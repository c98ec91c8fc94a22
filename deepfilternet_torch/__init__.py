"""deepfilternet_torch: the PyTorch and CUDA port of deepfilternet_tpu.

Streaming DeepFilterNet3 inference on an NVIDIA GPU, held against the JAX
package on the same inputs. The per-frame analysis frontend is a hand-written
CUDA kernel (`csrc/fused_frontend.cu`); everything else is PyTorch.

    from deepfilternet_torch import init_df, enhance
"""

__version__ = "0.1.0"

__all__ = ["init_df", "enhance", "__version__"]


def __getattr__(name):
    if name in ("init_df", "enhance"):
        from deepfilternet_torch import enhance as _enhance_mod

        return getattr(_enhance_mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
