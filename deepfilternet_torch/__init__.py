"""deepfilternet_torch: the PyTorch and CUDA port of deepfilternet_tpu.

DeepFilterNet inference and training on an NVIDIA GPU, held against the JAX
package on the same inputs: offline `enhance()` (and its CLI, `python -m
deepfilternet_torch.enhance`), the per-frame `StreamingRuntime`, the
frame-parallel `ChunkedStreamingRuntime` and the `WholeCellStreamingRuntime`
for DFN3 (the first three also for DFN2 and DFN1; DeepFilterNet-MF offline),
and the train step of all four families (`train/`: losses, an AdamW-amsgrad
step with batch-norm statistics and a NaN guard; `checkpoint.write_cp`).
Two hand-written CUDA kernels: the per-frame analysis frontend
(`csrc/fused_frontend.cu`) under `StreamingRuntime`, and the whole streaming
frame with the frame loop inside one launch (`csrc/whole_cell.cu`,
`csrc/whole_cell_rows.cu`) under `WholeCellStreamingRuntime`; everything
else is PyTorch. The stream server (`serve.py`, the JAX server's wire
protocol; on a GPU each tick is one CUDA-graph replay), its WebSocket bridge
(`serve_ws.py`), the terminal demo client (`scripts/demo_client.py`) and
stream sharding over several devices (`parallel/`) sit on top.

    from deepfilternet_torch import init_df, enhance
    from deepfilternet_torch import StreamingRuntime, ChunkedStreamingRuntime
    from deepfilternet_torch import WholeCellStreamingRuntime
"""

__version__ = "0.1.0"

__all__ = ["init_df", "enhance", "df_features", "StreamingRuntime",
           "ChunkedStreamingRuntime", "WholeCellStreamingRuntime", "RuntimeParams",
           "__version__"]

_LAZY = {
    "init_df": "enhance", "enhance": "enhance", "df_features": "enhance",
    "StreamingRuntime": "streaming", "RuntimeParams": "streaming",
    "ChunkedStreamingRuntime": "streaming",
    "WholeCellStreamingRuntime": "streaming_whole_cell",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
