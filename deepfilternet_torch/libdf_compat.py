"""pyDF-compatible API shim (reference: pyDF/src/lib.rs, module `libdf`),
the port's counterpart of `deepfilternet_tpu.libdf_compat`.

Drop-in equivalents of the reference's Rust-backed Python bindings so code
written against `libdf` ports directly:

    from deepfilternet_torch.libdf_compat import DF, erb, erb_inv, erb_norm, \
        unit_norm, unit_norm_init

Numpy in, numpy out, as the bindings: the work runs on the port's torch ops
(`ops/stft.py`, `ops/erb.py`, `ops/norms.py`) with the tensors on `device`,
by default the CUDA device (it raises without one); pass `device="cpu"` for
the CPU. `analysis` returns complex64 [C, T//hop, F], `erb_widths` uint64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deepfilternet_torch.enhance import resolve_device
from deepfilternet_torch.ops.erb import erb_fb_matrices, erb_widths
from deepfilternet_torch.ops.norms import erb_norm as _erb_norm
from deepfilternet_torch.ops.norms import unit_norm as _unit_norm
from deepfilternet_torch.ops.norms import unit_norm_init as _unit_norm_init
from deepfilternet_torch.ops.stft import Stft, istft, stft, vorbis_window


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


class DF:
    """pyclass DF equivalent (pyDF/src/lib.rs:14-136).

    Stateless between calls (analysis/synthesis reset by default, matching
    the binding's `reset: Option<bool> = true`).
    """

    def __init__(self, sr: int, fft_size: int, hop_size: int,
                 nb_bands: Optional[int] = None,
                 min_nb_erb_freqs: Optional[int] = None, device=None):
        assert hop_size * 2 <= fft_size
        self._cfg = Stft(sr=sr, fft_size=fft_size, hop_size=hop_size)
        self._nb_bands = nb_bands if nb_bands is not None else 32
        self._min_nb_freqs = min_nb_erb_freqs if min_nb_erb_freqs is not None else 1
        self.device = resolve_device(device)

    def analysis(self, input: np.ndarray, reset: bool = True) -> np.ndarray:
        """[C, T] float32 -> [C, T//hop, F] complex64."""
        x = _tensor(np.atleast_2d(input), torch.float32, self.device)
        return stft(x, self._cfg).cpu().numpy()

    def synthesis(self, input: np.ndarray, reset: bool = True) -> np.ndarray:
        """[C, T', F] complex -> [C, T'*hop] float32."""
        return istft(_tensor(input, torch.complex64, self.device), self._cfg).cpu().numpy()

    def erb_widths(self) -> np.ndarray:
        return np.asarray(
            erb_widths(self._cfg.sr, self._cfg.fft_size, self._nb_bands,
                       self._min_nb_freqs),
            np.uint64,
        )

    def fft_window(self) -> np.ndarray:
        return vorbis_window(self._cfg.fft_size).copy()

    def sr(self) -> int:
        return self._cfg.sr

    def fft_size(self) -> int:
        return self._cfg.fft_size

    def hop_size(self) -> int:
        return self._cfg.hop_size

    def nb_erb(self) -> int:
        return self._nb_bands

    def reset(self):
        pass  # stateless between calls


def erb(input: np.ndarray, erb_fb: np.ndarray, db: Optional[bool] = None,
        device=None) -> np.ndarray:
    """Band energies over ERB widths; input complex [..., T, F]
    (pyDF/src/lib.rs:142-192)."""
    dev = resolve_device(device)
    widths = tuple(int(w) for w in np.asarray(erb_fb))
    # in float64, rounded once to float32: within an ulp of the float32 sums
    # and logarithm of the bindings whatever the order of the sums
    x = _tensor(input, torch.complex128, dev)
    fb = _tensor(erb_fb_matrices(widths, normalized=True, inverse=False), torch.float64, dev)
    out = (torch.abs(x) ** 2) @ fb
    if db is None or db:
        out = 10.0 * torch.log10(out + 1e-10)
    return out.cpu().numpy().astype(np.float32)


def erb_inv(gains: np.ndarray, erb_fb: np.ndarray, device=None) -> np.ndarray:
    dev = resolve_device(device)
    widths = tuple(int(w) for w in np.asarray(erb_fb))
    g = _tensor(gains, torch.float64, dev)
    inv = _tensor(erb_fb_matrices(widths, normalized=True, inverse=True), torch.float64, dev)
    return (g @ inv).cpu().numpy().astype(np.float32)


def erb_norm(erb: np.ndarray, alpha: float,
             state: Optional[np.ndarray] = None, device=None) -> np.ndarray:
    """[C, T, E] -> normalized (pyDF/src/lib.rs:252-274)."""
    dev = resolve_device(device)
    return _erb_norm(_tensor(erb, torch.float32, dev), alpha,
                     state=None if state is None else _tensor(state, torch.float32, dev)
                     ).cpu().numpy()


def unit_norm(spec: np.ndarray, alpha: float,
              state: Optional[np.ndarray] = None, device=None) -> np.ndarray:
    """[C, T, F'] complex -> unit-normalized (pyDF/src/lib.rs:276-298)."""
    dev = resolve_device(device)
    return _unit_norm(_tensor(spec, torch.complex64, dev), alpha,
                      state=None if state is None else _tensor(state, torch.float32, dev)
                      ).cpu().numpy()


def unit_norm_init(num_freq_bins: int) -> np.ndarray:
    """Linspace init state [1, F'] (pyDF/src/lib.rs:300-309)."""
    return _unit_norm_init(num_freq_bins)[None, :].copy()
