"""Bandwidth estimation and spectral bandwidth extension, the port's copy of
`deepfilternet_tpu.ops.bandwidth`.

Reference: libDF/src/transforms.rs:440-579. Host-side NumPy (shapes are
data-dependent: these run in the data pipeline and in pre-enhancement
input conditioning, not on the device).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Band upper edges [Hz]: [0-8, 8-10, 10-12, 12-16, 16-18, 18-20, 20-22,
# 22-24] kHz, matching srs [16, 20, 24, 32, 36, 40, 44, 48] kHz.
_BAND_EDGES = np.array([8000.0, 10000.0, 12000.0, 16000.0, 18000.0, 20000.0,
                        22000.0, 24000.0])


def rfftfreqs(n: int, sr: int) -> np.ndarray:
    return np.arange(n) * (sr / 2) / (n - 1)


def _bw_filterbank(center_freqs: np.ndarray) -> np.ndarray:
    n = len(center_freqs)
    out = np.zeros((n, 8), np.float32)
    band = np.searchsorted(_BAND_EDGES[:-1], center_freqs, side="left")
    out[np.arange(n), band] = 1.0
    return out / np.maximum(out.sum(axis=0, keepdims=True), 1e-10)


def estimate_bandwidth(spec: np.ndarray, sr: int, db_cut_off: float = -120.0,
                       window_size: int = 10) -> int:
    """Estimate the occupied-bandwidth cutoff bin of a [C, T, F] complex
    spectrogram (transforms.rs:509-579): per-window max band energy in dB,
    first band below threshold marks the cutoff; median over windows."""
    assert sr == 48000, "bw filterbank assumes 48 kHz"
    t = spec.shape[1]
    window_size = min(window_size, t)
    if db_cut_off > 0:
        db_cut_off = -db_cut_off
    n_freqs = spec.shape[2]
    fb = _bw_filterbank(rfftfreqs(n_freqs, sr))
    f_db = (20.0 * np.log10(np.abs(spec) + 1e-16)).mean(axis=0) @ fb  # [T, 8]
    # map band -> highest original bin of that band
    c_map = np.zeros(8, np.int64)
    band_of_bin = np.argmax(fb > 0, axis=1)
    for b in range(8):
        bins = np.nonzero(band_of_bin == b)[0]
        c_map[b] = bins[-1] if bins.size else 0
    idcs = []
    for start in range(0, t, window_size):
        w = f_db[start : start + window_size]
        band_max = w.max(axis=0)  # [8]
        below = np.nonzero(band_max[1:] < db_cut_off)[0]
        c = int(below[0]) if below.size else 7
        idcs.append(int(c_map[c]))
    return int(np.median(idcs))


def ext_bandwidth_spectral(spec: np.ndarray, cbin: int, sr: int,
                           n_bins_overlap: Optional[int] = None) -> np.ndarray:
    """Copy lower-frequency content into missing upper bins
    (transforms.rs:446-478). spec: [C, T, F] complex, modified copy
    returned."""
    spec = spec.copy()
    n_bins_all = spec.shape[2]
    n_fft = (n_bins_all - 1) * 2
    if n_bins_all - cbin <= 1:
        return spec
    cbin -= n_bins_overlap or 0
    min_bin = 4000 // (sr // n_fft)
    if cbin <= min_bin:
        min_bin = 3000 // (sr // n_fft)
    max_copy_bins = cbin - min_bin
    if max_copy_bins <= 0:
        return spec
    missing = n_bins_all - cbin
    n_copies = int(np.ceil(missing / max_copy_bins))
    start_tgt = cbin
    start_src = max(min_bin, cbin - missing)
    for _ in range(n_copies):
        cur = min(max_copy_bins, n_bins_all - start_tgt)
        spec[:, :, start_tgt : start_tgt + cur] = spec[:, :, start_src : start_src + cur]
        start_tgt += cur
    return spec
