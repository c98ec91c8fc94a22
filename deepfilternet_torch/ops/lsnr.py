"""Local SNR target (the reference's LocalSnrTarget, df/modules.py:816-876).

Frame-local speech and noise energies, smoothed over time by a small hann
window, in dB and clamped to the configured LSNR range: the training target
of the model's LSNR head. Same functions as `deepfilternet_tpu.ops.lsnr`,
on complex tensors.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _hann(ws: int, device: torch.device) -> torch.Tensor:
    """torch.hann_window(ws) (periodic) on `device`, made once, but the
    identity for ws == 1 (the periodic window of one sample is [0])."""
    if ws == 1:
        return torch.ones(1, device=device)
    n = np.arange(ws, dtype=np.float64)
    return torch.tensor((0.5 * (1 - np.cos(2 * np.pi * n / ws))).astype(np.float32),
                        device=device)


def calc_ws(ws_ms: float, sr: int, fft_size: int, hop_size: int) -> int:
    ws = ws_ms - fft_size / sr * 1000.0
    ws = 1 + ws / (hop_size / sr * 1000.0)
    return max(int(round(ws)), 1)


def _local_energy(spec: torch.Tensor, ws: int) -> torch.Tensor:
    """spec: [B, T, F] complex -> [B, T] hann-smoothed frame energies."""
    if ws % 2 == 0:
        ws += 1
    half = ws // 2
    e = torch.sum(spec.real ** 2 + spec.imag ** 2, dim=-1)  # [B, T]
    windows = F.pad(e, (half, half)).unfold(-1, ws, 1)  # [B, T, ws]
    return torch.sum(windows * _hann(ws, e.device), dim=-1) / ws


def local_snr(
    clean: torch.Tensor,
    noise: torch.Tensor,
    window_size: int,
    db: bool = False,
    window_size_ns: Optional[int] = None,
    eps: float = 1e-12,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """clean/noise: [B, T, F] complex. Returns (snr [B, T], E_s, E_n)."""
    e_s = _local_energy(clean, window_size)
    e_n = _local_energy(noise, window_size_ns or window_size)
    snr = e_s / torch.clamp(e_n, min=eps)
    if db:
        snr = 10.0 * torch.log10(torch.clamp(snr, min=eps))
    return snr, e_s, e_n


def local_snr_target(
    clean: torch.Tensor,
    noise: torch.Tensor,
    sr: int,
    fft_size: int,
    hop_size: int,
    snr_range: Tuple[float, float],
    ws_ms: float = 20.0,
    max_bin: Optional[int] = None,
) -> torch.Tensor:
    """[B, T] dB target within snr_range."""
    if max_bin is not None:
        clean = clean[..., :max_bin]
        noise = noise[..., :max_bin]
    ws = calc_ws(ws_ms, sr, fft_size, hop_size)
    snr, _, _ = local_snr(clean, noise, ws, db=True, window_size_ns=ws * 2)
    return torch.clamp(snr, snr_range[0], snr_range[1])
