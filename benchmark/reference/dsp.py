"""Plain DSP of DeepFilterNet: the Vorbis-windowed STFT by dense DFT
matrices, the ERB filterbank, the exponential feature norms and the
streaming analysis and synthesis with their memories.

Semantics of DeepFilterNet's libDF (`libDF/src/lib.rs`): analysis frames
are each hop with the fft - hop samples before it (zero at the start),
scaled by 2 * hop / fft**2; synthesis is the unnormalized inverse,
windowed and overlap-added. Written from that description in plain
PyTorch and NumPy; it imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

MEAN_NORM_INIT = (-60.0, -90.0)
UNIT_NORM_INIT = (1e-3, 1e-4)


def vorbis_window(n: int) -> np.ndarray:
    """sin(pi/2 * sin^2(pi * (k + 0.5) / n)), float64."""
    k = np.arange(n, dtype=np.float64)
    s = np.sin(np.pi * (k + 0.5) / n)
    return np.sin(0.5 * np.pi * s * s)


def dft_matrices(fft: int, hop: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos [N, F], sin [N, F]) float32: frame @ cos + 1j * frame @ sin is
    the windowed real DFT scaled by 2 * hop / fft**2."""
    k = np.arange(fft, dtype=np.float64)[:, None]
    j = np.arange(fft // 2 + 1, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * k * j / fft
    w = vorbis_window(fft)[:, None] * (2.0 * hop / (fft * fft))
    return (torch.tensor(np.cos(ang) * w, dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang) * w, dtype=torch.float32, device=device))


def idft_matrices(fft: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re [F, N], im [F, N]) float32: the inverse real DFT times fft (the
    interior bins twice), the synthesis window folded in."""
    j = np.arange(fft // 2 + 1, dtype=np.float64)[:, None]
    k = np.arange(fft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * j * k / fft
    mult = np.full((fft // 2 + 1, 1), 2.0)
    mult[0] = 1.0
    if fft % 2 == 0:
        mult[-1] = 1.0
    w = vorbis_window(fft)[None, :]
    return (torch.tensor(np.cos(ang) * mult * w, dtype=torch.float32, device=device),
            torch.tensor(-np.sin(ang) * mult * w, dtype=torch.float32, device=device))


def erb_widths(sr: int, fft: int, nb_bands: int, min_nb_freqs: int) -> Tuple[int, ...]:
    """Bins a band, equally spaced on the ERB scale, at least min_nb_freqs
    each; they partition the fft // 2 + 1 bins (libDF's erb_fb)."""
    def f2e(f):
        return 9.265 * math.log1p(f / (24.7 * 9.265))

    def e2f(e):
        return 24.7 * 9.265 * (math.exp(e / 9.265) - 1.0)

    step = (f2e(sr / 2) - f2e(0.0)) / nb_bands
    widths, prev, over = [], 0, 0
    for i in range(1, nb_bands + 1):
        fb = int(round(e2f(f2e(0.0) + i * step) / (sr / fft)))
        nb = fb - prev - over
        if nb < min_nb_freqs:
            over, nb = min_nb_freqs - nb, min_nb_freqs
        else:
            over = 0
        widths.append(nb)
        prev = fb
    widths[-1] += 1
    excess = sum(widths) - (fft // 2 + 1)
    if excess > 0:
        widths[-1] -= excess
    if sum(widths) != fft // 2 + 1:
        raise ValueError("ERB widths do not cover the bins")
    return tuple(widths)


def erb_fb(widths, device, inverse: bool = False) -> torch.Tensor:
    """[F, E] band means of the bins (forward) or [E, F] a band's gain on
    each of its bins (inverse), float32."""
    fb = np.zeros((sum(widths), len(widths)), dtype=np.float64)
    lo = 0
    for i, w in enumerate(widths):
        fb[lo:lo + w, i] = 1.0
        lo += w
    m = fb.T if inverse else fb / fb.sum(axis=0, keepdims=True)
    return torch.tensor(m, dtype=torch.float32, device=device)


def norm_alpha(sr: int, hop: int, tau: float) -> float:
    """exp(-hop / sr / tau), rounded at rising precision until below 1."""
    a_ = math.exp(-(hop / sr) / tau)
    precision, a = 3, 1.0
    while a >= 1.0:
        a = round(a_, precision)
        precision += 1
    return a


def norm_init(lo_hi, n: int, rows: int, device) -> torch.Tensor:
    return torch.tensor(np.linspace(lo_hi[0], lo_hi[1], n, dtype=np.float32),
                        device=device).repeat(rows, 1)


def ema(x: torch.Tensor, s0: torch.Tensor, alpha: float) -> torch.Tensor:
    """s_t = (1 - alpha) x_t + alpha s_{t-1} over axis 1 of x [B, T, E], frame
    by frame from s0 [B, E]; returns every s_t [B, T, E]."""
    out, s = [], s0
    for t in range(x.shape[1]):
        s = x[:, t] * (1.0 - alpha) + s * alpha
        out.append(s)
    return torch.stack(out, dim=1)


def analysis(mem: torch.Tensor, audio: torch.Tensor, fft: int, hop: int):
    """mem [B, fft - hop], audio [B, T * hop] -> (re [B, T, F], im [B, T, F],
    new mem)."""
    b, n = audio.shape[0], audio.shape[1] // hop
    buf = torch.cat([mem, audio], dim=-1)
    idx = (torch.arange(n, device=audio.device)[:, None] * hop
           + torch.arange(fft, device=audio.device)[None, :])
    frames = buf[:, idx]  # [B, T, fft]
    cos_m, sin_m = dft_matrices(fft, hop, audio.device)
    return frames @ cos_m, frames @ sin_m, buf[:, buf.shape[1] - (fft - hop):]


def synthesis(mem: torch.Tensor, re: torch.Tensor, im: torch.Tensor, fft: int, hop: int):
    """mem [B, fft - hop] (the tail still in flight), re/im [B, T, F] ->
    (audio [B, T * hop], new mem)."""
    re_m, im_m = idft_matrices(fft, re.device)
    frames = re @ re_m + im @ im_m  # [B, T, fft]
    b, n = frames.shape[:2]
    out = frames.new_zeros((b, n * hop + fft - hop))
    out[:, :fft - hop] += mem
    for t in range(n):
        out[:, t * hop:t * hop + fft] += frames[:, t]
    return out[:, :n * hop], out[:, n * hop:]
