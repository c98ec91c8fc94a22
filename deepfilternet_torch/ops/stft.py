"""Vorbis-windowed STFT and inverse STFT, offline and streaming.

Semantics of the JAX package's `ops/stft.py`:

  * window: vorbis ``sin(pi/2 * sin^2(pi*(n+0.5)/N))`` computed in float64;
  * forward normalization ``wnorm = 2*hop / fft_size**2`` in analysis only;
  * analysis is streaming: each hop is transformed together with the
    `fft - hop` samples before it (the analysis memory, zero at the start),
    so a signal of T samples gives T // hop frames;
  * synthesis is the unnormalized inverse (scale `fft_size`), windowed and
    overlap-added through the synthesis memory.

Offline, `stft` frames the whole signal and takes one batched rfft (cuFFT on
the card); `istft` inverts with irfft, `istft_ri` with the iDFT matrices.
The real DFT and its inverse as dense [N, F] / [F, N] matrices, with the
window and wnorm folded in, are built in float64 and stored as float32; the
re/im per-frame steps (`*_step_ri`) and the chunked runtime multiply by them.
`analysis_step`/`synthesis_step` are the complex64 per-frame steps, by rfft
and irfft, with the memories of `StftState`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def vorbis_window(fft_size: int) -> np.ndarray:
    """Vorbis (Princen-Bradley compliant) window, float64 math, f32 output."""
    half = fft_size / 2
    n = np.arange(fft_size, dtype=np.float64)
    s = np.sin(0.5 * np.pi * (n + 0.5) / half)
    w = np.sin(0.5 * np.pi * s * s).astype(np.float32)
    w.setflags(write=False)
    return w


def wnorm(fft_size: int, hop_size: int) -> float:
    """Forward normalization 1/(N^2/(2*hop))."""
    return float(2.0 * hop_size / (fft_size * fft_size))


class Stft(NamedTuple):
    """Static STFT configuration."""

    sr: int
    fft_size: int
    hop_size: int


def frame_signal(x: torch.Tensor, fft_size: int, hop_size: int) -> torch.Tensor:
    """[..., T] -> [..., T // hop, fft_size] after a left zero pad of
    fft - hop: frame i holds signal[(i+1)*hop - fft : (i+1)*hop]."""
    if x.shape[-1] < hop_size:
        return x.new_zeros(x.shape[:-1] + (0, fft_size))
    return F.pad(x, (fft_size - hop_size, 0)).unfold(-1, fft_size, hop_size)


def stft(x: torch.Tensor, cfg: Stft) -> torch.Tensor:
    """Analysis: [..., T] real -> [..., T // hop, F] complex64, the windowed
    rfft scaled by wnorm with fresh (zero) stream state."""
    frames = frame_signal(x, cfg.fft_size, cfg.hop_size)
    win = _window_tensor(cfg.fft_size, x.device)
    spec = torch.fft.rfft(frames * win, dim=-1)
    return (spec * wnorm(cfg.fft_size, cfg.hop_size)).to(torch.complex64)


def overlap_add(frames: torch.Tensor, hop_size: int) -> torch.Tensor:
    """[..., T', N] windowed frames -> [..., T'*hop + N - hop]: chunk k of
    frame i lands at offset (i + k) * hop. The first T'*hop samples are the
    finished output, the rest the tail still in flight."""
    n_frames, fft = frames.shape[-2], frames.shape[-1]
    if fft % hop_size:
        raise ValueError("overlap-add needs hop | fft_size")
    r = fft // hop_size
    chunks = frames.reshape(frames.shape[:-1] + (r, hop_size))
    out_len = n_frames * hop_size
    out = frames.new_zeros(frames.shape[:-2] + (out_len + (r - 1) * hop_size,))
    for k in range(r):
        seg = chunks[..., :, k, :].reshape(frames.shape[:-2] + (out_len,))
        out[..., k * hop_size : k * hop_size + out_len] += seg
    return out


def istft(spec: torch.Tensor, cfg: Stft) -> torch.Tensor:
    """Synthesis: [..., T', F] complex -> [..., T'*hop] real: unnormalized
    irfft (x fft_size), windowed, overlap-added from zero synthesis memory."""
    fft = cfg.fft_size
    frames = torch.fft.irfft(spec, n=fft, dim=-1) * float(fft)
    frames = (frames * _window_tensor(fft, spec.device)).to(torch.float32)
    return overlap_add(frames, cfg.hop_size)[..., : spec.shape[-2] * cfg.hop_size]


def istft_ri(spec_ri: torch.Tensor, cfg: Stft) -> torch.Tensor:
    """Synthesis from re/im-split input [..., T', F, 2] -> [..., T'*hop], by
    the iDFT matrices (real arithmetic only)."""
    re_m, im_m = _idft_tensors(cfg.fft_size, spec_ri.device)
    frames = spec_ri[..., 0] @ re_m + spec_ri[..., 1] @ im_m
    return overlap_add(frames, cfg.hop_size)[..., : spec_ri.shape[-3] * cfg.hop_size]


@functools.lru_cache(maxsize=None)
def dft_matrices(fft_size: int, hop_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos_mat, sin_mat): windowed forward real DFT, [N, F] each.

    spec = (frame @ cos_mat) + 1j * (frame @ sin_mat), equal to
    rfft(frame * window) * wnorm.
    """
    n = fft_size
    f = n // 2 + 1
    k = np.arange(n, dtype=np.float64)[:, None]
    j = np.arange(f, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * k * j / n
    w = vorbis_window(n).astype(np.float64)[:, None]
    scale = wnorm(fft_size, hop_size)
    cos_m = (np.cos(ang) * w * scale).astype(np.float32)
    sin_m = (np.sin(ang) * w * scale).astype(np.float32)
    cos_m.setflags(write=False)
    sin_m.setflags(write=False)
    return cos_m, sin_m


@functools.lru_cache(maxsize=None)
def idft_matrices(fft_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(re_mat, im_mat): [F, N] inverse real DFT x fft_size with the
    synthesis window folded in; interior bins count twice, DC/Nyquist once.
    """
    n = fft_size
    f = n // 2 + 1
    j = np.arange(f, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * j * k / n
    mult = np.full((f, 1), 2.0)
    mult[0] = 1.0
    if n % 2 == 0:
        mult[-1] = 1.0
    w = vorbis_window(n).astype(np.float64)[None, :]
    re_m = (np.cos(ang) * mult * w).astype(np.float32)
    im_m = (-np.sin(ang) * mult * w).astype(np.float32)
    re_m.setflags(write=False)
    im_m.setflags(write=False)
    return re_m, im_m


@functools.lru_cache(maxsize=None)
def _window_tensor(fft_size: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(vorbis_window(fft_size), device=device)


@functools.lru_cache(maxsize=None)
def _dft_tensors(fft_size: int, hop_size: int, device: torch.device):
    return tuple(torch.tensor(m, device=device) for m in dft_matrices(fft_size, hop_size))


@functools.lru_cache(maxsize=None)
def _idft_tensors(fft_size: int, device: torch.device):
    return tuple(torch.tensor(m, device=device) for m in idft_matrices(fft_size))


def analysis_step_ri(
    state: torch.Tensor, frame: torch.Tensor, cfg: Stft
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One hop of streaming analysis. state [..., fft-hop], frame [..., hop]
    -> (new_state, spec_re [..., F], spec_im [..., F])."""
    buf = torch.cat([state, frame], dim=-1)
    cos_m, sin_m = _dft_tensors(cfg.fft_size, cfg.hop_size, buf.device)
    return buf[..., cfg.hop_size :], buf @ cos_m, buf @ sin_m


def synthesis_step_ri(
    state: torch.Tensor, spec_re: torch.Tensor, spec_im: torch.Tensor, cfg: Stft
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop of streaming synthesis (windowed iDFT + overlap-add).
    state [..., fft-hop] -> (new_state, out [..., hop])."""
    hop = cfg.hop_size
    re_m, im_m = _idft_tensors(cfg.fft_size, spec_re.device)
    x = spec_re @ re_m + spec_im @ im_m
    out = x[..., :hop] + state[..., :hop]
    zeros = state.new_zeros(state.shape[:-1] + (hop,))
    shifted = torch.cat([state[..., hop:], zeros], dim=-1)
    new_state = shifted + x[..., hop:] if cfg.fft_size > hop else shifted
    return new_state, out


# -- streaming steps on complex spectra --------------------------------------


class StftState(NamedTuple):
    """Per-stream STFT memories: analysis_mem [..., fft-hop] holds the last
    input samples, synthesis_mem [..., fft-hop] the overlap-add tail still
    in flight."""

    analysis_mem: torch.Tensor
    synthesis_mem: torch.Tensor


def stft_state_init(batch_shape: Tuple[int, ...], cfg: Stft, device="cpu") -> StftState:
    d = cfg.fft_size - cfg.hop_size
    z = torch.zeros(tuple(batch_shape) + (d,), dtype=torch.float32, device=device)
    return StftState(analysis_mem=z, synthesis_mem=z)


def analysis_step(state: torch.Tensor, frame: torch.Tensor, cfg: Stft
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop of streaming analysis by rfft. state [..., fft-hop], frame
    [..., hop] -> (new_state, spec [..., F] complex64)."""
    buf = torch.cat([state, frame], dim=-1)
    spec = torch.fft.rfft(buf * _window_tensor(cfg.fft_size, buf.device), dim=-1)
    return buf[..., cfg.hop_size:], (spec * wnorm(cfg.fft_size, cfg.hop_size)).to(torch.complex64)


def synthesis_step(state: torch.Tensor, spec: torch.Tensor, cfg: Stft
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop of streaming synthesis by irfft (x fft_size), windowed and
    overlap-added. state [..., fft-hop], spec [..., F] complex ->
    (new_state, out [..., hop])."""
    fft, hop = cfg.fft_size, cfg.hop_size
    x = torch.fft.irfft(spec, n=fft, dim=-1) * float(fft)
    x = (x * _window_tensor(fft, spec.device)).to(torch.float32)
    out = x[..., :hop] + state[..., :hop]
    shifted = torch.cat([state[..., hop:], state.new_zeros(state.shape[:-1] + (hop,))], dim=-1)
    return (shifted + x[..., hop:] if fft > hop else shifted), out
