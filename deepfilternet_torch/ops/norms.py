"""Exponential mean/unit normalization of features.

Per-band first-order trackers ``s_t = (1 - alpha) * x_t + alpha * s_{t-1}``:
mean-norm output ``(x_t - s_t) / 40`` over the ERB bands (state starts at
linspace(-60, -90) dB), unit-norm output ``x_t / sqrt(s_t)`` over the DF
bins with ``x_t = |spec_t|`` (state starts at linspace(1e-3, 1e-4)).

The streaming runtime carries ``s`` one frame at a time (`*_step`); over a
whole signal or chunk `_ema_scan` solves the recurrence with blocked matrix
products (the JAX package uses `lax.associative_scan`, which PyTorch lacks).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

MEAN_NORM_INIT = (-60.0, -90.0)
UNIT_NORM_INIT = (1e-3, 1e-4)


def get_norm_alpha(sr: int, hop_size: int, tau: float) -> float:
    """Decay factor for a time constant, rounded at increasing precision
    until it is strictly below 1.0."""
    a_ = math.exp(-(hop_size / sr) / tau)
    precision = 3
    a = 1.0
    while a >= 1.0:
        a = round(a_, precision)
        precision += 1
    return a


@lru_cache(maxsize=None)
def mean_norm_init(nb_erb: int) -> np.ndarray:
    s = np.linspace(MEAN_NORM_INIT[0], MEAN_NORM_INIT[1], nb_erb, dtype=np.float32)
    s.setflags(write=False)
    return s


@lru_cache(maxsize=None)
def unit_norm_init(nb_freqs: int) -> np.ndarray:
    s = np.linspace(UNIT_NORM_INIT[0], UNIT_NORM_INIT[1], nb_freqs, dtype=np.float32)
    s.setflags(write=False)
    return s


def erb_norm_step(
    state: torch.Tensor, x: torch.Tensor, alpha: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame of the ERB mean norm. x, state: [..., E] -> (state', out)."""
    s = x * (1.0 - alpha) + state * alpha
    return s, (x - s) / 40.0


def unit_norm_step(
    state: torch.Tensor, x: torch.Tensor, alpha: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame of the unit norm. x complex [..., F'], state [..., F'] ->
    (state', x / sqrt(state'))."""
    s = torch.abs(x) * (1.0 - alpha) + state * alpha
    return s, x / torch.sqrt(s)


# -- offline: the recurrence over whole signals ------------------------------

# frames a block of the blocked scan
EMA_BLOCK = 64


@lru_cache(maxsize=None)
def _ema_block_mats(decay: float, block: int, device: torch.device, dtype: torch.dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M [L, L], p [L, 1]) with M[t, k] = decay^(t-k) for k <= t (else 0) and
    p[t] = decay^(t+1), built in float64 and cast once."""
    t = np.arange(block)
    d = t[:, None] - t[None, :]
    m = np.where(d >= 0, np.power(decay, np.maximum(d, 0), dtype=np.float64), 0.0)
    p = np.power(decay, t + 1.0, dtype=np.float64)[:, None]
    return (torch.tensor(m, dtype=dtype, device=device),
            torch.tensor(p, dtype=dtype, device=device))


def _linear_scan(b: torch.Tensor, s0: torch.Tensor, decay: float) -> torch.Tensor:
    """All s_t of ``s_t = decay * s_{t-1} + b_t`` over axis -2 of b [..., T, E],
    from s0 [..., E].

    Blocks of EMA_BLOCK frames: inside a block, s = M @ b_blk + p * s_in, one
    batched product for all blocks at once; the state entering each block is
    the same recurrence over the blocks' last local sums with decay^L, solved
    the same way. No loop over frames or blocks: the depth is log_L(T).
    """
    t = b.shape[-2]
    blk = EMA_BLOCK
    if t <= blk:
        m, p = _ema_block_mats(decay, blk, b.device, b.dtype)
        return m[:t, :t] @ b + p[:t] * s0.unsqueeze(-2)
    n_blk = -(-t // blk)
    # zero frames at the end change no earlier state
    bp = torch.nn.functional.pad(b, (0, 0, 0, n_blk * blk - t))
    bp = bp.reshape(b.shape[:-2] + (n_blk, blk, b.shape[-1]))
    m, p = _ema_block_mats(decay, blk, b.device, b.dtype)
    local = m @ bp  # [..., n_blk, L, E]: each block from a zero state
    ends = _linear_scan(local[..., -1, :], s0, decay**blk)  # state after each block
    s_in = torch.cat([s0.unsqueeze(-2), ends[..., :-1, :]], dim=-2)
    s = local + p * s_in.unsqueeze(-2)
    return s.reshape(b.shape[:-2] + (n_blk * blk, b.shape[-1]))[..., :t, :]


def _ema_scan(x: torch.Tensor, s0: torch.Tensor, alpha: float, axis: int = -2
              ) -> torch.Tensor:
    """All states s_t of ``s_t = alpha*s_{t-1} + (1-alpha)*x_t`` along `axis`
    of x [..., T, ...], from s0 (x's shape without that axis)."""
    xt = torch.movedim(x, axis, -2)
    s = _linear_scan((1.0 - alpha) * xt, s0, alpha)
    return torch.movedim(s, -2, axis)


def erb_norm(erb_feats: torch.Tensor, alpha: float, state: Optional[torch.Tensor] = None,
             axis: int = -2) -> torch.Tensor:
    """Mean-normalize dB-scale ERB features over time: erb_feats [..., T, E],
    state [..., E] (default the linspace init) -> (x - s) / 40."""
    e = erb_feats.shape[-1]
    if state is None:
        state = torch.tensor(mean_norm_init(e), device=erb_feats.device).expand(
            erb_feats.shape[:-2] + (e,))
    return (erb_feats - _ema_scan(erb_feats, state, alpha, axis=axis)) / 40.0


def unit_norm(spec: torch.Tensor, alpha: float, state: Optional[torch.Tensor] = None,
              axis: int = -2) -> torch.Tensor:
    """Unit-normalize a complex spectrogram slice over time: spec [..., T, F']
    complex, state [..., F'] -> spec / sqrt(s), s tracking |spec|."""
    f = spec.shape[-1]
    if state is None:
        state = torch.tensor(unit_norm_init(f), device=spec.device).expand(
            spec.shape[:-2] + (f,))
    s = _ema_scan(torch.abs(spec), state, alpha, axis=axis)
    return spec / torch.sqrt(s)
