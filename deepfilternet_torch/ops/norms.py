"""Exponential mean/unit normalization of features (streaming form).

Per-band first-order trackers ``s_t = (1 - alpha) * x_t + alpha * s_{t-1}``:
mean-norm output ``(x_t - s_t) / 40`` over the ERB bands (state starts at
linspace(-60, -90) dB), unit-norm output ``x_t / sqrt(s_t)`` over the DF
bins with ``x_t = |spec_t|`` (state starts at linspace(1e-3, 1e-4)).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

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
