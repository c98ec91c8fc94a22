"""ERB filterbank construction (numpy; the port's own copy).

`nb_bands` bands whose integer bin widths exactly partition the
`fft_size/2+1` rfft bins, with a minimum number of bins per band; the
filterbank is materialized as a dense matrix so that the band reduction and
the band->bin gain broadcast are each one matrix product.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

_ERB_SCALE = 9.265
_ERB_Q = 24.7


def freq2erb(freq_hz: float) -> float:
    return _ERB_SCALE * math.log1p(freq_hz / (_ERB_Q * _ERB_SCALE))


def erb2freq(n_erb: float) -> float:
    return _ERB_Q * _ERB_SCALE * (math.exp(n_erb / _ERB_SCALE) - 1.0)


@lru_cache(maxsize=None)
def erb_widths(sr: int, fft_size: int, nb_bands: int, min_nb_freqs: int) -> Tuple[int, ...]:
    """Integer bin width per ERB band; widths sum to fft_size//2+1.

    Bands are equally spaced on the ERB scale between 0 Hz and Nyquist; a
    band narrower than `min_nb_freqs` is widened and the surplus deducted
    from the next band; the last band takes the Nyquist bin and any excess.
    """
    nyq_freq = sr / 2
    freq_width = sr / fft_size
    erb_low = freq2erb(0.0)
    erb_high = freq2erb(nyq_freq)
    widths = np.zeros(nb_bands, dtype=np.int64)
    step = (erb_high - erb_low) / nb_bands
    prev_freq = 0
    freq_over = 0
    for i in range(1, nb_bands + 1):
        f = erb2freq(erb_low + i * step)
        fb = int(round(f / freq_width))
        nb_freqs = fb - prev_freq - freq_over
        if nb_freqs < min_nb_freqs:
            freq_over = min_nb_freqs - nb_freqs
            nb_freqs = min_nb_freqs
        else:
            freq_over = 0
        widths[i - 1] = nb_freqs
        prev_freq = fb
    widths[nb_bands - 1] += 1
    too_large = int(widths.sum()) - (fft_size // 2 + 1)
    if too_large > 0:
        widths[nb_bands - 1] -= too_large
    if int(widths.sum()) != fft_size // 2 + 1:
        raise ValueError("ERB widths must cover all rfft bins")
    return tuple(int(w) for w in widths)


@lru_cache(maxsize=None)
def _erb_fb_matrices_cached(
    widths: Tuple[int, ...], normalized: bool, inverse: bool
) -> np.ndarray:
    n_freqs = int(sum(widths))
    nb_bands = len(widths)
    fb = np.zeros((n_freqs, nb_bands), dtype=np.float32)
    start = 0
    for i, w in enumerate(widths):
        fb[start : start + w, i] = 1.0
        start += w
    if inverse:
        fb = fb.T.copy()
        if not normalized:
            fb /= fb.sum(axis=1, keepdims=True)
    elif normalized:
        fb /= fb.sum(axis=0, keepdims=True)
    fb.setflags(write=False)
    return fb


def erb_fb_matrices(
    widths: Sequence[int], normalized: bool = True, inverse: bool = False
) -> np.ndarray:
    """Dense [n_freqs, nb_bands] band-average matrix (forward), or the
    [nb_bands, n_freqs] gain broadcast (inverse). Read-only: it is cached."""
    return _erb_fb_matrices_cached(tuple(int(w) for w in widths), normalized, inverse)


@lru_cache(maxsize=None)
def erb_fb_tensor(widths: Tuple[int, ...], device: torch.device,
                  inverse: bool = False) -> torch.Tensor:
    """`erb_fb_matrices(widths, normalized=True, inverse)` as a tensor on
    `device`, made once per device."""
    return torch.tensor(erb_fb_matrices(widths, normalized=True, inverse=inverse),
                        device=device)
