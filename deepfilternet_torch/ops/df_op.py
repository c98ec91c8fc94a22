"""Deep filtering: a complex multi-frame MAC over the low-frequency bins.

    y[t, f] = sum_n  x[t - (N-1-lookahead) + n, f] * c[n, t, f]

Offline (`deep_filter_offline`) the N taps are time shifts of the whole
spectrogram, any lookahead; streaming (`deep_filter`) keeps an (N-1)-frame
ring buffer, lookahead 0. Both take complex64; a bfloat16 model hands them
coefficients and spectra widened from bfloat16 parts (as JAX promotes
`re + 1j * im`), so the ring stays float32 at either model type.
"""

from __future__ import annotations

from typing import Tuple

import torch


def deep_filter(
    ring: torch.Tensor, spec_lo: torch.Tensor, coefs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ring [..., N-1, F'] past low-band frames (oldest first), spec_lo
    [..., F'] this frame's low bins, coefs [..., N, F'], all complex.
    Returns (new_ring, filtered [..., F'])."""
    buf = torch.cat([ring, spec_lo.unsqueeze(-2)], dim=-2)
    y = torch.sum(buf * coefs, dim=-2)
    return buf[..., 1:, :], y


# -- offline: all frames at once --------------------------------------------


def _shift_time(x: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    """x delayed by `shift` frames along `axis` with zero fill: out[t] =
    x[t - shift]; a negative shift advances (lookahead)."""
    if shift == 0:
        return x
    t = x.shape[axis]
    n = min(abs(shift), t)
    zshape = list(x.shape)
    zshape[axis] = n
    zeros = x.new_zeros(zshape)
    if shift > 0:
        return torch.cat([zeros, x.narrow(axis, 0, t - n)], dim=axis)
    return torch.cat([x.narrow(axis, n, t - n), zeros], dim=axis)


def spec_unfold(spec: torch.Tensor, order: int, lookahead: int = 0, time_axis: int = -2
                ) -> torch.Tensor:
    """[..., T, F] -> [..., T, F, N]: frame t, tap n = spec[t - (N-1-la) + n]."""
    axis = time_axis % spec.ndim
    taps = [_shift_time(spec, order - 1 - lookahead - n, axis) for n in range(order)]
    return torch.stack(taps, dim=-1)


def deep_filter_offline(spec: torch.Tensor, coefs: torch.Tensor, nb_df: int,
                        lookahead: int = 0) -> torch.Tensor:
    """spec [..., T, F] complex (full band), coefs [..., N, T, F'] complex with
    F' == nb_df. Returns spec with its first nb_df bins replaced by the
    filtered ones."""
    order = coefs.shape[-3]
    un = spec_unfold(spec[..., :nb_df], order, lookahead, time_axis=-2)  # [..., T, F', N]
    y = torch.sum(un * torch.movedim(coefs, -3, -1), dim=-1)
    return torch.cat([y, spec[..., nb_df:]], dim=-1)
