"""Deep filtering, streaming form: a complex multi-frame MAC over the
low-frequency bins with an (N-1)-frame ring buffer (lookahead 0).

    y[t, f] = sum_n  x[t - (N-1) + n, f] * c[n, t, f]
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
