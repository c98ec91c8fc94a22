"""Valin-style perceptual post-filter, in its spectral form (over the
enhanced and the noisy spectra) and its mask form (over an ERB gain mask,
DFN1/DFN2's `mask_pf`). Slightly over-attenuates noisy bins:

    g      = clamp(|e| / |x|, eps, 1)
    g_sin  = g * sin(pi * g / 2)
    pf     = (1 + beta) / (1 + beta * (g / g_sin)^2)
"""

from __future__ import annotations

import torch

from deepfilternet_torch.nn.layers import _rounded

PI = 3.1415926535897932384626433


def post_filter(
    noisy: torch.Tensor, enhanced: torch.Tensor, beta: float = 0.02, eps: float = 1e-12
) -> torch.Tensor:
    """Post-filter `enhanced` (complex) given the noisy spectrum."""
    g = torch.clamp(torch.abs(enhanced) / (torch.abs(noisy) + eps), eps, 1.0)
    g_sin = g * torch.sin(g * (PI / 2.0))
    pf = (1.0 + beta) / (1.0 + beta * (g / g_sin) ** 2)
    return enhanced * pf.to(torch.float32)


def post_filter_mask(mask: torch.Tensor, beta: float = 0.02, eps: float = 1e-12) -> torch.Tensor:
    """Mask form: the same gain curve with g = mask, its constants rounded
    to the mask's type (a bfloat16 mask: DFN1/DFN2 at bfloat16)."""
    dt = mask.dtype
    mask_sin = mask * torch.sin(_rounded(PI, dt) * mask / 2.0)
    return (_rounded(1.0 + beta, dt) * mask
            / (1.0 + _rounded(beta, dt)
               * (mask / torch.clamp(mask_sin, min=_rounded(eps, dt))) ** 2))
