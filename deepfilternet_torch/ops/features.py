"""Feature extraction over whole spectrograms: ERB band energies and
normalized complex bins, as in the JAX package's `ops/features.py`.

Per-band mean power through the normalized ERB filterbank, dB scale
``10*log10(x + 1e-10)``, exponential mean norm; and the low-frequency complex
bins divided by the square root of an exponential magnitude track. The norms
run as blocked scans (`norms._ema_scan`).
"""

from __future__ import annotations

from typing import Optional

import torch

from deepfilternet_torch.ops.erb import erb_fb_tensor
from deepfilternet_torch.ops.norms import erb_norm, unit_norm


def erb_band_energies(spec: torch.Tensor, widths, db: bool = True) -> torch.Tensor:
    """[..., F] complex -> [..., E] mean band power (optionally in dB)."""
    fb = erb_fb_tensor(tuple(widths), spec.device)
    power = spec.real**2 + spec.imag**2
    e = power @ fb
    if db:
        e = 10.0 * torch.log10(e + 1e-10)
    return e


def erb_feat(spec: torch.Tensor, widths, alpha: float,
             state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Band dB energies + exponential mean norm: [..., T, F] complex ->
    [..., T, E] float32."""
    return erb_norm(erb_band_energies(spec, widths), alpha, state=state).to(torch.float32)


def spec_feat(spec: torch.Tensor, nb_df: int, alpha: float,
              state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unit-normalized complex features of the first nb_df bins: [..., T, F]
    complex -> [..., T, nb_df] complex64."""
    return unit_norm(spec[..., :nb_df], alpha, state=state).to(torch.complex64)


def apply_interp_band_gain(spec: torch.Tensor, gains: torch.Tensor, widths) -> torch.Tensor:
    """Per-band gains [..., E] broadcast to the bins of spec [..., F] (complex)
    and multiplied in."""
    return spec * (gains @ erb_fb_tensor(tuple(widths), spec.device, inverse=True))
