"""Multi-frame filters over complex spectrograms: the complex ratio mask,
and the multi-frame Wiener filter (WF) and MVDR beamformer of DeepFilterNet-MF.

Spectrograms are complex [B, T, F] (time-major), the N-tap frame windows
those of `ops.df_op.spec_unfold`. The WF and MVDR weights are N x N complex
linear systems a bin and frame (N = df_order, 5 by default): solved with
`torch.linalg.solve` in complex64 when the network estimates the covariance
itself, one batched product when it estimates its inverse (the default).
"""

from __future__ import annotations

import torch

from deepfilternet_torch.ops.df_op import spec_unfold


def _ct(x: torch.Tensor) -> torch.Tensor:
    """The conjugate transpose of the last two axes."""
    return torch.conj(x.transpose(-1, -2))


def psd(x: torch.Tensor, n: int) -> torch.Tensor:
    """Correlation matrices of the N-frame window: x [..., T, F] complex ->
    Rxx [..., T, F, N, N], Rxx[m, n] = x_n * conj(x_m)."""
    xw = spec_unfold(x, n, lookahead=0, time_axis=-2)  # [..., T, F, N]
    return torch.einsum("...n,...m->...mn", xw, torch.conj(xw))


def crm(spec: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """Complex ratio mask: the elementwise product."""
    return spec * coefs


def _tik_reg(mat: torch.Tensor, reg: float = 1e-7, eps: float = 1e-8) -> torch.Tensor:
    """Tikhonov regularization: (trace * reg + eps) added to the diagonal."""
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    trace = torch.diagonal(mat, dim1=-2, dim2=-1).sum(-1).real[..., None, None]
    return mat + (trace * reg + eps) * eye


def _enforce_hermitian(r: torch.Tensor) -> torch.Tensor:
    """The strict lower triangle mirrored (conjugated) into the upper one,
    the diagonal's imaginary part dropped."""
    lower = torch.tril(r, diagonal=-1)
    diag = torch.diagonal(r, dim1=-2, dim2=-1).real  # [..., N]
    eye = torch.eye(r.shape[-1], dtype=r.dtype, device=r.device)
    return lower + _ct(lower) + diag[..., None, :] * eye


def _prep_cov(r: torch.Tensor, cholesky_decomp: bool, inverse: bool,
              enforce_constraints: bool) -> torch.Tensor:
    """The network's covariance estimate as a matrix: a Cholesky factor
    multiplied out (its upper triangle zeroed first under constraints), or
    made Hermitian."""
    if cholesky_decomp:
        if enforce_constraints:
            r = torch.tril(r)
        return r @ _ct(r)
    if enforce_constraints and not inverse:
        return _enforce_hermitian(r)
    return r


def _mf_weights(r: torch.Tensor, ifc: torch.Tensor, inverse: bool, dload: float,
                eps: float) -> torch.Tensor:
    """w = R^-1 ifc (a regularized solve), or R_inv @ ifc."""
    if not inverse:
        return torch.linalg.solve(_tik_reg(r, dload, eps), ifc[..., None])[..., 0]
    return torch.einsum("...nm,...m->...n", r, ifc)


def _filter(spec, w, nb_df, order, lookahead):
    un = spec_unfold(spec[..., :nb_df], order, lookahead, time_axis=-2)  # [B, T, F', N]
    return torch.cat([torch.sum(un * w, dim=-1), spec[..., nb_df:]], dim=-1)


def mf_wf(spec: torch.Tensor, ifc: torch.Tensor, r: torch.Tensor, nb_df: int, order: int,
          lookahead: int = 0, cholesky_decomp: bool = False, inverse: bool = True,
          enforce_constraints: bool = True, eps: float = 1e-8, dload: float = 1e-7
          ) -> torch.Tensor:
    """Multi-frame Wiener filter. spec [B, T, F] complex; ifc [B, T, F', N]
    the speech inter-frame correlation; r [B, T, F', N, N] the noisy
    covariance (or its inverse, or a Cholesky factor of either). Returns spec
    with its first nb_df bins filtered."""
    r = _prep_cov(r, cholesky_decomp, inverse, enforce_constraints)
    return _filter(spec, _mf_weights(r, ifc, inverse, dload, eps), nb_df, order, lookahead)


def mf_mvdr(spec: torch.Tensor, ifc: torch.Tensor, r: torch.Tensor, nb_df: int, order: int,
            lookahead: int = 0, cholesky_decomp: bool = False, inverse: bool = True,
            enforce_constraints: bool = True, eps: float = 1e-8, dload: float = 1e-7
            ) -> torch.Tensor:
    """Multi-frame MVDR beamformer: mf_wf's I/O with r the noise covariance;
    the weights are normalized by the distortionless constraint, with the
    last IFC tap as the steering reference."""
    r = _prep_cov(r, cholesky_decomp, inverse, enforce_constraints)
    numerator = _mf_weights(r, ifc, inverse, dload, eps)  # [B, T, F', N]
    denominator = torch.einsum("...n,...n->...", torch.conj(ifc), numerator)
    w = numerator * torch.conj(ifc[..., -1:]) / (denominator.real[..., None] + eps)
    return _filter(spec, w, nb_df, order, lookahead)


def wf_r_factor(inverse: bool, cholesky_decomp: bool) -> float:
    """Normalization factor of a network-estimated covariance (WF)."""
    return {(True, True): 2e3, (True, False): 3e7,
            (False, True): 2e-4, (False, False): 5e-6}[(inverse, cholesky_decomp)]


def mvdr_r_factor(inverse: bool, cholesky_decomp: bool) -> float:
    """Normalization factor of a network-estimated covariance (MVDR)."""
    return {(True, True): 2e4, (True, False): 3e8,
            (False, True): 5e-5, (False, False): 1e-6}[(inverse, cholesky_decomp)]
