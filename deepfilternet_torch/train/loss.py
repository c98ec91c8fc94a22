"""Training losses (the reference's df/loss.py), on complex tensors.

The functions and the `Loss` aggregator of `deepfilternet_tpu.train.loss`,
with the same config sections, keys and defaults ([MaskLoss],
[SpectralLoss], [MultiResSpecLoss], [SdrLoss], [LocalSnrLoss],
[DfAlphaLoss], [train] TD_LOSS_ISTFT). Autograd differentiates them; the
one custom gradient is `safe_angle`'s.

ASRLoss (Whisper-embedding distillation, `train/asr_loss.py`) joins when
[ASRLoss] factor > 0 or a Whisper model is passed; it needs local torch
Whisper weights ([ASRLoss] MODEL), which are not vendored.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from deepfilternet_torch.config import Csv, config
from deepfilternet_torch.ops.erb import erb_fb_tensor
from deepfilternet_torch.ops.lsnr import local_snr_target
from deepfilternet_torch.ops.stft import Stft, _window_tensor, istft

# ---------------------------------------------------------------------------
# mask targets (df/loss.py:18-35)
# ---------------------------------------------------------------------------


def wg(s: torch.Tensor, x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    n = x - s
    ss = torch.abs(s) ** 2
    nn = torch.abs(n) ** 2
    return torch.clamp(ss / (ss + nn + eps), 0.0, 1.0)


def irm(s: torch.Tensor, x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    n = x - s
    return torch.clamp(torch.abs(s) / (torch.abs(s) + torch.abs(n) + eps), 0.0, 1.0)


def iam(s: torch.Tensor, x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return torch.clamp(torch.abs(s) / (torch.abs(x) + eps), 0.0, 1.0)


_MASK_FNS = {"wg": wg, "irm": irm, "iam": iam}


# ---------------------------------------------------------------------------
# the time-domain round trip of the time-domain losses
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _hann_window(n: int, device: torch.device) -> torch.Tensor:
    return torch.hann_window(n, periodic=True, device=device)


def hann_stft(x: torch.Tensor, n_fft: int, hop: Optional[int] = None) -> torch.Tensor:
    """torch.stft with a periodic hann window, reflect-padded centre frames
    and 1/sqrt(n_fft) normalization: x [..., T] -> [..., T // hop + 1, F]
    complex."""
    hop = hop or n_fft // 4
    spec = torch.stft(x.reshape(-1, x.shape[-1]), n_fft, hop_length=hop,
                      window=_hann_window(n_fft, x.device), center=True, pad_mode="reflect",
                      normalized=True, return_complex=True).transpose(-1, -2)
    return spec.reshape(x.shape[:-1] + spec.shape[-2:])


def loss_istft(spec: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor) -> torch.Tensor:
    """The reference trainer's Istft (df/loss.py:66-92): one zero frame
    appended, then `torch.istft(normalized=True, center=True)` with the
    analysis window. spec: [..., T, F] complex -> [..., hop*T].

    This is not the DSP inverse (`ops.stft.istft`): the normalized istft
    multiplies frames by sqrt(n_fft) and divides by the window-square
    envelope, so on this package's forward-normalized spectra it gives
    `c * x` with `c = sqrt(n_fft) * wnorm` (~0.0323 at 960/480). The
    reference computes every time-domain loss on these scaled signals, so
    config factors keep their meaning only with the same scale.
    """
    t, f = spec.shape[-2:]
    s = spec.reshape(-1, t, f)
    s = torch.cat([s, s.new_zeros((s.shape[0], 1, f))], dim=1).transpose(1, 2)
    y = torch.istft(s, n_fft, hop_length=hop, window=window, center=True, normalized=True)
    return y.reshape(spec.shape[:-2] + (hop * t,))


# ---------------------------------------------------------------------------
# individual losses
# ---------------------------------------------------------------------------


class _SafeAngle(torch.autograd.Function):
    """atan2(im, re) whose backward clamps |z|^2 at 1e-10."""

    @staticmethod
    def forward(ctx, re, im):
        ctx.save_for_backward(re, im)
        return torch.atan2(im, re)

    @staticmethod
    def backward(ctx, g):
        re, im = ctx.saved_tensors
        gi = g / torch.clamp(re * re + im * im, min=1e-10)
        return -im * gi, re * gi


def safe_angle(z: torch.Tensor) -> torch.Tensor:
    """The angle of z with the zero-magnitude-robust gradient of the
    reference's `angle` autograd Function (df/utils.py:48-74): exact-zero
    bins (silence, padding) get a zero gradient instead of NaN."""
    return _SafeAngle.apply(z.real, z.imag)


def _compress(x_abs: torch.Tensor, gamma: float) -> torch.Tensor:
    return torch.clamp(x_abs, min=1e-12) ** gamma if gamma != 1.0 else x_abs


def spectral_loss(
    enhanced: torch.Tensor,
    clean: torch.Tensor,
    gamma: float = 1.0,
    factor_magnitude: float = 1.0,
    factor_complex: float = 1.0,
    factor_under: float = 1.0,
) -> torch.Tensor:
    """df/loss.py:137-177: gamma-compressed magnitude MSE (+ complex MSE),
    weighted up where the estimate undershoots."""
    e_abs = _compress(torch.abs(enhanced), gamma)
    c_abs = _compress(torch.abs(clean), gamma)
    tmp = (e_abs - c_abs) ** 2
    if factor_under != 1.0:
        tmp = tmp * torch.where(e_abs < c_abs, factor_under, 1.0)
    loss = torch.mean(tmp) * factor_magnitude
    if factor_complex > 0:
        if gamma != 1.0:
            e = torch.polar(e_abs, safe_angle(enhanced))
            c = torch.polar(c_abs, safe_angle(clean))
        else:
            e, c = enhanced, clean
        loss = loss + torch.mean(torch.abs(e - c) ** 2) / 2.0 * factor_complex
    return loss


def multi_res_spec_loss(
    enhanced_td: torch.Tensor,
    clean_td: torch.Tensor,
    n_ffts: Sequence[int] = (512, 1024, 2048),
    gamma: float = 1.0,
    factor: float = 1.0,
    factor_complex: float = 0.0,
) -> torch.Tensor:
    """df/loss.py:95-134 over time-domain signals [B, T]."""
    loss = enhanced_td.new_zeros(())
    for n_fft in n_ffts:
        y = hann_stft(enhanced_td, n_fft)
        s = hann_stft(clean_td, n_fft)
        y_abs = _compress(torch.abs(y), gamma)
        s_abs = _compress(torch.abs(s), gamma)
        loss = loss + torch.mean((y_abs - s_abs) ** 2) * factor
        if factor_complex > 0:
            if gamma != 1.0:
                y = torch.polar(y_abs, safe_angle(y))
                s = torch.polar(s_abs, safe_angle(s))
            loss = loss + torch.mean(torch.abs(y - s) ** 2) / 2.0 * factor_complex
    return loss


def mask_loss(
    pred_mask: torch.Tensor,
    clean: torch.Tensor,
    noisy: torch.Tensor,
    erb_fb: torch.Tensor,
    mask: str = "iam",
    gamma: float = 0.6,
    gamma_pred: float = 0.6,
    powers: Sequence[int] = (2, 4),
    factors: Sequence[float] = (1.0, 10.0),
    f_under: float = 2.0,
    factor: float = 1.0,
    eps: float = 1e-12,
    max_bin_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """df/loss.py:180-277. pred_mask: [B, T, E]; clean/noisy: [B, T, F]
    complex; erb_fb: [F, E] normalized forward matrix."""
    g_t = (_MASK_FNS[mask](clean, noisy) @ erb_fb) ** gamma
    g_p = torch.clamp(pred_mask, min=eps) ** gamma_pred
    tmp = (g_t - g_p) ** 2
    if f_under != 1.0:
        tmp = tmp * torch.where(g_p < g_t, f_under, 1.0)
    if max_bin_mask is not None:
        tmp = tmp * max_bin_mask
    loss = pred_mask.new_zeros(())
    for power, fct in zip(powers, factors):
        loss = loss + torch.mean(torch.clamp(tmp, min=1e-13) ** (power // 2)) * fct * factor
    return loss


def si_sdr(enhanced: torch.Tensor, target: torch.Tensor,
           eps: float = float(np.finfo(np.float32).eps)) -> torch.Tensor:
    """Scale-invariant SDR per row [B, T] -> [B] in dB (df/loss.py:345-373)."""
    rss = torch.sum(target * target, dim=-1, keepdim=True)
    a = (torch.sum(target * enhanced, dim=-1, keepdim=True) + eps) / (rss + eps)
    e_true = a * target
    e_res = enhanced - e_true
    sss = torch.sum(e_true ** 2, dim=-1)
    snn = torch.sum(e_res ** 2, dim=-1)
    return 10.0 * torch.log10((sss + eps) / (snn + eps))


def sdr_loss(enhanced_td: torch.Tensor, clean_td: torch.Tensor,
             factor: float = 0.2) -> torch.Tensor:
    return -torch.mean(si_sdr(enhanced_td, clean_td)) * factor


def seg_sdr_loss(enhanced_td: torch.Tensor, clean_td: torch.Tensor,
                 window_sizes: Sequence[int], factor: float = 0.2,
                 overlap: float = 0.0) -> torch.Tensor:
    loss = enhanced_td.new_zeros(())
    for ws in window_sizes:
        ws = min(ws, enhanced_td.shape[-1])
        hop = max(int((1 - overlap) * ws), 1)
        e = enhanced_td.unfold(-1, ws, hop).reshape(-1, ws)
        c = clean_td.unfold(-1, ws, hop).reshape(-1, ws)
        loss = loss + torch.mean(si_sdr(e, c))
    return -loss * factor


def local_snr_loss(pred_lsnr: torch.Tensor, target_lsnr: torch.Tensor,
                   factor: float = 1.0) -> torch.Tensor:
    """pred_lsnr: [B, T, 1]; target: [B, T] (df/loss.py:408-416)."""
    return torch.mean((pred_lsnr[..., 0] - target_lsnr) ** 2) * factor


def df_alpha_loss(
    pred_alpha: torch.Tensor,
    target_lsnr: torch.Tensor,
    factor: float = 1.0,
    lsnr_thresh: float = -7.5,
    lsnr_min: float = -10.0,
) -> torch.Tensor:
    """The DFN1/DFN2 alpha head's penalty (df/loss.py:297-342)."""

    def mapping(lsnr, thresh, lo):
        a_ = 1.0 / (thresh - lo)
        b_ = -a_ * lo
        return 1.0 - torch.clamp(a_ * lsnr + b_, 0.0, 1.0)

    w_off = mapping(target_lsnr, lsnr_thresh, lsnr_min)[..., None]
    l_off = torch.mean((pred_alpha * w_off) ** 2)
    w_on = mapping(target_lsnr, lsnr_thresh + 2.5, 0.0)[..., None]
    l_on = 0.1 * torch.mean(torch.abs((1.0 - pred_alpha) * w_on))
    return (l_off + l_on) * factor


# ---------------------------------------------------------------------------
# aggregator
# ---------------------------------------------------------------------------


class Loss:
    """Config-wired loss aggregator (df/loss.py:651-804).

    Call with complex spectra in the model's STFT domain:
        loss_fn(clean, noisy, enhanced, mask, lsnr, df_alpha=None)
            -> (total, {part: value})
    All inputs [B, T, F] complex but mask [B, T, E], lsnr and df_alpha
    [B, T, 1]; the constants live on the inputs' device.
    """

    def __init__(self, stft_cfg: Stft, erb_widths_: Sequence[int], nb_df: int,
                 lsnr_range: Tuple[float, float], asr_model=None):
        self.stft_cfg = stft_cfg
        self.nb_df = nb_df
        self.lsnr_range = lsnr_range
        self.erb_widths = tuple(int(w) for w in erb_widths_)
        c = config
        self.ml_f = c("factor", 0.0, float, section="MaskLoss")
        self.ml_mask = c("mask", "iam", str, section="MaskLoss")
        self.ml_gamma = c("gamma", 0.6, float, section="MaskLoss")
        self.ml_gamma_pred = c("gamma_pred", 0.6, float, section="MaskLoss")
        self.ml_f_under = c("f_under", 2.0, float, section="MaskLoss")
        ml_max_freq = c("max_freq", 0.0, float, section="MaskLoss")
        self.ml_f_max_idx = (
            int(ml_max_freq / (stft_cfg.sr / stft_cfg.fft_size)) if ml_max_freq > 0 else None
        )
        self.dfalpha_f = c("factor", 0.0, float, section="DfAlphaLoss")
        self.dfalpha_thresh = c("lsnr_thresh", -7.5, float, section="DfAlphaLoss")
        self.dfalpha_min = c("lsnr_min", -10.0, float, section="DfAlphaLoss")
        self.sl_fm = c("factor_magnitude", 0.0, float, section="SpectralLoss")
        self.sl_fc = c("factor_complex", 0.0, float, section="SpectralLoss")
        self.sl_fu = c("factor_under", 1.0, float, section="SpectralLoss")
        self.sl_gamma = c("gamma", 1.0, float, section="SpectralLoss")
        self.mrsl_f = c("factor", 0.0, float, section="MultiResSpecLoss")
        self.mrsl_fc = c("factor_complex", 0.0, float, section="MultiResSpecLoss")
        self.mrsl_gamma = c("gamma", 1.0, float, section="MultiResSpecLoss")
        self.mrsl_ffts = tuple(
            int(v) for v in c("fft_sizes", (512, 1024, 2048), Csv(int), section="MultiResSpecLoss")
        )
        self.sdrl_f = c("factor", 0.0, float, section="SdrLoss")
        self.sdrl_seg_ws = tuple(int(v) for v in c("segmental_ws", (), Csv(int), section="SdrLoss"))
        self.lsnr_f = c("factor", 0.0005, float, section="LocalSnrLoss")
        # how the time-domain losses (MRSL, SDR) get their signals: "torch"
        # is the reference trainer's normalized istft (`loss_istft`, scaled
        # signals), "exact" the DSP inverse (true amplitude)
        self.td_istft = c("TD_LOSS_ISTFT", "torch", str, section="train")
        if self.td_istft not in ("torch", "exact"):
            raise ValueError(f"TD_LOSS_ISTFT must be 'torch' or 'exact', not {self.td_istft!r}")
        asrl_f = c("factor", 0.0, float, section="ASRLoss")
        self.asr_loss = None
        if asrl_f > 0 or asr_model is not None:
            from deepfilternet_torch.train.asr_loss import ASRLoss

            self.asr_loss = ASRLoss(
                sr=stft_cfg.sr,
                factor=asrl_f,
                factor_lm=c("factor_lm", 1.0, float, section="ASRLoss"),
                loss_lm=c("loss_lm", "CrossEntropy", str, section="ASRLoss"),
                model=c("model", "", str, section="ASRLoss"),
                whisper_model=asr_model,
            )

    def __call__(
        self,
        clean: torch.Tensor,
        noisy: torch.Tensor,
        enhanced: torch.Tensor,
        mask: torch.Tensor,
        lsnr: torch.Tensor,
        df_alpha: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        p = self.stft_cfg
        dev = clean.device
        losses: Dict[str, torch.Tensor] = {}
        lsnr_gt = local_snr_target(
            clean, noisy - clean, p.sr, p.fft_size, p.hop_size,
            (self.lsnr_range[0] - 1, self.lsnr_range[1] + 1),
        )
        if self.ml_f != 0:
            if self.ml_mask == "spec":
                # MaskSpecLoss (df/loss.py:280-294): the ERB mask applied to
                # the noisy spectrum, a spectral loss against clean
                enh_m = noisy * (mask @ erb_fb_tensor(self.erb_widths, dev, inverse=True))
                cl = clean
                if self.ml_f_max_idx is not None:
                    enh_m = enh_m[..., : self.ml_f_max_idx]
                    cl = cl[..., : self.ml_f_max_idx]
                losses["mask"] = spectral_loss(enh_m, cl, gamma=self.ml_gamma,
                                               factor_magnitude=self.ml_f, factor_complex=0.0)
            else:
                losses["mask"] = mask_loss(
                    mask, clean, noisy, erb_fb_tensor(self.erb_widths, dev),
                    mask=self.ml_mask, gamma=self.ml_gamma, gamma_pred=self.ml_gamma_pred,
                    f_under=self.ml_f_under, factor=self.ml_f,
                )
        if self.sl_fm + self.sl_fc > 0:
            losses["spectral"] = spectral_loss(
                enhanced, clean, gamma=self.sl_gamma, factor_magnitude=self.sl_fm,
                factor_complex=self.sl_fc, factor_under=self.sl_fu,
            )
        if self.mrsl_f > 0 or self.sdrl_f != 0 or self.asr_loss is not None:
            if self.td_istft == "torch":
                win = _window_tensor(p.fft_size, dev)
                enhanced_td = loss_istft(enhanced, p.fft_size, p.hop_size, win)
                clean_td = loss_istft(clean, p.fft_size, p.hop_size, win)
            else:
                enhanced_td = istft(enhanced, p)
                clean_td = istft(clean, p)
        if self.mrsl_f > 0:
            losses["mrsl"] = multi_res_spec_loss(
                enhanced_td, clean_td, self.mrsl_ffts, gamma=self.mrsl_gamma,
                factor=self.mrsl_f, factor_complex=self.mrsl_fc,
            )
        if self.sdrl_f != 0:
            if any(w > 0 for w in self.sdrl_seg_ws):
                losses["sdr"] = seg_sdr_loss(enhanced_td, clean_td, self.sdrl_seg_ws,
                                             factor=self.sdrl_f)
            else:
                losses["sdr"] = sdr_loss(enhanced_td, clean_td, factor=self.sdrl_f)
        if self.lsnr_f != 0:
            losses["lsnr"] = local_snr_loss(lsnr, lsnr_gt, factor=self.lsnr_f)
        if self.dfalpha_f != 0 and df_alpha is not None:
            losses["df_alpha"] = df_alpha_loss(
                df_alpha, lsnr_gt, factor=self.dfalpha_f,
                lsnr_thresh=self.dfalpha_thresh, lsnr_min=self.dfalpha_min,
            )
        if self.asr_loss is not None:
            losses["asr"] = self.asr_loss(enhanced_td, clean_td)
        total = clean.real.new_zeros(())
        for v in losses.values():
            total = total + v
        return total, losses
