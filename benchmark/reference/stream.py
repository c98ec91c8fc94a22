"""DeepFilterNet3 streaming, and DFN2 offline enhancement, in plain PyTorch.

Streaming follows libDF's `DFState` and DeepFilterNet's real-time loop: a
stream's carry is its analysis and synthesis memories, the two feature norm
trackers, its count of quiet frames and the model's carry. A call takes a
block of whole hops and runs every stage over all of its frames at once;
only the recurrences run frame after frame. The runtime stages are at their
defaults: no attenuation limit, no post-filter, no LSNR gating; after 5
frames in a row whose RMS is under 1e-7 the output is silence.

Offline enhancement is `enhance()`'s: pad by fft, analysis from a zero
memory, the features, the model, synthesis, and the fft - hop delay
trimmed.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import dsp
from benchmark.reference.models import dfn2_forward, dfn3_forward, zero_carry

SILENCE_RMS, SILENCE_FRAMES = 1e-7, 5


def init_carry(cfg: Dict, rows: int, device) -> Dict[str, torch.Tensor]:
    d = cfg["fft_size"] - cfg["hop_size"]
    return dict(
        analysis_mem=torch.zeros((rows, d), device=device),
        synthesis_mem=torch.zeros((rows, d), device=device),
        mean_norm=dsp.norm_init(dsp.MEAN_NORM_INIT, cfg["nb_erb"], rows, device),
        unit_norm=dsp.norm_init(dsp.UNIT_NORM_INIT, cfg["nb_df"], rows, device),
        silence_ctr=torch.zeros((rows,), dtype=torch.int64, device=device),
        **zero_carry(cfg, rows, device),
    )


def _features(cfg, re, im, mean0, unit0):
    """(erb features, complex features, mean track, unit track) of a block."""
    nb_df = cfg["nb_df"]
    alpha = dsp.norm_alpha(cfg["sr"], cfg["hop_size"], cfg["norm_tau"])
    power = re ** 2 + im ** 2
    erb_db = 10.0 * torch.log10(power @ dsp.erb_fb(cfg["erb_widths"], re.device) + 1e-10)
    mtrack = dsp.ema(erb_db, mean0, alpha)
    utrack = dsp.ema(torch.sqrt(power[..., :nb_df]), unit0, alpha)
    scale = torch.rsqrt(utrack)
    feat_spec = torch.complex(re[..., :nb_df] * scale, im[..., :nb_df] * scale)
    return (erb_db - mtrack) / 40.0, feat_spec, mtrack, utrack


def stream_block(W, cfg: Dict, carry: Dict, audio: torch.Tensor):
    """One call of the streaming runtime: audio [S, T * hop] -> (carry',
    enhanced [S, T * hop], delayed by fft - hop). W = (params, state,
    statics)."""
    fft, hop = cfg["fft_size"], cfg["hop_size"]
    s, t = audio.shape[0], audio.shape[1] // hop
    re, im, amem = dsp.analysis(carry["analysis_mem"], audio, fft, hop)
    feat_erb, feat_spec, mtrack, utrack = _features(cfg, re, im, carry["mean_norm"],
                                                    carry["unit_norm"])
    spec_e, _, _, mcarry, _ = dfn3_forward(*W, cfg, carry, torch.complex(re, im),
                                           feat_erb, feat_spec)
    rms = torch.sqrt(torch.mean(audio.reshape(s, t, hop) ** 2, dim=-1))
    ctr, ctrs = carry["silence_ctr"], []
    for k in range(t):
        ctr = torch.where(rms[:, k] < SILENCE_RMS, ctr + 1, torch.zeros_like(ctr))
        ctrs.append(ctr)
    quiet = (torch.stack(ctrs, dim=1) >= SILENCE_FRAMES)[..., None]
    spec_e = torch.where(quiet, torch.zeros_like(spec_e), spec_e)
    out, smem = dsp.synthesis(carry["synthesis_mem"], spec_e.real, spec_e.imag, fft, hop)
    new = dict(analysis_mem=amem, synthesis_mem=smem, mean_norm=mtrack[:, -1],
               unit_norm=utrack[:, -1], silence_ctr=ctr, **mcarry)
    return new, out


def offline_enhance(W, cfg: Dict, audio: torch.Tensor) -> torch.Tensor:
    """`enhance(model, df_state, audio)` of the configuration's model:
    audio [C, T] -> [C, T]."""
    fft, hop = cfg["fft_size"], cfg["hop_size"]
    n = audio.shape[-1]
    x = torch.nn.functional.pad(audio, (0, fft))
    x = x[:, : (x.shape[-1] // hop) * hop]
    rows = x.shape[0]
    zero = x.new_zeros((rows, fft - hop))
    re, im, _ = dsp.analysis(zero, x, fft, hop)
    feat_erb, feat_spec, _, _ = _features(
        cfg, re, im, dsp.norm_init(dsp.MEAN_NORM_INIT, cfg["nb_erb"], rows, x.device),
        dsp.norm_init(dsp.UNIT_NORM_INIT, cfg["nb_df"], rows, x.device))
    spec = torch.complex(re, im)
    if cfg["model"] == "deepfilternet2":
        spec_e = dfn2_forward(*W, cfg, spec, feat_erb, feat_spec)
    else:
        spec_e = dfn3_forward(*W, cfg, zero_carry(cfg, rows, x.device), spec, feat_erb,
                              feat_spec)[0]
    out, _ = dsp.synthesis(zero, spec_e.real, spec_e.imag, fft, hop)
    d = fft - hop
    return out[:, d:n + d]
