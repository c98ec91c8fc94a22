"""Streaming inference runtime: one 10 ms hop at a time for a batch of
independent streams.

The per-frame pipeline is STFT analysis with the ERB/complex features and
their exponential norms (one fused frontend kernel on a CUDA device), the
DFN streaming cell, the post-model runtime stages (mask reduction, LSNR
gating, attenuation limit), the RMS silence skip and the iDFT synthesis with
overlap-add. Semantics are those of the JAX package's `StreamingRuntime`;
its XLA scheduling options (`fused`, `fuse_ops`, `unroll`, `packed_carry`,
`fuse_convs`, `fuse_gru_pairs`, `use_pallas`) have no counterpart here: the
frontend always goes through the kernel wrapper and the rest runs eagerly.

API:
    rt = StreamingRuntime(model, df_state)       # from enhance.init_df
    carry = rt.init(n_streams)
    carry, enhanced = rt.process(carry, audio)   # audio [S, k*hop]
    carry, frame = rt.process_frame(carry, f)    # single hop
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from deepfilternet_torch.config import config
from deepfilternet_torch.ops.erb import erb_fb_tensor
from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend
from deepfilternet_torch.ops.norms import get_norm_alpha, mean_norm_init, unit_norm_init
from deepfilternet_torch.ops.postfilter import post_filter
from deepfilternet_torch.ops.stft import Stft, synthesis_step_ri


class StreamCarry(NamedTuple):
    analysis_mem: torch.Tensor  # [S, fft-hop]
    synthesis_mem: torch.Tensor  # [S, fft-hop]
    mean_norm: torch.Tensor  # [S, E]
    unit_norm: torch.Tensor  # [S, F']
    silence_ctr: torch.Tensor  # [S] int32, consecutive sub-threshold frames
    model: Any  # the model's StreamState


class RuntimeParams(NamedTuple):
    """Streaming runtime knobs."""

    atten_lim_db: float = 0.0          # 0 disables the mixback limit
    post_filter_beta: float = 0.0      # >0 enables the post-filter
    lsnr_min: float = -10.0            # below: output silenced
    lsnr_max_erb: float = 30.0         # above: bypass both stages
    lsnr_max_df: float = 20.0          # above: ERB gains only, no DF
    lsnr_gating: bool = False          # enable the LSNR stage gating
    silence_rms_thresh: float = 1e-7   # RMS silence skip
    silence_skip_frames: int = 5
    reduce_mask: str = "none"          # none|max|mean over channel groups
    n_channels: int = 1


class StreamingRuntime:
    def __init__(self, model, df_state, params: RuntimeParams = RuntimeParams(),
                 dtype: torch.dtype = torch.float32):
        if dtype != torch.float32:
            raise NotImplementedError(
                "only float32 is ported; the reduced-precision runtime is a "
                "later ROADMAP item"
            )
        self.model = model
        self.df_state = df_state
        self.device = model.device
        self.cfg = model.cfg
        self.rt = params
        if params.post_filter_beta > 0:
            self.cfg = dict(self.cfg, mask_pf=True, pf_beta=params.post_filter_beta)
        self.stft_cfg: Stft = df_state.stft_cfg
        self.alpha = get_norm_alpha(
            df_state.sr, df_state.hop_size, config("NORM_TAU", 1.0, float, section="DF")
        )
        self.nb_df = self.cfg["nb_df"]
        self.nb_erb = self.cfg["nb_erb"]

    # -- state ---------------------------------------------------------------

    def init(self, n_streams: int) -> StreamCarry:
        d = self.stft_cfg.fft_size - self.stft_cfg.hop_size
        dev = self.device

        def rows(v):
            return torch.tensor(v, device=dev).repeat(n_streams, 1)

        return StreamCarry(
            analysis_mem=torch.zeros((n_streams, d), device=dev),
            synthesis_mem=torch.zeros((n_streams, d), device=dev),
            mean_norm=rows(mean_norm_init(self.nb_erb)),
            unit_norm=rows(unit_norm_init(self.nb_df)),
            silence_ctr=torch.zeros((n_streams,), dtype=torch.int32, device=dev),
            model=self.model.module.streaming_init(n_streams, self.cfg, device=dev),
        )

    # -- per-frame cell ------------------------------------------------------

    def _cell(self, carry: StreamCarry, frame: torch.Tensor
              ) -> Tuple[StreamCarry, torch.Tensor]:
        """frame: [S, hop], contiguous -> (carry', enhanced [S, hop])."""
        amem, spec_re, spec_im, feat_erb, fc_re, fc_im, mn, un = fused_analysis_frontend(
            carry.analysis_mem, frame, carry.mean_norm, carry.unit_norm,
            fft_size=self.stft_cfg.fft_size, hop_size=self.stft_cfg.hop_size,
            nb_erb=self.nb_erb, nb_df=self.nb_df,
            min_nb_erb_freqs=self.df_state.min_nb_erb_freqs,
            alpha=self.alpha, sr=self.df_state.sr,
        )
        feat_cplx_ri = torch.stack([fc_re, fc_im], dim=-1)
        spec = torch.complex(spec_re, spec_im)
        spec_ri = torch.stack([spec_re, spec_im], dim=-1)
        mstate, (spec_e_ri, lsnr, mask) = self.model.module.streaming_cell(
            self.model.params, self.model.state, self.cfg, carry.model,
            spec_ri, feat_erb, feat_cplx_ri,
        )
        spec_e = self._apply_runtime_stages(
            spec, torch.complex(spec_e_ri[..., 0], spec_e_ri[..., 1]), lsnr, mask
        )

        # RMS silence skip: after `silence_skip_frames` consecutive quiet
        # frames, output zeros
        rt = self.rt
        frame_rms = torch.sqrt(torch.mean(frame**2, dim=-1))
        quiet = frame_rms < rt.silence_rms_thresh
        ctr = torch.where(quiet, carry.silence_ctr + 1, torch.zeros_like(carry.silence_ctr))
        spec_e = torch.where((ctr >= rt.silence_skip_frames)[:, None],
                             torch.zeros_like(spec_e), spec_e)

        smem, out = synthesis_step_ri(carry.synthesis_mem, spec_e.real, spec_e.imag,
                                      self.stft_cfg)
        return StreamCarry(amem, smem, mn, un, ctr, mstate), out

    def _apply_runtime_stages(self, spec, spec_e, lsnr, mask):
        """Post-model RuntimeParams stages. spec/spec_e complex [S, F],
        lsnr [S, 1], mask [S, E]."""
        rt, cfg = self.rt, self.cfg
        inv_fb = erb_fb_tensor(cfg["erb_widths"], spec.device, inverse=True)

        # multichannel mask reduction: streams are (stream, channel) groups;
        # the ERB-mask stage is shared, the DF bins stay per channel
        if rt.reduce_mask != "none" and rt.n_channels > 1:
            c = rt.n_channels
            nb_df = cfg["nb_df"]
            mg = mask.reshape(-1, c, *mask.shape[1:])
            mg = mg.amax(dim=1) if rt.reduce_mask == "max" else mg.mean(dim=1)
            mask = torch.repeat_interleave(mg, c, dim=0)
            upper = (spec * (mask @ inv_fb))[..., nb_df:]
            if cfg.get("mask_pf"):
                upper = post_filter(spec[..., nb_df:], upper, beta=cfg.get("pf_beta", 0.02))
            spec_e = torch.cat([spec_e[..., :nb_df], upper.to(torch.complex64)], dim=-1)

        # LSNR-gated stage selection: all stages are computed and selected
        # per stream
        if rt.lsnr_gating:
            ls = lsnr[..., 0]
            spec_m = spec * (mask @ inv_fb)
            zero = torch.zeros_like(spec)
            spec_e = torch.where((ls < rt.lsnr_min)[..., None], zero, spec_e)
            spec_e = torch.where(
                ((ls > rt.lsnr_max_df) & (ls <= rt.lsnr_max_erb))[..., None],
                spec_m, spec_e,
            )
            spec_e = torch.where((ls > rt.lsnr_max_erb)[..., None], spec, spec_e)

        # attenuation-limit mixback
        if rt.atten_lim_db and abs(rt.atten_lim_db) > 0:
            lim = 10.0 ** (-abs(rt.atten_lim_db) / 20.0)
            spec_e = spec * lim + spec_e * (1.0 - lim)
        return spec_e

    # -- public API ----------------------------------------------------------

    def _audio(self, audio) -> torch.Tensor:
        if isinstance(audio, np.ndarray):
            audio = torch.from_numpy(np.ascontiguousarray(audio, dtype=np.float32))
        return audio.to(device=self.device, dtype=torch.float32)

    def process_frame(self, carry: StreamCarry, frame) -> Tuple[StreamCarry, torch.Tensor]:
        """frame: [S, hop] -> (carry', enhanced [S, hop])."""
        return self._cell(carry, self._audio(frame).contiguous())

    def process(self, carry: StreamCarry, audio) -> Tuple[StreamCarry, torch.Tensor]:
        """audio: [S, T] with T a multiple of hop. Returns [S, T] enhanced
        (delayed by fft-hop samples, streaming semantics)."""
        audio = self._audio(audio)
        hop = self.stft_cfg.hop_size
        s, t = audio.shape
        if t % hop:
            raise ValueError("process() needs whole hops")
        n = t // hop
        frames = audio.reshape(s, n, hop).transpose(0, 1).contiguous()
        out = torch.empty((n, s, hop), dtype=torch.float32, device=self.device)
        for i in range(n):
            carry, out[i] = self._cell(carry, frames[i])
        return carry, out.transpose(0, 1).reshape(s, t)
