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

`ChunkedStreamingRuntime` has the same semantics and carry but batches
`chunk_frames` frames at a time in the offline form (the model's
`forward_chunk`): no loop over frames, and no frontend kernel.

Reduced precision, as the JAX package's runtimes: `dtype=torch.bfloat16`
casts the model's float32 parameters and batch-norm statistics once, keeps
the model carry in bfloat16 except the DF ring (float32: it holds spectrum
values), and runs the model on the features cast to bfloat16; the frontend,
the norms, the runtime stages and the synthesis stay float32. `out_dtype`
casts only the synthesized output (a capacity knob: bfloat16 halves the
output buffer). The model types a family takes are its module's
`RUNTIME_DTYPES`: DFN3 both, DFN2 and DFN1 float32 (any other raises).

API:
    rt = StreamingRuntime(model, df_state)       # from enhance.init_df
    carry = rt.init(n_streams)
    carry, enhanced = rt.process(carry, audio)   # audio [S, k*hop]
    carry, frame = rt.process_frame(carry, f)    # single hop
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from deepfilternet_torch.config import config
from deepfilternet_torch.ops.erb import erb_fb_tensor
from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend
from deepfilternet_torch.ops.norms import (
    _ema_scan,
    get_norm_alpha,
    mean_norm_init,
    unit_norm_init,
)
from deepfilternet_torch.ops.postfilter import post_filter
from deepfilternet_torch.ops.stft import (
    Stft,
    _dft_tensors,
    _idft_tensors,
    overlap_add,
    synthesis_step_ri,
)


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


def _module_name(module) -> str:
    """A model module's name, or an adapter object's class name."""
    return getattr(module, "__name__", type(module).__name__)


def _cast_floats(tree, dtype: torch.dtype):
    """Every float32 leaf of a params / state tree (or NamedTuple carry) cast
    to `dtype`; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_floats(v, dtype) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_cast_floats(v, dtype) for v in tree))
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


class StreamingRuntime:
    def __init__(self, model, df_state, params: RuntimeParams = RuntimeParams(),
                 dtype: torch.dtype = torch.float32, out_dtype: torch.dtype = None):
        # the model types each family's cell is held to JAX at: DFN3 float32
        # and bfloat16, DFN1/DFN2 float32; DeepFilterNet-MF has no cell
        taken = getattr(model.module, "RUNTIME_DTYPES", ())
        if dtype not in taken:
            raise NotImplementedError(
                f"dtype {dtype}: the streaming runtimes take {_module_name(model.module)} at "
                f"{' or '.join(map(str, taken)) or 'no type (it has no streaming form)'} "
                "(ROADMAP: the other families at bfloat16)")
        if out_dtype is not None and not out_dtype.is_floating_point:
            raise ValueError(f"out_dtype must be a floating type, got {out_dtype}")
        self.dtype = dtype
        self.out_dtype = out_dtype
        if dtype != torch.float32:
            # weights and batch-norm statistics cast once; the features are
            # cast per frame
            model = dataclasses.replace(model, params=_cast_floats(model.params, dtype),
                                        state=_cast_floats(model.state, dtype), _cache={})
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
            model=self._init_model_carry(n_streams),
        )

    def _init_model_carry(self, n_streams: int):
        carry = self.model.module.streaming_init(n_streams, self.cfg, device=self.device)
        if self.dtype == torch.float32:
            return carry
        # the DF ring holds spectrum values and stays float32, as the cell
        # writes it back from a complex64 MAC
        keep = {f: getattr(carry, f) for f in carry._fields if "ring" in f}
        return _cast_floats(carry, self.dtype)._replace(**keep)

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
        dt = self.dtype
        mstate, (spec_e_ri, lsnr, mask) = self.model.module.streaming_cell(
            self.model.params, self.model.state, self.cfg, carry.model,
            spec_ri.to(dt), feat_erb.to(dt), feat_cplx_ri.to(dt),
        )
        spec_e_ri, lsnr, mask = (x.to(torch.float32) for x in (spec_e_ri, lsnr, mask))
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
        return StreamCarry(amem, smem, mn, un, ctr, mstate), self._out(out)

    def _out(self, out: torch.Tensor) -> torch.Tensor:
        return out if self.out_dtype is None else out.to(self.out_dtype)

    def _apply_runtime_stages(self, spec, spec_e, lsnr, mask):
        """Post-model RuntimeParams stages. spec/spec_e complex [S, F],
        lsnr [S, 1], mask [S, E]; or [S, T, ...] for a chunk."""
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

    def _frames(self, audio) -> Tuple[torch.Tensor, int]:
        """audio [S, T] -> (audio on the device, T // hop); raises unless T
        is a multiple of hop."""
        audio = self._audio(audio)
        if audio.shape[1] % self.stft_cfg.hop_size:
            raise ValueError("process() needs whole hops")
        return audio, audio.shape[1] // self.stft_cfg.hop_size

    def process(self, carry: StreamCarry, audio) -> Tuple[StreamCarry, torch.Tensor]:
        """audio: [S, T] with T a multiple of hop. Returns [S, T] enhanced
        (delayed by fft-hop samples, streaming semantics)."""
        audio, n = self._frames(audio)
        hop = self.stft_cfg.hop_size
        s, t = audio.shape
        frames = audio.reshape(s, n, hop).transpose(0, 1).contiguous()
        out = torch.empty((n, s, hop), dtype=self.out_dtype or torch.float32,
                          device=self.device)
        for i in range(n):
            carry, out[i] = self._cell(carry, frames[i])
        return carry, out.transpose(0, 1).reshape(s, t)


# ---------------------------------------------------------------------------
# chunked runtime: the frame-parallel pipeline with an explicit carried state
# ---------------------------------------------------------------------------


class ChunkedStreamingRuntime(StreamingRuntime):
    """Streaming with offline-style batching per chunk.

    Audio goes `chunk_frames` frames at a time: analysis (hop-reshape
    framing and the DFT matrices), features and their norms (blocked scans
    seeded from the carry), the model's `forward_chunk`, the runtime stages,
    the silence skip and the synthesis (iDFT matrices, overlap-add with the
    carried tail) each run over all frames of the chunk at once; only the GRU
    recurrences run frame after frame, inside one `aten.gru` call a stack.
    Same semantics and carry as `StreamingRuntime`: chunk and call
    boundaries are state-continuous. The frontend kernel is never launched.

    Needs a model module with `forward_chunk`.
    """

    def __init__(self, model, df_state, params: RuntimeParams = RuntimeParams(),
                 dtype: torch.dtype = torch.float32, chunk_frames: int = 20):
        if not hasattr(model.module, "forward_chunk"):
            raise NotImplementedError(
                f"model module {_module_name(model.module)} has no forward_chunk; "
                "use StreamingRuntime"
            )
        super().__init__(model, df_state, params, dtype)
        if chunk_frames < 1:
            raise ValueError("chunk_frames must be at least 1")
        self.chunk_frames = chunk_frames

    def _chunk_body(self, carry: StreamCarry, audio: torch.Tensor
                    ) -> Tuple[StreamCarry, torch.Tensor]:
        """One frame-parallel chunk: audio [S, t*hop] -> (carry', out [S, t*hop])."""
        hop, fft = self.stft_cfg.hop_size, self.stft_cfg.fft_size
        d = fft - hop
        s, t = audio.shape[0], audio.shape[1] // hop
        nb_df, alpha, dev = self.nb_df, self.alpha, self.device

        # analysis: frame t is hops t .. t+r-1 of [memory | audio]
        buf = torch.cat([carry.analysis_mem, audio], dim=-1)
        r = fft // hop
        hops = buf.reshape(s, t + r - 1, hop)
        frames = torch.cat([hops[:, k:k + t] for k in range(r)], dim=-1)  # [S, T, fft]
        cos_m, sin_m = _dft_tensors(fft, hop, dev)
        re, im = frames @ cos_m, frames @ sin_m
        # features, the norms as blocked scans seeded from the carry
        power = re**2 + im**2
        erb_db = 10.0 * torch.log10(power @ erb_fb_tensor(self.cfg["erb_widths"], dev) + 1e-10)
        mtrack = _ema_scan(erb_db, carry.mean_norm, alpha, axis=1)
        utrack = _ema_scan(torch.sqrt(power[..., :nb_df]), carry.unit_norm, alpha, axis=1)
        scale = torch.rsqrt(utrack)
        feat_spec = torch.stack([re[..., :nb_df] * scale, im[..., :nb_df] * scale], dim=-1)
        dt = self.dtype
        mcarry, (spec_e_ri, lsnr, mask) = self.model.module.forward_chunk(
            self.model.params, self.model.state, self.cfg, carry.model,
            torch.stack([re, im], dim=-1).to(dt), ((erb_db - mtrack) / 40.0).to(dt),
            feat_spec.to(dt),
        )
        spec_e_ri, lsnr, mask = (x.to(torch.float32) for x in (spec_e_ri, lsnr, mask))
        spec_e = self._apply_runtime_stages(
            torch.complex(re, im), torch.complex(spec_e_ri[..., 0], spec_e_ri[..., 1]),
            lsnr, mask,
        )

        # RMS silence skip: the quiet-frame counter is t - (last loud frame
        # index <= t), a cummax over loud frames' indices seeded by the
        # carried counter; the seed saturates at the skip threshold (only
        # ctr >= threshold matters), which keeps it above the quiet marker
        rt = self.rt
        rms = torch.sqrt(torch.mean(audio.reshape(s, t, hop) ** 2, dim=-1))
        tidx = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
        loud_idx = torch.where(rms < rt.silence_rms_thresh, torch.full_like(tidx, -(2**30)), tidx)
        seed = (-1 - torch.clamp(carry.silence_ctr, max=rt.silence_skip_frames))[:, None]
        last_loud = torch.cummax(torch.cat([seed, loud_idx], dim=1), dim=1).values[:, 1:]
        ctr = tidx - last_loud  # [S, T]
        spec_e = torch.where((ctr >= rt.silence_skip_frames)[..., None],
                             torch.zeros_like(spec_e), spec_e)

        # synthesis: iDFT of all frames, overlap-add, the carried tail added
        re_m, im_m = _idft_tensors(fft, dev)
        full = overlap_add(spec_e.real @ re_m + spec_e.imag @ im_m, hop)  # [S, t*hop + d]
        full[:, :d] += carry.synthesis_mem
        new_carry = StreamCarry(
            analysis_mem=buf[:, buf.shape[1] - d:],
            synthesis_mem=full[:, t * hop:],
            mean_norm=mtrack[:, -1],
            unit_norm=utrack[:, -1],
            silence_ctr=ctr[:, -1].contiguous(),
            model=mcarry,
        )
        return new_carry, full[:, : t * hop]

    def process_frame(self, carry: StreamCarry, frame) -> Tuple[StreamCarry, torch.Tensor]:
        """frame: [S, hop] -> (carry', enhanced [S, hop]), as a chunk of one."""
        return self.process(carry, frame)

    def process(self, carry: StreamCarry, audio) -> Tuple[StreamCarry, torch.Tensor]:
        """audio: [S, T] with T a multiple of hop: whole chunks of
        `chunk_frames` frames, then one shorter chunk for the rest. Returns
        [S, T] enhanced (delayed by fft-hop samples)."""
        audio, _ = self._frames(audio)
        step = self.chunk_frames * self.stft_cfg.hop_size
        outs = []
        for lo in range(0, audio.shape[1], step):
            carry, out = self._chunk_body(carry, audio[:, lo:lo + step])
            outs.append(out)
        if not outs:
            return carry, audio.new_zeros(audio.shape)
        return carry, torch.cat(outs, dim=1)
