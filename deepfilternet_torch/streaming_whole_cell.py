"""WholeCellStreamingRuntime: the whole-cell-kernel streaming runtime.

Drop-in alternative to StreamingRuntime for DFN3 models that runs the entire
per-frame pipeline, for all frames of a call, inside one launch of the
whole-cell kernel (`ops/whole_cell.py`, `csrc/whole_cell.cu` and
`csrc/whole_cell_rows.cu`), at the DSP geometry of `df_state` and the config
(DFN3's FFT 960 / hop 480 / 96 DF bins, or e.g. DFN3-ll's 480 / 240 / 48;
FFT = 2 x hop). Same public
API and carry type (StreamCarry), same streaming semantics (fft-hop delay,
silence skip, RuntimeParams atten-lim / post-filter / LSNR gating).

Unsupported RuntimeParams (multichannel mask reduction) raise at
construction; use StreamingRuntime for those.

Counterpart of the JAX package's `PallasStreamingRuntime`. Its Mosaic tiling
arguments (`s_blk`, `chunk`, `t_major`, `interpret`, and the block-shape rule
`_mosaic_layout`) have no counterpart here: they cut the work to the TPU's
block-shape rule and change no result. Any number of streams and any whole
number of frames work; the CUDA kernel masks its ragged last tile of streams.
`backend="kernel"` (there: "pallas") runs `cell_process`, which launches the
kernel for a model on a CUDA device; `backend="plain"` (there: "xla") runs
`cell_process_plain` on either device.

Each `process` call is the span `whole_cell.process` (utils/timings.py),
with the children `whole_cell.carry_in` and `whole_cell.carry_out` (the
carry to and from the kernel's flat layout) and, on a card, the kernel
wrapper's `k2.alloc` and `k2.launch`.

API:
    rt = WholeCellStreamingRuntime(model, df_state)   # from enhance.init_df
    carry = rt.init(n_streams)
    carry, enhanced = rt.process(carry, audio)        # audio [S, k*hop]
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from deepfilternet_torch.models import dfnet3
from deepfilternet_torch.ops.whole_cell import (
    build_cell_weights,
    cell_process,
    cell_process_plain,
    df_lanes,
)
from deepfilternet_torch.streaming import RuntimeParams, StreamCarry, StreamingRuntime
from deepfilternet_torch.utils.timings import span


def carry_to_flat(carry: StreamCarry) -> Dict[str, torch.Tensor]:
    """StreamCarry -> the kernel's flat {name: [S, d]} float32 dict, every
    array contiguous."""
    m = carry.model
    s = carry.analysis_mem.shape[0]

    def f32(x):
        return x.to(torch.float32).contiguous()

    sil = carry.analysis_mem.new_zeros((s, 8), dtype=torch.float32)
    sil[:, 0] = carry.silence_ctr.to(torch.float32)

    def ring(x):  # frames padded to the whole cell's DF lanes
        return f32(F.pad(x, (0, df_lanes(x.shape[-1]) - x.shape[-1]))).reshape(s, -1)

    return {
        "amem": f32(carry.analysis_mem),
        "smem": f32(carry.synthesis_mem),
        "norms": f32(torch.cat([carry.mean_norm, carry.unit_norm], dim=-1)),
        "sil": sil,
        "erb_ctx": f32(m.erb_buf.reshape(s, -1)),
        "spec_ctx": f32(m.spec_buf.reshape(s, -1)),
        "enc_h": f32(m.enc_gru_h[0]),
        "dec_h": f32(m.dec_gru_h[0]),
        "df_h": f32(torch.movedim(m.df_gru_h, 0, 1).reshape(s, -1)),
        "ring_re": ring(m.df_ring_re),
        "ring_im": ring(m.df_ring_im),
    }


def flat_to_carry(flat: Dict[str, torch.Tensor], like: StreamCarry) -> StreamCarry:
    """Inverse of carry_to_flat, shaped and typed like `like`."""
    m = like.model
    s = flat["amem"].shape[0]
    nb_erb = like.mean_norm.shape[-1]
    blk = flat["ring_re"].shape[-1] // 4
    new_model = m._replace(
        erb_buf=flat["erb_ctx"].reshape(m.erb_buf.shape).to(m.erb_buf.dtype),
        spec_buf=flat["spec_ctx"].reshape(m.spec_buf.shape).to(m.spec_buf.dtype),
        enc_gru_h=flat["enc_h"][None].to(m.enc_gru_h.dtype),
        dec_gru_h=flat["dec_h"][None].to(m.dec_gru_h.dtype),
        df_gru_h=torch.movedim(
            flat["df_h"].reshape(s, m.df_gru_h.shape[0], -1), 1, 0
        ).to(m.df_gru_h.dtype).contiguous(),
        df_ring_re=flat["ring_re"].reshape(s, -1, blk)[..., : m.df_ring_re.shape[-1]].contiguous(),
        df_ring_im=flat["ring_im"].reshape(s, -1, blk)[..., : m.df_ring_im.shape[-1]].contiguous(),
    )
    return StreamCarry(
        analysis_mem=flat["amem"],
        synthesis_mem=flat["smem"],
        mean_norm=flat["norms"][:, :nb_erb].contiguous(),
        unit_norm=flat["norms"][:, nb_erb:].contiguous(),
        silence_ctr=flat["sil"][:, 0].to(torch.int32),
        model=new_model,
    )


class WholeCellStreamingRuntime(StreamingRuntime):
    """StreamingRuntime running the whole-cell kernel.

    matmul_dtype: type of the matrix products' operands (weights and casts):
        torch.bfloat16, the default, as the JAX package's; or torch.float32.
        Carried state stays float32. Any other type raises
        NotImplementedError.
    backend: "kernel" launches the CUDA kernel for a model on a CUDA device
        (on the CPU it runs the plain version, as every kernel wrapper of
        the package does); "plain" always runs the plain version.
    """

    def __init__(self, model, df_state, params: RuntimeParams = RuntimeParams(),
                 matmul_dtype: torch.dtype = torch.bfloat16, backend: str = "kernel"):
        if model.module is not dfnet3:
            raise NotImplementedError(
                f"the whole-cell kernel runs DeepFilterNet3 only, not {model.module.__name__}; "
                "use StreamingRuntime or ChunkedStreamingRuntime")
        if backend not in ("kernel", "plain"):
            raise ValueError(f"backend must be 'kernel' or 'plain', got {backend!r}")
        if params.reduce_mask != "none" and params.n_channels > 1:
            raise NotImplementedError(
                "multichannel mask reduction is not supported by the whole-cell "
                "runtime; use StreamingRuntime"
            )
        super().__init__(model, df_state, params, dtype=torch.float32)
        self.matmul_dtype = matmul_dtype
        self.backend = backend
        # the runtime keeps the weight tensors alive: the kernel is handed
        # their addresses at every call
        self.weights, self.statics = build_cell_weights(
            self.model, df_state, params, matmul_dtype, cfg=self.cfg
        )

    def process(self, carry: StreamCarry, audio) -> Tuple[StreamCarry, torch.Tensor]:
        """audio: [S, T] with T a multiple of hop. Returns [S, T] enhanced
        (delayed by fft-hop samples, streaming semantics)."""
        with span("whole_cell.process"):
            audio = self._audio(audio).contiguous()
            if audio.shape[1] % self.stft_cfg.hop_size:
                raise ValueError("process() needs whole hops")
            run = cell_process if self.backend == "kernel" else cell_process_plain
            with span("whole_cell.carry_in"):
                flat = carry_to_flat(carry)
            new_flat, out = run(audio, flat, self.weights, self.statics)
            with span("whole_cell.carry_out"):
                return flat_to_carry(new_flat, carry), out

    def process_frame(self, carry: StreamCarry, frame) -> Tuple[StreamCarry, torch.Tensor]:
        return self.process(carry, frame)
