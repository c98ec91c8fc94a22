"""Whole-cell streaming DFN3: every stage of a frame, frames looped inside.

One call takes audio [S, T] for S independent streams and T / hop frames and
runs, per frame: the split analysis DFT, the ERB / unit-norm features with
their exponential norms, the dense-folded DFN3 cell (every conv collapsed to
a matrix product, see `models/dfnet3_fused.py`), the three GRU stacks, the
LSNR head, the ERB decoder and mask, the DF coefficient head and the order-5
complex MAC over a 4-frame ring, the ERB mask through `erb_inv`, post-filter,
LSNR gating, attenuation limit, the RMS silence counter and mute, and the
iDFT synthesis with overlap-add. State travels as a flat carry of 11 float32
arrays [S, d] (`CKEYS`), weights as the prefolded set `WKEYS` made by
`build_cell_weights`.

Two operand types, as in the JAX package: float32, and bfloat16 (the JAX
package's default `mdtype`). With a bfloat16 weight set every key but
`imult` and `convp_b` is bfloat16; a product's input is rounded to bfloat16,
its sum kept in float32, and then either kept (`mmf`: the analysis DFT, the
ERB bands, the LSNR head, the mask, `df_out_w`, `convp_co`, `erb_inv` and the
synthesis) or rounded to bfloat16 (`mm`: the model trunk, whose bias adds,
ReLUs and residual sums stay in bfloat16). The GRU gates, norms, DF MAC,
runtime stages and the carry stay float32.

Port of the TPU kernel `deepfilternet_tpu/ops/pallas_cell.py`
(`cell_process`, kernel closure of `make_cell_kernel`). The CUDA kernel is
`csrc/whole_cell.cu` (few streams) or `csrc/whole_cell_rows.cu` (many), each
built for both operand types, the bfloat16 builds on the tensor cores;
`cell_process_plain` is the same function as a Python
loop over frames of plain tensor operations (the counterpart of the JAX
package's `cell_process_xla`). `cell_process` runs the plain version for
tensors on the CPU and launches the kernel for tensors on a CUDA device; it
never falls back from one to the other.

The DSP geometry (FFT, hop, DF bins) is the configuration's
(`CellGeometry`), read from the weight set and the statics, with FFT = 2 x
hop; the model's widths are DFN3's (32 ERB bands, DF order 5, GRUs of 256,
16 conv channels). At DFN3's geometry `FPAD` (512) and `BLK` (128) keep the
JAX package's padded widths, so every weight compares one to one with the JAX
`build_cell_weights`; they suit 16-byte loads. The module's `WSHAPES` and
`CKEYS` are DFN3's; `weight_shapes` and `carry_widths` give any geometry's.
The rows design's library is built for one geometry at a time
(`rows_defines`); the units design takes DFN3's only. The TPU benchmarking
switch `CellStatics.ablate` is not ported.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from deepfilternet_torch.ops import whole_cell_plan as plan
from deepfilternet_torch.ops.stft import dft_matrices, wnorm
from deepfilternet_torch.utils import timings

PI = 3.1415926535897932384626433

# DSP geometry of the default DFN3 config
HOP = 480
FFT = 960
NFREQ = 481
FPAD = 512  # frequency bins padded to a multiple of 128
BLK = 128   # the 96-bin DF blocks padded to 128; pad lanes carry zeros end to end
# the model's widths the kernels take: conv channels, ERB bands, DFN3's DF
# bins, DF order, GRU width
_CH, _NB_ERB, _NB_DF, _ORDER, _HID = 16, 32, 96, 5, 256


class CellGeometry(NamedTuple):
    """The DSP geometry of a weight set: FFT and hop (FFT = 2 x hop), the DF
    bins, the FFT / 2 + 1 bins padded to `fpad` (a multiple of 128) and the
    DF bins padded to `blk` lanes (a multiple of 64)."""

    fft: int
    hop: int
    nb_df: int
    fpad: int
    blk: int

    @property
    def nfreq(self) -> int:
        return self.fft // 2 + 1


def df_lanes(nb_df: int) -> int:
    """The DF bins padded to whole blocks of 64 lanes (DFN3's 96: 128)."""
    return -(-nb_df // 64) * 64


def cell_geometry(fft: int, hop: int, nb_df: int) -> CellGeometry:
    """The geometry of a configuration, its padded widths derived."""
    if fft != 2 * hop:
        raise ValueError(f"the whole cell needs FFT = 2 x hop, got FFT {fft}, hop {hop}")
    return CellGeometry(fft, hop, nb_df, -(-(fft // 2 + 1) // 128) * 128, df_lanes(nb_df))


DFN3_GEOMETRY = cell_geometry(FFT, HOP, _NB_DF)


class CellStatics(NamedTuple):
    """Static scalars of a runtime, passed to the kernel as arguments."""

    alpha: float
    nb_erb: int
    nb_df: int
    df_order: int
    lsnr_min: float
    lsnr_max: float
    mask_pf: bool
    pf_beta: float
    silence_thresh: float
    silence_frames: int
    atten_lim: float  # 0 = disabled; else 10^(-|db|/20)
    lsnr_gating: bool
    gate_lsnr_min: float
    gate_lsnr_max_erb: float
    gate_lsnr_max_df: float


# ordered weight keys; the kernel receives their pointers in this order
WKEYS: List[str] = [
    "dft",        # [960, 1024]  cols 0:512 cos, 512:1024 sin (F padded)
    "imult",      # [1, 512]     row scaling turning dft^T into the iDFT
    "erb_fwd",    # [512, 32]
    "erb_inv",    # [32, 512]
    "e0_w", "e0_b", "e1_w", "e1_b", "e2_w", "e2_b", "e3_w", "e3_b",
    "c0w_t0", "c0w_t1", "c0w_t2", "c0_b", "c1_w", "c1_b", "gl_w",
    "p3_w", "p3_b", "t3_w", "t3_b", "p2_w", "p2_b", "t2_w", "t2_b",
    "p1_w", "p1_b", "t1_w", "t1_b", "p0_w", "p0_b", "out_w", "out_b",
    "enc_lin_in", "enc_wih", "enc_whh", "enc_bih", "enc_bhh", "enc_lin_out",
    "lsnr_w", "lsnr_b",
    "dec_lin_in", "dec_wih", "dec_whh", "dec_bih", "dec_bhh", "dec_lin_out",
    "df_lin_in",
    "df_wih0", "df_whh0", "df_bih0", "df_bhh0",
    "df_wih1", "df_whh1", "df_bih1", "df_bhh1",
    "df_wih2", "df_whh2", "df_bih2", "df_bhh2",
    "df_out_w",   # [256, 1280] output-permuted to (n, ri, f) blocks of BLK
    "convp_co",   # [16, 10]   true channel map of the 1x1 df_convp (+BN)
    "convp_b",    # [1, 16]    per-output-channel shift (10 used, padded)
]

def carry_widths(g: CellGeometry) -> List[Tuple[str, int]]:
    """The ordered carry keys with their per-stream widths at geometry g."""
    return [
        ("amem", g.fft - g.hop),     # analysis memory
        ("smem", g.fft - g.hop),     # synthesis OLA tail
        ("norms", _NB_ERB + g.nb_df),  # 0:32 mean-norm (dB), 32: unit-norm
        ("sil", 8),                  # col 0: consecutive-quiet-frame counter (f32)
        ("erb_ctx", 2 * _NB_ERB),    # 2 past erb feature frames, (t, f) flat
        ("spec_ctx", 4 * g.nb_df),   # 2 past feat_spec frames, (c, t, f) flat
        ("enc_h", _HID),
        ("dec_h", _HID),
        ("df_h", 3 * _HID),          # 3 layers, layer-major
        ("ring_re", 4 * g.blk),      # df ring: 4 past low-band frames, blk-padded
        ("ring_im", 4 * g.blk),
    ]


def weight_shapes(g: CellGeometry) -> Dict[str, Tuple[int, int]]:
    """The weight shapes the kernel takes at geometry g (DFN3's widths)."""
    c1 = _CH * g.nb_df // 2  # df_conv1's output, (F, C) flat
    shapes = {
        "dft": (g.fft, 2 * g.fpad), "imult": (1, g.fpad),
        "erb_fwd": (g.fpad, _NB_ERB), "erb_inv": (_NB_ERB, g.fpad),
        "e0_w": (3 * _NB_ERB, 512), "e0_b": (1, 512), "e1_w": (512, 256), "e1_b": (1, 256),
        "e2_w": (256, 128), "e2_b": (1, 128), "e3_w": (128, 128), "e3_b": (1, 128),
        "c0w_t0": (2 * g.nb_df, _CH * g.blk), "c0w_t1": (2 * g.nb_df, _CH * g.blk),
        "c0w_t2": (2 * g.nb_df, _CH * g.blk), "c0_b": (1, _CH * g.blk),
        "c1_w": (_CH * g.blk, c1), "c1_b": (1, c1), "gl_w": (c1, 128),
        "p3_w": (128, 128), "p3_b": (1, 128), "t3_w": (128, 128), "t3_b": (1, 128),
        "p2_w": (128, 128), "p2_b": (1, 128), "t2_w": (128, 256), "t2_b": (1, 256),
        "p1_w": (256, 256), "p1_b": (1, 256), "t1_w": (256, 512), "t1_b": (1, 512),
        "p0_w": (512, 512), "p0_b": (1, 512), "out_w": (512, _NB_ERB), "out_b": (1, _NB_ERB),
        "enc_lin_in": (128, _HID), "enc_lin_out": (_HID, 128),
        "lsnr_w": (128, 1), "lsnr_b": (1, 1),
        "dec_lin_in": (128, _HID), "dec_lin_out": (_HID, 128),
        "df_lin_in": (128, _HID),
        "df_out_w": (_HID, _ORDER * 2 * g.blk), "convp_co": (_CH, _ORDER * 2),
        "convp_b": (1, _CH),
    }
    shapes.update({k: (_HID, 3 * _HID) for k in WKEYS if "wih" in k or "whh" in k})
    shapes.update({k: (1, 3 * _HID) for k in WKEYS if "bih" in k or "bhh" in k})
    return shapes


# DFN3's: the carry and the weight shapes at its geometry
CKEYS: List[Tuple[str, int]] = carry_widths(DFN3_GEOMETRY)
WSHAPES: Dict[str, Tuple[int, int]] = weight_shapes(DFN3_GEOMETRY)


def geometry_of(weights: Dict[str, torch.Tensor], statics: "CellStatics") -> CellGeometry:
    """The geometry of a weight set: the FFT from `dft` [fft, 2 x fpad], the
    hop half of it, the DF bins from the statics (`cell_geometry`; the
    weights' other widths are held to it by `cell_process`'s shape check)."""
    fft = int(weights["dft"].shape[0])
    return cell_geometry(fft, fft // 2, int(statics.nb_df))


def check_rows_geometry(g: CellGeometry, statics: "CellStatics"):
    """Raise ValueError unless the rows kernel can be built for geometry g and
    the statics' widths: FFT = 2 x hop, a hop of whole 8 samples, the DF
    bins a multiple of 8 with their two feature frames within a hop, and
    DFN3's model widths. FPAD and BLK follow from `cell_geometry`."""
    if statics.nb_erb != _NB_ERB or statics.df_order != _ORDER:
        raise ValueError(f"the whole-cell kernel is built for {_NB_ERB} ERB bands and DF "
                         f"order {_ORDER}, got {statics.nb_erb} and {statics.df_order}")
    bad = [why for ok, why in (
        (g.fft == 2 * g.hop, "FFT = 2 x hop"),
        (g.hop % 8 == 0, "a hop of whole 8 samples"),
        (g.nb_df % 8 == 0 and 2 * g.nb_df <= g.hop, "DF bins a multiple of 8, at most hop / 2"),
    ) if not ok]
    if bad:
        raise ValueError(f"the rows kernel takes no geometry {g}: it needs {'; '.join(bad)}")


def rows_defines(g: CellGeometry) -> Tuple[str, ...]:
    """The rows kernel's build defines for geometry g: none for DFN3's (the
    source's defaults), else its hop, FPAD, DF bins and BLK."""
    if g == DFN3_GEOMETRY:
        return ()
    return (f"DFN_K2_HOP={g.hop}", f"DFN_K2_FPAD={g.fpad}", f"DFN_K2_NB_DF={g.nb_df}",
            f"DFN_K2_BLK={g.blk}")


def _pad_cols(a: np.ndarray, n: int) -> np.ndarray:
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, n - a.shape[-1])])


# operand types of the products; float16 has no counterpart in the JAX package
MATMUL_DTYPES = (torch.float32, torch.bfloat16)
# keys that stay float32 in a reduced-precision weight set: the iDFT row
# scaling multiplies the float32 spectrum, convp_b is added to a float32 sum
F32_KEYS = ("imult", "convp_b")


def weight_dtype(key: str, matmul_dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if key in F32_KEYS else matmul_dtype


def build_cell_weights(model, df_state, rt_params, matmul_dtype=torch.bfloat16,
                       cfg=None) -> Tuple[Dict[str, torch.Tensor], CellStatics]:
    """Precompute the whole-cell weight set from a loaded DFN3 model, as
    tensors on the model's device: `matmul_dtype` (float32 or bfloat16; the
    JAX package's default is bfloat16), `F32_KEYS` always float32. The DSP
    geometry is `df_state`'s FFT and hop (FFT = 2 x hop, else ValueError)
    and the config's DF bins (`weight_shapes`).

    Reuses the dense conv folds of `models/dfnet3_fused.build_fused` and
    re-permutes the DF-coefficient heads so both emit (n, ri, f)-blocked
    outputs (a contiguous block of BLK lanes per tap in the DF MAC). The
    folds are computed on the CPU in float32 whatever the model's device, so
    they do not depend on the card's convolution settings.
    """
    from deepfilternet_torch.config import config
    from deepfilternet_torch.models.dfnet3 import _tree_to
    from deepfilternet_torch.models.dfnet3_fused import (
        _grouped_dense,
        _linearize_conv,
        _perm_cf_to_fc,
        build_fused,
    )
    from deepfilternet_torch.ops.erb import erb_fb_matrices
    from deepfilternet_torch.ops.norms import get_norm_alpha

    if matmul_dtype not in MATMUL_DTYPES:
        raise NotImplementedError(
            f"matmul_dtype {matmul_dtype}: the whole cell takes torch.float32 or "
            "torch.bfloat16")
    cfg = cfg if cfg is not None else model.cfg
    if not cfg.get("run_df", True):
        raise NotImplementedError(
            "the whole-cell path has no mask-only (run_df=False) form; use "
            "StreamingRuntime"
        )
    geo = cell_geometry(df_state.fft_size, df_state.hop_size, cfg["nb_df"])
    fft, hop, fpad, nfreq, blk = geo.fft, geo.hop, geo.fpad, geo.nfreq, geo.blk
    assert cfg["nb_erb"] == _NB_ERB and cfg["df_order"] == _ORDER
    assert cfg["freq_bins"] == nfreq and cfg["df_pathway_kt"] == 1
    assert not cfg["enc_concat"] and cfg["df_gru_skip"] is None
    assert cfg["conv_kernel_inp"][0] == 3

    params = _tree_to(model.params, "cpu")
    state = _tree_to(model.state, "cpu")

    def npf(t) -> np.ndarray:
        return np.asarray(t.detach().to(torch.float32).numpy())

    F = build_fused(params, state, cfg)
    W: Dict[str, np.ndarray] = {}

    cos_m, sin_m = dft_matrices(fft, hop)  # [fft, nfreq] each
    W["dft"] = np.concatenate(
        [_pad_cols(cos_m, fpad), _pad_cols(sin_m, fpad)], axis=1
    )  # [fft, 2 * fpad]
    # The iDFT matrix is exactly a row-rescaled transpose of the forward
    # DFT matrix: idft_re[j, k] = dft_cos[k, j] * mult_j / wnorm (same for
    # the sin/im half), with mult_j = 2 except DC/Nyquist = 1
    # (ops/stft.py idft_matrices), so synthesis reuses dft^T.
    mult = np.full(fpad, 2.0, np.float64)
    mult[0] = 1.0
    mult[nfreq - 1] = 1.0
    mult[nfreq:] = 0.0
    W["imult"] = (mult / wnorm(fft, hop)).astype(np.float32)[None, :]

    widths = df_state.erb_widths
    erb_f = np.asarray(erb_fb_matrices(widths, normalized=True, inverse=False))
    erb_i = np.asarray(erb_fb_matrices(widths, normalized=True, inverse=True))
    W["erb_fwd"] = np.pad(erb_f, ((0, fpad - nfreq), (0, 0)))
    W["erb_inv"] = _pad_cols(erb_i, fpad)

    ch = cfg["conv_ch"]
    e = cfg["nb_erb"]

    for name in ("e0", "e1", "e2", "e3", "c0", "c1", "t3", "p2", "t2", "p1", "t1",
                 "p0", "out"):
        w, b = F[name]
        W[name + "_w"] = npf(w)
        W[name + "_b"] = npf(b)[None, :]
    # pad c0's 16 channel blocks from nb_df to blk lanes so that the DF MAC
    # reads it as [S, 16, blk]; c1 absorbs the matching zero input rows. The
    # fold is then split per context frame t: c0 = sum_t fs_t @ c0w_t with
    # fs_t = [re_t | im_t], so the 3-frame window is never materialized.
    nb_df = cfg["nb_df"]
    c0w, c0b = W.pop("c0_w"), W["c0_b"]
    c0w_p = np.zeros((c0w.shape[0], ch * blk), np.float32)
    c0b_p = np.zeros((1, ch * blk), np.float32)
    c1w_p = np.zeros((ch * blk, W["c1_w"].shape[1]), np.float32)
    for ci in range(ch):
        src_sl = slice(ci * nb_df, (ci + 1) * nb_df)
        dst_sl = slice(ci * blk, ci * blk + nb_df)
        c0w_p[:, dst_sl] = c0w[:, src_sl]
        c0b_p[:, dst_sl] = c0b[:, src_sl]
        c1w_p[dst_sl, :] = W["c1_w"][src_sl, :]
    for t in range(3):
        # window rows for frame t: (re channel, t, :) and (im channel, t, :)
        W[f"c0w_t{t}"] = np.concatenate(
            [c0w_p[t * nb_df: (t + 1) * nb_df],
             c0w_p[3 * nb_df + t * nb_df: 3 * nb_df + (t + 1) * nb_df]],
            axis=0,
        )  # [2 * nb_df, 16 * blk]
    W["c0_b"], W["c1_w"] = c0b_p, c1w_p
    W["gl_w"] = npf(F["gl"])
    # conv3p consumes e3, which the fused fold emits (F,C)-flat: fold the
    # (F,C)->(C,F) permutation (the same matrix with the roles of the two
    # axes swapped) into conv3p's input rows
    p3w, p3b = F["p3"]
    W["p3_w"] = _perm_cf_to_fc(e // 4, ch) @ npf(p3w)
    W["p3_b"] = npf(p3b)[None, :]

    # GRU stacks (torch layouts -> right-multiply transposes)
    def gru_block(prefix, gparams):
        W[prefix + "_lin_in"] = npf(_grouped_dense(gparams["linear_in"]["w"]))
        layers = gparams["gru"]["layers"]
        for li, lp in enumerate(layers):
            sfx = "" if len(layers) == 1 else str(li)
            W[f"{prefix}_wih{sfx}"] = npf(lp["w_ih"]).T
            W[f"{prefix}_whh{sfx}"] = npf(lp["w_hh"]).T
            W[f"{prefix}_bih{sfx}"] = npf(lp["b_ih"])[None, :]
            W[f"{prefix}_bhh{sfx}"] = npf(lp["b_hh"])[None, :]
        if "linear_out" in gparams:
            W[prefix + "_lin_out"] = npf(_grouped_dense(gparams["linear_out"]["w"]))

    L = cfg["layers"]
    assert L["df_gru"]["num_layers"] == 3 and L["enc_emb_gru"]["num_layers"] == 1
    assert L["dec_emb_gru"]["num_layers"] == 1
    gru_block("enc", params["enc_emb_gru"])
    gru_block("dec", params["dec_emb_gru"])
    # the decoder embedding is (F,C) flat, its pathway (C,F) flat: ReLU
    # commutes with a permutation, so it folds into dec_lin_out's columns
    W["dec_lin_out"] = W["dec_lin_out"] @ npf(F["p_demb"])
    gru_block("df", params["df_gru"])

    W["lsnr_w"] = npf(params["lsnr_fc"]["w"]).T  # [128, 1]
    W["lsnr_b"] = npf(params["lsnr_fc"]["b"])[None, :]

    # df_out: dense grouped-linear [256, F'*O*2]; output columns are
    # (f, n, ri)-flat; permute to (n, ri, f) blocks padded to blk lanes each
    o = cfg["df_order"]
    df_out = npf(_grouped_dense(params["df_out"]["w"]))  # [256, nb_df * 10]
    df_out_p = np.zeros((df_out.shape[0], o * 2, blk), np.float32)
    df_out_p[:, :, :nb_df] = df_out.reshape(-1, nb_df, o * 2).transpose(0, 2, 1)
    W["df_out_w"] = df_out_p.reshape(df_out.shape[0], o * 2 * blk)
    # df_convp is a pure 1x1 grouped conv (kernel (1,1), groups 2, no
    # pointwise) + BN affine: a frequency-invariant [16 -> 10] channel map.
    # Extract it from the exact dense fold and verify frequency invariance,
    # rather than re-deriving the BN/group algebra by hand.
    cw, cb = _linearize_conv(
        params["df_convp"], state.get("df_convp", {}), L["df_convp"], (ch, 1, nb_df)
    )  # [16 * nb_df, 10 * nb_df] (c,f)-in, (o,f)-out flat
    cw, cb = npf(cw), npf(cb)
    co = cw[::nb_df, ::nb_df].copy()   # [16, 10]
    bo = cb[::nb_df].copy()            # [10]
    for f0 in (1, nb_df // 3 + 5, nb_df - 1):  # frequency invariance, no leakage
        assert np.allclose(cw[1 * nb_df + f0, 3 * nb_df + f0], co[1, 3], atol=1e-6)
        assert abs(cw[1 * nb_df + f0, 3 * nb_df + (f0 - 1) % nb_df]) < 1e-7
        assert abs(cb[3 * nb_df + f0] - bo[3]) < 1e-6
    W["convp_co"] = co
    W["convp_b"] = np.pad(bo, (0, ch - o * 2))[None, :]

    alpha = get_norm_alpha(
        df_state.sr, df_state.hop_size, config("NORM_TAU", 1.0, float, section="DF")
    )
    statics = CellStatics(
        alpha=float(alpha),
        nb_erb=e,
        nb_df=nb_df,
        df_order=o,
        lsnr_min=float(cfg["lsnr_min"]),
        lsnr_max=float(cfg["lsnr_max"]),
        mask_pf=bool(cfg.get("mask_pf", False)),
        pf_beta=float(cfg.get("pf_beta", 0.02)),
        silence_thresh=float(rt_params.silence_rms_thresh),
        silence_frames=int(rt_params.silence_skip_frames),
        atten_lim=(10.0 ** (-abs(rt_params.atten_lim_db) / 20.0)
                   if rt_params.atten_lim_db else 0.0),
        lsnr_gating=bool(rt_params.lsnr_gating),
        gate_lsnr_min=float(rt_params.lsnr_min),
        gate_lsnr_max_erb=float(rt_params.lsnr_max_erb),
        gate_lsnr_max_df=float(rt_params.lsnr_max_df),
    )
    # copies, rounded on the CPU (to nearest, ties to even, as JAX's cast),
    # then moved
    weights = {
        k: torch.tensor(np.ascontiguousarray(W[k], dtype=np.float32))
        .to(weight_dtype(k, matmul_dtype)).to(model.device)
        for k in WKEYS
    }
    return weights, statics


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


class _Products:
    """The products of one weight set. `mmf(x, k)`: x rounded to the set's
    operand type, times weight k, summed in float32 and kept so; `mm(x, k)`:
    the same result rounded to the operand type. A product of two bfloat16
    values is exact in float32, so the float32 product of the widened
    operands equals a bfloat16 product with float32 sums, on any device and
    whatever its reduced-precision settings. For a float32 set both are
    plain float32 products."""

    def __init__(self, weights: Dict[str, torch.Tensor]):
        self.dtype = weights["dft"].dtype
        self.w = {k: w.float() for k, w in weights.items()}  # widened once

    def mmf(self, x: torch.Tensor, k: str) -> torch.Tensor:
        return x.to(self.dtype).float() @ self.w[k]

    def mm(self, x: torch.Tensor, k: str) -> torch.Tensor:
        return self.mmf(x, k).to(self.dtype)


def _gru_cell(h, gi, gh, b_hh):
    # gates in float32 whatever the operand type; b_hn stays inside
    # r * (...), per the torch GRU definition
    f32 = torch.float32
    i_r, i_z, i_n = gi.to(f32).chunk(3, dim=-1)
    h_r, h_z, h_n = gh.to(f32).chunk(3, dim=-1)
    b_r, b_z, b_n = b_hh.to(f32).chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r + b_r)
    z = torch.sigmoid(i_z + h_z + b_z)
    n = torch.tanh(i_n + r * (h_n + b_n))
    return (1.0 - z) * n + z * h.to(f32)


def _carry_split(c: Dict[str, torch.Tensor], g: CellGeometry) -> Dict[str, torch.Tensor]:
    """Flat carry dict -> per-frame state dict, whose rolling windows
    (analysis memory, conv feature contexts, DF ring) advance by rebinding
    keys rather than by shifting arrays."""
    e, f, blk = _NB_ERB, g.nb_df, g.blk
    s = {
        "prev_hop": c["amem"],          # [S, hop] == last input hop (fft = 2*hop)
        "smem": c["smem"],              # [S, hop] OLA tail
        "mean": c["norms"][:, :e],
        "unit": c["norms"][:, e:],
        "sil": c["sil"],
        "erb_a": c["erb_ctx"][:, :e],   # feat_erb at t-2
        "erb_b": c["erb_ctx"][:, e:],   # feat_erb at t-1
        # feat_spec frames as [re | im] pairs (t-2, t-1)
        "fs_a": torch.cat([c["spec_ctx"][:, :f], c["spec_ctx"][:, 2 * f:3 * f]], dim=-1),
        "fs_b": torch.cat([c["spec_ctx"][:, f:2 * f], c["spec_ctx"][:, 3 * f:]], dim=-1),
        "enc_h": c["enc_h"],
        "dec_h": c["dec_h"],
    }
    for li in range(3):
        s[f"dfh{li}"] = c["df_h"][:, li * _HID: (li + 1) * _HID]
    for n in range(4):
        s[f"r{n}_re"] = c["ring_re"][:, n * blk: (n + 1) * blk]
        s[f"r{n}_im"] = c["ring_im"][:, n * blk: (n + 1) * blk]
    return s


def _carry_join(s: Dict[str, torch.Tensor], g: CellGeometry) -> Dict[str, torch.Tensor]:
    """Inverse of _carry_split."""
    f = g.nb_df
    return {
        "amem": s["prev_hop"],
        "smem": s["smem"],
        "norms": torch.cat([s["mean"], s["unit"]], dim=-1),
        "sil": s["sil"],
        "erb_ctx": torch.cat([s["erb_a"], s["erb_b"]], dim=-1),
        "spec_ctx": torch.cat(
            [s["fs_a"][:, :f], s["fs_b"][:, :f],
             s["fs_a"][:, f:], s["fs_b"][:, f:]], dim=-1),
        "enc_h": s["enc_h"],
        "dec_h": s["dec_h"],
        "df_h": torch.cat([s["dfh0"], s["dfh1"], s["dfh2"]], dim=-1),
        "ring_re": torch.cat([s[f"r{n}_re"] for n in range(4)], dim=-1),
        "ring_im": torch.cat([s[f"r{n}_im"] for n in range(4)], dim=-1),
    }


def _frame_step(W: Dict[str, torch.Tensor], P: _Products, st: CellStatics,
                s: Dict[str, torch.Tensor], frame: torch.Tensor
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One frame on the split state. frame: [S, hop] float32; W the weight
    set (its biases are read as stored), P its products.

    Window products are split per context frame, so no window tensor is
    materialized:
      * analysis DFT: prev_hop @ dft[:hop] + frame @ dft[hop:]
      * df_conv0 fold: fs_{t-2} @ c0w_t0 + fs_{t-1} @ c0w_t1 + fs_t @ c0w_t2
      * synthesis iDFT: separate re/im products against the transposed DFT.
    """
    relu = torch.relu
    mm, mmf = P.mm, P.mmf
    g = geometry_of(W, st)
    nb_df, hop, fpad, blk = st.nb_df, g.hop, g.fpad, g.blk
    n_rows = frame.shape[0]
    ns = dict(s)
    lane_mask = (torch.arange(blk, device=frame.device) < nb_df).to(torch.float32)[None, :]

    # -- analysis: windowed real-DFT split over [prev_hop | frame]
    spec2 = (s["prev_hop"].to(P.dtype).float() @ P.w["dft"][:hop]
             + frame.to(P.dtype).float() @ P.w["dft"][hop:])
    spec_re = spec2[:, :fpad]
    spec_im = spec2[:, fpad:]
    ns["prev_hop"] = frame

    # -- features (feat_erb / feat_cplx with exponential norms)
    power = spec_re * spec_re + spec_im * spec_im  # [S, fpad]
    erb_db = 10.0 * torch.log10(mmf(power, "erb_fwd") + 1e-10)  # [S, 32]
    a = st.alpha
    new_mean = erb_db * (1.0 - a) + s["mean"] * a
    feat_erb = (erb_db - new_mean) / 40.0
    mag_lo = torch.sqrt(power[:, :nb_df])
    new_unit = mag_lo * (1.0 - a) + s["unit"] * a
    ns["mean"], ns["unit"] = new_mean, new_unit
    un_scale = torch.rsqrt(new_unit)
    fs_cur = torch.cat(
        [spec_re[:, :nb_df] * un_scale, spec_im[:, :nb_df] * un_scale], dim=-1
    )  # [S, 2 * nb_df]

    erb_a, erb_b, fs_a, fs_b = s["erb_a"], s["erb_b"], s["fs_a"], s["fs_b"]
    ns["erb_a"], ns["erb_b"] = erb_b, feat_erb
    ns["fs_a"], ns["fs_b"] = fs_b, fs_cur
    cur_re = spec_re[:, :blk] * lane_mask
    cur_im = spec_im[:, :blk] * lane_mask

    # -- conv frontend (dense folds, windows split per context frame); the
    # trunk's activations are in the operand type
    erb_win = torch.cat([erb_a, erb_b, feat_erb], dim=-1)  # [S, 96]
    e0 = relu(mm(erb_win, "e0_w") + W["e0_b"])        # [S, 512]
    e1 = relu(mm(e0, "e1_w") + W["e1_b"])             # [S, 256]
    e2 = relu(mm(e1, "e2_w") + W["e2_b"])             # [S, 128]
    e3 = relu(mm(e2, "e3_w") + W["e3_b"])             # [S, 128] (F,C) flat
    c0 = relu(mm(fs_a, "c0w_t0") + mm(fs_b, "c0w_t1")
              + mm(fs_cur, "c0w_t2") + W["c0_b"])     # [S, 16 * blk] (C,F) padded
    c1 = relu(mm(c0, "c1_w") + W["c1_b"])             # [S, 8 * nb_df] (F,C) flat
    cemb = relu(mm(c1, "gl_w"))                       # [S, 128]
    emb = e3 + cemb

    # -- encoder GRU + lsnr head
    xin = relu(mm(emb, "enc_lin_in"))
    gi = mm(xin, "enc_wih") + W["enc_bih"]
    enc_h = _gru_cell(s["enc_h"], gi, mm(s["enc_h"], "enc_whh"), W["enc_bhh"])
    ns["enc_h"] = enc_h
    emb = relu(mm(enc_h, "enc_lin_out"))              # [S, 128]
    lsnr = torch.sigmoid(mmf(emb, "lsnr_w") + W["lsnr_b"])
    lsnr = lsnr * (st.lsnr_max - st.lsnr_min) + st.lsnr_min  # [S, 1] float32

    # -- erb decoder (p_demb permutation folded into dec_lin_out)
    xdec = relu(mm(emb, "dec_lin_in"))
    gid = mm(xdec, "dec_wih") + W["dec_bih"]
    dec_h = _gru_cell(s["dec_h"], gid, mm(s["dec_h"], "dec_whh"), W["dec_bhh"])
    ns["dec_h"] = dec_h
    demb_cf = relu(mm(dec_h, "dec_lin_out"))          # [S, 128] (C,F) flat
    d3 = relu(mm(relu(mm(e3, "p3_w") + W["p3_b"]) + demb_cf, "t3_w") + W["t3_b"])
    d2 = relu(mm(relu(mm(e2, "p2_w") + W["p2_b"]) + d3, "t2_w") + W["t2_b"])
    d1 = relu(mm(relu(mm(e1, "p1_w") + W["p1_b"]) + d2, "t1_w") + W["t1_b"])
    m = torch.sigmoid(
        mmf(relu(mm(e0, "p0_w") + W["p0_b"]) + d1, "out_w") + W["out_b"]
    )  # [S, 32] float32

    # -- df decoder (3-layer GRU; coefficient heads in (n, ri, f) blocks)
    h_in = relu(mm(emb, "df_lin_in"))
    for li in range(3):
        gil = mm(h_in, f"df_wih{li}") + W[f"df_bih{li}"]
        h_in = _gru_cell(s[f"dfh{li}"], gil, mm(s[f"dfh{li}"], f"df_whh{li}"),
                         W[f"df_bhh{li}"])
        ns[f"dfh{li}"] = h_in
    coefs_t = torch.tanh(mmf(h_in, "df_out_w"))  # [S, O*2*blk] float32
    c0v = c0.reshape(n_rows, _CH, blk).float()
    cp = torch.einsum("co,scf->osf", P.w["convp_co"], c0v)  # [O*2, S, blk]

    # -- deep filter MAC: ring frames 0..3 and the current frame as tap 4
    y_re = torch.zeros((n_rows, blk), dtype=torch.float32, device=frame.device)
    y_im = torch.zeros_like(y_re)
    for n in range(st.df_order):
        if n < st.df_order - 1:
            t_re, t_im = s[f"r{n}_re"], s[f"r{n}_im"]
        else:
            t_re, t_im = cur_re, cur_im
        c_re = (coefs_t[:, (2 * n) * blk: (2 * n + 1) * blk]
                + relu(cp[2 * n] + W["convp_b"][0, 2 * n]))
        c_im = (coefs_t[:, (2 * n + 1) * blk: (2 * n + 2) * blk]
                + relu(cp[2 * n + 1] + W["convp_b"][0, 2 * n + 1]))
        y_re = y_re + t_re * c_re - t_im * c_im
        y_im = y_im + t_re * c_im + t_im * c_re
    for n in range(3):
        ns[f"r{n}_re"], ns[f"r{n}_im"] = s[f"r{n+1}_re"], s[f"r{n+1}_im"]
    ns["r3_re"], ns["r3_im"] = cur_re, cur_im
    return _frame_tail(W, P, st, ns, s, frame, m, lsnr, y_re, y_im, spec_re, spec_im, g)


def _frame_tail(W, P, st: CellStatics, ns, s, frame, m, lsnr, y_re, y_im, spec_re, spec_im,
                g: CellGeometry):
    """Post-model stages: ERB mask, post-filter, LSNR gating, atten-lim,
    silence skip, split-iDFT synthesis + overlap-add."""
    nb_df, hop, fpad = st.nb_df, g.hop, g.fpad
    bin_gains = P.mmf(m, "erb_inv")  # [S, fpad]
    sm_re = spec_re * bin_gains
    sm_im = spec_im * bin_gains
    se_re = torch.cat([y_re[:, :nb_df], sm_re[:, nb_df:]], dim=-1)
    se_im = torch.cat([y_im[:, :nb_df], sm_im[:, nb_df:]], dim=-1)

    if st.mask_pf:
        beta = st.pf_beta
        eps = 1e-12
        mag_e = torch.sqrt(se_re**2 + se_im**2)
        mag_x = torch.sqrt(spec_re**2 + spec_im**2)
        g = torch.clamp(mag_e / (mag_x + eps), eps, 1.0)
        g_sin = torch.clamp(g * torch.sin(PI * g / 2.0), min=eps)
        pf = (1.0 + beta) / (1.0 + beta * (g / g_sin) ** 2)
        se_re = se_re * pf
        se_im = se_im * pf

    if st.lsnr_gating:
        below = lsnr < st.gate_lsnr_min
        erb_only = (lsnr > st.gate_lsnr_max_df) & (lsnr <= st.gate_lsnr_max_erb)
        bypass = lsnr > st.gate_lsnr_max_erb
        zero = torch.zeros_like(se_re)
        se_re = torch.where(below, zero, torch.where(erb_only, sm_re,
                            torch.where(bypass, spec_re, se_re)))
        se_im = torch.where(below, zero, torch.where(erb_only, sm_im,
                            torch.where(bypass, spec_im, se_im)))

    if st.atten_lim > 0.0:
        lim = st.atten_lim
        se_re = spec_re * lim + se_re * (1.0 - lim)
        se_im = spec_im * lim + se_im * (1.0 - lim)

    # -- silence skip counter; the mute zeroes last, overriding the
    # atten-lim mixback as the per-frame runtime does
    rms = torch.sqrt(torch.mean(frame * frame, dim=-1, keepdim=True))  # [S,1]
    quiet = rms < st.silence_thresh
    ctr = torch.where(quiet, s["sil"][:, :1] + 1.0, torch.zeros_like(rms))
    ns["sil"] = torch.cat([ctr, s["sil"][:, 1:]], dim=-1)
    mute = ctr >= st.silence_frames
    se_re = torch.where(mute, torch.zeros_like(se_re), se_re)
    se_im = torch.where(mute, torch.zeros_like(se_im), se_im)

    # -- synthesis: windowed iDFT as separate re/im products against the
    # row-rescaled transposed DFT matrix, then overlap-add
    x = ((se_re * W["imult"]).to(P.dtype).float() @ P.w["dft"][:, :fpad].T
         + (se_im * W["imult"]).to(P.dtype).float() @ P.w["dft"][:, fpad:].T)  # [S, fft]
    out = x[:, :hop] + s["smem"]
    ns["smem"] = x[:, hop:]
    return ns, out


def cell_process_plain(audio: torch.Tensor, carry: Dict[str, torch.Tensor],
                       weights: Dict[str, torch.Tensor], statics: CellStatics,
                       products: type = _Products
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of the kernel: a Python loop over the frames of
    audio [S, T], at the weight set's geometry (`geometry_of`). Returns (new
    flat carry, enhanced audio [S, T]). `products`: the class of the products
    (`whole_cell_check` swaps in variants that sum or round differently)."""
    g = geometry_of(weights, statics)
    s, t = audio.shape
    if t % g.hop:
        raise ValueError("cell_process needs whole hops")
    st = _carry_split(carry, g)
    P = products(weights)
    outs = []
    for f in range(t // g.hop):
        st, o = _frame_step(weights, P, statics, st, audio[:, f * g.hop: (f + 1) * g.hop])
        outs.append(o)
    new_carry = {k: v.contiguous() for k, v in _carry_join(st, g).items()}
    out = torch.cat(outs, dim=-1) if outs else audio.new_zeros((s, 0))
    return new_carry, out


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

# (ids of the weight tensors) -> (weak references to them, {plan, "rows" or "dft_t": copy})
_PACKED: Dict[Tuple[int, ...], Tuple[list, dict]] = {}


def _packed_copies(weights: Dict[str, torch.Tensor]) -> dict:
    """The dict of packed copies kept for this weight set while its tensors
    live (found again by their identity, so a tensor edited in place
    afterwards is not seen)."""
    key = tuple(id(weights[k]) for k in WKEYS)
    hit = _PACKED.get(key)
    if hit is None or any(r() is not weights[k] for r, k in zip(hit[0], WKEYS)):
        refs = [weakref.ref(weights[k]) for k in WKEYS]
        refs[0] = weakref.ref(weights[WKEYS[0]], lambda _: _PACKED.pop(key, None))
        hit = (refs, {})
        _PACKED[key] = hit
    return hit[1]


def packed_weights(weights: Dict[str, torch.Tensor], s: int, n_blocks: int) -> torch.Tensor:
    """The units design's private copy of the products' weights, packed by the
    slices of the plan for (S, blocks) and the set's operand type
    (`whole_cell_plan.pack_weights`; it holds `dft` transposed for the
    synthesis product). Made once per weight set and plan; it is no key of
    the weight set, which goes on comparing with the JAX package key by
    key."""
    copies = _packed_copies(weights)
    tiles = -(-s // plan.RT)
    if (tiles, n_blocks) not in copies:
        _, info = plan.cached_plan(s, n_blocks, weights["dft"].dtype == torch.bfloat16)
        copies[(tiles, n_blocks)] = plan.pack_weights(weights, info)
    return copies[(tiles, n_blocks)]


def packed_rows_weights(weights: Dict[str, torch.Tensor]):
    """The rows design's bfloat16 copy of the products' weights in the tensor
    cores' A-fragment order, and its offsets as a ctypes int array
    (`whole_cell_plan.pack_rows_weights`). Made once per weight set."""
    copies = _packed_copies(weights)
    if "rows" not in copies:
        packed, offsets = plan.pack_rows_weights(weights)
        copies["rows"] = (packed, (ctypes.c_int * len(offsets))(*offsets))
    return copies["rows"]


def rows_dft_t(weights: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The rows design's float32 copy of `dft` transposed, row-major [2 x
    FPAD, FFT] (DFN3: [1024, 960]): the synthesis product's weight, which the
    kernel streams like the analysis DFT's. Made once per weight set; no key
    of the set."""
    copies = _packed_copies(weights)
    if "dft_t" not in copies:
        copies["dft_t"] = weights["dft"].t().contiguous()
    return copies["dft_t"]


# The units design wins while there are few tiles of 64 streams for the
# card's multiprocessors, and both operand types cross over at the same S.
# Measured on an H100 (132 multiprocessors): float32 ahead up to 8 tiles,
# level at 12 and behind at 17; bfloat16 level with rows at 8 tiles and
# behind at 17 (PERF.md).
_UNITS_SM_PER_TILE = 16


def _kernel_choice(s: int, n_sm: int, geometry: CellGeometry = DFN3_GEOMETRY) -> str:
    """Which design runs S streams on a card of n_sm multiprocessors, for
    either operand type: "units" (`csrc/whole_cell.cu`) or "rows"
    (`csrc/whole_cell_rows.cu`). The units design takes DFN3's geometry
    only: rows at any other, at every S."""
    if geometry != DFN3_GEOMETRY:
        return "rows"
    return "units" if -(-s // plan.RT) * _UNITS_SM_PER_TILE <= n_sm else "rows"


def _tile_rows(s: int, n_sm: int) -> int:
    """Stream rows per thread block of the rows design, either operand type:
    4 while that gives every tile a multiprocessor of its own, else 8 while
    tiles of 8 do, else 16. Each step reads the weights once for twice the
    streams; once tiles of 8 outnumber the multiprocessors, one tile of 16
    takes less time than two of 8 (measured on an H100 at 1100, 2112 and
    4096 streams, both types and both geometries, PERF.md)."""
    if -(-s // 4) <= n_sm:
        return 4
    return 8 if -(-s // 8) <= n_sm else 16


@functools.lru_cache(maxsize=None)
def _plan_on_device(s: int, n_blocks: int, bf16: bool, device: torch.device):
    table, info = plan.cached_plan(s, n_blocks, bf16)
    return torch.from_numpy(table).to(device), info


def _check_inputs(audio, carry, weights, statics) -> CellGeometry:
    """The inputs' geometry (`geometry_of`), once every array has the shape,
    type and device it needs there and the rows kernel can be built for it
    (`check_rows_geometry`); else ValueError or TypeError."""
    if audio.dim() != 2:
        raise ValueError(f"audio must be [S, T], got {tuple(audio.shape)}")
    g = geometry_of(weights, statics)
    check_rows_geometry(g, statics)
    s, t = audio.shape
    if t % g.hop:
        raise ValueError("cell_process needs whole hops")
    dev = audio.device
    mdtype = weights["dft"].dtype
    if mdtype not in MATMUL_DTYPES:
        raise TypeError(f"weights['dft'] must be float32 or bfloat16, got {mdtype}")
    f32 = torch.float32
    shapes = weight_shapes(g)
    want = [("audio", audio, (s, t), f32)]
    want += [(f"carry[{k!r}]", carry[k], (s, d), f32) for k, d in carry_widths(g)]
    want += [(f"weights[{k!r}]", weights[k], shapes[k], weight_dtype(k, mdtype)) for k in WKEYS]
    for name, x, shape, dtype in want:
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, audio on {dev}")
    return g


def cell_process(audio: torch.Tensor, carry: Dict[str, torch.Tensor],
                 weights: Dict[str, torch.Tensor], statics: CellStatics
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Run the whole cell over audio [S, T], T a whole number of hops.

    carry: dict of [S, d] float32 arrays (keys and widths per
    `carry_widths` at the geometry); weights, statics: from
    `build_cell_weights`, float32 or bfloat16 operands. Returns (new carry,
    enhanced audio [S, T]). A geometry the rows kernel cannot be built for
    (`check_rows_geometry`) raises ValueError before anything runs.

    CPU tensors run `cell_process_plain`. CUDA tensors launch the kernel
    once for all frames (counting one launch in `cell_process.launches`, and
    in `cell_process.bf16_launches` too for a bfloat16 weight set, the frames
    in `cell_process.frames`) or raise. Two designs of the kernel
    exist and `_kernel_choice` picks one from S, the card and the geometry,
    with no argument for the caller: for few streams every product is
    cut over all multiprocessors (`whole_cell_plan.plan`; a cooperative
    launch, one persistent block per multiprocessor), for many a block keeps
    a tile of stream rows to itself (`_tile_rows`). Each design has a build
    for each operand type: float32 products in FMAs on the CUDA cores,
    bfloat16 ones on the tensor cores (`mma.sync` m16n8k16). Any S works:
    both mask their ragged last tile. The units design takes DFN3's geometry
    only; the rows design's library is built for the call's geometry
    (`rows_defines`), the first load of each under the span `k2.build`. A
    rows launch sets `cell_process.tile_rows` to its tile's stream rows and
    `cell_process.weight_bytes` to the weight bytes it streams: its build's
    weight buffers (`rows_weight_bytes`) once a tile and frame (both 0 after
    a units launch).

    While a torch profiler is recording, one call in `RECORD_EVERY` (the
    first of each stretch of traced calls, then every `RECORD_EVERY`-th) is
    handed a record buffer and runs the recording kernel
    (`whole_cell_recording`): every thread block times each stage of its
    frames (`STAGES`, `FAMILIES`), and the buffer is kept for
    `utils.timings.k2_records()`. The other calls run the kernel that ships
    (`whole_cell_kernel`), so a trace times it too. With no profiler
    recording no buffer is made and no block reads a clock. The host's two
    steps are the spans `k2.alloc` (the output, the new carry and the
    kernel's work buffers) and `k2.launch` (the weights' addresses, the
    packed weights and the launch).
    """
    geo = _check_inputs(audio, carry, weights, statics)
    device = audio.device
    if device.type == "cpu":
        return cell_process_plain(audio, carry, weights, statics)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    keys = [k for k, _ in CKEYS]
    tensors = [audio] + [carry[k] for k in keys] + [weights[k] for k in WKEYS]
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the whole-cell kernel needs contiguous inputs")
    s, t = audio.shape
    n_frames = t // geo.hop
    bf16 = weights["dft"].dtype == torch.bfloat16
    record = _record_this_call()
    with torch.cuda.device(device):
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        design = _kernel_choice(s, n_sm, geo)
        units = design == "units"
        with timings.span("k2.alloc"):
            out = torch.empty_like(audio)
            new_carry = {k: torch.empty_like(carry[k]) for k in keys}
            work = (_units_buffers(s, n_sm, bf16, device, record) if units
                    else _rows_buffers(s, n_sm, device, record, geo))
        with timings.span("k2.launch"):
            ptr = ctypes.c_void_p * len(CKEYS)
            st = statics
            args = dict(
                audio=audio, out=out, s=s, n_frames=n_frames, n_sm=n_sm, weights=weights,
                c_in=ptr(*[carry[k].data_ptr() for k in keys]),
                c_out=ptr(*[new_carry[k].data_ptr() for k in keys]),
                w_ptrs=(ctypes.c_void_p * len(WKEYS))(*[weights[k].data_ptr() for k in WKEYS]),
                scalars=(ctypes.c_float * 10)(
                    st.alpha, 1.0 - st.alpha, st.lsnr_min, st.lsnr_max, st.pf_beta,
                    st.silence_thresh, st.atten_lim, st.gate_lsnr_min, st.gate_lsnr_max_erb,
                    st.gate_lsnr_max_df),
                flags=(int(st.mask_pf), int(st.lsnr_gating), int(st.silence_frames), int(bf16)),
                stream=torch.cuda.current_stream(device).cuda_stream,
            )
            err = (_launch_units if units else _launch_rows)(**args, **work)
    if err != 0:
        raise RuntimeError(
            f"whole_cell kernel launch failed: cudaError {err}"
            + (" (the card refused the cooperative launch of one block per multiprocessor)"
               if err in (720, 801) else ""))
    _count_launch(weights, s, n_frames, bf16, 0 if units else work["rows"])
    if work["records"] is not None:
        timings.k2_keep(design, STAGES[design], stage_families(design), n_frames,
                        work["records"])
    return new_carry, out


def _count_launch(weights: Dict[str, torch.Tensor], s: int, n_frames: int, bf16: bool,
                  rows: int):
    """A launch of S streams over `n_frames` frames in `cell_process`'s
    counters; `rows`: the rows design's tile, 0 for a units launch."""
    cell_process.launches += 1
    cell_process.bf16_launches += int(bf16)
    cell_process.frames += n_frames
    cell_process.tile_rows = rows
    cell_process.weight_bytes = rows_stream_bytes(weights, s, rows, n_frames) if rows else 0


# while a profiler records, the calls that run the recording kernel: one in
# this many of each stretch of traced calls, the first included
RECORD_EVERY = 4
_traced_calls = 0  # the calls of the current stretch of traced calls


def _record_this_call() -> bool:
    """Whether this call records: with a profiler recording, the first call
    of a stretch of traced calls and every `RECORD_EVERY`-th after it."""
    global _traced_calls
    if not timings.tracing():
        _traced_calls = 0
        return False
    _traced_calls += 1
    return (_traced_calls - 1) % RECORD_EVERY == 0


def _records(n_blocks: int, n_stages: int, device, record: bool):
    """The record buffer of a recording launch: int64 [blocks, stages + 3],
    every entry written by the kernel (a block's ns in each stage, then its
    first and last global timer reading and its SM cycles between them);
    None for a launch that does not record."""
    if not record:
        return None
    return torch.empty((n_blocks, n_stages + 3), dtype=torch.int64, device=device)


def _units_buffers(s, n_sm, bf16, device, record):
    """One launch's buffers for the units design: the plan's table (kept per
    plan), a zeroed scratch, zeroed counters and the record buffer."""
    table, info = _plan_on_device(s, n_sm, bf16, device)
    return dict(
        table=table,
        # zeroed: the columns nothing writes (pad lanes) are read as zeros
        scratch=torch.zeros(info["scratch_shape"], dtype=torch.float32, device=device),
        # the grid barrier's counter, then one per job and tile, counted up
        # over the launch
        counters=torch.zeros((info["n_counters"],), dtype=torch.int32, device=device),
        records=_records(n_sm, len(STAGES["units"]), device, record))


_ROWS_LIBS: Dict[Tuple[str, ...], ctypes.CDLL] = {}  # the rows libraries bound, by defines


def rows_library(geo: CellGeometry) -> ctypes.CDLL:
    """The rows kernel's library for geometry `geo`, bound; its first load
    (a build where none is cached) runs under the span `k2.build`."""
    from deepfilternet_torch.kernels import load

    defines = rows_defines(geo)
    if defines not in _ROWS_LIBS:
        with timings.span("k2.build"):
            lib = _bind_rows(load("whole_cell_rows", defines))
        built = (ctypes.c_int * 4)()
        lib.dfn_whole_cell_rows_geometry(built)
        if tuple(built) != (geo.hop, geo.fpad, geo.nb_df, geo.blk):
            raise RuntimeError(f"the rows library was built for {tuple(built)}, not {geo}")
        _ROWS_LIBS[defines] = lib
    return _ROWS_LIBS[defines]


def rows_weight_bytes(weights: Dict[str, torch.Tensor]) -> int:
    """Bytes of the weight buffers the rows design reads once a tile and
    frame: the float32 build's weight keys and its `rows_dft_t` copy; the
    bfloat16 build's packed products (`packed_rows_weights`) and the keys no
    product reads (biases, `imult`, `lsnr_w`, the DF head's channel map).
    Made once per weight set."""
    copies = _packed_copies(weights)
    if "stream_bytes" not in copies:
        def nbytes(t):
            return t.numel() * t.element_size()
        if weights["dft"].dtype == torch.bfloat16:
            in_products = {k for keys in plan.ROWS_PRODUCTS for k in keys}
            total = nbytes(packed_rows_weights(weights)[0]) + sum(
                nbytes(weights[k]) for k in WKEYS if k not in in_products)
        else:
            total = sum(nbytes(weights[k]) for k in WKEYS) + nbytes(rows_dft_t(weights))
        copies["stream_bytes"] = total
    return copies["stream_bytes"]


def rows_stream_bytes(weights: Dict[str, torch.Tensor], s: int, rows: int, n_frames: int) -> int:
    """Weight bytes a rows launch of S streams in tiles of `rows` streams
    reads over `n_frames` frames: `rows_weight_bytes` once a tile and
    frame."""
    return rows_weight_bytes(weights) * -(-s // rows) * n_frames


def _rows_buffers(s, n_sm, device, record, geo: CellGeometry = DFN3_GEOMETRY):
    """One launch's buffers for the rows design: the library for the
    geometry, the tile's rows, the scratch of its blocks and the record
    buffer."""
    lib = rows_library(geo)
    if record and lib.dfn_whole_cell_rows_stages() != len(STAGES["rows"]):
        raise RuntimeError("the rows kernel and STAGES['rows'] disagree on the stages")
    rows = _tile_rows(s, n_sm)
    # one persistent block per multiprocessor at most: each walks over its
    # tiles of `rows` streams, so the scratch stays small
    n_blocks = max(1, min(-(-s // rows), n_sm))
    scratch = torch.empty((n_blocks, rows, lib.dfn_whole_cell_rows_scratch_floats()),
                          dtype=torch.float32, device=device)
    return dict(lib=lib, rows=rows, scratch=scratch,
                records=_records(n_blocks, len(STAGES["rows"]), device, record))


def _launch_units(audio, out, s, n_frames, n_sm, weights, c_in, c_out, w_ptrs, scalars, flags,
                  stream, table, scratch, counters, records):
    """The design of `csrc/whole_cell.cu`: every product cut over all
    multiprocessors by the plan for (S, card); a unit waits on counters of
    the units it depends on (the plan's edges). One persistent block per
    multiprocessor, all resident at once: the launch is cooperative, and a
    card that refuses it makes `cell_process` raise."""
    from deepfilternet_torch.kernels import load

    lib = _bind(load("whole_cell"))
    if lib.dfn_whole_cell_threads() != plan.THREADS:
        raise RuntimeError("the whole-cell kernel and its plan disagree on the block size")
    wpack = packed_weights(weights, s, n_sm)
    return lib.dfn_whole_cell(
        audio.data_ptr(), out.data_ptr(), c_in, c_out, w_ptrs, len(WKEYS), wpack.data_ptr(),
        scratch.data_ptr(), table.data_ptr(), table.numel(), counters.data_ptr(),
        None if records is None else records.data_ptr(), s, n_frames, n_sm, scalars, *flags,
        stream)


def _launch_rows(audio, out, s, n_frames, n_sm, weights, c_in, c_out, w_ptrs, scalars, flags,
                 stream, lib, rows, scratch, records):
    """The design of `csrc/whole_cell_rows.cu`: one persistent block per tile
    of 4, 8 or 16 stream rows computes the whole frame by itself.
    The bfloat16 build reads the products' weights from their packed copy,
    the float32 build its synthesis product's from `rows_dft_t`."""
    bf16 = weights["dft"].dtype == torch.bfloat16
    wpack, offsets = packed_rows_weights(weights) if bf16 else (None, None)
    return lib.dfn_whole_cell_rows(
        audio.data_ptr(), out.data_ptr(), c_in, c_out, w_ptrs, len(WKEYS),
        wpack.data_ptr() if bf16 else None, offsets,
        None if bf16 else rows_dft_t(weights).data_ptr(), scratch.data_ptr(),
        None if records is None else records.data_ptr(), s, n_frames, rows, scratch.shape[0],
        scalars, *flags, stream)


cell_process.launches = 0  # type: ignore[attr-defined]
cell_process.bf16_launches = 0  # type: ignore[attr-defined]
cell_process.frames = 0  # type: ignore[attr-defined]
cell_process.weight_bytes = 0  # type: ignore[attr-defined]
cell_process.tile_rows = 0  # type: ignore[attr-defined]
# the stages each thread block times (in the order of the kernel's records),
# which differ between the two designs
STAGES = {
    # each phase's units of the frame, then the waits on producers
    "units": plan.STAGES,
    "rows": ("frame in, rms", "analysis DFT", "features, norms", "erb convs e0-e3", "df_conv0",
             "df_conv1, df_fc_emb", "encoder GRU, lsnr", "erb decoder GRU",
             "erb decoder convs, mask", "df GRU stack", "df_out, DF MAC", "mask gains, tail",
             "synthesis, overlap-add", "carry in, out"),
}
# Each stage's family: "gru", the stages that hold GRU layers' products (with
# the grouped linear layers around them; in the units design a phase that
# holds a GRU product, whatever else runs beside it); "conv", the
# convolutions and linear layers outside the GRUs; "dsp", the rest (frame
# in, DFTs, features and norms, mask gains, DF MAC, synthesis, the carry).
# The units design's "waiting on producers" belongs to none.
FAMILIES = {
    "units": {
        "gru": ("analysis DFT, h @ w_hh", "enc GRU", "dec GRU, df GRU 0", "dec lin_out, df GRU 1",
                "convt3, df GRU 2"),
        "conv": ("erb bands, df_conv0", "e0, df_conv1", "e1, df_fc_emb, p0", "e2, p1", "e3, p2",
                 "enc lin_in, p3", "enc lin_out", "dec/df lin_in, lsnr", "convt2, df_out",
                 "convt1", "conv_out mask"),
        "dsp": ("mask gains, DF MAC, tail", "synthesis, overlap-add, advance"),
    },
    "rows": {
        "gru": ("encoder GRU, lsnr", "erb decoder GRU", "df GRU stack"),
        "conv": ("erb convs e0-e3", "df_conv0", "df_conv1, df_fc_emb", "erb decoder convs, mask",
                 "df_out, DF MAC"),
        "dsp": ("frame in, rms", "analysis DFT", "features, norms", "mask gains, tail",
                "synthesis, overlap-add", "carry in, out"),
    },
}
WAIT_STAGE = plan.WAIT_STAGE


def stage_families(design: str) -> Tuple[str, ...]:
    """The family of each of the design's `STAGES` ("wait" for the units
    design's waiting on producers)."""
    of = {name: fam for fam, names in FAMILIES[design].items() for name in names}
    return tuple("wait" if n == WAIT_STAGE else of[n] for n in STAGES[design])


@functools.lru_cache(maxsize=None)
def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    pp, pf = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_float)
    fn = lib.dfn_whole_cell
    fn.argtypes = [p, p, pp, pp, pp, i, p, p, p, i, p, p, i, i, i, pf, i, i, i, i, p]
    fn.restype = ctypes.c_int
    lib.dfn_whole_cell_threads.argtypes = []
    lib.dfn_whole_cell_threads.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bind_rows(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    pp, pf = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_float)
    fn = lib.dfn_whole_cell_rows
    fn.argtypes = [p, p, pp, pp, pp, i, p, ctypes.POINTER(ctypes.c_int), p, p, p, i, i, i, i, pf,
                   i, i, i, i, p]
    fn.restype = ctypes.c_int
    for count in (lib.dfn_whole_cell_rows_scratch_floats, lib.dfn_whole_cell_rows_stages):
        count.argtypes = []
        count.restype = ctypes.c_int
    lib.dfn_whole_cell_rows_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.dfn_whole_cell_rows_geometry.restype = None
    return lib
