"""Fused DFN3 streaming cell: every conv block folded to one dense product.

Per frame, each Conv2dNormAct block is a *linear* map over its (channel,
freq) input (the time dimension is 1 with carried context, BatchNorm is an
affine at inference), so the whole conv stack collapses into a chain of
dense [in, out] products and activations. The matrices are built once by
*linearizing* the step functions of `deepfilternet_torch.nn`: pushing an
identity basis through `conv2d_norm_act_step` (activation stripped), which
also folds the depthwise+pointwise composition, the BN affine and all layout
permutations into the weights. Numerics therefore match the unfused cell by
construction (held to 1e-4 in the tests).

Build with `build_fused(model.params, model.state, model.cfg)`. The folds
feed the whole-cell kernel's weight set (`ops/whole_cell.build_cell_weights`);
`FusedDfNet3` is a module-shaped adapter (`streaming_init` /
`streaming_cell`) that runs them through `StreamingRuntime` as
`model.module`, which tests the folds on their own. Counterpart of the JAX
package's `models/dfnet3_fused.py`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from deepfilternet_torch.models.dfnet3 import StreamState
from deepfilternet_torch.models.dfnet3 import streaming_init as _orig_init
from deepfilternet_torch.nn import (
    conv2d_norm_act_step,
    conv_transpose2d_norm_act_step,
    grouped_linear_apply,
    linear_apply,
    squeezed_gru_s_step,
)
from deepfilternet_torch.ops.df_op import deep_filter
from deepfilternet_torch.ops.erb import erb_fb_tensor

PI = 3.1415926535897932384626433


def _linearize_conv(params, state, lcfg, in_shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (W [in, out], b [out]) for a conv step on [B, C, kT, F] input.

    Runs the actual step function over an identity basis so every folded
    detail (groups, pointwise, BN affine, fpad) is captured exactly.
    Activation is stripped (applied by the caller).
    """
    lcfg = dict(lcfg, act=None)
    fn = conv_transpose2d_norm_act_step if lcfg.get("transposed") else conv2d_norm_act_step
    in_dim = int(np.prod(in_shape))
    device = params["w"].device
    basis = torch.cat(
        [torch.eye(in_dim, dtype=torch.float32, device=device),
         torch.zeros((1, in_dim), dtype=torch.float32, device=device)],
        dim=0,
    ).reshape((in_dim + 1,) + tuple(in_shape))
    out = fn(params, state, lcfg, basis)  # [in_dim+1, C_out, F_out]
    out = out.reshape(in_dim + 1, -1)
    b = out[-1]
    return (out[:-1] - b).contiguous(), b.contiguous()


def _perm_cf_to_fc(c: int, f: int) -> np.ndarray:
    """Permutation matrix: (C,F) row-major flat -> (F,C) row-major flat."""
    p = np.zeros((c * f, c * f), np.float32)
    for ci in range(c):
        for fi in range(f):
            p[ci * f + fi, fi * c + ci] = 1.0
    return p


def _grouped_dense(w: torch.Tensor) -> torch.Tensor:
    """Grouped linear weight [G, I/G, H/G] -> block-diagonal [I, H]."""
    return torch.block_diag(*w.to(torch.float32))


def build_fused(params: Dict, state: Dict, cfg: Dict) -> Dict:
    """Precompute all dense matrices for the fused cell, on the params' device."""
    L = cfg["layers"]
    ch = cfg["conv_ch"]
    e = cfg["nb_erb"]
    fp = cfg["nb_df"]
    o = cfg["df_order"]
    kt0 = cfg["conv_kernel_inp"][0]
    device = params["erb_conv0"]["w"].device

    def lin(name, in_shape):
        return _linearize_conv(params[name], state.get(name, {}), L[name], in_shape)

    def perm(c, f):
        return torch.tensor(_perm_cf_to_fc(c, f), device=device)

    F = {}
    # encoder convs
    F["e0"] = lin("erb_conv0", (1, kt0, e))            # 96 -> 512   (C,F) out
    F["e1"] = lin("erb_conv1", (ch, 1, e))             # 512 -> 256
    F["e2"] = lin("erb_conv2", (ch, 1, e // 2))        # 256 -> 128
    F["e3"] = lin("erb_conv3", (ch, 1, e // 4))        # 128 -> 128
    F["c0"] = lin("df_conv0", (2, kt0, fp))            # 576 -> 1536
    F["c1"] = lin("df_conv1", (ch, 1, fp))             # 1536 -> 768
    # fold the (C,F)->(F,C) flatten permutations into the producing weights
    p_e3 = perm(ch, e // 4)
    F["e3"] = (F["e3"][0] @ p_e3, F["e3"][1] @ p_e3)
    p_c1 = perm(ch, fp // 2)
    # cemb = relu(GL(relu(c1))): the relu between keeps GL separate
    F["c1"] = (F["c1"][0] @ p_c1, F["c1"][1] @ p_c1)
    F["gl"] = _grouped_dense(params["df_fc_emb"]["w"])

    # erb decoder
    F["p3"] = lin("conv3p", (ch, 1, e // 4))           # 128 -> 128
    F["t3"] = lin("convt3", (ch, 1, e // 4))           # 128 -> 128
    F["p2"] = lin("conv2p", (ch, 1, e // 4))           # 128 -> 128
    F["t2"] = lin("convt2", (ch, 1, e // 4))           # 128 -> 256
    F["p1"] = lin("conv1p", (ch, 1, e // 2))           # 256 -> 256
    F["t1"] = lin("convt1", (ch, 1, e // 2))           # 256 -> 512
    F["p0"] = lin("conv0p", (ch, 1, e))                # 512 -> 512
    F["out"] = lin("conv0_out", (ch, 1, e))            # 512 -> 32 (sigmoid after)
    # demb [B, emb] is (F, C) flat per the reference reshape; the decoder
    # pathway operates in (C, F) flat
    F["p_demb"] = perm(e // 4, ch)                     # (F,C) -> (C,F)

    # df decoder
    ktp = cfg["df_pathway_kt"]
    F["convp"] = lin("df_convp", (ch, ktp, fp))        # 1536 -> 960 (C=O*2, F)
    p_convp = perm(o * 2, fp)                          # -> (F', O*2) flat
    F["convp"] = (F["convp"][0] @ p_convp, F["convp"][1] @ p_convp)
    F["df_out"] = _grouped_dense(params["df_out"]["w"])
    return F


def e3_cf(e3_fc: torch.Tensor, ch: int, e: int) -> torch.Tensor:
    """(F,C) flat -> (C,F) flat for the decoder pathway convs."""
    b = e3_fc.shape[0]
    return e3_fc.reshape(b, e // 4, ch).permute(0, 2, 1).reshape(b, -1)


class FusedDfNet3:
    """Module-shaped adapter exposing streaming_init/streaming_cell with the
    fused dense-product forward; drop-in for `model.module` of
    StreamingRuntime, at float32 (its folded products are float32)."""

    RUNTIME_DTYPES = (torch.float32,)

    def __init__(self, params: Dict, state: Dict, cfg: Dict):
        if cfg["df_pathway_kt"] != 1:
            raise NotImplementedError("the fused cell supports df_pathway_kt=1")
        if cfg["enc_concat"]:
            raise NotImplementedError("the fused cell supports enc_concat=False")
        if not cfg.get("run_df", True):
            raise NotImplementedError("the fused cell has no mask-only (run_df=False) form")
        self.fused = build_fused(params, state, cfg)
        self.params = params
        self.state = state
        self.cfg = cfg

    def streaming_init(self, batch: int, cfg: Dict, device="cpu") -> StreamState:
        return _orig_init(batch, cfg, device=device)

    def streaming_cell(self, params, state, cfg, carry: StreamState, spec_ri,
                       feat_erb, feat_spec_ri):
        F = self.fused
        L = cfg["layers"]
        nb_df = cfg["nb_df"]
        e = cfg["nb_erb"]
        ch = cfg["conv_ch"]
        b = spec_ri.shape[0]
        relu = torch.relu

        erb_win = torch.cat([carry.erb_buf, feat_erb[:, None, None, :]], dim=2)
        fs = torch.movedim(feat_spec_ri, -1, 1)[:, :, None, :]
        spec_win = torch.cat([carry.spec_buf, fs], dim=2)

        x = erb_win.reshape(b, -1)
        e0 = relu(x @ F["e0"][0] + F["e0"][1])       # [B, 512] (C,F)
        e1 = relu(e0 @ F["e1"][0] + F["e1"][1])      # [B, 256]
        e2 = relu(e1 @ F["e2"][0] + F["e2"][1])      # [B, 128]
        e3 = relu(e2 @ F["e3"][0] + F["e3"][1])      # [B, 128] (F,C) flat
        c = spec_win.reshape(b, -1)
        c0 = relu(c @ F["c0"][0] + F["c0"][1])       # [B, 1536] (C,F)
        c1 = relu(c0 @ F["c1"][0] + F["c1"][1])      # [B, 768] (F,C) flat
        cemb = relu(c1 @ F["gl"])                    # [B, 128]
        emb = e3 + cemb
        enc_h, emb = squeezed_gru_s_step(
            params["enc_emb_gru"], L["enc_emb_gru"], carry.enc_gru_h, emb
        )
        lsnr = torch.sigmoid(linear_apply(params["lsnr_fc"], emb))
        lsnr = lsnr * (cfg["lsnr_max"] - cfg["lsnr_min"]) + cfg["lsnr_min"]

        dec_h, demb = squeezed_gru_s_step(
            params["dec_emb_gru"], L["dec_emb_gru"], carry.dec_gru_h, emb
        )
        demb_cf = demb @ F["p_demb"]                 # (F,C) -> (C,F) flat
        d3 = relu((relu(e3_cf(e3, ch, e) @ F["p3"][0] + F["p3"][1]) + demb_cf)
                  @ F["t3"][0] + F["t3"][1])
        d2 = relu((relu(e2 @ F["p2"][0] + F["p2"][1]) + d3) @ F["t2"][0] + F["t2"][1])
        d1 = relu((relu(e1 @ F["p1"][0] + F["p1"][1]) + d2) @ F["t1"][0] + F["t1"][1])
        m = torch.sigmoid(
            (relu(e0 @ F["p0"][0] + F["p0"][1]) + d1) @ F["out"][0] + F["out"][1]
        )  # [B, E]

        df_h, cdf = squeezed_gru_s_step(params["df_gru"], L["df_gru"], carry.df_gru_h, emb)
        if cfg["df_gru_skip"] == "identity":
            cdf = cdf + emb
        elif cfg["df_gru_skip"] == "groupedlinear":
            cdf = cdf + grouped_linear_apply(params["df_skip"], emb)
        c0p = relu(c0 @ F["convp"][0] + F["convp"][1])  # [B, 960] (F', O*2) flat
        coefs = torch.tanh(cdf @ F["df_out"])           # [B, F'*O*2]
        coefs = (coefs.reshape(b, nb_df, cfg["df_order"], 2)
                 + c0p.reshape(b, nb_df, cfg["df_order"], 2))
        coefs_c = torch.movedim(torch.complex(coefs[..., 0], coefs[..., 1]), -1, 1)  # [B,O,F']

        spec_c = torch.complex(spec_ri[..., 0], spec_ri[..., 1])
        ring = torch.complex(carry.df_ring_re, carry.df_ring_im)
        new_ring, y_lo = deep_filter(ring, spec_c[:, :nb_df], coefs_c)
        bin_gains = m @ erb_fb_tensor(cfg["erb_widths"], m.device, inverse=True)
        spec_m = spec_c * bin_gains
        spec_e = torch.cat([y_lo, spec_m[:, nb_df:]], dim=-1)
        if cfg["mask_pf"]:
            beta = cfg["pf_beta"]
            eps = 1e-12
            g = torch.clamp(torch.abs(spec_e) / (torch.abs(spec_c) + eps), eps, 1.0)
            g_sin = torch.clamp(g * torch.sin(PI * g / 2.0), min=eps)
            spec_e = spec_e * ((1.0 + beta) / (1.0 + beta * (g / g_sin) ** 2))

        kt0 = cfg["conv_kernel_inp"][0]
        new_carry = StreamState(
            erb_buf=erb_win[:, :, 1:] if kt0 > 1 else carry.erb_buf,
            spec_buf=spec_win[:, :, 1:] if kt0 > 1 else carry.spec_buf,
            c0_buf=carry.c0_buf,
            enc_gru_h=enc_h,
            dec_gru_h=dec_h,
            df_gru_h=df_h,
            df_ring_re=new_ring.real.contiguous(),
            df_ring_im=new_ring.imag.contiguous(),
        )
        spec_e_ri = torch.stack([spec_e.real, spec_e.imag], dim=-1)
        return new_carry, (spec_e_ri, lsnr, m)
