"""DeepFilterNet3, streaming form: encoder + ERB-mask decoder + DF decoder.

  Encoder: erb_conv0..3 (freq strides 1,2,2,1) over the ERB features,
  df_conv0..1 over the re/im complex features, a grouped-linear df_fc_emb
  folding the complex path into the embedding, an added (or concatenated)
  combine, a SqueezedGRU_S embedding GRU and a sigmoid LSNR head scaled to
  [lsnr_min, lsnr_max].
  ErbDecoder: 1-layer SqueezedGRU_S + transposed-conv pathway with 1x1
  pathway convs from the encoder skips; sigmoid mask.
  DfDecoder: 3-layer SqueezedGRU_S + df_convp pathway, grouped-linear + tanh
  coefficient head.

`streaming_cell` runs one frame for a batch of streams with an explicit
carry (`StreamState`); the parameter tree and `cfg` are those of the JAX
package's `models/dfnet3.py`. The offline forward is not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepfilternet_torch.config import DfParams, config
from deepfilternet_torch.nn import (
    conv2d_norm_act_step,
    conv_transpose2d_norm_act_step,
    grouped_linear_apply,
    init_conv2d_norm_act,
    init_conv_transpose2d_norm_act,
    init_grouped_linear,
    init_linear,
    init_squeezed_gru_s,
    linear_apply,
    squeezed_gru_s_step,
)
from deepfilternet_torch.ops.df_op import deep_filter
from deepfilternet_torch.ops.erb import erb_fb_matrices, erb_fb_tensor, erb_widths

PI = 3.1415926535897932384626433


class ModelParams3(DfParams):
    """`deepfilternet` section hyperparameters; defaults equal the JAX
    package's."""

    section = "deepfilternet"

    def __init__(self):
        super().__init__()
        s = self.section
        self.conv_lookahead: int = config("CONV_LOOKAHEAD", cast=int, default=0, section=s)
        self.conv_ch: int = config("CONV_CH", cast=int, default=16, section=s)
        self.conv_kernel = tuple(
            int(v) for v in str(config("CONV_KERNEL", default="1,3", section=s)).split(",")
        )
        self.convt_kernel = tuple(
            int(v) for v in str(config("CONVT_KERNEL", default="1,3", section=s)).split(",")
        )
        self.conv_kernel_inp = tuple(
            int(v) for v in str(config("CONV_KERNEL_INP", default="3,3", section=s)).split(",")
        )
        self.emb_hidden_dim: int = config("EMB_HIDDEN_DIM", cast=int, default=256, section=s)
        self.emb_num_layers: int = config("EMB_NUM_LAYERS", cast=int, default=2, section=s)
        self.emb_gru_skip_enc: str = config("EMB_GRU_SKIP_ENC", default="none", section=s)
        self.emb_gru_skip: str = config("EMB_GRU_SKIP", default="none", section=s)
        self.df_hidden_dim: int = config("DF_HIDDEN_DIM", cast=int, default=256, section=s)
        self.df_gru_skip: str = config("DF_GRU_SKIP", default="none", section=s)
        self.df_pathway_kernel_size_t: int = config(
            "DF_PATHWAY_KERNEL_SIZE_T", cast=int, default=1, section=s
        )
        self.enc_concat: bool = config("ENC_CONCAT", cast=bool, default=False, section=s)
        self.df_num_layers: int = config("DF_NUM_LAYERS", cast=int, default=3, section=s)
        self.df_n_iter: int = config("DF_N_ITER", cast=int, default=1, section=s)
        self.lin_groups: int = config("LINEAR_GROUPS", cast=int, default=1, section=s)
        self.enc_lin_groups: int = config("ENC_LINEAR_GROUPS", cast=int, default=16, section=s)
        self.mask_pf: bool = config("MASK_PF", cast=bool, default=False, section=s)
        self.pf_beta: float = config("PF_BETA", cast=float, default=0.02, section=s)
        self.lsnr_dropout: bool = config("LSNR_DROPOUT", cast=bool, default=False, section=s)


def _skip_kind(name: str) -> Optional[str]:
    name = (name or "none").lower()
    return None if name == "none" else name


def init_dfnet3(generator: torch.Generator, p: Optional[ModelParams3] = None,
                device="cpu") -> Tuple[Dict, Dict, Dict]:
    """Random parameters from `generator`. Returns (params, state, cfg);
    the tree layout and cfg equal the JAX package's `init_dfnet3`."""
    p = p or ModelParams3()
    if p.nb_erb % 8:
        raise ValueError("erb_bins should be divisible by 8")
    g = generator
    ch = p.conv_ch
    emb_io_dim = ch * p.nb_erb // 4
    df_out_ch = p.df_order * 2
    params: Dict = {}
    state: Dict = {}
    layer_cfg: Dict = {}

    def add(init, name, *args, **kw):
        prm, st, c = init(g, *args, **kw)
        params[name] = prm
        if st:
            state[name] = st
        layer_cfg[name] = c

    conv, convt = init_conv2d_norm_act, init_conv_transpose2d_norm_act
    # encoder
    add(conv, "erb_conv0", 1, ch, p.conv_kernel_inp, bias=False, separable=True)
    add(conv, "erb_conv1", ch, ch, p.conv_kernel, fstride=2, bias=False, separable=True)
    add(conv, "erb_conv2", ch, ch, p.conv_kernel, fstride=2, bias=False, separable=True)
    add(conv, "erb_conv3", ch, ch, p.conv_kernel, fstride=1, bias=False, separable=True)
    add(conv, "df_conv0", 2, ch, p.conv_kernel_inp, bias=False, separable=True)
    add(conv, "df_conv1", ch, ch, p.conv_kernel, fstride=2, bias=False, separable=True)
    params["df_fc_emb"] = init_grouped_linear(
        g, ch * p.nb_df // 2, emb_io_dim, groups=p.enc_lin_groups
    )
    emb_in_dim = emb_io_dim * 2 if p.enc_concat else emb_io_dim
    params["enc_emb_gru"], layer_cfg["enc_emb_gru"] = init_squeezed_gru_s(
        g, emb_in_dim, p.emb_hidden_dim, output_size=emb_io_dim, num_layers=1,
        linear_groups=p.lin_groups, skip=_skip_kind(p.emb_gru_skip_enc),
        linear_act="relu",
    )
    params["lsnr_fc"] = init_linear(g, emb_io_dim, 1)
    # erb decoder
    params["dec_emb_gru"], layer_cfg["dec_emb_gru"] = init_squeezed_gru_s(
        g, emb_io_dim, p.emb_hidden_dim, output_size=emb_io_dim,
        num_layers=p.emb_num_layers - 1, linear_groups=p.lin_groups,
        skip=_skip_kind(p.emb_gru_skip), linear_act="relu",
    )
    add(conv, "conv3p", ch, ch, (1, 1), bias=False, separable=True)
    add(conv, "convt3", ch, ch, p.conv_kernel, bias=False, separable=True)
    add(conv, "conv2p", ch, ch, (1, 1), bias=False, separable=True)
    add(convt, "convt2", ch, ch, p.convt_kernel, fstride=2, bias=False, separable=True)
    add(conv, "conv1p", ch, ch, (1, 1), bias=False, separable=True)
    add(convt, "convt1", ch, ch, p.convt_kernel, fstride=2, bias=False, separable=True)
    add(conv, "conv0p", ch, ch, (1, 1), bias=False, separable=True)
    add(conv, "conv0_out", ch, 1, p.conv_kernel, bias=False, separable=True, act="sigmoid")
    # df decoder (linear_groups=8: the reference DfDecoder leaves it at the
    # SqueezedGRU_S default)
    params["df_gru"], layer_cfg["df_gru"] = init_squeezed_gru_s(
        g, emb_io_dim, p.df_hidden_dim, output_size=None, num_layers=p.df_num_layers,
        linear_groups=8, skip=None, linear_act="relu",
    )
    df_skip = _skip_kind(p.df_gru_skip)
    if df_skip == "groupedlinear":
        params["df_skip"] = init_grouped_linear(g, emb_io_dim, p.df_hidden_dim,
                                                groups=p.lin_groups)
    kt = p.df_pathway_kernel_size_t
    add(conv, "df_convp", ch, df_out_ch, (kt, 1), bias=False, separable=True)
    params["df_out"] = init_grouped_linear(g, p.df_hidden_dim, p.nb_df * df_out_ch,
                                           groups=p.lin_groups)
    params["df_fc_a"] = init_linear(g, p.df_hidden_dim, 1)

    widths = erb_widths(p.sr, p.fft_size, p.nb_erb, p.min_nb_freqs)
    cfg = dict(
        layers=layer_cfg,
        nb_erb=p.nb_erb,
        nb_df=p.nb_df,
        df_order=p.df_order,
        df_lookahead=p.df_lookahead,
        conv_ch=ch,
        emb_io_dim=emb_io_dim,
        enc_concat=p.enc_concat,
        df_gru_skip=df_skip,
        lsnr_min=p.lsnr_min,
        lsnr_max=p.lsnr_max,
        mask_pf=p.mask_pf,
        pf_beta=p.pf_beta,
        lsnr_dropout=p.lsnr_dropout,
        freq_bins=p.fft_size // 2 + 1,
        erb_widths=widths,
        erb_inv_fb=np.asarray(erb_fb_matrices(widths, normalized=True, inverse=True)),
        conv_kernel_inp=p.conv_kernel_inp,
        df_pathway_kt=kt,
        emb_num_layers=p.emb_num_layers,
        df_num_layers=p.df_num_layers,
        emb_hidden_dim=p.emb_hidden_dim,
        df_hidden_dim=p.df_hidden_dim,
    )
    return _tree_to(params, device), _tree_to(state, device), cfg


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# streaming cell
# ---------------------------------------------------------------------------


class StreamState(NamedTuple):
    """Per-stream model carry of the streaming cell."""

    erb_buf: torch.Tensor  # [B, 1, kt0-1, E]   erb_conv0 time context
    spec_buf: torch.Tensor  # [B, 2, kt0-1, F']  df_conv0 time context
    c0_buf: torch.Tensor  # [B, C, ktp-1, F']  df_convp time context
    enc_gru_h: torch.Tensor  # [1, B, H]
    dec_gru_h: torch.Tensor  # [L1, B, H]
    df_gru_h: torch.Tensor  # [L3, B, H]
    df_ring_re: torch.Tensor  # [B, O-1, F']
    df_ring_im: torch.Tensor  # [B, O-1, F']


def streaming_init(batch: int, cfg: Dict, device="cpu") -> StreamState:
    kt0 = cfg["conv_kernel_inp"][0]
    ktp = cfg["df_pathway_kt"]
    e, fp, o, ch = cfg["nb_erb"], cfg["nb_df"], cfg["df_order"], cfg["conv_ch"]

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return StreamState(
        erb_buf=z(batch, 1, kt0 - 1, e),
        spec_buf=z(batch, 2, kt0 - 1, fp),
        c0_buf=z(batch, ch, max(ktp - 1, 0), fp),
        enc_gru_h=z(1, batch, cfg["emb_hidden_dim"]),
        dec_gru_h=z(max(cfg["emb_num_layers"] - 1, 1), batch, cfg["emb_hidden_dim"]),
        df_gru_h=z(cfg["df_num_layers"], batch, cfg["df_hidden_dim"]),
        df_ring_re=z(batch, o - 1, fp),
        df_ring_im=z(batch, o - 1, fp),
    )


def streaming_cell(
    params: Dict,
    state: Dict,
    cfg: Dict,
    carry: StreamState,
    spec_ri: torch.Tensor,
    feat_erb: torch.Tensor,
    feat_spec_ri: torch.Tensor,
) -> Tuple[StreamState, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """One frame of streaming DFN3 (DF lookahead 0).

    Args:
        spec_ri:      [B, F, 2] current noisy spectrum frame.
        feat_erb:     [B, E] normalized ERB features for this frame.
        feat_spec_ri: [B, F', 2] normalized complex features.
    Returns (new_carry, (enhanced_spec [B, F, 2], lsnr [B, 1], mask [B, E])).
    """
    L = cfg["layers"]
    nb_df = cfg["nb_df"]

    # conv frontend with carried time context
    erb_win = torch.cat([carry.erb_buf, feat_erb[:, None, None, :]], dim=2)
    spec_feat_t = torch.movedim(feat_spec_ri, -1, 1)[:, :, None, :]  # [B,2,1,F']
    spec_win = torch.cat([carry.spec_buf, spec_feat_t], dim=2)

    def cstep(name, x):
        return conv2d_norm_act_step(params[name], state.get(name, {}), L[name], x)

    e0 = cstep("erb_conv0", erb_win)  # [B,C,E]
    e1 = cstep("erb_conv1", e0[:, :, None, :])
    e2 = cstep("erb_conv2", e1[:, :, None, :])
    e3 = cstep("erb_conv3", e2[:, :, None, :])
    c0 = cstep("df_conv0", spec_win)  # [B,C,F']
    c1 = cstep("df_conv1", c0[:, :, None, :])

    b = e0.shape[0]
    cemb = c1.permute(0, 2, 1).reshape(b, -1)
    cemb = torch.relu(grouped_linear_apply(params["df_fc_emb"], cemb))
    emb = e3.permute(0, 2, 1).reshape(b, -1)
    emb = torch.cat([emb, cemb], -1) if cfg["enc_concat"] else emb + cemb
    enc_h, emb = squeezed_gru_s_step(params["enc_emb_gru"], L["enc_emb_gru"],
                                     carry.enc_gru_h, emb)
    lsnr = torch.sigmoid(linear_apply(params["lsnr_fc"], emb))
    lsnr = lsnr * (cfg["lsnr_max"] - cfg["lsnr_min"]) + cfg["lsnr_min"]

    # erb decoder
    dec_h, demb = squeezed_gru_s_step(params["dec_emb_gru"], L["dec_emb_gru"],
                                      carry.dec_gru_h, emb)
    f4 = cfg["nb_erb"] // 4  # e3's freq size (two stride-2 encoder convs)
    demb = demb.reshape(b, f4, -1).permute(0, 2, 1)  # [B, C, F/4]

    def dstep(name, x):
        fn = conv_transpose2d_norm_act_step if L[name].get("transposed") else conv2d_norm_act_step
        return fn(params[name], state.get(name, {}), L[name], x[:, :, None, :])

    d3 = dstep("convt3", dstep("conv3p", e3) + demb)
    d2 = dstep("convt2", dstep("conv2p", e2) + d3)
    d1 = dstep("convt1", dstep("conv1p", e1) + d2)
    m = dstep("conv0_out", dstep("conv0p", e0) + d1)[:, 0]  # [B, E]

    # df decoder
    df_h, c = squeezed_gru_s_step(params["df_gru"], L["df_gru"], carry.df_gru_h, emb)
    if cfg["df_gru_skip"] == "identity":
        c = c + emb
    elif cfg["df_gru_skip"] == "groupedlinear":
        c = c + grouped_linear_apply(params["df_skip"], emb)
    ktp = cfg["df_pathway_kt"]
    if ktp > 1:
        c0_win = torch.cat([carry.c0_buf, c0[:, :, None, :]], dim=2)
    else:
        c0_win = c0[:, :, None, :]
    c0p = conv2d_norm_act_step(params["df_convp"], state.get("df_convp", {}),
                               L["df_convp"], c0_win)
    c0p = c0p.permute(0, 2, 1)  # [B, F', O*2]
    coefs = torch.tanh(grouped_linear_apply(params["df_out"], c))
    coefs = coefs.reshape(b, nb_df, cfg["df_order"], 2) + c0p.reshape(
        b, nb_df, cfg["df_order"], 2
    )
    coefs_c = torch.complex(coefs[..., 0], coefs[..., 1])  # [B, F', O]
    coefs_c = torch.movedim(coefs_c, -1, 1)  # [B, O, F']

    # apply: DF over the ring buffer (current + O-1 past low-band frames)
    spec_c = torch.complex(spec_ri[..., 0], spec_ri[..., 1])  # [B, F]
    ring = torch.complex(carry.df_ring_re, carry.df_ring_im)
    new_ring, y_lo = deep_filter(ring, spec_c[:, :nb_df], coefs_c)

    # upper bins: ERB mask on the current frame
    bin_gains = m @ erb_fb_tensor(cfg["erb_widths"], m.device, inverse=True)  # [B, F]
    spec_m = spec_c * bin_gains
    if cfg.get("run_df", True):
        spec_e = torch.cat([y_lo, spec_m[:, nb_df:]], dim=-1)
    else:
        spec_e = spec_m  # mask-only ablation; the ring still advances

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
        c0_buf=c0_win[:, :, 1:] if ktp > 1 else carry.c0_buf,
        enc_gru_h=enc_h,
        dec_gru_h=dec_h,
        df_gru_h=df_h,
        df_ring_re=new_ring.real.contiguous(),
        df_ring_im=new_ring.imag.contiguous(),
    )
    spec_e_ri = torch.stack([spec_e.real, spec_e.imag], dim=-1)
    return new_carry, (spec_e_ri, lsnr, m)
