"""DeepFilterNet3: encoder + ERB-mask decoder + DF decoder.

  Encoder: erb_conv0..3 (freq strides 1,2,2,1) over the ERB features,
  df_conv0..1 over the re/im complex features, a grouped-linear df_fc_emb
  folding the complex path into the embedding, an added (or concatenated)
  combine, a SqueezedGRU_S embedding GRU and a sigmoid LSNR head scaled to
  [lsnr_min, lsnr_max].
  ErbDecoder: 1-layer SqueezedGRU_S + transposed-conv pathway with 1x1
  pathway convs from the encoder skips; sigmoid mask.
  DfDecoder: 3-layer SqueezedGRU_S + df_convp pathway, grouped-linear + tanh
  coefficient head.

Three forms, with the parameter tree and `cfg` of the JAX package's
`models/dfnet3.py`: `forward` over whole utterances (frame-parallel convs and
products, one `aten.gru` call a GRU stack); `streaming_cell`, one frame for
a batch of streams with an explicit carry (`StreamState`); and
`forward_chunk`, a chunk of frames in the offline form that starts from
and returns that carry, equal to running the cell frame by frame.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepfilternet_torch.config import DfParams, config
from deepfilternet_torch.nn import (
    conv2d_norm_act_apply,
    conv2d_norm_act_step,
    conv_transpose2d_norm_act_apply,
    conv_transpose2d_norm_act_step,
    grouped_linear_apply,
    init_conv2d_norm_act,
    init_conv_transpose2d_norm_act,
    init_grouped_linear,
    init_linear,
    init_squeezed_gru_s,
    linear_apply,
    sigmoid,
    squeezed_gru_s_apply,
    squeezed_gru_s_step,
)
from deepfilternet_torch.ops.df_op import deep_filter, deep_filter_offline
from deepfilternet_torch.ops.erb import erb_fb_matrices, erb_fb_tensor, erb_widths

PI = 3.1415926535897932384626433

# model types the streaming runtimes take for this family
RUNTIME_DTYPES = (torch.float32, torch.bfloat16)


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
# offline forward
# ---------------------------------------------------------------------------


def _seq_conv(params, state, L, train=False, new_state=None):
    """name, x [B, C, T, F] -> the named (transposed) conv block over the
    whole sequence. In training each block's new batchnorm state goes into
    `new_state` under its name."""
    def conv(name, x):
        fn = (conv_transpose2d_norm_act_apply if L[name].get("transposed")
              else conv2d_norm_act_apply)
        out, st = fn(params[name], state.get(name, {}), L[name], x, train)
        if new_state is not None and name in state:
            new_state[name] = st
        return out
    return conv


def _lsnr(params, cfg, emb):
    lsnr = sigmoid(linear_apply(params["lsnr_fc"], emb))
    return lsnr * (cfg["lsnr_max"] - cfg["lsnr_min"]) + cfg["lsnr_min"]


def _embed(params, cfg, e3, c1):
    """Encoder outputs e3 [B, C, T, E/4], c1 [B, C, T, F'/2] -> the GRU's
    input [B, T, *]."""
    b, _, t, _ = c1.shape
    cemb = c1.permute(0, 2, 3, 1).reshape(b, t, -1)
    cemb = torch.relu(grouped_linear_apply(params["df_fc_emb"], cemb))
    emb = e3.permute(0, 2, 3, 1).reshape(b, t, -1)
    return torch.cat([emb, cemb], -1) if cfg["enc_concat"] else emb + cemb


def _encoder(params, conv, L, cfg, feat_erb, feat_spec):
    """feat_erb [B, 1, T, E], feat_spec [B, 2, T, F'] -> (e0, e1, e2, e3,
    emb, c0, lsnr); `conv` runs the conv blocks (`_seq_conv`)."""
    e0 = conv("erb_conv0", feat_erb)
    e1 = conv("erb_conv1", e0)
    e2 = conv("erb_conv2", e1)
    e3 = conv("erb_conv3", e2)
    c0 = conv("df_conv0", feat_spec)
    c1 = conv("df_conv1", c0)
    emb, _ = squeezed_gru_s_apply(params["enc_emb_gru"], L["enc_emb_gru"],
                                  _embed(params, cfg, e3, c1))
    return e0, e1, e2, e3, emb, c0, _lsnr(params, cfg, emb)


def _mask_pathway(conv, demb, e3, e2, e1, e0):
    """The ERB decoder's conv pathway: demb [B, T, E/4*C] -> mask [B, T, E]."""
    b, _, t, f4 = e3.shape
    demb = demb.reshape(b, t, f4, -1).permute(0, 3, 1, 2)  # [B, C, T, E/4]
    d3 = conv("convt3", conv("conv3p", e3) + demb)
    d2 = conv("convt2", conv("conv2p", e2) + d3)
    d1 = conv("convt1", conv("conv1p", e1) + d2)
    return conv("conv0_out", conv("conv0p", e0) + d1)[:, 0]


def _erb_decoder(params, conv, L, cfg, emb, e3, e2, e1, e0):
    demb, _ = squeezed_gru_s_apply(params["dec_emb_gru"], L["dec_emb_gru"], emb)
    return _mask_pathway(conv, demb, e3, e2, e1, e0)


def _df_skip(params, cfg, c, emb):
    if cfg["df_gru_skip"] == "identity":
        return c + emb
    if cfg["df_gru_skip"] == "groupedlinear":
        return c + grouped_linear_apply(params["df_skip"], emb)
    return c


def _df_coefs(params, cfg, c, c0p):
    """GRU output c [B, T, H], pathway c0p [B, O*2, T, F'] -> coefficients
    [B, T, F', O*2]."""
    b, t, _ = c.shape
    coefs = torch.tanh(grouped_linear_apply(params["df_out"], c))
    return coefs.reshape(b, t, cfg["nb_df"], cfg["df_order"] * 2) + c0p.permute(0, 2, 3, 1)


def _df_decoder(params, conv, L, cfg, emb, c0):
    c, _ = squeezed_gru_s_apply(params["df_gru"], L["df_gru"], emb)
    c0p = conv("df_convp", c0)
    return _df_coefs(params, cfg, _df_skip(params, cfg, c, emb), c0p)


def _complex(ri: torch.Tensor) -> torch.Tensor:
    """[..., 2] re/im -> complex64. A bfloat16 pair is widened first: JAX's
    `re + 1j * im` promotes it to complex64, and torch.complex refuses it."""
    return torch.complex(ri[..., 0].float(), ri[..., 1].float())


def _inv_fb(cfg, device):
    """cfg["erb_inv_fb"] [E, F] on `device`, made once per device from the
    same widths (a copy from the host each call would wait for the card)."""
    return erb_fb_tensor(cfg["erb_widths"], device, inverse=True)


def _post_filter(cfg, spec_e, spec_c):
    beta = cfg["pf_beta"]
    eps = 1e-12
    g = torch.clamp(torch.abs(spec_e) / (torch.abs(spec_c) + eps), eps, 1.0)
    g_sin = torch.clamp(g * torch.sin(PI * g / 2.0), min=eps)
    return spec_e * ((1.0 + beta) / (1.0 + beta * (g / g_sin) ** 2))


def forward(
    params: Dict,
    state: Dict,
    cfg: Dict,
    spec: torch.Tensor,
    feat_erb: torch.Tensor,
    feat_spec: torch.Tensor,
    train: bool = False,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], Dict]:
    """Offline forward.

    Args (real-valued, re/im split):
        spec:      [B, T, F, 2] noisy spectrum.
        feat_erb:  [B, T, E] normalized ERB features.
        feat_spec: [B, T, F', 2] unit-normalized complex features.
    Returns ((spec_e [B, T, F, 2], mask [B, T, E], lsnr [B, T, 1],
              df_coefs [B, O, T, F', 2]), new_state).

    `train=True` is the training forward: batchnorm normalizes with the
    batch's statistics and the returned state holds the new running
    statistics (a new dict; `state` is left as it was), and with
    `lsnr_dropout` frames predicted below -10 dB LSNR get a zero mask and
    zero DF coefficients. The post-filter, when on, runs in training too.
    """
    L = cfg["layers"]
    new_state = dict(state)
    conv = _seq_conv(params, state, L, train, new_state)
    e0, e1, e2, e3, emb, c0, lsnr = _encoder(
        params, conv, L, cfg, feat_erb[:, None], torch.movedim(feat_spec, -1, 1))
    mask = _erb_decoder(params, conv, L, cfg, emb, e3, e2, e1, e0)  # [B, T, E]
    coefs = _df_decoder(params, conv, L, cfg, emb, c0)  # [B, T, F', O*2]
    if train and cfg.get("lsnr_dropout", False):
        # the reference runs the decoders on the active frames only; the
        # same result, computed everywhere and masked per frame
        active = (lsnr[..., 0] > -10.0).to(mask.dtype)  # [B, T]
        mask = mask * active[:, :, None]
        coefs = coefs * active[:, :, None, None]

    nb_df = cfg["nb_df"]
    spec_c = torch.complex(spec[..., 0], spec[..., 1])  # [B, T, F]
    spec_m = spec_c * (mask @ _inv_fb(cfg, mask.device))
    b, t = coefs.shape[:2]
    coefs_ri = coefs.reshape(b, t, nb_df, cfg["df_order"], 2)
    if cfg.get("run_df", True):
        coefs_c = torch.complex(coefs_ri[..., 0], coefs_ri[..., 1]).permute(0, 3, 1, 2)
        spec_e = deep_filter_offline(spec_c, coefs_c, nb_df, cfg["df_lookahead"])
        spec_e = torch.cat([spec_e[..., :nb_df], spec_m[..., nb_df:]], dim=-1)
    else:
        spec_e = spec_m  # mask-only ablation: the coefficients are not applied
    if cfg["mask_pf"]:
        spec_e = _post_filter(cfg, spec_e, spec_c)
    spec_e_ri = torch.stack([spec_e.real, spec_e.imag], dim=-1)
    return (spec_e_ri, mask, lsnr, coefs_ri.permute(0, 3, 1, 2, 4)), new_state


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
    """The zero carry, float32 (a reduced-precision runtime casts it)."""
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
    lsnr = sigmoid(linear_apply(params["lsnr_fc"], emb))
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
    coefs_c = _complex(coefs)  # [B, F', O]
    coefs_c = torch.movedim(coefs_c, -1, 1)  # [B, O, F']

    # apply: DF over the ring buffer (current + O-1 past low-band frames)
    spec_c = _complex(spec_ri)  # [B, F]
    ring = torch.complex(carry.df_ring_re, carry.df_ring_im)
    new_ring, y_lo = deep_filter(ring, spec_c[:, :nb_df], coefs_c)

    # upper bins: ERB mask on the current frame; a bfloat16 mask is widened,
    # as JAX promotes a bfloat16 @ float32 product
    bin_gains = m.float() @ erb_fb_tensor(cfg["erb_widths"], m.device, inverse=True)  # [B, F]
    spec_m = spec_c * bin_gains
    if cfg.get("run_df", True):
        spec_e = torch.cat([y_lo, spec_m[:, nb_df:]], dim=-1)
    else:
        spec_e = spec_m  # mask-only ablation; the ring still advances

    if cfg["mask_pf"]:
        spec_e = _post_filter(cfg, spec_e, spec_c)

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


# ---------------------------------------------------------------------------
# chunked streaming forward: the offline form with a carried state
# ---------------------------------------------------------------------------


def forward_chunk(
    params: Dict,
    state: Dict,
    cfg: Dict,
    carry: StreamState,
    spec: torch.Tensor,
    feat_erb: torch.Tensor,
    feat_spec: torch.Tensor,
) -> Tuple[StreamState, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """T frames with streaming semantics in the offline form: convs,
    products and DF over all frames at once, the GRUs seeded from the carry
    (one `aten.gru` call a stack). Equal to T calls of `streaming_cell`.

    spec [B, T, F, 2], feat_erb [B, T, E], feat_spec [B, T, F', 2] ->
    (carry', (spec_e [B, T, F, 2], lsnr [B, T, 1], mask [B, T, E])).
    """
    L = cfg["layers"]
    nb_df, order = cfg["nb_df"], cfg["df_order"]
    ctx = cfg["conv_kernel_inp"][0] - 1
    t = feat_erb.shape[1]
    conv = _seq_conv(params, state, L)

    # the carried context frames go in front; their conv outputs are dropped
    fe = torch.cat([carry.erb_buf[:, 0], feat_erb], dim=1)  # [B, ctx+T, E]
    fs = torch.cat([carry.spec_buf, torch.movedim(feat_spec, -1, 1)], dim=2)  # [B, 2, ctx+T, F']
    e0 = conv("erb_conv0", fe[:, None])[:, :, ctx:]
    e1 = conv("erb_conv1", e0)
    e2 = conv("erb_conv2", e1)
    e3 = conv("erb_conv3", e2)
    c0 = conv("df_conv0", fs)[:, :, ctx:]
    c1 = conv("df_conv1", c0)
    emb, enc_h = squeezed_gru_s_apply(params["enc_emb_gru"], L["enc_emb_gru"],
                                      _embed(params, cfg, e3, c1), carry.enc_gru_h)
    lsnr = _lsnr(params, cfg, emb)

    demb, dec_h = squeezed_gru_s_apply(params["dec_emb_gru"], L["dec_emb_gru"], emb,
                                       carry.dec_gru_h)
    m = _mask_pathway(conv, demb, e3, e2, e1, e0)  # [B, T, E]

    c, df_h = squeezed_gru_s_apply(params["df_gru"], L["df_gru"], emb, carry.df_gru_h)
    ktp = cfg["df_pathway_kt"]
    if ktp > 1:
        c0_ext = torch.cat([carry.c0_buf, c0], dim=2)
        c0p = conv("df_convp", c0_ext)[:, :, ktp - 1:]
        new_c0_buf = c0_ext[:, :, -(ktp - 1):]
    else:
        c0p = conv("df_convp", c0)
        new_c0_buf = carry.c0_buf
    coefs = _df_coefs(params, cfg, _df_skip(params, cfg, c, emb), c0p)
    b = coefs.shape[0]
    coefs_ri = coefs.reshape(b, t, nb_df, order, 2)
    coefs_c = _complex(coefs_ri)  # [B, T, F', O]

    # DF over the carried ring: the O-1 past low-band frames go in front
    spec_c = _complex(spec)
    ring = torch.complex(carry.df_ring_re, carry.df_ring_im)  # [B, O-1, F']
    lo_ext = torch.cat([ring, spec_c[..., :nb_df]], dim=1)  # [B, O-1+T, F']
    taps = torch.stack([lo_ext[:, n:n + t] for n in range(order)], dim=-1)  # [B, T, F', O]
    y_lo = torch.sum(taps * coefs_c, dim=-1)

    spec_m = spec_c * (m.float() @ _inv_fb(cfg, m.device))
    if cfg.get("run_df", True):
        spec_e = torch.cat([y_lo, spec_m[..., nb_df:]], dim=-1)
    else:
        spec_e = spec_m  # mask-only ablation; the ring still advances
    if cfg["mask_pf"]:
        spec_e = _post_filter(cfg, spec_e, spec_c)

    new_ring = lo_ext[:, lo_ext.shape[1] - (order - 1):]
    new_carry = StreamState(
        erb_buf=fe[:, fe.shape[1] - ctx:][:, None] if ctx > 0 else carry.erb_buf,
        spec_buf=fs[:, :, fs.shape[2] - ctx:] if ctx > 0 else carry.spec_buf,
        c0_buf=new_c0_buf.contiguous(),
        enc_gru_h=enc_h,
        dec_gru_h=dec_h,
        df_gru_h=df_h,
        df_ring_re=new_ring.real.contiguous(),
        df_ring_im=new_ring.imag.contiguous(),
    )
    return new_carry, (torch.stack([spec_e.real, spec_e.imag], dim=-1), lsnr, m)
