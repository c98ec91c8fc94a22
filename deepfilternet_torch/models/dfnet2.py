"""DeepFilterNet2: DFN3's conv topology with the second generation's heads.

  * gru_type "grouped" (GroupedGRU and GroupedLinear with shuffles, the
    layers' outputs summed) or "squeeze" (SqueezedGRU with an identity skip);
  * the DF decoder emits coefficients and an `alpha`, which blends the DF
    output with the masked spectrum when dfop_method == "real_unfold";
  * the DF op runs on the ERB-masked spectrum, df_n_iter times.

Three forms over one parameter set, with the parameter tree and `cfg` of the
JAX package's `models/dfnet2.py`: `forward` over whole utterances,
`streaming_cell` over one frame with an explicit carry (`StreamState2`), and
`forward_chunk`, a chunk of frames in the offline form that starts from and
returns that carry. Streaming needs df_n_iter == 1, the released
configuration. The runtimes take this family at float32 and bfloat16
(`RUNTIME_DTYPES`); at bfloat16 the spectrum, the mask's bin gains and the
DF coefficients are widened to complex64 where JAX's promotion widens them.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepfilternet_torch.config import DfParams, config
from deepfilternet_torch.models.dfnet3 import (
    _complex,
    _df_skip,
    _inv_fb,
    _lsnr,
    _mask_pathway,
    _seq_conv,
    _tree_to,
)
from deepfilternet_torch.nn import (
    conv2d_norm_act_step,
    conv_transpose2d_norm_act_step,
    grouped_gru_apply,
    grouped_gru_step,
    grouped_linear_apply,
    grouped_linear_shuffle_apply,
    init_conv2d_norm_act,
    init_conv_transpose2d_norm_act,
    init_grouped_gru,
    init_grouped_linear,
    init_grouped_linear_shuffle,
    init_linear,
    init_squeezed_gru,
    linear_apply,
    sigmoid,
    squeezed_gru_apply,
    squeezed_gru_step,
)
from deepfilternet_torch.ops.df_op import deep_filter, deep_filter_offline
from deepfilternet_torch.ops.erb import erb_fb_matrices, erb_widths
from deepfilternet_torch.ops.postfilter import post_filter_mask

# model types the streaming runtimes take for this family
RUNTIME_DTYPES = (torch.float32, torch.bfloat16)


class ModelParams2(DfParams):
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
        self.conv_kernel_inp = tuple(
            int(v) for v in str(config("CONV_KERNEL_INP", default="3,3", section=s)).split(",")
        )
        self.emb_hidden_dim: int = config("EMB_HIDDEN_DIM", cast=int, default=256, section=s)
        self.emb_num_layers: int = config("EMB_NUM_LAYERS", cast=int, default=2, section=s)
        self.df_hidden_dim: int = config("DF_HIDDEN_DIM", cast=int, default=256, section=s)
        self.df_gru_skip: str = config("DF_GRU_SKIP", default="none", section=s)
        self.df_output_layer: str = config("DF_OUTPUT_LAYER", default="linear", section=s)
        self.df_pathway_kernel_size_t: int = config(
            "DF_PATHWAY_KERNEL_SIZE_T", cast=int, default=1, section=s
        )
        self.enc_concat: bool = config("ENC_CONCAT", cast=bool, default=False, section=s)
        self.df_num_layers: int = config("DF_NUM_LAYERS", cast=int, default=3, section=s)
        self.df_n_iter: int = config("DF_N_ITER", cast=int, default=2, section=s)
        self.gru_type: str = config("GRU_TYPE", default="grouped", section=s)
        self.gru_groups: int = config("GRU_GROUPS", cast=int, default=1, section=s)
        self.lin_groups: int = config("LINEAR_GROUPS", cast=int, default=1, section=s)
        self.group_shuffle: bool = config("GROUP_SHUFFLE", cast=bool, default=True, section=s)
        self.dfop_method: str = config("DFOP_METHOD", cast=str, default="real_unfold", section=s)
        self.mask_pf: bool = config("MASK_PF", cast=bool, default=False, section=s)
        self.pf_beta: float = config("PF_BETA", cast=float, default=0.02, section=s)


def init_dfnet2(generator: torch.Generator, p: Optional[ModelParams2] = None,
                device="cpu") -> Tuple[Dict, Dict, Dict]:
    """Random parameters from `generator`. Returns (params, state, cfg);
    the tree layout and cfg equal the JAX package's `init_dfnet2`."""
    p = p or ModelParams2()
    if p.nb_erb % 8:
        raise ValueError("erb_bins should be divisible by 8")
    if p.gru_type not in ("grouped", "squeeze"):
        raise ValueError(f"gru_type must be 'grouped' or 'squeeze', got {p.gru_type!r}")
    g = generator
    ch = p.conv_ch
    emb_in_dim = ch * p.nb_erb // 4
    emb_dim = p.emb_hidden_dim
    df_out_ch = p.df_order * 2
    grouped = p.gru_type == "grouped"
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    L: Dict[str, Any] = {}

    def add(init, name, *args, **kw):
        prm, st, c = init(g, *args, **kw)
        params[name] = prm
        if st:
            state[name] = st
        L[name] = c

    conv, convt = init_conv2d_norm_act, init_conv_transpose2d_norm_act
    # encoder convs (DFN3's topology)
    add(conv, "erb_conv0", 1, ch, p.conv_kernel_inp, bias=False, separable=True)
    add(conv, "erb_conv1", ch, ch, p.conv_kernel, fstride=2, bias=False, separable=True)
    add(conv, "erb_conv2", ch, ch, p.conv_kernel, fstride=2, bias=False, separable=True)
    add(conv, "erb_conv3", ch, ch, p.conv_kernel, fstride=1, bias=False, separable=True)
    add(conv, "df_conv0", 2, ch, p.conv_kernel_inp, bias=False, separable=True)
    add(conv, "df_conv1", ch, ch, p.conv_kernel, fstride=2, bias=False, separable=True)

    enc_in = emb_in_dim * (2 if p.enc_concat else 1)
    if grouped:
        params["df_fc_emb"], L["df_fc_emb"] = init_grouped_linear_shuffle(
            g, ch * p.nb_df // 2, emb_in_dim, groups=p.lin_groups)
        params["enc_emb_gru"], L["enc_emb_gru"] = init_grouped_gru(
            g, enc_in, emb_dim, num_layers=1, groups=p.gru_groups,
            shuffle=p.group_shuffle, add_outputs=True)
        # the reference's decoder GRU takes emb_in_dim inputs "for compat"
        params["dec_emb_gru"], L["dec_emb_gru"] = init_grouped_gru(
            g, emb_in_dim, emb_dim, num_layers=p.emb_num_layers - 1, groups=p.gru_groups,
            shuffle=p.group_shuffle, add_outputs=True)
        params["dec_fc_emb"], L["dec_fc_emb"] = init_grouped_linear_shuffle(
            g, emb_dim, emb_in_dim, groups=p.lin_groups, shuffle=p.group_shuffle)
        params["df_gru"], L["df_gru"] = init_grouped_gru(
            g, emb_dim, p.df_hidden_dim, num_layers=p.df_num_layers, groups=p.gru_groups,
            shuffle=p.group_shuffle, add_outputs=True)
    else:
        params["df_fc_emb"] = init_grouped_linear(g, ch * p.nb_df // 2, emb_in_dim,
                                                  groups=p.lin_groups)
        params["enc_emb_gru"], L["enc_emb_gru"] = init_squeezed_gru(
            g, enc_in, emb_dim, num_layers=1, linear_groups=p.lin_groups, linear_act="relu")
        params["dec_emb_gru"], L["dec_emb_gru"] = init_squeezed_gru(
            g, emb_dim, emb_dim, output_size=emb_in_dim, num_layers=p.emb_num_layers - 1,
            linear_groups=p.lin_groups, skip="identity", linear_act="relu")
        params["df_gru"], L["df_gru"] = init_squeezed_gru(
            g, emb_dim, p.df_hidden_dim, num_layers=p.df_num_layers, skip="identity",
            linear_act="relu")
    params["lsnr_fc"] = init_linear(g, emb_dim, 1)

    # erb decoder convs
    add(conv, "conv3p", ch, ch, (1, 1), bias=False, separable=True)
    add(conv, "convt3", ch, ch, p.conv_kernel, bias=False, separable=True)
    add(conv, "conv2p", ch, ch, (1, 1), bias=False, separable=True)
    add(convt, "convt2", ch, ch, p.conv_kernel, fstride=2, bias=False, separable=True)
    add(conv, "conv1p", ch, ch, (1, 1), bias=False, separable=True)
    add(convt, "convt1", ch, ch, p.conv_kernel, fstride=2, bias=False, separable=True)
    add(conv, "conv0p", ch, ch, (1, 1), bias=False, separable=True)
    add(conv, "conv0_out", ch, 1, p.conv_kernel, bias=False, separable=True, act="sigmoid")

    # df decoder
    kt = p.df_pathway_kernel_size_t
    add(conv, "df_convp", ch, df_out_ch, (kt, 1), bias=False, separable=True)
    df_skip = (p.df_gru_skip or "none").lower()
    if df_skip == "groupedlinear":
        params["df_skip"] = init_grouped_linear(g, emb_dim, p.df_hidden_dim,
                                                groups=p.lin_groups)
    out_dim = p.nb_df * df_out_ch
    if p.df_output_layer == "linear":
        params["df_out"] = init_linear(g, p.df_hidden_dim, out_dim)
    else:
        params["df_out"] = init_grouped_linear(g, p.df_hidden_dim, out_dim, groups=p.lin_groups)
    params["df_fc_a"] = init_linear(g, p.df_hidden_dim, 1)

    widths = erb_widths(p.sr, p.fft_size, p.nb_erb, p.min_nb_freqs)
    cfg = dict(
        layers=L,
        generation=2,
        grouped=grouped,
        nb_erb=p.nb_erb,
        nb_df=p.nb_df,
        df_order=p.df_order,
        df_lookahead=p.df_lookahead,
        conv_ch=ch,
        emb_in_dim=emb_in_dim,
        emb_hidden_dim=emb_dim,
        df_hidden_dim=p.df_hidden_dim,
        enc_concat=p.enc_concat,
        df_gru_skip=df_skip,
        df_output_layer=p.df_output_layer,
        dfop_method=p.dfop_method,
        df_n_iter=p.df_n_iter,
        use_alpha=p.dfop_method == "real_unfold",
        lsnr_min=p.lsnr_min,
        lsnr_max=p.lsnr_max,
        mask_pf=p.mask_pf,
        pf_beta=p.pf_beta,
        freq_bins=p.fft_size // 2 + 1,
        erb_widths=widths,
        erb_inv_fb=np.asarray(erb_fb_matrices(widths, normalized=True, inverse=True)),
        conv_kernel_inp=p.conv_kernel_inp,
        df_pathway_kt=kt,
        emb_num_layers=p.emb_num_layers,
        df_num_layers=p.df_num_layers,
        gru_groups=p.gru_groups,
    )
    return _tree_to(params, device), _tree_to(state, device), cfg


# -- shared pieces -------------------------------------------------------------


def _gru_apply(params, L, name, cfg, x, h0=None):
    fn = grouped_gru_apply if cfg["grouped"] else squeezed_gru_apply
    return fn(params[name], L[name], x, h0)


def _gru_step(params, L, name, cfg, h, x):
    fn = grouped_gru_step if cfg["grouped"] else squeezed_gru_step
    return fn(params[name], L[name], h, x)


def _fc_emb(params, L, cfg, x):
    if cfg["grouped"]:
        return grouped_linear_shuffle_apply(params["df_fc_emb"], L["df_fc_emb"], x)
    return torch.relu(grouped_linear_apply(params["df_fc_emb"], x))


def _embed(params, L, cfg, e3, c1):
    """e3 [B, C, T, E/4], c1 [B, C, T, F'/2] -> the encoder GRU's input
    [B, T, *] (channel-last flatten)."""
    b, _, t, _ = c1.shape
    cemb = _fc_emb(params, L, cfg, c1.permute(0, 2, 3, 1).reshape(b, t, -1))
    emb = e3.permute(0, 2, 3, 1).reshape(b, t, -1)
    return torch.cat([emb, cemb], -1) if cfg["enc_concat"] else emb + cemb


def _dec_emb(params, L, cfg, emb, h0=None):
    """The ERB decoder's GRU over emb [..., H] -> (its embedding, hN); the
    grouped decoder reads the first emb_in_dim channels and ends in a
    shuffled linear."""
    if cfg["grouped"]:
        demb, h = _gru_apply(params, L, "dec_emb_gru", cfg, emb[..., :cfg["emb_in_dim"]], h0)
        return torch.relu(
            grouped_linear_shuffle_apply(params["dec_fc_emb"], L["dec_fc_emb"], demb)), h
    return _gru_apply(params, L, "dec_emb_gru", cfg, emb, h0)


def _df_head(params, cfg, c, emb):
    """The DF GRU's output c [..., H] -> (c with its skip, alpha [..., 1])."""
    c = _df_skip(params, cfg, c, emb)
    return c, sigmoid(linear_apply(params["df_fc_a"], c))


def _coefs(params, cfg, c, c0p):
    """c [B, T, H], pathway c0p [B, O*2, T, F'] -> coefficients complex
    [B, T, O, F']; the linear head's outputs are (O*2, F')-ordered, the
    grouped one's (F', O*2)."""
    b, t = c.shape[:2]
    order, nb_df = cfg["df_order"], cfg["nb_df"]
    if cfg["df_output_layer"] == "linear":
        coefs = torch.tanh(linear_apply(params["df_out"], c))
        coefs = coefs.reshape(b, t, order * 2, nb_df) + c0p.permute(0, 2, 1, 3)
        coefs = coefs.reshape(b, t, order, 2, nb_df).movedim(-1, -2)  # [B,T,O,F',2]
    else:
        coefs = torch.tanh(grouped_linear_apply(params["df_out"], c))
        coefs = coefs.reshape(b, t, nb_df, order * 2) + c0p.permute(0, 2, 3, 1)
        coefs = coefs.reshape(b, t, nb_df, order, 2).movedim(2, 3)  # [B,T,O,F',2]
    return _complex(coefs)


def _blend(cfg, spec_lo_masked, df_out, alpha):
    """The alpha blend of real_unfold; other DF ops take the DF output."""
    if cfg["use_alpha"]:
        return df_out * alpha + spec_lo_masked * (1.0 - alpha)
    return df_out


def _ri(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([x.real, x.imag], dim=-1)


def _masked(cfg, spec_ri, m):
    """spec_ri [..., F, 2] times the mask's bin gains, complex64: a bfloat16
    spectrum and mask are widened first, as JAX promotes `re + 1j * im` and
    a bfloat16 @ float32 product."""
    return _complex(spec_ri) * (m.float() @ _inv_fb(cfg, m.device))


# -- offline forward -------------------------------------------------------------


def forward(params: Dict, state: Dict, cfg: Dict, spec: torch.Tensor,
            feat_erb: torch.Tensor, feat_spec: torch.Tensor, train: bool = False):
    """Offline forward. The I/O of dfnet3.forward, with alpha [B, T, 1] as
    the 4th output: ((spec_e [B, T, F, 2], mask [B, T, E], lsnr [B, T, 1],
    alpha), new_state). `train=True` as dfnet3.forward's, but the mask's
    post-filter is skipped in training, as in JAX and the reference."""
    L = cfg["layers"]
    new_state = dict(state)
    conv = _seq_conv(params, state, L, train, new_state)
    e0 = conv("erb_conv0", feat_erb[:, None])
    e1 = conv("erb_conv1", e0)
    e2 = conv("erb_conv2", e1)
    e3 = conv("erb_conv3", e2)
    c0 = conv("df_conv0", torch.movedim(feat_spec, -1, 1))
    c1 = conv("df_conv1", c0)
    emb, _ = _gru_apply(params, L, "enc_emb_gru", cfg, _embed(params, L, cfg, e3, c1))
    lsnr = _lsnr(params, cfg, emb)

    demb, _ = _dec_emb(params, L, cfg, emb)
    m = _mask_pathway(conv, demb, e3, e2, e1, e0)  # [B, T, E]
    if cfg["mask_pf"] and not train:
        m = post_filter_mask(m, cfg["pf_beta"])
    spec_m = _masked(cfg, spec, m)

    c, _ = _gru_apply(params, L, "df_gru", cfg, emb)
    c, alpha = _df_head(params, cfg, c, emb)
    coefs_c = _coefs(params, cfg, c, conv("df_convp", c0)).transpose(1, 2)  # [B,O,T,F']
    nb_df = cfg["nb_df"]
    out = spec_m
    # mask-only ablation: the coefficients are computed, the DF op not applied
    for _ in range(cfg["df_n_iter"] if cfg.get("run_df", True) else 0):
        filt = deep_filter_offline(out, coefs_c, nb_df, cfg["df_lookahead"])
        lo = _blend(cfg, out[..., :nb_df], filt[..., :nb_df], alpha)
        out = torch.cat([lo, out[..., nb_df:]], dim=-1)
    return (_ri(out), m, lsnr, alpha), new_state


# -- streaming ---------------------------------------------------------------------


class StreamState2(NamedTuple):
    """Per-stream model carry of the streaming cell."""

    erb_buf: torch.Tensor  # [B, 1, kt0-1, E]
    spec_buf: torch.Tensor  # [B, 2, kt0-1, F']
    c0_buf: torch.Tensor  # [B, C, ktp-1, F'] (zero frames for ktp == 1)
    enc_gru_h: torch.Tensor  # [1, B, H] squeeze; [G, B, H/G] grouped
    dec_gru_h: torch.Tensor  # [L-1, B, H]; [(L-1)*G, B, H/G]
    df_gru_h: torch.Tensor  # [L3, B, H]; [L3*G, B, H/G]
    df_ring_re: torch.Tensor  # [B, O-1, F']
    df_ring_im: torch.Tensor  # [B, O-1, F']


def _gru_state_shape(cfg, name, batch):
    layers = {"enc_emb_gru": 1, "dec_emb_gru": cfg["emb_num_layers"] - 1,
              "df_gru": cfg["df_num_layers"]}[name]
    hid = cfg["df_hidden_dim"] if name == "df_gru" else cfg["emb_hidden_dim"]
    g = cfg["gru_groups"] if cfg["grouped"] else 1
    return (layers * g, batch, hid // g)


def streaming_init(batch: int, cfg: Dict, device="cpu") -> StreamState2:
    """The zero carry, float32."""
    kt0, ktp = cfg["conv_kernel_inp"][0], cfg["df_pathway_kt"]

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return StreamState2(
        erb_buf=z(batch, 1, kt0 - 1, cfg["nb_erb"]),
        spec_buf=z(batch, 2, kt0 - 1, cfg["nb_df"]),
        c0_buf=z(batch, cfg["conv_ch"], max(ktp - 1, 0), cfg["nb_df"]),
        enc_gru_h=z(*_gru_state_shape(cfg, "enc_emb_gru", batch)),
        dec_gru_h=z(*_gru_state_shape(cfg, "dec_emb_gru", batch)),
        df_gru_h=z(*_gru_state_shape(cfg, "df_gru", batch)),
        df_ring_re=z(batch, cfg["df_order"] - 1, cfg["nb_df"]),
        df_ring_im=z(batch, cfg["df_order"] - 1, cfg["nb_df"]),
    )


def _check_one_iter(cfg):
    if cfg["df_n_iter"] != 1:
        raise NotImplementedError(
            f"streaming runs df_n_iter == 1 (the released configuration), got {cfg['df_n_iter']}")


def streaming_cell(params: Dict, state: Dict, cfg: Dict, carry: StreamState2,
                   spec_ri: torch.Tensor, feat_erb: torch.Tensor, feat_spec_ri: torch.Tensor
                   ) -> Tuple[StreamState2, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """One frame (DF lookahead 0). spec_ri [B, F, 2], feat_erb [B, E],
    feat_spec_ri [B, F', 2] -> (carry', (spec_e [B, F, 2], lsnr [B, 1],
    mask [B, E]))."""
    _check_one_iter(cfg)
    L = cfg["layers"]
    nb_df = cfg["nb_df"]
    erb_win = torch.cat([carry.erb_buf, feat_erb[:, None, None, :]], dim=2)
    spec_win = torch.cat([carry.spec_buf, torch.movedim(feat_spec_ri, -1, 1)[:, :, None, :]],
                         dim=2)

    def cstep(name, x):
        fn = conv_transpose2d_norm_act_step if L[name].get("transposed") else conv2d_norm_act_step
        return fn(params[name], state.get(name, {}), L[name], x)

    def win(x):  # [B, C, F] -> a one-frame window [B, C, 1, F]
        return x[:, :, None, :]

    e0 = cstep("erb_conv0", erb_win)
    e1 = cstep("erb_conv1", win(e0))
    e2 = cstep("erb_conv2", win(e1))
    e3 = cstep("erb_conv3", win(e2))
    c0 = cstep("df_conv0", spec_win)
    c1 = cstep("df_conv1", win(c0))
    emb = _embed(params, L, cfg, win(e3), win(c1))[:, 0]
    enc_h, emb = _gru_step(params, L, "enc_emb_gru", cfg, carry.enc_gru_h, emb)
    lsnr = _lsnr(params, cfg, emb)

    if cfg["grouped"]:
        dec_h, demb = _gru_step(params, L, "dec_emb_gru", cfg, carry.dec_gru_h,
                                emb[..., :cfg["emb_in_dim"]])
        demb = torch.relu(grouped_linear_shuffle_apply(params["dec_fc_emb"], L["dec_fc_emb"],
                                                       demb))
    else:
        dec_h, demb = _gru_step(params, L, "dec_emb_gru", cfg, carry.dec_gru_h, emb)
    m = _mask_pathway(lambda name, x: win(cstep(name, x)), demb[:, None],
                      win(e3), win(e2), win(e1), win(e0))[:, 0]  # [B, E]
    if cfg["mask_pf"]:
        m = post_filter_mask(m, cfg["pf_beta"])
    spec_m = _masked(cfg, spec_ri, m)

    df_h, c = _gru_step(params, L, "df_gru", cfg, carry.df_gru_h, emb)
    c, alpha = _df_head(params, cfg, c, emb)  # alpha [B, 1]
    ktp = cfg["df_pathway_kt"]
    c0_win = torch.cat([carry.c0_buf, win(c0)], dim=2) if ktp > 1 else win(c0)
    c0p = cstep("df_convp", c0_win)  # [B, O*2, F']
    coefs_c = _coefs(params, cfg, c[:, None], win(c0p))[:, 0]  # [B, O, F']

    ring = torch.complex(carry.df_ring_re, carry.df_ring_im)
    new_ring, filt = deep_filter(ring, spec_m[:, :nb_df], coefs_c)
    if cfg.get("run_df", True):
        lo = _blend(cfg, spec_m[:, :nb_df], filt, alpha)
        spec_e = torch.cat([lo, spec_m[:, nb_df:]], dim=-1)
    else:
        spec_e = spec_m  # mask-only ablation; the ring still advances

    kt0 = cfg["conv_kernel_inp"][0]
    new_carry = StreamState2(
        erb_buf=erb_win[:, :, 1:] if kt0 > 1 else carry.erb_buf,
        spec_buf=spec_win[:, :, 1:] if kt0 > 1 else carry.spec_buf,
        c0_buf=c0_win[:, :, 1:] if ktp > 1 else carry.c0_buf,
        enc_gru_h=enc_h,
        dec_gru_h=dec_h,
        df_gru_h=df_h,
        df_ring_re=new_ring.real.contiguous(),
        df_ring_im=new_ring.imag.contiguous(),
    )
    return new_carry, (_ri(spec_e), lsnr, m)


# -- chunked streaming forward: the offline form with a carried state -----------


def forward_chunk(params: Dict, state: Dict, cfg: Dict, carry: StreamState2,
                  spec: torch.Tensor, feat_erb: torch.Tensor, feat_spec: torch.Tensor
                  ) -> Tuple[StreamState2, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """T frames with streaming semantics in the offline form, the GRUs
    seeded from the carry. Equal to T calls of `streaming_cell`.

    spec [B, T, F, 2], feat_erb [B, T, E], feat_spec [B, T, F', 2] ->
    (carry', (spec_e [B, T, F, 2], lsnr [B, T, 1], mask [B, T, E])).
    """
    _check_one_iter(cfg)
    L = cfg["layers"]
    nb_df, order = cfg["nb_df"], cfg["df_order"]
    ctx = cfg["conv_kernel_inp"][0] - 1
    t = feat_erb.shape[1]
    conv = _seq_conv(params, state, L)

    # the carried context frames go in front; their conv outputs are dropped
    fe = torch.cat([carry.erb_buf[:, 0], feat_erb], dim=1)  # [B, ctx+T, E]
    fs = torch.cat([carry.spec_buf, torch.movedim(feat_spec, -1, 1)], dim=2)
    e0 = conv("erb_conv0", fe[:, None])[:, :, ctx:]
    e1 = conv("erb_conv1", e0)
    e2 = conv("erb_conv2", e1)
    e3 = conv("erb_conv3", e2)
    c0 = conv("df_conv0", fs)[:, :, ctx:]
    c1 = conv("df_conv1", c0)
    emb, enc_h = _gru_apply(params, L, "enc_emb_gru", cfg, _embed(params, L, cfg, e3, c1),
                            carry.enc_gru_h)
    lsnr = _lsnr(params, cfg, emb)

    demb, dec_h = _dec_emb(params, L, cfg, emb, carry.dec_gru_h)
    m = _mask_pathway(conv, demb, e3, e2, e1, e0)
    if cfg["mask_pf"]:
        m = post_filter_mask(m, cfg["pf_beta"])
    spec_m = _masked(cfg, spec, m)

    c, df_h = _gru_apply(params, L, "df_gru", cfg, emb, carry.df_gru_h)
    c, alpha = _df_head(params, cfg, c, emb)  # alpha [B, T, 1]
    ktp = cfg["df_pathway_kt"]
    if ktp > 1:
        c0_ext = torch.cat([carry.c0_buf, c0], dim=2)
        c0p = conv("df_convp", c0_ext)[:, :, ktp - 1:]
        new_c0_buf = c0_ext[:, :, c0_ext.shape[2] - (ktp - 1):]
    else:
        c0p = conv("df_convp", c0)
        new_c0_buf = carry.c0_buf
    coefs_c = _coefs(params, cfg, c, c0p)  # [B, T, O, F']

    # DF over the masked low band, the O-1 carried frames in front
    ring = torch.complex(carry.df_ring_re, carry.df_ring_im)
    lo_ext = torch.cat([ring, spec_m[..., :nb_df]], dim=1)  # [B, O-1+T, F']
    taps = torch.stack([lo_ext[:, n:n + t] for n in range(order)], dim=2)  # [B, T, O, F']
    filt = torch.sum(taps * coefs_c, dim=2)
    if cfg.get("run_df", True):
        lo = _blend(cfg, spec_m[..., :nb_df], filt, alpha)
        spec_e = torch.cat([lo, spec_m[..., nb_df:]], dim=-1)
    else:
        spec_e = spec_m  # mask-only ablation; the ring still advances

    new_ring = lo_ext[:, lo_ext.shape[1] - (order - 1):]
    new_carry = StreamState2(
        erb_buf=fe[:, fe.shape[1] - ctx:][:, None] if ctx > 0 else carry.erb_buf,
        spec_buf=fs[:, :, fs.shape[2] - ctx:] if ctx > 0 else carry.spec_buf,
        c0_buf=new_c0_buf.contiguous(),
        enc_gru_h=enc_h,
        dec_gru_h=dec_h,
        df_gru_h=df_h,
        df_ring_re=new_ring.real.contiguous(),
        df_ring_im=new_ring.imag.contiguous(),
    )
    return new_carry, (_ri(spec_e), lsnr, m)
