"""DeepFilterNet (v1): the first generation's convkxf blocks and grouped heads.

What differs from DFN2/3:
  * convkxf blocks: time kernel 2 in the encoder, 1 in the decoder; groups
    min(in, out) with a divisibility fallback (not the gcd rule), halved for
    the complex pathway conv, a pointwise conv whenever grouped (1x1s too);
    a conv bias only where batch norm is off;
  * the encoder's GroupedGRU runs on the flat embedding and the ERB decoder
    has no GRU (it reads the encoder's embedding through fc_emb);
  * embeddings flatten channel-major;
  * the DF decoder: GroupedGRU, a plain Linear + tanh head and an alpha that
    blends the DF output with the masked spectrum (real_unfold).

conv_dec_mode "transposed" decodes with transposed convs; "upsample" with a
nearest-neighbour frequency repeat and a stride-1 conv (the reference's
convkxf "upsample" mode). Three forms, with the JAX package's parameter
tree: `forward`, `streaming_cell` with its carry `StreamState1` (every
encoder conv of time kernel 2 keeps its input frame), and `forward_chunk`.
The runtimes take this family at float32 and bfloat16 (`RUNTIME_DTYPES`),
widening a bfloat16 spectrum, mask and DF coefficients where JAX promotes.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepfilternet_torch.config import DfParams, config
from deepfilternet_torch.models.dfnet2 import _masked
from deepfilternet_torch.models.dfnet3 import _complex, _lsnr, _seq_conv, _tree_to
from deepfilternet_torch.nn import (
    conv2d_norm_act_step,
    conv_transpose2d_norm_act_step,
    grouped_gru_apply,
    grouped_gru_step,
    grouped_linear_shuffle_apply,
    init_conv2d_norm_act,
    init_conv_transpose2d_norm_act,
    init_grouped_gru,
    init_grouped_linear_shuffle,
    init_linear,
    linear_apply,
    sigmoid,
)
from deepfilternet_torch.ops.df_op import deep_filter, deep_filter_offline
from deepfilternet_torch.ops.erb import erb_fb_matrices, erb_widths
from deepfilternet_torch.ops.postfilter import post_filter_mask

# model types the streaming runtimes take for this family
RUNTIME_DTYPES = (torch.float32, torch.bfloat16)


class ModelParams1(DfParams):
    """`deepfilternet` section hyperparameters; defaults equal the JAX
    package's."""

    section = "deepfilternet"

    def __init__(self):
        super().__init__()
        s = self.section
        self.conv_lookahead: int = config("CONV_LOOKAHEAD", cast=int, default=0, section=s)
        self.conv_k_enc: int = config("CONV_K_ENC", cast=int, default=2, section=s)
        self.conv_k_dec: int = config("CONV_K_DEC", cast=int, default=1, section=s)
        self.conv_ch: int = config("CONV_CH", cast=int, default=16, section=s)
        self.conv_width_f: int = config("CONV_WIDTH_FACTOR", cast=int, default=1, section=s)
        self.conv_dec_mode: str = config("CONV_DEC_MODE", default="transposed", section=s)
        self.conv_depthwise: bool = config("CONV_DEPTHWISE", cast=bool, default=True, section=s)
        self.convt_depthwise: bool = config("CONVT_DEPTHWISE", cast=bool, default=True, section=s)
        self.emb_hidden_dim: int = config("EMB_HIDDEN_DIM", cast=int, default=256, section=s)
        self.emb_num_layers: int = config("EMB_NUM_LAYERS", cast=int, default=1, section=s)
        self.df_hidden_dim: int = config("DF_HIDDEN_DIM", cast=int, default=256, section=s)
        self.df_num_layers: int = config("DF_NUM_LAYERS", cast=int, default=3, section=s)
        self.gru_groups: int = config("GRU_GROUPS", cast=int, default=1, section=s)
        self.lin_groups: int = config("LINEAR_GROUPS", cast=int, default=1, section=s)
        self.group_shuffle: bool = config("GROUP_SHUFFLE", cast=bool, default=True, section=s)
        self.dfop_method: str = config("DFOP_METHOD", cast=str, default="real_unfold", section=s)
        self.mask_pf: bool = config("MASK_PF", cast=bool, default=False, section=s)
        self.pf_beta: float = config("PF_BETA", cast=float, default=0.02, section=s)


def _convkxf_groups(in_ch: int, out_ch: int, depthwise: bool,
                    complex_in: bool = False) -> int:
    """The convkxf group rule: min(in, out) when depthwise, 1 unless it
    divides both, halved (when even) for a complex input."""
    groups = min(in_ch, out_ch) if depthwise else 1
    if in_ch % groups != 0 or out_ch % groups != 0:
        groups = 1
    if complex_in and groups % 2 == 0:
        groups //= 2
    return groups


def init_dfnet1(generator: torch.Generator, p: Optional[ModelParams1] = None,
                device="cpu") -> Tuple[Dict, Dict, Dict]:
    """Random parameters from `generator`. Returns (params, state, cfg);
    the tree layout equals the JAX package's `init_dfnet1`, and so does cfg
    but for the "upsample" decoder convs (see `add_kxf`)."""
    p = p or ModelParams1()
    if p.nb_erb % 8:
        raise ValueError("erb_bins should be divisible by 8")
    if p.conv_dec_mode not in ("transposed", "upsample"):
        raise ValueError(f"conv_dec_mode must be 'transposed' or 'upsample', "
                         f"got {p.conv_dec_mode!r}")
    g = generator
    ch, wf = p.conv_ch, p.conv_width_f
    emb_dim = ch * p.nb_erb // 4 * wf**2  # the encoder's flat embedding
    df_out_ch = p.df_order * 2
    k_enc, k_dec = p.conv_k_enc, p.conv_k_dec
    k0 = 1 if k_enc == 1 and p.conv_lookahead == 0 else max(2, k_enc)
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    L: Dict[str, Any] = {}

    def add_kxf(name, in_ch, out_ch, k, f=3, fstride=2, norm=True, act="relu",
                depthwise=True, complex_in=False, mode="normal"):
        """A convkxf block. The pointwise conv follows every grouped conv,
        1x1s too; the padding is (f-1)//2. "upsample" repeats the bins
        `fstride` times before a stride-1 conv (the JAX package's DFN1 gives
        this mode's conv the stride itself, which shrinks the decoder's bins
        and fails on its skip sums)."""
        groups = _convkxf_groups(in_ch, out_ch, depthwise, complex_in)
        stride = 1 if f == 1 else fstride
        kw = dict(bias=not norm, separable=groups > 1, norm=norm, act=act)
        if mode == "transposed":
            # gcd == min for the square channel counts used here
            prm, st, c = init_conv_transpose2d_norm_act(g, in_ch, out_ch, (k, f),
                                                        fstride=stride, **kw)
        else:
            up = stride if mode == "upsample" else 1
            prm, st, c = init_conv2d_norm_act(g, in_ch, out_ch, (k, f), fstride=stride // up,
                                              groups=groups, fupsample=up, force_pw=True, **kw)
        params[name] = prm
        if st:
            state[name] = st
        L[name] = c

    dec = p.conv_dec_mode
    # encoder
    add_kxf("erb_conv0", 1, ch, k0, fstride=1, depthwise=p.conv_depthwise)
    add_kxf("erb_conv1", ch, ch * wf, k_enc, depthwise=p.conv_depthwise)
    add_kxf("erb_conv2", ch * wf, ch * wf**2, k_enc, depthwise=p.conv_depthwise)
    add_kxf("erb_conv3", ch * wf**2, ch * wf**2, k_enc, fstride=1, depthwise=p.conv_depthwise)
    add_kxf("df_conv0", 2, ch, k0, fstride=1, depthwise=p.conv_depthwise)
    add_kxf("df_conv1", ch, ch * wf, k_enc, depthwise=p.conv_depthwise)
    # the reference's df_fc_emb is a GroupedLinear at its default shuffle=True
    params["df_fc_emb"], L["df_fc_emb"] = init_grouped_linear_shuffle(
        g, ch * p.nb_df // 2, emb_dim, groups=p.lin_groups, shuffle=True)
    params["enc_emb_gru"], L["enc_emb_gru"] = init_grouped_gru(
        g, emb_dim, p.emb_hidden_dim, num_layers=p.emb_num_layers, groups=p.gru_groups,
        shuffle=p.group_shuffle, add_outputs=True)
    params["lsnr_fc"] = init_linear(g, p.emb_hidden_dim, 1)

    # erb decoder
    emb_width = ch * wf**2
    params["dec_fc_emb"], L["dec_fc_emb"] = init_grouped_linear_shuffle(
        g, p.emb_hidden_dim, emb_width * (p.nb_erb // 4), groups=p.lin_groups,
        shuffle=p.group_shuffle)
    add_kxf("conv3p", ch * wf**2, emb_width, 1, f=1)
    add_kxf("convt3", emb_width, ch * wf**2, k_dec, fstride=1, depthwise=p.conv_depthwise)
    add_kxf("conv2p", ch * wf**2, ch * wf**2, 1, f=1)
    add_kxf("convt2", ch * wf**2, ch * wf, k_dec, depthwise=p.convt_depthwise, mode=dec)
    add_kxf("conv1p", ch * wf, ch * wf, 1, f=1)
    add_kxf("convt1", ch * wf, ch, k_dec, depthwise=p.convt_depthwise, mode=dec)
    add_kxf("conv0p", ch, ch, 1, f=1)
    add_kxf("conv0_out", ch, 1, k_dec, fstride=1, norm=False, act="sigmoid")

    # df decoder
    add_kxf("df_convp", ch, df_out_ch, 1, f=1, complex_in=True)
    params["df_gru"], L["df_gru"] = init_grouped_gru(
        g, p.emb_hidden_dim, p.df_hidden_dim, num_layers=p.df_num_layers, groups=p.gru_groups,
        shuffle=p.group_shuffle, add_outputs=True)
    params["df_out"] = init_linear(g, p.df_hidden_dim, p.nb_df * df_out_ch)
    params["df_fc_a"] = init_linear(g, p.df_hidden_dim, 1)

    widths = erb_widths(p.sr, p.fft_size, p.nb_erb, p.min_nb_freqs)
    cfg = dict(
        layers=L,
        generation=1,
        nb_erb=p.nb_erb,
        nb_df=p.nb_df,
        df_order=p.df_order,
        df_lookahead=p.df_lookahead,
        conv_ch=ch,
        emb_dim=emb_dim,
        emb_hidden_dim=p.emb_hidden_dim,
        df_hidden_dim=p.df_hidden_dim,
        emb_num_layers=p.emb_num_layers,
        df_num_layers=p.df_num_layers,
        gru_groups=p.gru_groups,
        lsnr_min=p.lsnr_min,
        lsnr_max=p.lsnr_max,
        mask_pf=p.mask_pf,
        pf_beta=p.pf_beta,
        freq_bins=p.fft_size // 2 + 1,
        erb_widths=widths,
        erb_inv_fb=np.asarray(erb_fb_matrices(widths, normalized=True, inverse=True)),
        k0=k0,
        k_enc=k_enc,
    )
    return _tree_to(params, device), _tree_to(state, device), cfg


# -- shared pieces -------------------------------------------------------------


def _embed(params, L, e3, c1):
    """e3 [B, C, T, E/4], c1 [B, C, T, F'/2] -> the encoder GRU's input
    [B, T, *], flattened channel-major."""
    b, _, t, _ = c1.shape
    cemb = grouped_linear_shuffle_apply(params["df_fc_emb"], L["df_fc_emb"],
                                        c1.transpose(1, 2).reshape(b, t, -1))
    return e3.transpose(1, 2).reshape(b, t, -1) + cemb


def _mask(params, L, cfg, conv, emb, e3, e2, e1, e0, train=False):
    """The ERB decoder over emb [B, T, H] and the encoder's outputs ->
    mask [B, T, E]; `conv(name, x)` runs a decoder conv over the frames.
    Training skips the post-filter, as JAX and the reference do."""
    demb = torch.relu(grouped_linear_shuffle_apply(params["dec_fc_emb"], L["dec_fc_emb"], emb))
    b, _, t, f4 = e3.shape
    demb = demb.reshape(b, t, -1, f4).transpose(1, 2)  # [B, C, T, E/4], channel-major
    d3 = conv("convt3", conv("conv3p", e3) + demb)
    d2 = conv("convt2", conv("conv2p", e2) + d3)
    d1 = conv("convt1", conv("conv1p", e1) + d2)
    m = conv("conv0_out", conv("conv0p", e0) + d1)[:, 0]
    return post_filter_mask(m, cfg["pf_beta"]) if cfg["mask_pf"] and not train else m


def _coefs(params, cfg, c, c0p):
    """c [B, T, H], pathway c0p [B, O*2, T, F'] -> coefficients complex
    [B, T, O, F'] (the linear head's outputs are (O*2, F')-ordered)."""
    b, t = c.shape[:2]
    order, nb_df = cfg["df_order"], cfg["nb_df"]
    coefs = torch.tanh(linear_apply(params["df_out"], c))
    coefs = coefs.reshape(b, t, order * 2, nb_df) + c0p.transpose(1, 2)
    return _complex(coefs.reshape(b, t, order, 2, nb_df).movedim(-1, -2))


def _ri(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([x.real, x.imag], dim=-1)


# -- offline forward -------------------------------------------------------------


def forward(params: Dict, state: Dict, cfg: Dict, spec: torch.Tensor,
            feat_erb: torch.Tensor, feat_spec: torch.Tensor, train: bool = False):
    """Offline forward, `train=True` as dfnet2.forward's. The I/O of
    dfnet3.forward, with alpha [B, T, 1] as the 4th output."""
    L = cfg["layers"]
    new_state = dict(state)
    conv = _seq_conv(params, state, L, train, new_state)
    e0 = conv("erb_conv0", feat_erb[:, None])
    e1 = conv("erb_conv1", e0)
    e2 = conv("erb_conv2", e1)
    e3 = conv("erb_conv3", e2)
    c0 = conv("df_conv0", torch.movedim(feat_spec, -1, 1))
    c1 = conv("df_conv1", c0)
    emb, _ = grouped_gru_apply(params["enc_emb_gru"], L["enc_emb_gru"],
                               _embed(params, L, e3, c1))
    lsnr = _lsnr(params, cfg, emb)
    m = _mask(params, L, cfg, conv, emb, e3, e2, e1, e0, train)
    spec_m = _masked(cfg, spec, m)

    c, _ = grouped_gru_apply(params["df_gru"], L["df_gru"], emb)
    alpha = sigmoid(linear_apply(params["df_fc_a"], c))
    coefs_c = _coefs(params, cfg, c, conv("df_convp", c0)).transpose(1, 2)  # [B,O,T,F']
    nb_df = cfg["nb_df"]
    if cfg.get("run_df", True):
        filt = deep_filter_offline(spec_m, coefs_c, nb_df, cfg["df_lookahead"])
        lo = filt[..., :nb_df] * alpha + spec_m[..., :nb_df] * (1 - alpha)
        out = torch.cat([lo, spec_m[..., nb_df:]], dim=-1)
    else:
        out = spec_m  # mask-only ablation: the ERB-masked spectrum
    return (_ri(out), m, lsnr, alpha), new_state


# -- streaming ---------------------------------------------------------------------


class StreamState1(NamedTuple):
    """Per-stream model carry of the streaming cell."""

    erb_buf: torch.Tensor  # [B, 1, k0-1, E]
    spec_buf: torch.Tensor  # [B, 2, k0-1, F']
    e0_buf: torch.Tensor  # [B, C, k-1, E]
    e1_buf: torch.Tensor  # [B, C, k-1, E/2]
    e2_buf: torch.Tensor  # [B, C, k-1, E/4]
    c0_buf: torch.Tensor  # [B, C, k-1, F']
    enc_gru_h: torch.Tensor  # [L*G, B, H/G]
    df_gru_h: torch.Tensor  # [L3*G, B, H/G]
    df_ring_re: torch.Tensor  # [B, O-1, F']
    df_ring_im: torch.Tensor  # [B, O-1, F']


def streaming_init(batch: int, cfg: Dict, device="cpu") -> StreamState1:
    """The zero carry, float32."""
    ch, e, fp, g = cfg["conv_ch"], cfg["nb_erb"], cfg["nb_df"], cfg["gru_groups"]
    k0m1, km1 = cfg["k0"] - 1, cfg["k_enc"] - 1

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return StreamState1(
        erb_buf=z(batch, 1, k0m1, e),
        spec_buf=z(batch, 2, k0m1, fp),
        e0_buf=z(batch, ch, km1, e),
        e1_buf=z(batch, ch, km1, e // 2),
        e2_buf=z(batch, ch, km1, e // 4),
        c0_buf=z(batch, ch, km1, fp),
        enc_gru_h=z(cfg["emb_num_layers"] * g, batch, cfg["emb_hidden_dim"] // g),
        df_gru_h=z(cfg["df_num_layers"] * g, batch, cfg["df_hidden_dim"] // g),
        df_ring_re=z(batch, cfg["df_order"] - 1, fp),
        df_ring_im=z(batch, cfg["df_order"] - 1, fp),
    )


def streaming_cell(params: Dict, state: Dict, cfg: Dict, carry: StreamState1,
                   spec_ri: torch.Tensor, feat_erb: torch.Tensor, feat_spec_ri: torch.Tensor
                   ) -> Tuple[StreamState1, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """One frame (DF lookahead 0). spec_ri [B, F, 2], feat_erb [B, E],
    feat_spec_ri [B, F', 2] -> (carry', (spec_e [B, F, 2], lsnr [B, 1],
    mask [B, E]))."""
    L = cfg["layers"]
    nb_df = cfg["nb_df"]

    def cstep(name, x):
        fn = conv_transpose2d_norm_act_step if L[name].get("transposed") else conv2d_norm_act_step
        return fn(params[name], state.get(name, {}), L[name], x)

    def win(buf, x):  # the carried frames, then this frame's [B, C, F]
        return torch.cat([buf, x[:, :, None, :]], dim=2)

    erb_win = win(carry.erb_buf, feat_erb[:, None])
    spec_win = win(carry.spec_buf, torch.movedim(feat_spec_ri, -1, 1))
    e0 = cstep("erb_conv0", erb_win)
    e0_win = win(carry.e0_buf, e0)
    e1 = cstep("erb_conv1", e0_win)
    e1_win = win(carry.e1_buf, e1)
    e2 = cstep("erb_conv2", e1_win)
    e2_win = win(carry.e2_buf, e2)
    e3 = cstep("erb_conv3", e2_win)
    c0 = cstep("df_conv0", spec_win)
    c0_win = win(carry.c0_buf, c0)
    c1 = cstep("df_conv1", c0_win)

    emb = _embed(params, L, e3[:, :, None], c1[:, :, None])[:, 0]
    enc_h, emb = grouped_gru_step(params["enc_emb_gru"], L["enc_emb_gru"], carry.enc_gru_h, emb)
    lsnr = _lsnr(params, cfg, emb)

    def one(name, x):  # a decoder conv over one frame [B, C, 1, F]
        return cstep(name, x)[:, :, None]

    m = _mask(params, L, cfg, one, emb[:, None], e3[:, :, None], e2[:, :, None],
              e1[:, :, None], e0[:, :, None])[:, 0]
    spec_m = _masked(cfg, spec_ri, m)

    df_h, c = grouped_gru_step(params["df_gru"], L["df_gru"], carry.df_gru_h, emb)
    alpha = sigmoid(linear_apply(params["df_fc_a"], c))
    coefs_c = _coefs(params, cfg, c[:, None], one("df_convp", c0[:, :, None]))[:, 0]

    ring = torch.complex(carry.df_ring_re, carry.df_ring_im)
    new_ring, filt = deep_filter(ring, spec_m[:, :nb_df], coefs_c)
    if cfg.get("run_df", True):
        lo = filt * alpha + spec_m[:, :nb_df] * (1 - alpha)
        spec_e = torch.cat([lo, spec_m[:, nb_df:]], dim=-1)
    else:
        spec_e = spec_m  # mask-only ablation; the ring still advances

    def roll(w, old, k):
        return w[:, :, 1:] if k > 1 else old

    k0, ke = cfg["k0"], cfg["k_enc"]
    new_carry = StreamState1(
        erb_buf=roll(erb_win, carry.erb_buf, k0),
        spec_buf=roll(spec_win, carry.spec_buf, k0),
        e0_buf=roll(e0_win, carry.e0_buf, ke),
        e1_buf=roll(e1_win, carry.e1_buf, ke),
        e2_buf=roll(e2_win, carry.e2_buf, ke),
        c0_buf=roll(c0_win, carry.c0_buf, ke),
        enc_gru_h=enc_h,
        df_gru_h=df_h,
        df_ring_re=new_ring.real.contiguous(),
        df_ring_im=new_ring.imag.contiguous(),
    )
    return new_carry, (_ri(spec_e), lsnr, m)


# -- chunked streaming forward: the offline form with a carried state -----------


def forward_chunk(params: Dict, state: Dict, cfg: Dict, carry: StreamState1,
                  spec: torch.Tensor, feat_erb: torch.Tensor, feat_spec: torch.Tensor
                  ) -> Tuple[StreamState1, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """T frames with streaming semantics in the offline form: every conv of
    time kernel k > 1 starts from its k-1 carried input frames, the GRUs
    from the carry. Equal to T calls of `streaming_cell`.

    spec [B, T, F, 2], feat_erb [B, T, E], feat_spec [B, T, F', 2] ->
    (carry', (spec_e [B, T, F, 2], lsnr [B, T, 1], mask [B, T, E])).
    """
    L = cfg["layers"]
    nb_df, order = cfg["nb_df"], cfg["df_order"]
    t = feat_erb.shape[1]
    conv = _seq_conv(params, state, L)

    def conv_ctx(name, x, buf, k):
        """x [B, C, T, F] after the k-1 carried frames `buf` -> (out over
        the T frames, the last k-1 input frames)."""
        if k == 1:
            return conv(name, x), buf
        xe = torch.cat([buf, x], dim=2)
        return conv(name, xe)[:, :, k - 1:], xe[:, :, xe.shape[2] - (k - 1):]

    k0, ke = cfg["k0"], cfg["k_enc"]
    e0, erb_buf = conv_ctx("erb_conv0", feat_erb[:, None], carry.erb_buf, k0)
    e1, e0_buf = conv_ctx("erb_conv1", e0, carry.e0_buf, ke)
    e2, e1_buf = conv_ctx("erb_conv2", e1, carry.e1_buf, ke)
    e3, e2_buf = conv_ctx("erb_conv3", e2, carry.e2_buf, ke)
    c0, spec_buf = conv_ctx("df_conv0", torch.movedim(feat_spec, -1, 1), carry.spec_buf, k0)
    c1, c0_buf = conv_ctx("df_conv1", c0, carry.c0_buf, ke)

    emb, enc_h = grouped_gru_apply(params["enc_emb_gru"], L["enc_emb_gru"],
                                   _embed(params, L, e3, c1), carry.enc_gru_h)
    lsnr = _lsnr(params, cfg, emb)
    m = _mask(params, L, cfg, conv, emb, e3, e2, e1, e0)
    spec_m = _masked(cfg, spec, m)

    c, df_h = grouped_gru_apply(params["df_gru"], L["df_gru"], emb, carry.df_gru_h)
    alpha = sigmoid(linear_apply(params["df_fc_a"], c))  # [B, T, 1]
    coefs_c = _coefs(params, cfg, c, conv("df_convp", c0))  # [B, T, O, F']

    ring = torch.complex(carry.df_ring_re, carry.df_ring_im)
    lo_ext = torch.cat([ring, spec_m[..., :nb_df]], dim=1)  # [B, O-1+T, F']
    taps = torch.stack([lo_ext[:, n:n + t] for n in range(order)], dim=2)  # [B, T, O, F']
    filt = torch.sum(taps * coefs_c, dim=2)
    if cfg.get("run_df", True):
        lo = filt * alpha + spec_m[..., :nb_df] * (1 - alpha)
        spec_e = torch.cat([lo, spec_m[..., nb_df:]], dim=-1)
    else:
        spec_e = spec_m  # mask-only ablation; the ring still advances

    new_ring = lo_ext[:, lo_ext.shape[1] - (order - 1):]
    new_carry = StreamState1(
        erb_buf=erb_buf.contiguous(),
        spec_buf=spec_buf.contiguous(),
        e0_buf=e0_buf.contiguous(),
        e1_buf=e1_buf.contiguous(),
        e2_buf=e2_buf.contiguous(),
        c0_buf=c0_buf.contiguous(),
        enc_gru_h=enc_h,
        df_gru_h=df_h,
        df_ring_re=new_ring.real.contiguous(),
        df_ring_im=new_ring.imag.contiguous(),
    )
    return new_carry, (_ri(spec_e), lsnr, m)
