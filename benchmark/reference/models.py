"""DeepFilterNet3 and DeepFilterNet2 in plain PyTorch, over the parameter
tree of `layers.py`, after Rikorose/DeepFilterNet `df/deepfilternet3.py`
and `df/deepfilternet2.py`.

`spec(cfg)` gives the weight shapes of a configuration (the keys of
`benchmark/configs/<name>.json`), `forward(...)` the model over a block of
frames. DFN3's forward starts from a carry (the conv context frames, the
GRU states and the DF ring), so a stream can be followed call after call;
from the zero carry it is the offline forward. DFN2's is the offline
forward of the configuration the benchmark runs: `gru_type` squeeze,
`df_output_layer` groupedlinear, `dfop_method` complex_strided,
`df_n_iter` 1.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import layers as L
from benchmark.reference.dsp import erb_fb


def _widths(cfg):
    ch = cfg["conv_ch"]
    return ch, ch * cfg["nb_erb"] // 4, cfg["df_order"] * 2


def _encoder_convs(cfg, ch):
    kin, k = tuple(cfg["conv_kernel_inp"]), tuple(cfg["conv_kernel"])
    return {
        "erb_conv0": L.conv_spec(1, ch, kin),
        "erb_conv1": L.conv_spec(ch, ch, k, fstride=2),
        "erb_conv2": L.conv_spec(ch, ch, k, fstride=2),
        "erb_conv3": L.conv_spec(ch, ch, k),
        "df_conv0": L.conv_spec(2, ch, kin),
        "df_conv1": L.conv_spec(ch, ch, k, fstride=2),
    }


def _decoder_convs(cfg, ch, df_out_ch):
    k, kt = tuple(cfg["conv_kernel"]), tuple(cfg.get("convt_kernel", cfg["conv_kernel"]))
    return {
        "conv3p": L.conv_spec(ch, ch, (1, 1)),
        "convt3": L.conv_spec(ch, ch, k),
        "conv2p": L.conv_spec(ch, ch, (1, 1)),
        "convt2": L.conv_spec(ch, ch, kt, fstride=2, transposed=True),
        "conv1p": L.conv_spec(ch, ch, (1, 1)),
        "convt1": L.conv_spec(ch, ch, kt, fstride=2, transposed=True),
        "conv0p": L.conv_spec(ch, ch, (1, 1)),
        "conv0_out": L.conv_spec(ch, 1, k, act="sigmoid"),
        "df_convp": L.conv_spec(ch, df_out_ch, (cfg["df_pathway_kernel_size_t"], 1)),
    }


def spec(cfg: Dict):
    """(params spec, state spec, statics) of the configuration's model."""
    ch, emb, df_out_ch = _widths(cfg)
    convs = dict(_encoder_convs(cfg, ch), **_decoder_convs(cfg, ch, df_out_ch))
    params = {k: v[0] for k, v in convs.items()}
    state = {k: v[1] for k, v in convs.items()}
    statics = {k: v[2] for k, v in convs.items()}
    hid, dfh = cfg["emb_hidden_dim"], cfg["df_hidden_dim"]
    lg = cfg["linear_groups"]
    if cfg["model"] == "deepfilternet3":
        params.update(
            df_fc_emb=L.grouped_linear_spec(ch * cfg["nb_df"] // 2, emb, cfg["enc_linear_groups"]),
            enc_emb_gru=L.squeezed_gru_spec(emb, hid, emb, 1, lg),
            lsnr_fc=L.linear_spec(emb, 1),
            dec_emb_gru=L.squeezed_gru_spec(emb, hid, emb, cfg["emb_num_layers"] - 1, lg),
            # DFN3's DfDecoder leaves its SqueezedGRU_S at 8 linear groups
            df_gru=L.squeezed_gru_spec(emb, dfh, None, cfg["df_num_layers"], 8),
            df_out=L.grouped_linear_spec(dfh, cfg["nb_df"] * df_out_ch, lg),
            df_fc_a=L.linear_spec(dfh, 1),
        )
    elif cfg["model"] == "deepfilternet2":
        if (cfg["gru_type"], cfg["df_output_layer"], cfg["dfop_method"], cfg["df_n_iter"]) != (
                "squeeze", "groupedlinear", "complex_strided", 1):
            raise NotImplementedError("the DFN2 reference runs the squeeze / groupedlinear / "
                                      "complex_strided / one-iteration configuration")
        params.update(
            df_fc_emb=L.grouped_linear_spec(ch * cfg["nb_df"] // 2, emb, lg),
            enc_emb_gru=L.squeezed_gru_spec(emb, hid, None, 1, lg),
            dec_emb_gru=L.squeezed_gru_spec(hid, hid, emb, cfg["emb_num_layers"] - 1, lg),
            df_gru=L.squeezed_gru_spec(hid, dfh, None, cfg["df_num_layers"], 8),
            lsnr_fc=L.linear_spec(hid, 1),
            df_out=L.grouped_linear_spec(dfh, cfg["nb_df"] * df_out_ch, lg),
            df_fc_a=L.linear_spec(dfh, 1),
        )
    else:
        raise NotImplementedError(cfg["model"])
    return params, state, statics


def zero_carry(cfg: Dict, rows: int, device) -> Dict[str, torch.Tensor]:
    """DFN3's model carry at a stream's start."""
    kt0 = cfg["conv_kernel_inp"][0]
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return {
        "erb_buf": z(rows, 1, kt0 - 1, cfg["nb_erb"]),
        "spec_buf": z(rows, 2, kt0 - 1, cfg["nb_df"]),
        "enc_h": z(1, rows, cfg["emb_hidden_dim"]),
        "dec_h": z(cfg["emb_num_layers"] - 1, rows, cfg["emb_hidden_dim"]),
        "df_h": z(cfg["df_num_layers"], rows, cfg["df_hidden_dim"]),
        "ring": torch.zeros((rows, cfg["df_order"] - 1, cfg["nb_df"]), dtype=torch.complex64,
                            device=device),
    }


def _mask(conv, demb, e3, e2, e1, e0):
    b, _, t, f4 = e3.shape
    demb = demb.reshape(b, t, f4, -1).permute(0, 3, 1, 2)
    d3 = conv("convt3", conv("conv3p", e3) + demb)
    d2 = conv("convt2", conv("conv2p", e2) + d3)
    d1 = conv("convt1", conv("conv1p", e1) + d2)
    return conv("conv0_out", conv("conv0p", e0) + d1)[:, 0]  # [B, T, E]


def _convs(params, state, statics, train, new_state):
    def conv(name, x):
        out, st = L.conv_block(params[name], state[name], statics[name], x, train)
        new_state[name] = st
        return out
    return conv


def _deep_filter(ring, spec_lo, coefs):
    """ring [B, O-1, F'] past low bins, spec_lo [B, T, F'], coefs [B, T, O, F']
    complex -> (y [B, T, F'], the ring after the last frame)."""
    order, t = coefs.shape[2], spec_lo.shape[1]
    ext = torch.cat([ring, spec_lo], dim=1)
    y = sum(ext[:, n:n + t] * coefs[:, :, n] for n in range(order))
    return y, ext[:, ext.shape[1] - (order - 1):]


def dfn3_forward(params, state, statics, cfg, carry, spec, feat_erb, feat_spec,
                 train: bool = False):
    """DFN3 over T frames from `carry`. spec complex [B, T, F], feat_erb
    [B, T, E], feat_spec complex [B, T, F'] -> (spec_e complex [B, T, F], mask
    [B, T, E], lsnr [B, T, 1], new carry, new batch-norm state)."""
    nb_df, order = cfg["nb_df"], cfg["df_order"]
    ctx = cfg["conv_kernel_inp"][0] - 1
    new_state = {}
    conv = _convs(params, state, statics, train, new_state)
    fe = torch.cat([carry["erb_buf"][:, 0], feat_erb], dim=1)[:, None]  # [B, 1, ctx+T, E]
    fs = torch.cat([carry["spec_buf"],
                    torch.stack([feat_spec.real, feat_spec.imag], dim=1)], dim=2)
    e0 = conv("erb_conv0", fe)[:, :, ctx:]
    e1 = conv("erb_conv1", e0)
    e2 = conv("erb_conv2", e1)
    e3 = conv("erb_conv3", e2)
    c0 = conv("df_conv0", fs)[:, :, ctx:]
    c1 = conv("df_conv1", c0)
    b, _, t, _ = c1.shape
    cemb = torch.relu(L.grouped_linear(params["df_fc_emb"],
                                       c1.permute(0, 2, 3, 1).reshape(b, t, -1)))
    emb, enc_h = L.squeezed_gru_s(params["enc_emb_gru"],
                                  e3.permute(0, 2, 3, 1).reshape(b, t, -1) + cemb,
                                  carry["enc_h"])
    lsnr = torch.sigmoid(L.linear(params["lsnr_fc"], emb))
    lsnr = lsnr * (cfg["lsnr_max"] - cfg["lsnr_min"]) + cfg["lsnr_min"]
    demb, dec_h = L.squeezed_gru_s(params["dec_emb_gru"], emb, carry["dec_h"])
    m = _mask(conv, demb, e3, e2, e1, e0)
    c, df_h = L.squeezed_gru_s(params["df_gru"], emb, carry["df_h"])
    c0p = conv("df_convp", c0)  # [B, O*2, T, F']
    coefs = torch.tanh(L.grouped_linear(params["df_out"], c)).reshape(b, t, nb_df, order * 2)
    coefs = (coefs + c0p.permute(0, 2, 3, 1)).reshape(b, t, nb_df, order, 2)
    coefs = torch.complex(coefs[..., 0], coefs[..., 1]).permute(0, 1, 3, 2)  # [B, T, O, F']
    y, ring = _deep_filter(carry["ring"], spec[..., :nb_df], coefs)
    spec_m = spec * (m @ erb_fb(cfg["erb_widths"], m.device, inverse=True))
    spec_e = torch.cat([y, spec_m[..., nb_df:]], dim=-1)
    new_carry = {
        "erb_buf": fe[:, :, fe.shape[2] - ctx:],
        "spec_buf": fs[:, :, fs.shape[2] - ctx:],
        "enc_h": enc_h, "dec_h": dec_h, "df_h": df_h, "ring": ring,
    }
    return spec_e, m, lsnr, new_carry, new_state


def dfn2_forward(params, state, statics, cfg, spec, feat_erb, feat_spec):
    """DFN2's offline forward (eval). spec complex [B, T, F] -> spec_e
    complex [B, T, F]: the ERB mask on every bin, then the DF op on the
    masked spectrum's low bins."""
    nb_df, order = cfg["nb_df"], cfg["df_order"]
    new_state = {}
    conv = _convs(params, state, statics, False, new_state)
    e0 = conv("erb_conv0", feat_erb[:, None])
    e1 = conv("erb_conv1", e0)
    e2 = conv("erb_conv2", e1)
    e3 = conv("erb_conv3", e2)
    c0 = conv("df_conv0", torch.stack([feat_spec.real, feat_spec.imag], dim=1))
    c1 = conv("df_conv1", c0)
    b, _, t, _ = c1.shape
    cemb = torch.relu(L.grouped_linear(params["df_fc_emb"],
                                       c1.permute(0, 2, 3, 1).reshape(b, t, -1)))
    emb, _ = L.squeezed_gru_s(params["enc_emb_gru"],
                                 e3.permute(0, 2, 3, 1).reshape(b, t, -1) + cemb)
    demb, _ = L.squeezed_gru_skip(params["dec_emb_gru"], emb)
    m = _mask(conv, demb, e3, e2, e1, e0)
    spec_m = spec * (m @ erb_fb(cfg["erb_widths"], m.device, inverse=True))
    c, _ = L.squeezed_gru_skip(params["df_gru"], emb)
    c0p = conv("df_convp", c0)
    coefs = torch.tanh(L.grouped_linear(params["df_out"], c)).reshape(b, t, nb_df, order * 2)
    coefs = (coefs + c0p.permute(0, 2, 3, 1)).reshape(b, t, nb_df, order, 2)
    coefs = torch.complex(coefs[..., 0], coefs[..., 1]).permute(0, 1, 3, 2)
    ring = spec_m.new_zeros((b, order - 1, nb_df))
    y, _ = _deep_filter(ring, spec_m[..., :nb_df], coefs)
    return torch.cat([y, spec_m[..., nb_df:]], dim=-1)
