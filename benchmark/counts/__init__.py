"""Operations and bytes of the work each cell asks for, from the
configuration's widths alone (never from the program's tensors), so that a
roofline reads the same work whatever computes it.

All counts are multiply-adds (MACs); a FLOP count is twice that.
"""

from __future__ import annotations

import math
from typing import Dict

F32 = 4


def _w(conf: Dict):
    """The widths the counts read."""
    fft = conf["fft_size"]
    return dict(fft=fft, f=fft // 2 + 1, hop=conf["hop_size"], e=conf["nb_erb"],
                fdf=conf["nb_df"], o=conf["df_order"], c=conf["conv_ch"],
                emb=conf["conv_ch"] * conf["nb_erb"] // 4, h=conf["emb_hidden_dim"],
                hdf=conf["df_hidden_dim"], ldec=conf["emb_num_layers"] - 1,
                ldf=conf["df_num_layers"], kt0=conf["conv_kernel_inp"][0],
                kf0=conf["conv_kernel_inp"][1], kf=conf["conv_kernel"][1])


def _gru(i: int, h: int, layers: int) -> int:
    return 3 * h * (i + h) + 3 * h * 2 * h * (layers - 1)


def rfft_macs(n: int) -> int:
    """MACs of one real FFT (or its inverse) of n points: the usual count of
    a real transform, 2.5 n log2 n FLOPs."""
    return round(1.25 * n * math.log2(n))


def stft_macs(conf: Dict) -> int:
    """MACs a frame of the DSP around the model: the analysis FFT, the
    synthesis FFT, and the ERB band sums of the features (each bin's power
    into its one band). Windows, norms and overlap-add are elementwise and
    not counted."""
    w = _w(conf)
    return 2 * rfft_macs(w["fft"]) + w["f"]


def k2_macs(conf: Dict) -> int:
    """MACs a stream and frame of DFN3's whole streaming cell, the work the
    configuration needs whatever computes it: the model's forward
    (`forward_macs`, each conv by its kernel taps) and the DSP around it
    (`stft_macs`). 2,473,378 at DFN3's defaults."""
    return forward_macs(conf) + stft_macs(conf)


def carry_floats(conf: Dict) -> int:
    """Floats of one stream's carry at the configuration's widths."""
    w = _w(conf)
    return (2 * (w["fft"] - w["hop"]) + w["e"] + w["fdf"] + 1
            + (w["kt0"] - 1) * (w["e"] + 2 * w["fdf"])
            + w["h"] * (1 + w["ldec"]) + w["hdf"] * w["ldf"] + 2 * (w["o"] - 1) * w["fdf"])


def weight_floats(conf: Dict) -> int:
    """Floats of the model's weights (parameters and batch-norm statistics)
    at the configuration's widths, from the reference's shapes."""
    from benchmark.reference import layers, models

    pspec, sspec, _ = models.spec(conf)
    return sum(math.prod(leaf.shape) for tree in (pspec, sspec)
               for _, leaf in layers.leaves(tree))


def k2_work(conf: Dict, streams: int, frames: int):
    """(FLOPs, bytes) of one call: the MACs twice for every stream and frame;
    the weights read once, the audio in and out and the carry in and out."""
    flops = 2 * k2_macs(conf) * streams * frames
    nbytes = F32 * (weight_floats(conf) + 2 * streams * frames * conf["hop_size"]
                    + 2 * streams * carry_floats(conf))
    return flops, nbytes


def k1_work(conf: Dict, streams: int):
    """(FLOPs, bytes) of one frame of K1, the fused analysis frontend: the
    analysis FFT and the ERB band sums; the memories, the hop and the norms
    in, the memories, the spectrum, the features and the norms out."""
    w = _w(conf)
    f, d, e, fdf = w["f"], w["fft"] - w["hop"], w["e"], w["fdf"]
    flops = 2 * streams * (rfft_macs(w["fft"]) + f)
    nbytes = F32 * (streams * (d + w["hop"] + e + fdf)
                    + streams * (d + 2 * f + 2 * e + 3 * fdf))
    return flops, nbytes


def forward_macs(conf: Dict) -> int:
    """MACs a frame of the model's forward at the configuration's widths, as
    the layers compute it: each conv's kernel over its output bins (a
    transposed conv's over its input bins) and its pointwise conv, grouped
    linears by group, the GRUs, the mask's gain a bin and the DF op. The
    STFT is not counted."""
    w = _w(conf)
    e, fdf, c, emb, h, hdf, o = w["e"], w["fdf"], w["c"], w["emb"], w["h"], w["hdf"], w["o"]
    kf, kt0, kf0 = w["kf"], w["kt0"], w["kf0"]

    def sep(cin, cout, kt, kfr, bins_out, bins_w=None):
        g = math.gcd(cin, cout)
        main = (bins_w or bins_out) * cout * (cin // g) * kt * kfr
        pw = bins_out * cout * cout if g > 1 and max(kt, kfr) > 1 else 0
        return main + pw

    convs = (sep(1, c, kt0, kf0, e) + sep(c, c, 1, kf, e // 2) + sep(c, c, 1, kf, e // 4)
             + sep(c, c, 1, kf, e // 4) + sep(2, c, kt0, kf0, fdf) + sep(c, c, 1, kf, fdf // 2)
             + 2 * sep(c, c, 1, 1, e // 4) + sep(c, c, 1, kf, e // 4)      # conv3p, conv2p, convt3
             + sep(c, c, 1, kf, e // 2, e // 4) + sep(c, c, 1, 1, e // 2)  # convt2, conv1p
             + sep(c, c, 1, kf, e, e // 2) + sep(c, c, 1, 1, e)             # convt1, conv0p
             + sep(c, 1, 1, kf, e) + sep(c, 2 * o, 1, 1, fdf))             # conv0_out, df_convp
    lg = conf["linear_groups"]
    if conf["model"] == "deepfilternet3":
        lin = (c * fdf // 2) * emb // conf["enc_linear_groups"] + emb
        grus = (emb * h // lg + _gru(h, h, 1) + h * emb // lg
                + emb * h // lg + _gru(h, h, w["ldec"]) + h * emb // lg
                + emb * hdf // 8 + _gru(hdf, hdf, w["ldf"]))
    else:
        lin = (c * fdf // 2) * emb // lg + h
        grus = (emb * h // lg + _gru(h, h, 1)
                + h * h // lg + _gru(h, h, w["ldec"]) + h * emb // lg
                + h * hdf // 8 + _gru(hdf, hdf, w["ldf"]))
    head = hdf * 2 * o * fdf // lg
    apply = w["f"] + 4 * o * fdf
    return convs + lin + grus + head + apply
