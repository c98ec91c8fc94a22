"""The frozen counts at the configurations' widths: the model's count is the
reference's own matrix work, and the kernels' counts hold the work the
configuration needs, not one kernel's layout of it."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import common, counts
from benchmark.reference import models


def _reference_macs_a_frame(conf, frames, rows=2):
    """MACs a frame of the reference's forward that torch's flop counter
    sees (convolutions and matrix products), taken between `frames` and
    twice as many so that DFN3's context frames drop out."""
    W = common.seeded_weights(conf, 3, torch.device("cpu"))
    gen = torch.Generator().manual_seed(5)

    def macs(t):
        f = conf["fft_size"] // 2 + 1
        spec = torch.randn((rows, t, f), dtype=torch.complex64, generator=gen)
        fe = torch.randn((rows, t, conf["nb_erb"]), generator=gen)
        fs = torch.randn((rows, t, conf["nb_df"]), dtype=torch.complex64, generator=gen)
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            if conf["model"] == "deepfilternet3":
                models.dfn3_forward(*W, conf, models.zero_carry(conf, rows, "cpu"), spec, fe, fs)
            else:
                models.dfn2_forward(*W, conf, spec, fe, fs)
        return fc.get_total_flops() // 2

    return (macs(2 * frames) - macs(frames)) / (rows * frames)


@pytest.mark.parametrize("name", ["dfn3", "dfn2"])
def test_forward_macs_are_the_references_products(name):
    conf = common.load_config(name)
    f, e = conf["fft_size"] // 2 + 1, conf["nb_erb"]
    # the reference expands the ERB mask by a dense [E, F] product (one
    # gain a bin is the work), and its DF op is elementwise, which the flop
    # counter does not see; DFN2's reference leaves out the LSNR head
    seen = (counts.forward_macs(conf) - f - 4 * conf["df_order"] * conf["nb_df"] + e * f
            - (conf["emb_hidden_dim"] if name == "dfn2" else 0))
    assert _reference_macs_a_frame(conf, 4) == seen


def test_k2_macs_a_stream_and_frame():
    conf = common.load_config("dfn3")
    assert counts.k2_macs(conf) == counts.forward_macs(conf) + counts.stft_macs(conf)
    assert counts.k2_macs(conf) == 2_473_378
    # K2's dense fold of the convs and its dense DFT do 7,218,112; the count
    # holds the work, so a kernel that does less still reads under 100%
    assert counts.k2_macs(conf) < 7_218_112 / 2


def test_k1_bound_at_64_streams():
    flops, nbytes = counts.k1_work(common.load_config("dfn3"), 64)
    bound_ms = max(flops / 67e12, nbytes / 3.35e12) * 1e3
    assert round(bound_ms, 5) == 0.00022
    assert nbytes / 3.35e12 > flops / 67e12  # bound by bytes


def test_counts_scale_with_the_work():
    conf = common.load_config("dfn3")
    f1, b1 = counts.k2_work(conf, 64, 10)
    f2, b2 = counts.k2_work(conf, 128, 20)
    assert f2 == 4 * f1 and b2 > b1
    assert counts.weight_floats(conf) > 2_000_000
