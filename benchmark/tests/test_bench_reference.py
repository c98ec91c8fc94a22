"""The plain reference against the program's CPU paths, on the same seeded
weights and audio: streaming (the per-frame runtime and the whole cell's
plain version) and offline enhancement, DFN3 and DFN2."""

import numpy as np
import pytest
import torch

from benchmark import common
from benchmark.reference import stream as ref

torch.set_num_threads(1)


def small(name):
    """The configuration at small widths (the CPU's share)."""
    conf = common.load_config(name)
    cut = {"conv_ch": 8, "emb_hidden_dim": 64, "df_hidden_dim": 64}
    conf.update(cut)
    conf["sections"]["deepfilternet"].update(cut)
    return conf


def _port_carry(c):
    m = c.model
    return dict(analysis_mem=c.analysis_mem, synthesis_mem=c.synthesis_mem,
                mean_norm=c.mean_norm, unit_norm=c.unit_norm, enc_h=m.enc_gru_h,
                dec_h=m.dec_gru_h, df_h=m.df_gru_h, erb_buf=m.erb_buf, spec_buf=m.spec_buf,
                ring=torch.complex(m.df_ring_re, m.df_ring_im))


def _close(got, want, rel):
    scale = max(float(want.abs().max()), 1e-6)
    assert float((got - want).abs().max()) <= rel * scale


def _streams(conf, runtime, calls=2, streams=3, frames=6, seed=11):
    W = common.seeded_weights(conf, seed, "cpu")
    model, df_state = common.port_model(conf, W[0], W[1], "cpu")
    rt = runtime(model, df_state)
    audio = common.speech_like(streams, calls * frames * conf["hop_size"], seed, "cpu")
    c_port, c_ref = rt.init(streams), ref.init_carry(conf, streams, "cpu")
    step = frames * conf["hop_size"]
    with torch.no_grad():
        for k in range(calls):
            a = audio[:, k * step:(k + 1) * step]
            c_port, o_port = rt.process(c_port, a)
            c_ref, o_ref = ref.stream_block(W, conf, c_ref, a)
            _close(o_port, o_ref, 1e-4)
    for name, v in _port_carry(c_port).items():
        _close(v.to(c_ref[name].dtype), c_ref[name], 1e-4)


def test_stream_block_is_the_per_frame_runtime():
    from deepfilternet_torch.streaming import StreamingRuntime

    _streams(small("dfn3"), StreamingRuntime)


def test_stream_block_is_the_whole_cell_plain_version():
    from deepfilternet_torch.streaming_whole_cell import WholeCellStreamingRuntime

    def runtime(model, df_state):
        return WholeCellStreamingRuntime(model, df_state, matmul_dtype=torch.float32,
                                         backend="plain")

    _streams(common.load_config("dfn3"), runtime, streams=2, frames=4)


@pytest.mark.parametrize("name", ["dfn3", "dfn2"])
def test_offline_is_enhance(name):
    from deepfilternet_torch.enhance import enhance

    conf = small(name)
    W = common.seeded_weights(conf, 5, "cpu")
    model, df_state = common.port_model(conf, W[0], W[1], "cpu")
    audio = common.speech_like(2, 48_000 // 2 + 123, 5, "cpu")
    with torch.no_grad():
        got = enhance(model, df_state, audio.numpy(), backend="offline")
        want = ref.offline_enhance(W, conf, audio)
    assert got.shape == tuple(want.shape)
    _close(torch.from_numpy(np.ascontiguousarray(got)), want, 1e-4)


def test_weights_are_drawn_from_the_seed():
    conf = common.load_config("dfn3")
    a, b = common.seeded_weights(conf, 3, "cpu"), common.seeded_weights(conf, 3, "cpu")
    c = common.seeded_weights(conf, 4, "cpu")
    w = ("df_out", "w")
    assert torch.equal(a[0][w[0]][w[1]], b[0][w[0]][w[1]])
    assert not torch.equal(a[0][w[0]][w[1]], c[0][w[0]][w[1]])
