"""The port's chunked streaming runtime on the CPU: `forward_chunk` against
the port's own per-frame `streaming_cell`, and `ChunkedStreamingRuntime`
against the JAX package's `ChunkedStreamingRuntime` and the port's per-frame
`StreamingRuntime`, on the demo checkpoint: atol 1e-4 end to end, 1e-5 with
the runtime stages on (as the JAX tests hold their pair) and where the port
is compared with itself. Chunk and call boundaries must be state-continuous,
the int32 silence counter included."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepfilternet_tpu.enhance import init_df as j_init_df  # noqa: E402
from deepfilternet_tpu.streaming import ChunkedStreamingRuntime as JChunked  # noqa: E402
from deepfilternet_tpu.streaming import RuntimeParams as JRuntimeParams  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.enhance import init_df  # noqa: E402
from deepfilternet_torch.models import dfnet3 as t_dfnet3  # noqa: E402
from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend  # noqa: E402
from deepfilternet_torch.streaming import (  # noqa: E402
    ChunkedStreamingRuntime,
    RuntimeParams,
    StreamingRuntime,
)

MODEL_DIR = "pretrained/dfn3_fixture_demo"
HOP = 480
FRAMES = 14
STAGES = dict(atten_lim_db=12.0, lsnr_gating=True)


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_config():
    """Reset the port's global config; run torch on one CPU thread (the
    suite runs several workers at once)."""
    t_config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jm, jd, _ = j_init_df(MODEL_DIR)
    tm, td, _ = init_df(MODEL_DIR, device="cpu")
    return jm, jd, tm, td


@pytest.fixture(scope="module")
def audio():
    """Seeded [2, 480*14]: a harmonic tone plus noise."""
    rng = np.random.default_rng(51)
    t = np.arange(HOP * FRAMES) / 48000.0
    tone = 0.1 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * np.sin(2 * np.pi * 660.0 * t)
    return (tone[None] + rng.standard_normal((2, HOP * FRAMES)) * 0.05).astype(np.float32)


@pytest.fixture(scope="module")
def per_frame(models, audio):
    """The port's per-frame runtime output, default params and STAGES."""
    _, _, tm, td = models
    outs = {}
    for name, kw in (("default", {}), ("stages", STAGES)):
        rt = StreamingRuntime(tm, td, RuntimeParams(**kw))
        outs[name] = rt.process(rt.init(2), audio)[1].numpy()
    return outs


@pytest.mark.parametrize("ktp", [1, 5])
def test_forward_chunk_matches_cell(ktp):
    """A random-init port model: two chunks (4 + 5 frames) equal nine calls
    of the per-frame cell, outputs and every carried array."""
    t_config.reset()
    t_config.set("DF_PATHWAY_KERNEL_SIZE_T", str(ktp), section="deepfilternet")
    try:
        params, state, cfg = t_dfnet3.init_dfnet3(torch.Generator().manual_seed(3))
    finally:
        t_config.reset()
    rng = np.random.default_rng(52)
    b, t = 2, 9
    spec = torch.from_numpy((rng.standard_normal((b, t, 481, 2)) * 0.1).astype(np.float32))
    fe = torch.from_numpy((rng.standard_normal((b, t, 32)) * 0.5).astype(np.float32))
    fs = torch.from_numpy((rng.standard_normal((b, t, 96, 2)) * 0.5).astype(np.float32))
    carry = t_dfnet3.streaming_init(b, cfg)
    ref = {"spec_e": [], "lsnr": [], "mask": []}
    for i in range(t):
        carry, outs = t_dfnet3.streaming_cell(params, state, cfg, carry, spec[:, i], fe[:, i],
                                              fs[:, i])
        for k, o in zip(ref, outs):
            ref[k].append(o)
    c = t_dfnet3.streaming_init(b, cfg)
    got = {k: [] for k in ref}
    for lo, hi in ((0, 4), (4, t)):
        c, outs = t_dfnet3.forward_chunk(params, state, cfg, c, spec[:, lo:hi], fe[:, lo:hi],
                                         fs[:, lo:hi])
        for k, o in zip(got, outs):
            got[k].append(o)
    for k in ref:
        np.testing.assert_allclose(torch.cat(got[k], 1).numpy(), torch.stack(ref[k], 1).numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    for name in c._fields:
        np.testing.assert_allclose(getattr(c, name).numpy(), getattr(carry, name).numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("chunk_frames", [6, 4])
@pytest.mark.parametrize("params", ["default", "stages"])
def test_chunked_matches_jax_and_per_frame(models, audio, per_frame, params, chunk_frames):
    """14 frames: whole chunks and a ragged last one."""
    jm, jd, tm, td = models
    kw = STAGES if params == "stages" else {}
    atol = 1e-5 if kw else 1e-4
    jrt = JChunked(jm, jd, JRuntimeParams(**kw), chunk_frames=chunk_frames)
    jcarry, ref = jrt.process(jrt.init(2), jnp.asarray(audio))
    rt = ChunkedStreamingRuntime(tm, td, RuntimeParams(**kw), chunk_frames=chunk_frames)
    carry, got = rt.process(rt.init(2), audio)
    assert got.shape == audio.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol)
    np.testing.assert_allclose(got.numpy(), per_frame[params], rtol=0, atol=atol)
    for name in ("analysis_mem", "synthesis_mem", "mean_norm", "unit_norm"):
        np.testing.assert_allclose(getattr(carry, name).numpy(),
                                   np.asarray(getattr(jcarry, name)), rtol=0, atol=1e-4,
                                   err_msg=name)
    for name in carry.model._fields:
        np.testing.assert_allclose(getattr(carry.model, name).numpy(),
                                   np.asarray(getattr(jcarry.model, name)), rtol=0, atol=1e-4,
                                   err_msg=name)
    assert carry.silence_ctr.dtype == torch.int32


def test_calls_equal_one_call(models, audio, per_frame):
    """Uneven calls (5 + 1 + 8 frames, chunks of 4) continue each other."""
    _, _, tm, td = models
    rt = ChunkedStreamingRuntime(tm, td, chunk_frames=4)
    c, outs = rt.init(2), []
    for lo, hi in ((0, 5), (5, 6), (6, FRAMES)):
        c, o = rt.process(c, audio[:, lo * HOP: hi * HOP])
        outs.append(o.numpy())
    _, one = rt.process(rt.init(2), audio)
    np.testing.assert_allclose(np.concatenate(outs, 1), one.numpy(), rtol=0, atol=1e-5)
    # process_frame is a chunk of one
    c, outs = rt.init(2), []
    for i in range(3):
        c, o = rt.process_frame(c, audio[:, i * HOP:(i + 1) * HOP])
        outs.append(o.numpy())
    np.testing.assert_allclose(np.concatenate(outs, 1), one.numpy()[:, :3 * HOP],
                               rtol=0, atol=1e-5)


def test_silence_counter_continuity(models):
    """3 zero frames count to 3 in both runtimes; a loud frame inside the
    next chunk resets both counters alike; the JAX chunked runtime agrees."""
    jm, jd, tm, td = models
    rt = StreamingRuntime(tm, td)
    crt = ChunkedStreamingRuntime(tm, td, chunk_frames=4)
    jrt = JChunked(jm, jd, JRuntimeParams(), chunk_frames=4)
    z = np.zeros((1, HOP * 3), np.float32)
    ca, cb, cj = rt.init(1), crt.init(1), jrt.init(1)
    ca, _ = rt.process(ca, z)
    cb, _ = crt.process(cb, z)
    cj, _ = jrt.process(cj, jnp.asarray(z))
    assert int(ca.silence_ctr[0]) == int(cb.silence_ctr[0]) == int(cj.silence_ctr[0]) == 3
    loud = np.concatenate([z[:, :HOP], np.full((1, HOP), 0.5, np.float32), z[:, :2 * HOP]], 1)
    ca, oa = rt.process(ca, loud)
    cb, ob = crt.process(cb, loud)
    cj, oj = jrt.process(cj, jnp.asarray(loud))
    assert int(ca.silence_ctr[0]) == int(cb.silence_ctr[0]) == int(cj.silence_ctr[0]) == 2
    assert cb.silence_ctr.dtype == torch.int32
    np.testing.assert_allclose(ob.numpy(), oa.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ob.numpy(), np.asarray(oj), rtol=0, atol=1e-5)
    # a long quiet run mutes from the 5th quiet frame on, across chunks
    c, o = crt.process(crt.init(1), np.zeros((1, HOP * 9), np.float32))
    assert not o[:, 5 * HOP:].any() and int(c.silence_ctr[0]) >= 5


def test_never_launches_the_frontend_kernel(models, audio):
    _, _, tm, td = models
    rt = ChunkedStreamingRuntime(tm, td, chunk_frames=4)
    before = fused_analysis_frontend.launches
    c, _ = rt.process(rt.init(2), audio[:, :6 * HOP])
    rt.process_frame(c, audio[:, 6 * HOP:7 * HOP])
    assert fused_analysis_frontend.launches == before


def test_rejects_what_it_cannot_run(models):
    _, _, tm, td = models
    rt = ChunkedStreamingRuntime(tm, td)
    with pytest.raises(ValueError, match="whole hops"):
        rt.process(rt.init(1), np.zeros((1, HOP * 2 + 7), np.float32))
    with pytest.raises(ValueError):
        ChunkedStreamingRuntime(tm, td, chunk_frames=0)

    class NoChunk:
        __name__ = "no_chunk"

    with pytest.raises(NotImplementedError, match="forward_chunk"):
        ChunkedStreamingRuntime(dataclasses.replace(tm, module=NoChunk(), _cache={}), td)
