"""The port's streaming DFN3 slice end to end, with the demo checkpoint at
full width, against the JAX `StreamingRuntime` with its fused frontend
kernel (`use_pallas=True`) and with its op fusion (`fuse_ops=True`): atol
1e-4 end to end, as the JAX package's own streaming tests hold its runtimes
to each other; 1e-5 where the port is compared with itself."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepfilternet_tpu.enhance import enhance as j_enhance  # noqa: E402
from deepfilternet_tpu.enhance import init_df as j_init_df  # noqa: E402
from deepfilternet_tpu.streaming import RuntimeParams as JRuntimeParams  # noqa: E402
from deepfilternet_tpu.streaming import StreamingRuntime as JRuntime  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.enhance import enhance, init_df  # noqa: E402
from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend  # noqa: E402
from deepfilternet_torch.streaming import RuntimeParams, StreamingRuntime  # noqa: E402

MODEL_DIR = "pretrained/dfn3_fixture_demo"
HOP = 480
JAX_RUNTIMES = {"use_pallas": dict(use_pallas=True), "fuse_ops": dict(fuse_ops=True)}


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_config():
    """Reset the port's global config; run torch on one CPU thread (the
    per-frame ops are tiny, and the suite runs several workers at once)."""
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
def port_rt(models):
    return StreamingRuntime(models[2], models[3])


@pytest.fixture(scope="module")
def audio():
    """Seeded [2, 480*50]: a harmonic tone plus noise, 0.5 s."""
    rng = np.random.default_rng(41)
    t = np.arange(HOP * 50) / 48000.0
    tone = 0.1 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * np.sin(2 * np.pi * 660.0 * t)
    noise = rng.standard_normal((2, HOP * 50)) * 0.05
    return (tone[None] + noise).astype(np.float32)


@pytest.fixture(scope="module")
def port_out(port_rt, audio):
    carry, out = port_rt.process(port_rt.init(2), audio)
    return carry, out.numpy()


@pytest.mark.parametrize("variant", list(JAX_RUNTIMES))
def test_process_matches_jax(models, audio, port_out, variant):
    jm, jd, _, _ = models
    jrt = JRuntime(jm, jd, **JAX_RUNTIMES[variant])
    jcarry, ref = jrt.process(jrt.init(2), jnp.asarray(audio))
    carry, got = port_out
    assert got.shape == audio.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-4)
    if variant == "use_pallas":
        # the carried state too, leaf by leaf (fuse_ops reshapes nothing in it)
        for name in ("analysis_mem", "synthesis_mem", "mean_norm", "unit_norm"):
            np.testing.assert_allclose(getattr(carry, name).numpy(),
                                       np.asarray(getattr(jcarry, name)), rtol=0, atol=1e-4,
                                       err_msg=name)
        for name in carry.model._fields:
            np.testing.assert_allclose(getattr(carry.model, name).numpy(),
                                       np.asarray(getattr(jcarry.model, name)),
                                       rtol=0, atol=1e-4, err_msg=name)
        assert carry.silence_ctr.dtype == torch.int32


def test_chunked_calls_equal_one_call(port_rt, audio, port_out):
    c = port_rt.init(2)
    outs = []
    for lo, hi in ((0, 7), (7, 8), (8, 30), (30, 50)):
        c, o = port_rt.process(c, audio[:, lo * HOP: hi * HOP])
        outs.append(o.numpy())
    np.testing.assert_allclose(np.concatenate(outs, 1), port_out[1], rtol=0, atol=1e-5)


def test_process_frame_equals_process(port_rt, audio, port_out):
    c = port_rt.init(2)
    outs = []
    for i in range(6):
        c, o = port_rt.process_frame(c, audio[:, i * HOP:(i + 1) * HOP])
        outs.append(o.numpy())
    np.testing.assert_allclose(np.concatenate(outs, 1), port_out[1][:, :6 * HOP],
                               rtol=0, atol=1e-5)


def test_runtime_params_match_jax(models, audio):
    jm, jd, tm, td = models
    kw = dict(atten_lim_db=12.0, lsnr_gating=True, post_filter_beta=0.02)
    jrt = JRuntime(jm, jd, JRuntimeParams(**kw), use_pallas=True)
    rt = StreamingRuntime(tm, td, RuntimeParams(**kw))
    x = audio[:, :HOP * 20]
    _, ref = jrt.process(jrt.init(2), jnp.asarray(x))
    _, got = rt.process(rt.init(2), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("reduce", ["max", "mean"])
def test_reduce_mask_matches_jax(models, audio, reduce):
    jm, jd, tm, td = models
    kw = dict(reduce_mask=reduce, n_channels=2, post_filter_beta=0.02)
    jrt = JRuntime(jm, jd, JRuntimeParams(**kw))
    rt = StreamingRuntime(tm, td, RuntimeParams(**kw))
    x = audio[:, :HOP * 8]
    _, ref = jrt.process(jrt.init(2), jnp.asarray(x))
    _, got = rt.process(rt.init(2), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_silence_counter_carries_across_chunks(models, port_rt):
    """Zero chunks of 3 then 4 frames: the int32 counter keeps counting
    across the call boundary, output is muted from the 5th quiet frame on,
    and a loud frame resets it; the same as the JAX runtime."""
    jm, jd, _, _ = models
    jrt = JRuntime(jm, jd, use_pallas=True)
    c, jc = port_rt.init(1), jrt.init(1)
    z = np.zeros((1, HOP * 7), np.float32)
    seen = []
    for lo, hi in ((0, 3), (3, 7)):
        c, o = port_rt.process(c, z[:, lo * HOP: hi * HOP])
        jc, jo = jrt.process(jc, jnp.asarray(z[:, lo * HOP: hi * HOP]))
        seen.append(int(c.silence_ctr[0]))
        assert int(c.silence_ctr[0]) == int(jc.silence_ctr[0])
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-4)
    assert seen == [3, 7] and c.silence_ctr.dtype == torch.int32
    assert not o[:, 2 * HOP:].any()  # frames 5..7 are muted
    loud = np.full((1, HOP), 0.5, np.float32)
    c, _ = port_rt.process(c, loud)
    assert int(c.silence_ctr[0]) == 0


def test_partial_hop_raises(port_rt):
    with pytest.raises(ValueError, match="whole hops"):
        port_rt.process(port_rt.init(1), np.zeros((1, HOP * 2 + 7), np.float32))


def test_cpu_runtime_never_launches_the_kernel(port_rt):
    before = fused_analysis_frontend.launches
    port_rt.process(port_rt.init(1), np.ones((1, HOP * 2), np.float32))
    assert fused_analysis_frontend.launches == before


def test_enhance_scan_matches_jax(models):
    jm, jd, tm, td = models
    rng = np.random.default_rng(42)
    x = (rng.standard_normal((16, HOP * 40)) * 0.1).astype(np.float32)
    ref = j_enhance(jm, jd, x, backend="scan")
    got = enhance(tm, td, x, backend="scan")
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    # "auto" picks the scan at 16 rows; atten-lim mixback in the time domain
    np.testing.assert_allclose(enhance(tm, td, x, backend="auto"), got, rtol=0, atol=1e-6)
    ref_lim = j_enhance(jm, jd, x[:2], atten_lim_db=6.0, backend="scan")
    got_lim = enhance(tm, td, x[:2], atten_lim_db=6.0, backend="scan")
    np.testing.assert_allclose(got_lim, ref_lim, rtol=0, atol=1e-4)


@pytest.mark.parametrize("backend", ["offline", "auto"])  # auto -> offline below 16 rows
def test_enhance_offline_and_auto_match_jax(models, audio, backend):
    jm, jd, tm, td = models
    x = audio[:, : HOP * 12]
    ref = j_enhance(jm, jd, x, backend="offline")
    got = enhance(tm, td, x, backend=backend)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        enhance(tm, td, x, backend="nonsense")
