"""DSP pieces of the PyTorch port against the JAX package on the same inputs."""

import importlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepfilternet_tpu.ops import df_op as j_df  # noqa: E402
from deepfilternet_tpu.ops import erb as j_erb  # noqa: E402
from deepfilternet_tpu.ops import norms as j_norms  # noqa: E402
from deepfilternet_tpu.ops import postfilter as j_pf  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.ops import df_op as t_df  # noqa: E402
from deepfilternet_torch.ops import erb as t_erb  # noqa: E402
from deepfilternet_torch.ops import norms as t_norms  # noqa: E402
from deepfilternet_torch.ops import postfilter as t_pf  # noqa: E402
from deepfilternet_torch.ops import stft as t_stft  # noqa: E402

# the JAX package's ops/__init__ re-exports a function named `stft`
j_stft = importlib.import_module("deepfilternet_tpu.ops.stft")
STFT = t_stft.Stft(sr=48000, fft_size=960, hop_size=480)


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_config():
    """Reset the port's global config; run torch on one CPU thread (the
    per-frame ops are tiny, and the suite runs several workers at once)."""
    t_config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("sr,fft,bands,min_freqs", [
    (48000, 960, 32, 2), (48000, 960, 32, 1), (48000, 960, 24, 2),
    (16000, 320, 32, 2), (48000, 1920, 32, 3),
])
def test_erb_widths_and_filterbanks_equal(sr, fft, bands, min_freqs):
    w = t_erb.erb_widths(sr, fft, bands, min_freqs)
    assert w == j_erb.erb_widths(sr, fft, bands, min_freqs)
    for normalized in (True, False):
        for inverse in (True, False):
            np.testing.assert_array_equal(
                t_erb.erb_fb_matrices(w, normalized, inverse),
                j_erb.erb_fb_matrices(w, normalized, inverse),
            )


@pytest.mark.parametrize("fft,hop", [(960, 480), (320, 160), (512, 128)])
def test_window_and_dft_matrices(fft, hop):
    np.testing.assert_allclose(t_stft.vorbis_window(fft), j_stft.vorbis_window(fft),
                               rtol=0, atol=1e-7)
    assert t_stft.wnorm(fft, hop) == j_stft.wnorm(fft, hop)
    for a, b in zip(t_stft.dft_matrices(fft, hop), j_stft.dft_matrices(fft, hop)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
    for a, b in zip(t_stft.idft_matrices(fft), j_stft.idft_matrices(fft)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)


@pytest.mark.parametrize("fft,hop", [(960, 480), (480, 240)])
def test_stft_config_properties(fft, hop):
    """`Stft`'s properties equal JAX's (the window bit for bit), and it stays
    a three-field NamedTuple that unpacks, compares and pickles as before."""
    import pickle

    t, j = t_stft.Stft(48000, fft, hop), j_stft.Stft(48000, fft, hop)
    assert (t.freq_size, t.delay, t.wnorm) == (j.freq_size, j.delay, j.wnorm)
    assert t.freq_size == fft // 2 + 1 and t.delay == fft - hop
    assert t.window.dtype == j.window.dtype == np.float32
    np.testing.assert_array_equal(t.window, j.window)
    assert t._fields == ("sr", "fft_size", "hop_size") and len(t) == 3
    assert t._asdict() == {"sr": 48000, "fft_size": fft, "hop_size": hop}
    assert tuple(t) == tuple(j) and pickle.loads(pickle.dumps(t)) == t


def test_analysis_and_synthesis_steps_chained():
    rng = np.random.default_rng(11)
    s, d = 4, 480
    jcfg = j_stft.Stft(sr=48000, fft_size=960, hop_size=480)
    amem = smem = np.zeros((s, d), np.float32)
    ja, js, ta, ts = jnp.asarray(amem), jnp.asarray(smem), _t(amem), _t(smem)
    for _ in range(4):
        frame = (rng.standard_normal((s, 480)) * 0.1).astype(np.float32)
        ja, jre, jim = j_stft.analysis_step_ri(ja, jnp.asarray(frame), jcfg)
        ta, tre, tim = t_stft.analysis_step_ri(ta, _t(frame), STFT)
        for a, b in ((ja, ta), (jre, tre), (jim, tim)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)
        js, jout = j_stft.synthesis_step_ri(js, jre, jim, jcfg)
        ts, tout = t_stft.synthesis_step_ri(ts, tre, tim, STFT)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)


def test_analysis_synthesis_reconstructs_delayed_input():
    """Perfect reconstruction of the port on its own: the output is the
    input delayed by fft - hop."""
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((2, 480 * 6)) * 0.1).astype(np.float32)
    amem = smem = torch.zeros((2, 480))
    outs = []
    for i in range(6):
        amem, re, im = t_stft.analysis_step_ri(amem, _t(x[:, i * 480:(i + 1) * 480]), STFT)
        smem, out = t_stft.synthesis_step_ri(smem, re, im, STFT)
        outs.append(out.numpy())
    y = np.concatenate(outs, 1)
    np.testing.assert_allclose(y[:, 480:], x[:, :-480], rtol=0, atol=1e-5)


def test_norm_alpha_and_inits():
    for sr, hop, tau in ((48000, 480, 1.0), (16000, 160, 0.5), (48000, 960, 2.0)):
        assert t_norms.get_norm_alpha(sr, hop, tau) == j_norms.get_norm_alpha(sr, hop, tau)
    for n in (32, 96):
        np.testing.assert_array_equal(t_norms.mean_norm_init(n), j_norms.mean_norm_init(n))
        np.testing.assert_array_equal(t_norms.unit_norm_init(n), j_norms.unit_norm_init(n))


def test_erb_norm_step_chained():
    rng = np.random.default_rng(13)
    st = np.broadcast_to(j_norms.mean_norm_init(32), (3, 32)).astype(np.float32)
    js, ts = jnp.asarray(st), _t(st)
    for _ in range(5):
        x = (rng.standard_normal((3, 32)) * 10 - 70).astype(np.float32)
        js, jo = j_norms.erb_norm_step(js, jnp.asarray(x), 0.99)
        ts, to = t_norms.erb_norm_step(ts, _t(x), 0.99)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def test_deep_filter_ring():
    rng = np.random.default_rng(14)
    ring, lo, coefs = _cplx(rng, (3, 4, 96)), _cplx(rng, (3, 96)), _cplx(rng, (3, 5, 96))
    jr, jy = j_df.deep_filter(jnp.asarray(ring), jnp.asarray(lo), jnp.asarray(coefs))
    tr, ty = t_df.deep_filter(_t(ring), _t(lo), _t(coefs))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_post_filter():
    rng = np.random.default_rng(15)
    noisy = _cplx(rng, (4, 385))
    enh = (noisy * rng.uniform(0.0, 1.2, (4, 385))).astype(np.complex64)
    jo = j_pf.post_filter(jnp.asarray(noisy), jnp.asarray(enh), beta=0.02)
    to = t_pf.post_filter(_t(noisy), _t(enh), beta=0.02)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)


# -- the complex per-frame steps -------------------------------------------------


def test_stft_state_init():
    st = t_stft.stft_state_init((3,), STFT)
    jst = j_stft.stft_state_init((3,), j_stft.Stft(sr=48000, fft_size=960, hop_size=480))
    assert st._fields == jst._fields
    for a, b in zip(st, jst):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32 and not a.any()


def test_complex_analysis_and_synthesis_steps_chained():
    """analysis_step (rfft) and synthesis_step (irfft) hop by hop against
    JAX's, memories and outputs at 1e-5, and against the port's own offline
    stft at 1e-5."""
    rng = np.random.default_rng(16)
    jcfg = j_stft.Stft(sr=48000, fft_size=960, hop_size=480)
    x = (rng.standard_normal((3, 480 * 6)) * 0.1).astype(np.float32)
    ja, js = j_stft.stft_state_init((3,), jcfg)
    ta, ts = t_stft.stft_state_init((3,), STFT)
    specs = []
    for i in range(6):
        frame = x[:, i * 480:(i + 1) * 480]
        ja, jspec = j_stft.analysis_step(ja, jnp.asarray(frame), jcfg)
        ta, tspec = t_stft.analysis_step(ta, _t(frame), STFT)
        assert tspec.dtype == torch.complex64
        np.testing.assert_allclose(tspec.numpy(), np.asarray(jspec), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        js, jout = j_stft.synthesis_step(js, jspec, jcfg)
        ts, tout = t_stft.synthesis_step(ts, tspec, STFT)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
        specs.append(tspec)
    np.testing.assert_allclose(torch.stack(specs, 1).numpy(),
                               t_stft.stft(_t(x), STFT).numpy(), rtol=0, atol=1e-5)


def test_unit_norm_step_chained():
    """unit_norm_step frame by frame against JAX's and against the port's
    offline unit_norm, 1e-5."""
    rng = np.random.default_rng(17)
    x = _cplx(rng, (40, 96)) * np.float32(0.01)
    js = jnp.asarray(j_norms.unit_norm_init(96))
    ts = _t(np.array(t_norms.unit_norm_init(96)))
    outs = []
    for t in range(40):
        js, jo = j_norms.unit_norm_step(js, jnp.asarray(x[t]), 0.99)
        ts, to = t_norms.unit_norm_step(ts, _t(x[t]), 0.99)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
        outs.append(to)
    np.testing.assert_allclose(torch.stack(outs).numpy(),
                               t_norms.unit_norm(_t(x), 0.99, axis=0).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("beta", [0.02, 0.1])
def test_post_filter_mask(beta):
    m = np.random.default_rng(18).uniform(0.0, 1.0, (4, 7, 32)).astype(np.float32)
    m[0, 0, :4] = (0.0, 1e-7, 1.0, 0.5)
    np.testing.assert_allclose(t_pf.post_filter_mask(_t(m), beta).numpy(),
                               np.asarray(j_pf.post_filter_mask(jnp.asarray(m), beta)),
                               rtol=0, atol=1e-5)
