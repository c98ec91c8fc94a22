"""The port's `utils/seed.py`, `utils/logger.py` and `libdf_compat.py`
against the JAX package's, on the CPU.

  * `derive_rng` draws bit for bit JAX's; `torch_generator` is reproducible
    and explicit (the global torch RNG is untouched); the seed gate raises
    before `seed_everything`;
  * `warn_once`, `init_logger`'s file sink and `log_metrics`' lines equal
    JAX's; `count_params`, `estimate_macs_per_frame` and `model_summary`
    return JAX's numbers on the DFN3, DFN2 and DFN1 checkpoints, over the
    port's tensors and over numpy trees;
  * `libdf_compat` per op against JAX's at 1e-5 (shaped as the JAX
    package's own tests of it): analysis, synthesis, erb (in dB: plus two
    float32 ulps of the value, since both sides round the logarithm of a
    float32 sum), erb_inv, erb_norm and unit_norm with and without a state,
    unit_norm_init, the DF getters and types; synthesis(analysis(x)) is x
    delayed by fft_size - hop_size.
"""

import logging
import os
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepfilternet_torch import libdf_compat as t_df  # noqa: E402
from deepfilternet_torch.checkpoint import read_cp as t_read_cp  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.enhance import init_df as t_init_df  # noqa: E402
from deepfilternet_torch.utils import logger as t_log  # noqa: E402
from deepfilternet_torch.utils import seed as t_seed  # noqa: E402
from deepfilternet_tpu import libdf_compat as j_df  # noqa: E402
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.enhance import init_df as j_init_df  # noqa: E402
from deepfilternet_tpu.utils import logger as j_log  # noqa: E402
from deepfilternet_tpu.utils import seed as j_seed  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _fresh_configs():
    j_config.reset()
    t_config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    j_config.reset()
    t_config.reset()


# -- seed ------------------------------------------------------------------------


@pytest.mark.parametrize("seed,stream", [(0, ()), (42, (1,)), (2**40 + 3, (7, 0, 9))])
def test_derive_rng_matches_jax(seed, stream):
    assert t_seed.seed_everything(seed) == j_seed.seed_everything(seed) == seed
    assert t_seed.get_seed() == j_seed.get_seed() == seed
    a, b = t_seed.derive_rng(*stream), j_seed.derive_rng(*stream)
    np.testing.assert_array_equal(a.random(64), b.random(64))
    np.testing.assert_array_equal(a.integers(0, 2**31, 16), b.integers(0, 2**31, 16))
    # seed_everything seeds Python's and numpy's global generators as JAX's does
    t_seed.seed_everything(seed)
    x = (random.random(), np.random.random())
    j_seed.seed_everything(seed)
    assert x == (random.random(), np.random.random())


def test_torch_generator_reproducible_and_explicit(monkeypatch):
    monkeypatch.setattr(t_seed, "_GLOBAL_SEED", None)
    with pytest.raises(RuntimeError, match="seed_everything"):
        t_seed.torch_generator(1)
    t_seed.seed_everything(5)
    state = torch.random.get_rng_state()
    a = torch.randn(32, generator=t_seed.torch_generator(1, 2))
    b = torch.randn(32, generator=t_seed.torch_generator(1, 2))
    c = torch.randn(32, generator=t_seed.torch_generator(1, 3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(state, torch.random.get_rng_state())
    g = t_seed.torch_generator(1, 2, device="cpu")
    assert g.device.type == "cpu"
    assert g.initial_seed() == int(t_seed.derive_rng(1, 2).integers(0, 2**63 - 1))
    t_seed.seed_everything(6)
    assert not torch.equal(a, torch.randn(32, generator=t_seed.torch_generator(1, 2)))


# -- logger ----------------------------------------------------------------------


def test_warn_once_and_log_metrics_match_jax(tmp_path, caplog):
    """Both packages log to the one "df" logger; each keeps its own set of
    warnings already given."""
    metrics = {"b": 0.5, "A": 1e-5, "c": np.float32(12.25), "n": 3, "s": "x"}
    lines = {}
    for tag, mod in (("torch", t_log), ("jax", j_log)):
        path = str(tmp_path / f"{tag}.log")
        lg = mod.init_logger("info", file=path)
        assert lg is logging.getLogger("df") and lg.level == logging.INFO
        mod.warn_once(f"careful {tag}")
        mod.warn_once(f"careful {tag}")
        mod.log_metrics("valid", metrics)
        for h in lg.handlers:
            h.flush()
        with open(path) as f:
            lines[tag] = [ln.split(" | ", 1)[1] for ln in f.read().splitlines()]
    assert lines["torch"] == [ln.replace("jax", "torch") for ln in lines["jax"]]
    assert lines["torch"] == ["WARNONCE | df | careful torch",
                              "INFO     | df | valid | A: 1.000E-05 | b: 0.50000 | c: 12.25000 "
                              "| n: 3 | s: x"]
    assert t_log.WARNONCE == j_log.WARNONCE == 25
    logging.getLogger("df").handlers.clear()


@pytest.mark.parametrize("name", ["dfn3_fixture_demo", "dfn2_fixture_demo",
                                  "dfn1_fixture_demo"])
def test_model_summary_matches_jax(name):
    model_dir = os.path.join(REPO, "pretrained", name)
    tm, _, _ = t_init_df(model_dir, device="cpu")
    jm, _, _ = j_init_df(model_dir)
    n = j_log.count_params(jm.params)
    macs = j_log.estimate_macs_per_frame(jm.params, jm.cfg)
    assert t_log.count_params(tm.params) == n > 0
    assert t_log.estimate_macs_per_frame(tm.params, tm.cfg) == macs > 0
    assert t_log.model_summary(tm.params, tm.cfg) == j_log.model_summary(jm.params, jm.cfg)
    # over the checkpoint's numpy tree: the sum of its leaf sizes
    payload = t_read_cp(os.path.join(model_dir, "checkpoints"), "best")
    leaves = jax.tree.leaves(payload["params"])
    assert t_log.count_params(payload["params"]) == sum(x.size for x in leaves) == n
    assert t_log.estimate_macs_per_frame(payload["params"], tm.cfg) == macs


# -- libdf_compat ------------------------------------------------------------------


def _close(got, want, rtol=0.0):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL)


def test_df_class_api_matches_jax():
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((1, 48000)).astype(np.float32)
    for args in ((48000, 960, 480), (16000, 320, 160, 24, 2)):
        dt, dj = t_df.DF(*args, device="cpu"), j_df.DF(*args)
        spec, jspec = dt.analysis(audio), dj.analysis(audio)
        assert spec.dtype == np.complex64 and spec.shape == (1, 48000 // args[2], args[1] // 2 + 1)
        _close(spec, jspec)
        out = dt.synthesis(jspec)
        assert out.shape == (1, 48000)
        _close(out, dj.synthesis(jspec))
        w = dt.erb_widths()
        assert w.dtype == np.uint64 and np.array_equal(w, dj.erb_widths())
        assert int(w.sum()) == args[1] // 2 + 1
        np.testing.assert_array_equal(dt.fft_window(), dj.fft_window())
        for getter in ("sr", "fft_size", "hop_size", "nb_erb"):
            assert getattr(dt, getter)() == getattr(dj, getter)()
        dt.reset()
    # 1-D input is one channel, as the binding's
    _close(dt.analysis(audio[0]), dj.analysis(audio[0]))


def test_synthesis_of_analysis_is_delayed_input():
    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal((2, 48000))).astype(np.float32)
    df = t_df.DF(48000, 960, 480, device="cpu")
    y = df.synthesis(df.analysis(x))
    d = 960 - 480
    np.testing.assert_allclose(y[:, d:], x[:, :-d], atol=1e-4)


@pytest.mark.parametrize("seed", [1, 2])
def test_module_fns_match_jax(seed):
    rng = np.random.default_rng(seed)
    df = t_df.DF(48000, 960, 480, device="cpu")
    scale = 10.0 ** rng.uniform(-3, 0)
    spec = (scale * (rng.standard_normal((2, 20, 481))
                     + 1j * rng.standard_normal((2, 20, 481)))).astype(np.complex64)
    widths = df.erb_widths()
    e = t_df.erb(spec, widths, device="cpu")
    assert e.shape == (2, 20, 32)
    # dB values up to ~100 in size: a float32 ulp there is 7.6e-6
    _close(e, j_df.erb(spec, widths), rtol=2.4e-7)
    _close(t_df.erb(spec, widths, db=False, device="cpu"), j_df.erb(spec, widths, db=False))
    gains = rng.uniform(0, 1, (2, 20, 32)).astype(np.float32)
    _close(t_df.erb_inv(gains, widths, device="cpu"), j_df.erb_inv(gains, widths))
    np.testing.assert_allclose(t_df.erb_inv(np.ones((1, 20, 32), np.float32), widths,
                                            device="cpu"), 1.0, atol=1e-6)
    je = j_df.erb(spec, widths)
    _close(t_df.erb_norm(je, 0.99, device="cpu"), j_df.erb_norm(je, 0.99))
    state = rng.uniform(-80, -40, (2, 32)).astype(np.float32)
    _close(t_df.erb_norm(je, 0.95, state, device="cpu"), j_df.erb_norm(je, 0.95, state))
    _close(t_df.unit_norm(spec[..., :96], 0.99, device="cpu"),
           j_df.unit_norm(spec[..., :96], 0.99))
    ustate = rng.uniform(1e-4, 1e-2, (2, 96)).astype(np.float32)
    _close(t_df.unit_norm(spec[..., :96], 0.9, ustate, device="cpu"),
           j_df.unit_norm(spec[..., :96], 0.9, ustate))
    s0 = t_df.unit_norm_init(96)
    assert s0.shape == (1, 96) and s0.flags.writeable
    np.testing.assert_array_equal(s0, j_df.unit_norm_init(96))


def test_libdf_compat_needs_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_df.DF(48000, 960, 480)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_df.erb(np.zeros((1, 2, 481), np.complex64), np.full(1, 481))
