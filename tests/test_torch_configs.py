"""BASELINE.json's configuration matrix on the port: the counterpart of
`tests/test_configs.py`, held against the JAX package on the same inputs
rather than only checked for finite output.

Each configuration is set in both packages' configs; JAX initialises the
model at random and `params_from_numpy` carries its numbers into the port.
The widths are narrow (`_torch_families.SMALL`: 8 conv channels, GRUs of
64), since the matrix varies the DSP configuration and the model family,
not the widths. The audio is a seeded harmonic tone plus noise (never the
reference's asset, which is not in the repository).

Tolerances, float32 on both sides: 1e-4 end to end (the JAX package's own
between its runtimes; the measured gap is below 1e-7), 2e-4 for the
streaming cell against the offline forward (`tests/test_configs.py`), 1e-5
where the port is compared with itself.

The low-latency configuration (FFT 480, hop 240, 48 DF bins: a 5 ms delay)
runs the per-frame paths through K1's plain version here; `chip_smoke.py`
phase 15 runs them through the CUDA kernel on the card. JAX's whole cell
takes only DFN3's default geometry; the port's takes DFN3-ll too
(`tests/test_torch_whole_cell_geometry.py`, at the default widths).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from _torch_families import (  # noqa: E402
    E2E,
    SMALL,
    STREAM_VS_OFFLINE,
    assert_same_cfg,
    both_configs,
    build,
    carry_params,
    check_forward,
    close,
    rand_inputs,
    run_cells,
)

from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.enhance import enhance as j_enhance  # noqa: E402
from deepfilternet_tpu.enhance import init_df as j_init_df  # noqa: E402
from deepfilternet_tpu.models import dfnet3 as j_dfnet3  # noqa: E402
from deepfilternet_tpu.streaming import StreamingRuntime as JRuntime  # noqa: E402
from deepfilternet_tpu.streaming_pallas import PallasStreamingRuntime  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.enhance import enhance, init_df  # noqa: E402
from deepfilternet_torch.models import dfnet3 as t_dfnet3  # noqa: E402
from deepfilternet_torch.streaming import StreamingRuntime  # noqa: E402

SELF = 1e-5
DFN2 = {("MODEL", "train"): "deepfilternet2", ("GRU_TYPE", "deepfilternet"): "squeeze",
        ("DF_OUTPUT_LAYER", "deepfilternet"): "groupedlinear",
        ("DFOP_METHOD", "deepfilternet"): "complex_strided",
        ("DF_N_ITER", "deepfilternet"): "1"}
LOW_LATENCY = {("FFT_SIZE", "DF"): "480", ("HOP_SIZE", "DF"): "240", ("NB_DF", "DF"): "48"}
ERB_COUNTS = {("NB_ERB", "DF"): "24", ("NB_DF", "DF"): "64"}


@pytest.fixture(scope="module", autouse=True)
def _fresh_configs():
    """Both packages' configs reset around the module; torch on one CPU
    thread (the per-frame ops are tiny, and the suite runs several workers
    at once)."""
    j_config.reset()
    t_config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    j_config.reset()
    t_config.reset()


def _audio(rows, n, seed):
    """Seeded [rows, n]: a harmonic tone plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    tone = 0.1 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * np.sin(2 * np.pi * 660.0 * t)
    return (tone[None] + rng.standard_normal((rows, n)) * 0.05).astype(np.float32)


def _models(keys, **init_kw):
    """(JAX model, JAX df_state, port model on the CPU, port df_state) of a
    random-init model under `keys` (narrow widths): JAX's numbers carried
    into the port, whose config must equal JAX's."""
    with both_configs({**SMALL, **keys}):
        jm, jd, _ = j_init_df(**init_kw)
        tm, td, _ = init_df(device="cpu", **init_kw)
    assert_same_cfg(tm.cfg, jm.cfg)
    assert (td.fft_size, td.hop_size, td.nb_erb) == (jd.fft_size, jd.hop_size, jd.nb_erb)
    tm.params, tm.state = carry_params(jm.params, jm.state)
    return jm, jd, tm, td


def _offline_matches(models, x, **kw):
    jm, jd, tm, td = models
    ref = j_enhance(jm, jd, x, **kw)
    got = enhance(tm, td, x, **kw)
    assert got.shape == x.shape and np.isfinite(got).all()
    close(got, ref, E2E, "offline")
    return got


def _process_matches(models, x):
    """The port's StreamingRuntime.process against JAX's with its K1
    counterpart (`use_pallas=True`); returns the port's output."""
    jm, jd, tm, td = models
    jrt, rt = JRuntime(jm, jd, use_pallas=True), StreamingRuntime(tm, td)
    _, ref = jrt.process(jrt.init(x.shape[0]), jnp.asarray(x))
    _, got = rt.process(rt.init(x.shape[0]), x)
    assert got.shape == x.shape and torch.isfinite(got).all()
    close(got, ref, E2E, "StreamingRuntime.process")
    return got.numpy()


# -- the model families and the post-filter ------------------------------------


def test_dfn2_offline():
    """DFN2 with test_configs' keys (squeeze GRUs, grouped DF output layer,
    strided complex DF), offline on [2, 1 s]."""
    models = _models(DFN2, model_name="deepfilternet2")
    assert models[2].module.__name__.endswith("dfnet2")
    _offline_matches(models, _audio(2, 48000, 1))


def test_dfn3_postfilter_delay_comp():
    """DFN3 with the post-filter and the delay compensation (pad=True)."""
    models = _models({}, post_filter=True, model_name="deepfilternet3")
    assert models[0].cfg["mask_pf"] is True and models[2].cfg["mask_pf"] is True
    _offline_matches(models, _audio(2, 24000, 2), pad=True)


def test_dfn1_erb_only():
    models = _models({}, model_name="deepfilternet")
    assert models[2].module.__name__.endswith("dfnet1")
    _offline_matches(models, _audio(2, 24000, 3))


# -- the DF order sweep ----------------------------------------------------------


@pytest.mark.parametrize("df_order", [1, 2, 3, 4, 5])
def test_df_order_sweep(df_order):
    """The multi-frame filter at orders 1-5: the coefficients' order, the
    offline forward against JAX's, the streaming cell against JAX's cell and
    against the port's own offline forward (2e-4, as JAX's test holds it)."""
    model = build(j_dfnet3.init_dfnet3, t_dfnet3.init_dfnet3,
                  {**SMALL, ("DF_ORDER", "DF"): str(df_order)})
    jp, js, jcfg, tp, ts, tcfg = model
    assert tcfg["df_order"] == df_order
    inputs = rand_inputs(0, 1, 6, tcfg)
    spec_e, _, _, coefs = check_forward(j_dfnet3, t_dfnet3, model, inputs,
                                        names=("spec_e", "mask", "lsnr", "coefs"))
    assert coefs.shape[1] == df_order
    _, jo = run_cells(j_dfnet3, jp, js, jcfg, inputs, j_dfnet3.streaming_init(1, jcfg),
                      jnp.asarray)
    _, to = run_cells(t_dfnet3, tp, ts, tcfg, inputs, t_dfnet3.streaming_init(1, tcfg),
                      torch.from_numpy)
    close(to[0], jo[0], E2E, "cell spec_e")
    close(to[0], spec_e, STREAM_VS_OFFLINE, "cell vs offline")


# -- the low-latency configuration (DFN3-ll: FFT 480, hop 240) ------------------


@pytest.fixture(scope="module")
def low_latency():
    return _models(LOW_LATENCY)


@pytest.fixture(scope="module")
def ll_audio():
    return _audio(2, 24000, 4)


@pytest.fixture(scope="module")
def ll_offline(low_latency, ll_audio):
    jm, jd, tm, td = low_latency
    assert (td.fft_size, td.hop_size, td.delay) == (480, 240, 240) and jd.delay == 240
    assert tm.cfg["nb_df"] == 48 and tm.cfg["freq_bins"] == 241
    return _offline_matches(low_latency, ll_audio)


def test_low_latency_offline(ll_offline, ll_audio):
    assert ll_offline.shape == ll_audio.shape


def test_low_latency_process(low_latency, ll_audio):
    """StreamingRuntime.process over 100 hops of 240 samples."""
    _process_matches(low_latency, ll_audio)


def test_low_latency_process_frame(low_latency, ll_audio):
    """process_frame over 20 frames: equal to one process call over the
    same 20 hops (1e-5), and to JAX's runtime (1e-4)."""
    jm, jd, tm, td = low_latency
    x = ll_audio[:, : 20 * 240]
    rt = StreamingRuntime(tm, td)
    c, outs = rt.init(2), []
    for i in range(20):
        c, o = rt.process_frame(c, x[:, i * 240: (i + 1) * 240])
        assert o.shape == (2, 240)
        outs.append(o.numpy())
    got = np.concatenate(outs, 1)
    close(got, rt.process(rt.init(2), x)[1], SELF, "process_frame vs process")
    jrt = JRuntime(jm, jd, use_pallas=True)
    close(got, jrt.process(jrt.init(2), jnp.asarray(x))[1], E2E, "process_frame vs JAX")


def test_low_latency_scan(low_latency, ll_audio, ll_offline):
    """enhance(backend="scan"): the per-frame runtime behind enhance(),
    against the offline output (frame-exact in both packages)."""
    jm, jd, tm, td = low_latency
    got = enhance(tm, td, ll_audio, backend="scan")
    assert got.shape == ll_audio.shape
    close(got, ll_offline, E2E, "scan vs offline")


def test_low_latency_whole_cell_raises(low_latency):
    """JAX's whole cell takes only DFN3's default geometry (FFT 960, hop 480,
    96 DF bins). The port's runs DFN3-ll, at the default widths the kernel
    is built for, and matches its per-frame runtime there
    (`tests/test_torch_whole_cell_geometry.py`)."""
    jm, jd, tm, td = low_latency
    with pytest.raises(AssertionError):
        PallasStreamingRuntime(jm, jd)


# -- non-default ERB and DF bin counts --------------------------------------------


@pytest.fixture(scope="module")
def erb_counts():
    return _models(ERB_COUNTS)


def test_nondefault_erb_counts_offline(erb_counts):
    assert erb_counts[2].cfg["nb_erb"] == 24 and erb_counts[2].cfg["nb_df"] == 64
    _offline_matches(erb_counts, _audio(2, 24000, 5))


def test_nondefault_erb_counts_per_frame(erb_counts):
    _process_matches(erb_counts, _audio(2, 480 * 20, 6))
