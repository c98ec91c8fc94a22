"""The port's offline path against the JAX package, on the CPU.

Same seeded inputs through both packages, float32 on both sides:

  * per op at 1e-5: `frame_signal`, `stft`, `istft`, `istft_ri`, the blocked
    `_ema_scan` and the norms over it, the feature functions, `df_features`,
    `deep_filter_offline` (lookahead 0 and 2), every `*_apply` layer of the
    demo checkpoint (the conv blocks also in training mode, with their new
    batch-norm statistics) and `gru_apply` with and without `h0`;
  * model and pipeline at 1e-4: `forward` on the demo checkpoint (also
    `train=True`, its new batch-norm state at 1e-5) and on
    random-init JAX models carried across (DF lookahead 2, post-filter,
    mask only, a DF pathway kernel of 5 frames), `enhance` with the offline
    and the auto backend, the offline output against the port's own per-frame
    runtime;
  * a `.tar.gz` model archive and the CLI (`--device cpu`) against the JAX
    CLI, within one int16 step.
"""

import dataclasses
import importlib
import os
import tarfile

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepfilternet_tpu import nn as jnn  # noqa: E402
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.enhance import df_features as j_df_features  # noqa: E402
from deepfilternet_tpu.enhance import enhance as j_enhance  # noqa: E402
from deepfilternet_tpu.enhance import init_df as j_init_df  # noqa: E402
from deepfilternet_tpu.enhance import main as j_main  # noqa: E402
from deepfilternet_tpu.ops import df_op as j_df  # noqa: E402
from deepfilternet_tpu.ops import features as j_feat  # noqa: E402
from deepfilternet_tpu.ops import norms as j_norms  # noqa: E402
from deepfilternet_tpu.utils.audio_io import load_audio as j_load_audio  # noqa: E402
from deepfilternet_torch import nn as tnn  # noqa: E402
from deepfilternet_torch.checkpoint import params_from_numpy  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.enhance import df_features, enhance, init_df, main  # noqa: E402
from deepfilternet_torch.ops import df_op as t_df  # noqa: E402
from deepfilternet_torch.ops import features as t_feat  # noqa: E402
from deepfilternet_torch.ops import norms as t_norms  # noqa: E402
from deepfilternet_torch.ops import stft as t_stft  # noqa: E402
from deepfilternet_torch.streaming import StreamingRuntime  # noqa: E402
from deepfilternet_torch.utils import load_audio, resample, save_audio  # noqa: E402

# the JAX package's ops/__init__ re-exports a function named `stft`
j_stft = importlib.import_module("deepfilternet_tpu.ops.stft")

MODEL_DIR = "pretrained/dfn3_fixture_demo"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 480
STFT = t_stft.Stft(sr=48000, fft_size=960, hop_size=HOP)
J_STFT = j_stft.Stft(sr=48000, fft_size=960, hop_size=HOP)
ALPHA = 0.99
CONVS = ["erb_conv0", "erb_conv1", "erb_conv2", "erb_conv3", "df_conv0", "df_conv1",
         "conv3p", "convt3", "conv2p", "conv1p", "conv0p", "conv0_out", "df_convp"]
CONVTS = ["convt2", "convt1"]
# each layer's input frequency width in the DFN3 graph
CONV_F = {"erb_conv0": 32, "erb_conv1": 32, "erb_conv2": 16, "erb_conv3": 8, "df_conv0": 96,
          "df_conv1": 96, "conv3p": 8, "convt3": 8, "conv2p": 8, "convt2": 8, "conv1p": 16,
          "convt1": 16, "conv0p": 32, "conv0_out": 32, "df_convp": 96}
GRUS = ["enc_emb_gru", "dec_emb_gru", "df_gru"]
# random-init models: (config keys set in both packages, init_df arguments)
VARIANTS = {
    "df_lookahead_2": ({("DF_LOOKAHEAD", "DF"): "2"}, {}),
    "mask_pf": ({}, {"post_filter": True}),
    "mask_only": ({}, {"mask_only": True}),
    "df_pathway_kt_5": ({("DF_PATHWAY_KERNEL_SIZE_T", "deepfilternet"): "5"}, {}),
}


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


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, atol=1e-5):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _audio(rows, frames, seed):
    """Seeded harmonic tone plus noise, [rows, frames*hop]."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames * HOP) / 48000.0
    tone = 0.1 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * np.sin(2 * np.pi * 660.0 * t)
    return (tone[None] + rng.standard_normal((rows, frames * HOP)) * 0.05).astype(np.float32)


def _cplx(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale).astype(
        np.complex64)


# -- STFT ---------------------------------------------------------------------


@pytest.mark.parametrize("t", [HOP * 7, HOP * 7 + 123, 300])
def test_frame_signal(t):
    x = np.random.default_rng(1).standard_normal((2, t)).astype(np.float32)
    _close(t_stft.frame_signal(torch.from_numpy(x), 960, HOP),
           j_stft.frame_signal(jnp.asarray(x), 960, HOP), atol=0)


@pytest.mark.parametrize("t", [HOP * 12, HOP * 12 + 77])
def test_stft(t):
    x = (np.random.default_rng(2).standard_normal((2, t)) * 0.3).astype(np.float32)
    got = t_stft.stft(torch.from_numpy(x), STFT)
    assert got.dtype == torch.complex64
    _close(got, j_stft.stft(jnp.asarray(x), J_STFT))


@pytest.mark.parametrize("form", ["istft", "istft_ri"])
def test_istft(form):
    spec = _cplx(np.random.default_rng(3), (2, 9, 481), 0.01)
    if form == "istft":
        got = t_stft.istft(torch.from_numpy(spec), STFT)
        ref = j_stft.istft(jnp.asarray(spec), J_STFT)
    else:
        ri = np.stack([spec.real, spec.imag], -1)
        got = t_stft.istft_ri(torch.from_numpy(ri), STFT)
        ref = j_stft.istft_ri(jnp.asarray(ri), J_STFT)
    _close(got, ref)


def test_stft_istft_ri_reconstructs_delayed_input():
    x = (np.random.default_rng(4).standard_normal((1, HOP * 10)) * 0.3).astype(np.float32)
    spec = t_stft.stft(torch.from_numpy(x), STFT)
    y = t_stft.istft_ri(torch.stack([spec.real, spec.imag], -1), STFT).numpy()
    d = 960 - HOP
    np.testing.assert_allclose(y[:, d:], x[:, :-d], rtol=0, atol=1e-5)


# -- norms and features -------------------------------------------------------


@pytest.mark.parametrize("t", [1, 7, 1000])
def test_ema_scan(t):
    """dB-scale input scaled by 1/40 as erb_norm's output is; T = 1000 ends in
    a ragged block and runs two levels of blocks."""
    rng = np.random.default_rng(5)
    x = ((rng.standard_normal((3, t, 32)) * 10 - 70) / 40).astype(np.float32)
    s0 = ((rng.standard_normal((3, 32)) * 5 - 70) / 40).astype(np.float32)
    _close(t_norms._ema_scan(torch.from_numpy(x), torch.from_numpy(s0), ALPHA, axis=1),
           j_norms._ema_scan(jnp.asarray(x), jnp.asarray(s0), ALPHA, axis=1))


@pytest.mark.parametrize("with_state", [False, True])
def test_erb_and_unit_norm(with_state):
    rng = np.random.default_rng(6)
    erb = (rng.standard_normal((2, 150, 32)) * 10 - 70).astype(np.float32)
    spec = _cplx(rng, (2, 150, 96), 0.01)
    es = us = None
    if with_state:
        es = (rng.standard_normal((2, 32)) * 5 - 70).astype(np.float32)
        us = rng.uniform(1e-4, 1e-3, (2, 96)).astype(np.float32)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    _close(t_norms.erb_norm(torch.from_numpy(erb), ALPHA, t(es)),
           j_norms.erb_norm(jnp.asarray(erb), ALPHA, j(es)))
    _close(t_norms.unit_norm(torch.from_numpy(spec), ALPHA, t(us)),
           j_norms.unit_norm(jnp.asarray(spec), ALPHA, j(us)))


def test_features(models):
    widths = models[3].erb_widths
    rng = np.random.default_rng(7)
    spec = _cplx(rng, (2, 40, 481), 0.01)
    ts, js = torch.from_numpy(spec), jnp.asarray(spec)
    _close(t_feat.erb_band_energies(ts, widths, db=False) * 1e4,
           j_feat.erb_band_energies(js, widths, db=False) * 1e4)
    _close(t_feat.erb_feat(ts, widths, ALPHA), j_feat.erb_feat(js, widths, ALPHA))
    _close(t_feat.spec_feat(ts, 96, ALPHA), j_feat.spec_feat(js, 96, ALPHA))
    gains = rng.uniform(0, 1, (2, 40, 32)).astype(np.float32)
    _close(t_feat.apply_interp_band_gain(ts, torch.from_numpy(gains), widths),
           j_feat.apply_interp_band_gain(js, jnp.asarray(gains), widths))


def test_df_features(models):
    _, jd, _, td = models
    x = _audio(2, 30, seed=8)
    got = df_features(x, td, 96, device="cpu")
    ref = j_df_features(x, jd, 96)
    for g, r in zip(got, ref):
        _close(g, r)


# -- deep filter ----------------------------------------------------------------


@pytest.mark.parametrize("lookahead", [0, 2])
def test_deep_filter_offline(lookahead):
    rng = np.random.default_rng(9 + lookahead)
    spec = _cplx(rng, (2, 11, 481), 0.1)
    coefs = _cplx(rng, (2, 5, 11, 96), 0.5)
    _close(t_df.spec_unfold(torch.from_numpy(spec), 5, lookahead),
           j_df.spec_unfold(jnp.asarray(spec), 5, lookahead), atol=0)
    _close(t_df.deep_filter_offline(torch.from_numpy(spec), torch.from_numpy(coefs), 96,
                                    lookahead),
           j_df.deep_filter_offline(jnp.asarray(spec), jnp.asarray(coefs), 96, lookahead))


# -- layers ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def demo(models):
    """(JAX params, JAX state, cfg, port params, port state) of the demo
    checkpoint."""
    jm, _, tm, _ = models
    return jm.params, jm.state, jm.cfg, tm.params, tm.state


@pytest.mark.parametrize("name", CONVS + CONVTS)
def test_conv_apply(demo, name):
    jp, js, cfg, tp, ts = demo
    lc = cfg["layers"][name]
    w = jp[name]["w"]
    c_in = w.shape[0] if lc.get("transposed") else w.shape[1] * lc["groups"]
    x = np.random.default_rng(11).standard_normal((2, c_in, 6, CONV_F[name])).astype(np.float32)
    j_fn, t_fn = ((jnn.conv_transpose2d_norm_act_apply, tnn.conv_transpose2d_norm_act_apply)
                  if lc.get("transposed") else
                  (jnn.conv2d_norm_act_apply, tnn.conv2d_norm_act_apply))
    j_out, _ = j_fn(jp[name], js.get(name, {}), lc, jnp.asarray(x), False)
    t_out, _ = t_fn(tp[name], ts.get(name, {}), lc, torch.from_numpy(x))
    _close(t_out, j_out)


@pytest.mark.parametrize("name", CONVS + CONVTS)
def test_conv_apply_training(demo, name):
    """Training mode: the batch's statistics normalize, and the new running
    statistics equal JAX's; the input state is left as it was."""
    jp, js, cfg, tp, ts = demo
    lc = cfg["layers"][name]
    w = jp[name]["w"]
    c_in = w.shape[0] if lc.get("transposed") else w.shape[1] * lc["groups"]
    x = np.random.default_rng(14).standard_normal((2, c_in, 6, CONV_F[name])).astype(np.float32)
    j_fn, t_fn = ((jnn.conv_transpose2d_norm_act_apply, tnn.conv_transpose2d_norm_act_apply)
                  if lc.get("transposed") else
                  (jnn.conv2d_norm_act_apply, tnn.conv2d_norm_act_apply))
    state = ts.get(name, {})
    before = {k: v.clone() for k, v in state.get("bn", {}).items()}
    j_out, j_st = j_fn(jp[name], js.get(name, {}), lc, jnp.asarray(x), True)
    t_out, t_st = t_fn(tp[name], state, lc, torch.from_numpy(x), train=True)
    _close(t_out, j_out)
    assert set(t_st) == set(j_st)
    for k in before:
        _close(t_st["bn"][k], j_st["bn"][k])
        assert torch.equal(state["bn"][k], before[k])


def test_training_mode_raises(models):
    """DFN3's training forward on the demo checkpoint: every output and the
    new batch-norm state equal JAX's, at 1e-4 and 1e-5."""
    from deepfilternet_tpu.models import dfnet3 as j_dfnet3

    from deepfilternet_torch.models import dfnet3 as t_dfnet3

    jm, jd, tm, _ = models
    inputs = _forward_inputs(jd, frames=20)
    ref, j_state = j_dfnet3.forward(jm.params, jm.state, jm.cfg, *map(jnp.asarray, inputs),
                                    train=True)
    got, t_state = t_dfnet3.forward(tm.params, tm.state, tm.cfg, *map(torch.from_numpy, inputs),
                                    train=True)
    for name, g, r in zip(("spec_e", "mask", "lsnr", "df_coefs"), got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=0, atol=1e-4, err_msg=name)
    assert set(t_state) == set(j_state) == set(tm.state)
    for name, st in j_state.items():
        for k in ("mean", "var"):
            _close(t_state[name]["bn"][k], st["bn"][k])
            assert not torch.equal(t_state[name]["bn"][k], tm.state[name]["bn"][k])


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("name", GRUS)
def test_gru_apply(demo, name, with_h0):
    jp, _, cfg, tp, _ = demo
    jg, tg = jp[name]["gru"], tp[name]["gru"]
    n_layers, hidden = len(jg["layers"]), jg["layers"][0]["w_hh"].shape[1]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 13, jg["layers"][0]["w_ih"].shape[1])).astype(np.float32)
    h0 = (rng.standard_normal((n_layers, 3, hidden)) * 0.5).astype(np.float32)
    jh0, th0 = (jnp.asarray(h0), torch.from_numpy(h0)) if with_h0 else (None, None)
    j_out, j_h = jnn.gru_apply(jg, jnp.asarray(x), jh0)
    t_out, t_h = tnn.gru_apply(tg, torch.from_numpy(x), th0)
    _close(t_out, j_out)
    _close(t_h, j_h)
    # the squeezed block around it
    lc = cfg["layers"][name]
    x = rng.standard_normal((3, 13, 128)).astype(np.float32)
    j_out, j_h = jnn.squeezed_gru_s_apply(jp[name], lc, jnp.asarray(x), jh0)
    t_out, t_h = tnn.squeezed_gru_s_apply(tp[name], lc, torch.from_numpy(x), th0)
    _close(t_out, j_out)
    _close(t_h, j_h)


# -- model forward --------------------------------------------------------------


def _forward_inputs(jd, frames=30, seed=13):
    return [np.array(a) for a in j_df_features(_audio(2, frames, seed), jd, 96)]


def _check_forward(jm, tm, inputs):
    from deepfilternet_tpu.models import dfnet3 as j_dfnet3

    from deepfilternet_torch.models import dfnet3 as t_dfnet3

    ref, _ = j_dfnet3.forward(jm.params, jm.state, jm.cfg, *map(jnp.asarray, inputs))
    got, _ = t_dfnet3.forward(tm.params, tm.state, tm.cfg, *map(torch.from_numpy, inputs))
    for name, g, r in zip(("spec_e", "mask", "lsnr", "df_coefs"), got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=0, atol=1e-4, err_msg=name)


def test_forward_demo(models):
    """Inference: the JAX outputs, and the state handed back unchanged."""
    jm, jd, tm, _ = models
    _check_forward(jm, tm, _forward_inputs(jd))
    _, state = tm.module.forward(tm.params, tm.state, tm.cfg,
                                 *map(torch.from_numpy, _forward_inputs(jd, frames=3)))
    assert set(state) == set(tm.state) and all(state[k] is tm.state[k] for k in state)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_random_init(models, variant):
    """A random-init JAX model, its numbers carried into the port model
    built from the same config."""
    keys, init_kw = VARIANTS[variant]
    j_config.reset()
    t_config.reset()
    try:
        for (key, section), value in keys.items():
            j_config.set(key, value, section=section)
            t_config.set(key, value, section=section)
        jm, jd, _ = j_init_df(**init_kw)
        tm, _, _ = init_df(device="cpu", **init_kw)
        p, s = params_from_numpy(jax.tree.map(np.asarray, jm.params),
                                 jax.tree.map(np.asarray, jm.state), "cpu")
        tm = dataclasses.replace(tm, params=p, state=s, _cache={})
        assert {k: tm.cfg.get(k) for k in ("df_lookahead", "mask_pf", "run_df", "df_pathway_kt")} \
            == {k: jm.cfg.get(k) for k in ("df_lookahead", "mask_pf", "run_df", "df_pathway_kt")}
        _check_forward(jm, tm, _forward_inputs(jd, frames=20))
    finally:
        j_config.reset()
        t_config.reset()


# -- enhance --------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"atten_lim_db": 12.0}, {"pad": False}],
                         ids=["default", "atten_lim", "no_pad"])
@pytest.mark.parametrize("backend", ["offline", "auto"])
def test_enhance_matches_jax(models, backend, kw):
    jm, jd, tm, td = models
    x = _audio(2, 40, seed=14)[:, : 40 * HOP - 111]
    ref = j_enhance(jm, jd, x, backend="offline", **kw)
    got = enhance(tm, td, x, backend=backend, **kw)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_offline_equals_per_frame_runtime(models):
    """As the JAX package holds its own pair: the per-frame runtime
    reproduces the offline enhance with pad=False."""
    _, _, tm, td = models
    x = _audio(1, 50, seed=15)
    off = enhance(tm, td, x, pad=False)
    rt = StreamingRuntime(tm, td)
    _, out = rt.process(rt.init(1), x)
    assert out.shape == off.shape
    np.testing.assert_allclose(out.numpy(), off, rtol=0, atol=1e-4)


def test_df_state_delay(models):
    _, jd, _, td = models
    assert td.delay == jd.delay == 480


# -- model archives and the CLI ------------------------------------------------


def test_model_archive_loads_the_same_params(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    archive = tmp_path / "dfn3.tar.gz"
    with tarfile.open(archive, "w:gz") as tar:
        for name in ("config.ini", "checkpoints"):
            tar.add(os.path.join(REPO, MODEL_DIR, name), arcname=name)
    ref, ref_state, _ = init_df(os.path.join(REPO, MODEL_DIR), device="cpu")
    for _ in range(2):  # unpacked once, then read from the cache
        got, got_state, suffix = init_df(str(archive), device="cpu")
        assert suffix == "e234408" and got_state == ref_state
        g_leaves, g_def = jax.tree.flatten(got.params)
        r_leaves, r_def = jax.tree.flatten(ref.params)
        assert g_def == r_def
        for a, b in zip(g_leaves, r_leaves):
            assert torch.equal(a, b)
    cached = os.listdir(tmp_path / "cache" / "deepfilternet_torch")
    assert len(cached) == 1 and len(cached[0]) == 12


@pytest.mark.parametrize("sr", [48000, 16000])
def test_cli_matches_jax_cli(tmp_path, sr):
    x = resample(_audio(1, 30, seed=16 + sr // 16000), 48000, sr)
    src = str(tmp_path / "noisy.wav")
    save_audio(src, x, sr)
    j_out, t_out = tmp_path / "jax", tmp_path / "torch"
    try:
        j_main([src, "-o", str(j_out)])
    finally:
        j_config.reset()
    main([src, "-o", str(t_out), "--device", "cpu"])
    name = "noisy_DeepFilterNet_TPU.wav"
    ref, ref_sr = j_load_audio(str(j_out / name))
    got, got_sr = load_audio(str(t_out / name))
    assert got_sr == ref_sr == sr and got.shape == ref.shape == x.shape
    assert np.abs(got - ref).max() * 32768 <= 1.0


def test_cli_without_inputs_exits():
    with pytest.raises(SystemExit):
        main(["--device", "cpu"])
