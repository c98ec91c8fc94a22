"""DFN3 layers of the PyTorch port, one by one, against the JAX layers with
the demo checkpoint's own parameters for each layer (1e-5)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepfilternet_tpu import nn as jnn  # noqa: E402
from deepfilternet_tpu.enhance import init_df as j_init_df  # noqa: E402
from deepfilternet_tpu.models import dfnet3 as j_dfnet3  # noqa: E402
from deepfilternet_torch import nn as tnn  # noqa: E402
from deepfilternet_torch.checkpoint import params_from_numpy  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.models import dfnet3 as t_dfnet3  # noqa: E402

MODEL_DIR = "pretrained/dfn3_fixture_demo"
CONVS = ["erb_conv0", "erb_conv1", "erb_conv2", "erb_conv3", "df_conv0", "df_conv1",
         "conv3p", "convt3", "conv2p", "conv1p", "conv0p", "conv0_out", "df_convp"]
CONVTS = ["convt2", "convt1"]
GRUS = ["enc_emb_gru", "dec_emb_gru", "df_gru"]
ATOL = 1e-5


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
def demo():
    """(JAX params, JAX state, cfg, port params, port state) of the demo
    checkpoint."""
    model, _, _ = j_init_df(MODEL_DIR)
    p_np = jax.tree.map(np.asarray, model.params)
    s_np = jax.tree.map(np.asarray, model.state)
    tp, ts = params_from_numpy(p_np, s_np, "cpu")
    return model.params, model.state, model.cfg, tp, ts


def _close(t_out, j_out):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=ATOL)


def _conv_input(rng, prm, cfg, f):
    w = prm["w"]
    c_in = w.shape[0] if cfg.get("transposed") else w.shape[1] * cfg["groups"]
    return rng.standard_normal((3, c_in, cfg["kernel"][0], f)).astype(np.float32)


@pytest.mark.parametrize("name", CONVS)
def test_conv2d_norm_act_step(demo, name):
    jp, js, cfg, tp, ts = demo
    lc = cfg["layers"][name]
    x = _conv_input(np.random.default_rng(31), jp[name], lc, 24)
    j_out = jnn.conv2d_norm_act_step(jp[name], js.get(name, {}), lc, jnp.asarray(x))
    t_out = tnn.conv2d_norm_act_step(tp[name], ts.get(name, {}), lc, torch.from_numpy(x))
    _close(t_out, j_out)


@pytest.mark.parametrize("name", CONVTS)
def test_conv_transpose2d_norm_act_step(demo, name):
    jp, js, cfg, tp, ts = demo
    lc = cfg["layers"][name]
    assert lc["transposed"]
    x = _conv_input(np.random.default_rng(32), jp[name], lc, 8)
    j_out = jnn.conv_transpose2d_norm_act_step(jp[name], js[name], lc, jnp.asarray(x))
    t_out = tnn.conv_transpose2d_norm_act_step(tp[name], ts[name], lc, torch.from_numpy(x))
    assert t_out.shape == (3, 16, 16)
    _close(t_out, j_out)


@pytest.mark.parametrize("ci,co,kernel,fstride,dilation", [
    (16, 16, (1, 3), 1, 1), (16, 16, (2, 3), 2, 1), (8, 16, (1, 5), 2, 2),
    (4, 4, (1, 3), 3, 1),
])
def test_conv_transpose2d_other_shapes(ci, co, kernel, fstride, dilation):
    """The transposed conv's padding conventions beyond the DFN3 layers,
    with random weights and non-trivial batchnorm statistics."""
    rng = np.random.default_rng(33)
    prm, st, lc = jnn.init_conv_transpose2d_norm_act(
        jax.random.PRNGKey(0), ci, co, kernel, fstride=fstride, dilation=dilation,
        bias=True, separable=True)
    st["bn"]["mean"] = jnp.asarray(rng.standard_normal(co).astype(np.float32) * 0.1)
    st["bn"]["var"] = jnp.asarray(1.0 + rng.random(co).astype(np.float32))
    tp, ts = params_from_numpy(jax.tree.map(np.asarray, prm),
                               jax.tree.map(np.asarray, st), "cpu")
    x = _conv_input(rng, prm, lc, 7)
    j_out = jnn.conv_transpose2d_norm_act_step(prm, st, lc, jnp.asarray(x))
    t_out = tnn.conv_transpose2d_norm_act_step(tp, ts, lc, torch.from_numpy(x))
    assert t_out.shape == tuple(j_out.shape)
    _close(t_out, j_out)


def test_batchnorm_eval(demo):
    """Inputs drawn from the layer's own running statistics, so the outputs
    are of order one (unit-normal inputs reach ~170 through its small
    variances, where 1e-5 is below one float32 ulp)."""
    jp, js, _, tp, ts = demo
    mean, var = (np.asarray(js["convt2"]["bn"][k])[None, :, None, None] for k in ("mean", "var"))
    z = np.random.default_rng(34).standard_normal((2, 16, 1, 12))
    x = (mean + np.sqrt(var) * z).astype(np.float32)
    j_out, _ = jnn.batchnorm_apply(jp["convt2"]["bn"], js["convt2"]["bn"], jnp.asarray(x),
                                   train=False)
    t_out, _ = tnn.batchnorm_apply(tp["convt2"]["bn"], ts["convt2"]["bn"], torch.from_numpy(x))
    _close(t_out, j_out)


@pytest.mark.parametrize("name", ["lsnr_fc", "df_fc_a"])
def test_linear(demo, name):
    jp, _, _, tp, _ = demo
    x = np.random.default_rng(35).standard_normal((4, jp[name]["w"].shape[1])).astype(np.float32)
    _close(tnn.linear_apply(tp[name], torch.from_numpy(x)),
           jnn.linear_apply(jp[name], jnp.asarray(x)))


@pytest.mark.parametrize("path", [
    ("df_fc_emb",), ("df_out",), ("enc_emb_gru", "linear_in"),
    ("enc_emb_gru", "linear_out"), ("dec_emb_gru", "linear_out"), ("df_gru", "linear_in"),
])
def test_grouped_linear(demo, path):
    jp, _, _, tp, _ = demo
    for k in path:
        jp, tp = jp[k], tp[k]
    g, ws, _ = jp["w"].shape
    x = np.random.default_rng(36).standard_normal((4, g * ws)).astype(np.float32)
    _close(tnn.grouped_linear_apply(tp, torch.from_numpy(x)),
           jnn.grouped_linear_apply(jp, jnp.asarray(x)))


@pytest.mark.parametrize("name", GRUS)
def test_gru_step(demo, name):
    jp, _, _, tp, _ = demo
    jg, tg = jp[name]["gru"], tp[name]["gru"]
    n_layers, hidden = len(jg["layers"]), jg["layers"][0]["w_hh"].shape[1]
    rng = np.random.default_rng(37)
    h = (rng.standard_normal((n_layers, 3, hidden)) * 0.5).astype(np.float32)
    x = rng.standard_normal((3, jg["layers"][0]["w_ih"].shape[1])).astype(np.float32)
    jh, jo = jnn.gru_step(jg, jnp.asarray(h), jnp.asarray(x))
    th, to = tnn.gru_step(tg, torch.from_numpy(h), torch.from_numpy(x))
    _close(th, jh)
    _close(to, jo)


@pytest.mark.parametrize("name", GRUS)
def test_squeezed_gru_s_step(demo, name):
    jp, _, cfg, tp, _ = demo
    lc = cfg["layers"][name]
    rng = np.random.default_rng(38)
    h = (rng.standard_normal((lc["num_layers"], 3, lc["hidden_size"])) * 0.5).astype(np.float32)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    jh, jo = jnn.squeezed_gru_s_step(jp[name], lc, jnp.asarray(h), jnp.asarray(x))
    th, to = tnn.squeezed_gru_s_step(tp[name], lc, torch.from_numpy(h), torch.from_numpy(x))
    _close(th, jh)
    _close(to, jo)


@pytest.mark.parametrize("skip", ["identity", "groupedlinear"])
def test_squeezed_gru_s_step_with_skip(skip):
    rng = np.random.default_rng(39)
    prm, lc = jnn.init_squeezed_gru_s(jax.random.PRNGKey(1), 32, 24, output_size=32,
                                      num_layers=2, linear_groups=4, skip=skip)
    tp, _ = params_from_numpy(jax.tree.map(np.asarray, prm), {}, "cpu")
    h = rng.standard_normal((2, 3, 24)).astype(np.float32)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    jh, jo = jnn.squeezed_gru_s_step(prm, lc, jnp.asarray(h), jnp.asarray(x))
    th, to = tnn.squeezed_gru_s_step(tp, lc, torch.from_numpy(h), torch.from_numpy(x))
    _close(th, jh)
    _close(to, jo)


def test_activations():
    x = np.linspace(-4, 4, 33, dtype=np.float32)
    for name, fn in jnn.ACT.items():
        _close(tnn.ACT[name](torch.from_numpy(x)), fn(jnp.asarray(x)))


def test_init_dfnet3_layout_and_cfg_match():
    """Random init (torch generator): the same tree, shapes and static cfg
    as the JAX package's init."""
    t_config.reset()
    tp, ts, tcfg = t_dfnet3.init_dfnet3(torch.Generator().manual_seed(0))
    jp, js, jcfg = j_dfnet3.init_dfnet3(jax.random.PRNGKey(0))
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(tp) == shapes(jax.tree.map(np.asarray, jp))
    assert shapes(ts) == shapes(jax.tree.map(np.asarray, js))
    assert set(tcfg) == set(jcfg)
    for k in jcfg:
        if k == "erb_inv_fb":
            np.testing.assert_array_equal(tcfg[k], jcfg[k])
        else:
            assert tcfg[k] == jcfg[k], k
