"""The grouped and DFN1/DFN2 layers of the port against the JAX package.

Each layer is initialised by the JAX package, its parameters carried into
the port (`params_from_numpy`), and both run on the same seeded inputs,
offline (`*_apply`, with and without `h0`) and one frame (`*_step`), at
1e-5 per op: the convolution block's `groups`, `lookahead`, `fupsample` and
`force_pw`, `GroupedLinear` with and without its shuffle, `GroupedGRU` at 1
and 4 groups (shuffle and `add_outputs` on and off) and `SqueezedGRU` with
and without its identity skip. The port's own initialisers give the JAX
package's configs and shapes.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepfilternet_tpu import nn as jnn  # noqa: E402
from deepfilternet_torch import nn as tnn  # noqa: E402
from deepfilternet_torch.checkpoint import params_from_numpy  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.nn.layers import _conv_groups  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_config():
    """Reset the port's global config; run torch on one CPU thread (the
    suite runs several workers at once)."""
    t_config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _carry(*trees):
    """JAX trees -> the port's tensor trees on the CPU."""
    p, s = params_from_numpy(jax.tree.map(np.asarray, trees[0]),
                             jax.tree.map(np.asarray, trees[1] if len(trees) > 1 else {}), "cpu")
    return p, s


def _close(got, ref, atol=1e-5):
    got, ref = got.detach().numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


def _same_layout(jtree, ttree):
    """Equal nesting and leaf shapes of a JAX and a port tree."""
    assert _shapes(jtree) == jax.tree.map(lambda a: tuple(a.shape), ttree,
                                          is_leaf=lambda a: isinstance(a, torch.Tensor))


# -- the convolution block ------------------------------------------------------

CONVS = {
    # name: (in, out, kernel, init arguments, input frequency bins)
    "gcd_separable": (4, 8, (2, 3), dict(separable=True), 12),
    "explicit_groups": (8, 8, (2, 3), dict(groups=8, separable=True, fstride=2), 12),
    "lookahead_1": (4, 4, (3, 3), dict(lookahead=1, separable=True), 10),
    "lookahead_past_kernel": (2, 4, (1, 3), dict(lookahead=1), 10),
    "fupsample_2": (4, 4, (1, 3), dict(fupsample=2, groups=4, separable=True), 6),
    "force_pw_1x1": (8, 8, (1, 1), dict(groups=8, separable=True, force_pw=True), 7),
    "pw_suppressed_1x1": (8, 8, (1, 1), dict(separable=True), 7),
    "bias_no_norm": (4, 1, (2, 3), dict(norm=False, act="sigmoid"), 9),
}


def test_conv_groups_rule():
    for args in ((1, 16, (3, 3), True), (16, 16, (1, 1), True), (12, 8, (1, 3), True),
                 (16, 10, (1, 1), False)):
        assert _conv_groups(*args) == jnn.layers._conv_groups(*args)


@pytest.mark.parametrize("name", list(CONVS))
def test_conv_block(name):
    c_in, c_out, kernel, kw, f = CONVS[name]
    jp, js, cfg = jnn.init_conv2d_norm_act(jax.random.PRNGKey(len(name)), c_in, c_out, kernel,
                                           **kw)
    tp0, ts0, tcfg = tnn.init_conv2d_norm_act(torch.Generator().manual_seed(0), c_in, c_out,
                                              kernel, **kw)
    assert tcfg == cfg
    _same_layout(jp, tp0)
    if "bn" in js:  # batch-norm statistics away from the identity
        js = {"bn": {"mean": jnp.asarray(_x(1, (c_out,), 0.3)),
                     "var": jnp.asarray(np.abs(_x(2, (c_out,))) + 0.5)}}
    tp, ts = _carry(jp, js)
    x = _x(3, (2, c_in, 6, f))
    j_out, _ = jnn.conv2d_norm_act_apply(jp, js, cfg, jnp.asarray(x), False)
    t_out, _ = tnn.conv2d_norm_act_apply(tp, ts, cfg, torch.from_numpy(x))
    _close(t_out, j_out)
    win = x[:, :, : kernel[0]]
    _close(tnn.conv2d_norm_act_step(tp, ts, cfg, torch.from_numpy(win)),
           jnn.conv2d_norm_act_step(jp, js, cfg, jnp.asarray(win)))


# -- GroupedLinear ----------------------------------------------------------------


@pytest.mark.parametrize("groups,shuffle", [(1, True), (4, False), (4, True)])
def test_grouped_linear_shuffle(groups, shuffle):
    jp, cfg = jnn.init_grouped_linear_shuffle(jax.random.PRNGKey(groups), 32, 48, groups,
                                              shuffle)
    tp0, tcfg = tnn.init_grouped_linear_shuffle(torch.Generator().manual_seed(0), 32, 48,
                                                groups, shuffle)
    assert tcfg == cfg
    _same_layout(jp, tp0)
    tp, _ = _carry(jp)
    x = _x(4, (3, 5, 32))
    _close(tnn.grouped_linear_shuffle_apply(tp, cfg, torch.from_numpy(x)),
           jnn.grouped_linear_shuffle_apply(jp, cfg, jnp.asarray(x)))
    # one frame, as the streaming cells call it
    _close(tnn.grouped_linear_shuffle_apply(tp, cfg, torch.from_numpy(x[:, 0])),
           jnn.grouped_linear_shuffle_apply(jp, cfg, jnp.asarray(x[:, 0])))


# -- GroupedGRU -------------------------------------------------------------------

GGRU = {
    "g1": dict(groups=1, shuffle=True, add_outputs=False),
    "g4_shuffle_add": dict(groups=4, shuffle=True, add_outputs=True),
    "g4_no_shuffle": dict(groups=4, shuffle=False, add_outputs=False),
    "g4_shuffle_no_add": dict(groups=4, shuffle=True, add_outputs=False),
}


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("name", list(GGRU))
def test_grouped_gru(name, with_h0):
    kw = GGRU[name]
    n_layers, g = 2, kw["groups"]
    jp, cfg = jnn.init_grouped_gru(jax.random.PRNGKey(7), 24, 32, num_layers=n_layers, **kw)
    tp0, tcfg = tnn.init_grouped_gru(torch.Generator().manual_seed(0), 24, 32,
                                     num_layers=n_layers, **kw)
    assert tcfg == cfg
    _same_layout(jp, tp0)
    tp, _ = _carry(jp)
    x = _x(5, (3, 9, 24))
    h0 = _x(6, (n_layers * g, 3, 32 // g), 0.5)
    jh0, th0 = (jnp.asarray(h0), torch.from_numpy(h0)) if with_h0 else (None, None)
    j_out, j_h = jnn.grouped_gru_apply(jp, cfg, jnp.asarray(x), jh0)
    t_out, t_h = tnn.grouped_gru_apply(tp, cfg, torch.from_numpy(x), th0)
    _close(t_out, j_out)
    _close(t_h, j_h)
    # frame by frame from the same carry
    jh, th = jnp.asarray(h0), torch.from_numpy(h0)
    for i in range(4):
        jh, j_o = jnn.grouped_gru_step(jp, cfg, jh, jnp.asarray(x[:, i]))
        th, t_o = tnn.grouped_gru_step(tp, cfg, th, torch.from_numpy(x[:, i]))
        _close(t_o, j_o)
        _close(th, jh)


# -- SqueezedGRU --------------------------------------------------------------------

SGRU = {
    "identity_skip_out": dict(output_size=16, skip="identity", linear_act="relu"),
    "no_skip": dict(output_size=None, skip=None, linear_act="identity"),
    "identity_skip_no_out": dict(output_size=None, skip="identity", linear_act="relu"),
}


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("name", list(SGRU))
def test_squeezed_gru(name, with_h0):
    kw = SGRU[name]
    jp, cfg = jnn.init_squeezed_gru(jax.random.PRNGKey(9), 24, 32, num_layers=2,
                                    linear_groups=4, **kw)
    tp0, tcfg = tnn.init_squeezed_gru(torch.Generator().manual_seed(0), 24, 32, num_layers=2,
                                      linear_groups=4, **kw)
    assert tcfg == cfg
    _same_layout(jp, tp0)
    tp, _ = _carry(jp)
    x = _x(10, (3, 9, 24))
    h0 = _x(11, (2, 3, 32), 0.5)
    jh0, th0 = (jnp.asarray(h0), torch.from_numpy(h0)) if with_h0 else (None, None)
    j_out, j_h = jnn.squeezed_gru_apply(jp, cfg, jnp.asarray(x), jh0)
    t_out, t_h = tnn.squeezed_gru_apply(tp, cfg, torch.from_numpy(x), th0)
    _close(t_out, j_out)
    _close(t_h, j_h)
    jh, th = jnp.asarray(h0), torch.from_numpy(h0)
    for i in range(4):
        jh, j_o = jnn.squeezed_gru_step(jp, cfg, jh, jnp.asarray(x[:, i]))
        th, t_o = tnn.squeezed_gru_step(tp, cfg, th, torch.from_numpy(x[:, i]))
        _close(t_o, j_o)
        _close(th, jh)
