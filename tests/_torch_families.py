"""Helpers shared by the port's DFN1/DFN2 tests (`tests/test_torch_dfnet1.py`,
`test_torch_dfnet2.py`): a model family built by both packages from one
config and the JAX parameters carried into the port, and the comparisons of
`forward`, `streaming_cell` and `forward_chunk` on the same seeded inputs.

Tolerances, float32 on both sides: 1e-4 for a model's outputs against JAX's
(end to end), 2e-4 for the port's streaming cell against its own offline
forward (`tests/test_dfnet1.py:49`), 2e-5 for its chunked form against its
cell (`tests/test_dfnet1.py:86`).
"""

import contextlib
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 480
E2E, STREAM_VS_OFFLINE, CHUNK_VS_CELL = 1e-4, 2e-4, 2e-5
# narrow widths for the random-init grids
SMALL = {("CONV_CH", "deepfilternet"): "8", ("EMB_HIDDEN_DIM", "deepfilternet"): "64",
         ("DF_HIDDEN_DIM", "deepfilternet"): "64"}


@contextlib.contextmanager
def both_configs(keys):
    """`keys` {(key, section): value} set in both packages' configs, both
    reset before and after."""
    from deepfilternet_tpu.config import config as j_config
    from deepfilternet_torch.config import config as t_config

    j_config.reset()
    t_config.reset()
    try:
        for (key, section), value in keys.items():
            j_config.set(key, value, section=section)
            t_config.set(key, value, section=section)
        yield
    finally:
        j_config.reset()
        t_config.reset()


def carry_params(jp, js, device="cpu"):
    import jax

    from deepfilternet_torch.checkpoint import params_from_numpy

    return params_from_numpy(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js), device)


def assert_same_cfg(tcfg, jcfg):
    """Equal configs, the inverse filterbank compared as an array."""
    np.testing.assert_array_equal(tcfg["erb_inv_fb"], jcfg["erb_inv_fb"])
    strip = lambda c: {k: v for k, v in c.items() if k != "erb_inv_fb"}  # noqa: E731
    assert strip(tcfg) == strip(jcfg)


def build(j_init, t_init, keys, patch_jax_cfg=None):
    """(JAX params, JAX state, JAX cfg, port params, port state, port cfg) of
    one family under `keys`: JAX initialises, the port carries its numbers
    and builds its own cfg, which must equal JAX's (after `patch_jax_cfg`,
    where JAX's differs on purpose)."""
    import jax
    import torch

    with both_configs(keys):
        jp, js, jcfg = j_init(jax.random.PRNGKey(0))
        _, _, tcfg = t_init(torch.Generator().manual_seed(0))
    if patch_jax_cfg is not None:
        jcfg = patch_jax_cfg(jcfg)
    assert_same_cfg(tcfg, jcfg)
    tp, ts = carry_params(jp, js)
    return jp, js, jcfg, tp, ts, tcfg


def rand_inputs(seed, b, t, cfg):
    """(spec [B, T, F, 2], feat_erb [B, T, E], feat_spec [B, T, F', 2])."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, cfg["freq_bins"], 2)).astype(np.float32),
            rng.standard_normal((b, t, cfg["nb_erb"])).astype(np.float32),
            rng.standard_normal((b, t, cfg["nb_df"], 2)).astype(np.float32))


def _np(x):
    import torch

    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, ref, atol, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=what)


def check_forward(j_mod, t_mod, model, inputs, names=("spec_e", "mask", "lsnr", "alpha")):
    """The offline forward of both packages, every output at 1e-4."""
    import jax.numpy as jnp
    import torch

    jp, js, jcfg, tp, ts, tcfg = model
    ref, _ = j_mod.forward(jp, js, jcfg, *map(jnp.asarray, inputs))
    got, _ = t_mod.forward(tp, ts, tcfg, *map(torch.from_numpy, inputs))
    for name, g, r in zip(names, got, ref):
        close(g, r, E2E, name)
    return got


def run_cells(mod, params, state, cfg, inputs, carry, wrap):
    """The streaming cell frame by frame from `carry`; returns (carry',
    [spec_e, lsnr, mask] stacked over the frames)."""
    outs = []
    for i in range(inputs[1].shape[1]):
        carry, o = mod.streaming_cell(params, state, cfg, carry,
                                      *(wrap(x[:, i]) for x in inputs))
        outs.append([_np(v) for v in o])
    return carry, [np.stack(v, 1) for v in zip(*outs)]


def check_cell_and_chunk(j_mod, t_mod, model, inputs):
    """streaming_cell over every frame and forward_chunk in two chunks
    (4 | rest), each against JAX's at 1e-4 (outputs and the final carry,
    leaf by leaf); the port's chunks against its cell at 2e-5 and its cell
    against its offline forward at 2e-4."""
    import jax.numpy as jnp
    import torch

    jp, js, jcfg, tp, ts, tcfg = model
    b = inputs[1].shape[0]
    jc, jo = run_cells(j_mod, jp, js, jcfg, inputs, j_mod.streaming_init(b, jcfg), jnp.asarray)
    tc, to = run_cells(t_mod, tp, ts, tcfg, inputs, t_mod.streaming_init(b, tcfg),
                       torch.from_numpy)
    for name, g, r in zip(("spec_e", "lsnr", "mask"), to, jo):
        close(g, r, E2E, f"cell {name}")
    assert tc._fields == jc._fields
    for name, g, r in zip(tc._fields, tc, jc):
        close(g, r, E2E, f"cell carry {name}")

    def chunks(mod, params, state, cfg, wrap):
        carry, outs = mod.streaming_init(b, cfg), []
        for lo, hi in ((0, 4), (4, inputs[1].shape[1])):
            carry, o = mod.forward_chunk(params, state, cfg, carry,
                                         *(wrap(x[:, lo:hi]) for x in inputs))
            outs.append([_np(v) for v in o])
        return carry, [np.concatenate(v, 1) for v in zip(*outs)]

    jcc, jco = chunks(j_mod, jp, js, jcfg, jnp.asarray)
    tcc, tco = chunks(t_mod, tp, ts, tcfg, torch.from_numpy)
    for name, g, r, own in zip(("spec_e", "lsnr", "mask"), tco, jco, to):
        close(g, r, E2E, f"chunk {name}")
        close(g, own, CHUNK_VS_CELL, f"chunk vs cell {name}")
    for name, g, r in zip(tcc._fields, tcc, jcc):
        close(g, r, E2E, f"chunk carry {name}")
    (off, _, _, _), _ = t_mod.forward(tp, ts, tcfg, *map(torch.from_numpy, inputs))
    close(to[0], off, STREAM_VS_OFFLINE, "cell vs offline")


def audio(rows, frames, seed):
    """Seeded harmonic tone plus noise, [rows, frames*hop]."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames * HOP) / 48000.0
    tone = 0.1 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * np.sin(2 * np.pi * 660.0 * t)
    return (tone[None] + rng.standard_normal((rows, frames * HOP)) * 0.05).astype(np.float32)


def load_fixture(model_dir, **kw):
    """(JAX model, JAX df_state, port model on the CPU, port df_state) of a
    bundled checkpoint, each package's config reset after its load."""
    from deepfilternet_tpu.config import config as j_config
    from deepfilternet_tpu.enhance import init_df as j_init_df
    from deepfilternet_torch.config import config as t_config
    from deepfilternet_torch.enhance import init_df

    try:
        jm, jd, _ = j_init_df(model_dir, **kw)
        tm, td, _ = init_df(model_dir, device="cpu", **kw)
    finally:
        j_config.reset()
        t_config.reset()
    return jm, jd, tm, td


def check_fixture_entry_points(fixture, x):
    """enhance() offline and scan, StreamingRuntime (against JAX's with
    `use_pallas=True`, K1's counterpart) and ChunkedStreamingRuntime, each
    against the same JAX entry point on the same audio at 1e-4; the port's
    per-frame runtime against its offline path at 1e-4."""
    import jax.numpy as jnp

    from deepfilternet_tpu.enhance import enhance as j_enhance
    from deepfilternet_tpu.streaming import ChunkedStreamingRuntime as JChunked
    from deepfilternet_tpu.streaming import StreamingRuntime as JRuntime
    from deepfilternet_torch.enhance import enhance
    from deepfilternet_torch.streaming import ChunkedStreamingRuntime, StreamingRuntime

    jm, jd, tm, td = fixture
    for backend in ("offline", "scan"):
        got = enhance(tm, td, x, backend=backend)
        assert got.shape == x.shape and np.isfinite(got).all()
        close(got, j_enhance(jm, jd, x, backend=backend), E2E, f"enhance {backend}")
    s = x.shape[0]
    for j_cls, t_cls, kw in ((JRuntime, StreamingRuntime, dict(use_pallas=True)),
                             (JChunked, ChunkedStreamingRuntime, dict(chunk_frames=7))):
        jrt = j_cls(jm, jd, **kw)
        trt = t_cls(tm, td, **({} if t_cls is StreamingRuntime else kw))
        _, ref = jrt.process(jrt.init(s), jnp.asarray(x))
        _, got = trt.process(trt.init(s), x)
        close(got, ref, E2E, t_cls.__name__)
        if t_cls is StreamingRuntime:
            per_frame = got
    close(per_frame, enhance(tm, td, x, pad=False), E2E, "per-frame vs offline")
