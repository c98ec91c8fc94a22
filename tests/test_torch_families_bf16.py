"""DeepFilterNet2 and DeepFilterNet1 at bfloat16 in the port against the JAX
package, on the CPU.

Same seeded numpy inputs through both packages, small sizes:

  * the layers the two families add, each at bfloat16 against JAX's at
    bfloat16 (`grouped_linear_apply`, `grouped_linear_shuffle_apply`,
    `grouped_gru_*`, `squeezed_gru_s_*`, `squeezed_gru_*`, the mask
    post-filter);
  * `StreamingRuntime(dtype=bfloat16)` of each family, from its bundled
    checkpoint and from a random-init model at narrow widths
    (`_torch_families.SMALL`), against JAX's: the output, the carry leaf by
    leaf (values and types);
  * `ChunkedStreamingRuntime(dtype=bfloat16)` in calls of 5 and 3 frames
    against JAX's chunked runtime, and against the port's own per-frame
    bfloat16 and float32 runs;
  * calls that continue from the carry equal one call, bit for bit.

The bounds are DFN3's (`tests/test_torch_reduced_precision.py`), each a
fraction of the reference's largest value (`_rel`): a value near a rounding
boundary rounds to the neighbouring bfloat16 when a float32 sum runs in
another order, and the saturated GRUs carry that on. The sequence form of a
GRU is one `aten.gru` call, which rounds its gate sums in its own order, so
the chunked runtime is held to its bound and not to bit equality.

    PYTHONPATH=. python tests/test_torch_families_bf16.py

prints the worst error of every comparison here (the figures CHANGES.md
quotes).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_families import REPO, SMALL, build, carry_params, load_fixture  # noqa: E402
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.models import dfnet1 as j_dfnet1  # noqa: E402
from deepfilternet_tpu.models import dfnet2 as j_dfnet2  # noqa: E402
from deepfilternet_tpu.nn import layers as jl  # noqa: E402
from deepfilternet_tpu.ops.postfilter import post_filter_mask as j_post_filter_mask  # noqa: E402
from deepfilternet_tpu.streaming import ChunkedStreamingRuntime as JChunked  # noqa: E402
from deepfilternet_tpu.streaming import RuntimeParams as JRuntimeParams  # noqa: E402
from deepfilternet_tpu.streaming import StreamingRuntime as JRuntime  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.models import dfnet1 as t_dfnet1  # noqa: E402
from deepfilternet_torch.models import dfnet2 as t_dfnet2  # noqa: E402
from deepfilternet_torch.nn import layers as tl  # noqa: E402
from deepfilternet_torch.ops.postfilter import post_filter_mask  # noqa: E402
from deepfilternet_torch.streaming import (  # noqa: E402
    ChunkedStreamingRuntime,
    RuntimeParams,
    StreamingRuntime,
)

HOP = 480
FRAMES = 8
BF16 = torch.bfloat16
D = "deepfilternet"
STAGES = dict(atten_lim_db=12.0, post_filter_beta=0.02, lsnr_gating=True)

# Bounds, each a fraction of the reference's largest value; the worst
# measured by `main` in brackets (CHANGES.md, PR 12).
TOL_OUT = 2e-2        # per-frame runtime output against JAX
TOL_CARRY = 5e-2      # per-frame runtime carry leaves against JAX
TOL_CHUNKED = 1e-2    # chunked runtime output against JAX's chunked runtime
TOL_JAX_OWN = 0.1     # the JAX tests' own bound for chunked against per-frame

FAMILIES = {
    "dfn2": (j_dfnet2, t_dfnet2, f"{REPO}/pretrained/dfn2_fixture_demo",
             {**SMALL, ("DF_N_ITER", D): "1", ("GRU_GROUPS", D): "4",
              ("LINEAR_GROUPS", D): "4"}),
    "dfn1": (j_dfnet1, t_dfnet1, f"{REPO}/pretrained/dfn1_fixture_demo",
             {**SMALL, ("GRU_GROUPS", D): "4", ("LINEAR_GROUPS", D): "4"}),
}
# (streams, audio seed, runtime knobs); seed 3 is one whose features round
# differently in the two packages
STREAM_CASES = ((2, 7, {}), (3, 3, {}), (4, 11, STAGES))


@pytest.fixture(scope="module", autouse=True)
def _fresh_configs():
    """Reset both packages' configs; run torch on one CPU thread (the suite
    runs several workers at once)."""
    j_config.reset()
    t_config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    j_config.reset()
    t_config.reset()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _rel(got, ref) -> float:
    """Largest absolute difference over the reference's largest value."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    if not ref.size:
        return 0.0
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


# -- the layers ------------------------------------------------------------------


def _bf16_params(jp):
    """A JAX parameter tree at bfloat16 and the same numbers in the port."""
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp, _ = carry_params(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp), {})
    return jp, jax.tree.map(lambda t: t.to(BF16), tp)


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _pair(a):
    """A float32 array as (JAX bfloat16, port bfloat16), the same values."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(BF16)


def layer_errors():
    """{layer: error} of each layer at bfloat16 against JAX's."""
    key = jax.random.PRNGKey(3)
    b, t, i, h, g = 3, 6, 32, 32, 4
    errs = {}
    jx, tx = _pair(_x(1, (b, t, i)))
    jx1, tx1 = jx[:, 0], tx[:, 0]

    jp, tp = _bf16_params(jl.init_grouped_linear(key, i, h, g))
    errs["grouped_linear_apply"] = _rel(tl.grouped_linear_apply(tp, tx),
                                        jl.grouped_linear_apply(jp, jx))
    jgp, cfg = jl.init_grouped_linear_shuffle(key, i, h, g)
    jp, tp = _bf16_params(jgp)
    errs["grouped_linear_shuffle_apply"] = _rel(tl.grouped_linear_shuffle_apply(tp, cfg, tx),
                                                jl.grouped_linear_shuffle_apply(jp, cfg, jx))

    jgp, cfg = jl.init_grouped_gru(key, i, h, num_layers=2, groups=g, add_outputs=True)
    jp, tp = _bf16_params(jgp)
    jh0, th0 = _pair(_x(2, (2 * g, b, h // g), 0.5))
    out, hn = tl.grouped_gru_apply(tp, cfg, tx, th0)
    ref, rhn = jl.grouped_gru_apply(jp, cfg, jx, jh0)
    errs["grouped_gru_apply"] = max(_rel(out, ref), _rel(hn, rhn))
    hn, out = tl.grouped_gru_step(tp, cfg, th0, tx1)
    rhn, ref = jl.grouped_gru_step(jp, cfg, jh0, jx1)
    errs["grouped_gru_step"] = max(_rel(out, ref), _rel(hn, rhn))

    jh0, th0 = _pair(_x(4, (2, b, h), 0.5))
    for name, j_init, j_apply, j_step, t_apply, t_step, kw in (
            ("squeezed_gru_s", jl.init_squeezed_gru_s, jl.squeezed_gru_s_apply,
             jl.squeezed_gru_s_step, tl.squeezed_gru_s_apply, tl.squeezed_gru_s_step,
             dict(output_size=i, skip="groupedlinear")),
            ("squeezed_gru", jl.init_squeezed_gru, jl.squeezed_gru_apply, jl.squeezed_gru_step,
             tl.squeezed_gru_apply, tl.squeezed_gru_step,
             dict(output_size=i, skip="identity", linear_act="relu"))):
        jgp, cfg = j_init(key, i, h, num_layers=2, linear_groups=g, **kw)
        jp, tp = _bf16_params(jgp)
        out, hn = t_apply(tp, cfg, tx, th0)
        ref, rhn = j_apply(jp, cfg, jx, jh0)
        errs[f"{name}_apply"] = max(_rel(out, ref), _rel(hn, rhn))
        hn, out = t_step(tp, cfg, th0, tx1)
        rhn, ref = j_step(jp, cfg, jh0, jx1)
        errs[f"{name}_step"] = max(_rel(out, ref), _rel(hn, rhn))

    jm, tm = _pair(np.random.default_rng(5).uniform(0, 1, (b, 32)).astype(np.float32))
    errs["post_filter_mask"] = _rel(post_filter_mask(tm, 0.02), j_post_filter_mask(jm, 0.02))
    return errs


# Elementwise layers, and those whose products are short enough that both
# packages round one float32 sum the same way, equal JAX's bit for bit.
BIT_EQUAL = ("grouped_linear_apply", "grouped_linear_shuffle_apply", "grouped_gru_step",
             "squeezed_gru_s_step", "squeezed_gru_step", "post_filter_mask")


@pytest.fixture(scope="module")
def layer_errs():
    return layer_errors()


@pytest.mark.parametrize("layer", BIT_EQUAL)
def test_layer_bf16_equals_jax(layer_errs, layer):
    assert layer_errs[layer] == 0.0


@pytest.mark.parametrize("layer", ("grouped_gru_apply", "squeezed_gru_s_apply",
                                   "squeezed_gru_apply"))
def test_gru_sequence_bf16_matches_jax(layer_errs, layer):
    """A GRU's sequence form is one `aten.gru` call, which adds the bias
    inside its products and rounds its gate sums in its own order: a
    bfloat16 unit in the last place flips and the recurrence carries it
    (up to 2.4% of a final state's scale over 6 steps), so these are held
    to the carry bound. The same sequence through the port's own cell
    equals JAX's bit for bit (`test_gru_cell_loop_bf16_equals_jax`)."""
    assert layer_errs[layer] <= TOL_CARRY


def test_gru_cell_loop_bf16_equals_jax():
    """`gru_step` frame by frame over a sequence equals JAX's `gru_apply`
    at bfloat16 bit for bit: JAX's sequence form is its cell in a scan."""
    jp, tp = _bf16_params(jl.init_gru(jax.random.PRNGKey(1), 32, 32, 2))
    jx, tx = _pair(_x(1, (3, 6, 32)))
    jh, th = _pair(_x(11, (2, 3, 32), 0.5))
    ref, rhn = jl.gru_apply(jp, jx, jh)
    outs = []
    for t in range(tx.shape[1]):
        th, o = tl.gru_step(tp, th, tx[:, t])
        outs.append(o)
    assert _rel(torch.stack(outs, 1), ref) == 0.0 and _rel(th, rhn) == 0.0


# -- the runtimes ------------------------------------------------------------------


def _random_models(family, fixture):
    """Both packages' runtime models of a random-init model at narrow widths,
    JAX's numbers carried into the port (the fixture's DSP state)."""
    j_mod, t_mod, _, keys = FAMILIES[family]
    jm, jd, tm, td = fixture
    init = f"init_{family.replace('dfn', 'dfnet')}"
    jp, js, jcfg, tp, ts, tcfg = build(getattr(j_mod, init), getattr(t_mod, init), keys)
    return (dataclasses.replace(jm, params=jp, state=js, cfg=jcfg, _jit_cache={}), jd,
            dataclasses.replace(tm, params=tp, state=ts, cfg=tcfg, _cache={}), td)


def load_models():
    """{(family, "demo" | "random"): (JAX model, JAX df_state, port model,
    port df_state)}."""
    out = {}
    for family, (_, _, model_dir, _) in FAMILIES.items():
        out[family, "demo"] = load_fixture(model_dir)
        out[family, "random"] = _random_models(family, out[family, "demo"])
    return out


@pytest.fixture(scope="module")
def all_models():
    return load_models()


def seeded_audio(s, seed, frames=FRAMES):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((s, frames * HOP)) * 0.1).astype(np.float32)


def streaming_errors(models, s, seed, knobs):
    """StreamingRuntime(dtype=bf16) against JAX's: (output error, {leaf:
    error}, [(leaf, port type, JAX type)])."""
    jm, jd, tm, td = models
    x = seeded_audio(s, seed)
    jrt = JRuntime(jm, jd, JRuntimeParams(**knobs), dtype=jnp.bfloat16)
    jc, ref = jrt.process(jrt.init(s), jnp.asarray(x))
    rt = StreamingRuntime(tm, td, RuntimeParams(**knobs), dtype=BF16)
    c, got = rt.process(rt.init(s), x)
    assert got.dtype == torch.float32
    leaves = list(c._asdict().items())[:-1] + list(c.model._asdict().items())
    j_leaves = list(jc)[:-1] + list(jc.model)
    errs = {name: _rel(a, b) for (name, a), b in zip(leaves, j_leaves)}
    types = [(name, _dtype_name(a), str(b.dtype)) for (name, a), b in zip(leaves, j_leaves)]
    return _rel(got, ref), errs, types


# the model carry's types, as JAX's: every leaf bfloat16 but the DF ring
MODEL_LEAF_TYPES = {"dfn2": (6, 2), "dfn1": (8, 2)}


@pytest.mark.parametrize("s, seed, knobs", STREAM_CASES, ids=("2", "3", "4-stages"))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_streaming_bf16_matches_jax(all_models, family, s, seed, knobs):
    out, errs, types = streaming_errors(all_models[family, "demo"], s, seed, knobs)
    assert out <= TOL_OUT
    for name, err in errs.items():
        assert err <= TOL_CARRY, name
    for name, mine, theirs in types:
        assert mine == theirs, name
    model_types = [t for n, t, _ in types][5:]
    assert (model_types.count("bfloat16"), model_types.count("float32")) \
        == MODEL_LEAF_TYPES[family]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_streaming_bf16_random_init_matches_jax(all_models, family):
    out, errs, types = streaming_errors(all_models[family, "random"], 2, 7, {})
    assert out <= TOL_OUT
    assert max(errs.values()) <= TOL_CARRY
    assert all(mine == theirs for _, mine, theirs in types)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_streaming_bf16_continues_across_calls(all_models, family):
    """Calls that continue from the carry equal one call, bit for bit, for
    the per-frame and the chunked runtime."""
    _, _, tm, td = all_models[family, "demo"]
    x = seeded_audio(2, 5)
    for rt in (StreamingRuntime(tm, td, dtype=BF16),
               ChunkedStreamingRuntime(tm, td, dtype=BF16, chunk_frames=4)):
        c_full, full = rt.process(rt.init(2), x)
        c, o1 = rt.process(rt.init(2), x[:, : 4 * HOP])
        c, o2 = rt.process(c, x[:, 4 * HOP:])
        assert torch.equal(torch.cat([o1, o2], 1), full)
        for a, b in zip(jax.tree.leaves(c), jax.tree.leaves(c_full)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def chunked_errors(models):
    """ChunkedStreamingRuntime(dtype=bf16, chunk_frames=4) in calls of 5 and
    3 frames: errors against JAX's chunked bf16 runtime, the port's per-frame
    bf16 run and its float32 run."""
    jm, jd, tm, td = models
    x = seeded_audio(2, 13)
    jcrt = JChunked(jm, jd, dtype=jnp.bfloat16, chunk_frames=4)
    crt = ChunkedStreamingRuntime(tm, td, dtype=BF16, chunk_frames=4)
    jc, c, refs, outs = jcrt.init(2), crt.init(2), [], []
    for lo, hi in ((0, 5), (5, 8)):
        jc, r = jcrt.process(jc, jnp.asarray(x[:, lo * HOP: hi * HOP]))
        c, o = crt.process(c, x[:, lo * HOP: hi * HOP])
        refs.append(np.asarray(r))
        outs.append(o)
    got = torch.cat(outs, 1)
    for a, b in zip(jax.tree.leaves(c.model), jax.tree.leaves(jc.model)):
        assert _dtype_name(a) == str(b.dtype)
    per_frame = StreamingRuntime(tm, td, dtype=BF16)
    _, pf = per_frame.process(per_frame.init(2), x)
    f32 = StreamingRuntime(tm, td)
    _, exact = f32.process(f32.init(2), x)
    return _rel(got, np.concatenate(refs, 1)), _rel(got, pf), _rel(got, exact)


@pytest.mark.parametrize("kind", ("demo", "random"))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_chunked_bf16_matches_jax(all_models, family, kind):
    jax_err, per_frame_err, f32_err = chunked_errors(all_models[family, kind])
    assert jax_err <= TOL_CHUNKED
    assert per_frame_err <= TOL_JAX_OWN and f32_err <= TOL_JAX_OWN


def test_mask_only_bf16_runs_through_the_cell(all_models):
    """DFN1's mask-only model (`run_df=False`) at bfloat16 against JAX's."""
    jm, jd, tm, td = all_models["dfn1", "demo"]
    jm = dataclasses.replace(jm, cfg=dict(jm.cfg, run_df=False), _jit_cache={})
    tm = dataclasses.replace(tm, cfg=dict(tm.cfg, run_df=False), _cache={})
    out, errs, _ = streaming_errors((jm, jd, tm, td), 2, 7, {})
    assert out <= TOL_OUT and max(errs.values()) <= TOL_CARRY


def main():
    """Print the worst error of every comparison."""
    torch.set_num_threads(1)
    for name, err in layer_errors().items():
        print(f"layer {name}: {err:.3g}")
    models = load_models()
    for (family, kind), m in models.items():
        cases = STREAM_CASES if kind == "demo" else STREAM_CASES[:1]
        worst_out = worst_carry = 0.0
        for s, seed, knobs in cases:
            out, errs, _ = streaming_errors(m, s, seed, knobs)
            worst_out, worst_carry = max(worst_out, out), max(worst_carry, max(errs.values()))
        print(f"{family} {kind} per-frame: output {worst_out:.3g}, carry {worst_carry:.3g}")
        j, pf, f32 = chunked_errors(m)
        print(f"{family} {kind} chunked: vs JAX {j:.3g}, vs per-frame bf16 {pf:.3g}, "
              f"vs float32 {f32:.3g}")


if __name__ == "__main__":
    main()
