"""The port's reduced-precision runtimes against the JAX package's, on the CPU.

Same seeded numpy audio through both packages, small sizes (2 to 4 streams,
8 frames), for the bundled demo checkpoint and for a random-init JAX model
carried across with `params_from_numpy`:

  * `StreamingRuntime(dtype=bfloat16)`, its carry leaf by leaf (values and
    types), `out_dtype=bfloat16`, and `ChunkedStreamingRuntime(dtype=bfloat16)`
    in calls of 5 and 3 frames;
  * the whole cell at bfloat16 operands: the weight set key by key,
    `cell_process_plain` against `cell_process_xla` and the Pallas kernel in
    interpret mode, `run_plan` (the CUDA kernel's schedule) against
    `cell_process_plain`, and `WholeCellStreamingRuntime()` with its default
    operands against `PallasStreamingRuntime()` with its own;
  * the bounds the CUDA kernel's bfloat16 build is held to
    (`whole_cell_check.BF16_BOUNDS`): a variant that sums in float64 meets
    them, each wrong rounding exceeds them;
  * the drift of bfloat16 runs over 200 frames, the port's against the JAX
    package's own.

bfloat16 keeps 8 bits of mantissa, so every bound is relative to the largest
value of the output or leaf it holds (`_rel`). Where a value lies near a
rounding boundary, two float32 sums in another order (the frontends, the
products) round it to neighbouring bfloat16 values, and the saturated GRU
recurrences carry that unit in the last place on: over 8 frames the
per-frame runtime then stays within 1.2% of the output's scale and 3.5% of
the GRU state's, the whole cell within 2% of a GRU state's (PERF.md),
as the JAX package's own two bfloat16 per-frame variants (`fuse_ops` on and
off) stay within 1.5% and 6% of each other. Where no value flips, the port
equals the JAX package to float32 rounding.

    PYTHONPATH=. python tests/test_torch_reduced_precision.py

prints the worst relative error of every comparison here (the figures
PERF.md quotes).
"""

import dataclasses
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.enhance import init_df as j_init_df  # noqa: E402
from deepfilternet_tpu.ops import pallas_cell as j_cell  # noqa: E402
from deepfilternet_tpu.streaming import ChunkedStreamingRuntime as JChunked  # noqa: E402
from deepfilternet_tpu.streaming import RuntimeParams as JRuntimeParams  # noqa: E402
from deepfilternet_tpu.streaming import StreamingRuntime as JRuntime  # noqa: E402
from deepfilternet_tpu import streaming_pallas as j_sp  # noqa: E402
from deepfilternet_torch.checkpoint import params_from_numpy  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.enhance import init_df  # noqa: E402
from deepfilternet_torch.ops import whole_cell as wc  # noqa: E402
from deepfilternet_torch.ops import whole_cell_plan as wp  # noqa: E402
from deepfilternet_torch.ops import whole_cell_check as wcc  # noqa: E402
from deepfilternet_torch.streaming import (  # noqa: E402
    ChunkedStreamingRuntime,
    RuntimeParams,
    StreamingRuntime,
)
from deepfilternet_torch.streaming_whole_cell import (  # noqa: E402
    WholeCellStreamingRuntime,
    carry_to_flat,
)

MODEL_DIR = "pretrained/dfn3_fixture_demo"
HOP = 480
FRAMES = 8
BF16 = torch.bfloat16
STAGES = dict(atten_lim_db=12.0, post_filter_beta=0.02, lsnr_gating=True)
PARAM_SETS = {"default": {}, "stages": STAGES}
# (streams, audio seed) of the per-frame comparisons; seed 3 is one whose
# features round differently in the two packages (see the module docstring)
STREAM_CASES = ((2, 7), (3, 3), (4, 11))

# Bounds, each a fraction of the reference's largest value; the worst
# measured by `main` (PERF.md) in brackets. A bound more than 10x above
# its measured worst is 4x that worst.
TOL_OUT = 2e-2         # per-frame runtime output against JAX [1.18e-2]
TOL_CARRY = 5e-2       # per-frame runtime carry leaves against JAX [3.52e-2]
TOL_OUT_DTYPE = 1e-2   # out_dtype=bf16 against JAX's [1.46e-3]
TOL_CHUNKED = 1e-2     # chunked runtime output against JAX's chunked runtime [8.11e-3]
TOL_JAX_OWN = 0.1      # the JAX tests' own bound for chunked against per-frame [2.70e-2]
TOL_CELL = 5e-2        # whole cell, the 12 outputs, against JAX's [2.02e-2]
TOL_RT_OUT = 2.2e-4    # whole-cell runtime output against JAX's [5.31e-5]
TOL_RT_CARRY = 4.3e-3  # whole-cell runtime carry against JAX's [1.07e-3]
TOL_PLAN = 4e-4        # run_plan against cell_process_plain, both bfloat16 [6.40e-5]


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_config():
    """Reset the port's global config; run torch on one CPU thread (the
    per-frame ops are tiny, and the suite runs several workers at once)."""
    t_config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_models():
    """{"demo": the bundled checkpoint in both packages, "random": a
    random-init JAX model and the same numbers carried into the port}."""
    jm, jd, _ = j_init_df(MODEL_DIR)
    tm, td, _ = init_df(MODEL_DIR, device="cpu")
    j_config.reset()
    rjm, rjd, _ = j_init_df()
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    p, s = params_from_numpy(to_np(rjm.params), to_np(rjm.state), "cpu")
    rtm = dataclasses.replace(tm, params=p, state=s, _cache={})
    return {"demo": (jm, jd, tm, td), "random": (rjm, rjd, rtm, td)}


@pytest.fixture(scope="module")
def all_models():
    return load_models()


@pytest.fixture(scope="module", params=["demo", "random"])
def models(request, all_models):
    return all_models[request.param]


def seeded_audio(s, seed, frames=FRAMES):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((s, frames * HOP)) * 0.1).astype(np.float32)


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


# -- the per-frame runtime -----------------------------------------------------


def streaming_errors(models, s, seed, pset):
    """StreamingRuntime(dtype=bf16) against JAX's: (output error, {leaf:
    error}, [(leaf, port type, JAX type)])."""
    jm, jd, tm, td = models
    x = seeded_audio(s, seed)
    jrt = JRuntime(jm, jd, JRuntimeParams(**PARAM_SETS[pset]), dtype=jnp.bfloat16)
    jc, ref = jrt.process(jrt.init(s), jnp.asarray(x))
    rt = StreamingRuntime(tm, td, RuntimeParams(**PARAM_SETS[pset]), dtype=BF16)
    c, got = rt.process(rt.init(s), x)
    assert got.dtype == torch.float32
    leaves = list(c._asdict().items())[:-1] + list(c.model._asdict().items())
    j_leaves = list(jc)[:-1] + list(jc.model)
    errs = {name: _rel(a, b) for (name, a), b in zip(leaves, j_leaves)}
    types = [(name, _dtype_name(a), str(b.dtype)) for (name, a), b in zip(leaves, j_leaves)]
    return _rel(got, ref), errs, types


@pytest.mark.parametrize("pset", list(PARAM_SETS))
@pytest.mark.parametrize("s, seed", STREAM_CASES)
def test_streaming_bf16_matches_jax(models, s, seed, pset):
    out, errs, types = streaming_errors(models, s, seed, pset)
    assert out <= TOL_OUT
    for name, err in errs.items():
        assert err <= TOL_CARRY, name
    # the same type leaf by leaf: bfloat16 model carry, float32 DF ring,
    # frontend memories and norms, int32 counter
    for name, mine, theirs in types:
        assert mine == theirs, name
    want = {"erb_buf": "bfloat16", "enc_gru_h": "bfloat16", "df_ring_re": "float32",
            "mean_norm": "float32", "silence_ctr": "int32"}
    assert {n: t for n, t, _ in types if n in want} == want


def test_streaming_bf16_continues_across_calls(all_models):
    """Calls that continue from the carry equal one call, bit for bit."""
    _, _, tm, td = all_models["demo"]
    rt = StreamingRuntime(tm, td, dtype=BF16)
    x = seeded_audio(2, 5)
    c_full, full = rt.process(rt.init(2), x)
    c, o1 = rt.process(rt.init(2), x[:, : 3 * HOP])
    c, o2 = rt.process_frame(c, x[:, 3 * HOP: 4 * HOP])
    c, o3 = rt.process(c, x[:, 4 * HOP:])
    assert torch.equal(torch.cat([o1, o2, o3], 1), full)
    for a, b in zip(jax.tree.leaves(c), jax.tree.leaves(c_full)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def out_dtype_errors(models):
    """out_dtype=bf16: (result type, bit-equal to the float32 output cast,
    error against JAX's out_dtype=bf16 run)."""
    jm, jd, tm, td = models
    x = seeded_audio(2, 9)
    jrt = JRuntime(jm, jd, out_dtype=jnp.bfloat16)
    _, ref = jrt.process(jrt.init(2), jnp.asarray(x))
    rt = StreamingRuntime(tm, td, out_dtype=BF16)
    _, got = rt.process(rt.init(2), x)
    f32 = StreamingRuntime(tm, td)
    _, exact = f32.process(f32.init(2), x)
    return got.dtype, torch.equal(got, exact.to(BF16)), _rel(got, ref)


def test_out_dtype_bf16(models):
    dtype, bit_equal, err = out_dtype_errors(models)
    assert dtype == BF16 and bit_equal
    assert err <= TOL_OUT_DTYPE


def test_out_dtype_with_bf16_model_and_per_frame_calls(all_models):
    _, _, tm, td = all_models["demo"]
    rt = StreamingRuntime(tm, td, dtype=BF16, out_dtype=BF16)
    x = seeded_audio(2, 4, frames=3)
    c, full = rt.process(rt.init(2), x)
    _, frame = rt.process_frame(rt.init(2), x[:, :HOP])
    assert full.dtype == frame.dtype == BF16
    assert torch.equal(frame, full[:, :HOP])


def test_float16_raises(all_models):
    _, _, tm, td = all_models["demo"]
    for cls in (StreamingRuntime, ChunkedStreamingRuntime):
        with pytest.raises(NotImplementedError, match="bfloat16"):
            cls(tm, td, dtype=torch.float16)
    with pytest.raises(ValueError):
        StreamingRuntime(tm, td, out_dtype=torch.int16)


def test_runtime_casts_params_once_and_keeps_the_model(all_models):
    _, _, tm, td = all_models["demo"]
    rt = StreamingRuntime(tm, td, dtype=BF16)
    assert rt.model.params["erb_conv0"]["w"].dtype == BF16
    assert rt.model.state["erb_conv0"]["bn"]["var"].dtype == BF16
    # the caller's model stays float32
    assert tm.params["erb_conv0"]["w"].dtype == torch.float32


def noisy_speech_like(n_streams, seconds, seed, sr=48000):
    """chip_smoke.py's main-path audio: harmonic tones with a slow vibrato
    plus white noise, per stream."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(100.0, 300.0, (n_streams, 1))
    vib = 1.0 + 0.02 * np.sin(2 * np.pi * rng.uniform(2.0, 6.0, (n_streams, 1)) * t)
    phase = 2 * np.pi * f0 * np.cumsum(vib, axis=1) / sr
    speech = sum(np.sin(k * phase) / k for k in range(1, 6)) * 0.1
    noise = rng.standard_normal(speech.shape) * rng.uniform(0.01, 0.05, (n_streams, 1))
    return (speech + noise).astype(np.float32)


def drift_errors(models, s):
    """bfloat16 runs drift apart over chip_smoke.py's 2 s main path (its
    first `s` of 64 streams): {pair: (the JAX package's own reading, the
    port's)}, for the per-frame runtime at bf16 against float32 and the
    whole cell at bf16 against the per-frame runtime at bf16."""
    jm, jd, tm, td = models
    x = noisy_speech_like(64, 2.0, 0)[:s]
    jax_rts = {"f32": JRuntime(jm, jd), "bf16": JRuntime(jm, jd, dtype=jnp.bfloat16),
               "cell": j_sp.PallasStreamingRuntime(jm, jd, chunk=2, backend="xla")}
    port_rts = {"f32": StreamingRuntime(tm, td), "bf16": StreamingRuntime(tm, td, dtype=BF16),
                "cell": WholeCellStreamingRuntime(tm, td, backend="plain")}
    j = {k: rt.process(rt.init(s), jnp.asarray(x))[1] for k, rt in jax_rts.items()}
    p = {k: rt.process(rt.init(s), x)[1] for k, rt in port_rts.items()}
    pairs = {"per-frame bf16 vs float32": ("bf16", "f32"),
             "whole cell bf16 vs per-frame bf16": ("cell", "bf16")}
    return {k: (_rel(j[a], j[b]), _rel(p[a], p[b])) for k, (a, b) in pairs.items()}


def test_bf16_drift_over_2s_is_the_jax_packages_own(all_models):
    """Over 200 frames the bfloat16 GRU states of the per-frame runtime
    carry rounding flips on until the runs differ by several percent of the
    output's scale: in the JAX package as in the port, so chip_smoke.py
    holds these pairs over all 200 frames to the JAX tests' 0.1."""
    for pair, (jax_drift, port_drift) in drift_errors(all_models["demo"], 8).items():
        assert port_drift <= 2 * jax_drift and port_drift <= TOL_JAX_OWN, pair


# -- the chunked runtime -------------------------------------------------------


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


def test_chunked_bf16_matches_jax(models):
    jax_err, per_frame_err, f32_err = chunked_errors(models)
    assert jax_err <= TOL_CHUNKED
    # the JAX tests' own bounds for the chunked runtime at bfloat16
    assert per_frame_err <= TOL_JAX_OWN and f32_err <= TOL_JAX_OWN


def test_chunked_out_dtype(all_models):
    """The chunked runtime's output is float32 at either model type, as the
    JAX package's is; `out_dtype` belongs to the per-frame runtime only."""
    _, _, tm, td = all_models["demo"]
    x = seeded_audio(2, 6, frames=5)
    for dtype in (torch.float32, BF16):
        crt = ChunkedStreamingRuntime(tm, td, dtype=dtype, chunk_frames=2)
        _, got = crt.process(crt.init(2), x)
        assert got.dtype == torch.float32 and got.shape == x.shape
    with pytest.raises(TypeError):
        ChunkedStreamingRuntime(tm, td, chunk_frames=2, out_dtype=BF16)


# -- the whole cell ------------------------------------------------------------


@pytest.mark.parametrize("pset", list(PARAM_SETS))
def test_build_cell_weights_bf16_matches_jax(models, pset):
    jm, jd, tm, td = models
    params = PARAM_SETS[pset]
    jw, _ = j_cell.build_cell_weights(jm, jd, JRuntimeParams(**params), jnp.bfloat16)
    tw, _ = wc.build_cell_weights(tm, td, RuntimeParams(**params), BF16)
    for k in wc.WKEYS:
        want = "float32" if k in ("imult", "convp_b") else "bfloat16"
        assert _dtype_name(tw[k]) == str(jw[k].dtype) == want, k
        assert tw[k].is_contiguous() and tuple(tw[k].shape) == wc.WSHAPES[k]
        if want == "bfloat16":  # rounded to nearest, ties to even, on both sides
            np.testing.assert_array_equal(_np(tw[k]), _np(jw[k]), err_msg=k)
        else:
            np.testing.assert_allclose(_np(tw[k]), _np(jw[k]), rtol=0, atol=1e-5, err_msg=k)


def _seeded_flat_carry(s, seed):
    """A plausible non-initial flat carry, as numpy arrays per CKEYS."""
    rng = np.random.default_rng(seed)
    flat = {k: (rng.standard_normal((s, d)) * 0.1).astype(np.float32) for k, d in wc.CKEYS}
    flat["norms"][:, :32] = np.linspace(-60, -90, 32, dtype=np.float32) + flat["norms"][:, :32]
    flat["norms"][:, 32:] = rng.uniform(1e-4, 1e-3, (s, 96)).astype(np.float32)
    flat["sil"][:] = 0.0
    flat["sil"][:, 0] = np.arange(s) % 3
    for k in ("ring_re", "ring_im"):  # pad lanes of the DF ring stay zero
        flat[k].reshape(s, 4, wc.BLK)[:, :, 96:] = 0.0
    return flat


def cell_errors(models, pset, interpret=False, s=3):
    """cell_process_plain at bf16 against the JAX whole cell at bf16 (the
    XLA form, or the Pallas kernel in interpret mode) from a non-initial
    carry: {output: error} over the audio and the 11 carry arrays."""
    jm, jd, tm, td = models
    params = PARAM_SETS[pset]
    jw, jst = j_cell.build_cell_weights(jm, jd, JRuntimeParams(**params), jnp.bfloat16)
    tw, tst = wc.build_cell_weights(tm, td, RuntimeParams(**params), BF16)
    x = seeded_audio(s, 17)
    carry = _seeded_flat_carry(s, 5)
    got_c, got = wc.cell_process_plain(
        torch.from_numpy(x), {k: torch.from_numpy(v.copy()) for k, v in carry.items()}, tw, tst)
    jcarry = {k: jnp.asarray(v) for k, v in carry.items()}
    if interpret:
        ref_c, ref = j_cell.cell_process(jnp.asarray(x), jcarry, jw, jst, s, 2,
                                         mdtype=jnp.bfloat16, interpret=True)
    else:
        ref_c, ref = j_cell.cell_process_xla(jnp.asarray(x), jcarry, jw, jst, 2,
                                             mdtype=jnp.bfloat16)
    errs = {"audio": _rel(got, ref)}
    errs.update({k: _rel(got_c[k], ref_c[k]) for k, _ in wc.CKEYS})
    return errs


@pytest.mark.parametrize("pset", list(PARAM_SETS))
def test_cell_process_plain_bf16_matches_jax_xla(models, pset):
    for name, err in cell_errors(models, pset).items():
        assert err <= TOL_CELL, name


def test_cell_process_plain_bf16_matches_jax_pallas_interpret(all_models):
    for name, err in cell_errors(all_models["demo"], "stages", interpret=True).items():
        assert err <= TOL_CELL, name


def plan_errors(models, pset, s, bf16_plan=False):
    """run_plan (the kernel's schedule, with its rounding points; the float32
    build's plan, or with `bf16_plan` the bfloat16 build's, whose weights are
    packed in fragment order) against cell_process_plain, both at bf16, from a
    non-initial carry with a silent stretch: {output: error}, and the hazards
    found."""
    _, _, tm, td = models
    rt = WholeCellStreamingRuntime(tm, td, RuntimeParams(**PARAM_SETS[pset]), backend="plain")
    frames = 6
    x = torch.from_numpy(seeded_audio(s, s, frames=4 + frames))
    x[:, 6 * HOP: 8 * HOP] = 0.0
    carry, _ = wc.cell_process_plain(x[:, : 4 * HOP].contiguous(), carry_to_flat(rt.init(s)),
                                     rt.weights, rt.statics)
    xc = x[:, 4 * HOP:].contiguous()
    ref_c, ref = wc.cell_process_plain(xc, carry, rt.weights, rt.statics)
    table, info = wp.plan(s, 132, bf16=bf16_plan)
    packed = wp.pack_weights(rt.weights, info)
    assert packed.dtype == BF16
    hazards = []
    got_c, got = wp.run_plan(table, xc, carry, rt.weights, rt.statics, packed, hazards=hazards)
    errs = {"audio": _rel(got, ref)}
    errs.update({k: _rel(got_c[k], ref_c[k]) for k, _ in wc.CKEYS})
    return errs, hazards


@pytest.mark.parametrize("pset", list(PARAM_SETS))
@pytest.mark.parametrize("s", [3, 70])
def test_run_plan_bf16_matches_cell_process_plain(all_models, pset, s):
    errs, hazards = plan_errors(all_models["demo"], pset, s)
    assert hazards == []
    for name, err in errs.items():
        assert err <= TOL_PLAN, name


@pytest.mark.parametrize("pset", list(PARAM_SETS))
@pytest.mark.parametrize("s", [3, 70])
def test_run_plan_on_the_bf16_plan_matches_cell_process_plain(all_models, pset, s):
    """The bfloat16 build's own plan (n8-tile widths, B-fragment packing) run
    on the CPU, as test_run_plan_bf16_matches_cell_process_plain runs the
    float32 one."""
    errs, hazards = plan_errors(all_models["demo"], pset, s, bf16_plan=True)
    assert hazards == []
    for name, err in errs.items():
        assert err <= TOL_PLAN, name


def gate_errors(models, pset, s, products, frames=FRAMES):
    """The plain version with `products` against the plain version, both at
    bf16, from the carry 4 plain frames leave: {"one frame": errors of each
    frame from the plain version's carry, "frames": errors of `frames`
    frames running on} (`whole_cell_check`)."""
    _, _, tm, td = models
    rt = WholeCellStreamingRuntime(tm, td, RuntimeParams(**PARAM_SETS[pset]), backend="plain")
    W, st = rt.weights, rt.statics
    x = torch.from_numpy(seeded_audio(s, 100 + s, frames=4 + frames))
    carry, _ = wc.cell_process_plain(x[:, : 4 * HOP].contiguous(), carry_to_flat(rt.init(s)),
                                     W, st)
    xc = x[:, 4 * HOP:].contiguous()
    variant = lambda x1, c1: wc.cell_process_plain(x1, c1, W, st, products)  # noqa: E731
    return {"one frame": wcc.frame_by_frame(variant, xc, carry, W, st),
            "frames": wcc.cell_errors(variant(xc, carry), wc.cell_process_plain(xc, carry, W, st))}


@pytest.mark.parametrize("pset", list(PARAM_SETS))
@pytest.mark.parametrize("s", [8, 37])
def test_bf16_gate_passes_another_sum_order(all_models, pset, s):
    """A right kernel that sums in another order (float64 here) stays within
    the bounds the CUDA kernel's bfloat16 build is held to."""
    for span, errs in gate_errors(all_models["demo"], pset, s, wcc.Float64Sums).items():
        assert wcc.out_of_bounds(errs, wcc.BF16_BOUNDS[span]) == [], span


@pytest.mark.parametrize("pset", list(PARAM_SETS))
@pytest.mark.parametrize("s", [8, 37])
def test_bf16_gate_passes_the_tensor_core_sum_order(all_models, pset, s):
    """The order in which the CUDA kernel's bfloat16 builds sum on the tensor
    cores (`TensorCoreSums`: exact k16 steps, truncating float32 chains of up
    to one 64-row chunk, chunks joined rounded to nearest) stays within the
    bounds the kernel is held to."""
    for span, errs in gate_errors(all_models["demo"], pset, s, wcc.TensorCoreSums).items():
        assert wcc.out_of_bounds(errs, wcc.BF16_BOUNDS[span]) == [], span


def test_tensor_core_sums_truncate_within_a_chunk_and_round_between():
    """`TensorCoreSums` on a hand-made product: within a 64-row chunk the
    chain's adds cut toward zero, chunks are added rounded to nearest. 1 + 3 *
    2^-25 is 3/4 of a float32 unit above 1."""
    w = {"dft": torch.zeros((2, 2), dtype=BF16), "m": torch.ones((128, 1), dtype=BF16)}
    p = wcc.TensorCoreSums(w)
    x = torch.zeros((1, 128))
    x[0, 0] = 1.0                               # k16 step 0 of chunk 0
    x[0, 16], x[0, 17] = 2.0 ** -24, 2.0 ** -25  # step 1, summed exactly
    assert float(p.mmf(x, "m")) == 1.0          # cut, where rounding gives 1 + 2^-23
    y = torch.zeros((1, 128))
    y[0, 0] = 1.0                               # chunk 0
    y[0, 64], y[0, 65] = 2.0 ** -24, 2.0 ** -25  # chunk 1
    assert float(p.mmf(y, "m")) == 1.0 + 2.0 ** -23  # the chunks' join rounds


@pytest.mark.parametrize("pset", list(PARAM_SETS))
@pytest.mark.parametrize("wrong", wcc.WRONG, ids=lambda c: c.__name__)
def test_bf16_gate_rejects_misplaced_rounding(all_models, pset, wrong):
    """A kernel that skips or misplaces the bfloat16 rounding fails each of
    the bounds, one frame and several."""
    for span, errs in gate_errors(all_models["demo"], pset, 37, wrong).items():
        assert wcc.out_of_bounds(errs, wcc.BF16_BOUNDS[span]) != [], span


def whole_cell_runtime_errors(models, pset):
    """WholeCellStreamingRuntime() with its default operands against JAX's
    PallasStreamingRuntime(backend="xla") with its own: (output error,
    {carry field: error})."""
    jm, jd, tm, td = models
    x = seeded_audio(3, 19)
    # chunk=2 (frames a scan step, no effect on results): XLA's CPU backend
    # has refused one of the bfloat16 products of an 8-frame step
    jrt = j_sp.PallasStreamingRuntime(jm, jd, JRuntimeParams(**PARAM_SETS[pset]), chunk=2,
                                      backend="xla")
    jc, ref = jrt.process(jrt.init(3), jnp.asarray(x))
    rt = WholeCellStreamingRuntime(tm, td, RuntimeParams(**PARAM_SETS[pset]), backend="plain")
    c, got = rt.process(rt.init(3), x)
    leaves = list(c._asdict().items())[:-1] + list(c.model._asdict().items())
    j_leaves = list(jc)[:-1] + list(jc.model)
    return _rel(got, ref), {n: _rel(a, b) for (n, a), b in zip(leaves, j_leaves)}


@pytest.mark.parametrize("pset", list(PARAM_SETS))
def test_whole_cell_runtime_default_is_bf16_and_matches_jax(models, pset):
    _, _, tm, td = models
    rt = WholeCellStreamingRuntime(tm, td, backend="plain")
    assert rt.matmul_dtype == BF16 and rt.weights["dft"].dtype == BF16
    assert rt.weights["imult"].dtype == rt.weights["convp_b"].dtype == torch.float32
    out, errs = whole_cell_runtime_errors(models, pset)
    assert out <= TOL_RT_OUT
    for name, err in errs.items():
        assert err <= TOL_RT_CARRY, name


def test_whole_cell_bf16_continues_across_calls(all_models):
    _, _, tm, td = all_models["demo"]
    rt = WholeCellStreamingRuntime(tm, td, backend="plain")
    x = seeded_audio(2, 21)
    c_full, full = rt.process(rt.init(2), x)
    c, o1 = rt.process(rt.init(2), x[:, : 5 * HOP])
    c, o2 = rt.process(c, x[:, 5 * HOP:])
    assert torch.equal(torch.cat([o1, o2], 1), full)
    for a, b in zip(jax.tree.leaves(c), jax.tree.leaves(c_full)):
        assert torch.equal(a, b)


def test_cell_process_checks_weight_types(all_models):
    """A bfloat16 set keeps imult and convp_b in float32; a set of any other
    type is refused."""
    _, _, tm, td = all_models["demo"]
    rt = WholeCellStreamingRuntime(tm, td, backend="plain")
    x = torch.zeros((2, HOP))
    carry = carry_to_flat(rt.init(2))
    for key, dtype in (("imult", BF16), ("e0_w", torch.float32), ("dft", torch.float16)):
        weights = dict(rt.weights, **{key: rt.weights[key].to(dtype)})
        with pytest.raises(TypeError):
            wc.cell_process(x, carry, weights, rt.statics)


# -- the CUDA kernel's bfloat16 build ----------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the whole-cell CUDA kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 5, 37])
def test_cuda_bf16_kernel_matches_plain(cuda_device, s):
    """The bfloat16 build against the plain bfloat16 version on the card, all
    12 outputs, 8 frames from the same carry and each frame from the plain
    version's carry, within `whole_cell_check.BF16_BOUNDS` (the bounds
    chip_smoke.py holds it to)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    tm, td, _ = init_df(MODEL_DIR, device=cuda_device)
    rt = WholeCellStreamingRuntime(tm, td, RuntimeParams(**STAGES))
    x = torch.from_numpy(seeded_audio(s, s)).to(cuda_device)
    carry = {k: torch.from_numpy(v).to(cuda_device) for k, v in _seeded_flat_carry(s, 3).items()}
    W, st = rt.weights, rt.statics
    before = (wc.cell_process.launches, wc.cell_process.bf16_launches)
    got = wc.cell_process(x, carry, W, st)
    torch.cuda.synchronize()
    assert (wc.cell_process.launches, wc.cell_process.bf16_launches) == (before[0] + 1,
                                                                         before[1] + 1)
    errs = wcc.cell_errors(got, wc.cell_process_plain(x, carry, W, st))
    assert wcc.out_of_bounds(errs, wcc.BF16_BOUNDS["frames"]) == []
    errs = wcc.frame_by_frame(lambda x1, c1: wc.cell_process(x1, c1, W, st), x, carry, W, st)
    assert wcc.out_of_bounds(errs, wcc.BF16_BOUNDS["one frame"]) == []


@pytest.mark.cuda
@pytest.mark.parametrize("design, rows", [("rows", 16), ("rows", 8), ("units", None)])
@pytest.mark.parametrize("s", [37, 70])
def test_cuda_bf16_kernel_designs_match_plain(cuda_device, monkeypatch, s, design, rows):
    """Each design of the bfloat16 build, forced whatever S (the rows design
    with 16 stream rows a block, two n8 tiles of the tensor cores; with 8; the
    units design), against the plain bfloat16 version within `BF16_BOUNDS`,
    8 frames and each frame from the plain version's carry."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    monkeypatch.setattr(wc, "_kernel_choice", lambda *a: design)
    if rows is not None:
        monkeypatch.setattr(wc, "_tile_rows", lambda *a: rows)
    tm, td, _ = init_df(MODEL_DIR, device=cuda_device)
    rt = WholeCellStreamingRuntime(tm, td, RuntimeParams(**STAGES))
    x = torch.from_numpy(seeded_audio(s, s)).to(cuda_device)
    carry = {k: torch.from_numpy(v).to(cuda_device) for k, v in _seeded_flat_carry(s, 3).items()}
    W, st = rt.weights, rt.statics
    errs = wcc.cell_errors(wc.cell_process(x, carry, W, st), wc.cell_process_plain(x, carry, W, st))
    assert wcc.out_of_bounds(errs, wcc.BF16_BOUNDS["frames"]) == []
    errs = wcc.frame_by_frame(lambda x1, c1: wc.cell_process(x1, c1, W, st), x, carry, W, st)
    assert wcc.out_of_bounds(errs, wcc.BF16_BOUNDS["one frame"]) == []


# -- the worst errors, for PERF.md ----------------------------------------------


def main():
    torch.set_num_threads(1)
    t_config.reset()
    all_m = load_models()
    worst = {}

    def note(key, err):
        worst[key] = max(worst.get(key, 0.0), err)

    for mname, m in all_m.items():
        for pset in PARAM_SETS:
            for s, seed in STREAM_CASES:
                out, errs, _ = streaming_errors(m, s, seed, pset)
                note("per-frame output vs JAX", out)
                gru = max(errs[k] for k in ("enc_gru_h", "dec_gru_h", "df_gru_h"))
                note("per-frame GRU states vs JAX", gru)
                note("per-frame other carry leaves vs JAX",
                     max(v for k, v in errs.items() if not k.endswith("gru_h")))
                print(f"{mname} {pset} S={s} seed={seed}: output {out:.3e}, GRU states {gru:.3e}")
            for k, v in cell_errors(m, pset).items():
                note("cell_process_plain vs cell_process_xla", v)
            out, errs = whole_cell_runtime_errors(m, pset)
            note("whole-cell runtime output vs PallasStreamingRuntime(xla)", out)
            note("whole-cell runtime carry vs PallasStreamingRuntime(xla)", max(errs.values()))
        note("out_dtype=bf16 vs JAX", out_dtype_errors(m)[2])
        for key, v in zip(("chunked vs JAX chunked", "chunked vs port per-frame bf16",
                           "chunked vs port float32"), chunked_errors(m)):
            note(key, v)
    for v in cell_errors(all_m["demo"], "stages", interpret=True).values():
        note("cell_process_plain vs Pallas interpret", v)
    for pset in PARAM_SETS:
        for s in (3, 70):
            errs, _ = plan_errors(all_m["demo"], pset, s)
            note("run_plan vs cell_process_plain", max(errs.values()))
    # the bfloat16 kernel's bounds: a right variant and the wrong ones
    # against the plain version, (largest, mean) per span
    gate = {}
    for pset in PARAM_SETS:
        for s in (1, 8, 37):
            for products in wcc.RIGHT + wcc.WRONG:
                for span, errs in gate_errors(all_m["demo"], pset, s, products).items():
                    top, mean = wcc.worst(errs)
                    key = (products.__name__, span)
                    lo = gate.get(key, (0.0, 0.0, 1.0))
                    gate[key] = (max(lo[0], top), max(lo[1], mean), min(lo[2], mean))
    for pair, (jax_drift, port_drift) in drift_errors(all_m["demo"], 64).items():
        print(f"drift over chip_smoke.py's 64 x 2 s, {pair}: the JAX package's "
              f"{jax_drift:.3e}, the port's {port_drift:.3e}")
    print("worst relative errors (fraction of the reference's largest value):")
    for k, v in worst.items():
        print(f"  {k}: {v:.3e}")
    print("plain-version variants against the plain version at bf16, S = 1, 8, 37, both "
          f"param sets (largest error, mean error: worst and least); bounds {wcc.BF16_BOUNDS}:")
    for (name, span), (top, mean, least) in gate.items():
        print(f"  {name}, {span}: largest {top:.3e}, mean {mean:.3e} (least {least:.3e})")


if __name__ == "__main__":
    sys.exit(main())
