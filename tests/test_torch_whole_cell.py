"""The port's whole-cell streaming path against the JAX package, on the CPU.

Same seeded inputs through both packages, float32 on both sides (the
runtime is asked for float32 operands; its bfloat16 default is held to the
JAX package in `tests/test_torch_reduced_precision.py`), small sizes (3
streams, 8 frames), for the bundled demo checkpoint and for a random-init JAX
model carried across with `params_from_numpy`:

  * the dense conv folds (`build_fused`) and the kernel's weight set
    (`build_cell_weights`) key by key, 1e-5;
  * the flat carry layout (`carry_to_flat` / `flat_to_carry`);
  * `cell_process_plain` against the JAX Pallas kernel run in interpret mode
    (as the JAX package's own tests run it on the CPU) and against
    `cell_process_xla`, on the audio and all 11 carry arrays;
  * `WholeCellStreamingRuntime(backend="plain")` against
    `PallasStreamingRuntime(interpret=True)` and the per-frame JAX
    `StreamingRuntime`, at the JAX tests' own tolerance for that pair
    (atol 2e-4, rtol 1e-3); 1e-5 where the port is compared with itself.

On the CPU the kernel wrapper runs its plain version; the tests that launch
the CUDA kernel are marked `cuda` and skip without a GPU.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.enhance import init_df as j_init_df  # noqa: E402
from deepfilternet_tpu.models.dfnet3_fused import build_fused as j_build_fused  # noqa: E402
from deepfilternet_tpu.ops import pallas_cell as j_cell  # noqa: E402
from deepfilternet_tpu.streaming import RuntimeParams as JRuntimeParams  # noqa: E402
from deepfilternet_tpu.streaming import StreamingRuntime as JRuntime  # noqa: E402
from deepfilternet_tpu import streaming_pallas as j_sp  # noqa: E402
from deepfilternet_torch.checkpoint import params_from_numpy  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.enhance import init_df  # noqa: E402
from deepfilternet_torch.models.dfnet3_fused import FusedDfNet3, build_fused  # noqa: E402
from deepfilternet_torch.ops import whole_cell as wc  # noqa: E402
from deepfilternet_torch.streaming import RuntimeParams, StreamingRuntime  # noqa: E402
from deepfilternet_torch.streaming_whole_cell import (  # noqa: E402
    WholeCellStreamingRuntime,
    carry_to_flat,
    flat_to_carry,
)

MODEL_DIR = "pretrained/dfn3_fixture_demo"
HOP = 480
S, FRAMES = 3, 8
STAGES = dict(atten_lim_db=12.0, post_filter_beta=0.02, lsnr_gating=True)
PARAM_SETS = {"default": {}, "stages": STAGES}
# the JAX tests' own tolerance for the whole-cell runtime against the per-frame one
RT_TOL = dict(atol=2e-4, rtol=1e-3)
CARRY_FIELDS = ("analysis_mem", "synthesis_mem", "mean_norm", "unit_norm", "silence_ctr")


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
def all_models():
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


@pytest.fixture(scope="module", params=["demo", "random"])
def models(request, all_models):
    return all_models[request.param]


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((S, FRAMES * HOP)) * 0.1).astype(np.float32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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


# -- (a) the dense folds -----------------------------------------------------


def test_build_fused_matches_jax(models):
    jm, _, tm, _ = models
    ref = j_build_fused(jm.params, jm.state, jm.cfg)
    got = build_fused(tm.params, tm.state, tm.cfg)
    assert set(got) == set(ref)
    for k, r in ref.items():
        pairs = zip(got[k], r) if isinstance(r, tuple) else [(got[k], r)]
        for g, rr in pairs:
            np.testing.assert_allclose(_np(g), np.asarray(rr), rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("pset", list(PARAM_SETS))
def test_fused_adapter_matches_unfused_cell(models, audio, pset):
    """FusedDfNet3 plugs into StreamingRuntime as model.module."""
    _, _, tm, td = models
    params = RuntimeParams(**PARAM_SETS[pset])
    fused = dataclasses.replace(tm, module=FusedDfNet3(tm.params, tm.state, tm.cfg))
    rt, frt = StreamingRuntime(tm, td, params), StreamingRuntime(fused, td, params)
    c, ref = rt.process(rt.init(S), audio)
    fc, got = frt.process(frt.init(S), audio)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-4)
    for name in c.model._fields:
        np.testing.assert_allclose(getattr(fc.model, name).numpy(),
                                   getattr(c.model, name).numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)


# -- (b) the kernel's weight set ---------------------------------------------


@pytest.mark.parametrize("pset", list(PARAM_SETS))
def test_build_cell_weights_matches_jax(models, pset):
    jm, jd, tm, td = models
    jrt = j_sp.PallasStreamingRuntime(jm, jd, JRuntimeParams(**PARAM_SETS[pset]),
                                      matmul_dtype=jnp.float32, interpret=True)
    rt = WholeCellStreamingRuntime(tm, td, RuntimeParams(**PARAM_SETS[pset]),
                                   matmul_dtype=torch.float32, backend="plain")
    assert wc.WKEYS == j_cell.WKEYS and wc.CKEYS == j_cell.CKEYS
    assert (wc.FPAD, wc.BLK) == (j_cell.FPAD, j_cell.BLK)
    for k in wc.WKEYS:
        g, r = rt.weights[k], np.asarray(jrt.weights[k])
        assert g.dtype == torch.float32 and g.is_contiguous()
        assert tuple(g.shape) == r.shape == wc.WSHAPES[k], k
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5, err_msg=k)
    for field in wc.CellStatics._fields:  # the JAX `ablate` switch is not ported
        got, ref = getattr(rt.statics, field), getattr(jrt.statics, field)
        assert type(got) is type(ref) and got == pytest.approx(ref, rel=1e-12), field
    assert rt.statics.mask_pf == (pset == "stages")


# -- (c) the flat carry ------------------------------------------------------


def test_carry_flat_matches_jax(all_models):
    jm, jd, tm, td = all_models["demo"]
    jrt = JRuntime(jm, jd)
    rt = StreamingRuntime(tm, td)
    jc0, c0 = jrt.init(S), rt.init(S)
    j_leaves, j_def = jax.tree.flatten(jc0)
    t_leaves, t_def = jax.tree.flatten(c0)
    assert len(j_leaves) == len(t_leaves)
    rng = np.random.default_rng(11)
    vals = []
    for jl, tl in zip(j_leaves, t_leaves):
        assert tuple(jl.shape) == tuple(tl.shape)
        if jl.dtype == jnp.int32:
            vals.append(rng.integers(0, 4, jl.shape).astype(np.int32))
        else:
            vals.append(rng.standard_normal(jl.shape).astype(np.float32))
    jc = jax.tree.unflatten(j_def, [jnp.asarray(v) for v in vals])
    c = jax.tree.unflatten(t_def, [torch.from_numpy(v.copy()) for v in vals])

    jflat, flat = j_sp.carry_to_flat(jc), carry_to_flat(c)
    assert list(flat) == [k for k, _ in wc.CKEYS]
    for k, d in wc.CKEYS:
        assert tuple(flat[k].shape) == (S, d) and flat[k].is_contiguous(), k
        assert flat[k].dtype == torch.float32
        np.testing.assert_array_equal(flat[k].numpy(), np.asarray(jflat[k]), err_msg=k)

    back, jback = flat_to_carry(flat, c0), j_sp.flat_to_carry(jflat, jc0)
    for got, ref, orig in zip(jax.tree.leaves(back), jax.tree.leaves(jback), vals):
        assert tuple(got.shape) == tuple(ref.shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got.numpy(), orig)  # the round trip
    assert back.silence_ctr.dtype == torch.int32


# -- (d) the plain version against the JAX kernel ----------------------------


def test_cell_process_plain_matches_jax_kernel(models, audio):
    """Audio and all 11 carry arrays, from a non-initial carry, against the
    Pallas kernel in interpret mode and against cell_process_xla."""
    jm, jd, tm, td = models
    jrt = j_sp.PallasStreamingRuntime(jm, jd, matmul_dtype=jnp.float32, interpret=True)
    rt = WholeCellStreamingRuntime(tm, td, matmul_dtype=torch.float32, backend="plain")
    carry = _seeded_flat_carry(S, seed=5)
    before = (wc.cell_process.launches, wc.cell_process.frames)
    got_c, got = wc.cell_process(
        torch.from_numpy(audio), {k: torch.from_numpy(v.copy()) for k, v in carry.items()},
        rt.weights, rt.statics)
    assert (wc.cell_process.launches, wc.cell_process.frames) == before  # CPU: plain version
    jcarry = {k: jnp.asarray(v) for k, v in carry.items()}
    refs = {
        "pallas interpret": j_cell.cell_process(
            jnp.asarray(audio), jcarry, jrt.weights, jrt.statics, S, 2,
            mdtype=jnp.float32, interpret=True),
        "xla": j_cell.cell_process_xla(
            jnp.asarray(audio), jcarry, jrt.weights, jrt.statics, 2, mdtype=jnp.float32),
    }
    assert got.shape == audio.shape and torch.isfinite(got).all()
    for name, (ref_c, ref) in refs.items():
        # float32 on both sides, sums in another order: 1e-4 relative, 1e-5 absolute
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        for k, _ in wc.CKEYS:
            np.testing.assert_allclose(got_c[k].numpy(), np.asarray(ref_c[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name}: {k}")
    np.testing.assert_array_equal(got_c["sil"][:, 0].numpy(), 0.0)  # loud frames reset it
    np.testing.assert_array_equal(got_c["amem"].numpy(), audio[:, -HOP:])


# -- (e) the runtime ---------------------------------------------------------


@pytest.mark.parametrize("pset", list(PARAM_SETS))
def test_runtime_matches_jax_runtimes(models, audio, pset):
    jm, jd, tm, td = models
    frames = FRAMES if pset == "default" else 4
    x = audio[:, : frames * HOP]
    jparams = JRuntimeParams(**PARAM_SETS[pset])
    rt = WholeCellStreamingRuntime(tm, td, RuntimeParams(**PARAM_SETS[pset]),
                                   matmul_dtype=torch.float32, backend="plain")
    carry, got = rt.process(rt.init(S), x)
    assert got.shape == x.shape and torch.isfinite(got).all()
    jrts = {
        "whole-cell, pallas interpret": j_sp.PallasStreamingRuntime(
            jm, jd, jparams, matmul_dtype=jnp.float32, s_blk=S, chunk=2, interpret=True),
        "per-frame": JRuntime(jm, jd, jparams),
    }
    for name, jrt in jrts.items():
        jcarry, ref = jrt.process(jrt.init(S), jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=name, **RT_TOL)
        for f in CARRY_FIELDS:
            np.testing.assert_allclose(getattr(carry, f).numpy(), np.asarray(getattr(jcarry, f)),
                                       err_msg=f"{name}: {f}", **RT_TOL)
        for f in carry.model._fields:
            np.testing.assert_allclose(getattr(carry.model, f).numpy(),
                                       np.asarray(getattr(jcarry.model, f)),
                                       err_msg=f"{name}: {f}", **RT_TOL)
    assert carry.silence_ctr.dtype == torch.int32


@pytest.mark.parametrize("pset", list(PARAM_SETS))
def test_runtime_matches_port_per_frame_runtime(models, audio, pset):
    """The two runtimes of the port agree; `backend="kernel"` on a CPU model
    runs the plain version and moves neither counter."""
    _, _, tm, td = models
    params = RuntimeParams(**PARAM_SETS[pset])
    ref_rt = StreamingRuntime(tm, td, params)
    rc, ref = ref_rt.process(ref_rt.init(S), audio)
    before = (wc.cell_process.launches, wc.cell_process.frames)
    for backend in ("kernel", "plain"):
        rt = WholeCellStreamingRuntime(tm, td, params, matmul_dtype=torch.float32,
                                       backend=backend)
        c, got = rt.process(rt.init(S), audio)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **RT_TOL)
        for f in c.model._fields:
            np.testing.assert_allclose(getattr(c.model, f).numpy(), getattr(rc.model, f).numpy(),
                                       err_msg=f, **RT_TOL)
    assert (wc.cell_process.launches, wc.cell_process.frames) == before


@pytest.mark.parametrize("splits", [((0, 4), (4, 8)), ((0, 1), (1, 3), (3, 8))])
def test_chunk_continuity(all_models, audio, splits):
    """Calls that continue from the carry equal one call over all frames."""
    _, _, tm, td = all_models["demo"]
    rt = WholeCellStreamingRuntime(tm, td, matmul_dtype=torch.float32, backend="plain")
    c_full, full = rt.process(rt.init(S), audio)
    c, outs = rt.init(S), []
    for lo, hi in splits:
        step = rt.process_frame if hi - lo == 1 else rt.process
        c, o = step(c, audio[:, lo * HOP: hi * HOP])
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), rtol=1e-5, atol=1e-5)
    for a, b in zip(jax.tree.leaves(c), jax.tree.leaves(c_full)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_silence_skip(all_models):
    """Quiet frames count up across calls and mute the output after
    silence_skip_frames; a loud frame resets the counter; as the JAX runtime."""
    jm, jd, tm, td = all_models["demo"]
    rt = WholeCellStreamingRuntime(tm, td, matmul_dtype=torch.float32, backend="plain")
    z = np.zeros((2, FRAMES * HOP), np.float32)
    c, o1 = rt.process(rt.init(2), z[:, : 3 * HOP])
    assert c.silence_ctr.tolist() == [3, 3]
    c, o2 = rt.process(c, z[:, 3 * HOP:])
    assert c.silence_ctr.tolist() == [FRAMES, FRAMES] and c.silence_ctr.dtype == torch.int32
    out = torch.cat([o1, o2], 1)
    np.testing.assert_allclose(out[:, 6 * HOP:].numpy(), 0.0, atol=1e-12)
    jrt = j_sp.PallasStreamingRuntime(jm, jd, matmul_dtype=jnp.float32, s_blk=2, chunk=2,
                                      interpret=True)
    jc, jo = jrt.process(jrt.init(2), jnp.asarray(z))
    assert int(jc.silence_ctr[0]) == FRAMES
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), **RT_TOL)
    c, _ = rt.process(c, np.full((2, HOP), 0.5, np.float32))
    assert c.silence_ctr.tolist() == [0, 0]


def _construct(all_models, **kw):
    _, _, tm, td = all_models["demo"]
    return WholeCellStreamingRuntime(tm, td, **kw)


@pytest.mark.parametrize("case, exc", [
    ("reduce_mask", NotImplementedError),
    ("float16", NotImplementedError),
    ("run_df_false", NotImplementedError),
    ("backend", ValueError),
    ("partial_hop", ValueError),
])
def test_unsupported_raises(all_models, case, exc):
    _, _, tm, td = all_models["demo"]
    with pytest.raises(exc):
        if case == "reduce_mask":
            _construct(all_models, params=RuntimeParams(reduce_mask="max", n_channels=2))
        elif case == "float16":
            _construct(all_models, matmul_dtype=torch.float16)
        elif case == "run_df_false":
            mask_only = dataclasses.replace(tm, cfg=dict(tm.cfg, run_df=False))
            WholeCellStreamingRuntime(mask_only, td)
        elif case == "backend":
            _construct(all_models, backend="pallas")
        else:
            rt = _construct(all_models, backend="plain")
            rt.process(rt.init(1), np.zeros((1, 2 * HOP + 7), np.float32))


def test_reduce_mask_single_channel_is_accepted(all_models):
    """As in the JAX runtime, the refusal needs more than one channel."""
    _construct(all_models, params=RuntimeParams(reduce_mask="max", n_channels=1))


@pytest.mark.parametrize("case", ["dtype", "carry_shape", "weight_shape", "partial_hop",
                                  "audio_rank"])
def test_cell_process_checks_its_inputs(all_models, case):
    rt = _construct(all_models, backend="plain")
    x = torch.zeros((2, 2 * HOP))
    carry = carry_to_flat(rt.init(2))
    weights = dict(rt.weights)
    exc = ValueError
    if case == "dtype":
        x, exc = x.double(), TypeError
    elif case == "carry_shape":
        carry["ring_re"] = carry["ring_re"][:, :384]
    elif case == "weight_shape":
        weights["c1_w"] = weights["c1_w"][:1536]
    elif case == "partial_hop":
        x = x[:, :-3]
    else:
        x = x[0]
    with pytest.raises(exc):
        wc.cell_process(x, carry, weights, rt.statics)


def test_exports():
    import deepfilternet_torch as pkg
    from deepfilternet_torch import kernels, ops

    assert pkg.WholeCellStreamingRuntime is WholeCellStreamingRuntime
    assert ops.cell_process is wc.cell_process and ops.cell_process_plain is wc.cell_process_plain
    assert (kernels.SOURCE_DIR / kernels.SOURCES["whole_cell"]).is_file()


# -- the CUDA kernel ---------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the whole-cell CUDA kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 5, 37])
def test_cuda_kernel_matches_plain(cuda_device, s):
    """Kernel against plain version on the card, all 12 outputs, 1e-4 of
    each output's largest value (sums of up to 2048 terms in another order,
    through ~45 layers and three recurrences)."""
    _kernel_matches_plain(cuda_device, s)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 8, 16])
@pytest.mark.parametrize("s", [37, 70])
def test_cuda_float32_rows_design_matches_plain(cuda_device, monkeypatch, s, rows):
    """The float32 rows design, forced whatever S, with 4, 8 and 16 stream
    rows a block (37 and 70 streams leave a ragged last tile), against the
    plain version as above; 16 rows give the bits of 8."""
    monkeypatch.setattr(wc, "_kernel_choice", lambda *a: "rows")
    monkeypatch.setattr(wc, "_tile_rows", lambda *a: rows)
    got = _kernel_matches_plain(cuda_device, s)
    if rows == 16:
        monkeypatch.setattr(wc, "_tile_rows", lambda *a: 8)
        for k, v in _kernel_matches_plain(cuda_device, s).items():
            assert torch.equal(got[k], v), k


def _kernel_matches_plain(cuda_device, s):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tm, td, _ = init_df(MODEL_DIR, device=cuda_device)
    rt = WholeCellStreamingRuntime(tm, td, RuntimeParams(**STAGES), matmul_dtype=torch.float32)
    rng = np.random.default_rng(s)
    x = torch.from_numpy((rng.standard_normal((s, FRAMES * HOP)) * 0.1).astype(np.float32))
    x = x.to(cuda_device)
    carry = {k: torch.from_numpy(v).to(cuda_device) for k, v in _seeded_flat_carry(s, 3).items()}
    before = (wc.cell_process.launches, wc.cell_process.frames)
    got_c, got = wc.cell_process(x, carry, rt.weights, rt.statics)
    torch.cuda.synchronize()
    assert (wc.cell_process.launches, wc.cell_process.frames) == (before[0] + 1,
                                                                  before[1] + FRAMES)
    ref_c, ref = wc.cell_process_plain(x, carry, rt.weights, rt.statics)
    for name, a, b in [("audio", got, ref)] + [(k, got_c[k], ref_c[k]) for k, _ in wc.CKEYS]:
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name
    return dict(got_c, audio=got)
