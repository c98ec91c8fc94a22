"""The whole cell at the configuration's DSP geometry: DFN3-ll (FFT 480,
hop 240, 48 DF bins: a 5 ms hop and delay) beside DFN3's default (960 /
480 / 96), at the default widths (GRUs of 256, 16 conv channels), seeded
random weights.

  * the plain version at DFN3-ll against the port's per-frame
    `StreamingRuntime` over chained calls, and against the benchmark's plain
    reference (`benchmark/reference/stream.py::stream_block`), each at 1e-4;
  * `WholeCellStreamingRuntime` at DFN3-ll at its default bfloat16
    operands against the per-frame runtime;
  * `build_cell_weights` shapes at both geometries, the carry's widths;
  * `cell_process` refusing, before it runs, a geometry or width the rows
    kernel is not built for;
  * the count of weight bytes a rows launch streams;
  * on a card (`cuda`): the rows kernel forced against the plain version at
    DFN3-ll, both builds, and the runtime's choice of design there.

No JAX: `tests/test_torch_configs.py` holds the per-frame runtime at DFN3-ll
to the JAX package, and JAX's whole cell takes DFN3's geometry only.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepfilternet_torch.config import config  # noqa: E402
from deepfilternet_torch.enhance import init_df  # noqa: E402
from deepfilternet_torch.ops import whole_cell as wc  # noqa: E402
from deepfilternet_torch.ops import whole_cell_check as chk  # noqa: E402
from deepfilternet_torch.streaming import StreamingRuntime  # noqa: E402
from deepfilternet_torch.streaming_whole_cell import (  # noqa: E402
    WholeCellStreamingRuntime,
    carry_to_flat,
    flat_to_carry,
)

LOW_LATENCY = {"FFT_SIZE": "480", "HOP_SIZE": "240", "NB_DF": "48"}
E2E = 1e-4
S, HOP_LL = 3, 240


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.reset()


def _model(keys, seed=7, device="cpu"):
    """(model, df_state) of a seeded random DFN3 at the default widths with
    the DF section's `keys`."""
    config.reset()
    config.load(None, allow_reload=True)
    for k, v in keys.items():
        config.set(k, v, section="DF")
    torch.manual_seed(seed)
    model, df_state, _ = init_df(None, device=device)
    return model, df_state


@pytest.fixture(scope="module")
def ll():
    model, df_state = _model(LOW_LATENCY)
    assert (df_state.fft_size, df_state.hop_size, model.cfg["nb_df"]) == (480, 240, 48)
    rts = {dt: WholeCellStreamingRuntime(model, df_state, matmul_dtype=dt)
           for dt in (torch.float32, torch.bfloat16)}
    return model, df_state, rts


@pytest.fixture(scope="module")
def dfn3_weights():
    model, df_state = _model({})
    return {dt: WholeCellStreamingRuntime(model, df_state, matmul_dtype=dt, backend="plain")
            for dt in (torch.float32, torch.bfloat16)}


def _audio(rows, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    tone = 0.1 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * np.sin(2 * np.pi * 660.0 * t)
    return torch.from_numpy((tone[None] + rng.standard_normal((rows, n)) * 0.05)
                            .astype(np.float32))


def _rel(got, ref):
    if not ref.is_complex():
        got, ref = got.float(), ref.float()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


# -- the plain version at DFN3-ll ----------------------------------------------


def test_plain_matches_per_frame_runtime(ll):
    """Three chained calls of 5, 1 and 6 hops from a fresh carry: audio and
    every carry leaf of the plain whole cell (float32) within 1e-4 of the
    per-frame runtime's, each over its largest value."""
    model, df_state, _ = ll
    rt = StreamingRuntime(model, df_state)
    wrt = WholeCellStreamingRuntime(model, df_state, matmul_dtype=torch.float32, backend="plain")
    x = _audio(S, 12 * HOP_LL, 3)
    c, w = rt.init(S), wrt.init(S)
    for lo, hi in ((0, 5), (5, 6), (6, 12)):
        a = x[:, lo * HOP_LL: hi * HOP_LL]
        c, ref = rt.process(c, a)
        w, got = wrt.process(w, a)
        assert got.shape == a.shape
        assert _rel(got, ref) <= E2E, (lo, _rel(got, ref))
    for name in ("analysis_mem", "synthesis_mem", "mean_norm", "unit_norm"):
        assert _rel(getattr(w, name), getattr(c, name)) <= E2E, name
    assert torch.equal(w.silence_ctr, c.silence_ctr)
    for name in c.model._fields:
        ref = getattr(c.model, name)
        if ref.numel():
            assert _rel(getattr(w.model, name), ref) <= E2E, name


def test_plain_matches_benchmark_reference(ll):
    """The plain whole cell at DFN3-ll on the benchmark's seeded weights and
    audio against its plain reference's `stream_block`, two calls of 4 hops:
    the plain reference is DFN3-ll's reference too."""
    from benchmark import common
    from benchmark.reference import stream as ref

    conf = common.load_config("dfn3_ll")
    assert (conf["fft_size"], conf["hop_size"], conf["nb_df"]) == (480, 240, 48)
    W = common.seeded_weights(conf, 11, "cpu")
    model, df_state = common.port_model(conf, W[0], W[1], "cpu")
    rt = WholeCellStreamingRuntime(model, df_state, matmul_dtype=torch.float32, backend="plain")
    audio = common.speech_like(2, 8 * HOP_LL, 11, "cpu")
    c_port, c_ref = rt.init(2), ref.init_carry(conf, 2, "cpu")
    with torch.no_grad():
        for k in range(2):
            a = audio[:, k * 4 * HOP_LL:(k + 1) * 4 * HOP_LL]
            c_port, o_port = rt.process(c_port, a)
            c_ref, o_ref = ref.stream_block(W, conf, c_ref, a)
            assert _rel(o_port, o_ref) <= E2E, k
    m = c_port.model
    port = dict(analysis_mem=c_port.analysis_mem, synthesis_mem=c_port.synthesis_mem,
                mean_norm=c_port.mean_norm, unit_norm=c_port.unit_norm, enc_h=m.enc_gru_h,
                dec_h=m.dec_gru_h, df_h=m.df_gru_h, erb_buf=m.erb_buf, spec_buf=m.spec_buf,
                ring=torch.complex(m.df_ring_re, m.df_ring_im))
    for name, v in port.items():
        assert _rel(v.to(c_ref[name].dtype), c_ref[name]) <= E2E, name


def test_default_runtime_bfloat16_near_per_frame(ll):
    """`WholeCellStreamingRuntime(model, df_state)` at DFN3-ll takes its
    default bfloat16 products: 12 hops in two calls within 5e-2 of the
    float32 per-frame runtime's largest output (bfloat16's rounding; the
    float32 whole cell meets 1e-4 above)."""
    model, df_state, rts = ll
    rt = WholeCellStreamingRuntime(model, df_state)
    assert rt.matmul_dtype == torch.bfloat16 and rt.weights["dft"].dtype == torch.bfloat16
    ref_rt = StreamingRuntime(model, df_state)
    x = _audio(S, 12 * HOP_LL, 5)
    c, w = ref_rt.init(S), rt.init(S)
    for lo, hi in ((0, 4), (4, 12)):
        c, ref = ref_rt.process(c, x[:, lo * HOP_LL: hi * HOP_LL])
        w, got = rt.process(w, x[:, lo * HOP_LL: hi * HOP_LL])
        assert torch.isfinite(got).all() and _rel(got, ref) <= 5e-2, _rel(got, ref)


def test_flat_carry_round_trip_ll(ll):
    """The runtime's carry to the kernel's flat layout and back, at 48 DF
    bins padded to 64 lanes."""
    model, df_state, rts = ll
    rt = rts[torch.float32]
    c, _ = rt.process(rt.init(2), _audio(2, 3 * HOP_LL, 9))
    flat = carry_to_flat(c)
    g = wc.geometry_of(rt.weights, rt.statics)
    assert {k: v.shape[1] for k, v in flat.items()} == dict(wc.carry_widths(g))
    back = flat_to_carry(flat, c)
    for name in c.model._fields:
        assert torch.equal(getattr(back.model, name).float(), getattr(c.model, name).float()), name


# -- the weight set's shapes ----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_cell_weights_shapes(ll, dfn3_weights, dtype):
    dt = getattr(torch, dtype)
    want = {  # the keys that follow the geometry
        "dfn3": {"dft": (960, 1024), "imult": (1, 512), "erb_fwd": (512, 32),
                 "erb_inv": (32, 512), "c0w_t0": (192, 2048), "c0_b": (1, 2048),
                 "c1_w": (2048, 768), "c1_b": (1, 768), "gl_w": (768, 128),
                 "df_out_w": (256, 1280)},
        "dfn3_ll": {"dft": (480, 512), "imult": (1, 256), "erb_fwd": (256, 32),
                    "erb_inv": (32, 256), "c0w_t0": (96, 1024), "c0_b": (1, 1024),
                    "c1_w": (1024, 384), "c1_b": (1, 384), "gl_w": (384, 128),
                    "df_out_w": (256, 640)},
    }
    geos = {"dfn3": (960, 480, 96, 512, 128), "dfn3_ll": (480, 240, 48, 256, 64)}
    for name, rt in (("dfn3", dfn3_weights[dt]), ("dfn3_ll", ll[2][dt])):
        g = wc.geometry_of(rt.weights, rt.statics)
        assert tuple(g) == geos[name] and g == wc.cell_geometry(*geos[name][:3])
        shapes = wc.weight_shapes(g)
        for k in wc.WKEYS:
            w = rt.weights[k]
            assert tuple(w.shape) == shapes[k], (name, k)
            assert w.dtype == wc.weight_dtype(k, dt) and w.is_contiguous(), (name, k)
            if k in want[name]:
                assert tuple(w.shape) == want[name][k], (name, k)
    assert wc.weight_shapes(wc.DFN3_GEOMETRY) == wc.WSHAPES
    # the rest are the model's widths, DFN3's at both geometries
    ll_shapes = wc.weight_shapes(wc.cell_geometry(480, 240, 48))
    moved = {k for k in wc.WKEYS if ll_shapes[k] != wc.WSHAPES[k]}
    assert moved == set(want["dfn3_ll"]) | {"c0w_t1", "c0w_t2"}
    assert wc.carry_widths(wc.DFN3_GEOMETRY) == wc.CKEYS
    ll_widths = dict(wc.carry_widths(wc.cell_geometry(480, 240, 48)))
    assert (ll_widths["amem"], ll_widths["norms"], ll_widths["spec_ctx"],
            ll_widths["ring_re"]) == (240, 80, 192, 256)


# -- what the rows kernel refuses ---------------------------------------------------


def _bad_inputs(ll, case):
    _, _, rts = ll
    rt = rts[torch.float32]
    W, st = dict(rt.weights), rt.statics
    if case == "df_bins_not_whole_8":
        st = st._replace(nb_df=44)
    elif case == "df_bins_beyond_blk":
        st = st._replace(nb_df=80)
    elif case == "bins_beyond_fpad":
        W["dft"] = W["dft"][:, :256].contiguous()  # FPAD 128 for 241 bins
    elif case == "erb_bands":
        st = st._replace(nb_erb=24)
    elif case == "df_order":
        st = st._replace(df_order=3)
    carry = carry_to_flat(rt.init(2))
    return _audio(2, 2 * HOP_LL, 1), carry, W, st


@pytest.mark.parametrize("case", ["df_bins_not_whole_8", "df_bins_beyond_blk",
                                  "bins_beyond_fpad", "erb_bands", "df_order"])
def test_cell_process_refuses_geometry_outside_the_build(ll, case, monkeypatch):
    """A geometry or width the rows kernel is not built for raises ValueError
    in `cell_process` before anything runs (here: before the plain version,
    which the CPU would run)."""
    ran = []
    monkeypatch.setattr(wc, "cell_process_plain", lambda *a, **k: ran.append(1))
    x, carry, W, st = _bad_inputs(ll, case)
    with pytest.raises(ValueError):
        wc.cell_process(x, carry, W, st)
    assert not ran


def test_rows_geometry_checks():
    ok = wc.cell_geometry(480, 240, 48)
    st = SimpleNamespace(nb_erb=32, df_order=5)
    wc.check_rows_geometry(ok, st)
    wc.check_rows_geometry(wc.DFN3_GEOMETRY, st)
    for g in (ok._replace(hop=236, fft=472), ok._replace(fft=400), ok._replace(nb_df=124),
              ok._replace(nb_df=44), ok._replace(nb_df=128, blk=128)):
        with pytest.raises(ValueError):
            wc.check_rows_geometry(g, st)
    with pytest.raises(ValueError):
        wc.cell_geometry(480, 238, 48)  # FFT = 2 x hop, or no whole cell
    assert wc.rows_defines(wc.DFN3_GEOMETRY) == ()
    assert wc.rows_defines(ok) == ("DFN_K2_HOP=240", "DFN_K2_FPAD=256", "DFN_K2_NB_DF=48",
                                   "DFN_K2_BLK=64")


def test_whole_cell_runtime_refuses_fft_not_twice_hop():
    model, df_state = _model({"FFT_SIZE": "480", "HOP_SIZE": "160", "NB_DF": "48"})
    with pytest.raises(ValueError):
        WholeCellStreamingRuntime(model, df_state, matmul_dtype=torch.float32)


# -- the weight bytes a rows launch streams ----------------------------------------


def test_weight_bytes_counter(ll, dfn3_weights):
    """`rows_weight_bytes`: the float32 build reads every weight key and the
    `dft^T` copy; the bfloat16 build its packed products and the keys no
    product reads. A launch streams them once a tile and frame, and the
    benchmark's `k2_weight_tbps.stream` divides that by K2's time a call."""
    from benchmark import harness
    from benchmark.common import ROOT
    from deepfilternet_torch.ops import whole_cell_plan as plan

    def nbytes(t):
        return t.numel() * t.element_size()

    got = {}
    for name, rts in (("dfn3", dfn3_weights), ("dfn3_ll", ll[2])):
        for dt, rt in rts.items():
            W = rt.weights
            if dt == torch.float32:
                want = sum(nbytes(W[k]) for k in wc.WKEYS) + nbytes(W["dft"])
            else:
                used = {k for keys in plan.ROWS_PRODUCTS for k in keys}
                products = sum(math.prod((W["dft"].T if k == "dft_t" else W[k]).shape)
                               for keys in plan.ROWS_PRODUCTS for k in keys)
                want = 2 * products + sum(nbytes(W[k]) for k in wc.WKEYS if k not in used)
            got[name, dt] = wc.rows_weight_bytes(W)
            assert got[name, dt] == want, (name, dt)
            assert wc.rows_stream_bytes(W, 4096, 8, 400) == want * 512 * 400
            assert wc.rows_stream_bytes(W, 37, 8, 3) == want * 5 * 3  # ragged last tile
    assert got["dfn3", torch.float32] == 32_431_940
    assert got["dfn3_ll", torch.float32] == 17_352_004
    read = harness.load_module(ROOT / "metrics" / "k2_weight_tbps.stream.py").read
    ctx = SimpleNamespace(k2_per_call=0.5)
    saved = wc.cell_process.weight_bytes
    try:
        wc.cell_process.weight_bytes = 3_000_000_000_000
        assert read(ctx) == pytest.approx(6.0)
        wc.cell_process.weight_bytes = 0  # a units launch
        assert read(ctx) is None
        wc.cell_process.weight_bytes = 10
        assert read(SimpleNamespace(k2_per_call=None)) is None
    finally:
        wc.cell_process.weight_bytes = saved


@pytest.mark.parametrize("rows", [4, 8, 16])
def test_rows_stream_bytes_by_tile(dfn3_weights, rows):
    """A tile of `rows` streams reads the build's weight buffers once a
    frame: 16 rows at S=4096 read them 256 times a frame, half as often as 8,
    and a ragged last tile counts whole."""
    for rt in dfn3_weights.values():
        once = wc.rows_weight_bytes(rt.weights)
        for s, frames in ((4096, 400), (37, 3), (1100, 20)):
            assert wc.rows_stream_bytes(rt.weights, s, rows, frames) == \
                once * -(-s // rows) * frames
        assert wc.rows_stream_bytes(rt.weights, 4096, rows, 1) == once * 4096 // rows


@pytest.mark.parametrize("rows", [0, 4, 8, 16])
def test_launch_counts_its_tile(dfn3_weights, rows):
    """A launch's counters (`_count_launch`, which `cell_process` calls after
    every launch on a card): one launch, its frames, its tile's stream rows
    in `cell_process.tile_rows` and the weight bytes it streams; a units
    launch (rows 0) sets both to 0."""
    names = ("launches", "bf16_launches", "frames", "tile_rows", "weight_bytes")
    saved = {k: getattr(wc.cell_process, k) for k in names}
    try:
        for dt, rt in dfn3_weights.items():
            before = {k: getattr(wc.cell_process, k) for k in names}
            wc._count_launch(rt.weights, 4096, 20, dt == torch.bfloat16, rows)
            assert wc.cell_process.launches == before["launches"] + 1
            assert wc.cell_process.bf16_launches == before["bf16_launches"] + (
                dt == torch.bfloat16)
            assert wc.cell_process.frames == before["frames"] + 20
            assert wc.cell_process.tile_rows == rows
            assert wc.cell_process.weight_bytes == (
                wc.rows_stream_bytes(rt.weights, 4096, rows, 20) if rows else 0)
    finally:
        for k, v in saved.items():
            setattr(wc.cell_process, k, v)


# -- on a card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the rows kernel is CUDA code with no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [37, 70])
def test_cuda_rows_at_low_latency_matches_plain(cuda_device, dtype, s, monkeypatch):
    """The rows kernel at DFN3-ll, each tile size its build has, against the
    plain version on the card (TF32 off), 16 frames from a carry warmed by
    8 plain frames: float32 within 1e-4 of each output's largest value,
    bfloat16 within `whole_cell_check.BF16_BOUNDS["frames"]`. The wrapper
    picks rows at this geometry at every S."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, df_state = _model(LOW_LATENCY, device=cuda_device)
    dt = getattr(torch, dtype)
    rt = WholeCellStreamingRuntime(model, df_state, matmul_dtype=dt)
    g = wc.geometry_of(rt.weights, rt.statics)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert g.hop == 240 and wc._kernel_choice(s, n_sm, g) == "rows"
    x = _audio(s, 24 * HOP_LL, 2).to(cuda_device)
    carry, _ = wc.cell_process_plain(x[:, :8 * HOP_LL].contiguous(),
                                     carry_to_flat(rt.init(s)), rt.weights, rt.statics)
    xr = x[:, 8 * HOP_LL:].contiguous()
    ref = wc.cell_process_plain(xr, carry, rt.weights, rt.statics)
    outs = {}
    for rows in (4, 8, 16):
        monkeypatch.setattr(wc, "_tile_rows", lambda *a, r=rows: r)
        launches = wc.cell_process.launches
        got = wc.cell_process(xr, carry, rt.weights, rt.statics)
        assert wc.cell_process.launches == launches + 1
        errs = chk.cell_errors(got, ref)
        if dt == torch.float32:
            assert max(e for e, _ in errs.values()) <= 1e-4, (rows, errs)
        else:
            assert not chk.out_of_bounds(errs, chk.BF16_BOUNDS["frames"]), (rows, errs)
        assert wc.cell_process.tile_rows == rows
        assert wc.cell_process.weight_bytes == wc.rows_stream_bytes(rt.weights, s, rows, 16)
        outs[rows] = dict(got[0], audio=got[1])
    if dt == torch.float32:  # each row's sums run as at 8 rows: the same bits
        for k, v in outs[8].items():
            assert torch.equal(outs[16][k], v), k
