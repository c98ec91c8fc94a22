"""What surrounds the port's two CUDA kernels, on the CPU: the Python that
decides tiles, work units, scratch sizes and weight layouts, and the numerics
the kernels rely on. No test here needs a GPU; the kernels themselves are
held against their plain versions on the card by `chip_smoke.py`.

  * K1 (`ops/fused_frontend.py`): the tile chooser and scratch shapes; the
    packed DFT chunks; the TF32 hi/lo operand split and the three-term
    product, emulated bit for bit in PyTorch;
  * K2 (`ops/whole_cell.py`, `ops/whole_cell_plan.py`): the design chooser;
    the work plan (every output of every product owned by exactly one unit,
    no job touching what another job of its phase writes); the edges between
    jobs that take the place of grid barriers (every conflict ordered, every
    edge backward in the global unit order, units in any order the edges
    allow equal to the phase order bit for bit, any edge dropped caught);
    the plan executed with plain tensor operations against
    `cell_process_plain`; the packed weights, including the transposed DFT
    of the synthesis product; the reordering of `h @ w_hh` that the plan
    relies on;
  * K2's bfloat16 builds on the tensor cores: the design and row choices by
    operand type, the bfloat16 plan, and the units' B-fragment and the rows'
    A-fragment packs read back lane by lane as the kernels address them.
"""

import gc
import inspect
import weakref

import numpy as np
import pytest

pytest.importorskip("jax")  # collected and counted like the other port tests
torch = pytest.importorskip("torch")

from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.enhance import init_df  # noqa: E402
from deepfilternet_torch.ops import fused_frontend as ff  # noqa: E402
from deepfilternet_torch.ops import whole_cell as wc  # noqa: E402
from deepfilternet_torch.ops import whole_cell_plan as wp  # noqa: E402
from deepfilternet_torch.ops.stft import dft_matrices  # noqa: E402
from deepfilternet_torch.streaming import RuntimeParams  # noqa: E402
from deepfilternet_torch.streaming_whole_cell import (  # noqa: E402
    WholeCellStreamingRuntime,
    carry_to_flat,
)

MODEL_DIR = "pretrained/dfn3_fixture_demo"
HOP = 480
N_SM = 132  # an H100's multiprocessors
STREAMS = (1, 16, 17, 37, 64, 528, 529, 1056, 1100, 4096)
STAGES = dict(atten_lim_db=12.0, post_filter_beta=0.02, lsnr_gating=True)


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_config():
    t_config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runtimes():
    """float32 operands ("default", "stages") and bfloat16 ones ("bf16 ...")."""
    model, df_state, _ = init_df(MODEL_DIR, device="cpu")
    return {f"{prefix}{name}": WholeCellStreamingRuntime(
                model, df_state, RuntimeParams(**kw), matmul_dtype=dtype, backend="plain")
            for prefix, dtype in (("", torch.float32), ("bf16 ", torch.bfloat16))
            for name, kw in (("default", {}), ("stages", STAGES))}


# -- K1 ----------------------------------------------------------------------


@pytest.mark.parametrize("s", STREAMS)
def test_frontend_tile_covers_every_stream_and_bin(s):
    rows, bins = ff._frontend_tile(s, N_SM)
    assert (rows, bins) in (ff._TILE_SMALL, ff._TILE_LARGE)
    fp, f, nb_erb = 512, 481, 32
    assert fp % bins == 0
    grid = (-(-s // rows), fp // bins)
    # every (stream, bin) lies in exactly one block's tile
    owner = np.zeros((s, f), np.int32)
    for i in range(grid[0]):
        for j in range(grid[1]):
            owner[i * rows: (i + 1) * rows, j * bins: (j + 1) * bins] += 1
    assert (owner == 1).all()
    # the large tile only once its grid fills the card; the small one starts
    # 8 times the blocks where it would not
    if (rows, bins) == ff._TILE_LARGE:
        assert grid[0] * grid[1] >= N_SM
    else:
        big = ff._TILE_LARGE
        assert -(-s // big[0]) * (fp // big[1]) < N_SM
    band, done = ff._frontend_scratch(s, (rows, bins), fp, nb_erb)
    assert band == (grid[1], s, nb_erb) and done == (grid[0],)


@pytest.mark.parametrize("bins", [ff._TILE_SMALL[1], ff._TILE_LARGE[1]])
def test_packed_dft_holds_the_chunks(bins):
    cpu = torch.device("cpu")
    cos_p, sin_p = ff._padded_dft_tensors(960, 480, cpu)
    packed = ff._packed_dft(960, 480, bins, cpu)
    assert packed.shape == (512 // bins, 960, 2 * bins + 8) and packed.is_contiguous()
    for c in range(512 // bins):
        assert torch.equal(packed[c, :, :bins], cos_p[:, c * bins: (c + 1) * bins])
        assert torch.equal(packed[c, :, bins: 2 * bins], sin_p[:, c * bins: (c + 1) * bins])
    assert not packed[:, :, 2 * bins:].any()
    # a K-slice of a chunk is a whole number of 16-byte units (one bulk copy)
    assert (32 * (2 * bins + 8) * 4) % 16 == 0


# (fft, hop): the default, DFN3-ll, 75% overlap, D and H not multiples of 32
# (244, 236), D and H not multiples of 4 (242, 238)
GEOMETRIES = [(960, 480), (480, 240), (960, 240), (480, 236), (480, 238)]


@pytest.mark.parametrize("bins", [ff._TILE_SMALL[1], ff._TILE_LARGE[1]])
@pytest.mark.parametrize("fft,hop", GEOMETRIES)
def test_packed_dft_slices_walk_like_the_kernel(fft, hop, bins):
    """The kernel's K loop over the packed DFT, emulated in float64: every
    K-slice taken from mem or frame alone (`slice_at`), columns past the
    source zero-filled, new_mem written by index. The spectrum equals the
    plain analysis to float32 rounding, and new_mem equals it exactly, at
    any fft / hop (the padded rows of mem start frame's on a slice)."""
    from deepfilternet_torch.ops.stft import Stft, analysis_step_ri

    rng = np.random.default_rng(fft + hop)
    s, d, ks = 5, fft - hop, ff._KS
    mem = torch.from_numpy((rng.standard_normal((s, d)) * 0.1).astype(np.float32))
    frame = torch.from_numpy((rng.standard_normal((s, hop)) * 0.1).astype(np.float32))
    packed = ff._packed_dft(fft, hop, bins, torch.device("cpu")).double()
    chunks, k_rows, _ = packed.shape
    dp = ff._k_rows(d)
    assert k_rows == dp + ff._k_rows(hop) and dp % ks == 0 and k_rows % ks == 0
    re = torch.zeros((s, chunks, bins), dtype=torch.float64)
    im = torch.zeros_like(re)
    new_mem = torch.full((s, d), float("nan"))
    for k0 in range(0, k_rows, ks):
        src, length, col0, b0 = (mem, d, k0, k0) if k0 < dp else (frame, hop, k0 - dp,
                                                                    d + k0 - dp)
        a = torch.zeros((s, ks), dtype=torch.float64)
        n = max(0, min(ks, length - col0))
        a[:, :n] = src[:, col0: col0 + n].double()
        rows = packed[:, k0: k0 + ks]
        re += torch.einsum("sk,ckb->scb", a, rows[..., :bins])
        im += torch.einsum("sk,ckb->scb", a, rows[..., bins: 2 * bins])
        for c in range(n):
            if b0 + c >= hop:
                new_mem[:, b0 + c - hop] = a[:, c].float()
    f = fft // 2 + 1
    want_mem, want_re, want_im = analysis_step_ri(mem, frame, Stft(48000, fft, hop))
    assert torch.equal(new_mem, want_mem)
    for got, want in ((re, want_re), (im, want_im)):
        got = got.reshape(s, -1)
        assert not got[:, f:].any()
        err = float((got[:, :f] - want.double()).abs().max())
        assert err <= 1e-5 * float(want.abs().max())


def test_tf32_split_of_the_dft_matrices():
    cs = torch.tensor(np.concatenate(dft_matrices(960, 480), axis=1))
    hi, lo = ff.tf32_split(cs)
    # hi keeps at most 10 mantissa bits: its low 13 bits are clear
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    # hi + lo gives the float32 value back to 2^-21 of it (lo is cut to TF32,
    # which loses at most 2^-10 of a value that is at most 2^-11 of x)
    err = ((hi.double() + lo.double()) - cs.double()).abs()
    assert (err <= cs.double().abs() * 2.0 ** -21).all()
    # lo is what rounding hi to the nearest left over: at most half a TF32 ulp
    assert (lo.abs() <= hi.abs() * 2.0 ** -11 + 1e-45).all()


@pytest.mark.parametrize("s", [16, 64])
def test_three_term_tf32_product_holds_float32_accuracy(s):
    """The kernel's product a_lo*b_hi + a_hi*b_lo + a_hi*b_hi on seeded audio
    against a float64 product at K = 960: within 1e-5 of the largest value
    (the limit the card check holds K1 to), with more than 2x head-room, and
    about as good as a plain float32 product. One TF32 pass alone is not."""
    rng = np.random.default_rng(s)
    a = torch.from_numpy((rng.standard_normal((s, 960)) * 0.1).astype(np.float32))
    b = torch.tensor(np.concatenate(dft_matrices(960, 480), axis=1))
    ref = a.double() @ b.double()
    a_hi, a_lo = ff.tf32_split(a)
    b_hi, b_lo = ff.tf32_split(b)
    got = (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
    scale = float(ref.abs().max())
    err = float((got.double() - ref).abs().max()) / scale
    plain = float(((a @ b).double() - ref).abs().max()) / scale
    one_pass = float(((a_hi @ b_hi).double() - ref).abs().max()) / scale
    assert err < 5e-6          # 2x under the 1e-5 limit
    assert err < 4 * plain     # float32-like
    assert one_pass > 1e-5     # plain TF32 would fail the limit


# -- K2 ----------------------------------------------------------------------


@pytest.mark.parametrize("s", STREAMS)
def test_kernel_choice_and_rows(s):
    design = wc._kernel_choice(s, N_SM)
    tiles = -(-s // wp.RT)
    # measured on an H100: the units design is ahead up to 8 tiles of 64 streams
    assert design == ("units" if tiles <= 8 else "rows")
    assert wc._tile_rows(s, N_SM) == (4 if -(-s // 4) <= N_SM else 8 if -(-s // 8) <= N_SM
                                      else 16)
    assert set(wc.STAGES) == {"units", "rows"}
    assert wc.STAGES["units"][-1] == "waiting on producers"


@pytest.mark.parametrize("s", STREAMS)
def test_plan_units_own_every_output_once(s):
    table, info = wp.plan(s, N_SM)
    t = wp.decode(table)
    tiles = -(-s // wp.RT)
    assert info["blocks"] == N_SM and info["tiles"] == tiles == int(t.header[wp.H_TILES])
    assert info["scratch_shape"] == (tiles, wp.SCR, wp.RT) and tiles * wp.RT >= s
    assert int(t.header[wp.H_SCR]) == wp.SCR and info["n_stages"] == len(wp.STAGES)
    assert len(table) <= 3072  # the kernel's shared-memory copy of the table
    assert [int(x) for x in t.lay] == [wp.OFF[n] for n, _ in wp.LAYOUT]
    for first, count, n_units in t.phases:
        jobs = t.jobs[first: first + count]
        # units of a phase are numbered job after job without gaps
        assert int(jobs[0][wp.J_BEGIN]) == 0
        assert all(int(a[wp.J_BEGIN] + a[wp.J_UNITS]) == int(b[wp.J_BEGIN])
                   for a, b in zip(jobs[:-1], jobs[1:]))
        assert int(jobs[-1][wp.J_BEGIN] + jobs[-1][wp.J_UNITS]) == n_units
        for j in jobs:
            if j[wp.J_TYPE] != wp.T_GEMM:
                assert int(j[wp.J_UNITS]) == int(j[wp.J_AUX]) * tiles
                continue
            ncat, stride, cw, n_slices = (int(j[i]) for i in (
                wp.J_NCAT, wp.J_CSTRIDE, wp.J_CW, wp.J_SLICES))
            n = cw * n_slices
            cnt = ncat * cw
            assert cw % 4 == 0 and cnt <= wp.MAX_CNT and int(j[wp.J_K]) % 32 == 0
            # every (tile, output column) of the product is owned by one unit
            owned = np.zeros((tiles, max(ncat * stride, n)), np.int32)
            for u in range(int(j[wp.J_BEGIN]), int(j[wp.J_BEGIN] + j[wp.J_UNITS])):
                tile, cols = wp.unit_columns(j, u, tiles)
                owned[tile, cols] += 1
            want = np.zeros_like(owned)
            for c in range(ncat):
                want[:, c * stride: c * stride + n] = 1
            assert (owned == want).all()
            # the unit's threads: K groups x 8 row groups x column groups
            mc, kg = int(j[wp.J_AUX]), int(j[wp.J_KG])
            assert mc in (2, 8) and cnt % mc == 0
            assert kg * 8 * cnt // mc <= wp.THREADS and 32 % kg == 0
            assert kg * cnt * wp.RT <= wp.THREADS * wp.RT  # the reduction tile


def test_plan_spreads_small_s_over_the_card():
    """At S = 64 (one tile) the big products are cut into about one unit a
    multiprocessor, not one unit a tile."""
    _, info = wp.plan(64, N_SM)
    units = {name: n for ph in info["phases"] for name, _, _, n in ph}
    assert units["dft"] + 5 * units["enc_whh"] <= N_SM
    assert units["c0"] >= 64 and units["c1"] >= 64 and units["synthesis"] >= 64
    assert len(wp.frame_phases()) == 18  # phases a frame


@pytest.mark.parametrize("pset", ["default", "stages"])
@pytest.mark.parametrize("s", [3, 70])
def test_plan_executed_plain_matches_cell_process_plain(runtimes, pset, s):
    """The plan's table run with plain tensor operations (`run_plan`: phase by
    phase, each product on its packed weight, each epilogue as the kernel
    writes it) against `cell_process_plain`, from a non-initial carry, with a
    silent stretch. 1e-5 of each output's largest value: same arithmetic in
    another order of products. No job reads or writes what another job of its
    phase writes."""
    rt = runtimes[pset]
    frames = 6
    rng = np.random.default_rng(s)
    x = torch.from_numpy((rng.standard_normal((s, (4 + frames) * HOP)) * 0.1).astype(np.float32))
    x[:, 6 * HOP: 8 * HOP] = 0.0
    carry, _ = wc.cell_process_plain(x[:, : 4 * HOP].contiguous(), carry_to_flat(rt.init(s)),
                                     rt.weights, rt.statics)
    xc = x[:, 4 * HOP:].contiguous()
    ref_c, ref_o = wc.cell_process_plain(xc, carry, rt.weights, rt.statics)
    table, info = wp.plan(s, N_SM)
    packed = wp.pack_weights(rt.weights, info)
    hazards = []
    got_c, got_o = wp.run_plan(table, xc, carry, rt.weights, rt.statics, packed, hazards=hazards)
    assert hazards == []
    for name, ref in dict(ref_c, audio=ref_o).items():
        got = got_o if name == "audio" else got_c[name]
        tol = 1e-5 * max(float(ref.abs().max()), 1e-30)
        assert float((got - ref).abs().max()) <= tol, name


def test_run_plan_reports_a_hazard(runtimes):
    """The hazard check is live: a plan whose e1 is moved into e0's phase
    (e1 reads what e0 writes) is reported."""
    rt = runtimes["default"]
    table, info = wp.plan(2, N_SM)
    t = wp.decode(table)
    n_pre = int(t.header[wp.H_PRE])
    bad = table.copy()
    a = wp.HEADER_INTS + len(t.lay) + t.segs.size
    phases = bad[a: a + t.phases.size].reshape(-1, wp.PHASE_INTS)
    # phase "e0, df_conv1" takes the first job of the next phase (e1) as well
    assert wp.frame_phases()[3][1][0].name == "e1"
    phases[n_pre + 2][1] += 1
    x = torch.zeros((2, HOP))
    hazards = []
    wp.run_plan(bad, x, carry_to_flat(rt.init(2)), rt.weights, rt.statics,
                wp.pack_weights(rt.weights, info), hazards=hazards)
    assert any(pi == n_pre + 2 for pi, _, _ in hazards)


def _frame_rows(t):
    n_pre, n_fp = int(t.header[wp.H_PRE]), int(t.header[wp.H_FRAME_PHASES])
    return list(range(int(t.phases[n_pre][0]), int(t.phases[n_pre + n_fp][0])))


def _reach(t, frame_rows):
    """{(row, frame): nodes reachable from it} over the table's edges, two
    frames unrolled."""
    succ = {}
    for b in frame_rows:
        for a, _, off in wp.job_deps(t, b):
            for f in (0, 1):
                if f + off >= 0:
                    succ.setdefault((int(a), f + int(off)), []).append((b, f))
    reach = {}
    for node in [(r, f) for r in frame_rows for f in (0, 1)]:
        seen, todo = set(), [node]
        while todo:
            for nxt in succ.get(todo.pop(), ()):
                if nxt not in seen:
                    seen.add(nxt)
                    todo.append(nxt)
        reach[node] = seen
    return reach


@pytest.mark.parametrize("s", [1, 130])
def test_plan_edges_order_every_conflict_and_point_backward(runtimes, s):
    """The edges that take the place of the grid barriers. Each frame job's
    columns as the plan states them (`job_access`) are those the plan's
    plain run reads and writes. Every two jobs that conflict there (one
    writes what the other reads or writes; a job with itself a frame apart)
    are ordered by a path of edges, the earlier of the frame order first
    within a frame and the later one of the frame before first across
    frames. Every edge points backward in the global unit order: each
    producer's units in the tile lie before the first unit that waits for
    them. The edges are stated per tile: a counter per job and tile, and a
    producer's count a frame is its units in one tile; the same edges at
    1 and 3 tiles."""
    rt = runtimes["stages"]  # gating on: the tail reads the LSNR
    table, info = wp.plan(s, N_SM)
    t = wp.decode(table)
    tiles = int(t.header[wp.H_TILES])
    rows = _frame_rows(t)
    x = torch.from_numpy(np.random.default_rng(s).standard_normal((s, 2 * HOP))
                         .astype(np.float32) * 0.1)
    accesses = {}
    wp.run_plan(table, x, carry_to_flat(rt.init(s)), rt.weights, rt.statics,
                wp.pack_weights(rt.weights, info), accesses=accesses)
    acc = {}
    for r in rows:
        reads, writes = wp.job_access(t.jobs[r])
        assert set(np.flatnonzero(reads)) == accesses[r][0], info["names"][r]
        assert set(np.flatnonzero(writes)) == accesses[r][1], info["names"][r]
        acc[r] = (reads, writes)
    reach = _reach(t, rows)
    for i, a in enumerate(rows):
        for b in rows[i:]:
            (ra, wa), (rb, wb) = acc[a], acc[b]
            if not ((rb & wa).any() or (wb & ra).any() or (wb & wa).any()):
                continue
            if a != b:
                assert (b, 1) in reach[(a, 1)], (info["names"][a], info["names"][b])
            assert (a, 1) in reach[(b, 0)], (info["names"][b], info["names"][a])
    order = list(wp.unit_order(table, 3))
    last = {}
    for i, (f, ji, tile, _) in enumerate(order):
        last[(f, ji, tile)] = i
    for i, (f, ji, tile, _) in enumerate(order):
        for a, per, off in wp.job_deps(t, ji):
            if f + off >= 0:
                assert last[(f + int(off), int(a), tile)] < i
    assert info["n_counters"] == 1 + len(t.jobs) * tiles
    # each frame phase deals its units over every block once (a permutation)
    assert t.ranks.shape == (len(wp.frame_phases()), N_SM)
    assert all(sorted(r) == list(range(N_SM)) for r in t.ranks)
    assert all(int(per) == int(t.jobs[int(a)][wp.J_UNITS]) // tiles for a, per, _ in t.deps)
    t64 = wp.decode(wp.plan(64, N_SM)[0])
    assert {b: [(int(a), int(o)) for a, _, o in wp.job_deps(t, b)] for b in rows} == \
        {b: [(int(a), int(o)) for a, _, o in wp.job_deps(t64, b)] for b in rows}
    # pre- and post-phase jobs wait at grid barriers, not on counters
    assert all(int(t.jobs[r][wp.J_NDEP]) == 0 for r in range(len(t.jobs)) if r not in rows)


def _plan_inputs(rt, s, frames=3):
    rng = np.random.default_rng(s)
    x = torch.from_numpy((rng.standard_normal((s, (2 + frames) * HOP)) * 0.1).astype(np.float32))
    carry, _ = wc.cell_process_plain(x[:, : 2 * HOP].contiguous(), carry_to_flat(rt.init(s)),
                                     rt.weights, rt.statics)
    return x[:, 2 * HOP:].contiguous(), carry


def _same(a, b):
    (ca, oa), (cb, ob) = a, b
    return torch.equal(oa, ob) and all(torch.equal(ca[k], cb[k]) for k in ca)


@pytest.mark.parametrize("pset", ["stages", "bf16 stages"])
@pytest.mark.parametrize("s", [1, 37, 64, 130])
def test_units_in_any_order_the_edges_allow_equal_the_phase_order(runtimes, pset, s):
    """The plan run unit by unit over 3 frames from a non-initial carry: in
    a seeded random order among the units whose producers' counters are
    reached, as the kernel's blocks may meet them, it equals the global
    order bit for bit, and no read finds another version than the phase
    order leaves there."""
    rt = runtimes[pset]
    xc, carry = _plan_inputs(rt, s)
    table, info = wp.plan(s, N_SM, bf16=pset.startswith("bf16"))
    packed = wp.pack_weights(rt.weights, info)
    phase_order = wp.run_plan(table, xc, carry, rt.weights, rt.statics, packed,
                              schedule="phase")
    hazards = []
    got = wp.run_plan(table, xc, carry, rt.weights, rt.statics, packed, hazards=hazards,
                      schedule=s)
    assert hazards == []
    assert _same(phase_order, got)
    out = got[1]
    assert out.shape == xc.shape and bool(torch.isfinite(out).all())


def _drop_edge(table, ji, k):
    """The table with edge k of job row ji taken out."""
    bad = table.copy()
    t = wp.decode(bad)
    a = wp.HEADER_INTS + t.lay.size + t.segs.size + t.phases.size  # the first job row
    jobs = bad[a: a + t.jobs.size].reshape(-1, wp.JOB_INTS)
    deps = bad[a + t.jobs.size: a + t.jobs.size + t.deps.size].reshape(-1, wp.DEP_INTS)
    first, n = int(jobs[ji][wp.J_DEP0]), int(jobs[ji][wp.J_NDEP])
    deps[[first + k, first + n - 1]] = deps[[first + n - 1, first + k]]
    jobs[ji][wp.J_NDEP] -= 1
    return bad


# a sample of the plan's 50 edges: reads across frames and within one,
# writes after reads (the tail's spectrum and mute, the next frame's
# overlap), an elementwise producer and consumer, a decoder pathway addend
DROPPED = [("dft", "advance"), ("enc_gru", "enc_whh"), ("e3", "gl"), ("erb_inv", "synthesis"),
           ("advance", "erb_inv"), ("t1", "p0")]


@pytest.mark.parametrize("consumer,producer", DROPPED)
def test_dropping_an_edge_is_caught(runtimes, consumer, producer):
    """Each sampled edge is needed: with it taken out of the table, the unit
    run that puts off the producer's first frame while anything else can run
    reports a read at another version than the phase order's (with the edge
    in, any order the edges allow reports none:
    `test_units_in_any_order_the_edges_allow_equal_the_phase_order`)."""
    rt = runtimes["stages"]
    s = 1
    xc, carry = _plan_inputs(rt, s, frames=2)  # an edge from the frame before needs two
    table, info = wp.plan(s, N_SM)
    t = wp.decode(table)
    names = info["names"]
    b = names.index(consumer)
    k = [names[int(d[wp.D_JOB])] for d in wp.job_deps(t, b)].index(producer)
    packed = wp.pack_weights(rt.weights, info)
    hazards = []
    wp.run_plan(_drop_edge(table, b, k), xc, carry, rt.weights, rt.statics, packed,
                hazards=hazards, schedule=(0, names.index(producer)))
    assert hazards


@pytest.mark.parametrize("pset", ["default", "bf16 default"])
def test_packed_weights_hold_every_product_and_leave_the_set_alone(runtimes, pset):
    rt = runtimes[pset]
    keys_before = list(rt.weights)
    for s in (64, 4096):
        table, info = wp.plan(s, N_SM)
        packed = wp.pack_weights(rt.weights, info)
        # in the products' operand type; offsets count elements
        assert packed.numel() == info["pack_floats"] and packed.dtype == rt.weights["dft"].dtype
        jobs = [j for j in wp.decode(table).jobs if j[wp.J_TYPE] == wp.T_GEMM]
        assert len(jobs) == len(info["packing"])
        for j, pk in zip(jobs, info["packing"]):
            assert int(j[wp.J_W]) == pk.offset and pk.offset % 4 == 0
            w = torch.cat([rt.weights["dft"].T if k == "dft_t" else rt.weights[k]
                           for k in pk.keys], dim=0)
            got = wp.unpack_weight(packed, j)
            for c in range(pk.ncat):
                assert torch.equal(got[:, c], w[:, c * pk.cat_stride: c * pk.cat_stride + pk.n])
    # the synthesis product's weight is dft transposed, [1024, 960]
    syn = next(pk for pk in info["packing"] if pk.keys == ("dft_t",))
    assert (syn.k, syn.ncat * syn.n) == (2 * wc.FPAD, wc.FFT)
    # the weight set keeps its keys and shapes: it compares with the JAX
    # package key by key
    assert list(rt.weights) == keys_before == wc.WKEYS
    assert all(tuple(rt.weights[k].shape) == wc.WSHAPES[k] for k in wc.WKEYS)
    assert "dft_t" not in wc.WKEYS and "dft_t" not in wc.WSHAPES


def test_packed_weights_are_cached_per_weight_set_and_plan(runtimes):
    rt = runtimes["default"]
    a = wc.packed_weights(rt.weights, 64, N_SM)
    assert wc.packed_weights(rt.weights, 33, N_SM) is a       # same tiles, same plan
    assert wc.packed_weights(rt.weights, 4096, N_SM) is not a
    # found again by the identity of every tensor of the set
    other = dict(rt.weights, e0_w=rt.weights["e0_w"].clone())
    assert wc.packed_weights(other, 64, N_SM) is not a
    assert wc.packed_weights(rt.weights, 64, N_SM) is a


@pytest.mark.parametrize("pset", ["default", "stages", "bf16 default"])
def test_hidden_products_first_is_bit_equal(runtimes, pset, monkeypatch):
    """The kernel computes every h @ w_hh of the frame in the frame's first
    phase, from last frame's state, beside the analysis DFT. In
    `cell_process_plain`'s arithmetic that reordering changes no bit: with
    all five products made before the rest of the frame and handed to the GRU
    cells, outputs and carry are equal."""
    rt = runtimes[pset]
    W, st = rt.weights, rt.statics
    s, frames = 3, 5
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.standard_normal((s, frames * HOP)) * 0.1).astype(np.float32))
    carry = carry_to_flat(rt.init(s))
    ref_c, ref_o = wc.cell_process_plain(x, carry, W, st)

    own_step, own_cell = wc._frame_step, wc._gru_cell
    pre = {}

    def frame_step(W_, P_, st_, state, frame):
        # the frame's five h @ w_hh, before anything else of the frame, found
        # again by the layer's b_hh
        pre.clear()
        for h_key, layer in (("enc_h", "enc_"), ("dec_h", "dec_"), ("dfh0", "df_"),
                             ("dfh1", "df_"), ("dfh2", "df_")):
            sfx = h_key[-1] if h_key.startswith("dfh") else ""
            pre[id(W_[f"{layer}bhh{sfx}"])] = P_.mm(state[h_key], f"{layer}whh{sfx}")
        return own_step(W_, P_, st_, state, frame)

    def gru_cell(h, gi, gh, b_hh):
        made_first = pre[id(b_hh)]  # made at the top of the frame
        assert torch.equal(made_first, gh)
        return own_cell(h, gi, made_first, b_hh)

    monkeypatch.setattr(wc, "_frame_step", frame_step)
    monkeypatch.setattr(wc, "_gru_cell", gru_cell)
    got_c, got_o = wc.cell_process_plain(x, carry, W, st)
    assert own_cell is not gru_cell
    assert torch.equal(got_o, ref_o)
    for k in ref_c:
        assert torch.equal(got_c[k], ref_c[k]), k


# -- K2's bfloat16 build: tensor-core plans and packs -------------------------


@pytest.mark.parametrize("s", STREAMS)
def test_kernel_choice_and_rows_by_operand_type(s):
    """Both builds' choices, which take no operand type: the same design
    crossover (units up to 8 tiles of 64 streams), and the smallest tile of 4
    or 8 stream rows whose tiles the multiprocessors hold at once, else 16,
    in the float32 build as in the bfloat16 one."""
    tiles = -(-s // wp.RT)
    assert wc._kernel_choice(s, N_SM) == ("units" if tiles <= 8 else "rows")
    fits = [r for r in (4, 8) if -(-s // r) <= N_SM]
    assert wc._tile_rows(s, N_SM) == (fits[0] if fits else 16)
    assert list(inspect.signature(wc._tile_rows).parameters) == ["s", "n_sm"]


@pytest.mark.parametrize("s, rows", [(528, 4), (529, 8), (1056, 8), (1057, 16), (4096, 16)])
def test_tile_rows_at_the_thresholds(s, rows):
    """Where 8 and 16 rows a block start on 132 multiprocessors: 529 streams
    (133 tiles of 4), 1057 (133 tiles of 8)."""
    assert wc._tile_rows(s, N_SM) == rows


@pytest.mark.parametrize("s", STREAMS)
def test_bf16_plan_packs_whole_n8_tiles(s):
    """The bfloat16 plan: the float32 plan's jobs, phases, slices and units
    (a slice of 4 or 12 columns stays, so the epilogues keep their
    parallelism), four K groups (the k16 steps of a chunk) and no register
    tile; every unit's packed weight slice is whole n8 tiles of the tensor
    cores, ncat x cw padded to a multiple of 8, and the packed products lie
    one after the other."""
    table, info = wp.plan(s, N_SM, bf16=True)
    table32, info32 = wp.plan(s, N_SM)
    t, t32 = wp.decode(table), wp.decode(table32)
    assert info["bf16"] and not info32["bf16"] and len(table) <= 3072
    assert (t.phases == t32.phases).all()
    fields = [f for f in range(wp.JOB_INTS) if f not in (wp.J_W, wp.J_KG, wp.J_AUX)]
    assert (t.jobs[:, fields] == t32.jobs[:, fields]).all()
    off = 0
    for j in t.jobs:
        if j[wp.J_TYPE] != wp.T_GEMM:
            continue
        cnt = int(j[wp.J_NCAT] * j[wp.J_CW])
        cp = wp.packed_cols(cnt, True)
        assert cp % 8 == 0 and cnt <= cp < cnt + 8 and cp <= wp.MAX_CNT
        assert int(j[wp.J_KG]) == wp.MMA_K_GROUPS == 4 and int(j[wp.J_AUX]) == 0
        assert int(j[wp.J_W]) == off
        off += int(j[wp.J_SLICES]) * int(j[wp.J_K]) * cp
    assert off == info["pack_floats"]


def test_bf16_plan_spreads_small_s_over_the_card():
    """Restricted to n8 tiles, the bfloat16 plan still cuts the big products
    at S = 64 into about one unit a multiprocessor."""
    _, info = wp.plan(64, N_SM, bf16=True)
    units = {name: n for ph in info["phases"] for name, _, _, n in ph}
    assert units["dft"] + 5 * units["enc_whh"] <= N_SM
    assert units["c0"] >= 64 and units["c1"] >= 64 and units["synthesis"] >= 64


def _lanes():
    lane = np.arange(32)
    return lane // 4, lane % 4


@pytest.mark.parametrize("s", [64, 4096])
def test_bf16_units_pack_read_lane_by_lane(runtimes, s):
    """The units' bfloat16 pack read the way the kernel's lanes load it: the
    B fragment of (unit slice, k16 step, n8 tile) is lane l's 4 values at
    ((step * tiles + tile) * 32 + l) * 4 of the slice, holding k rows 2t,
    2t + 1, 2t + 8, 2t + 9 of the step and column g of the tile (g = l // 4,
    t = l % 4); each equals the weight there, or 0 past the slice's own
    columns."""
    rt = runtimes["bf16 default"]
    table, info = wp.plan(s, N_SM, bf16=True)
    packed = wp.pack_weights(rt.weights, info)
    assert packed.dtype == torch.bfloat16 and packed.numel() == info["pack_floats"]
    buf = packed.float().numpy()
    g, t = _lanes()
    jobs = [j for j in wp.decode(table).jobs if j[wp.J_TYPE] == wp.T_GEMM]
    for j, pk in zip(jobs, info["packing"]):
        w = torch.cat([rt.weights["dft"].T if k == "dft_t" else rt.weights[k]
                       for k in pk.keys], dim=0).float().numpy()
        k, ncat, cw, n_slices = (int(j[i]) for i in (wp.J_K, wp.J_NCAT, wp.J_CW, wp.J_SLICES))
        cnt, stride = ncat * cw, int(j[wp.J_CSTRIDE])
        tiles = -(-cnt // 8)
        for sl in range(n_slices):
            base = int(j[wp.J_W]) + sl * k * tiles * 8
            for e in range(4):
                kk = 2 * t + (e & 1) + 8 * (e >> 1)                       # [32]
                step, tile = np.meshgrid(np.arange(k // 16), np.arange(tiles), indexing="ij")
                addr = base + ((step[..., None] * tiles + tile[..., None]) * 32
                               + np.arange(32)) * 4 + e
                c = tile[..., None] * 8 + g                               # column in the slice
                col = (c // cw) * stride + sl * cw + c % cw
                col = np.minimum(col, w.shape[1] - 1)                     # pad: any column
                want = np.where(c < cnt, w[step[..., None] * 16 + kk, col], 0.0)
                assert np.array_equal(buf[addr], want), (pk.keys, sl, e)


def test_bf16_rows_pack_read_lane_by_lane(runtimes):
    """The rows design's bfloat16 pack read the way the kernel's lanes load
    it: the A fragment of (16 output columns mt, k16 step) is lane l's 8
    values at ((mt * K / 16 + step) * 32 + l) * 8 of the product, holding
    column g (values 0, 1, 4, 5) and g + 8 (2, 3, 6, 7) at k rows 2t, 2t + 1
    (0-3) and 2t + 8, 2t + 9 (4-7) of the step; each equals the weight. Every
    product of the plan is there once, df_conv0's three segments stacked."""
    rt = runtimes["bf16 default"]
    packed, offsets = wp.pack_rows_weights(rt.weights)
    assert packed.dtype == torch.bfloat16 and len(offsets) == len(wc.WKEYS) + 1
    buf = packed.float().numpy()
    g, t = _lanes()
    total = 0
    for keys in wp.ROWS_PRODUCTS:
        w = torch.cat([rt.weights["dft"].T if k == "dft_t" else rt.weights[k]
                       for k in keys], dim=0).float().numpy()
        k, n = w.shape
        off = offsets[len(wc.WKEYS) if keys == ("dft_t",) else wc.WKEYS.index(keys[0])]
        assert off % 8 == 0
        mt, step = np.meshgrid(np.arange(n // 16), np.arange(k // 16), indexing="ij")
        for e in range(8):
            kk = 2 * t + (e & 1) + 8 * (e >> 2)
            col = mt[..., None] * 16 + g + 8 * ((e >> 1) & 1)
            addr = off + ((mt[..., None] * (k // 16) + step[..., None]) * 32
                          + np.arange(32)) * 8 + e
            assert np.array_equal(buf[addr], w[step[..., None] * 16 + kk, col]), (keys, e)
        total += k * n
    assert total == packed.numel()
    assert {keys for keys in wp.ROWS_PRODUCTS} >= {("c0w_t0", "c0w_t1", "c0w_t2"), ("dft_t",)}
    assert sum(o >= 0 for o in offsets) == len(wp.ROWS_PRODUCTS)


def test_rows_float32_dft_t_copy_is_made_once_per_weight_set(runtimes):
    """The float32 rows build's synthesis weight: `dft` transposed and
    contiguous, made once per weight set, no key of it, dropped with it."""
    weights = {k: v.clone() for k, v in runtimes["default"].weights.items()}
    t = wc.rows_dft_t(weights)
    assert t.dtype == torch.float32 and t.shape == (1024, 960) and t.is_contiguous()
    assert torch.equal(t, weights["dft"].T)
    assert wc.rows_dft_t(weights) is t
    assert "dft_t" not in wc.WKEYS and set(weights) == set(runtimes["default"].weights)
    key = tuple(id(weights[k]) for k in wc.WKEYS)
    assert key in wc._PACKED
    copy = weakref.ref(t)
    del weights, t
    gc.collect()
    assert key not in wc._PACKED and copy() is None


def test_rows_and_units_copies_are_cached_per_weight_set(runtimes):
    rt = runtimes["bf16 default"]
    a = wc.packed_rows_weights(rt.weights)
    assert wc.packed_rows_weights(rt.weights) is a
    u = wc.packed_weights(rt.weights, 64, N_SM)
    assert u.dtype == torch.bfloat16 and wc.packed_weights(rt.weights, 64, N_SM) is u
    with pytest.raises(TypeError):
        wp.pack_rows_weights(runtimes["default"].weights)
    with pytest.raises(TypeError):
        wp.pack_weights(runtimes["default"].weights, wp.plan(64, N_SM, bf16=True)[1])
