"""The port's tracing (`deepfilternet_torch/utils/timings.py`): spans that
cost nothing with no profiler recording and name the layers' steps while one
records, the loader's summary under LOG_TIMINGS, the whole-cell kernel's
per-block stage records and their families, and the server's `stats()`.

Imports no JAX: the card's test (marked `cuda`) runs on a machine with the
card from the repository's root with
`python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py -m cuda`.
"""

import ctypes
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepfilternet_torch.enhance import enhance, init_df
from deepfilternet_torch.ops import whole_cell as wc
from deepfilternet_torch.streaming_whole_cell import WholeCellStreamingRuntime, carry_to_flat
from deepfilternet_torch.utils import timings

MODEL_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "pretrained", "dfn3_fixture_demo")
HOP = 480
ENHANCE_CHILDREN = ("enhance.pad", "enhance.h2d", "enhance.features", "enhance.forward",
                    "enhance.synthesis", "enhance.d2h", "enhance.trim")


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_config():
    """The port's config reset and torch on one CPU thread, as
    `tests/_torch_serving.py::port_config` (not imported: on the card's
    machine another package may own the name `tests`)."""
    from deepfilternet_torch.config import config

    config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _quiet_timings():
    """Each test starts with LOG_TIMINGS read as off, no timings and no K2
    records, and leaves them so."""
    from deepfilternet_torch.config import config

    def clear():
        config.set("LOG_TIMINGS", "false", section="train")
        timings.log_timings_enabled()
        timings.GLOBAL_TIMINGS.reset()
        timings.k2_clear()

    clear()
    yield
    clear()


@pytest.fixture(scope="module")
def model():
    return init_df(MODEL_DIR, device="cpu")[:2]


def ranges(prof):
    """{name: [(start ns, end ns), ...]} of the host events of a profile."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def all_threads_config():
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


# -- spans ---------------------------------------------------------------------


def test_span_off_is_one_shared_null_context(monkeypatch):
    """No profiler and LOG_TIMINGS off: every span is the same null context,
    no range is opened (record_function is never called) and nothing is
    timed."""
    def refuse(*a, **k):
        raise AssertionError("a range was opened with no profiler recording")

    monkeypatch.setattr(timings._profiler, "record_function", refuse)
    assert not timings.tracing()
    a, b = timings.span("enhance"), timings.span("k2.alloc")
    assert a is b is timings._OFF
    with timings.span("x"), timings.span("x.y"):
        pass
    assert timings.GLOBAL_TIMINGS.totals() == {}


def test_span_under_log_timings_adds_running_sums():
    from deepfilternet_torch.config import config

    config.set("LOG_TIMINGS", "true", section="train")
    assert timings.log_timings_enabled()
    for _ in range(1000):
        with timings.span("step"):
            pass
    acc = timings.GLOBAL_TIMINGS._acc["step"]
    assert acc[0] == 1000 and len(acc) == 3  # a count, a total, a largest: bounded
    assert "step:" in timings.GLOBAL_TIMINGS.summary()


def test_timings_from_many_threads_lose_no_update():
    """More threads than cores add to one Timings with a short switch
    interval: every addition is counted."""
    import sys

    t = timings.Timings()
    n_threads, n_adds = 2 * (os.cpu_count() or 2) + 2, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [t.add("x", 1e-3) for _ in range(n_adds)])
                   for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert t._acc["x"][0] == n_threads * n_adds
    assert t.totals()["x"] == pytest.approx(n_threads * n_adds * 1e-3)


def test_enhance_offline_emits_each_span_once_nested(model):
    tm, td = model
    audio = (np.random.default_rng(0).standard_normal((1, 8 * HOP)) * 0.1).astype(np.float32)
    quiet = enhance(tm, td, audio, backend="offline")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timings.tracing()
        traced = enhance(tm, td, audio, backend="offline")
    assert not timings.tracing()
    np.testing.assert_array_equal(traced, quiet)
    r = ranges(prof)
    assert len(r["enhance"]) == 1
    for name in ENHANCE_CHILDREN:
        assert len(r.get(name, [])) == 1, name
        assert inside(r[name][0], r["enhance"][0]), name
    starts = [r[name][0][0] for name in ENHANCE_CHILDREN]
    assert starts == sorted(starts)
    assert timings.GLOBAL_TIMINGS.totals() == {}


def test_whole_cell_process_spans_and_no_records_on_the_cpu(model):
    tm, td = model
    rt = WholeCellStreamingRuntime(tm, td, matmul_dtype=torch.float32, backend="plain")
    audio = torch.from_numpy(
        (np.random.default_rng(1).standard_normal((2, 2 * HOP)) * 0.1).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rt.process(rt.init(2), audio)
    r = ranges(prof)
    assert len(r["whole_cell.process"]) == 1
    for name in ("whole_cell.carry_in", "whole_cell.carry_out"):
        assert len(r[name]) == 1 and inside(r[name][0], r["whole_cell.process"][0]), name
    assert r["whole_cell.carry_in"][0][1] <= r["whole_cell.carry_out"][0][0]
    assert timings.k2_records() == []  # the plain version keeps no records


def test_record_buffer_only_while_a_profiler_records():
    """No profiler: no call records. Under one: the first call of the stretch
    and every RECORD_EVERY-th after it; a call with no profiler starts the
    count again."""
    dev = torch.device("cpu")
    assert wc._records(132, 14, dev, wc._record_this_call()) is None
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            wanted = [wc._record_this_call() for _ in range(2 * wc.RECORD_EVERY + 1)]
        assert wanted == [i % wc.RECORD_EVERY == 0 for i in range(len(wanted))]
        assert not wc._record_this_call()
    rec = wc._records(132, 14, dev, True)
    assert rec.dtype == torch.int64 and tuple(rec.shape) == (132, 17)


# -- the loader under LOG_TIMINGS ----------------------------------------------


class _TinyDataset:
    """Samples of the shapes `collate` stacks, drawn from the seed."""

    def __len__(self):
        return 8

    def get_sample(self, idx, seed):
        rng = np.random.default_rng(seed)
        t, tf, f = 960, 3, 481

        def cplx(shape):
            return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
                np.complex64)
        return dict(speech=rng.standard_normal((1, t)).astype(np.float32),
                    noisy=rng.standard_normal((1, t)).astype(np.float32),
                    spec_clean=cplx((1, tf, f)), spec_noisy=cplx((1, tf, f)),
                    feat_erb=rng.standard_normal((1, tf, 32)).astype(np.float32),
                    feat_spec=cplx((1, tf, 96)), max_freq=24000, snr=5, gain=0, idx=idx)


@pytest.mark.parametrize("log", [False, True])
def test_loader_adds_to_global_timings_only_under_log_timings(log):
    from deepfilternet_torch.config import config
    from deepfilternet_torch.data.dataloader import DataLoader

    config.set("LOG_TIMINGS", "true" if log else "false", section="train")
    loader = DataLoader(_TinyDataset(), batch_size=2, num_workers=2)
    batches = list(loader.iter_epoch("train", 3))
    assert len(batches) == 4
    totals = timings.GLOBAL_TIMINGS.totals()
    if log:
        assert set(totals) == {"dataloader.sample", "dataloader.collate"}
        assert timings.GLOBAL_TIMINGS._acc["dataloader.sample"][0] == 4
    else:
        assert totals == {}


# -- K2's stage families and records -------------------------------------------


@pytest.mark.parametrize("design", ["units", "rows"])
def test_families_split_the_stages(design):
    groups = wc.FAMILIES[design]
    assert set(groups) == {"gru", "conv", "dsp"}
    names = [n for g in groups.values() for n in g]
    assert len(names) == len(set(names))  # disjoint
    wait = {wc.WAIT_STAGE} if design == "units" else set()
    assert set(names) == set(wc.STAGES[design]) - wait
    fam = wc.stage_families(design)
    assert len(fam) == len(wc.STAGES[design])
    assert [n for n, f in zip(wc.STAGES[design], fam) if f == "wait"] == sorted(wait)


def test_a_test_build_of_a_kernel_is_a_library_of_its_own():
    """`kernels.load(name, defines)` (the card test's DFN_K2_PLANT build) keys
    its library by the defines too; with none, the path is the shipped one."""
    from deepfilternet_torch import kernels

    for name in ("whole_cell", "whole_cell_rows"):
        shipped, planted = (kernels.library_path(name),
                            kernels.library_path(name, ("DFN_K2_PLANT",)))
        assert shipped == kernels.library_path(name, ())
        assert planted != shipped and planted.parent == shipped.parent
    assert kernels._flags(("A",)) == kernels.NVCC_FLAGS + ("-DA",)


def test_k2_split_of_made_up_records():
    # 3 blocks, 4 stages (gru, conv, dsp, wait), 2 frames
    ns = np.array([[100, 50, 30, 20], [200, 60, 40, 0], [150, 40, 10, 0]], np.int64) * 1000
    start = np.array([1_000_000, 1_010_000, 1_000_000], np.int64)
    span = np.stack([start, start + ns.sum(axis=1)], axis=1)
    rec = dict(design="units", stages=("a", "b", "c", "d"), families=("gru", "conv", "dsp",
                                                                       "wait"),
               frames=2, ns=ns, span=span)
    sp = timings.k2_split(rec)
    assert sp["family_ms"] == pytest.approx(dict(gru=0.15, conv=0.05, dsp=0.02666667,
                                                 wait=0.00666667))
    call = (1_010_000 + 300_000) - 1_000_000
    assert sp["call_ms"] == pytest.approx(call * 1e-6)
    assert sp["busy"] == pytest.approx((200 + 300 + 200) * 1000 / (3 * call))
    np.testing.assert_allclose(sp["stage_median_ms"], [0.15, 0.05, 0.03, 0.0])
    np.testing.assert_allclose(sp["stage_max_ms"], [0.2, 0.06, 0.04, 0.02])


def test_k2_records_keep_the_last_calls_and_read_them_back():
    for i in range(timings.K2_KEEP + 5):
        rec = torch.full((2, 6), i, dtype=torch.int64)
        timings.k2_keep("rows", ("a", "b", "c"), ("gru", "conv", "dsp"), 10, rec)
    recs = timings.k2_records()
    assert len(recs) == timings.K2_KEEP
    first, last = recs[0], recs[-1]
    assert int(first["ns"][0, 0]) == 5 and int(last["span"][1, 1]) == timings.K2_KEEP + 4
    assert last["ns"].shape == (2, 3) and last["span"].shape == (2, 2)
    assert last["cycles"].shape == (2,) and int(last["cycles"][0]) == timings.K2_KEEP + 4
    assert last["families"] == ("gru", "conv", "dsp") and last["frames"] == 10


# -- the server ----------------------------------------------------------------


def test_server_stats_on_a_cpu_sharded_server(model):
    """A server whose slots are split over two CPU shards: stats() counts
    what the clients sent, and its spans show in a profile of all threads."""
    from deepfilternet_torch.parallel import Mesh
    from tests._torch_serving import stream, torch_server

    tm, td = model
    cpu = torch.device("cpu")
    audio = (np.random.default_rng(4).standard_normal((2, 3 * HOP)) * 0.1).astype(np.float32)
    with torch_server(tm, td, max_streams=4, mesh=Mesh((cpu, cpu)),
                      batch_window_ms=20.0) as srv:
        assert srv.stats()["tick_host_s"] == dict(count=0, p50=None, p95=None)
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=all_threads_config()) as prof:
            threads = [threading.Thread(target=stream, args=(srv.port, audio[i]))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
        assert not any(t.is_alive() for t in threads)
        st = srv.stats()
    assert st["frames"] == 2 * 3 and st["dispatches"] >= 3 and st["graph_replays"] == 0
    assert st["tick_host_s"]["count"] == st["dispatches"]
    assert st["dispatch_s"]["count"] == st["dispatches"]
    assert st["queue_wait_s"]["count"] == st["frames"]
    for key in ("tick_host_s", "dispatch_s", "queue_wait_s"):
        assert 0.0 <= st[key]["p50"] <= st[key]["p95"]
    r = ranges(prof)
    for name in ("serve.handler_wait", "serve.queue", "serve.submit", "serve.fetch",
                 "serve.reply"):
        assert len(r.get(name, [])) >= 2, name
    for q in r["serve.queue"]:
        assert any(inside(q, w) for w in r["serve.handler_wait"])


# -- the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K2's records are written by its CUDA kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_records_change_no_output_and_add_up(cuda_device, dtype, monkeypatch):
    """K2 with and without the record buffer, each design and build: the 12
    outputs bit for bit the same; each block's stages add up to within 2% of
    its own span of the global timer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tm, td, _ = init_df(MODEL_DIR, device=cuda_device)
    rt = WholeCellStreamingRuntime(tm, td, matmul_dtype=getattr(torch, dtype))
    s, frames = 64, 6
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.standard_normal((s, frames * HOP)) * 0.1).astype(np.float32))
    x = x.to(cuda_device)
    carry = carry_to_flat(rt.init(s))
    rows_options = (4, 8, 16) if dtype == "bfloat16" else (4, 8)
    for design, rows in [("units", None)] + [("rows", r) for r in rows_options]:
        monkeypatch.setattr(wc, "_kernel_choice", lambda *a, d=design: d)
        if rows is not None:
            monkeypatch.setattr(wc, "_tile_rows", lambda *a, r=rows: r)
        timings.k2_clear()
        c0, o0 = wc.cell_process(x, carry, rt.weights, rt.statics)
        torch.cuda.synchronize()
        assert timings.k2_records() == []
        with profile(activities=[ProfilerActivity.CPU]):
            c1, o1 = wc.cell_process(x, carry, rt.weights, rt.statics)
        torch.cuda.synchronize()
        tag = f"{design} {rows} {dtype}"
        assert torch.equal(o0, o1), tag
        for k, _ in wc.CKEYS:
            assert torch.equal(c0[k], c1[k]), (tag, k)
        (rec,) = timings.k2_records()
        assert rec["design"] == design and rec["frames"] == frames
        assert rec["ns"].shape[1] == len(wc.STAGES[design])
        blocks = torch.cuda.get_device_properties(cuda_device).multi_processor_count \
            if design == "units" else -(-s // rows)
        assert rec["ns"].shape[0] == blocks, tag
        own = (rec["span"][:, 1] - rec["span"][:, 0]).astype(np.float64)
        total = rec["ns"].sum(axis=1).astype(np.float64)
        assert (own > 0).all() and (rec["ns"] >= 0).all(), tag
        np.testing.assert_allclose(total, own, rtol=0.02, err_msg=tag)


def _max_sm_clock_ghz():
    """The card's highest SM clock (nvidia-smi), or the H100's 1.98 GHz."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=30).stdout.split()
        return float(out[0]) * 1e-3
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return 1.98


def _stage_counts(design, s, frames, rows, n_blocks):
    """How often each block closes each stage in one call: [blocks, stages]."""
    if design == "rows":
        tiles = np.array([len(range(b, -(-s // rows), n_blocks)) for b in range(n_blocks)])
        counts = np.repeat((frames * tiles)[:, None], len(wc.STAGES["rows"]), axis=1)
        counts[:, -1] = tiles + 1  # the carry: at each tile's start, then once at the end
        return counts
    from deepfilternet_torch.ops import whole_cell_plan as plan

    _, info = plan.cached_plan(s, n_blocks, False)
    n_pre = len(plan.PRE_PHASES)
    counts = np.zeros((n_blocks, len(wc.STAGES["units"])), np.int64)
    for ph in range(len(wc.STAGES["units"]) - 1):
        total = sum(u for *_, u in info["phases"][n_pre + ph])
        counts[:, ph] = [frames * len(range(int(info["ranks"][ph, b]), total, n_blocks))
                         for b in range(n_blocks)]
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["units", "rows"])
def test_cuda_records_hold_to_the_sm_clock_the_profiler_and_a_planted_stage(
        cuda_device, design, monkeypatch):
    """Checks of K2's records (float32) that do not lean on their own scale:
    each block's SM cycles over its span of the global timer lie at the card's
    SM clock; the call's span in the records (first start to last end) lies
    within the launch's time between two CUDA events around it (the stream
    kept busy while the host enqueues it, so the events bracket the kernel
    and, in the units design, its two small fills); and in a test build
    (DFN_K2_PLANT) that spends a known stretch of the global timer at the end
    of one stage, each stage in turn gains that stretch times the number of
    times the block closes it, and no other stage gains a tenth as much (the
    units design's waits on producers aside)."""
    from deepfilternet_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    tm, td, _ = init_df(MODEL_DIR, device=cuda_device)
    rt = WholeCellStreamingRuntime(tm, td, matmul_dtype=torch.float32)
    s, frames, rows, plant_ns = 64, 24, 8, 100_000
    rng = np.random.default_rng(12)
    x = torch.from_numpy((rng.standard_normal((s, frames * HOP)) * 0.1).astype(np.float32))
    x = x.to(cuda_device)
    carry = carry_to_flat(rt.init(s))
    monkeypatch.setattr(wc, "_kernel_choice", lambda *a: design)
    monkeypatch.setattr(wc, "_tile_rows", lambda *a: rows)
    wc.cell_process(x, carry, rt.weights, rt.statics)  # built and loaded

    timings.k2_clear()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU]):
        torch.cuda._sleep(50_000_000)  # ~25 ms of SM cycles: busy while the call is enqueued
        start.record()
        wc.cell_process(x, carry, rt.weights, rt.statics)
        end.record()
    end.synchronize()
    (rec,) = timings.k2_records()
    launch = start.elapsed_time(end) * 1e6  # ns
    call = int(rec["span"][:, 1].max() - rec["span"][:, 0].min())
    # the units design's records leave out its carry phases (~2% here)
    assert 0.95 * launch <= call <= launch, (call, launch)

    ghz = rec["cycles"] / (rec["span"][:, 1] - rec["span"][:, 0])
    top = _max_sm_clock_ghz()
    assert (ghz >= 0.7 * top).all() and (ghz <= 1.02 * top).all(), (ghz.min(), ghz.max(), top)
    assert ghz.max() <= 1.02 * ghz.min()

    name = "whole_cell" if design == "units" else "whole_cell_rows"
    planted = kernels.load(name, ("DFN_K2_PLANT",))
    real_load = kernels.load
    monkeypatch.setattr(kernels, "load", lambda n, d=(): planted if n == name and not d
                        else real_load(n, d))
    n_stages = len(wc.STAGES[design]) - (design == "units")
    counts = _stage_counts(design, s, frames, rows, rec["ns"].shape[0])

    monkeypatch.setattr(wc, "RECORD_EVERY", 1)  # every traced call records

    def stage_ns(stage):
        assert planted.dfn_k2_plant(stage, ctypes.c_longlong(plant_ns)) == 0
        timings.k2_clear()
        with profile(activities=[ProfilerActivity.CPU]):
            wc.cell_process(x, carry, rt.weights, rt.statics)
        (r,) = timings.k2_records()
        return r["ns"].astype(np.float64)

    base = stage_ns(-1)
    for k in range(n_stages):
        gained = stage_ns(k) - base
        want = plant_ns * counts[:, k]
        tag = f"{design}: {wc.STAGES[design][k]}"
        np.testing.assert_allclose(gained[:, k], want, rtol=0.05, atol=5_000, err_msg=tag)
        # no other stage gains a tenth of it (the units design's waits on producers,
        # which grow with the planted delays of other blocks, left out)
        others = np.delete(gained[:, :n_stages], k, axis=1).sum(axis=0)
        assert (others <= 0.1 * gained[:, k].sum()).all(), (tag, others.max())


def test_serve_hop_has_no_queue_event_without_a_profiler():
    """A hop's `taken` event, which only the span `serve.queue` waits on, is
    made only while a profiler records: untraced, a handler waits on one event."""
    from deepfilternet_torch.serve import _Req

    hop = np.zeros(HOP, np.float32)
    assert _Req(hop).taken is None
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _Req(hop)
    assert isinstance(traced.taken, threading.Event) and not traced.taken.is_set()
