"""The offline forward replayed from CUDA graphs (`enhance.py::_ForwardGraphs`).

On the CPU, with the capture and the replay replaced by a stub (a "graph" is
the forward over copies of the weights and cfg taken at capture, so a replay
the stamp should have refused gives the old weights' output):

  * a shape's calls before the `CAPTURE_AT`-th run eagerly, that one
    captures, the next replays, each with the eager forward's output;
  * whatever the forward reads changing (a weight edited in place, new
    weight tensors, a cfg switch edited in place, a new cfg) drops the
    graphs and starts over;
  * a new shape gets a graph of its own, and a model keeps at most
    `FORWARD_GRAPHS` of them, least recently used evicted;
  * a capture that raises leaves the model eager, at every shape and after a
    weight edit, until its cfg changes;
  * autograd on the weights keeps the forward eager;
  * threads sharing a model: one at a time uses the graphs, the others run
    eagerly, every output right;
  * the spans `enhance.forward.capture` and `enhance.forward.replay`;
  * the counter goes on when a wrapper takes `enhance`'s place;
  * on a CPU model the graph path is never taken, and `enhance()` returns
    bit for bit what the offline path computes without it.

On a card (`cuda`): DFN2 at the benchmark's widths and DFN3, each at two
shapes, replayed against eager bit for bit; a weight edited in place; a
forward that cannot be captured (DeepFilterNet-MF solving for its filter);
the counter over N calls at one shape; refused captures at several shapes
leave the card's reserved memory where the first left it. No JAX, so that the card's machine
runs them: `python -m pytest --noconftest tests/test_torch_offline_graph.py`.
"""

import dataclasses
import functools
import json
import os
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepfilternet_torch import enhance as enh  # noqa: E402
from deepfilternet_torch.config import config  # noqa: E402
from deepfilternet_torch.ops.stft import istft_ri  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 480


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.reset()


def _model(name=None, keys=None, device="cpu"):
    """(model, df_state) of a seeded random model at the config's defaults
    but for `keys` ({(key, section): value})."""
    config.reset()
    config.load(None, allow_reload=True)
    for (k, section), v in (keys or {}).items():
        config.set(k, v, section=section)
    model, df_state, _ = enh.init_df(None, model_name=name, device=device)
    return model, df_state


@pytest.fixture(scope="module")
def dfn3():
    return _model()


def _audio(rows, hops, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(hops * HOP) / 48000.0
    tone = 0.1 * np.sin(2 * np.pi * 220.0 * t)
    return (tone[None] + 0.05 * rng.standard_normal((rows, hops * HOP))).astype(np.float32)


def _inputs(model, df_state, rows=2, hops=10, seed=0):
    return enh.df_features(_audio(rows, hops, seed), df_state, model.cfg["nb_df"],
                           device=model.device)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


class StubGraphs(enh._ForwardGraphs):
    """`_ForwardGraphs` with a CPU stand-in for the side stream, the capture
    and the replay; `log` records which of them ran."""

    def __init__(self, fail=False):
        super().__init__(torch.device("cpu"))
        self.fail = fail
        self.log = []

    def _warm_up(self, fn, inputs):
        self.log.append("warm_up")
        return fn(inputs)

    def _record(self, fn, inputs):
        self.log.append("record")
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        model = fn.args[0]
        frozen = dataclasses.replace(model, params=_clone(model.params),
                                     state=_clone(model.state), cfg=dict(model.cfg), _cache={})
        return (functools.partial(enh._forward_eager, frozen),
                tuple(x.clone() for x in inputs), None)

    def _replay(self, entry, inputs):
        self.log.append("replay")
        graph, static_in, _ = entry
        for dst, src in zip(static_in, inputs):
            dst.copy_(src)
        return graph(static_in)


# the counter, held here so that a test may set a wrapper in `enhance`'s place
FORWARD_CALLS = enh.enhance.forward_calls


class Counts:
    """`enhance.forward_calls` since the context began."""

    def __enter__(self):
        self.before = dict(FORWARD_CALLS)
        return self

    def __exit__(self, *exc):
        self.delta = {k: v - self.before[k] for k, v in FORWARD_CALLS.items()}


def _eager(model, inputs):
    return enh._forward_eager(model, inputs)


def _calls(graphs, model, inputs_list):
    return [graphs(model, x) for x in inputs_list]


def _k():
    """The call at a shape that captures."""
    return enh.CAPTURE_AT


# -- the policy, on the CPU ----------------------------------------------------


def test_first_eager_second_capture_then_replay(dfn3):
    model, df_state = dfn3
    graphs = StubGraphs()
    xs = [_inputs(model, df_state, seed=s) for s in range(_k() + 2)]
    with Counts() as c:
        outs = _calls(graphs, model, xs)
    assert graphs.log == ["warm_up", "record", "replay", "replay"]
    assert c.delta == {"eager": _k() - 1, "capture": 1, "replay": 2, "capture_failed": 0}
    for x, out in zip(xs, outs):
        assert torch.equal(out, _eager(model, x))


def _edit_weight(model):
    model.params["df_gru"]["gru"]["layers"][0]["w_hh"].mul_(1.5)


def _new_weights(model):
    model.params = _clone(model.params)
    model.params["enc_emb_gru"]["gru"]["layers"][0]["b_ih"].add_(0.25)


def _edit_cfg(model):
    model.cfg["mask_pf"] = not model.cfg["mask_pf"]


def _new_cfg(model):
    model.cfg = dict(model.cfg, run_df=False)


@pytest.mark.parametrize("change", [_edit_weight, _new_weights, _edit_cfg, _new_cfg])
def test_a_change_to_what_the_forward_reads_drops_the_graphs(change):
    model, df_state = _model()
    graphs = StubGraphs()
    n = _k() + 1
    xs = [_inputs(model, df_state, seed=s) for s in range(2 * n)]
    _calls(graphs, model, xs[:n])
    assert len(graphs.graphs) == 1
    change(model)
    with Counts() as c:
        outs = _calls(graphs, model, xs[n:])
    # eager at the new stamp, then a capture and a replay of the new forward
    assert c.delta == {"eager": _k() - 1, "capture": 1, "replay": 1, "capture_failed": 0}
    assert graphs.log[-3:] == ["warm_up", "record", "replay"]
    for x, out in zip(xs[n:], outs):
        assert torch.equal(out, _eager(model, x))


def test_a_new_shape_gets_its_own_graph_within_the_bound(dfn3):
    model, df_state = dfn3
    graphs = StubGraphs()
    shapes = [(1, 8 + h) for h in range(enh.FORWARD_GRAPHS + 2)]
    for rows, hops in shapes:
        x = _inputs(model, df_state, rows, hops)
        for _ in range(_k() + 1):
            assert torch.equal(graphs(model, x), _eager(model, x))
        assert len(graphs.graphs) <= enh.FORWARD_GRAPHS
    assert len(graphs.graphs) == enh.FORWARD_GRAPHS
    assert graphs.log.count("record") == len(shapes)
    # the oldest shapes were evicted: seen again, they start over
    x = _inputs(model, df_state, *shapes[0])
    with Counts() as c:
        _calls(graphs, model, [x] * (_k() + 1))
    assert c.delta == {"eager": _k() - 1, "capture": 1, "replay": 1, "capture_failed": 0}
    # the newest stayed: it replays at once
    x = _inputs(model, df_state, *shapes[-1])
    with Counts() as c:
        graphs(model, x)
    assert c.delta["replay"] == 1


def test_seen_shapes_are_a_bounded_window(dfn3):
    model, df_state = dfn3
    graphs = StubGraphs()
    for hops in range(2, 2 + enh.SEEN_SHAPES + 3):
        graphs(model, _inputs(model, df_state, 1, hops))
    assert len(graphs.seen) == enh.SEEN_SHAPES
    assert graphs.log == []


def test_a_failed_capture_runs_eager_and_is_never_retried():
    model, df_state = _model()
    graphs = StubGraphs(fail=True)
    xs = [_inputs(model, df_state, seed=s) for s in range(_k() + 3)]
    with Counts() as c:
        outs = _calls(graphs, model, xs)
    assert graphs.log == ["warm_up", "record"]
    assert c.delta == {"eager": _k() + 2, "capture": 0, "replay": 0, "capture_failed": 1}
    assert graphs.graphs == {}
    for x, out in zip(xs, outs):
        assert torch.equal(out, _eager(model, x))
    # neither another shape nor an edited weight is tried again
    x = _inputs(model, df_state, 1, 7)
    _calls(graphs, model, [x] * (_k() + 1))
    _edit_weight(model)
    _calls(graphs, model, [x] * (_k() + 1))
    assert graphs.log == ["warm_up", "record"]
    # a new cfg may capture: it is tried once
    _new_cfg(model)
    with Counts() as c:
        _calls(graphs, model, [x] * (_k() + 1))
    assert graphs.log == ["warm_up", "record"] * 2
    assert c.delta == {"eager": _k(), "capture": 0, "replay": 0, "capture_failed": 1}


def test_autograd_on_the_weights_stays_eager():
    model, df_state = _model()
    graphs = StubGraphs()
    w = model.params["df_gru"]["gru"]["layers"][0]["w_hh"]
    w.requires_grad_(True)
    x = _inputs(model, df_state)
    with Counts() as c:
        outs = _calls(graphs, model, [x] * (_k() + 1))
    assert graphs.log == [] and c.delta["eager"] == _k() + 1
    assert outs[0].requires_grad
    with torch.no_grad():
        _calls(graphs, model, [x] * (_k() + 1))
    assert graphs.log == ["warm_up", "record", "replay"]


def test_threads_share_the_graphs_one_at_a_time():
    """More threads than cores call one model at one shape; the stub replay
    counts the threads inside it. Each output must be its own input's."""
    inside, most = [0], [0]
    guard = threading.Lock()

    class Timed(StubGraphs):
        def _replay(self, entry, inputs):
            with guard:
                inside[0] += 1
                most[0] = max(most[0], inside[0])
            try:
                return super()._replay(entry, inputs)
            finally:
                with guard:
                    inside[0] -= 1

    w = torch.tensor([2.0])
    module = SimpleNamespace(forward=lambda p, s, cfg, a, b: ((a * p["w"] + b, None, None,
                                                                None), s))
    model = enh.DfModel(params={"w": w}, state={}, cfg={}, module=module,
                        device=torch.device("cpu"))
    graphs = Timed()
    n_threads, n_calls = (os.cpu_count() or 4) + 2, 20
    errors = []

    def work(i):
        for k in range(n_calls):
            a = torch.full((64, 64), float(i * n_calls + k))
            b = torch.full((64, 64), 1.0)
            out = graphs(model, (a, b))
            if not torch.equal(out, a * 2.0 + 1.0):
                errors.append((i, k))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with Counts() as c:
            threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert most[0] == 1
    assert sum(c.delta.values()) == n_threads * n_calls
    assert c.delta["capture"] == 1 and c.delta["replay"] >= 1


def test_capture_and_replay_spans(dfn3):
    model, df_state = dfn3
    graphs = StubGraphs()
    x = _inputs(model, df_state)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _calls(graphs, model, [x] * (_k() + 1))
    names = [e.name for e in prof.events()]
    assert names.count("enhance.forward.capture") == 1
    assert names.count("enhance.forward.replay") == 1


def _offline_without_graphs(model, df_state, audio, lim):
    """`enhance(..., backend="offline")` as the offline path computes it
    with the forward called directly."""
    n_fft = df_state.fft_size
    padded = np.pad(audio, ((0, 0), (0, n_fft)))
    padded = padded[:, : padded.shape[1] // HOP * HOP]
    x = torch.from_numpy(padded)
    spec, erb, sf = enh._features(x, df_state, model.cfg["nb_df"], enh._norm_alpha(df_state))
    spec_ri = enh._ri(spec)
    (spec_e_ri, _, _, _), _ = model.module.forward(model.params, model.state, model.cfg,
                                                    spec_ri, erb, enh._ri(sf))
    out = istft_ri(spec_ri * lim + spec_e_ri * (1.0 - lim), df_state.stft_cfg).numpy()
    d = n_fft - HOP
    return out[:, d: audio.shape[1] + d]


@pytest.mark.parametrize("atten_lim_db", [None, 12.0])
def test_a_cpu_model_never_takes_the_graph_path(dfn3, atten_lim_db):
    model, df_state = dfn3
    lim = 0.0 if atten_lim_db is None else 10.0 ** (-atten_lim_db / 20.0)
    audio = _audio(2, 10, 3)[:, :4700]
    with Counts() as c:
        outs = [enh.enhance(model, df_state, audio, atten_lim_db=atten_lim_db)
                for _ in range(3)]
    assert c.delta == {"eager": 3, "capture": 0, "replay": 0, "capture_failed": 0}
    assert "forward_graphs" not in model._cache
    ref = _offline_without_graphs(model, df_state, audio, lim)
    for out in outs:
        assert out.shape == audio.shape
        assert np.array_equal(out, ref)


def test_the_count_goes_on_under_a_wrapped_enhance(dfn3, monkeypatch):
    """A caller may set a wrapper in `enhance`'s place (to time or record
    each call, as `evaluation_loop`'s callers do); the forward still counts."""
    model, df_state = dfn3
    real = enh.enhance
    monkeypatch.setattr(enh, "enhance", lambda *a, **k: real(*a, **k))
    audio = _audio(1, 6, 4)
    with Counts() as c:
        enh.enhance(model, df_state, audio)
    assert c.delta == {"eager": 1, "capture": 0, "replay": 0, "capture_failed": 0}


# -- on a card -------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs exist only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bench_keys(name):
    """The benchmark configuration `name`'s model keys, as config entries."""
    with open(os.path.join(REPO, "benchmark", "configs", f"{name}.json")) as f:
        raw = json.load(f)

    def ini(v):
        if isinstance(v, bool):
            return "true" if v else "false"
        return ",".join(map(str, v)) if isinstance(v, list) else str(v)

    keys = {(k.upper(), s): ini(v) for s in ("DF", "deepfilternet") for k, v in raw[s].items()}
    return raw["model"], keys


def _eager_copy(model):
    """The model with a cache of its own: its first call at a shape is eager."""
    return dataclasses.replace(model, _cache={})


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dfn2", "dfn3"])
def test_cuda_replay_equals_eager(cuda_device, name):
    model_name, keys = _bench_keys(name)
    model, df_state = _model(model_name, keys, device=cuda_device)
    for rows, seconds in ((4, 1.0), (16, 3.0)):
        audios = [_audio(rows, int(seconds * 100), 10 * rows + k) for k in range(_k() + 1)]
        with Counts() as c:
            outs = [enh.enhance(model, df_state, a, backend="offline") for a in audios]
        assert c.delta == {"eager": _k() - 1, "capture": 1, "replay": 1, "capture_failed": 0}
        for a, out in zip(audios, outs):
            ref = enh.enhance(_eager_copy(model), df_state, a, backend="offline")
            assert float(np.abs(out - ref).max()) == 0.0, (name, rows)


@pytest.mark.cuda
def test_cuda_weight_edited_in_place_is_not_replayed_stale(cuda_device):
    model, df_state = _model(device=cuda_device)
    n = _k() + 1
    audios = [_audio(4, 100, k) for k in range(2 * n)]
    for a in audios[:n]:
        enh.enhance(model, df_state, a)
    with torch.no_grad():
        model.params["df_gru"]["gru"]["layers"][0]["w_hh"].mul_(1.5)
    with Counts() as c:
        outs = [enh.enhance(model, df_state, a) for a in audios[n:]]
    assert c.delta == {"eager": _k() - 1, "capture": 1, "replay": 1, "capture_failed": 0}
    for a, out in zip(audios[n:], outs):
        assert np.array_equal(out, enh.enhance(_eager_copy(model), df_state, a))


@pytest.mark.cuda
def test_cuda_a_forward_that_cannot_be_captured_runs_eager(cuda_device):
    """DeepFilterNet-MF estimating the covariance itself solves for its
    filter with `torch.linalg.solve`, whose error check waits on the card."""
    model, df_state = _model("deepfilternetmf",
                             {("MF_ESTIMATE_INVERSE", "deepfilternet"): "false"},
                             device=cuda_device)
    audios = [_audio(4, 100, k) for k in range(_k() + 2)]
    with Counts() as c:
        outs = [enh.enhance(model, df_state, a) for a in audios]
    assert c.delta == {"eager": _k() + 1, "capture": 0, "replay": 0, "capture_failed": 1}
    for a, out in zip(audios, outs):
        assert np.array_equal(out, enh.enhance(_eager_copy(model), df_state, a))
    # the card is still usable, and the allocator no longer fills the pool
    dfn3, dfn3_state = _model(device=cuda_device)
    a = _audio(4, 100, 9)
    with Counts() as c:
        outs = [enh.enhance(dfn3, dfn3_state, a) for _ in range(_k() + 1)]
    assert c.delta == {"eager": _k() - 1, "capture": 1, "replay": 1, "capture_failed": 0}
    assert all(np.array_equal(o, outs[0]) for o in outs)


@pytest.mark.cuda
def test_cuda_refused_captures_do_not_grow_memory(cuda_device):
    """A refused capture keeps what it allocated in its pool; the model then
    stays eager, so further shapes add no pool. Shapes fall in size, so that
    the eager calls need no block the first shape's did not."""
    model, df_state = _model("deepfilternetmf",
                             {("MF_ESTIMATE_INVERSE", "deepfilternet"): "false"},
                             device=cuda_device)
    reserved = []
    with Counts() as c:
        for hops in (160, 140, 120, 100):
            for k in range(_k() + 2):
                enh.enhance(model, df_state, _audio(4, hops, k))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved.append(torch.cuda.memory_reserved(cuda_device))
    assert c.delta["capture_failed"] == 1 and c.delta["capture"] == 0
    assert max(reserved[1:]) <= reserved[0], reserved


@pytest.mark.cuda
def test_cuda_counter_over_n_calls(cuda_device):
    model, df_state = _model(device=cuda_device)
    n = _k() + 4
    with Counts() as c:
        for k in range(n):
            enh.enhance(model, df_state, _audio(4, 100, k))
    assert c.delta == {"eager": _k() - 1, "capture": 1, "replay": n - _k(),
                       "capture_failed": 0}
