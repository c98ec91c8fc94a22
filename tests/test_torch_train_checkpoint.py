"""The port's checkpoint writing and bookkeeping against the JAX package's.

`write_cp`/`read_cp` both ways between the packages (parameters and state
bit for bit; a torch optimizer's state restored and stepping on as if never
stopped; a JAX optimizer state dropped by the port's reader), `_cleanup`'s
keep-n and one-best rule, `log_best`/`read_best` and `check_patience`, each
on the same calls in both packages.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepfilternet_tpu import checkpoint as jc  # noqa: E402
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.train import trainer as jt  # noqa: E402
from deepfilternet_torch import checkpoint as tc  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.train import trainer as tt  # noqa: E402


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


def _trees(seed=0):
    """A parameter tree with nested dicts and lists, a batch-norm state."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    params = {"conv": {"w": f(4, 2, 3, 3), "bn": {"scale": f(4), "bias": f(4)}},
              "gru": {"layers": [{"w_ih": f(6, 3), "b_ih": f(6)}, {"w_ih": f(6, 2), "b_ih": f(6)}]}}
    state = {"conv": {"bn": {"mean": f(4), "var": np.abs(f(4))}}}
    return params, state


def _assert_tree_equal(got, ref):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _assert_tree_equal(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_tree_equal(g, r)
    else:
        g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        assert g.dtype == np.asarray(ref).dtype
        np.testing.assert_array_equal(g, np.asarray(ref))


def test_port_checkpoint_reads_in_jax(tmp_path):
    params, state = _trees(1)
    tp, ts = tc.params_from_numpy(params, state, "cpu")
    ts_ = tt.init_train_state(tp, ts, tt.make_optimizer())
    path = tc.write_cp(str(tmp_path), ts_.params, ts_.model_state, 7,
                       opt_state=ts_.opt_state.state_dict(), extra={"step": 3})
    assert os.path.basename(path) == "model_7.ckpt"
    payload = jc.read_cp(str(tmp_path))
    assert payload["epoch"] == 7 and payload["extra"] == {"step": 3}
    _assert_tree_equal(payload["params"], params)
    _assert_tree_equal(payload["state"], state)
    assert isinstance(payload["params"]["conv"]["w"], jax.Array)


def test_jax_checkpoint_reads_in_port(tmp_path):
    params, state = _trees(2)
    opt = jt.make_optimizer()
    jps = jax.tree.map(jnp.asarray, params)
    jc.write_cp(str(tmp_path), jps, jax.tree.map(jnp.asarray, state), 4,
                opt_state=opt.init(jps), is_best=True)
    jc.write_cp(str(tmp_path), jps, jax.tree.map(jnp.asarray, state), 5)
    for which in ("best", 4):
        payload = tc.read_cp(str(tmp_path), which)
        assert payload["epoch"] == 4 and "opt_state" not in payload
        _assert_tree_equal(payload["params"], params)
        _assert_tree_equal(payload["state"], state)
    assert tc.read_cp(str(tmp_path))["epoch"] == 5
    tp, ts = tc.params_from_numpy(payload["params"], payload["state"], "cpu")
    _assert_tree_equal(tp, params)


def test_optimizer_state_resumes(tmp_path):
    """Three steps, a checkpoint, a fresh optimizer from it, three more
    steps: bit for bit the six steps of one optimizer."""
    params, _ = _trees(3)
    grads = [tc.params_from_numpy(_trees(10 + i)[0], {}, "cpu")[0] for i in range(6)]

    def run(ts, gs):
        for g in gs:
            for (_, t), (_, gt) in zip(tt._leaves(ts.params), tt._leaves(g)):
                t.grad = gt.clone()
            tt._set_lr(ts.opt_state, 1e-3, 0.05)
            ts.opt_state.step()
        return ts

    whole = run(tt.init_train_state(tc.params_from_numpy(params, {}, "cpu")[0], {},
                                    tt.make_optimizer()), grads)
    first = run(tt.init_train_state(tc.params_from_numpy(params, {}, "cpu")[0], {},
                                    tt.make_optimizer()), grads[:3])
    tc.write_cp(str(tmp_path), first.params, {}, 3, opt_state=first.opt_state.state_dict())
    payload = tc.read_cp(str(tmp_path))
    resumed = tt.init_train_state(tc.params_from_numpy(payload["params"], {}, "cpu")[0], {},
                                  tt.make_optimizer())
    resumed.opt_state.load_state_dict(tc.optimizer_state_from_numpy(payload["opt_state"]))
    resumed = run(resumed, grads[3:])
    for (_, a), (_, b) in zip(tt._leaves(whole.params), tt._leaves(resumed.params)):
        assert torch.equal(a, b)


def _names(d):
    return sorted(n for n in os.listdir(d) if n.startswith("model_"))


def _reference_names(calls, keep_n):
    """The files the reference keeps after `calls` of (epoch, is_best): every
    epoch as `model_<e>.ckpt`, the newest `keep_n` of them (all for
    keep_n <= 0), and a `.best` copy of the newest best epoch."""
    plain = [e for e, _ in calls]
    plain = plain[-keep_n:] if keep_n > 0 else plain
    best = [e for e, b in calls if b][-1:]
    return sorted([f"model_{e}.ckpt" for e in plain] + [f"model_{e}.ckpt.best" for e in best])


def test_cleanup_keeps_newest_and_one_best(tmp_path):
    """The port writes every epoch as `model_<e>.ckpt` and a best one also as
    `.best` (the reference; JAX's writer keeps a best epoch only as `.best`),
    with `_cleanup`'s rules: the newest keep_n plain files and the newest
    best. The two packages' listings agree once the best is no longer among
    the newest plain files."""
    params, state = _trees(4)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    calls = [(1, False), (2, True), (3, False), (4, False), (5, True), (6, False), (7, False)]
    for i, (epoch, best) in enumerate(calls):
        jc.write_cp(jdir, params, state, epoch, is_best=best, keep_n=2)
        tc.write_cp(tdir, params, state, epoch, is_best=best, keep_n=2)
        assert _names(tdir) == _reference_names(calls[:i + 1], 2)
    assert _names(tdir) == _names(jdir) == ["model_5.ckpt.best", "model_6.ckpt",
                                            "model_7.ckpt"]
    for epoch in range(8, 11):
        jc.write_cp(jdir, params, state, epoch, keep_n=0)
        tc.write_cp(tdir, params, state, epoch, keep_n=0)
    assert _names(tdir) == _names(jdir) and len(_names(tdir)) == 6


def test_best_and_patience(tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jdir)
    os.makedirs(tdir)
    assert tc.read_best(tdir) is None and jc.read_best(jdir) is None
    metrics = [(0, 1.0), (1, 0.9), (2, 1.2), (3, 1.1), (4, 1.1), (5, 1.3), (6, 0.5)]
    for maximize in (True, False):
        for epoch, metric in metrics:
            j_go = jc.check_patience(jdir, 2, metric, maximize=maximize)
            t_go = tc.check_patience(tdir, 2, metric, maximize=maximize)
            assert t_go == j_go, (maximize, epoch)
            with open(os.path.join(tdir, ".patience")) as f, \
                    open(os.path.join(jdir, ".patience")) as g:
                assert f.read() == g.read()
            best = jc.read_best(jdir)
            if best is None or (metric > best[1] if maximize else metric < best[1]):
                jc.log_best(jdir, epoch, metric)
                tc.log_best(tdir, epoch, metric)
            assert tc.read_best(tdir) == jc.read_best(jdir)
    assert tc.read_best(tdir) == (6, 0.5)


@pytest.mark.parametrize("calls", [
    [(0, False), (1, True)],
    [(0, False), (1, True), (2, False), (3, True)],
    [(0, True), (1, False), (2, True), (3, True)],
    [(0, False), (1, False), (2, True), (3, False)],
])
def test_latest_is_the_newest_epoch_in_both_readers(tmp_path, calls):
    """On a directory the port writes, `read_cp(dir, "latest")` of both
    packages returns the newest epoch written, best or not, with that
    epoch's weights; "best" the newest best one."""
    d = str(tmp_path)
    for epoch, best in calls:
        params, state = _trees(20 + epoch)
        tc.write_cp(d, params, state, epoch, is_best=best, keep_n=2)
    newest, best = calls[-1][0], [e for e, b in calls if b][-1]
    t_latest, j_latest = tc.read_cp(d, "latest"), jc.read_cp(d, "latest")
    assert t_latest["epoch"] == j_latest["epoch"] == newest
    _assert_tree_equal(t_latest["params"], _trees(20 + newest)[0])
    _assert_tree_equal(jax.tree.map(np.asarray, j_latest["params"]), _trees(20 + newest)[0])
    assert tc.read_cp(d, "best")["epoch"] == jc.read_cp(d, "best")["epoch"] == best
