"""The port's train step against the JAX package's, on the CPU.

  * every optimizer of `make_optimizer`, with the global-norm clip and the
    per-step lr and weight decay, step for step against JAX's optax chain
    over 25 steps, one of them clipped, at 1e-6;
  * `cosine_scheduler` against JAX's;
  * DFN3 at the widths of the bundled demo checkpoint, from its weights,
    B=2 x 20 frames, with the demo loss stack and the multi-resolution
    loss: three steps of `make_train_step` against JAX's jitted one (the
    losses at relative 1e-5, the new batch-norm statistics at 1e-5), the
    step's gradients against JAX's at 1e-4 of each leaf's largest value,
    the parameters after the steps within 2 lr (Adam's first steps are
    close to lr sign(g), and a near-zero gradient may round to the other
    sign) and 99.9% of them within 1e-6 + 1e-3 lr;
  * DFN3's LSNR frame dropout in training against JAX's;
  * the NaN guard; MASK_ONLY freezing, with the clip norm over all
    gradients;
  * DFN2 (its DF alpha in DfAlphaLoss), DFN1 and DeepFilterNet-MF at narrow
    widths: the step's loss, parts, gradients and batch-norm state against
    JAX's;
  * `init_model`'s default device; a train step and `write_cp` in a fresh
    interpreter load no JAX module.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_families import SMALL, build, rand_inputs  # noqa: E402
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.enhance import init_df as j_init_df  # noqa: E402
from deepfilternet_tpu.models import dfnet1 as j_dfnet1  # noqa: E402
from deepfilternet_tpu.models import dfnet2 as j_dfnet2  # noqa: E402
from deepfilternet_tpu.models import dfnet3 as j_dfnet3  # noqa: E402
from deepfilternet_tpu.models import dfnetmf as j_dfnetmf  # noqa: E402
from deepfilternet_tpu.ops import Stft as JStft  # noqa: E402
from deepfilternet_tpu.ops import erb_widths  # noqa: E402
from deepfilternet_tpu.train import loss as jl  # noqa: E402
from deepfilternet_tpu.train import lr as j_lr  # noqa: E402
from deepfilternet_tpu.train import trainer as jt  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.enhance import init_df  # noqa: E402
from deepfilternet_torch.models import dfnet1 as t_dfnet1  # noqa: E402
from deepfilternet_torch.models import dfnet2 as t_dfnet2  # noqa: E402
from deepfilternet_torch.models import dfnetmf as t_dfnetmf  # noqa: E402
from deepfilternet_torch.models import init_model  # noqa: E402
from deepfilternet_torch.ops.stft import Stft as TStft  # noqa: E402
from deepfilternet_torch.train import loss as tl  # noqa: E402
from deepfilternet_torch.train import lr as t_lr  # noqa: E402
from deepfilternet_torch.train import trainer as tt  # noqa: E402

MODEL_DIR = "pretrained/dfn3_fixture_demo"
LR, WD = 1e-3, 0.05
# the fixture-demo loss stack (scripts/train_demo.py) and the multi-resolution
# loss, so the time-domain round trip runs too
LOSS_KEYS = {("factor_magnitude", "SpectralLoss"): "100",
             ("factor_complex", "SpectralLoss"): "100", ("gamma", "SpectralLoss"): "0.6",
             ("factor", "MaskLoss"): "1", ("factor", "LocalSnrLoss"): "0.0005",
             ("factor", "MultiResSpecLoss"): "500",
             ("fft_sizes", "MultiResSpecLoss"): "256,512,1024"}


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


def _losses(keys, nb_erb=32, nb_df=96, fft_size=960, hop_size=480):
    """(JAX Loss, port Loss) under `keys`, set in both configs, at the STFT
    geometry `fft_size` / `hop_size`."""
    for cfg in (j_config, t_config):
        for (key, section), value in keys.items():
            cfg.set(key, value, section=section)
    widths = erb_widths(48000, fft_size, nb_erb, 2)
    return (jl.Loss(JStft(48000, fft_size, hop_size), widths, nb_df, (-15, 35)),
            tl.Loss(TStft(48000, fft_size, hop_size), widths, nb_df, (-15, 35)))


def _batch(seed, b, t, cfg):
    """Seeded spectra and features; clean is silent above bin 400."""
    spec, feat_erb, feat_spec = rand_inputs(seed, b, t, cfg)
    clean = (np.random.default_rng(seed + 1).standard_normal(spec.shape) * 0.05).astype(np.float32)
    clean[:, :, 400:] = 0
    return {"noisy": spec * 0.1, "clean": clean, "feat_erb": feat_erb, "feat_spec": feat_spec * 0.5}


def _j_value_and_grad(module, cfg, loss_obj):
    """JAX's `make_train_step` loss function, differentiated (one compile)."""
    returns_alpha = cfg.get("generation", 3) in (1, 2)

    def loss_fn(params, model_state, batch):
        (spec_e, m, lsnr, aux), new_state = module.forward(
            params, model_state, cfg, batch["noisy"], batch["feat_erb"], batch["feat_spec"],
            train=True)
        c = lambda x: x[..., 0] + 1j * x[..., 1]  # noqa: E731
        total, parts = loss_obj(c(batch["clean"]), c(batch["noisy"]), c(spec_e), m, lsnr,
                                df_alpha=aux if returns_alpha else None)
        return total, (new_state, parts)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture
def clip_spy(monkeypatch):
    """Each train step's gradients as they reach the clip (copies), and the
    norm it took."""
    seen = []
    real = tt.clip_by_global_norm_

    def spy(grads, max_norm):
        copies = [g.detach().clone() for g in grads]
        norm = real(grads, max_norm)
        seen.append((copies, float(norm)))
        return norm

    monkeypatch.setattr(tt, "clip_by_global_norm_", spy)
    return seen


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, ref, rel, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()),
                               err_msg=what)


def _check_grads(grads, j_grads, params):
    """Each leaf within 1e-4 of its largest |g|. A 1x1 per-channel conv
    weight [C, 1, 1, 1] under a batch norm is a scale the norm divides out:
    its gradient is the sum of terms that cancel but for a factor
    eps / (w^2 var + eps), so what is left is mostly the terms' rounding;
    it is held to 1e-4 of its block's largest |g| (the batch norm's bias and
    scale gradients are sums of the same terms)."""
    ref = jax.tree.leaves(j_grads)
    leaves = tt._leaves(params)
    assert len(grads) == len(ref) == len(leaves)
    block = {}
    for (k, _), r in zip(leaves, ref):
        block[k] = max(block.get(k, 0.0), float(np.abs(np.asarray(r)).max()))
    for i, ((k, t), g, r) in enumerate(zip(leaves, grads, ref)):
        r = np.asarray(r)
        assert g.shape == t.shape == r.shape, (k, g.shape, r.shape)
        scale = float(np.abs(r).max())
        if tuple(r.shape[1:]) == (1, 1, 1) and "bn" in params[k]:
            scale = block[k]
        np.testing.assert_allclose(_np(g), r, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"gradient leaf {i} of {k} {r.shape}")


def _check_first_step(params, j_params):
    """Parameters after one step: within 2 lr (Adam's first step is close to
    lr sign(g), and a near-zero gradient may round to the other sign), and
    99.9% of them within 1e-6 + 1e-3 lr."""
    d = np.concatenate([np.abs(_np(t) - np.asarray(r)).ravel()
                        for (_, t), r in zip(tt._leaves(params), jax.tree.leaves(j_params))])
    assert d.max() <= 2 * LR, d.max()
    assert np.mean(d <= 1e-6 + 1e-3 * LR) >= 0.999, np.mean(d <= 1e-6 + 1e-3 * LR)


def _check_state(state, j_state):
    for name, st in j_state.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(_np(state[name]["bn"][k]), np.asarray(st["bn"][k]),
                                       rtol=0, atol=1e-5, err_msg=f"{name} {k}")


# -- the optimizers ---------------------------------------------------------------

SHAPES = {"w1": (7, 5), "b1": (5,), "w2": (5, 3)}


@pytest.mark.parametrize("optimizer, amsgrad", [("adamw", True), ("adam", True),
                                                ("adamw", False), ("adam", False),
                                                ("sgd", True), ("rmsprop", True)])
def test_optimizer_step_for_step(optimizer, amsgrad):
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads_seq = [{k: (rng.standard_normal(s) * 0.05).astype(np.float32)
                  for k, s in SHAPES.items()} for _ in range(25)]
    grads_seq[5] = {k: v * 100 for k, v in grads_seq[5].items()}  # one clipped step
    lrs = (np.abs(rng.standard_normal(25)) * 1e-3 + 1e-5).astype(np.float32)
    opt_cfg = dict(lr=1.0, weight_decay=WD, optimizer=optimizer, betas=(0.9, 0.999),
                   amsgrad=amsgrad)

    j_opt = jt.make_optimizer(opt_cfg)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = j_opt.init(j_params)
    for g, lr in zip(grads_seq, lrs):
        state = jt._set_lr(state, jnp.asarray(lr), jnp.asarray(WD))
        updates, state = j_opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, j_params)
        j_params = jax.tree.map(lambda p, u: p + u, j_params, updates)

    keys = sorted(SHAPES)
    t_params = [torch.from_numpy(params[k].copy()).requires_grad_(True) for k in keys]
    opt = tt.make_optimizer(opt_cfg)(t_params)
    norms = []
    for g, lr in zip(grads_seq, lrs):
        grads = [torch.from_numpy(g[k].copy()) for k in keys]
        norms.append(float(tt.clip_by_global_norm_(grads, tt.CLIP_NORM)))
        for p, gr in zip(t_params, grads):
            p.grad = gr
        tt._set_lr(opt, lr, WD)
        opt.step()
    assert norms[5] > 1 > max(norms[:5] + norms[6:])
    for k, p in zip(keys, t_params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]), rtol=0,
                                   atol=1e-6, err_msg=f"{optimizer}/{k}")


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        tt.make_optimizer(dict(lr=1e-3, weight_decay=0.0, optimizer="lamb"))


@pytest.mark.parametrize("kw", [
    dict(base_value=5e-4, final_value=1e-6, epochs=10, niter_per_ep=100, warmup_epochs=3,
         start_warmup_value=1e-4),
    dict(base_value=1.0, final_value=0.0, epochs=8, niter_per_ep=10, initial_ep_per_cycle=4,
         cycle_decay=0.5),
    dict(base_value=1.0, final_value=0.1, epochs=9, niter_per_ep=7, warmup_epochs=1,
         warmup_steps=5, initial_ep_per_cycle=2, cycle_decay=0.7, cycle_mul=1.5),
])
def test_cosine_scheduler(kw):
    np.testing.assert_array_equal(t_lr.cosine_scheduler(**kw), j_lr.cosine_scheduler(**kw))


def test_init_model_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model()
    _, _, _, mod = init_model(device="cpu")
    assert mod.__name__ == "deepfilternet_torch.models.dfnet3"


# -- DFN3 at the demo checkpoint's widths --------------------------------------------


@pytest.fixture(scope="module")
def dfn3():
    """JAX's and the port's demo model, the losses, a batch, and JAX's
    jitted step and value-and-gradient."""
    jm, _, _ = j_init_df(MODEL_DIR)
    tm, _, _ = init_df(MODEL_DIR, device="cpu")
    j_loss, t_loss = _losses(LOSS_KEYS)
    batch = _batch(3, 2, 20, tm.cfg)
    j_opt = jt.make_optimizer()
    return dict(jm=jm, tm=tm, j_loss=j_loss, t_loss=t_loss, batch=batch, j_opt=j_opt,
                j_step=jax.jit(jt.make_train_step(j_dfnet3, jm.cfg, j_loss, j_opt)),
                j_vg=_j_value_and_grad(j_dfnet3, jm.cfg, j_loss))


def _port_state(tm):
    opt = tt.make_optimizer()
    return tt.init_train_state(tm.params, tm.state, opt)


def test_dfn3_train_step_matches_jax(dfn3, clip_spy):
    jm, tm, batch = dfn3["jm"], dfn3["tm"], dfn3["batch"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (j_loss, (j_state, _)), j_grads = dfn3["j_vg"](jm.params, jm.state, jb)
    jts = jt.init_train_state(jm.params, jm.state, dfn3["j_opt"])
    ts = _port_state(tm)
    step = tt.make_train_step(tm.module, tm.cfg, dfn3["t_loss"])
    for i in range(3):
        jts, jmet = dfn3["j_step"](jts, jb, jnp.asarray(LR), jnp.asarray(WD))
        ts, met = step(ts, tb, LR, WD)
        assert bool(met["finite"]) and bool(jmet["finite"])
        assert set(met) == set(jmet)
        for k in met:
            if k != "finite":
                _rel(met[k], jmet[k], 1e-5, f"step {i} {k}")
        if i == 0:
            _rel(met["loss"], j_loss, 1e-5, "loss")
            _check_grads(clip_spy[0][0], j_grads, ts.params)
            _check_state(ts.model_state, j_state)
            _check_first_step(ts.params, jts.params)
    _check_state(ts.model_state, jts.model_state)
    assert (ts.step, ts.nan_count) == (3, 0)
    # the caller's tree is not trained in place
    np.testing.assert_array_equal(tm.params["lsnr_fc"]["w"].numpy(),
                                  np.asarray(jm.params["lsnr_fc"]["w"]))


def test_dfn3_lsnr_dropout_matches_jax(dfn3):
    """With `lsnr_dropout`, frames predicted below -10 dB get a zero mask and
    zero DF coefficients in training, as in JAX (the LSNR head's bias moved
    down so that some frames drop and some stay)."""
    jm, tm, batch = dfn3["jm"], dfn3["tm"], dfn3["batch"]
    names = ("noisy", "feat_erb", "feat_spec")
    jp = dict(jm.params, lsnr_fc=dict(jm.params["lsnr_fc"], b=jm.params["lsnr_fc"]["b"] - 1.5))
    tp = dict(tm.params, lsnr_fc=dict(tm.params["lsnr_fc"], b=tm.params["lsnr_fc"]["b"] - 1.5))
    ref, _ = j_dfnet3.forward(jp, jm.state, dict(jm.cfg, lsnr_dropout=True),
                              *(jnp.asarray(batch[k]) for k in names), train=True)
    got, _ = tm.module.forward(tp, tm.state, dict(tm.cfg, lsnr_dropout=True),
                               *(torch.from_numpy(batch[k]) for k in names), train=True)
    for name, g, r in zip(("spec_e", "mask", "lsnr", "df_coefs"), got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=0, atol=1e-4, err_msg=name)
    dropped = _np(got[2])[..., 0] <= -10.0
    assert 0 < dropped.mean() < 1, dropped.mean()
    assert np.all(_np(got[1])[dropped] == 0)
    assert np.all(_np(got[3]).transpose(0, 2, 1, 3, 4)[dropped] == 0)


def test_nan_guard_keeps_everything(dfn3):
    tm = dfn3["tm"]
    ts = _port_state(tm)
    step = tt.make_train_step(tm.module, tm.cfg, dfn3["t_loss"])
    good = {k: torch.from_numpy(v) for k, v in dfn3["batch"].items()}
    ts, _ = step(ts, good, LR, WD)  # an optimizer state to keep
    bad = dict(good, noisy=torch.full_like(good["noisy"], float("nan")))
    params = [t.detach().clone() for _, t in tt._leaves(ts.params)]
    opt_before = tt._map(lambda v: v.clone() if isinstance(v, torch.Tensor) else v,
                         ts.opt_state.state_dict())
    ts2, met = step(ts, bad, LR, WD)
    assert not bool(met["finite"]) and not np.isfinite(float(met["loss"]))
    assert (ts2.nan_count, ts2.step) == (1, 2)
    assert ts2.model_state is ts.model_state
    for p, (_, t) in zip(params, tt._leaves(ts2.params)):
        assert torch.equal(p, t)
    after = ts2.opt_state.state_dict()
    assert after["param_groups"] == opt_before["param_groups"]
    for i, st in opt_before["state"].items():
        for k, v in st.items():
            assert torch.equal(v, after["state"][i][k]), (i, k)


def test_mask_only_freezes_df_decoder_and_clips_over_all(dfn3, clip_spy):
    tm = dfn3["tm"]
    trainable = tt.trainable_filter(mask_only=True)
    ts = _port_state(tm)
    before = {id(t): (k, t.detach().clone()) for k, t in tt._leaves(ts.params)}
    step = tt.make_train_step(tm.module, tm.cfg, dfn3["t_loss"], trainable=trainable)
    ts, met = step(ts, {k: torch.from_numpy(v) for k, v in dfn3["batch"].items()}, LR, WD)
    assert bool(met["finite"])
    leaves = tt._leaves(ts.params)
    frozen = [k for k, _ in leaves if k in tt.DF_DECODER_KEYS]
    assert set(frozen) == {"df_gru", "df_skip", "df_convp", "df_out", "df_fc_a"} & set(tm.params)
    for k, t in leaves:
        if k in tt.DF_DECODER_KEYS:
            assert torch.equal(t, before[id(t)][1]), k
            assert not ts.opt_state.state[t]
    assert any(not torch.equal(t, before[id(t)][1]) for k, t in leaves
               if k not in tt.DF_DECODER_KEYS)
    grads, norm = clip_spy[0]
    assert len(grads) == len(leaves)
    norm_all = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    norm_trained = np.sqrt(sum(float((g.double() ** 2).sum()) for g, (k, _) in zip(grads, leaves)
                               if k not in tt.DF_DECODER_KEYS))
    assert norm > 1  # the clip scales this step
    # the DF decoder's share of the norm is small: hold the float32 norm to
    # 1e-6 of the float64 one, which tells the two sets apart
    assert abs(norm - norm_all) <= 1e-6 * norm_all
    assert abs(norm - norm_trained) > 1e-5 * norm_all


# -- the other families at narrow widths ------------------------------------------------

FAMILIES = {
    "dfn2": (j_dfnet2.init_dfnet2, t_dfnet2.init_dfnet2, t_dfnet2),
    "dfn1": (j_dfnet1.init_dfnet1, t_dfnet1.init_dfnet1, t_dfnet1),
    "mf": (j_dfnetmf.init_dfnetmf, t_dfnetmf.init_dfnetmf, t_dfnetmf),
}
J_MODULES = {"dfn2": j_dfnet2, "dfn1": j_dfnet1, "mf": j_dfnetmf}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_train_step_matches_jax(family, clip_spy):
    j_init, t_init, t_mod = FAMILIES[family]
    jp, js, jcfg, tp, ts_, tcfg = build(j_init, t_init, SMALL)
    keys = dict(LOSS_KEYS)
    if family != "mf":
        keys[("factor", "DfAlphaLoss")] = "1"
    j_loss, t_loss = _losses(keys, tcfg["nb_erb"], tcfg["nb_df"])
    batch = _batch(7, 2, 16, tcfg)
    (j_total, (j_state, j_parts)), j_grads = _j_value_and_grad(J_MODULES[family], jcfg, j_loss)(
        jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts = tt.init_train_state(tp, ts_, tt.make_optimizer())
    ts, met = tt.make_train_step(t_mod, tcfg, t_loss)(
        ts, {k: torch.from_numpy(v) for k, v in batch.items()}, LR, WD)
    assert bool(met["finite"])
    assert ("df_alpha" in met) == (family != "mf")
    assert set(met) == set(j_parts) | {"loss", "finite"}
    _rel(met["loss"], j_total, 1e-5, "loss")
    for k, v in j_parts.items():
        _rel(met[k], v, 1e-5, k)
    _check_grads(clip_spy[0][0], j_grads, ts.params)
    _check_state(ts.model_state, j_state)


def test_train_step_imports_no_jax(tmp_path):
    """A fresh interpreter takes a DFN3 train step from the demo checkpoint
    with every loss part on and writes a checkpoint; then no jax, optax or
    deepfilternet_tpu module may be loaded."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        from deepfilternet_torch.checkpoint import read_cp, write_cp
        from deepfilternet_torch.config import config
        from deepfilternet_torch.enhance import df_features, init_df
        from deepfilternet_torch.train.loss import Loss
        from deepfilternet_torch.train.lr import cosine_scheduler
        from deepfilternet_torch.train.trainer import (init_train_state, load_opt_config,
                                                       make_optimizer, make_train_step)
        model, dfs, _ = init_df("pretrained/dfn3_fixture_demo", device="cpu")
        for (key, section), value in {{**{LOSS_KEYS!r}, ("factor", "SdrLoss"): "0.1"}}.items():
            config.set(key, value, section=section)
        x = np.random.default_rng(0).standard_normal((1, 4800)).astype(np.float32) * 0.1
        spec, erb, sf = df_features(x, dfs, 96, device="cpu")
        batch = {{"noisy": spec, "clean": spec * 0.5, "feat_erb": erb, "feat_spec": sf}}
        ts = init_train_state(model.params, model.state, make_optimizer())
        step = make_train_step(model.module, model.cfg,
                               Loss(dfs.stft_cfg, dfs.erb_widths, 96, (-15, 35)))
        lr = cosine_scheduler(1e-3, 1e-5, epochs=1, niter_per_ep=2)
        ts, met = step(ts, batch, lr[0], load_opt_config()["weight_decay"])
        assert bool(met["finite"]) and len(met) == 7, sorted(met)
        write_cp({str(tmp_path)!r}, ts.params, ts.model_state, 1,
                 opt_state=ts.opt_state.state_dict())
        assert "opt_state" in read_cp({str(tmp_path)!r})
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "optax", "deepfilternet_tpu"))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout
