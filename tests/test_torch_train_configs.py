"""The port's training path at `BASELINE.json`'s configurations against the
JAX package's, on the CPU: the low-latency DFN3 (DFN3-ll: FFT 480, hop 240,
32 ERB bands, 48 DF bins, a 5 ms delay) and 24 ERB bands / 64 DF bins.
`tests/test_torch_trainer.py`, `test_torch_data.py` and
`test_torch_train_run.py` hold the same paths at the default geometry
(FFT 960, hop 480, 32 / 96); this file reuses their helpers and bounds:

  * one train step of DFN3 at DFN3-ll and at 24 / 64, and of DFN2 and DFN1
    at DFN3-ll, at narrow widths (`_torch_families.SMALL`) from JAX's
    random weights, the fixture-demo and multi-resolution losses (and the
    DF alpha loss for DFN2 / DFN1), B=2 x 16 frames: the loss and its parts
    at relative 1e-5, every gradient leaf at 1e-4 of its scale, the new
    batch-norm statistics at 1e-5, the parameters after the step within 2 lr
    of those JAX's optimizer makes of JAX's gradients (99.9% within 1e-6 +
    1e-3 lr);
  * `FdDataset` samples at 1e-6 and `DataLoader` batches (3 workers) at
    those configurations against JAX's, on the corpus of
    `tests/test_torch_data.py`;
  * one `train/run.py::train` epoch at DFN3-ll against JAX's, on the corpus
    of `tests/test_torch_train_run.py`: every step's loss, the valid and
    test losses within 1e-4 relative.
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from _torch_families import SMALL, build  # noqa: E402
from test_torch_data import _datasets, _same_batch, write_corpus  # noqa: E402
from test_torch_train_run import CONFIG as RUN_CONFIG  # noqa: E402
from test_torch_train_run import _close, train_both  # noqa: E402
from test_torch_trainer import (  # noqa: E402
    LOSS_KEYS,
    LR,
    WD,
    _batch,
    _check_first_step,
    _check_grads,
    _check_state,
    _j_value_and_grad,
    _losses,
    _rel,
    clip_spy,  # noqa: F401 - a fixture
)

from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.data import dataloader as j_dl  # noqa: E402
from deepfilternet_tpu.data import dataset as j_ds  # noqa: E402
from deepfilternet_tpu.models import dfnet1 as j_dfnet1  # noqa: E402
from deepfilternet_tpu.models import dfnet2 as j_dfnet2  # noqa: E402
from deepfilternet_tpu.models import dfnet3 as j_dfnet3  # noqa: E402
from deepfilternet_tpu.train import trainer as jt  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.data import dataloader as t_dl  # noqa: E402
from deepfilternet_torch.data import dataset as t_ds  # noqa: E402
from deepfilternet_torch.models import dfnet1 as t_dfnet1  # noqa: E402
from deepfilternet_torch.models import dfnet2 as t_dfnet2  # noqa: E402
from deepfilternet_torch.models import dfnet3 as t_dfnet3  # noqa: E402
from deepfilternet_torch.train import trainer as tt  # noqa: E402

# (fft, hop, ERB bands, DF bins) and the config keys that set them
GEOMETRIES = {"dfn3_ll": (480, 240, 32, 48), "erb24_df64": (960, 480, 24, 64)}


def _keys(geometry):
    fft, hop, nb_erb, nb_df = GEOMETRIES[geometry]
    return {("FFT_SIZE", "DF"): str(fft), ("HOP_SIZE", "DF"): str(hop),
            ("NB_ERB", "DF"): str(nb_erb), ("NB_DF", "DF"): str(nb_df)}


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


# -- one train step ---------------------------------------------------------------

FAMILIES = {
    "dfn3": (j_dfnet3.init_dfnet3, t_dfnet3.init_dfnet3, j_dfnet3, t_dfnet3),
    "dfn2": (j_dfnet2.init_dfnet2, t_dfnet2.init_dfnet2, j_dfnet2, t_dfnet2),
    "dfn1": (j_dfnet1.init_dfnet1, t_dfnet1.init_dfnet1, j_dfnet1, t_dfnet1),
}


@pytest.mark.parametrize("family, geometry", [("dfn3", "dfn3_ll"), ("dfn3", "erb24_df64"),
                                              ("dfn2", "dfn3_ll"), ("dfn1", "dfn3_ll")])
def test_train_step_matches_jax(family, geometry, clip_spy):  # noqa: F811
    j_init, t_init, j_mod, t_mod = FAMILIES[family]
    fft, hop, nb_erb, nb_df = GEOMETRIES[geometry]
    jp, js, jcfg, tp, ts_, tcfg = build(j_init, t_init, {**SMALL, **_keys(geometry)})
    assert (tcfg["nb_erb"], tcfg["nb_df"], tcfg["freq_bins"]) == (nb_erb, nb_df, fft // 2 + 1)
    keys = dict(LOSS_KEYS)
    if family != "dfn3":
        keys[("factor", "DfAlphaLoss")] = "1"
    j_loss, t_loss = _losses(keys, nb_erb, nb_df, fft, hop)
    batch = _batch(11, 2, 16, tcfg)
    (j_total, (j_state, j_parts)), j_grads = _j_value_and_grad(j_mod, jcfg, j_loss)(
        jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
    # JAX's step after its gradients: the optax chain (global-norm clip,
    # AdamW with amsgrad) at the step's lr and weight decay
    j_opt = jt.make_optimizer()
    opt_state = jt._set_lr(jt.init_train_state(jp, js, j_opt).opt_state, jnp.asarray(LR),
                           jnp.asarray(WD))
    updates, _ = j_opt.update(j_grads, opt_state, jp)
    j_params = optax.apply_updates(jp, updates)

    ts = tt.init_train_state(tp, ts_, tt.make_optimizer())
    ts, met = tt.make_train_step(t_mod, tcfg, t_loss)(
        ts, {k: torch.from_numpy(v) for k, v in batch.items()}, LR, WD)
    assert bool(met["finite"]) and len(clip_spy) == 1
    assert ("df_alpha" in met) == (family != "dfn3")
    assert set(met) == set(j_parts) | {"loss", "finite"}
    _rel(met["loss"], j_total, 1e-5, "loss")
    for k, v in j_parts.items():
        _rel(met[k], v, 1e-5, k)
    _check_grads(clip_spy[0][0], j_grads, ts.params)
    _check_state(ts.model_state, j_state)
    _check_first_step(ts.params, j_params)


# -- the data engine ---------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    write_corpus(d)
    return d


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_fd_dataset_features(corpus, geometry):
    fft, hop, nb_erb, nb_df = GEOMETRIES[geometry]
    t, j = _datasets(corpus, p_bandwidth_ext=0.0)
    tf = t_ds.FdDataset(t, fft, hop, nb_erb, nb_df)
    jf = j_ds.FdDataset(j, fft, hop, nb_erb, nb_df)
    for idx, seed in ((0, 3), (1, 4), (2, 11)):
        a, b = tf.get_sample(idx, seed), jf.get_sample(idx, seed)
        assert a["max_freq"] == 16000
        assert a["spec_noisy"].shape[-1] == fft // 2 + 1 and a["feat_erb"].shape[-1] == nb_erb
        assert a["feat_spec"].shape[-1] == nb_df
        for k in b:
            if isinstance(b[k], np.ndarray) and b[k].dtype.kind in "fc":
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_dataloader_batches_match_jax(corpus, geometry):
    fft, hop, nb_erb, nb_df = GEOMETRIES[geometry]
    t, j = _datasets(corpus)
    loaders = [mod.DataLoader(fd, batch_size=2, num_workers=3, drop_last=True,
                              batch_size_eval=3)
               for mod, fd in ((t_dl, t_ds.FdDataset(t, fft, hop, nb_erb, nb_df)),
                               (j_dl, j_ds.FdDataset(j, fft, hop, nb_erb, nb_df)))]
    assert loaders[0].len_of("train") == loaders[1].len_of("train")
    n = 0
    for split, seed in (("train", 0), ("train", 1), ("valid", 0)):
        got = list(loaders[0].iter_epoch(split, seed))
        want = list(loaders[1].iter_epoch(split, seed))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.feat_spec.shape[-1] == nb_df and a.spec_noisy.shape[-1] == fft // 2 + 1
            _same_batch(a, b, (split, seed))
            n += 1
    assert n >= 5


# -- train/run.py ----------------------------------------------------------------------


def test_train_epoch_at_low_latency_matches_jax(tmp_path_factory):
    """Both packages' train() at DFN3-ll from one JAX-written checkpoint of
    epoch 0, one epoch (epoch 1 of max_epochs 2, 3 debug steps): every step's
    loss, every evaluation loss and the test loss within 1e-4 relative."""
    fft, hop, _, nb_df = GEOMETRIES["dfn3_ll"]
    config_ini = (RUN_CONFIG.replace("max_epochs = 3", "max_epochs = 2")
                  + f"\n[DF]\nfft_size = {fft}\nhop_size = {hop}\nnb_df = {nb_df}\n")
    assert "max_epochs = 2" in config_ini
    runs = train_both(tmp_path_factory.mktemp("train_run_ll"), config_ini)
    (jbase, jrec, jtest), (tbase, trec, ttest) = runs["jax"], runs["torch"]
    assert len(trec.steps) == len(jrec.steps) == 3
    for i, (a, b) in enumerate(zip(trec.steps, jrec.steps)):
        assert np.isfinite(a) and _close(a, b), (i, a, b)
    assert len(trec.evals) == len(jrec.evals) > 0
    for i, (a, b) in enumerate(zip(trec.evals, jrec.evals)):
        assert _close(a, b), (i, a, b)
    assert np.isfinite(ttest) and _close(ttest, jtest), (ttest, jtest)
    for base in (jbase, tbase):
        text = (base / "config.ini").read_text().lower()
        assert "fft_size = 480" in text and "hop_size = 240" in text and "nb_df = 48" in text
