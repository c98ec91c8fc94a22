"""The port's demo trainers (`deepfilternet_torch/scripts/train_demo.py`,
`overfit_trial.py`) against the JAX package's, on the CPU.

One seeded corpus that the port's `prepare_data` writes (`clean.hdf5`,
`noise_flac.hdf5`: the file names both packages' demo trainers read), and
one narrow DFN3 `config.ini`:

  * `train_demo`'s pool (DEMO_POOLS=2, padded to one frame count) against
    the same pool built with JAX's loader and `batch_to_arrays`: the audio
    bit for bit, the model inputs within 1e-6;
  * the first step's loss from JAX's initial parameters carried into the
    port, the port's train step against JAX's, within 1e-5 relative;
  * `train_demo.main` writes a best checkpoint that JAX's `read_cp` reads,
    and a second call resumes from it; a checkpoint with another
    optimizer's state warm-starts the parameters and restarts the optimizer,
    one of another architecture trains from scratch (the messages of
    `tests/test_train.py::TestTrainDemoResume`); the DEMO_PAD_FRAMES guard;
  * `overfit_trial.main` writes its checkpoint with the optimizer state,
    resumes from it and prints its SI-SDR line.
"""

import os
import pickle

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepfilternet_tpu import checkpoint as j_ckpt  # noqa: E402
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_torch.checkpoint import read_cp as t_read_cp  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.scripts import overfit_trial  # noqa: E402
from deepfilternet_torch.scripts import prepare_data as t_prep  # noqa: E402
from deepfilternet_torch.scripts import train_demo  # noqa: E402
from deepfilternet_torch.utils.audio_io import save_audio  # noqa: E402

SR = 48000
NARROW = """[deepfilternet]
conv_ch = 8
emb_hidden_dim = 64
df_hidden_dim = 64
"""
DEMO_ENV = {"DEMO_POOLS": "2", "DEMO_BATCH": "2", "DEMO_MAX_LEN_S": "0.5"}


@pytest.fixture(scope="module", autouse=True)
def _fresh_configs():
    j_config.reset()
    t_config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    j_config.reset()
    t_config.reset()


def _wav(path, seconds, seed, noise):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    if noise:
        x = rng.standard_normal(t.size) * 0.3
    else:
        f0 = rng.uniform(100, 300)
        x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5)) * 0.2
    save_audio(path, (x + 0.002 * rng.standard_normal(t.size))[None].astype(np.float32), SR)
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A corpus directory the port's `prepare_data` writes: one speech and
    two noise files, seeded."""
    d = tmp_path_factory.mktemp("assets")
    t_prep.prepare("speech", str(d / "clean.hdf5"), [_wav(str(d / "sp.wav"), 1.0, 1, False)])
    t_prep.prepare("noise", str(d / "noise_flac.hdf5"),
                   [_wav(str(d / f"n{i}.wav"), 0.8, 2 + i, True) for i in range(2)])
    return str(d)


@pytest.fixture
def demo_env(monkeypatch, corpus):
    for k, v in dict(DEMO_ENV, DEMO_ASSETS=corpus).items():
        monkeypatch.setenv(k, v)


def _model_dir(tmp_path, name="demo"):
    d = tmp_path / name
    d.mkdir()
    (d / "config.ini").write_text(NARROW)
    return str(d)


def _jax_pool(corpus):
    """The pool JAX's train_demo builds from the same knobs (DEMO_POOLS=2):
    (first epoch's batches, padded arrays)."""
    from deepfilternet_tpu.data.dataloader import DataLoader
    from deepfilternet_tpu.data.dataset import FdDataset, Hdf5Cfg, TdDataset
    from deepfilternet_tpu.train.run import batch_to_arrays

    cfgs = [Hdf5Cfg("clean.hdf5", 16), Hdf5Cfg("noise_flac.hdf5", 1)]
    td = TdDataset(corpus, cfgs, "train", max_len_s=0.5, snrs=(-5, 0, 5, 10, 20, 40), seed=1,
                   p_reverb=0.0, p_interfer_sp=0.0)
    dl = DataLoader(FdDataset(td), batch_size=2, num_workers=6, drop_last=True)
    first = list(dl.iter_epoch("train", 0))
    raw = [batch_to_arrays(b) for b in first] + [batch_to_arrays(b)
                                                 for b in dl.iter_epoch("train", 1)]
    tmax = max(a["noisy"].shape[1] for a in raw)
    return first, [{k: np.pad(v, [(0, 0), (0, tmax - v.shape[1])] + [(0, 0)] * (v.ndim - 2))
                    for k, v in a.items()} for a in raw]


@pytest.fixture(scope="module")
def pools(corpus):
    """(JAX's pool, the port's pool) of the same corpus and knobs."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in dict(DEMO_ENV, DEMO_ASSETS=corpus).items():
            mp.setenv(k, v)
        first, raw = train_demo.batch_pool(train_demo.demo_loader(), 2)
        _, padded = train_demo.pad_pool(raw)
    return _jax_pool(corpus), (first, padded)


def test_pool_matches_jax(pools):
    (j_first, j_pool), (t_first, t_pool) = pools
    assert len(t_first) == len(j_first) and len(t_pool) == len(j_pool) > len(t_first)
    for a, b in zip(t_first, j_first):
        np.testing.assert_array_equal(a.speech, b.speech)
        np.testing.assert_array_equal(a.noisy, b.noisy)
    for a, b in zip(t_pool, j_pool):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape
            np.testing.assert_allclose(a[k], b[k], rtol=0,
                                       atol=1e-6 * max(np.abs(b[k]).max(), 1.0), err_msg=k)


def test_first_step_loss_matches_jax(pools, tmp_path):
    """JAX's initial parameters at the demo's config and loss defaults, both
    packages' train steps on the pool's first batch."""
    from deepfilternet_tpu.models import init_model as j_init_model
    from deepfilternet_tpu.ops import Stft as JStft
    from deepfilternet_tpu.ops import erb_widths as j_erb_widths
    from deepfilternet_tpu.train.loss import Loss as JLoss
    from deepfilternet_tpu.train.trainer import init_train_state as j_init_ts
    from deepfilternet_tpu.train.trainer import make_optimizer as j_make_opt
    from deepfilternet_tpu.train.trainer import make_train_step as j_make_step
    from deepfilternet_torch.checkpoint import params_from_numpy
    from deepfilternet_torch.models import init_model
    from deepfilternet_torch.ops.erb import erb_widths
    from deepfilternet_torch.ops.stft import Stft
    from deepfilternet_torch.train.loss import Loss
    from deepfilternet_torch.train.run import to_device
    from deepfilternet_torch.train.trainer import init_train_state, make_optimizer, make_train_step

    model_dir = _model_dir(tmp_path)
    j_config.reset()
    j_config.load(os.path.join(model_dir, "config.ini"), allow_reload=True)
    for sec, k, v in train_demo.LOSS_DEFAULTS:
        j_config.set(k, v, section=sec)
    jp, js, jcfg, jmod = j_init_model(seed=5)
    widths = j_erb_widths(48000, 960, 32, 2)
    j_loss = JLoss(JStft(48000, 960, 480), widths, 96, (-15, 35))
    opt = j_make_opt()
    j_step = jax.jit(j_make_step(jmod, jcfg, j_loss, opt))
    arrays = pools[1][1][0]
    _, jm = j_step(j_init_ts(jp, js, opt), {k: jnp.asarray(v) for k, v in arrays.items()},
                   jnp.asarray(3e-4), jnp.asarray(0.05))
    j_config.reset()

    train_demo.load_demo_config(model_dir)
    _, _, cfg, mod = init_model(device="cpu")
    p, s = params_from_numpy(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js), "cpu")
    loss = Loss(Stft(48000, 960, 480), erb_widths(48000, 960, 32, 2), 96, (-15, 35))
    step = make_train_step(mod, cfg, loss)
    _, m = step(init_train_state(p, s, make_optimizer()), to_device(arrays, "cpu"),
                torch.tensor(3e-4), torch.tensor(0.05))
    t_config.reset()
    ref = float(jm["loss"])
    assert abs(float(m["loss"]) - ref) <= 1e-5 * abs(ref)


def test_train_demo_writes_best_and_resumes(demo_env, tmp_path, capsys):
    model_dir = _model_dir(tmp_path)
    train_demo.main(model_dir, budget_s=0.5, device="cpu")
    out = capsys.readouterr().out
    assert "train-set si_sdr" in out and "resumed" not in out
    ckpt_dir = os.path.join(model_dir, "checkpoints")
    names = sorted(os.listdir(ckpt_dir))
    assert len(names) == 2 and names[1] == names[0] + ".best"
    payload = j_ckpt.read_cp(ckpt_dir, "best")
    step = payload["epoch"]
    assert step >= 8 and "opt_state" in t_read_cp(ckpt_dir)
    train_demo.main(model_dir, budget_s=0.5, device="cpu")
    out = capsys.readouterr().out
    assert f"resumed from step {step}" in out and "restarting" not in out
    t_config.reset()


def test_train_demo_opt_state_mismatch_warm_starts_params_only(demo_env, tmp_path, capsys):
    """As tests/test_train.py::TestTrainDemoResume: a checkpoint written
    under another optimizer warm-starts the parameters and restarts the
    optimizer state."""
    model_dir = _model_dir(tmp_path)
    train_demo.main(model_dir, budget_s=0.5, device="cpu")
    ckpt_dir = os.path.join(model_dir, "checkpoints")
    names = [n for n in os.listdir(ckpt_dir) if n.startswith("model_")]
    for name in names:
        path = os.path.join(ckpt_dir, name)
        with open(path, "rb") as f:
            payload = pickle.load(f)
        assert "opt_state" in payload
        payload["opt_state"] = {"junk": np.zeros(1, np.float32)}
        with open(path, "wb") as f:
            pickle.dump(payload, f)
    capsys.readouterr()
    train_demo.main(model_dir, budget_s=0.5, device="cpu")  # must not raise
    out = capsys.readouterr().out
    assert "restarting optimizer state" in out
    assert "resumed from step" in out
    t_config.reset()


def test_train_demo_other_architecture_trains_from_scratch(demo_env, tmp_path, capsys):
    model_dir = _model_dir(tmp_path)
    train_demo.main(model_dir, budget_s=0.5, device="cpu")
    with open(os.path.join(model_dir, "config.ini"), "w") as f:
        f.write(NARROW.replace("conv_ch = 8", "conv_ch = 16"))
    capsys.readouterr()
    train_demo.main(model_dir, budget_s=0.5, device="cpu")
    out = capsys.readouterr().out
    assert "incompatible with current architecture" in out and "resumed" not in out
    t_config.reset()


def test_pad_frames_guard(pools):
    _, (_, padded) = pools
    tmax = padded[0]["noisy"].shape[1]
    with pytest.raises(SystemExit, match="is frames"):
        train_demo.pad_pool(padded, 10 * tmax + 1)
    t, out = train_demo.pad_pool(padded, 10 * tmax + 1, force=True)
    assert t == 10 * tmax + 1 and out[0]["noisy"].shape[1] == t
    with pytest.raises(ValueError, match="below"):
        train_demo.pad_pool(padded, tmax - 1)


def test_overfit_trial(corpus, tmp_path, capsys):
    ckpt = str(tmp_path / "trial")
    overfit_trial.main(budget_s=1e-3, ckpt_dir=ckpt, assets_dir=corpus, device="cpu")
    out = capsys.readouterr().out
    assert "si_sdr noisy=" in out and "resumed" not in out
    payload = t_read_cp(ckpt)
    assert payload["epoch"] == 2 and "opt_state" in payload
    assert j_ckpt.read_cp(ckpt)["epoch"] == 2
    overfit_trial.main(budget_s=1e-3, ckpt_dir=ckpt, assets_dir=corpus, device="cpu")
    assert "resumed from step 2" in capsys.readouterr().out
    t_config.reset()
