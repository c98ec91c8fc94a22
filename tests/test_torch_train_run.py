"""The port's corpus training loop (`deepfilternet_torch/train/run.py`)
against the JAX package's `train/run.py`, on the CPU.

One tiny corpus (written by JAX's `prepare_data` with h5py), one
`config.ini` at narrow DFN3 widths with the spectral, multi-resolution,
mask and LSNR losses, and one checkpoint that JAX's `write_cp` writes of
JAX's initial parameters as epoch 0: both `train()`s resume from it with
`debug=True` (3 steps an epoch) for two epochs, the port's with
device="cpu". Held:

  * the same step count, every step's loss within 1e-4 relative, and the
    valid and test losses within 1e-4 relative;
  * the same `.best` log (epochs; losses at 1e-4); every checkpoint JAX
    kept within 2 lr of the port's of that epoch, 99.9% of the parameters
    within 1e-6 + 1e-3 lr (the trainer tests' bounds). The port keeps the
    reference's checkpoint layout and patience count, which JAX does not
    (a best epoch only as `.best`; patience that rises every epoch), so
    those are held to the reference's rules, not to JAX;
  * patience driven with scripted losses, and a resume after a best epoch
    that starts after it;
  * the summaries of each epoch (wavs and LSNR text);
  * `batch_to_arrays` against JAX's on a multichannel batch;
  * the `prepare_data` CLI against JAX's; the training CLI's device default;
  * a corpus written and a debug epoch trained through the CLI in a fresh
    interpreter load no jax, h5py or deepfilternet_tpu module.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepfilternet_torch import checkpoint as t_ckpt  # noqa: E402
from deepfilternet_torch.checkpoint import read_cp as t_read_cp  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.data.dataloader import collate  # noqa: E402
from deepfilternet_torch.scripts import prepare_data as t_prep  # noqa: E402
from deepfilternet_torch.train import loss as t_loss  # noqa: E402
from deepfilternet_torch.train import run as t_run  # noqa: E402
from deepfilternet_torch.train import trainer as t_trainer  # noqa: E402
from deepfilternet_torch.utils.audio_io import save_audio  # noqa: E402
from deepfilternet_tpu import checkpoint as j_ckpt  # noqa: E402
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.models import init_model as j_init_model  # noqa: E402
from deepfilternet_tpu.scripts import prepare_data as j_prep  # noqa: E402
from deepfilternet_tpu.train import loss as j_loss  # noqa: E402
from deepfilternet_tpu.train import run as j_run  # noqa: E402

SR = 48000
CONFIG = """[train]
seed = 3
max_epochs = 3
batch_size = 2
max_sample_len_s = 0.4
early_stopping_patience = 2

[distortion]
p_reverb = 0.3

[deepfilternet]
conv_ch = 8
emb_hidden_dim = 64
df_hidden_dim = 64

[optim]
lr = 0.001

[SpectralLoss]
factor_magnitude = 100
factor_complex = 100
gamma = 0.6

[MultiResSpecLoss]
factor = 50
fft_sizes = 256,512

[MaskLoss]
factor = 1

[LocalSnrLoss]
factor = 0.0005
"""
REL = 1e-4


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


def _wavs(d, prefix, n, seconds, seed, channels=1, decay=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = np.arange(int(SR * seconds)) / SR
        if decay is None:
            f0 = rng.uniform(100, 300, (channels, 1))
            x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5)) * 0.2
        else:
            x = rng.standard_normal((channels, t.size)) * np.exp(-t * decay) * 0.5
        out.append(str(d / f"{prefix}{i}.wav"))
        save_audio(out[-1], x + 0.002 * rng.standard_normal(x.shape), SR)
    return out


class _Recorder:
    """Every step's loss and every evaluation loss of one `train()` call."""

    def __init__(self):
        self.steps, self.evals = [], []


def _recording_loss(base, rec, concrete):
    class RecordingLoss(base):
        def __call__(self, *args, **kwargs):
            total, parts = super().__call__(*args, **kwargs)
            if concrete(total):
                rec.evals.append(float(total))
            return total, parts

    return RecordingLoss


class _JaxJitRecorder:
    """`jax` for JAX's run module: jit as usual, the train step's losses
    recorded (the first function it jits is the step)."""

    def __init__(self, rec):
        self.rec, self.n = rec, 0

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        jitted, first = jax.jit(fn), self.n == 0
        self.n += 1

        def call(*args):
            out = jitted(*args)
            if first:
                self.rec.steps.append(float(out[1]["loss"]))
            return out

        return call


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return train_both(tmp_path_factory.mktemp("train_run"), CONFIG)


def train_both(root, config_ini):
    """Both packages' train() under `config_ini` from one JAX-written
    checkpoint of epoch 0, over a corpus written under `root`; returns
    {"jax"|"torch": (base dir, recorder, test loss)}."""
    data = root / "data"
    data.mkdir()
    j_prep.prepare("speech", str(data / "speech.hdf5"), _wavs(data, "sp", 6, 0.5, 1))
    j_prep.prepare("noise", str(data / "noise.hdf5"),
                   _wavs(data, "ns", 2, 0.6, 2, decay=0.0) + _wavs(data, "st", 1, 0.3, 3, 2, 0.0))
    j_prep.prepare("rir", str(data / "rir.hdf5"), _wavs(data, "rir", 1, 0.1, 4, decay=40.0))
    ds_cfg = root / "dataset.cfg"
    entry = '[["speech.hdf5", 1], ["noise.hdf5", 1], ["rir.hdf5", 1]]'
    ds_cfg.write_text(f'{{"train": {entry}, "valid": {entry}, "test": {entry}}}')
    # JAX's initial parameters at the config's widths, epoch 0
    seed_dir = root / "seed"
    seed_dir.mkdir()
    (seed_dir / "config.ini").write_text(config_ini)
    j_config.reset()
    j_config.load(str(seed_dir / "config.ini"), allow_reload=True)
    params, state, _, _ = j_init_model("deepfilternet3", seed=11)
    j_ckpt.write_cp(str(seed_dir / "checkpoints"), params, state, 0)
    out = {}
    for name in ("jax", "torch"):
        base = root / name
        shutil.copytree(seed_dir, base)
        rec = _Recorder()
        with pytest.MonkeyPatch.context() as mp:
            if name == "jax":
                mp.setattr(j_run, "jax", _JaxJitRecorder(rec))
                mp.setattr(j_run, "Loss", _recording_loss(
                    j_loss.Loss, rec, lambda x: not isinstance(x, jax.core.Tracer)))
                _, test_loss = j_run.train(str(ds_cfg), str(data), str(base), num_workers=2,
                                           debug=True)
            else:
                real = t_trainer.make_train_step

                def recording_step(*a, **kw):
                    step = real(*a, **kw)

                    def call(*args):
                        ts, met = step(*args)
                        rec.steps.append(float(met["loss"]))
                        return ts, met

                    return call

                mp.setattr(t_run, "make_train_step", recording_step)
                mp.setattr(t_run, "Loss", _recording_loss(
                    t_loss.Loss, rec, lambda x: not torch.is_grad_enabled()))
                _, test_loss = t_run.train(str(ds_cfg), str(data), str(base), num_workers=2,
                                           debug=True, device="cpu")
        out[name] = (base, rec, test_loss)
    return out


def _close(got, want):
    return abs(got - want) <= REL * abs(want)


def test_train_steps_and_losses_match_jax(runs):
    (_, jrec, jtest), (_, trec, ttest) = runs["jax"], runs["torch"]
    # epochs 1 and 2 of 3 (epoch 0 is the checkpoint), 3 steps each
    assert len(trec.steps) == len(jrec.steps) == 6
    for i, (a, b) in enumerate(zip(trec.steps, jrec.steps)):
        assert np.isfinite(a) and _close(a, b), (i, a, b)
    # per epoch: the summaries' batch is not scored; valid (3 batches), then test
    assert len(trec.evals) == len(jrec.evals) > 0
    for i, (a, b) in enumerate(zip(trec.evals, jrec.evals)):
        assert _close(a, b), (i, a, b)
    assert np.isfinite(ttest) and _close(ttest, jtest), (ttest, jtest)


def test_checkpoints_best_log_and_patience_match_jax(runs):
    """Parity where the packages agree: the best log and each checkpoint JAX
    kept. The port's own listing and patience count follow the reference:
    every epoch as `model_<e>.ckpt` plus one `.best` copy, and a count of
    the epochs since the last best (JAX's counts every epoch)."""
    (jbase, _, _), (tbase, _, _) = runs["jax"], runs["torch"]
    jck, tck = jbase / "checkpoints", tbase / "checkpoints"
    jbest = [ln.split() for ln in (jck / ".best").read_text().splitlines()]
    tbest = [ln.split() for ln in (tck / ".best").read_text().splitlines()]
    assert [e for e, _ in tbest] == [e for e, _ in jbest] and tbest[0][0] == "1"
    for (_, a), (_, b) in zip(tbest, jbest):
        assert _close(float(a), float(b))
    last_best = int(tbest[-1][0])
    names = sorted(n for n in os.listdir(tck) if n.startswith("model_"))
    assert names == sorted(["model_0.ckpt", "model_1.ckpt", "model_2.ckpt",
                            f"model_{last_best}.ckpt.best"])
    # epochs 1 and 2 ran; the count is the epochs since the last best
    assert (tck / ".patience").read_text() == str(2 - last_best)
    # each checkpoint JAX kept against the port's of the same epoch, read by
    # both readers
    jepochs = sorted({int(n.split("_")[1].split(".")[0]) for n in os.listdir(jck)
                      if n.startswith("model_")} - {0})
    assert 2 in jepochs
    for epoch in jepochs:
        tp, jp = t_read_cp(str(tck), epoch), j_ckpt.read_cp(str(jck), epoch)
        assert tp["epoch"] == jp["epoch"] == epoch
        assert j_ckpt.read_cp(str(tck), epoch)["epoch"] == epoch
        jleaves = jax.tree.leaves(jax.tree.map(np.asarray, jp["params"]))
        tleaves = jax.tree.leaves(tp["params"])
        assert len(jleaves) == len(tleaves)
        # Adam's steps are close to lr sign(g), and a near-zero gradient may
        # round to the other sign: the trainer tests' bound of 2 lr (lr 1e-3)
        d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(tleaves, jleaves)])
        assert d.max() <= 2 * 1e-3 and np.mean(d <= 1e-6 + 1e-3 * 1e-3) >= 0.999, epoch


@pytest.mark.parametrize("patience", [1, 2, 3])
def test_patience_counts_only_epochs_that_do_not_improve(tmp_path, patience):
    """`best_and_patience`, as `train()` calls it after each epoch, with
    scripted validation losses: losses that improve every epoch never stop
    training; from a best epoch on, losses that do not beat it stop training
    after exactly `patience` epochs; an epoch that beats the best resets the
    count."""
    def drive(d, losses):
        os.makedirs(d)
        out = []
        for epoch, loss in enumerate(losses):
            out.append(t_run.best_and_patience(d, epoch, loss, patience))
        return out

    improving = drive(str(tmp_path / "improving"), [1.0 - 0.05 * i for i in range(12)])
    assert improving == [(True, True)] * 12
    assert (tmp_path / "improving" / ".patience").read_text() == "0"
    assert len((tmp_path / "improving" / ".best").read_text().splitlines()) == 12

    flat = drive(str(tmp_path / "flat"), [1.0] + [1.0 + 0.01 * i for i in range(patience)])
    assert flat == [(True, True)] + [(False, True)] * (patience - 1) + [(False, False)]
    assert (tmp_path / "flat" / ".patience").read_text() == str(patience)
    assert t_ckpt.read_best(str(tmp_path / "flat")) == (0, 1.0)

    # a new best resets the count: patience - 1 worse epochs, a best, then
    # patience worse epochs stop it
    losses = [1.0] + [1.5] * (patience - 1) + [0.5] + [0.6] * patience
    reset = drive(str(tmp_path / "reset"), losses)
    assert [go for _, go in reset] == [True] * (2 * patience) + [False]
    assert [b for b, _ in reset] == [True] + [False] * (patience - 1) + [True] + [False] * patience
    assert t_ckpt.read_best(str(tmp_path / "reset")) == (patience, 0.5)


def test_resume_after_a_best_epoch_starts_after_it(runs, capsys):
    """A run whose newest epoch (1) was a best one resumes from it: train()
    prints "Resuming from epoch 1" and runs epoch 2 next (a best epoch
    written only as `.best` would resume from epoch 0)."""
    tbase = runs["torch"][0]
    root = tbase.parent
    base = root / "resume"
    base.mkdir()
    shutil.copy(tbase / "config.ini", base / "config.ini")
    seed = t_read_cp(str(root / "seed" / "checkpoints"), 0)
    ck = str(base / "checkpoints")
    t_ckpt.write_cp(ck, seed["params"], seed["state"], 0)
    t_ckpt.write_cp(ck, seed["params"], seed["state"], 1, is_best=True)
    capsys.readouterr()
    _, test_loss = t_run.train(str(root / "dataset.cfg"), str(root / "data"), str(base),
                               max_epochs=3, num_workers=1, debug=True, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert "Resuming from epoch 1" in lines
    assert sorted({ln.split()[1].rstrip(":") for ln in lines if ln.startswith("epoch ")}) == ["2"]
    assert np.isfinite(test_loss) and t_read_cp(ck, "latest")["epoch"] == 2


def test_config_and_summaries_match_jax(runs):
    (jbase, _, _), (tbase, _, _) = runs["jax"], runs["torch"]
    for epoch in (1, 2):
        jnames = {n for n in os.listdir(jbase / "summaries" / f"epoch_{epoch}")
                  if not n.endswith(".png")}
        tnames = {n for n in os.listdir(tbase / "summaries" / f"epoch_{epoch}")
                  if not n.endswith(".png")}
        assert tnames == jnames
        assert any(n.startswith("0_enh_snr") and n.endswith(".wav") for n in tnames)
    assert "max_epochs = 3" in (tbase / "config.ini").read_text()


def test_batch_to_arrays_matches_jax():
    rng = np.random.default_rng(0)
    samples = []
    for i in range(3):
        s = {"speech": rng.standard_normal((2, 960)).astype(np.float32)}
        s["noisy"] = s["speech"] * 2
        for k, f in (("spec_clean", 481), ("spec_noisy", 481), ("feat_spec", 96)):
            s[k] = (rng.standard_normal((2, 2, f)) + 1j * rng.standard_normal((2, 2, f))
                    ).astype(np.complex64)
        s["feat_erb"] = rng.standard_normal((2, 2, 32)).astype(np.float32)
        s.update(max_freq=24000, snr=0, gain=0, idx=i)
        samples.append(s)
    batch = collate(samples)
    got, want = t_run.batch_to_arrays(batch), j_run.batch_to_arrays(batch)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape == ((6, 2, 481, 2) if k in ("noisy", "clean")
                                                 else got[k].shape)
        np.testing.assert_array_equal(got[k], want[k])
    tensors = t_run.to_device(got, "cpu")
    assert all(tensors[k].dtype == torch.float32 for k in tensors)


def test_prepare_data_cli_matches_jax(tmp_path):
    wav = tmp_path / "wav"
    wav.mkdir()
    files = _wavs(wav, "a", 2, 0.3, 5) + _wavs(wav, "b", 1, 0.2, 6, channels=2)
    outs = {}
    for name, mod in (("jax", j_prep), ("torch", t_prep)):
        d = tmp_path / name
        d.mkdir()
        out = str(d / "noise.hdf5")
        mod.main(["noise", out, files[0], "--glob", str(wav / "b*.wav"), "--max-freq", "20000",
                  "--dtype", "float32", "--mono"])
        mod.main(["speech", out, *files[:2], "--sr", "48000"])
        outs[name] = out
    with h5py.File(outs["torch"], "r") as a, h5py.File(outs["jax"], "r") as b:
        assert list(a.keys()) == list(b.keys()) == ["noise", "speech"]
        for g in a:
            assert list(a[g].keys()) == list(b[g].keys())
            for k in a[g]:
                assert a[g][k].dtype == b[g][k].dtype
                np.testing.assert_array_equal(a[g][k][...], b[g][k][...])
        assert a["noise"][t_prep.sanitize_key(files[2])].shape[0] == 1  # --mono
    with pytest.raises(SystemExit):
        t_prep.main(["speech", str(tmp_path / "x.hdf5")])


def test_train_cli_needs_cuda_without_device(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_run.main([str(tmp_path / "ds.cfg"), str(tmp_path), str(tmp_path / "run")])


def test_corpus_training_imports_no_jax_or_h5py(tmp_path):
    """A fresh interpreter writes a corpus with the port's prepare_data and
    trains one debug epoch through the CLI (`--device cpu`), then one more
    over a copy of the committed corpus h5py wrote with libver="latest"
    (`deepfilternet_torch/data/testdata/`: the reader's `data/h5v2.py`
    structures); then no jax, h5py or deepfilternet_tpu module may be
    loaded (the card's machine has neither)."""
    code = textwrap.dedent(f"""
        import os, shutil, sys
        import numpy as np
        from deepfilternet_torch.scripts.prepare_data import prepare
        from deepfilternet_torch.train import run
        from deepfilternet_torch.utils.audio_io import save_audio
        d = {str(tmp_path)!r}
        rng = np.random.default_rng(0)
        for g, n in (("speech", 4), ("noise", 2)):
            paths = []
            for i in range(n):
                paths.append(os.path.join(d, f"{{g}}{{i}}.wav"))
                save_audio(paths[-1], 0.1 * rng.standard_normal(19200), 48000)
            prepare(g, os.path.join(d, "corpus.hdf5"), paths)
        with open(os.path.join(d, "ds.cfg"), "w") as f:
            f.write('{{"train": [["corpus.hdf5", 1]], "valid": [["corpus.hdf5", 1]], '
                    '"test": [["corpus.hdf5", 1]]}}')
        latest = os.path.join(d, "latest")
        shutil.copytree(os.path.join("deepfilternet_torch", "data", "testdata"), latest)
        files = '[["speech.hdf5", 1], ["noise.hdf5", 1], ["rir.hdf5", 1]]'
        with open(os.path.join(latest, "ds.cfg"), "w") as f:
            f.write(f'{{{{"train": {{files}}, "valid": {{files}}, "test": {{files}}}}}}')
        for data_dir, run_dir in ((d, "run"), (latest, "run_latest")):
            os.makedirs(os.path.join(d, run_dir))
            with open(os.path.join(d, run_dir, "config.ini"), "w") as f:
                f.write({CONFIG!r})
            run.main([os.path.join(data_dir, "ds.cfg"), data_dir, os.path.join(d, run_dir),
                      "--device", "cpu", "--debug", "--max-epochs", "1", "--num-workers", "1"])
            assert os.path.isfile(os.path.join(d, run_dir, "checkpoints", "model_0.ckpt.best"))
        assert "deepfilternet_torch.data.h5v2" in sys.modules
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "h5py", "deepfilternet_tpu"))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout and res.stdout.count("final test loss") == 2
