"""The port's evaluation (`eval/`, `scripts/eval_dir.py`, `scripts/test_df.py`)
against the JAX package's, on the CPU.

Seeded speech-like audio (harmonics with a vibrato and a syllable-rate
envelope) and its noisy mixtures, written with the port's `save_audio`.
Held:

  * every metric of `compute_metrics` (the metric modules are numpy copies)
    equal to JAX's on the same arrays at rtol 1e-9; `dnsmos` raises in both;
  * `evaluation_loop` with one shared `enhance_fn` at 1 and 2 workers:
    means at rtol 1e-9, the CSV text equal;
  * `eval_dir.main` with each package's own `enhance` on the demo
    checkpoint (2 files x 1 s): every metric mean within 1e-4 of JAX's
    (the worst is printed), the CSV's rows and keys;
  * `pair_files`, plain and DNS naming, equal to JAX's;
  * `test_df` goldens written, then asserted (exit 0) on a copy of the demo
    directory; a changed golden fails (exit 1); the port's metrics pass
    against goldens JAX's `test_df` wrote; a missing input names itself;
  * the entry points want CUDA without `--device`; a fresh interpreter that
    scores a directory, runs `libdf_compat` and `hdf5_tool` loads no jax,
    h5py or deepfilternet_tpu module.
"""

import csv
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.eval import evaluation as t_eval  # noqa: E402
from deepfilternet_torch.scripts import eval_dir as t_eval_dir  # noqa: E402
from deepfilternet_torch.scripts import test_df as t_test_df  # noqa: E402
from deepfilternet_torch.utils.audio_io import save_audio  # noqa: E402
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.eval import evaluation as j_eval  # noqa: E402
from deepfilternet_tpu.scripts import eval_dir as j_eval_dir  # noqa: E402
from deepfilternet_tpu.scripts import test_df as j_test_df  # noqa: E402

SR = 48000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DIR = os.path.join(REPO, "pretrained", "dfn3_fixture_demo")
METRICS = ("stoi", "sisdr", "snrseg", "fwsnrseg", "llr", "wss", "pesq", "pesq-nb", "composite")
RTOL = 1e-9


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


def speech_like(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = rng.uniform(100.0, 300.0)
    phase = 2 * np.pi * f0 * np.cumsum(1.0 + 0.02 * np.sin(2 * np.pi * 3.0 * t)) / SR
    env = 0.2 + 0.8 * np.sin(2 * np.pi * rng.uniform(2.0, 4.0) * t) ** 2
    return (env * sum(np.sin(k * phase) / k for k in range(1, 6)) * 0.1).astype(np.float32)


def mixture(clean, snr_db, seed):
    noise = np.random.default_rng(seed).standard_normal(clean.shape)
    g = np.sqrt(np.mean(clean ** 2) / (np.mean(noise ** 2) * 10 ** (snr_db / 10)))
    return (clean + g * noise).astype(np.float32)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Two (noisy, clean) pairs of 1 s at 48 kHz, plain and DNS names:
    {"noisy": dir, "clean": dir, "files": [(noisy, clean), ...],
    "dns_noisy": dir, "dns_clean": dir}."""
    root = tmp_path_factory.mktemp("eval")
    dirs = {k: root / k for k in ("noisy", "clean", "dns_noisy", "dns_clean")}
    for d in dirs.values():
        d.mkdir()
    files = []
    for i, snr in enumerate((3.0, 9.0)):
        clean = speech_like(SR, 10 + i)
        noisy = mixture(clean, snr, 20 + i)
        n, c = str(dirs["noisy"] / f"utt{i}.wav"), str(dirs["clean"] / f"utt{i}.wav")
        save_audio(n, noisy, SR)
        save_audio(c, clean, SR)
        files.append((n, c))
        save_audio(str(dirs["dns_noisy"] / f"book_snr{int(snr)}_fileid_{i + 3}.wav"), noisy, SR)
        save_audio(str(dirs["dns_clean"] / f"clean_fileid_{i + 3}.wav"), clean, SR)
    # files pair_files must skip: no clean partner, no DNS id
    save_audio(str(dirs["noisy"] / "orphan.wav"), speech_like(4800, 1), SR)
    save_audio(str(dirs["dns_noisy"] / "no_id.wav"), speech_like(4800, 2), SR)
    save_audio(str(dirs["dns_noisy"] / "x_fileid_9.wav"), speech_like(4800, 3), SR)
    out = {k: str(v) for k, v in dirs.items()}
    out["files"] = files
    return out


@pytest.fixture(scope="module")
def signals():
    clean = speech_like(int(1.5 * SR), 7)
    return clean, mixture(clean, 5.0, 8)


@pytest.mark.parametrize("metric", METRICS)
def test_metric_matches_jax(signals, metric):
    """Each metric alone in the port; beside "snrseg" in JAX, whose
    `compute_metrics` resamples to 16 kHz only for the sepm metrics, so that
    "pesq" or "pesq-nb" alone raise there (the port resamples for them)."""
    clean, noisy = signals
    got = t_eval.compute_metrics(clean, noisy, SR, (metric,))
    want = j_eval.compute_metrics(clean, noisy, SR, (metric, "snrseg"))
    assert got and set(got) <= set(want)
    for k, v in got.items():
        assert np.isfinite(v) and v == pytest.approx(want[k], rel=RTOL, abs=0), (k, v, want[k])
    if metric in ("pesq", "pesq-nb"):
        # "pesq" gets no signal ("too short"), "pesq-nb" None to resample
        with pytest.raises((ValueError, TypeError)):
            j_eval.compute_metrics(clean, noisy, SR, (metric,))


def test_all_metrics_match_jax_and_dnsmos_raises(signals):
    clean, noisy = signals
    got = t_eval.compute_metrics(clean, noisy[:-4800], SR, METRICS)
    want = j_eval.compute_metrics(clean, noisy[:-4800], SR, METRICS)
    assert set(got) == set(want) == {"stoi", "sisdr", "snrseg", "fwsnrseg", "llr", "wss",
                                     "pesq_wb", "pesq_nb", "pesq", "csig", "cbak", "covl",
                                     "composite_segsnr"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=RTOL, abs=0), k
    assert t_eval.si_sdr_np(noisy, clean) == j_eval.si_sdr_np(noisy, clean)
    for mod in (t_eval, j_eval):
        with pytest.raises(RuntimeError, match="DNSMOS"):
            mod.compute_metrics(clean, noisy, SR, ("dnsmos",))


def _damp(audio):
    """A deterministic stand-in for a model: a one-pole low-pass, scaled."""
    from scipy.signal import lfilter

    return (0.8 * lfilter([0.5], [1.0, -0.5], audio, axis=-1)).astype(np.float32)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("n_workers", [1, 2])
def test_evaluation_loop_shared_enhance_matches_jax(pairs, tmp_path, n_workers):
    from deepfilternet_torch.enhance import DfState

    noisy, clean = zip(*pairs["files"])
    metrics = ("stoi", "sisdr", "snrseg", "llr", "composite")
    out = {}
    for tag, mod in (("torch", t_eval), ("jax", j_eval)):
        path = str(tmp_path / f"{tag}.csv")
        means = mod.evaluation_loop(None, DfState(), noisy, clean, metrics=metrics,
                                    n_workers=n_workers, csv_path=path, enhance_fn=_damp)
        out[tag] = (means, _read_csv(path))
    (tm, tcsv), (jm, jcsv) = out["torch"], out["jax"]
    assert set(tm) == set(jm) and len(tm) == 9
    for k in jm:
        assert np.isfinite(tm[k]) and tm[k] == pytest.approx(jm[k], rel=RTOL, abs=0), k
    assert tcsv == jcsv and len(tcsv) == 3


def test_evaluation_loop_nan_excluded_from_means(pairs, caplog):
    """A file whose enhanced audio is NaN: its metrics are NaN in the rows,
    left out of the means with one warning, as in JAX."""
    from deepfilternet_torch.enhance import DfState
    from deepfilternet_torch.utils import logger

    calls = iter(range(4))

    def nan_first(audio):
        return audio * np.nan if next(calls) % 2 == 0 else audio

    noisy, clean = zip(*pairs["files"])
    logger.init_logger("INFO")
    with caplog.at_level("INFO", logger="df"):
        got = t_eval.evaluation_loop(None, DfState(), noisy, clean, metrics=("sisdr",),
                                     n_workers=1, enhance_fn=nan_first)
        want = j_eval.evaluation_loop(None, DfState(), noisy, clean, metrics=("sisdr",),
                                      n_workers=1, enhance_fn=nan_first)
    assert np.isfinite(got["sisdr"]) and got == want
    assert sum("excluded from means: ['sisdr']" in r.getMessage() for r in caplog.records) >= 1


@pytest.mark.parametrize("dns", [False, True])
def test_pair_files_matches_jax(pairs, dns):
    n, c = (pairs["dns_noisy"], pairs["dns_clean"]) if dns else (pairs["noisy"], pairs["clean"])
    got, want = t_eval_dir.pair_files(n, c, dns), j_eval_dir.pair_files(n, c, dns)
    assert got == want and len(got) == 2


def test_eval_dir_with_each_packages_enhance_matches_jax(pairs, tmp_path, capsys):
    """`eval_dir.main` on the demo checkpoint, each package's own offline
    `enhance`, every metric: the port's means within 1e-4 of JAX's."""
    args = ["-m", MODEL_DIR, "--noisy-dir", pairs["noisy"], "--clean-dir", pairs["clean"],
            "--metrics", ",".join(METRICS)]
    tcsv, jcsv = str(tmp_path / "torch.csv"), str(tmp_path / "jax.csv")
    got = t_eval_dir.main(args + ["--csv", tcsv, "--workers", "2", "--device", "cpu"])
    want = j_eval_dir.main(args + ["--csv", jcsv, "--workers", "1"])
    assert set(got) == set(want) and len(got) == 13
    diffs = {k: abs(got[k] - want[k]) for k in want}
    print("eval_dir means, port against JAX, largest abs difference:",
          max(diffs, key=diffs.get), max(diffs.values()))
    for k in want:
        assert np.isfinite(got[k]) and diffs[k] <= 1e-4, (k, got[k], want[k])
    rows = _read_csv(tcsv)
    assert rows[0] == ["file"] + sorted(want) and [r[0] for r in rows[1:]] == ["utt0.wav",
                                                                             "utt1.wav"]
    # the DNS layout pairs its two files
    dns = t_eval_dir.main(["-m", MODEL_DIR, "--noisy-dir", pairs["dns_noisy"], "--clean-dir",
                           pairs["dns_clean"], "--dns", "--metrics", "sisdr", "--workers", "1",
                           "--device", "cpu"])
    assert set(dns) == {"sisdr"}


def test_scripts_need_cuda_without_device(pairs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_eval_dir.main(["--noisy-dir", pairs["noisy"], "--clean-dir", pairs["clean"]])
    n, c = pairs["files"][0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_test_df.main([MODEL_DIR, "--noisy", n, "--clean", c])
    with pytest.raises(SystemExit) as e:
        t_eval_dir.main(["--noisy-dir", str(tmp_path), "--clean-dir", str(tmp_path),
                         "--device", "cpu"])
    assert e.value.code == 2


def _copy_model(tmp_path, name):
    d = tmp_path / name
    shutil.copytree(MODEL_DIR, d)
    os.remove(d / "golden_metrics.json")
    return str(d)


def test_test_df_update_then_assert(pairs, tmp_path, capsys):
    n, c = pairs["files"][1]
    io = ["--noisy", n, "--clean", c, "--device", "cpu"]
    model = _copy_model(tmp_path, "port")
    with pytest.raises(SystemExit) as e:
        t_test_df.main([model, "--update-golden"] + io)
    assert e.value.code == 0
    with open(os.path.join(model, "golden_metrics.json")) as f:
        golden = json.load(f)
    assert set(golden) == {"stoi", "sisdr", "snrseg", "pesq", "csig", "cbak", "covl",
                           "composite_segsnr", "_pesq_scale"}
    assert golden["_pesq_scale"].startswith("local from-spec calibration")
    with pytest.raises(SystemExit) as e:
        t_test_df.main([model] + io)
    assert e.value.code == 0 and "FAIL" not in capsys.readouterr().out
    golden["sisdr"] += 0.01
    with open(os.path.join(model, "golden_metrics.json"), "w") as f:
        json.dump(golden, f)
    with pytest.raises(SystemExit) as e:
        t_test_df.main([model] + io)
    assert e.value.code == 1 and "FAIL sisdr" in capsys.readouterr().out
    # the port's metrics against goldens JAX's test_df wrote on the same files
    jmodel = _copy_model(tmp_path, "jax")
    with pytest.raises(SystemExit) as e:
        j_test_df.main([jmodel, "--update-golden", "--noisy", n, "--clean", c])
    with pytest.raises(SystemExit) as e:
        t_test_df.main([jmodel] + io)
    assert e.value.code == 0
    # a missing input names itself; the default is the reference's asset
    with pytest.raises(FileNotFoundError, match="noisy_snr0.wav"):
        t_test_df.eval_model(model, os.path.join(str(tmp_path), t_test_df.DEFAULT_NOISY), c,
                             device="cpu")
    assert t_test_df.DEFAULT_CLEAN.endswith(os.path.basename(j_test_df.DEFAULT_CLEAN))


def test_evaluation_imports_no_jax_or_h5py(pairs, tmp_path):
    """A fresh interpreter scores a directory with eval_dir (2 workers),
    runs libdf_compat, the logger's summary, the seed helpers and hdf5_tool
    on the CPU; then no jax, h5py or deepfilternet_tpu module may be
    loaded (the card's machine has none of them)."""
    code = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        from deepfilternet_torch import libdf_compat
        from deepfilternet_torch.enhance import init_df
        from deepfilternet_torch.scripts import eval_dir, hdf5_tool, test_df
        from deepfilternet_torch.scripts.prepare_data import prepare
        from deepfilternet_torch.utils import logger, seed
        means = eval_dir.main(["--noisy-dir", {pairs["noisy"]!r}, "--clean-dir",
                               {pairs["clean"]!r}, "--metrics", "stoi,sisdr", "--workers", "2",
                               "--device", "cpu", "-m", {MODEL_DIR!r}])
        assert set(means) == {{"stoi", "sisdr"}}
        df = libdf_compat.DF(48000, 960, 480, device="cpu")
        spec = df.analysis(np.zeros((1, 4800), np.float32))
        libdf_compat.erb(spec, df.erb_widths(), device="cpu")
        model, _, _ = init_df({MODEL_DIR!r}, device="cpu")
        print(logger.model_summary(model.params, model.cfg))
        seed.seed_everything(1)
        seed.torch_generator(2)
        h5 = os.path.join({str(tmp_path)!r}, "c.hdf5")
        prepare("speech", h5, [{pairs["files"][0][1]!r}])
        hdf5_tool.main(["list", h5])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "h5py", "deepfilternet_tpu"))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout and "Model summary" in res.stdout


def _all_metrics(pair):
    return t_eval.compute_metrics(*pair, SR, METRICS)


def metric_sensitivity(levels=(1e-4, 1e-6), seeds=6, workers=4):
    """How far each metric moves when white noise at `levels` of the
    enhanced audio's largest value is added to it: the 16 pairs of
    `chip_smoke.py`'s phase 11, enhanced by the demo checkpoint on the CPU.
    Prints the largest move of each metric over pairs and seeds; phase 11
    holds the card against the CPU at these (the PESQ-based ones and WSS)."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    sys.path.insert(0, REPO)
    import chip_smoke

    from deepfilternet_torch.enhance import enhance, init_df
    from deepfilternet_torch.utils.audio_io import load_audio

    model, df_state, _ = init_df(MODEL_DIR, device="cpu")
    with tempfile.TemporaryDirectory() as root:
        dirs = chip_smoke.write_eval_pairs(root)
        names = sorted(os.listdir(dirs["noisy"]))
        pairs = [(load_audio(os.path.join(dirs["clean"], n))[0][0],
                  enhance(model, df_state, load_audio(os.path.join(dirs["noisy"], n))[0])[0])
                 for n in names]
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        base = list(pool.map(_all_metrics, pairs))
        for level in levels:
            worst = {}
            for seed in range(seeds):
                rng = np.random.default_rng(1000 + seed)
                moved = [(c, (e + level * np.abs(e).max() * rng.standard_normal(e.shape))
                          .astype(np.float32)) for c, e in pairs]
                for b, m in zip(base, pool.map(_all_metrics, moved)):
                    for k in b:
                        worst[k] = max(worst.get(k, 0.0), abs(m[k] - b[k]))
            print(f"white noise at {level:g} of the enhanced audio's largest value, "
                  f"{len(pairs)} pairs x {seeds} seeds, largest move: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


if __name__ == "__main__":
    metric_sensitivity()
