"""The port's `scripts/make_vtlp_pool.py` against the repository's root
`scripts/make_vtlp_pool.py` (JAX's `RandVTLP` and `Hdf5Dataset`, h5py), on
the CPU, over a seeded corpus the port's `prepare_data` writes (mono and
stereo speech clips, one noise clip):

  * with `--include-original` and without, with the default alphas and a
    custom list: the same groups and keys, the same file attributes and
    clip attributes (values and types), and the same int16 samples bit for
    bit, read by h5py and by the port's `H5File`; the same closing line;
  * a fresh interpreter runs the port's script and loads no jax, h5py or
    deepfilternet_tpu module;
  * the grown pool feeds `TdDataset` through an extra `Hdf5Cfg`, as
    `train_demo`'s `DEMO_EXTRA_CLEAN` does (the counterpart of
    `tests/test_data.py::TestVtlpPoolGrowth`, whose assets are not in the
    repository).
"""

import os
import runpy
import subprocess
import sys
import textwrap

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
pytest.importorskip("jax")

from deepfilternet_torch.data.dataset import Hdf5Cfg, TdDataset  # noqa: E402
from deepfilternet_torch.data.h5file import H5File  # noqa: E402
from deepfilternet_torch.data.hdf5 import Hdf5Dataset  # noqa: E402
from deepfilternet_torch.scripts import make_vtlp_pool  # noqa: E402
from deepfilternet_torch.scripts.prepare_data import prepare  # noqa: E402
from deepfilternet_torch.utils.audio_io import save_audio  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_SCRIPT = os.path.join(REPO, "scripts", "make_vtlp_pool.py")
SR = 48000


def _speech(rng, seconds, channels=1):
    t = np.arange(int(SR * seconds)) / SR
    f0 = rng.uniform(100, 300, (channels, 1))
    x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5)) * 0.2
    return x * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) + 0.003 * rng.standard_normal(x.shape)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """speech.hdf5: two mono clips and one stereo clip of speech, and a noise
    group of one clip, written by the port's prepare_data."""
    d = tmp_path_factory.mktemp("vtlp")
    rng = np.random.default_rng(5)
    speech = []
    for i, (seconds, ch) in enumerate(((0.6, 1), (0.35, 2), (0.5, 1))):
        speech.append(str(d / f"sp{i}.wav"))
        save_audio(speech[-1], _speech(rng, seconds, ch), SR)
    noise = str(d / "ns0.wav")
    save_audio(noise, 0.1 * rng.standard_normal((1, int(SR * 0.3))), SR)
    src = str(d / "speech.hdf5")
    prepare("speech", src, speech)
    prepare("noise", src, [noise])
    return d, src


def _root_script(argv, monkeypatch, capsys):
    """The root script's main() in this process (it imports the JAX package
    and h5py); returns its closing line."""
    monkeypatch.setattr(sys, "argv", [ROOT_SCRIPT, *argv])
    monkeypatch.setattr(sys, "path", list(sys.path))  # it prepends the repository
    capsys.readouterr()
    runpy.run_path(ROOT_SCRIPT, run_name="__main__")
    return capsys.readouterr().out.strip()


def _attrs(attrs):
    """{name: (kind, value)}: "str" for a variable-length string, else the
    numpy type's kind."""
    return {k: ("str", v) if isinstance(v, str) else (np.asarray(v).dtype.kind,
                                                     np.asarray(v).tolist())
            for k, v in attrs.items()}


@pytest.mark.parametrize("extra", [["--include-original"], ["--alphas", "0.92,1.08"]],
                         ids=["default_alphas_with_original", "custom_alphas"])
def test_pool_matches_root_script(corpus, tmp_path, monkeypatch, capsys, extra):
    _, src = corpus
    want, got = str(tmp_path / "root_pool.hdf5"), str(tmp_path / "port_pool.hdf5")
    want_line = _root_script([src, want, *extra], monkeypatch, capsys)
    make_vtlp_pool.main([src, got, *extra])
    got_line = capsys.readouterr().out.strip()
    assert got_line == want_line.replace(want, got)
    n_alphas = 2 if "--alphas" in extra else 4
    n_per_key = n_alphas + ("--include-original" in extra)
    assert got_line.endswith(f"{4 * n_per_key} clips ({n_alphas} warps"
                             + (" + original)" if "--include-original" in extra else ")"))
    with h5py.File(want, "r") as b, h5py.File(got, "r") as a, H5File(got) as p:
        attrs = _attrs(b.attrs)
        assert _attrs(a.attrs) == _attrs(p.attrs) == dict(attrs, db_name=("str", "port_pool.hdf5"))
        assert attrs["db_name"] == ("str", "root_pool.hdf5")
        assert attrs["sr"] == ("i", SR) and attrs["codec"] == ("str", "pcm")
        assert list(a.keys()) == list(b.keys()) == p["/"].keys() == ["noise", "speech"]
        for g in b:
            keys = list(b[g].keys())
            assert list(a[g].keys()) == list(p[g].keys()) == keys
            assert len(keys) == (3 if g == "speech" else 1) * n_per_key
            for k in keys:
                ref = b[g][k][...]
                assert ref.dtype == np.int16 and ref.ndim == 2
                for ds in (a[g][k], p[g][k]):
                    assert ds.dtype == ref.dtype
                    np.testing.assert_array_equal(ds[...], ref, err_msg=f"{g}/{k}")
                    assert _attrs(ds.attrs) == _attrs(b[g][k].attrs) == {
                        "n_samples": ("i", ref.shape[1]), "n_channels": ("i", ref.shape[0])}
        # the stereo clip stays stereo, and a warp changes the samples
        assert any(b["speech"][k].shape[0] == 2 for k in b["speech"])
        orig = Hdf5Dataset(src)
        key = orig.keys("speech")[0]
        warped = b["speech"][f"{key}_vtlp{0.92 if '--alphas' in extra else 0.9:g}"][...]
        assert not np.array_equal(warped, np.round(orig.read("speech", key) * 32768))
        if "--include-original" in extra:
            np.testing.assert_array_equal(
                b["speech"][key][...],
                np.clip(orig.read("speech", key) * 32768.0, -32768, 32767).astype(np.int16))
        orig.close()


def test_pool_script_imports_no_jax_or_h5py(corpus, tmp_path):
    """The CLI in a fresh interpreter: its closing line, and no jax, h5py or
    deepfilternet_tpu module loaded (the card's machine has neither)."""
    _, src = corpus
    out = str(tmp_path / "pool.hdf5")
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.argv = ["make_vtlp_pool", {src!r}, {out!r}, "--alphas", "0.95"]
        runpy.run_module("deepfilternet_torch.scripts.make_vtlp_pool", run_name="__main__")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "h5py", "deepfilternet_tpu"))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"wrote {out}: 4 clips (1 warps)" in res.stdout and "LOADED []" in res.stdout


def test_pool_generates_and_feeds_tddataset(tmp_path):
    """A pool of two pseudo-speakers grown from a one-clip clean corpus reads
    back as real audio and mixes through TdDataset as an extra Hdf5Cfg."""
    rng = np.random.default_rng(9)
    wav = tmp_path / "wav"
    wav.mkdir()
    save_audio(str(wav / "clean0.wav"), _speech(rng, 1.0), SR)
    save_audio(str(wav / "noise0.wav"), 0.1 * rng.standard_normal((1, SR)), SR)
    prepare("speech", str(tmp_path / "clean.hdf5"), [str(wav / "clean0.wav")])
    prepare("noise", str(tmp_path / "noise.hdf5"), [str(wav / "noise0.wav")])
    out = tmp_path / "clean_vtlp.hdf5"
    make_vtlp_pool.main([str(tmp_path / "clean.hdf5"), str(out), "--alphas", "0.92,1.08"])

    ds = Hdf5Dataset(str(out))
    keys = ds.keys("speech")
    assert len(keys) == 2 and all("_vtlp" in k for k in keys)
    assert ds.sr == SR and ds.codec == "pcm"
    # warped copies are real audio, not silence or byte copies
    src = Hdf5Dataset(str(tmp_path / "clean.hdf5"))
    a = src.read("speech", src.keys("speech")[0])
    w = ds.read("speech", keys[0])
    assert w.shape == a.shape
    assert np.all(np.isfinite(w)) and np.abs(w).max() > 0.01
    assert not np.allclose(w, a, atol=1e-3)
    ds.close()
    src.close()

    # the grown pool mixes through TdDataset exactly like the original
    cfgs = [Hdf5Cfg("clean.hdf5", 2), Hdf5Cfg("clean_vtlp.hdf5", 1), Hdf5Cfg("noise.hdf5", 1)]
    td = TdDataset(str(tmp_path), cfgs, "train", max_len_s=0.5, seed=3)
    assert len(td) == 2 + 2  # 1 original key x2 + 2 pseudo-speakers x1
    s = td.get_sample(len(td) - 1, seed=0)
    assert np.all(np.isfinite(s["noisy"]))
    assert not np.allclose(s["speech"], s["noisy"])
