"""The port's `scripts/hdf5_tool.py` (over its own HDF5 reader and writer)
against the JAX package's (over h5py), on the same h5py-written files, on
the CPU.

Corpora: int16 and float32 PCM written by JAX's `prepare_data`, and a
"vorbis" corpus of 1-D uint8 byte streams shorter and longer than one of
the writer's chunks, with legacy and string attributes, written by h5py.
Held bit for bit: what `list` prints, the wav `sample` writes, and every
dataset (values, dtype) and attribute of what `split`, `trim` and `fix`
write, read back by h5py; the byte streams also through `H5File`.
"""

import shutil

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.data.h5file import H5File, H5Writer  # noqa: E402
from deepfilternet_torch.data.hdf5 import Hdf5Dataset  # noqa: E402
from deepfilternet_torch.scripts import hdf5_tool as t_tool  # noqa: E402
from deepfilternet_torch.utils.audio_io import save_audio  # noqa: E402
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.scripts import hdf5_tool as j_tool  # noqa: E402
from deepfilternet_tpu.scripts import prepare_data as j_prep  # noqa: E402

SR = 48000
# byte-stream lengths around the writer's chunk of 48000 elements
STREAM_LENS = (1, 1000, 47999, 48000, 48001, 100003)


@pytest.fixture(scope="module", autouse=True)
def _fresh_configs():
    j_config.reset()
    t_config.reset()
    yield
    j_config.reset()
    t_config.reset()


def _wavs(d, prefix, lengths, seed, channels=1):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lengths):
        out.append(str(d / f"{prefix}{i}.wav"))
        save_audio(out[-1], 0.2 * rng.standard_normal((channels, n)), SR)
    return out


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{"int16" | "float32" | "vorbis": path of an h5py-written corpus}."""
    root = tmp_path_factory.mktemp("hdf5_tool")
    wav = root / "wav"
    wav.mkdir()
    out = {}
    for dtype in ("int16", "float32"):
        path = str(root / f"{dtype}.hdf5")
        j_prep.prepare("speech", path, _wavs(wav, f"s{dtype}", [9600, 24000, 4800, 60000, 14400,
                                                                19200, 12000, 33600], 1),
                       dtype=dtype)
        j_prep.prepare("noise", path, _wavs(wav, f"n{dtype}", [7200, 50000, 2400], 2, 2),
                       dtype=dtype)
        out[dtype] = path
    path = str(root / "vorbis.hdf5")
    rng = np.random.default_rng(3)
    with h5py.File(path, "w") as f:
        f.attrs.update(sr=SR, max_freq=20000, codec="vorbis", dtype="int16",
                       db_name=np.bytes_(b"vorbis.hdf5"))
        for g, lens in (("speech", STREAM_LENS), ("noise", STREAM_LENS[::2])):
            grp = f.create_group(g)
            for i, n in enumerate(lens):
                d = grp.create_dataset(f"clip_{i}", data=rng.integers(0, 256, n, np.uint8),
                                       compression="gzip", compression_opts=4)
                d.attrs["n_samples"] = np.array([SR * (i + 1) // 2])
                if i % 2:
                    d.attrs["n_ch"] = 1
    out["vorbis"] = path
    return out


def _assert_attrs_equal(a, b):
    assert sorted(a.attrs) == sorted(b.attrs)
    for k in a.attrs:
        x, y = a.attrs[k], b.attrs[k]
        assert type(x) is type(y) and np.asarray(x).dtype == np.asarray(y).dtype, k
        assert np.array_equal(np.asarray(x), np.asarray(y)), k


def _assert_files_equal(got, want):
    """Same groups, keys, dataset values and dtypes and attributes (h5py)."""
    with h5py.File(got, "r") as a, h5py.File(want, "r") as b:
        _assert_attrs_equal(a, b)
        assert list(a.keys()) == list(b.keys())
        for g in b:
            assert list(a[g].keys()) == list(b[g].keys())
            for k in b[g]:
                x, y = a[g][k], b[g][k]
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x[...], y[...])
                _assert_attrs_equal(x, y)


def _run(tool, argv, capsys):
    capsys.readouterr()
    tool.main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("kind", ["int16", "float32", "vorbis"])
def test_list_matches_jax(corpora, kind, capsys):
    argv = ["list", corpora[kind], "--max-keys", "4"]
    got, want = _run(t_tool, argv, capsys), _run(j_tool, argv, capsys)
    assert got == want and "[speech] " in got


@pytest.mark.parametrize("key", [None, "speech/", "noise/"])
def test_sample_matches_jax(corpora, key, tmp_path, capsys):
    """A named key (of either group) and a random one drawn from the seed:
    the same wav bytes, holding the audio Hdf5Dataset.read gives."""
    argv = ["--seed", "5"]
    if key is not None:
        group = key.rstrip("/")
        name = sorted(h5py.File(corpora["int16"], "r")[group].keys())[1]
        argv += ["--group", group, "--key", name]
    outs = {}
    for tag, tool in (("torch", t_tool), ("jax", j_tool)):
        outs[tag] = str(tmp_path / f"{tag}.wav")
        printed = _run(tool, ["sample", corpora["int16"], outs[tag]] + argv, capsys)
        outs[tag + "_printed"] = printed.replace(outs[tag], "OUT")
    assert outs["torch_printed"] == outs["jax_printed"]
    with open(outs["torch"], "rb") as a, open(outs["jax"], "rb") as b:
        assert a.read() == b.read()
    group, name = outs["torch_printed"].split()[1].split("/")
    ds = Hdf5Dataset(corpora["int16"])
    want = ds.read(group, name)
    ds.close()
    from deepfilternet_torch.utils.audio_io import load_audio

    got, sr = load_audio(outs["torch"])
    assert sr == SR and got.shape == want.shape
    # the wav holds the clip as save_audio scales it (x 32767, rounded)
    np.testing.assert_array_equal(np.round(got * 32768),
                                  np.round(np.clip(want, -1.0, 1.0) * 32767.0))


@pytest.mark.parametrize("kind", ["int16", "float32", "vorbis"])
def test_split_matches_jax(corpora, kind, tmp_path, capsys):
    outs = {}
    for tag, tool in (("torch", t_tool), ("jax", j_tool)):
        d = tmp_path / tag
        d.mkdir()
        outs[tag] = _run(tool, ["split", corpora[kind], str(d), "--ratios", "0.6,0.2,0.2",
                                "--seed", "7"], capsys)
    assert outs["torch"] == outs["jax"]
    stem = kind
    keys = {}
    for split in ("train", "valid", "test"):
        got = str(tmp_path / "torch" / f"{stem}_{split}.hdf5")
        _assert_files_equal(got, str(tmp_path / "jax" / f"{stem}_{split}.hdf5"))
        with H5File(got) as f:
            keys[split] = {(g, k) for g in f["/"].keys() for k in f[g].keys()}
    # the three key sets partition the original
    with h5py.File(corpora[kind], "r") as f:
        whole = {(g, k) for g in f for k in f[g]}
    assert sum(len(v) for v in keys.values()) == len(whole)
    assert set.union(*keys.values()) == whole


@pytest.mark.parametrize("kind,max_len_s", [("int16", 0.5), ("float32", 1.0),
                                            ("vorbis", 1.5)])
def test_trim_matches_jax(corpora, kind, max_len_s, tmp_path, capsys):
    outs = {}
    for tag, tool in (("torch", t_tool), ("jax", j_tool)):
        outs[tag] = str(tmp_path / f"{tag}.hdf5")
        outs[tag + "_printed"] = _run(tool, ["trim", corpora[kind], outs[tag], "--max-len-s",
                                             str(max_len_s)], capsys)
    assert outs["torch_printed"] == outs["jax_printed"]
    kept, dropped = (int(s.strip(",")) for s in outs["torch_printed"].split()[1:4:2])
    assert kept and dropped
    _assert_files_equal(outs["torch"], outs["jax"])


@pytest.mark.parametrize("kind,extra", [("int16", []), ("float32", ["--sr", "48000",
                                                                    "--max-freq", "16000"])])
def test_fix_matches_jax(corpora, kind, extra, tmp_path, capsys):
    """A file whose n_samples were written wrong, with a legacy n_ch attr,
    fixed by both tools: the same printout, and n_samples / n_channels read
    right afterwards; every other dataset and attribute unchanged."""
    src = str(tmp_path / "broken.hdf5")
    shutil.copy(corpora[kind], src)
    with h5py.File(src, "r+") as f:
        for i, k in enumerate(sorted(f["speech"])):
            if i % 2:
                f["speech"][k].attrs["n_samples"] = np.array([7])
            f["speech"][k].attrs["n_ch"] = 1
        del f.attrs["max_freq"]
    outs = {}
    for tag, tool in (("torch", t_tool), ("jax", j_tool)):
        outs[tag] = str(tmp_path / f"{tag}.hdf5")
        shutil.copy(src, outs[tag])
        outs[tag + "_printed"] = _run(tool, ["fix", outs[tag]] + extra, capsys).replace(
            outs[tag], "OUT")
    assert outs["torch_printed"] == outs["jax_printed"]
    assert "fixed 4 entries" in outs["torch_printed"]
    _assert_files_equal(outs["torch"], outs["jax"])
    with h5py.File(outs["torch"], "r") as f:
        for g in f:
            for k in f[g]:
                d = f[g][k]
                assert int(d.attrs["n_samples"]) == d.shape[-1] and "n_ch" not in d.attrs
                assert int(d.attrs["n_channels"]) == (d.shape[0] if d.ndim == 2 else 1)


@pytest.mark.parametrize("n", STREAM_LENS)
def test_byte_streams_round_trip(tmp_path, n):
    """A 1-D uint8 stream shorter or longer than one of the writer's chunks
    (48000 elements) reads back bit for bit through h5py and H5File."""
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8)
    path = str(tmp_path / "s.hdf5")
    with H5Writer(path) as w:
        w.create_dataset("noise/s", data, attrs={"n_samples": np.array([n * 3])})
    with h5py.File(path, "r") as f:
        assert f["noise/s"].dtype == np.uint8
        np.testing.assert_array_equal(f["noise/s"][...], data)
        assert int(f["noise/s"].attrs["n_samples"][0]) == n * 3
    with H5File(path) as f:
        np.testing.assert_array_equal(f["noise"]["s"][...], data)
