"""The port's HDF5 reader and writer (`deepfilternet_torch/data/h5file.py`)
against h5py, on the CPU.

  * the reader on the files JAX's `prepare_data.prepare` writes (int16 and
    float32), and on files h5py writes here that cover each feature of the
    subset: a group of 300+ keys (a group B-tree of two levels), a 10 s clip
    in chunks of 1000 (a chunk B-tree of two levels), the shuffle filter,
    compact and contiguous layouts, uint8 streams, scalar and 1-element
    `n_samples`, fixed- and variable-length strings, big-endian numbers, a
    user block: every dataset (whole and sliced) and attribute equal to
    h5py's, values and types;
  * what the reader leaves out raises `NotImplementedError`: the fletcher32,
    lzf and scaleoffset filters (libver="latest" and track_order=True files,
    once refused here, are read in `tests/test_torch_h5file_latest.py`);
  * the writer: h5py reads back every dataset and attribute bit for bit,
    across groups of 300 keys and a chunk B-tree of two levels; JAX's
    `Hdf5Dataset` reads a port-written corpus as the port's does; the port's
    `prepare_data` merges into an existing file as JAX's does in mode "a".
"""

import os

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
pytest.importorskip("jax")

from deepfilternet_torch.data import h5file  # noqa: E402
from deepfilternet_torch.data.hdf5 import Hdf5Dataset  # noqa: E402
from deepfilternet_torch.scripts import prepare_data as t_prep  # noqa: E402
from deepfilternet_torch.utils.audio_io import save_audio  # noqa: E402
from deepfilternet_tpu.data.hdf5 import Hdf5Dataset as JHdf5Dataset  # noqa: E402
from deepfilternet_tpu.scripts import prepare_data as j_prep  # noqa: E402


def assert_same_value(got, want, where=""):
    """A value the port's reader returns against h5py's: same type, same
    numbers (arrays: dtype, shape and bytes)."""
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype)
        if want.dtype == object:
            assert got.tolist() == want.tolist(), where
        else:
            np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want or (np.isnan(got) and np.isnan(want)), (where, got, want)


def assert_same_file(path):
    """Every group, dataset and attribute the port reads equals h5py's."""
    with h5py.File(path, "r") as ref, h5file.H5File(path) as f:
        n = 0

        def walk(rg, g, prefix):
            nonlocal n
            assert set(g.attrs) == set(rg.attrs), prefix
            for k, v in rg.attrs.items():
                assert_same_value(g.attrs[k], v, f"{prefix}@{k}")
            assert g.keys() == list(rg.keys()), prefix
            for k in rg.keys():
                robj, obj = rg[k], g[k]
                if isinstance(robj, h5py.Group):
                    assert isinstance(obj, h5file.Group)
                    walk(robj, obj, f"{prefix}/{k}")
                    continue
                n += 1
                assert obj.shape == robj.shape and obj.dtype == robj.dtype, k
                assert obj.chunks == robj.chunks, k
                assert_same_value(obj[...], robj[...], f"{prefix}/{k}")
                if robj.ndim and robj.shape[-1] > 10:
                    t = robj.shape[-1]
                    for sl in (np.s_[..., 3:t - 2], np.s_[..., t // 3:t // 3 + 7],
                               np.s_[..., ::3], np.s_[..., -5:]):
                        assert_same_value(obj[sl], robj[sl], f"{prefix}/{k}{sl}")
                if robj.ndim == 2:
                    assert_same_value(obj[0], robj[0], f"{prefix}/{k}[0]")
                for a, v in robj.attrs.items():
                    assert_same_value(obj.attrs[a], v, f"{prefix}/{k}@{a}")
                assert set(obj.attrs) == set(robj.attrs)

        walk(ref, f["/"], "")
        return n


def _wavs(tmp_path, n, seconds, seed, channels=1):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = np.arange(int(48000 * seconds)) / 48000
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300, (channels, 1)) * t)
        x = x + 0.05 * rng.standard_normal(x.shape)
        p = str(tmp_path / f"clip_{seed}_{i}.wav")
        save_audio(p, x, 48000)
        out.append(p)
    return out


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_reader_on_jax_prepare_data(tmp_path, dtype):
    out = str(tmp_path / f"corpus_{dtype}.hdf5")
    j_prep.prepare("speech", out, _wavs(tmp_path, 3, 2.5, 1), dtype=dtype)
    j_prep.prepare("noise", out, _wavs(tmp_path, 2, 1.0, 2, channels=2), dtype=dtype,
                   max_freq=16000)
    assert assert_same_file(out) == 5


def test_reader_covers_each_feature(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "features.hdf5")
    with h5py.File(path, "w", userblock_size=512) as f:
        f.attrs["sr"] = 48000
        f.attrs["codec"] = "pcm"
        f.attrs.create("vascii", "ascii text", dtype=h5py.string_dtype("ascii"))
        f.attrs["fixed"] = np.bytes_(b"int16")
        f.attrs["fixed_arr"] = np.array([b"ab", b"cde"])
        f.attrs["vlen_arr"] = np.array(["speech", "noise"], dtype=h5py.string_dtype())
        f.attrs["f64"] = 0.25
        f.attrs["be"] = np.array([1, -2], ">i4")
        f.attrs["u8"] = np.uint8(7)
        many = f.create_group("many")
        for i in range(310):  # > 32 symbol-table nodes: a group B-tree of two levels
            d = many.create_dataset(f"k{i:03d}_{'x' * (i % 7)}",
                                    data=rng.integers(-9, 9, (1, 50 + i), dtype=np.int16),
                                    compression="gzip", compression_opts=2)
            d.attrs["n_samples"] = np.array([50 + i]) if i % 2 else 50 + i
        g = f.create_group("speech")
        long = rng.integers(-32768, 32767, (1, 480000), dtype=np.int16)
        g.create_dataset("long_chunks", data=long, chunks=(1, 1000), compression="gzip",
                         compression_opts=2)  # 480 chunks: a chunk B-tree of two levels
        g.create_dataset("shuffled", data=rng.standard_normal((2, 5000)).astype(np.float32),
                         chunks=(1, 777), shuffle=True, compression="gzip")
        g.create_dataset("shuffle_only", data=rng.integers(0, 1 << 30, 3000, dtype=np.int64),
                         chunks=(512,), shuffle=True)
        g.create_dataset("contiguous", data=rng.standard_normal((3, 100)))
        g.create_dataset("big_endian", data=rng.standard_normal((2, 300)).astype(">f4"),
                         chunks=(2, 128), compression="gzip")
        g.create_dataset("be_int", data=rng.integers(-1000, 1000, (1, 999)).astype(">i2"))
        g.create_dataset("stream", data=rng.integers(0, 256, 12345, dtype=np.uint8),
                         compression="gzip").attrs["n_samples"] = np.int64(48000)
        g.create_dataset("scalar", data=np.float32(1.5))
        g.create_dataset("empty", shape=(1, 0), dtype=np.int16)
        g.create_dataset("unwritten", shape=(2, 100), dtype=np.float32, chunks=(1, 10))
        partial = g.create_dataset("partial", shape=(1, 100), dtype=np.int16, chunks=(1, 10))
        partial[0, 35:47] = 3
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((2, 40))
        h5py.h5d.create(g.id, b"compact", h5py.h5t.STD_I16LE, space, dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, rng.integers(-99, 99, (2, 40), dtype=np.int16))
        nested = g.create_group("nested/deeper")
        nested.create_dataset("x", data=np.arange(10.0))
    assert assert_same_file(path) == 310 + 13
    with h5file.H5File(path) as f:
        assert "speech/nested/deeper/x" in f and "speech/nope" not in f
        assert f.attrs["vascii"] == "ascii text"
        with pytest.raises(KeyError):
            f["speech/missing"]


def _raises(path, match):
    with pytest.raises(NotImplementedError, match=match):
        with h5file.H5File(path) as f:
            def visit(g):
                for k in g.keys():
                    obj = g[k]
                    if isinstance(obj, h5file.Group):
                        visit(obj)
                    else:
                        obj[...]
            visit(f["/"])


def test_reader_refuses_what_it_does_not_cover(tmp_path):
    data = np.arange(1000, dtype=np.int16).reshape(1, -1)
    for name, kw, match in (("fletcher", dict(fletcher32=True, chunks=(1, 100)), "fletcher32"),
                            ("lzf", dict(compression="lzf"), "filter 32000"),
                            ("scaleoffset", dict(scaleoffset=0, chunks=(1, 100)), "scaleoffset")):
        path = str(tmp_path / f"{name}.hdf5")
        with h5py.File(path, "w") as f:
            f.create_dataset("a", data=data, **kw)
        _raises(path, match)
    with open(str(tmp_path / "plain.bin"), "wb") as f:
        f.write(b"\0" * 4096)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        h5file.H5File(str(tmp_path / "plain.bin"))


def test_writer_read_back_by_h5py(tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "written.hdf5")
    data, attrs = {}, {}
    with h5file.H5Writer(path) as w:
        root = {"sr": 48000, "max_freq": 24000, "codec": "pcm", "dtype": "int16",
                "db_name": "written.hdf5", "db_id": 1700000000, "unicode": "héllo ✓",
                "fixed": np.bytes_(b"abc"), "arr": np.array([0.5, 1.5], np.float32),
                "be": np.array([3, 4], ">i8")}
        for k, v in root.items():
            w.set_attr("/", k, v)
        for g in ("speech", "noise", "rir"):
            w.require_group(g)
        for i in range(300):  # a group B-tree of two levels
            d = rng.integers(-32768, 32767, (1, 1000 + 37 * i), dtype=np.int16)
            data[f"speech/s{i:03d}"] = d
            attrs[f"speech/s{i:03d}"] = {"n_samples": np.array([d.shape[-1]])}
        # 80 chunks of one second: a chunk B-tree of two levels; two channels
        data["noise/long"] = rng.standard_normal((2, 48000 * 80)).astype(np.float32)
        data["noise/short_f64"] = rng.standard_normal((1, 10))
        data["noise/uneven"] = rng.integers(0, 9, (3, 48001), dtype=np.uint16)
        data["rir/r"] = rng.standard_normal((1, 24000)).astype(np.float32)
        data["rir/stream"] = rng.integers(0, 256, 5000, dtype=np.uint8)
        attrs["rir/stream"] = {"n_samples": 24000, "note": "flac bytes"}
        for k, d in data.items():
            w.create_dataset(k, d, attrs=attrs.get(k))
    with h5py.File(path, "r") as f:
        assert list(f.keys()) == ["noise", "rir", "speech"]
        assert set(f.attrs) == set(root)
        for k, v in root.items():
            want = np.asarray(v) if isinstance(v, np.ndarray) else v
            got = f.attrs[k]
            if isinstance(v, np.ndarray):
                assert got.dtype == v.dtype
                np.testing.assert_array_equal(got, v)
            else:
                assert got == want and (type(got) is str) == isinstance(v, str), (k, got)
        assert len(f["speech"]) == 300
        for k, d in data.items():
            ds = f[k]
            assert ds.dtype == d.dtype and ds.shape == d.shape, k
            np.testing.assert_array_equal(ds[...], d, err_msg=k)
            for a, v in attrs.get(k, {}).items():
                got = ds.attrs[a]
                assert (got == v).all() if isinstance(v, np.ndarray) else got == v
        np.testing.assert_array_equal(f["noise/long"][1, 47990:96010],
                                      data["noise/long"][1, 47990:96010])
    assert assert_same_file(path) == len(data)
    with pytest.raises(KeyError):
        with h5file.H5Writer(str(tmp_path / "dup.hdf5")) as w:
            w.create_dataset("a/b", np.zeros(3))
            w.create_dataset("a/b", np.zeros(3))


def test_port_written_corpus_reads_alike(tmp_path):
    """JAX's Hdf5Dataset reads what the port's prepare_data wrote as the
    port's Hdf5Dataset does; both packages' prepare_data give the same file
    contents, the merge into an existing file included."""
    sp, ns = _wavs(tmp_path, 4, 1.5, 3), _wavs(tmp_path, 2, 1.0, 4, channels=2)
    for d in ("ours", "theirs"):
        (tmp_path / d).mkdir()
    ours, theirs = str(tmp_path / "ours/corpus.hdf5"), str(tmp_path / "theirs/corpus.hdf5")
    for mod, out in ((t_prep, ours), (j_prep, theirs)):
        mod.prepare("speech", out, sp[:3], max_freq=20000)
        mod.prepare("noise", out, ns, dtype="float32")
        mod.prepare("speech", out, sp[1:])  # replaces two keys, adds one
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        assert {k: v for k, v in a.attrs.items() if k != "db_id"} == \
            {k: v for k, v in b.attrs.items() if k != "db_id"}
        for g in ("speech", "noise"):
            assert list(a[g].keys()) == list(b[g].keys())
            for k in b[g].keys():
                assert a[g][k].dtype == b[g][k].dtype
                np.testing.assert_array_equal(a[g][k][...], b[g][k][...])
                np.testing.assert_array_equal(a[g][k].attrs["n_samples"],
                                              b[g][k].attrs["n_samples"])
        assert "rir" not in a and "rir" not in b
    assert os.listdir(tmp_path / "ours") == ["corpus.hdf5"]  # no temporary file left
    t, j = Hdf5Dataset(ours), JHdf5Dataset(ours)
    assert (t.sr, t.max_freq, t.codec, t.dtype, t.groups) == (j.sr, j.max_freq, j.codec,
                                                              j.dtype, j.groups)
    for g in t.groups:
        assert t.keys(g) == j.keys(g)
        for k in t.keys(g):
            assert t.sample_len(g, k) == j.sample_len(g, k)
            np.testing.assert_array_equal(t.read(g, k), j.read(g, k))
            r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
            np.testing.assert_array_equal(t.read(g, k, 20000, r1), j.read(g, k, 20000, r2))
    t.close()
    j.close()
