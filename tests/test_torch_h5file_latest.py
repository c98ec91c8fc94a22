"""The port's HDF5 reader (`deepfilternet_torch/data/h5file.py` over
`data/h5v2.py`) on the newer file formats h5py writes, against h5py, on the
CPU:

  * each structure, written by h5py into tmp_path and read back equal to
    h5py (every dataset whole and sliced, every attribute with its type,
    `keys()` in h5py's order): superblock 3 (`libver="latest"`) and 2
    (`("v108", "latest")`); `track_order=True` on the file and on a group;
    3,000 keys (an indirect heap block, a name index of depth 2); 200
    attributes in dense storage; an attribute heap of nested indirect blocks
    and a huge attribute; layout 4 with a single chunk (filtered and not), an
    implicit index, a paged fixed array, an extensible array with secondary
    blocks and paged data blocks, a v2 B-tree chunk index (filtered and not);
    compact, contiguous, shuffle plus gzip, unwritten chunks and fill values;
  * the named refusals (soft and external links in link messages, the
    superblock extension) and the checksums (one byte flipped in an object
    header, a B-tree leaf, a heap direct block, a fixed array data block:
    `ValueError` naming it). h5py never opens a corrupted file: it aborts the
    interpreter on some;
  * against the JAX package on the committed corpus and on a latest-format
    copy of a JAX `prepare_data` corpus: `Hdf5Dataset`, `TdDataset` samples,
    the `prepare_data` merge and `hdf5_tool` list / split / trim / fix (the
    merge and `fix` edit the file in place; `tests/test_torch_h5edit.py`
    holds the writer's mode "a" to h5py's);
  * the committed corpus (`deepfilternet_torch/data/testdata/`) holds what
    `write_latest_corpus` makes and carries the structures it should.

Regenerate the committed corpus (h5py needed):
    PYTHONPATH=. python tests/test_torch_h5file_latest.py
"""

import functools
import hashlib
import json
import os
import re
import shutil
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_h5file import _wavs, assert_same_file  # noqa: E402

from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.data import dataset as t_ds  # noqa: E402
from deepfilternet_torch.data import h5file  # noqa: E402
from deepfilternet_torch.data.hdf5 import Hdf5Dataset  # noqa: E402
from deepfilternet_torch.scripts import hdf5_tool as t_tool  # noqa: E402
from deepfilternet_torch.scripts import prepare_data as t_prep  # noqa: E402
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.data import dataset as j_ds  # noqa: E402
from deepfilternet_tpu.data.hdf5 import Hdf5Dataset as JHdf5Dataset  # noqa: E402
from deepfilternet_tpu.scripts import hdf5_tool as j_tool  # noqa: E402
from deepfilternet_tpu.scripts import prepare_data as j_prep  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "deepfilternet_torch", "data", "testdata")
SR = 48000


# -- the committed corpus ------------------------------------------------------------

# (group, clips, seconds from, to, amplitude) of each file; the noise group
# keeps its creation order (track_order=True) and its clips are made out of
# name order
CORPUS = {"speech": (16, 0.5, 1.0, 0.2), "noise": (10, 0.3, 0.6, 0.02),
          "rir": (4, 0.1, 0.25, 0.5)}
DB_ID = 1760000000  # prepare_data writes the time; the fixture a constant


def _clip(rng, group, seconds, amplitude, channels=1):
    t = np.arange(int(SR * seconds)) / SR
    if group == "speech":
        f0 = rng.uniform(100, 300, (channels, 1))
        x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5))
        x = x * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) + 0.01 * rng.standard_normal(x.shape)
    elif group == "noise":
        x = rng.standard_normal((channels, t.size))
    else:
        x = rng.standard_normal((channels, t.size)) * np.exp(-t / rng.uniform(0.02, 0.06))
    return amplitude * x


def write_latest_corpus(out_dir, seed=0):
    """speech.hdf5, noise.hdf5 and rir.hdf5 in `out_dir`, written by h5py with
    libver="latest" as JAX's prepare_data writes a corpus (int16 [C, T] clips
    compressed by gzip at level 2, an `n_samples` attribute each, its root
    attributes) plus four more root attributes (ten: dense storage); the
    noise group with track_order=True, one of its clips stereo. Then
    MANIFEST.json: each file's groups, each key's shape and the sha256 of its
    int16 bytes. Returns the manifest."""
    rng = np.random.default_rng(seed)
    manifest = {}
    for name, (n, lo, hi, amplitude) in CORPUS.items():
        path = os.path.join(out_dir, f"{name}.hdf5")
        keys, entry = {}, {}
        with h5py.File(path, "w", libver="latest") as f:
            for k, v in (("sr", SR), ("max_freq", SR // 2), ("codec", "pcm"),
                         ("dtype", "int16"), ("db_name", f"{name}.hdf5"), ("db_id", DB_ID),
                         ("generator", "tests/test_torch_h5file_latest.py"), ("seed", seed),
                         ("libver", "latest"), ("clips", n)):
                f.attrs[k] = v
            group = f.create_group(name, track_order=name == "noise")
            order = rng.permutation(n) if name == "noise" else range(n)
            for i in order:
                key = f"{name}_{i:03d}"
                channels = 2 if name == "noise" and i == 1 else 1
                audio = _clip(rng, name, rng.uniform(lo, hi), amplitude, channels)
                data = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
                ds = group.create_dataset(key, data=data, compression="gzip", compression_opts=2)
                ds.attrs["n_samples"] = np.array([data.shape[-1]])
                keys[key] = {"shape": list(data.shape),
                             "sha256": hashlib.sha256(data.tobytes()).hexdigest()}
            entry[name] = {"order": list(group.keys()), "keys": keys}
        manifest[f"{name}.hdf5"] = entry
    with open(os.path.join(out_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


def _signatures(path):
    data = open(path, "rb").read()
    return {s.decode(): len(re.findall(s, data)) for s in
            (b"OHDR", b"OCHK", b"FRHP", b"FHDB", b"FHIB", b"BTHD", b"BTIN", b"BTLF", b"FAHD",
             b"FADB", b"EAHD", b"EAIB", b"EASB", b"EADB")}


def _btree_types(path):
    data = open(path, "rb").read()
    return {data[m.start() + 5] for m in re.finditer(b"BTHD", data)}


def test_committed_corpus_provenance(tmp_path):
    """The committed files hold exactly what the generator makes (through
    h5py) and carry the structures they are there for."""
    want = write_latest_corpus(str(tmp_path))
    with open(os.path.join(TESTDATA, "MANIFEST.json")) as f:
        assert json.load(f) == want
    for name in CORPUS:
        committed, made = os.path.join(TESTDATA, f"{name}.hdf5"), str(tmp_path / f"{name}.hdf5")
        with h5py.File(committed, "r") as a, h5py.File(made, "r") as b:
            assert dict(a.attrs) == dict(b.attrs) and list(a) == list(b) == [name]
            assert list(a[name]) == list(b[name]) == want[f"{name}.hdf5"][name]["order"]
            for k in b[name]:
                assert a[name][k].dtype == np.int16 and a[name][k].compression == "gzip"
                np.testing.assert_array_equal(a[name][k][...], b[name][k][...])
                assert a[name][k].attrs["n_samples"] == b[name][k].attrs["n_samples"]
        with open(committed, "rb") as f:
            assert f.read(9)[8] == 3  # superblock version 3
        sig = _signatures(committed)
        # dense root attributes (a heap and a name index, v2 B-tree type 8);
        # dense links in speech and noise (type 5), noise's creation-order
        # index (type 6); fixed-array chunk indexes
        want_trees = {"speech": {5, 8}, "noise": {5, 6, 8}, "rir": {8}}[name]
        assert _btree_types(committed) == want_trees, (name, sig)
        assert sig["FRHP"] == (1 if name == "rir" else 2), (name, sig)
        if name != "rir":
            assert sig["FAHD"] >= 1 and sig["FADB"] >= 1, (name, sig)
    assert want["noise.hdf5"]["noise"]["order"] != sorted(want["noise.hdf5"]["noise"]["order"])
    total = sum(os.path.getsize(os.path.join(TESTDATA, n)) for n in os.listdir(TESTDATA))
    assert total <= 2 << 20


def test_committed_corpus_against_manifest():
    """What the card's check does without h5py: every key through H5File
    and Hdf5Dataset against the manifest's sha256, the noise group in
    creation order."""
    with open(os.path.join(TESTDATA, "MANIFEST.json")) as f:
        manifest = json.load(f)
    for fname, groups in manifest.items():
        path = os.path.join(TESTDATA, fname)
        ds = Hdf5Dataset(path)
        with h5file.H5File(path) as f:
            for g, entry in groups.items():
                assert f[g].keys() == entry["order"]
                for k, want in entry["keys"].items():
                    data = f[g][k][...]
                    assert list(data.shape) == want["shape"] and data.dtype == np.int16
                    assert hashlib.sha256(data.tobytes()).hexdigest() == want["sha256"]
                    np.testing.assert_array_equal(ds.read(g, k), data.astype(np.float32) / 32768)
        ds.close()
        assert_same_file(path)


# -- each structure, against h5py ------------------------------------------------------


def _rng():
    return np.random.default_rng(11)


def _latest(path, **kw):
    return h5py.File(path, "w", libver="latest", **kw)


def case_superblock3(path):
    rng = _rng()
    with _latest(path) as f:
        for i in range(12):
            f.attrs[f"attr{i:02d}"] = i * 1.5
        g = f.create_group("speech")
        for i in range(17):  # > 8 links: dense storage
            d = g.create_dataset(f"k{i:02d}", data=rng.integers(-99, 99, (1, 5000 + 97 * i),
                                                                dtype=np.int16),
                                 compression="gzip", compression_opts=2)
            d.attrs["n_samples"] = np.array([5000 + 97 * i])
        small = f.create_group("few")
        small.create_dataset("b", data=np.arange(5))
        small.create_dataset("a", data=np.arange(3.0))
        f.create_group("empty")
        d = f.create_dataset("grown", data=np.arange(100, dtype=np.int32))
        for i in range(6):  # attributes added later: a continuation block
            d.attrs[f"late{i:02d}"] = np.arange(64.0) + i


def case_superblock2(path):
    rng = _rng()
    with h5py.File(path, "w", libver=("v108", "latest")) as f:
        f.attrs["sr"] = SR
        g = f.create_group("speech")
        for i in range(12):
            g.create_dataset(f"s{i}", data=rng.integers(-99, 99, (1, 3000), dtype=np.int16),
                             chunks=(1, 1000), compression="gzip")


def case_track_order_file(path):
    with h5py.File(path, "w", track_order=True) as f:
        for k in ("zeta", "alpha", "mid", "beta"):
            f.create_dataset(k, data=np.arange(len(k)))
            f.attrs[k] = len(k)
        g = f.create_group("inner")
        for k in ("b", "c", "a"):
            g.create_dataset(k, data=np.arange(3))


def case_track_order_group_default_libver(path):
    """A tracked group in a file of h5py's default format: a version-2
    header under superblock 0 (a read the reader refused before)."""
    with h5py.File(path, "w") as f:
        g = f.create_group("speech", track_order=True)
        g.create_dataset("b", data=np.arange(1000, dtype=np.int16).reshape(1, -1))
        g.create_dataset("a", data=np.arange(10, dtype=np.int16).reshape(1, -1),
                         compression="gzip")
        f.create_group("noise").create_dataset("n", data=np.ones((1, 5), np.int16))


def case_track_order_group(path):
    rng = _rng()
    with _latest(path) as f:
        dense = f.create_group("dense", track_order=True)
        compact = f.create_group("compact", track_order=True)
        for i in rng.permutation(20):
            dense.create_dataset(f"n{i:02d}", data=np.full(3, i))
        for i in (5, 1, 3):
            compact.create_dataset(f"c{i}", data=np.full(2, i))
        plain = f.create_group("plain")
        for i in rng.permutation(20):
            plain.create_dataset(f"p{i:02d}", data=np.full(2, i))


def case_many_keys(path):
    with _latest(path) as f:
        g = f.create_group("speech")
        for i in range(3000):  # an indirect heap block; a name index of depth 2
            g.create_dataset(f"clip_{i:05d}", data=np.array([i], np.int16))


def case_dense_attrs(path):
    rng = _rng()
    with _latest(path) as f:
        d = f.create_dataset("x", data=np.arange(10))
        for target in (f, d):
            for i in range(100):
                target.attrs[f"v{i:03d}"] = f"text {i} " * (i % 5)
                target.attrs[f"n{i:03d}"] = rng.standard_normal(i % 4 + 1)
            target.attrs.create("fixed", np.bytes_(b"abc"))
            target.attrs["vlen_arr"] = np.array(["a", "bcd"], dtype=h5py.string_dtype())


def case_large_attrs(path):
    rng = _rng()
    with _latest(path) as f:
        for i in range(220):  # ~880 KB of managed objects: nested indirect blocks
            f.attrs[f"a{i:03d}"] = rng.integers(0, 1 << 30, 500, dtype=np.int64)
        f.attrs["huge"] = rng.standard_normal(20000)  # 160 KB: a huge object
        g = f.create_group("g")
        for i in range(10):
            g.attrs[f"s{i}"] = i
        g.attrs["huge"] = np.arange(9000, dtype=np.int32)
        d = g.create_dataset("x", data=np.arange(7))
        for i in range(10):
            d.attrs[f"t{i}"] = "x" * (500 * i)


def case_single_chunk(path):
    rng = _rng()
    with _latest(path) as f:
        f.create_dataset("plain", data=rng.integers(-9, 9, (2, 700), dtype=np.int16),
                         chunks=(2, 700))
        f.create_dataset("gzip", data=rng.integers(-9, 9, (1, 5000), dtype=np.int16),
                         chunks=(1, 5000), compression="gzip", compression_opts=2)
        f.create_dataset("unwritten", shape=(3, 40), dtype=np.float32, chunks=(3, 40))


def case_implicit(path):
    rng = _rng()
    with _latest(path) as f:
        for name, shape, chunks in (("a", (3, 1000), (2, 300)), ("b", (5000,), (512,))):
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk(chunks)
            dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
            space = h5py.h5s.create_simple(shape)
            h5py.h5d.create(f.id, name.encode(), h5py.h5t.STD_I16LE, space, dcpl=dcpl).write(
                h5py.h5s.ALL, h5py.h5s.ALL, rng.integers(-99, 99, shape, dtype=np.int16))


def case_fixed_array(path):
    rng = _rng()
    with _latest(path) as f:
        f.create_dataset("paged", data=rng.integers(-999, 999, (1, 1_100_000), dtype=np.int16),
                         chunks=(1, 1000), compression="gzip", compression_opts=2)
        sparse = f.create_dataset("sparse", shape=(1, 3_100_000), dtype=np.int16,
                                  chunks=(1, 1000))  # 4 pages, the middle two never written
        sparse[0, 3500:4200] = 5
        sparse[0, 3_099_990:] = 6
        f.create_dataset("few", data=rng.standard_normal((3, 900)), chunks=(2, 200),
                         maxshape=(10, 2000))  # over the maximum dimensions' grid


def case_extensible_array(path):
    with _latest(path) as f:
        f.create_dataset("secondary", data=np.arange(120_000, dtype=np.int16) % 977,
                         chunks=(100,), maxshape=(None,))  # 1,200 chunks
        f.create_dataset("gzip", data=(np.arange(60_000) % 313).astype(np.int16),
                         chunks=(50,), maxshape=(None,), compression="gzip")
        f.create_dataset("second_dim", data=np.arange(3 * 9000, dtype=np.float32).reshape(3, 9000),
                         chunks=(2, 100), maxshape=(3, None))  # the unlimited dimension moved
        paged = f.create_dataset("paged", shape=(140_000,), dtype=np.int16, chunks=(1,),
                                 maxshape=(None,))  # data blocks of 2,048 in pages of 1,024
        paged[5] = 1
        paged[131_500:131_600] = 2
        paged[139_000] = 7


def case_btree2(path):
    rng = _rng()
    with _latest(path) as f:
        f.create_dataset("plain", data=rng.integers(-9, 9, (60, 700), dtype=np.int16),
                         chunks=(3, 10), maxshape=(None, None))  # 1,400 chunks: internal nodes
        f.create_dataset("gzip", data=rng.integers(-9, 9, (20, 900), dtype=np.int16),
                         chunks=(4, 25), maxshape=(None, None), compression="gzip")
        sparse = f.create_dataset("sparse", shape=(30, 30), dtype=np.float64, chunks=(4, 4),
                                  maxshape=(None, None))
        sparse[10:13, 3:20] = 1.25


def case_layouts(path):
    rng = _rng()
    with _latest(path) as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((2, 40))
        h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I16LE, space, dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, rng.integers(-99, 99, (2, 40), dtype=np.int16))
        f.create_dataset("contiguous", data=rng.standard_normal((3, 100)))
        f.create_dataset("shuffle_gzip", data=rng.standard_normal((2, 5000)).astype(np.float32),
                         chunks=(1, 777), shuffle=True, compression="gzip")
        part = f.create_dataset("unwritten", shape=(2, 100), dtype=np.int16, chunks=(1, 10))
        part[1, 35:47] = 3
        f.create_dataset("filled", shape=(1, 50), dtype=np.float32, chunks=(1, 8),
                         fillvalue=-2.5)[0, 9:20] = 4.0
        f.create_dataset("filled_contiguous", shape=(4,), dtype=np.int32, fillvalue=7)
        f.create_dataset("scalar", data=np.float32(1.5))
        f.create_dataset("empty", shape=(1, 0), dtype=np.int16)
        f.create_dataset("big_endian", data=rng.standard_normal((2, 300)).astype(">f4"),
                         chunks=(2, 128), compression="gzip")
        f.create_dataset("stream", data=rng.integers(0, 256, 12345, dtype=np.uint8),
                         compression="gzip").attrs["n_samples"] = np.int64(48000)


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_equals_h5py(tmp_path, case):
    path = str(tmp_path / f"{case}.hdf5")
    CASES[case](path)
    assert assert_same_file(path) >= 1
    # dense attributes come in h5py's order too (by name where the object
    # does not track creation order)
    with h5py.File(path, "r") as ref, h5file.H5File(path) as f:
        if len(ref.attrs) > 8:
            assert list(f.attrs) == list(ref.attrs)


def test_structures_of_the_cases(tmp_path):
    """The cases carry what they are named for."""
    want = {"many_keys": ("FHIB", "BTIN"), "large_attrs": ("FHIB",),
            "fixed_array": ("FAHD", "FADB"), "extensible_array": ("EAIB", "EASB", "EADB"),
            "btree2": ("BTIN",), "superblock3": ("OCHK",)}
    for case, sigs in want.items():
        path = str(tmp_path / f"{case}.hdf5")
        CASES[case](path)
        found = _signatures(path)
        assert all(found[s] for s in sigs), (case, found)
    CASES["superblock2"](str(tmp_path / "v108.hdf5"))
    with open(tmp_path / "v108.hdf5", "rb") as f:
        assert f.read(9)[8] == 2


def _visit(path):
    with h5file.H5File(path) as f:
        def visit(g):
            for k in g.keys():
                obj = g[k]
                if isinstance(obj, h5file.Group):
                    visit(obj)
                else:
                    obj[...]
                    obj.attrs
        visit(f["/"])


def _soft(path):
    with _latest(path) as f:
        f.create_dataset("a", data=np.arange(3))
        f["link"] = h5py.SoftLink("/a")


def _external(path):
    with _latest(path) as f:
        f.create_dataset("a", data=np.arange(3))
        f["link"] = h5py.ExternalLink("other.hdf5", "/a")


def _extension(path):
    with h5py.File(path, "w", libver="latest", fs_strategy="page", fs_persist=True) as f:
        f.create_dataset("a", data=np.arange(3))


@pytest.mark.parametrize("make,match", [(_soft, "soft links"), (_external, "external links"),
                                        (_extension, "superblock extension")],
                         ids=["soft_link", "external_link", "superblock_extension"])
def test_named_refusals(tmp_path, make, match):
    """h5py writes no filtered fractal heap or filtered huge object (no API
    sets a heap's filters), so those refusals are not tested here."""
    path = str(tmp_path / "refused.hdf5")
    make(path)
    with pytest.raises(NotImplementedError, match=match):
        _visit(path)


@pytest.mark.parametrize("signature,what,case", [
    (b"OHDR", "object header", "superblock3"),
    (b"BTLF", "v2 B-tree leaf node", "superblock3"),
    (b"FHDB", "fractal heap direct block", "superblock3"),
    (b"FADB", "fixed array data block", "superblock3"),
    (b"EAIB", "extensible array index block", "extensible_array"),
    (b"FRHP", "fractal heap header", "superblock3"),
])
def test_checksums(tmp_path, signature, what, case):
    """One byte flipped inside a structure (past its signature and version):
    the port raises ValueError naming it. Never opened with h5py."""
    path = str(tmp_path / "good.hdf5")
    CASES[case](path)
    data = bytearray(open(path, "rb").read())
    at = data.index(signature)
    if signature == b"OHDR":
        at = data.index(signature, at + 4)  # not the root's: one the walk reaches later
        flags = data[at + 5]
        # past the times, phase-change values and chunk 0's size: a message
        at += 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0) + (1 << (flags & 3))
    elif signature == b"FHDB":
        at += 4 + 1 + 8 + 4 + 4  # past the block's prefix and checksum: an object
    else:
        at += 8
    data[at + 2] ^= 0x10
    bad = str(tmp_path / "bad.hdf5")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(ValueError, match=what):
        _visit(bad)


# -- against the JAX package -------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _fresh_configs():
    j_config.reset()
    t_config.reset()
    yield
    j_config.reset()
    t_config.reset()


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{"committed": a copy of the committed corpus' directory, "jax": a
    directory of JAX prepare_data corpora written with libver="latest"}."""
    root = tmp_path_factory.mktemp("latest")
    committed = root / "committed"
    shutil.copytree(TESTDATA, committed)
    jax_dir = root / "jax"
    jax_dir.mkdir()
    latest = functools.partial(h5py.File, libver="latest")
    real = j_prep.h5py.File
    j_prep.h5py.File = latest
    try:
        sp = _wavs(jax_dir, 10, 0.6, 21)
        j_prep.prepare("speech", str(jax_dir / "speech.hdf5"), sp, max_freq=20000)
        j_prep.prepare("noise", str(jax_dir / "noise.hdf5"), _wavs(jax_dir, 3, 0.5, 22, 2))
        j_prep.prepare("rir", str(jax_dir / "rir.hdf5"), _wavs(jax_dir, 2, 0.2, 23))
    finally:
        j_prep.h5py.File = real
    with open(jax_dir / "speech.hdf5", "rb") as f:
        assert f.read(9)[8] == 3
    return {"committed": committed, "jax": jax_dir}


@pytest.mark.parametrize("which", ["committed", "jax"])
def test_hdf5_dataset_matches_jax(corpora, which):
    for name in ("speech", "noise", "rir"):
        path = str(corpora[which] / f"{name}.hdf5")
        t, j = Hdf5Dataset(path), JHdf5Dataset(path)
        assert (t.sr, t.max_freq, t.codec, t.dtype, t.groups) == (j.sr, j.max_freq, j.codec,
                                                                  j.dtype, j.groups)
        for g in t.groups:
            assert t.keys(g) == j.keys(g) and t.keys(g)
            for k in t.keys(g):
                assert t.sample_len(g, k) == j.sample_len(g, k)
                np.testing.assert_array_equal(t.read(g, k), j.read(g, k))
                r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
                np.testing.assert_array_equal(t.read(g, k, 9000, r1), j.read(g, k, 9000, r2))
        t.close()
        j.close()


@pytest.mark.parametrize("which", ["committed", "jax"])
def test_td_dataset_matches_jax(corpora, which):
    cfgs = [("speech.hdf5", 1), ("noise.hdf5", 1), ("rir.hdf5", 1)]
    kw = dict(max_len_s=0.4, p_reverb=0.5, p_interfer_sp=0.3, seed=3)
    t = t_ds.TdDataset(str(corpora[which]), [t_ds.Hdf5Cfg(*c) for c in cfgs], "train", **kw)
    j = j_ds.TdDataset(str(corpora[which]), [j_ds.Hdf5Cfg(*c) for c in cfgs], "train", **kw)
    assert len(t) == len(j) > 0
    for idx in range(len(t)):
        a, b = t.get_sample(idx, 100 + idx), j.get_sample(idx, 100 + idx)
        assert a.keys() == b.keys()
        for k in a:
            assert type(a[k]) is type(b[k]), k
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{idx} {k}")


def _superblock_version(path):
    with open(path, "rb") as f:
        return f.read(9)[8]


def _same_contents(got, want):
    """Same root attributes but db_id, groups, keys, values and attributes
    (h5py), every group and attribute list in the same h5py iteration order
    (creation order where tracked: the port edits a file in place as h5py
    does), and the same superblock version."""
    assert _superblock_version(got) == _superblock_version(want)
    with h5py.File(got, "r") as a, h5py.File(want, "r") as b:
        assert {k: v for k, v in a.attrs.items() if k != "db_id"} == \
            {k: v for k, v in b.attrs.items() if k != "db_id"}
        assert list(a.attrs) == list(b.attrs)
        assert list(a) == list(b)
        for g in b:
            assert list(a[g]) == list(b[g])
            for k in b[g]:
                assert a[g][k].dtype == b[g][k].dtype
                np.testing.assert_array_equal(a[g][k][...], b[g][k][...])
                assert {n: np.asarray(v).tolist() for n, v in a[g][k].attrs.items()} == \
                    {n: np.asarray(v).tolist() for n, v in b[g][k].attrs.items()}
                assert list(a[g][k].attrs) == list(b[g][k].attrs)


@pytest.mark.parametrize("which,name", [("committed", "speech"), ("committed", "noise"),
                                        ("jax", "speech")])
def test_prepare_data_merge_matches_jax(corpora, which, name, tmp_path):
    """The port's prepare_data into a latest-format file (in place, as
    h5py's mode "a") against JAX's into a copy: the same keys, order, data
    and superblock version."""
    wavs = _wavs(tmp_path, 2, 0.4, 31)
    src = str(corpora[which] / f"{name}.hdf5")
    for d in ("ours", "theirs"):
        (tmp_path / d).mkdir()
    ours, theirs = str(tmp_path / "ours" / f"{name}.hdf5"), str(tmp_path / "theirs" / f"{name}.hdf5")
    shutil.copy(src, ours)
    shutil.copy(src, theirs)
    t_prep.prepare(name, ours, wavs)
    j_prep.prepare(name, theirs, wavs)
    _same_contents(ours, theirs)
    with h5file.H5File(ours) as f:
        assert len(f[name].keys()) == len(h5py.File(src, "r")[name]) + 2


def _run(tool, argv, capsys):
    capsys.readouterr()
    tool.main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("command", ["list", "split", "trim", "fix"])
def test_hdf5_tool_matches_jax(corpora, command, tmp_path, capsys):
    src = str(corpora["committed"] / "noise.hdf5")
    if command == "list":
        argv = ["list", src, "--max-keys", "20"]
        assert _run(t_tool, argv, capsys) == _run(j_tool, argv, capsys)
        return
    outs = {}
    for tag, tool in (("torch", t_tool), ("jax", j_tool)):
        d = tmp_path / tag
        d.mkdir()
        if command == "split":
            argv = ["split", src, str(d), "--ratios", "0.6,0.2,0.2", "--seed", "3"]
        elif command == "trim":
            argv = ["trim", src, str(d / "trim.hdf5"), "--max-len-s", "0.45"]
        else:
            shutil.copy(src, d / "fix.hdf5")
            argv = ["fix", str(d / "fix.hdf5"), "--max-freq", "16000"]
        outs[tag] = _run(tool, argv, capsys).replace(str(d), "OUT")
    assert outs["torch"] == outs["jax"]
    names = {"split": [f"noise_{s}.hdf5" for s in ("train", "valid", "test")],
             "trim": ["trim.hdf5"], "fix": ["fix.hdf5"]}[command]
    for n in names:
        _same_contents(str(tmp_path / "torch" / n), str(tmp_path / "jax" / n))


if __name__ == "__main__":
    os.makedirs(TESTDATA, exist_ok=True)
    made = write_latest_corpus(TESTDATA)
    print(f"wrote {sorted(made)} and MANIFEST.json to {TESTDATA}: "
          f"{sum(os.path.getsize(os.path.join(TESTDATA, n)) for n in os.listdir(TESTDATA))} "
          "bytes")
