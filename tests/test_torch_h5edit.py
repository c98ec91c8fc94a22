"""The port's HDF5 writer editing files in place (`H5Writer(path, "a")` in
`deepfilternet_torch/data/h5file.py`, over `data/h5v2.py`) against h5py
and the JAX package's scripts, on the CPU:

  (a) the port's `prepare_data` and JAX's (h5py's mode "a") on copies of a
      port-written file, an h5py default-format file, the committed
      superblock-3 speech.hdf5 and noise.hdf5 (its group in creation order),
      a superblock-2 ("v108", "latest") file and a track_order=True file:
      the same contents, h5py iteration order of every group and attribute
      and superblock version, read by h5py, `H5File` and JAX's
      `Hdf5Dataset`;
  (b) the old file's bytes outside the superblock are a prefix of the new
      file, which grew by at most the new chunks, the new clips' headers and
      chunk B-trees, the touched groups' structures and 4 KiB;
  (c) chains of edits both ways: JAX's `prepare` into a file the port
      edited, and the port's into one h5py edited;
  (d) a key replaced, a new content group, two appends in a row and an
      empty file list;
  (e) a WAV that fails to load halfway leaves the file byte-identical (and
      no file where the call would have created one);
  (f) a superblock-1 file raises `NotImplementedError` and stays as it was
      (written here by hand: h5py has no setter for the chunk B-tree K that
      makes HDF5 write one);
  (g) `hdf5_tool fix` against JAX's on copies, every chunk index entry
      unchanged;
  (h) `hdf5_tool split` and `trim` give the chunks of h5py's `copy`: the
      same raw bytes, filter masks, offsets and chunk shape.
"""

import functools
import itertools
import os
import shutil
import struct
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_h5file import _wavs, assert_same_file  # noqa: E402
from test_torch_h5file_latest import TESTDATA, _run, _same_contents  # noqa: E402

from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.data import h5file  # noqa: E402
from deepfilternet_torch.data.hdf5 import Hdf5Dataset  # noqa: E402
from deepfilternet_torch.scripts import hdf5_tool as t_tool  # noqa: E402
from deepfilternet_torch.scripts import prepare_data as t_prep  # noqa: E402
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.data.hdf5 import Hdf5Dataset as JHdf5Dataset  # noqa: E402
from deepfilternet_tpu.scripts import hdf5_tool as j_tool  # noqa: E402
from deepfilternet_tpu.scripts import prepare_data as j_prep  # noqa: E402

# each source file and the content group a merge writes into
CONTENT = {"port": "speech", "h5py": "speech", "speech3": "speech", "noise3": "noise",
           "v108": "speech", "tracked": "speech"}
PACKAGES = {"torch": t_prep, "jax": j_prep}


@pytest.fixture(scope="module", autouse=True)
def _fresh_configs():
    j_config.reset()
    t_config.reset()
    yield
    j_config.reset()
    t_config.reset()


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """{name: path} of the source files: written by the port's prepare_data,
    by JAX's (h5py's default format; ("v108", "latest"), superblock 2, with
    more than 8 speech clips: links in a fractal heap; track_order=True on
    the file: links and attributes in creation order, version-2 headers
    under superblock 0), and copies of the committed superblock-3 corpus."""
    root = tmp_path_factory.mktemp("sources")
    wav = root / "wav"
    wav.mkdir()
    sp, ns = _wavs(wav, 3, 0.4, 1), _wavs(wav, 2, 0.3, 2, channels=2)
    out = {}
    for name, mod in (("port", t_prep), ("h5py", j_prep)):
        out[name] = str(root / f"{name}.hdf5")
        mod.prepare("speech", out[name], sp)
        mod.prepare("noise", out[name], ns, dtype="float32")
    real = j_prep.h5py.File
    for name, kw in (("v108", dict(libver=("v108", "latest"))), ("tracked", dict(track_order=True))):
        out[name] = str(root / f"{name}.hdf5")
        j_prep.h5py.File = functools.partial(h5py.File, **kw)
        try:
            j_prep.prepare("speech", out[name], _wavs(wav, 10, 0.2, 3))
            j_prep.prepare("noise", out[name], ns)
        finally:
            j_prep.h5py.File = real
    for name, fname in (("speech3", "speech.hdf5"), ("noise3", "noise.hdf5")):
        out[name] = str(root / name / fname)
        os.makedirs(os.path.dirname(out[name]))
        shutil.copy(os.path.join(TESTDATA, fname), out[name])
    assert [_version(out[n]) for n in ("port", "h5py", "v108", "speech3")] == [0, 0, 2, 3]
    return out


def _version(path):
    with open(path, "rb") as f:
        return f.read(9)[8]


def _copies(src, tmp_path, tags=("torch", "jax")):
    """A copy of `src` under tmp_path/<tag>/ for each tag, same basename."""
    out = {}
    for tag in tags:
        (tmp_path / tag).mkdir()
        out[tag] = str(tmp_path / tag / os.path.basename(src))
        shutil.copy(src, out[tag])
    return out


def _read_alike(path):
    """h5py and H5File read every group, dataset and attribute alike, and
    JAX's Hdf5Dataset reads what the port's does."""
    assert assert_same_file(path) >= 1
    t, j = Hdf5Dataset(path), JHdf5Dataset(path)
    try:
        assert (t.sr, t.max_freq, t.codec, t.dtype, t.groups) == (j.sr, j.max_freq, j.codec,
                                                                  j.dtype, j.groups)
        for g in t.groups:
            assert t.keys(g) == j.keys(g)
            for k in t.keys(g):
                assert t.sample_len(g, k) == j.sample_len(g, k)
                np.testing.assert_array_equal(t.read(g, k), j.read(g, k))
    finally:
        t.close()
        j.close()


def _pad8(n):
    return (n + 7) & ~7


def _growth_bound(path, content, keys):
    """What an in-place merge of `keys` may add: their stored chunks, each
    clip's header (1 KiB) and chunk B-tree nodes (full width, 64 entries),
    the root's and the content group's structures written anew (a header
    of 1 KiB and its attributes; a symbol table's local heap, nodes of 8
    entries and B-tree nodes, or a link message a member), and one global
    heap collection of the new string attributes (4 KiB)."""
    bound = 4096
    with h5py.File(path, "r") as f, h5file.H5File(path) as r:
        for k in keys:
            d = f[content][k]
            n = d.id.get_num_chunks()
            bound += sum(d.id.get_chunk_info(i).size for i in range(n))
            leaves = -(-n // 64)
            bound += 1024 + (leaves + (leaves > 1)) * (24 + 64 * 8 + 65 * (16 + 8 * d.ndim))
        for g in (f, f[content]):
            names = [n.encode("utf-8") for n in g]
            bound += 1024 + sum(96 + len(a) + np.asarray(v).nbytes for a, v in g.attrs.items())
            if any(t == 0x11 for t, _, _ in r[g.name]._msgs):  # a symbol table
                snods = -(-len(names) // 8)
                bound += (48 + sum(_pad8(len(n) + 1) for n in names) + snods * 328
                          + (-(-snods // 32) + 1) * 544)
            else:
                bound += sum(24 + len(n) for n in names)
    return bound


# -- (a), (b): one merge against JAX's -------------------------------------------------


@pytest.mark.parametrize("src", sorted(CONTENT))
def test_merge_in_place_matches_jax(sources, src, tmp_path):
    content = CONTENT[src]
    wavs = _wavs(tmp_path, 3, 0.3, 41)
    paths = _copies(sources[src], tmp_path)
    before = open(paths["torch"], "rb").read()
    t_prep.prepare(content, paths["torch"], wavs)
    j_prep.prepare(content, paths["jax"], wavs)
    _same_contents(paths["torch"], paths["jax"])
    assert _version(paths["torch"]) == _version(sources[src])
    _read_alike(paths["torch"])
    # (b) no byte of the old file but its superblock changed; the growth is
    # the new data and the metadata it touched
    after = open(paths["torch"], "rb").read()
    sb = 96 if before[8] == 0 else 48
    assert after[sb:len(before)] == before[sb:]
    keys = [t_prep.sanitize_key(p) for p in wavs]
    grown, bound = len(after) - len(before), _growth_bound(paths["torch"], content, keys)
    assert 0 < grown <= bound, (grown, bound)


def test_growth_does_not_follow_the_file(sources, tmp_path):
    """(b) on a file many times the size (20 s more noise): the same merge
    grows both files alike."""
    wavs = _wavs(tmp_path, 2, 0.3, 42)
    small = _copies(sources["h5py"], tmp_path, ("small",))["small"]
    big = str(tmp_path / "big.hdf5")
    shutil.copy(sources["h5py"], big)
    j_prep.prepare("noise", big, _wavs(tmp_path, 20, 1.0, 43))
    grown = {}
    for path in (small, big):
        size = os.path.getsize(path)
        t_prep.prepare("speech", path, wavs)
        grown[path] = os.path.getsize(path) - size
    assert os.path.getsize(big) > 5 * os.path.getsize(small)
    assert abs(grown[big] - grown[small]) <= 4096, grown


# -- (c) chains of edits both ways ----------------------------------------------------


@pytest.mark.parametrize("first", ["torch", "jax"])
@pytest.mark.parametrize("src", sorted(CONTENT))
def test_edit_chain(sources, src, first, tmp_path):
    """One package edits the file, then the other (replacing one of the
    first's keys): as JAX alone on a copy, both readers alike."""
    content = CONTENT[src]
    wa, wb = _wavs(tmp_path, 2, 0.3, 51), _wavs(tmp_path, 2, 0.3, 52)
    paths = _copies(sources[src], tmp_path, ("chain", "ref"))
    second = "jax" if first == "torch" else "torch"
    PACKAGES[first].prepare(content, paths["chain"], wa)
    PACKAGES[second].prepare(content, paths["chain"], wb + wa[:1])
    j_prep.prepare(content, paths["ref"], wa)
    j_prep.prepare(content, paths["ref"], wb + wa[:1])
    _same_contents(paths["chain"], paths["ref"])
    _read_alike(paths["chain"])


# -- (d) replace, new group, appends in a row, no files ---------------------------------


@pytest.mark.parametrize("src", ["port", "h5py", "noise3", "v108"])
def test_merge_cases(sources, src, tmp_path):
    content = CONTENT[src]
    other = "speech" if content == "noise" else "rir"
    a, b, c = _wavs(tmp_path, 3, 0.25, 61)
    r = _wavs(tmp_path, 1, 0.1, 62)
    paths = _copies(sources[src], tmp_path)
    for mod in (t_prep, j_prep):
        path = paths["torch" if mod is t_prep else "jax"]
        mod.prepare(content, path, [a, b])
        mod.prepare(content, path, [b, c], max_freq=16000)  # b replaced
        mod.prepare(other, path, r)  # a new content group
        mod.prepare(content, path, [])  # attributes only
    _same_contents(paths["torch"], paths["jax"])
    _read_alike(paths["torch"])
    with h5py.File(paths["torch"], "r") as f:
        assert f.attrs["max_freq"] == 24000 and len(f[other]) == 1
        assert t_prep.sanitize_key(b) in f[content]


# -- (e) a failed call ------------------------------------------------------------------


@pytest.mark.parametrize("src", ["port", "speech3", None])
def test_failed_load_leaves_the_file(sources, src, tmp_path):
    good = _wavs(tmp_path, 2, 0.3, 71)
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"RIFF" + bytes(range(200)))
    if src is None:
        path = str(tmp_path / "new.hdf5")
    else:
        path = _copies(sources[src], tmp_path, ("t",))["t"]
        before = open(path, "rb").read()
    with pytest.raises(Exception, match="WAVE"):
        t_prep.prepare(CONTENT.get(src, "speech"), path, [good[0], bad, good[1]])
    if src is None:
        assert not os.path.exists(path)
    else:
        assert open(path, "rb").read() == before
        _read_alike(path)


# -- (f) superblock 1 --------------------------------------------------------------------


def test_superblock_1_is_refused(sources, tmp_path):
    """A superblock of version 1 (what HDF5 writes for a chunk B-tree K
    other than 32) at offset 0, before an h5py file with a 512-byte user
    block whose base address it names: the reader reads it, the writer
    refuses it by name and leaves it whole."""
    plain = str(tmp_path / "plain.hdf5")
    with h5py.File(plain, "w", userblock_size=512) as f:
        f.attrs["sr"] = 48000
        f.create_group("speech").create_dataset("a", data=np.arange(3000, dtype=np.int16)
                                                .reshape(1, -1), chunks=(1, 1000))
    data = bytearray(open(plain, "rb").read())
    sb0 = data[512:608]
    assert sb0[:8] == h5file.SIGNATURE and sb0[8] == 0
    leaf_k, internal_k = struct.unpack_from("<HH", sb0, 16)
    sb1 = (h5file.SIGNATURE + bytes([1, 0, 0, 0, 0, 8, 8, 0])
           + struct.pack("<HHIHH", leaf_k, internal_k, 0, 64, 0)
           + struct.pack("<4Q", 512, h5file.UNDEF, len(data), h5file.UNDEF) + sb0[56:96])
    data[:len(sb1)] = sb1
    path = str(tmp_path / "sb1.hdf5")
    open(path, "wb").write(bytes(data))
    with h5file.H5File(path) as f:
        assert f.superblock_version == 1
        np.testing.assert_array_equal(f["speech/a"][...], np.arange(3000).reshape(1, -1))
    for call in (lambda: t_prep.prepare("speech", path, _wavs(tmp_path, 1, 0.1, 81)),
                 lambda: t_tool.main(["fix", path])):
        with pytest.raises(NotImplementedError, match="superblock version 1"):
            call()
        assert open(path, "rb").read() == bytes(data)


# -- (g) fix in place ---------------------------------------------------------------------


def _chunk_entries(path):
    """{dataset: [(offset, filter mask, address, size)]} of every chunk, by
    h5py."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset) and obj.chunks:
                out[name] = [tuple(obj.id.get_chunk_info(i))
                             for i in range(obj.id.get_num_chunks())]
        f.visititems(visit)
    return out


@pytest.mark.parametrize("src", ["h5py", "port", "noise3", "v108"])
def test_fix_in_place_matches_jax(sources, src, tmp_path, capsys):
    broken = str(tmp_path / "broken.hdf5")
    shutil.copy(sources[src], broken)
    with h5py.File(broken, "r+") as f:
        g = f[CONTENT[src]]
        for i, k in enumerate(sorted(g)):
            if i % 2:
                g[k].attrs["n_samples"] = np.array([7])
            g[k].attrs["n_ch"] = 1
        del f.attrs["max_freq"]
    paths = _copies(broken, tmp_path)
    chunks = _chunk_entries(broken)
    size = os.path.getsize(broken)
    printed = {tag: _run(tool, ["fix", paths[tag]], capsys).replace(paths[tag], "OUT")
               for tag, tool in (("torch", t_tool), ("jax", j_tool))}
    assert printed["torch"] == printed["jax"] and "fixed" in printed["torch"]
    _same_contents(paths["torch"], paths["jax"])
    _read_alike(paths["torch"])
    assert _chunk_entries(paths["torch"]) == chunks
    after = open(paths["torch"], "rb").read()
    sb = 96 if after[8] == 0 else 48
    assert after[sb:size] == open(broken, "rb").read()[sb:]
    with h5py.File(paths["torch"], "r") as f:
        for k, d in f[CONTENT[src]].items():
            assert int(d.attrs["n_samples"]) == d.shape[-1] and "n_ch" not in d.attrs


# -- (h) split and trim copy chunks raw ----------------------------------------------------


def _direct_chunks(ds):
    """{offset: (filter mask, raw bytes)} of every stored chunk, by h5py's
    read_direct_chunk over the chunk grid (h5py's get_chunk_info reports
    wrong offsets for an extensible array whose unlimited dimension is not
    the first)."""
    out = {}
    for origin in itertools.product(*(range(0, n, c) for n, c in zip(ds.shape, ds.chunks))):
        try:
            out[origin] = ds.id.read_direct_chunk(origin)
        except (KeyError, OSError, RuntimeError, ValueError):
            continue  # never written
    assert len(out) == ds.id.get_num_chunks(), ds.name
    return out


def _same_chunks(got, want, names=None):
    """The datasets `names` (default: every chunked one) of `got` hold the
    chunks of `want`'s: chunk shape, filters, and each chunk's offset, mask
    and raw bytes. Returns how many were compared."""
    with h5py.File(got, "r") as a, h5py.File(want, "r") as b:
        if names is None:
            names = []
            b.visititems(lambda n, o: names.append(n) if isinstance(o, h5py.Dataset) else None)
        for name in names:
            x, y = a[name], b[name]
            assert (x.chunks, x.dtype, x.compression, x.compression_opts, x.shuffle) == \
                (y.chunks, y.dtype, y.compression, y.compression_opts, y.shuffle), name
            assert _direct_chunks(x) == _direct_chunks(y), name
        return len(names)


@pytest.mark.parametrize("command", ["split", "trim"])
@pytest.mark.parametrize("src", ["h5py", "port", "speech3"])
def test_split_trim_copy_chunks_raw(sources, src, command, tmp_path, capsys):
    outs = {}
    for tag, tool in (("torch", t_tool), ("jax", j_tool)):
        d = tmp_path / tag
        d.mkdir()
        if command == "split":
            argv = ["split", sources[src], str(d), "--ratios", "0.5,0.25,0.25", "--seed", "2"]
        else:
            # keeps some clips of each source and drops others
            argv = ["trim", sources[src], str(d / "trim.hdf5"), "--max-len-s",
                    "0.75" if src == "speech3" else "0.35"]
        outs[tag] = _run(tool, argv, capsys).replace(str(d), "OUT")
    assert outs["torch"] == outs["jax"]
    for name in sorted(os.listdir(tmp_path / "jax")):
        got, want = str(tmp_path / "torch" / name), str(tmp_path / "jax" / name)
        assert _same_chunks(got, want) >= 1
        _read_alike(got)


# -- the writer's mode "a" against h5py's, and the raw copy under every chunk index ----


def _edit_source(path, **kw):
    """An h5py file with what an edit must keep as it is: attributes the
    writer cannot encode (an array of variable-length strings, kept byte for
    byte), a group of 12 clips, and soft links in two groups the edit
    changes (a symbol table, or a group of link messages with its creation
    order where the format has them)."""
    rng = np.random.default_rng(91)
    with h5py.File(path, "w", **kw) as f:
        f.attrs["sr"] = 48000
        f.attrs["names"] = np.array(["speech", "noise"], dtype=h5py.string_dtype())
        f.attrs["fixed"] = np.bytes_(b"int16")
        g = f.create_group("speech")
        for i in range(12):
            d = g.create_dataset(f"k{i:02d}", data=rng.integers(-99, 99, (1, 700 + i), np.int16),
                                 compression="gzip", compression_opts=2, chunks=(1, 256))
            d.attrs["n_samples"] = np.array([700 + i])
            d.attrs["note"] = f"clip {i}"
        few = f.create_group("few", track_order=bool(kw))
        few.create_dataset("a", data=np.arange(3.0))
        few["soft"] = h5py.SoftLink("/few/a")
        f.create_group("links")["soft"] = h5py.SoftLink("/few/a")


def _edits(data):
    """The same edits through the port's writer (first) and h5py (second)."""
    def port(w):
        w.set_attr("/", "text", "héllo")
        w.set_attr("speech/k00", "n_samples", 5)
        w.del_attr("speech/k01", "note")
        w.delete("speech/k02")
        w.create_dataset("speech/k02", data["k02"], attrs={"n_samples": np.array([900])})
        w.create_dataset("deep/er/x", data["x"])
        w.require_group("empty")
        w.set_attr("few", "count", np.float32(2.5))
        w.set_attr("links", "n", 1)

    def h5(f):
        f.attrs["text"] = "héllo"
        f["speech/k00"].attrs["n_samples"] = 5
        del f["speech/k01"].attrs["note"]
        del f["speech/k02"]
        f["speech"].create_dataset("k02", data=data["k02"], compression="gzip",
                                   compression_opts=2).attrs["n_samples"] = np.array([900])
        f.create_dataset("deep/er/x", data=data["x"], compression="gzip", compression_opts=2)
        f.require_group("empty")
        f["few"].attrs["count"] = np.float32(2.5)
        f["links"].attrs["n"] = 1
    return port, h5


def _same_tree(got, want):
    """Every group (h5py's order), link, dataset and attribute (values,
    types, order) of `want` in `got`, soft links followed."""
    with h5py.File(got, "r") as a, h5py.File(want, "r") as b:
        def walk(x, y, where):
            assert list(x.attrs) == list(y.attrs), where
            for k in y.attrs:
                u, v = x.attrs[k], y.attrs[k]
                assert type(u) is type(v) and np.asarray(u).dtype == np.asarray(v).dtype, (where, k)
                assert np.asarray(u).tolist() == np.asarray(v).tolist(), (where, k)
            if isinstance(y, h5py.Dataset):
                assert x.dtype == y.dtype and x.shape == y.shape, where
                np.testing.assert_array_equal(x[...], y[...], err_msg=where)
                return
            assert list(x) == list(y), where
            for k in y:
                assert type(x.get(k, getlink=True)) is type(y.get(k, getlink=True)), (where, k)
                walk(x[k], y[k], f"{where}/{k}")
        walk(a, b, "")


@pytest.mark.parametrize("kw", [{}, {"libver": "latest"}, {"track_order": True}],
                         ids=["default", "latest", "track_order"])
def test_writer_edits_like_h5py(tmp_path, kw):
    src = str(tmp_path / "src.hdf5")
    _edit_source(src, **kw)
    data = {"k02": np.arange(5000, dtype=np.int16).reshape(1, -1),
            "x": np.linspace(0, 1, 77, dtype=np.float32)}
    port, h5 = _edits(data)
    paths = _copies(src, tmp_path)
    before = open(paths["torch"], "rb").read()
    with h5file.H5Writer(paths["torch"], "a") as w:
        assert "speech/k03" in w and "speech/nope" not in w and "links" in w
        port(w)
    with h5py.File(paths["jax"], "a") as f:
        h5(f)
    _same_tree(paths["torch"], paths["jax"])
    assert _version(paths["torch"]) == _version(src)
    after = open(paths["torch"], "rb").read()
    sb = 96 if before[8] == 0 else 48
    assert after[sb:len(before)] == before[sb:]
    with h5file.H5File(paths["torch"]) as f:
        np.testing.assert_array_equal(f["speech/k02"][...], data["k02"])
        assert f["/"].attrs["text"] == "héllo" and "note" not in f["speech/k01"].attrs
        assert f["speech"].keys() == [k for k in h5py.File(paths["jax"], "r")["speech"]]


def test_writer_refuses_and_leaves_the_file(tmp_path):
    """A value the writer cannot encode fails at close: the file is cut back
    to what it was. A key that exists, a path through a dataset, a missing
    key and a bad mode raise before anything is written; a call that
    changed nothing writes nothing."""
    path = str(tmp_path / "src.hdf5")
    _edit_source(path)
    before = open(path, "rb").read()
    with pytest.raises(NotImplementedError, match="writing attribute bad"):
        with h5file.H5Writer(path, "a") as w:
            w.create_dataset("speech/new", np.ones((1, 100), np.int16))
            w.set_attr("links", "bad", [1, "a"])
    assert open(path, "rb").read() == before
    with h5file.H5Writer(path, "a") as w:
        with pytest.raises(KeyError):
            w.create_dataset("speech/k00", np.zeros(3))
        with pytest.raises(KeyError):
            w.create_dataset("speech/k00/x", np.zeros(3))
        with pytest.raises(TypeError):
            w.require_group("speech/k00")
        with pytest.raises(KeyError):
            w.delete("speech/nope")
        with pytest.raises(KeyError):
            w.del_attr("speech/k00", "nope")
        w.require_group("speech")
    assert open(path, "rb").read() == before
    with pytest.raises(ValueError, match="mode"):
        h5file.H5Writer(path, "r+")


@pytest.mark.parametrize("case", ["single_chunk", "implicit", "fixed_array", "extensible_array",
                                  "btree2", "layouts"])
def test_copy_group_keeps_chunks_as_h5py_copy(tmp_path, case):
    """copy_group over the latest-format cases of every chunk index h5py
    writes: each chunked dataset's chunks as h5py's `copy` leaves them (raw
    bytes, masks, offsets, chunk shape, filters, fill value); the rest (and
    the values of all) read back as h5py reads the source."""
    from test_torch_h5file_latest import CASES

    src = str(tmp_path / "src.hdf5")
    CASES[case](src)
    ours, theirs = str(tmp_path / "ours.hdf5"), str(tmp_path / "theirs.hdf5")
    with h5file.H5File(src) as f, h5file.H5Writer(ours) as w:
        h5file.copy_group(f["/"], w)
    with h5py.File(src, "r") as f, h5py.File(theirs, "w") as g:
        for k in f:
            f.copy(f[k], g, name=k)
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        chunked = [k for k in b if isinstance(b[k], h5py.Dataset) and b[k].chunks]
        assert chunked
        for k in b:
            np.testing.assert_array_equal(a[k][...], b[k][...], err_msg=k)
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            if k in chunked:
                assert a[k].fillvalue == b[k].fillvalue, k
    assert _same_chunks(ours, theirs, chunked) == len(chunked)
    assert assert_same_file(ours) >= len(chunked)


def test_too_many_links_become_a_symbol_table(tmp_path, monkeypatch):
    """A changed group of link messages with more links than Group Info
    counts (65,535; lowered here to 10) is written as a symbol table, keys
    by name, which h5py reads (and edits) as it reads the links."""
    monkeypatch.setattr(h5file, "_MAX_LINK_MESSAGES", 10)
    path = str(tmp_path / "many.hdf5")
    with h5py.File(path, "w", libver="latest") as f:
        g = f.create_group("speech", track_order=True)
        for i in (7, 3, 11, 0, 5, 9, 1, 10, 2, 8, 4):
            g.create_dataset(f"k{i:02d}", data=np.full((1, 3), i, np.int16))
    with h5file.H5Writer(path, "a") as w:
        w.create_dataset("speech/k06", np.full((1, 3), 6, np.int16))
    with h5file.H5File(path) as f:
        assert any(t == 0x11 for t, _, _ in f["speech"]._msgs)  # a symbol table
        assert f.superblock_version == 3
    with h5py.File(path, "r") as f:
        assert list(f["speech"]) == [f"k{i:02d}" for i in range(12)]
        for i in range(12):
            assert (f["speech"][f"k{i:02d}"][...] == i).all()
    assert assert_same_file(path) == 12
    j_prep.prepare("speech", path, _wavs(tmp_path, 1, 0.1, 92))
    assert assert_same_file(path) == 13


def test_h5py_moves_attributes_dense_after_an_edit(tmp_path):
    """The committed superblock-3 root holds 10 attributes in dense storage;
    the port's edit writes them compact with the header's compact limit
    raised to their count, so h5py's next attribute moves them to dense
    storage again, as HDF5 keeps them."""
    path = str(tmp_path / "speech.hdf5")
    shutil.copy(os.path.join(TESTDATA, "speech.hdf5"), path)

    def dense(path):
        with h5file.H5File(path) as f:
            info = [d for t, _, _, d in f._header(f._root_addr).msgs if t == 0x15]
            return struct.unpack_from("<Q", info[0], 2 + (2 if info[0][1] & 1 else 0))[0] \
                != h5file.UNDEF
    assert dense(path)
    with h5file.H5Writer(path, "a") as w:
        w.set_attr("/", "edited", 1)
    assert not dense(path)
    with h5py.File(path, "a") as f:
        f.attrs["again"] = 2
    assert dense(path)
    with h5py.File(path, "r") as f:
        assert f.attrs["edited"] == 1 and f.attrs["again"] == 2 and len(f.attrs) == 12
