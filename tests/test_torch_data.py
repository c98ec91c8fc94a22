"""The port's data engine (`deepfilternet_torch/data/`, `ops/bandwidth.py`)
against the JAX package's, on the CPU, on corpora the test writes with h5py
(JAX's `prepare_data`) under tmp_path:

  * each augmentation from the same seeded Generator: equal to JAX's at 1e-6
    and the generator left in the same state (the same draws in the same
    order);
  * `TdDataset.get_sample` bit for bit over 24 (idx, seed) pairs, with
    reverb, interfering speakers, a corpus `max_freq` below sr/2, the
    bandwidth limiter, the `DF_P_*` knobs on, and fractional sampling
    factors across `set_epoch`; `FdDataset` features at 1e-6 (bandwidth
    extension included);
  * `DataLoader` batches equal to JAX's at num_workers 1 and 3, epochs and
    splits; multichannel `collate`; `DatasetConfig`;
  * a FLAC-coded corpus (bytes built by a helper with verbatim subframes:
    there is no encoder here) through `_native.decode_flac`;
  * the native library's `available()`, its build (renamed into place, no
    file left behind) and `biquad_chain` against scipy.
"""

import json
import os
import struct

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
pytest.importorskip("jax")

from deepfilternet_torch.data import _native as t_native  # noqa: E402
from deepfilternet_torch.data import augmentations as t_aug  # noqa: E402
from deepfilternet_torch.data import dataloader as t_dl  # noqa: E402
from deepfilternet_torch.data import dataset as t_ds  # noqa: E402
from deepfilternet_torch.ops import bandwidth as t_bw  # noqa: E402
from deepfilternet_torch.utils.audio_io import save_audio  # noqa: E402
from deepfilternet_tpu.data import _native as j_native  # noqa: E402
from deepfilternet_tpu.data import augmentations as j_aug  # noqa: E402
from deepfilternet_tpu.data import dataloader as j_dl  # noqa: E402
from deepfilternet_tpu.data import dataset as j_ds  # noqa: E402
from deepfilternet_tpu.ops import bandwidth as j_bw  # noqa: E402
from deepfilternet_tpu.scripts.prepare_data import prepare  # noqa: E402

SR = 48000
KNOBS = {"DF_P_CLIPPING": "0.3", "DF_P_ZEROING": "0.3", "DF_P_AIR_AUG": "0.3",
         "DF_P_BIQUAD": "0.3", "DF_P_VTLP": "0.2", "DF_P_NOISE_GEN": "0.3",
         "DF_P_RESAMPLE": "0.3"}


def speech_like(rng, seconds, channels=1):
    t = np.arange(int(SR * seconds)) / SR
    f0 = rng.uniform(100, 300, (channels, 1))
    x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5)) * 0.2
    return x * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) + 0.003 * rng.standard_normal(x.shape)


def write_corpus(d, seed=0, n_speech=5, n_noise=3):
    """speech.hdf5 (max_freq 16 kHz), noise.hdf5 (one clip stereo) and
    rir.hdf5 under `d`, written by JAX's prepare_data (h5py)."""
    rng = np.random.default_rng(seed)
    wav = d / "wav"
    wav.mkdir(exist_ok=True)
    files = {"speech": [], "noise": [], "rir": []}
    for i in range(n_speech):
        files["speech"].append(str(wav / f"sp{i}.wav"))
        save_audio(files["speech"][-1], speech_like(rng, rng.uniform(0.4, 1.0)), SR)
    for i in range(n_noise):
        files["noise"].append(str(wav / f"ns{i}.wav"))
        ch = 2 if i == 0 else 1
        save_audio(files["noise"][-1], 0.1 * rng.standard_normal((ch, int(SR * 0.7))), SR)
    for i in range(2):
        files["rir"].append(str(wav / f"rir{i}.wav"))
        n = 9600
        save_audio(files["rir"][-1], 0.5 * rng.standard_normal(n) * np.exp(-np.arange(n) / 1200),
                   SR)
    prepare("speech", str(d / "speech.hdf5"), files["speech"], max_freq=16000)
    prepare("noise", str(d / "noise.hdf5"), files["noise"])
    prepare("rir", str(d / "rir.hdf5"), files["rir"])
    return files


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    write_corpus(d)
    return d


# -- the native library -------------------------------------------------------


def test_native_available_and_biquad():
    from scipy.signal import lfilter

    assert t_native.available()
    # the port builds into a file of its own and renames it into place
    assert t_native._build()
    assert not [f for f in os.listdir(t_native._NATIVE_DIR) if f.startswith(".libdfdata.")]
    x = np.random.default_rng(0).standard_normal(3000).astype(np.float32)
    b, a = t_aug.low_pass(2000, 0.7, SR)
    coefs = np.array([[*b, *a], [*t_aug.high_pass(100, 0.7, SR)[0],
                                 *t_aug.high_pass(100, 0.7, SR)[1]]])
    got = t_native.biquad_chain(x, coefs)
    np.testing.assert_array_equal(got, j_native.biquad_chain(x, coefs))
    want = x.astype(np.float64)
    for c in coefs:
        want = lfilter(c[:3] / c[3], np.array([1.0, c[4] / c[3], c[5] / c[3]]), want)
    np.testing.assert_allclose(got, want, atol=1e-5)


# -- augmentations --------------------------------------------------------------


def _rir(rng):
    n = 4800
    return (rng.standard_normal((1, n)) * np.exp(-np.arange(n) / 600)).astype(np.float32)


AUGMENTATIONS = {
    "remove_dc": lambda a: a.RandRemoveDc(1.0),
    "lfilt": lambda a: a.RandLFilt(1.0),
    "biquad": lambda a: a.RandBiquadFilter(1.0, sr=SR),
    "resample": lambda a: a.RandResample(1.0, sr=SR),
    "vtlp": lambda a: a.RandVTLP(1.0, sr=SR),
    "clipping": lambda a: a.RandClipping(1.0, c_range=(0.05, 0.9)),
    "clipping_eq_snr": lambda a: a.RandClipping(1.0, eq_snr=(3.0, 20.0)),
    "zeroing": lambda a: a.RandZeroingTD(1.0),
    "compose_gated": lambda a: a.Compose([a.RandRemoveDc(0.5), a.RandLFilt(0.5),
                                          a.RandResample(0.5, sr=SR), a.RandZeroingTD(0.5)]),
    "gen_noise": lambda a: (lambda x, rng: a.gen_noise(float(rng.uniform(-2, 2)), 2, 30000, SR,
                                                       rng)),
    "noise_generator": lambda a: (lambda x, rng: a.NoiseGenerator(SR, 0.7).maybe_generate(
        -2.0, 2.0, 1, 20000, rng)),
    "reverb": lambda a: (lambda x, rng: a.RandReverbSim(0.8, SR).transform(
        x, x[:, ::-1].copy() * 0.5, _rir(rng), rng)),
    "reverb_no_drr": lambda a: (lambda x, rng: a.RandReverbSim(1.0, SR, drr_f=None).transform(
        x, x * 0.3, _rir(rng), rng)),
    "bandwidth_limiter": lambda a: (lambda x, rng: a.BandwidthLimiterAugmentation(
        1.0, SR).transform(x, 20000, rng)),
    "low_pass_resample": lambda a: (lambda x, rng: a.low_pass_resample(x, 6000, SR)),
    "air_absorption": lambda a: (lambda x, rng: a.AirAbsorptionAugmentation(1.0).apply_spectrum(
        np.fft.rfft(x.reshape(1, -1, 2000), axis=-1), SR, rng)),
    "biquad_designs": lambda a: (lambda x, rng: [
        a.biquad_inplace(x.copy(), *fn()) for fn in (
            lambda: a.high_shelf(3000, 6, 0.7, SR), lambda: a.low_shelf(300, -6, 0.9, SR),
            lambda: a.peaking_eq(1000, 4, 1.2, SR), lambda: a.notch(500, 2.0, SR))]),
}


def _flat(out):
    if out is None:
        return [np.zeros(0)]
    if isinstance(out, (tuple, list)):
        return [v for o in out for v in _flat(o)]
    return [np.atleast_1d(np.asarray(out))]


@pytest.mark.parametrize("name", sorted(AUGMENTATIONS))
def test_augmentation_matches_jax(name):
    for seed in range(4):
        x = speech_like(np.random.default_rng(100 + seed), 0.25).astype(np.float32)
        outs, states = [], []
        for mod in (t_aug, j_aug):
            rng = np.random.default_rng(seed)
            outs.append(_flat(AUGMENTATIONS[name](mod)(x.copy(), rng)))
            states.append(rng.bit_generator.state)
        assert states[0] == states[1], (name, seed)
        assert len(outs[0]) == len(outs[1])
        for got, want in zip(*outs):
            assert got.shape == want.shape and got.dtype == want.dtype, (name, seed)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f"{name} {seed}")


def test_helpers_match_jax():
    sizes = [1, 2, 7, 97, 1000, 48001, 123457] + list(
        np.random.default_rng(2).integers(2, 20000, 40)) + [1 << 14, (1 << 14) + 1]
    for n in sizes:
        assert t_aug._good_fft_size(int(n)) == j_aug._good_fft_size(int(n)), n
    rng = np.random.default_rng(3)
    spec = np.fft.rfft(rng.standard_normal((2, 30, 960)), axis=-1)
    spec[..., 340:] *= 1e-9
    assert t_bw.estimate_bandwidth(spec, SR) == j_bw.estimate_bandwidth(spec, SR)
    for cbin in (120, 300, 470, 481):
        np.testing.assert_array_equal(t_bw.ext_bandwidth_spectral(spec, cbin, SR, 4),
                                      j_bw.ext_bandwidth_spectral(spec, cbin, SR, 4))
    np.testing.assert_array_equal(t_bw.rfftfreqs(481, SR), j_bw.rfftfreqs(481, SR))


# -- datasets --------------------------------------------------------------------

CFGS = [("speech.hdf5", 1.5), ("noise.hdf5", 1), ("rir.hdf5", 1)]


def _datasets(corpus, split="train", cfgs=CFGS, **kw):
    kw = dict(dict(max_len_s=0.5, p_reverb=0.5, p_interfer_sp=0.5, p_bandwidth_ext=0.5,
                   seed=7), **kw)
    t = t_ds.TdDataset(str(corpus), [t_ds.Hdf5Cfg(*c) for c in cfgs], split, **kw)
    j = j_ds.TdDataset(str(corpus), [j_ds.Hdf5Cfg(*c) for c in cfgs], split, **kw)
    return t, j


def _same_sample(a, b, where):
    assert a.keys() == b.keys(), where
    for k in a:
        assert type(a[k]) is type(b[k]), (where, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")


def test_td_dataset_bit_for_bit(corpus, monkeypatch):
    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    t, j = _datasets(corpus)
    assert t._has_fractional and len(t.ns_keys) == 3 and len(t.rir_keys) == 2
    freqs, lengths = [], set()
    for epoch in (0, 1, 2):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        assert t.sp_index == j.sp_index and len(t) == len(j)
        lengths.add(len(t))
        for idx in range(len(t)):
            seed = epoch * 1000 + idx
            a = t.get_sample(idx, seed)
            _same_sample(a, j.get_sample(idx, seed), (epoch, idx))
            freqs.append(a["max_freq"])
    assert len(freqs) >= 20
    # the bandwidth limiter cut some samples below the corpus' 16 kHz, and the
    # fractional factor changed the epoch's length
    assert min(freqs) < 16000 == max(freqs) and len(lengths) > 1


def test_fd_dataset_features(corpus):
    t, j = _datasets(corpus, p_bandwidth_ext=0.0)
    tf, jf = t_ds.FdDataset(t), j_ds.FdDataset(j)
    for idx, seed in ((0, 3), (1, 4), (2, 11)):
        a, b = tf.get_sample(idx, seed), jf.get_sample(idx, seed)
        assert a["max_freq"] == 16000  # extended above 8 kHz by ext_bandwidth_spectral
        for k in b:
            if isinstance(b[k], np.ndarray) and b[k].dtype.kind in "fc":
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
            else:
                assert a[k] == b[k], k


def _same_batch(a, b, where):
    for f in ("speech", "noisy", "spec_clean", "spec_noisy", "feat_erb", "feat_spec",
              "lengths", "max_freq", "snr", "gain", "ids"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (where, f)
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6, err_msg=f"{where} {f}")


@pytest.mark.parametrize("num_workers", [1, 3])
def test_dataloader_batches_match_jax(corpus, num_workers):
    t, j = _datasets(corpus)
    loaders = [mod.DataLoader(fd, batch_size=2, num_workers=num_workers, drop_last=True,
                              batch_size_eval=3)
               for mod, fd in ((t_dl, t_ds.FdDataset(t)), (j_dl, j_ds.FdDataset(j)))]
    assert loaders[0].len_of("train") == loaders[1].len_of("train")
    n = 0
    for split, seed in (("train", 0), ("train", 1), ("valid", 0)):
        got = list(loaders[0].iter_epoch(split, seed))
        want = list(loaders[1].iter_epoch(split, seed))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            _same_batch(a, b, (split, seed))
            n += 1
    assert n >= 5


def test_collate_multichannel():
    rng = np.random.default_rng(0)
    samples = []
    for i, (t, tf) in enumerate(((960, 2), (1440, 3))):
        s = {k: rng.standard_normal((2, t)).astype(np.float32) for k in ("speech", "noisy")}
        for k, f in (("spec_clean", 481), ("spec_noisy", 481), ("feat_spec", 96)):
            s[k] = (rng.standard_normal((2, tf, f)) + 1j * rng.standard_normal((2, tf, f))
                    ).astype(np.complex64)
        s["feat_erb"] = rng.standard_normal((2, tf, 32)).astype(np.float32)
        s.update(max_freq=24000, snr=5, gain=-6, idx=i)
        samples.append(s)
    a, b = t_dl.collate(samples), j_dl.collate(samples)
    assert a.spec_noisy.shape == (2, 2, 3, 481) and a.speech.shape == (2, 2, 1440)
    _same_batch(a, b, "collate")


def test_dataset_config(tmp_path):
    path = tmp_path / "dataset.cfg"
    path.write_text(json.dumps({"train": [["a.hdf5", 2.5], ["b.hdf5", 1, 16000, 8000], "c.hdf5"],
                                "valid": [["a.hdf5"]], "test": []}))
    t, j = t_ds.DatasetConfig.open(str(path)), j_ds.DatasetConfig.open(str(path))
    for split in ("train", "valid", "test"):
        assert [vars(c) for c in t.split(split)] == [vars(c) for c in j.split(split)]
    assert vars(t.train[1]) == {"filename": "b.hdf5", "sampling_factor": 1.0,
                                "fallback_sr": 16000, "fallback_max_freq": 8000}
    rng = np.random.default_rng(1)
    x, n = rng.standard_normal((1, 4000)), rng.standard_normal((1, 4000))
    assert t_ds.mix_f(x, n, 5.0) == j_ds.mix_f(x, n, 5.0)
    for got, want in zip(t_ds.mix_audio_signal(x * 3, None, n, 0.0, 6.0),
                         j_ds.mix_audio_signal(x * 3, None, n, 0.0, 6.0)):
        np.testing.assert_array_equal(got, want)


# -- FLAC ----------------------------------------------------------------------------


def flac_bytes(pcm: np.ndarray, sr: int = SR, block: int = 4096) -> bytes:
    """A FLAC stream of int16 `pcm` [C, T]: STREAMINFO, then frames of
    `block` samples with verbatim subframes (CRCs left 0: the decoder reads
    them without checking)."""
    c, t = pcm.shape
    info = struct.pack(">HH", block, block) + b"\0" * 6
    info += ((sr << 44) | ((c - 1) << 41) | (15 << 36) | t).to_bytes(8, "big") + b"\0" * 16
    out = bytearray(b"fLaC" + bytes([0x80]) + len(info).to_bytes(3, "big") + info)
    for n, start in enumerate(range(0, t, block)):
        part = pcm[:, start:start + block]
        size = part.shape[1]
        assert n < 128  # one-byte UTF-8 frame number
        head = bytes([0xFF, 0xF8, (7 << 4) | 10, ((c - 1) << 4) | (4 << 1), n])
        out += head + struct.pack(">H", size - 1) + b"\0"
        for ch in part:
            out += b"\x02" + ch.astype(">i2").tobytes()
        out += b"\0\0"
    return bytes(out)


def test_flac_corpus(tmp_path):
    rng = np.random.default_rng(5)
    write_corpus(tmp_path, seed=1, n_noise=1)
    clips = [np.clip(rng.standard_normal((ch, n)) * 4000, -32768, 32767).astype(np.int16)
             for ch, n in ((1, 30000), (2, 12345), (1, 4096))]
    with h5py.File(tmp_path / "noise_flac.hdf5", "w") as f:
        f.attrs.update(sr=SR, max_freq=SR // 2, codec="flac", dtype="int16")
        g = f.create_group("noise")
        for i, clip in enumerate(clips):
            audio, rate = t_native.decode_flac(flac_bytes(clip))
            assert rate == SR
            np.testing.assert_array_equal(audio, clip.astype(np.float32) / 32768.0)
            ds = g.create_dataset(f"n{i}", data=np.frombuffer(flac_bytes(clip), np.uint8))
            ds.attrs["n_samples"] = np.array([clip.shape[1]]) if i else clip.shape[1]
    cfgs = [("speech.hdf5", 1), ("noise_flac.hdf5", 1)]
    t, j = _datasets(tmp_path, cfgs=cfgs, p_interfer_sp=0.0)
    assert t.handles["noise_flac.hdf5"].codec == "flac"
    for i in range(3):
        assert (t.handles["noise_flac.hdf5"].sample_len("noise", f"n{i}")
                == clips[i].shape[1])
        np.testing.assert_array_equal(t.handles["noise_flac.hdf5"].read("noise", f"n{i}"),
                                      clips[i].astype(np.float32) / 32768.0)
    for idx in range(len(t)):
        _same_sample(t.get_sample(idx, idx + 3), j.get_sample(idx, idx + 3), idx)


def host_profile(trials=5):
    """The host numbers PERF.md and ROADMAP.md quote, on the machine this
    runs on (CPU only; `PYTHONPATH=. python tests/test_torch_data.py`): a
    3 s FdDataset sample's host time on one thread (speech 16 x 5 s, noise
    8 x 10 s, RIRs 2 x 0.5 s, reverb 0.2, as chip_smoke.py phase 10 builds
    its corpus), the loader's samples a second at 1 and 4 workers, each
    package's `_good_fft_size` at that sample's reverb length, and how often
    two JAX processes and a port process that build and load the native
    library at the same time fail."""
    import subprocess
    import sys
    import tempfile
    import time

    from deepfilternet_torch.scripts.prepare_data import prepare as t_prepare

    d = tempfile.mkdtemp()
    rng = np.random.default_rng(0)
    for name, n, seconds in (("speech", 16, 5.0), ("noise", 8, 10.0), ("rir", 2, 0.5)):
        paths = []
        for i in range(n):
            paths.append(os.path.join(d, f"{name}{i}.wav"))
            x = (speech_like(rng, seconds) if name == "speech" else
                 0.1 * rng.standard_normal(int(SR * seconds)) * (
                     np.exp(-np.arange(int(SR * seconds)) / 4800.0) if name == "rir" else 1.0))
            save_audio(paths[-1], x, SR)
        t_prepare(name, os.path.join(d, f"{name}.hdf5"), paths)
    cfgs = [t_ds.Hdf5Cfg(f"{g}.hdf5") for g in ("speech", "noise", "rir")]
    td = t_ds.TdDataset(d, cfgs, "train", max_len_s=3.0, p_reverb=0.2, seed=42)
    fd = t_ds.FdDataset(td)
    fd.get_sample(0, 0)
    t0 = time.perf_counter()
    for i in range(8):
        fd.get_sample(i, i)
    print(f"FdDataset sample of 3 s on one thread: {(time.perf_counter() - t0) / 8 * 1e3:.1f} ms")
    for workers in (1, 4):
        loader = t_dl.DataLoader(fd, 8, num_workers=workers, drop_last=True)
        t0 = time.perf_counter()
        n = sum(b.noisy.shape[0] for b in loader.iter_epoch("train", 0))
        print(f"loader at {workers} worker(s): {n / (time.perf_counter() - t0):.1f} samples/s")
    n = 3 * SR + int(0.5 * SR) - 1
    for label, fn in (("JAX", j_aug._good_fft_size), ("port", t_aug._good_fft_size)):
        t0 = time.perf_counter()
        size = fn(n)
        print(f"{label} _good_fft_size({n}) = {size}: {time.perf_counter() - t0:.4f} s")
    code = ("from deepfilternet_{}.data import _native; import numpy as np; "
            "_native.biquad_chain(np.ones(4, np.float32), np.array([1., 0, 0, 1, 0, 0]))")
    failed = {"tpu": 0, "tpu ": 0, "torch": 0}
    for _ in range(trials):
        for f in ("libdfdata.so", "ladspa_df.so"):
            if os.path.exists(os.path.join(t_native._NATIVE_DIR, f)):
                os.remove(os.path.join(t_native._NATIVE_DIR, f))
        procs = {k: subprocess.Popen([sys.executable, "-c", code.format(k.strip())],
                                     stderr=subprocess.DEVNULL) for k in failed}
        for k, p in procs.items():
            failed[k] += p.wait(timeout=300) != 0
    print(f"native library built and loaded by two JAX processes and a port process at once, "
          f"{trials} times: the JAX processes failed {failed['tpu'] + failed['tpu ']} times, "
          f"the port's {failed['torch']}")
    t_native.available()


if __name__ == "__main__":
    host_profile(trials=10)
