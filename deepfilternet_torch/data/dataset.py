"""Time-domain sample synthesis + feature datasets, the port's copy of
`deepfilternet_tpu.data.dataset` (host-side numpy; its corpora are read by
`data/h5file.py`, not h5py).

Reference: libDF/src/dataset.rs. `DatasetConfig` parses the JSON dataset
config ({"train"/"valid"/"test": [[hdf5, sampling_factor], ...]}).
`TdDataset.get_sample(idx, seed)` deterministically synthesizes one
(clean, noisy) pair per (epoch, idx): SNR/gain sampling, speech clip
concatenation to max length, 2-5 augmented noises, reverb with
dereverberated target, TD/FD distortions, bandwidth limiting, interfering
speakers, SNR mixing with clipping guard (dataset.rs:1211-1379,
2047-2074). `FdDataset` adds STFT + ERB/complex features computed with the
framework's own DSP (NumPy path of the same numerics).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepfilternet_torch.data import augmentations as aug
from deepfilternet_torch.data.hdf5 import Hdf5Dataset, store_key_cache
from deepfilternet_torch.ops.erb import erb_fb_matrices, erb_widths
from deepfilternet_torch.ops.norms import get_norm_alpha, mean_norm_init, unit_norm_init
from deepfilternet_torch.ops.stft import vorbis_window, wnorm


def _get_env(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v is not None else default


# ---------------------------------------------------------------------------
# dataset config json (dataset.rs:151-277)
# ---------------------------------------------------------------------------


@dataclass
class Hdf5Cfg:
    filename: str
    sampling_factor: float = 1.0
    fallback_sr: Optional[int] = None
    fallback_max_freq: Optional[int] = None


@dataclass
class DatasetConfig:
    train: List[Hdf5Cfg] = field(default_factory=list)
    valid: List[Hdf5Cfg] = field(default_factory=list)
    test: List[Hdf5Cfg] = field(default_factory=list)

    @classmethod
    def open(cls, path: str) -> "DatasetConfig":
        with open(path) as f:
            raw = json.load(f)
        out = cls()
        for split in ("train", "valid", "test"):
            for entry in raw.get(split, []):
                if isinstance(entry, (list, tuple)):
                    cfg = Hdf5Cfg(entry[0], float(entry[1]) if len(entry) > 1 else 1.0,
                                  int(entry[2]) if len(entry) > 2 else None,
                                  int(entry[3]) if len(entry) > 3 else None)
                else:
                    cfg = Hdf5Cfg(str(entry))
                getattr(out, split).append(cfg)
        return out

    def split(self, name: str) -> List[Hdf5Cfg]:
        return getattr(self, name)


# ---------------------------------------------------------------------------
# TdDataset
# ---------------------------------------------------------------------------


class TdDataset:
    def __init__(
        self,
        ds_dir: str,
        cfgs: List[Hdf5Cfg],
        split: str,
        sr: int = 48000,
        max_len_s: float = 10.0,
        snrs: Sequence[int] = (-5, 0, 5, 10, 20, 40),
        gains: Sequence[int] = (-6, 0, 6),
        p_reverb: float = 0.0,
        p_interfer_sp: float = 0.0,
        p_bandwidth_ext: float = 0.0,
        seed: int = 0,
        global_sampling_factor: float = 1.0,
    ):
        self.sr = sr
        self.split = split
        self.seed = seed
        self.max_samples = int(round(max_len_s * sr))
        self.snrs = list(snrs)
        self.gains = list(gains)
        self.p_interfer_sp = p_interfer_sp
        self.handles: Dict[str, Hdf5Dataset] = {}
        self.sp_keys: List[Tuple[str, str, float]] = []  # (file, key, factor)
        self.ns_keys: List[Tuple[str, str]] = []
        self.rir_keys: List[Tuple[str, str]] = []
        for cfg in cfgs:
            path = os.path.join(ds_dir, cfg.filename)
            if not os.path.isfile(path):
                continue
            ds = Hdf5Dataset(path, cfg.fallback_sr, cfg.fallback_max_freq)
            self.handles[cfg.filename] = ds
            store_key_cache(path, {g: sorted(ds.file[g].keys()) for g in ds.groups})
            for g in ds.groups:
                for k in ds.keys(g):
                    if g == "speech":
                        self.sp_keys.append((cfg.filename, k, cfg.sampling_factor))
                    elif g == "noise":
                        self.ns_keys.append((cfg.filename, k))
                    elif g == "rir":
                        self.rir_keys.append((cfg.filename, k))
        # fractional/integer sampling factors (dataset.rs:1397-1451): keys
        # repeat by the integer part; fractional inclusion is regenerated
        # per epoch via set_epoch (reference: shuffle + cycle + take(n))
        self.global_sampling_factor = global_sampling_factor
        self._has_fractional = any(f != int(f) for _, _, f in self.sp_keys)
        self.set_epoch(0)

        train = split == "train"
        self.sp_augmentations = aug.Compose([
            aug.RandRemoveDc(_get_env("DF_P_REMVOE_DC", 0.25)),
            aug.RandLFilt(_get_env("DF_P_LFILT", 0.25)),
            aug.RandBiquadFilter(_get_env("DF_P_BIQUAD", 0.0), sr=sr),
            aug.RandResample(_get_env("DF_P_RESAMPLE", 0.1), sr=sr),
            # VTLP "new speaker" synthesis — default off (reference
            # parity); data-ceiling experiment knob (pretrained/README.md)
            aug.RandVTLP(_get_env("DF_P_VTLP", 0.0), sr=sr),
        ])
        self.sp_distortions_td = aug.Compose([])
        self.air_absorption: Optional[aug.AirAbsorptionAugmentation] = None
        if train:
            p_clip = _get_env("DF_P_CLIPPING", 0.0)
            if p_clip > 0:
                self.sp_distortions_td.push(aug.RandClipping(p_clip, c_range=(0.05, 0.9)))
            p_zero = _get_env("DF_P_ZEROING", 0.0)
            if p_zero > 0:
                self.sp_distortions_td.push(aug.RandZeroingTD(p_zero))
            p_air = _get_env("DF_P_AIR_AUG", 0.0)
            if p_air > 0:
                self.air_absorption = aug.AirAbsorptionAugmentation(p_air)
        self.ns_augmentations = aug.Compose([
            aug.RandLFilt(_get_env("DF_P_LFILT", 0.25)),
            aug.RandBiquadFilter(_get_env("DF_P_BIQUAD", 0.0), sr=sr),
            aug.RandResample(_get_env("DF_P_RESAMPLE", 0.1), sr=sr),
        ])
        if train:
            self.ns_augmentations.push(
                aug.RandClipping(_get_env("DF_P_CLIPPING_NOISE", 0.1), c_range=(0.01, 0.5))
            )
        self.reverb = aug.RandReverbSim(
            p_reverb, sr,
            rt60=_get_env("DF_REVERB_RT60", 0.5),
            offset_late=int(_get_env("DF_REVERB_OFFSET_LATE", 20)),
            drr_f=_get_env("DF_REVERB_DRR", 0.3),
        )
        self.noise_generator = aug.NoiseGenerator(
            sr, _get_env("DF_P_NOISE_GEN", 0.05) if train else 0.0
        )
        self.p_bandwidth_ext = p_bandwidth_ext
        self.bw_limiter = (
            aug.BandwidthLimiterAugmentation(p_bandwidth_ext, sr)
            if p_bandwidth_ext > 0 else None
        )

    def set_epoch(self, epoch_seed: int):
        """Regenerate fractional sampling inclusion for an epoch
        (dataset.rs:1397-1451)."""
        rng = np.random.default_rng(np.uint64(self.seed * 7919 + epoch_seed))
        expanded: List[Tuple[str, str]] = []
        for fname, key, factor in self.sp_keys:
            n = int(factor)
            frac = factor - n
            expanded.extend([(fname, key)] * n)
            if frac > 0 and rng.uniform(0, 1) < frac:
                expanded.append((fname, key))
        self.sp_index = expanded
        if self.global_sampling_factor != 1.0:
            keep = max(int(len(self.sp_index) * self.global_sampling_factor), 1)
            self.sp_index = self.sp_index[:keep]

    def __len__(self) -> int:
        return len(self.sp_index)

    # -- loading helpers -----------------------------------------------------

    def _read(self, fname: str, key: str, group: str, max_len=None, rng=None) -> np.ndarray:
        ds = self.handles[fname]
        audio = ds.read(group, key, max_len=max_len, rng=rng)
        if ds.sr != self.sr:
            from deepfilternet_torch.utils.audio_io import resample

            audio = resample(audio, ds.sr, self.sr)
        return audio

    def _max_freq(self, fname: str) -> int:
        return min(self.handles[fname].max_freq, self.sr // 2)

    def _load_aug_speech(self, idx: int, rng) -> Tuple[np.ndarray, int]:
        """dataset.rs:1100-1175: concat augmented clips to max length, crop."""
        fname, key = self.sp_index[idx]
        max_freq = self.sr // 2
        cur_len = 0
        chunks = []
        attempts = 0
        while True:
            attempts += 1
            n_read = int(self.max_samples * 1.1) - cur_len
            try:
                sample = self._read(fname, key, "speech", max_len=n_read, rng=rng)
            except (ValueError, RuntimeError, KeyError):
                # corrupt sample fallback (dataset.rs:1037-1060)
                fname, key = self.sp_index[int(rng.integers(0, len(self.sp_index)))]
                if attempts > 20:
                    raise
                continue
            if sample.shape[0] > 1:
                sample = sample[:1]
            max_freq = min(max_freq, self._max_freq(fname))
            if aug.rms(sample) < 1e-10:
                fname, key = self.sp_index[int(rng.integers(0, len(self.sp_index)))]
                if attempts > 20:
                    break
                continue
            sample = self.sp_augmentations(sample, rng)
            if aug.rms(sample) < 1e-10:
                fname, key = self.sp_index[int(rng.integers(0, len(self.sp_index)))]
                if attempts > 20:
                    break
                continue
            cur_len += sample.shape[-1]
            chunks.append(sample)
            if cur_len < self.max_samples:
                fname, key = self.sp_index[int(rng.integers(0, len(self.sp_index)))]
            else:
                break
        speech = np.concatenate(chunks, axis=-1) if chunks else np.zeros((1, self.max_samples), np.float32)
        if speech.shape[-1] > self.max_samples:
            start = int(rng.integers(0, speech.shape[-1] - self.max_samples))
            speech = speech[..., start : start + self.max_samples]
        return speech, max_freq

    def _load_aug_noise(self, rng) -> Tuple[np.ndarray, float]:
        """dataset.rs:1177-1207."""
        gen = self.noise_generator.maybe_generate(-2.0, 2.0, 1, self.max_samples, rng)
        if gen is not None:
            return gen, float([-24.0, -12.0, -6.0, 0.0][rng.integers(0, 4)])
        for _ in range(50):
            fname, key = self.ns_keys[int(rng.integers(0, len(self.ns_keys)))]
            try:
                ns = self._read(fname, key, "noise", rng=rng)
            except (ValueError, RuntimeError, KeyError):
                continue
            if ns.shape[-1] < 100 or np.abs(ns).max() < 1e-10:
                continue
            ns = self.ns_augmentations(ns, rng)
            if ns.shape[-1] > self.max_samples:
                ns = ns[..., : self.max_samples]
            return ns, float(self.gains[rng.integers(0, len(self.gains))])
        raise RuntimeError("Could not load a usable noise sample")

    # -- the sample pipeline -------------------------------------------------

    def get_sample(self, idx: int, seed: Optional[int] = None) -> Dict:
        sample_seed = seed if seed is not None else idx
        rng = np.random.default_rng(np.uint64(self.seed + sample_seed))

        snr = self.snrs[rng.integers(0, len(self.snrs))]
        gain = self.gains[rng.integers(0, len(self.gains))]

        speech, max_freq = self._load_aug_speech(idx, rng)
        ch, length = speech.shape

        noise_low_pass = max_freq if max_freq < self.sr // 2 else None
        n_noises = int(rng.integers(2, 6))
        noises, noise_gains = [], []
        for _ in range(n_noises):
            ns, g = self._load_aug_noise(rng)
            noises.append(ns)
            noise_gains.append(g)
        noise = combine_noises(ch, length, noises, noise_gains, rng)

        # reverberation (target = less-reverberant speech)
        speech_distorted = speech.copy()
        if self.rir_keys:
            fname, key = self.rir_keys[int(rng.integers(0, len(self.rir_keys)))]
            rir = self._read(fname, key, "rir")
            speech, noise, speech_rev = self.reverb.transform(speech, noise, rir, rng)
            if speech_rev is not None:
                speech_distorted = speech_rev
            else:
                speech_distorted = speech.copy()

        speech_distorted = self.sp_distortions_td(speech_distorted, rng)

        downsample_freq = None
        if self.bw_limiter is not None:
            speech_distorted, f = self.bw_limiter.transform(speech_distorted, max_freq, rng)
            if f < max_freq:
                downsample_freq = f
                noise_low_pass = f
        if noise_low_pass is not None:
            noise = aug.low_pass_resample(noise, noise_low_pass, self.sr)[..., :length]

        if self.air_absorption is not None:
            spec = np.fft.rfft(
                _frame(speech_distorted, 2048, 1024) * np.hanning(2048), axis=-1
            )
            spec = self.air_absorption.apply_spectrum(spec, self.sr, rng)
            speech_distorted = _overlap_add(
                np.fft.irfft(spec, n=2048, axis=-1), 1024, length
            ).astype(np.float32)

        if self.p_interfer_sp > 0 and self.p_interfer_sp > rng.uniform(0, 1):
            interferers, igains = [], []
            for _ in range(int(rng.integers(1, 3))):
                fname, key = self.sp_index[int(rng.integers(0, len(self.sp_index)))]
                s = self._read(fname, key, "speech",
                               max_len=int(self.max_samples * 1.1), rng=rng)
                if s.shape[-1] > length:
                    s = s[..., :length]
                interferers.append(s)
                igains.append(float(self.gains[rng.integers(0, len(self.gains))]))
            inter = combine_noises(ch, length, interferers, igains, rng)
            snr_i = [30.0, 20.0, 15.0][rng.integers(0, 3)]
            speech, _, speech_distorted = mix_audio_signal(
                speech, speech_distorted, inter, snr_i, 0.0
            )

        speech, noise, noisy = mix_audio_signal(
            speech, speech_distorted, noise, float(snr), float(gain)
        )
        return dict(
            speech=speech.astype(np.float32),
            noisy=noisy.astype(np.float32),
            max_freq=int(downsample_freq or max_freq),
            snr=int(snr),
            gain=int(gain),
            idx=idx,
        )


def _frame(x: np.ndarray, n: int, hop: int) -> np.ndarray:
    t = max((x.shape[-1] - n) // hop + 1, 1)
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, max(n + (t - 1) * hop - x.shape[-1], 0))])
    idx = np.arange(t)[:, None] * hop + np.arange(n)[None, :]
    return xp[..., idx]


def _overlap_add(frames: np.ndarray, hop: int, out_len: int) -> np.ndarray:
    c, t, n = frames.shape
    out = np.zeros((c, t * hop + n), np.float32)
    win = np.hanning(n)
    for i in range(t):
        out[:, i * hop : i * hop + n] += frames[:, i] * win
    # hann OLA at 50% has constant gain 1 * window_power compensation
    comp = np.sum(win**2) / hop
    return out[:, :out_len] / max(comp, 1e-10)


def combine_noises(ch: int, length: int, noises: List[np.ndarray],
                   gains: Optional[List[float]], rng) -> np.ndarray:
    """dataset.rs:1979-2023: tile/crop each noise to length, match channels,
    apply per-noise gains, average."""
    out = np.zeros((ch, length), np.float32)
    for i, ns in enumerate(noises):
        while ns.shape[-1] < length:
            ns = np.concatenate([ns, ns], axis=-1)
        if ns.shape[-1] > length:
            start = int(rng.integers(0, ns.shape[-1] - length + 1))
            ns = ns[..., start : start + length]
        while ns.shape[0] > ch:
            drop = int(rng.integers(0, ns.shape[0]))
            ns = np.delete(ns, drop, axis=0)
        while ns.shape[0] < ch:
            r = int(rng.integers(0, ns.shape[0]))
            ns = np.concatenate([ns, ns[r : r + 1]], axis=0)
        g = 10.0 ** (gains[i] / 20.0) if gains is not None else 1.0
        out += ns * g
    return out / ch


def mix_f(clean: np.ndarray, noise: np.ndarray, snr_db: float) -> float:
    """SNR mixing factor (transforms.rs:58-64)."""
    e_clean = float(np.sum(clean**2)) + 1e-10
    e_noise = float(np.sum(noise**2)) + 1e-10
    snr = 10.0 ** (snr_db / 10.0)
    return float(1.0 / math.sqrt((e_noise / e_clean) * snr + 1e-10))


def mix_audio_signal(clean: np.ndarray, clean_distorted: Optional[np.ndarray],
                     noise: np.ndarray, snr_db: float, gain_db: float
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """dataset.rs:2047-2074: gain, SNR-scaled noise, clipping guard."""
    g = 10.0 ** (gain_db / 20.0)
    clean_out = clean * g
    clean_mix = (clean_distorted * g) if clean_distorted is not None else clean_out.copy()
    noise = noise * mix_f(clean_out, noise, snr_db)
    mixture = clean_mix + noise
    max_val = max(np.abs(clean_out).max(), np.abs(noise).max(), np.abs(mixture).max())
    if max_val - 1.0 > 1e-10:
        f = 1.0 / (max_val + 1e-10)
        clean_out, noise, mixture = clean_out * f, noise * f, mixture * f
    return clean_out, noise, mixture


# ---------------------------------------------------------------------------
# FdDataset: adds STFT features (dataset.rs:849-944), NumPy mirror of the
# framework DSP numerics so workers run without touching the device.
# ---------------------------------------------------------------------------


class FdDataset:
    def __init__(self, td: TdDataset, fft_size: int = 960, hop_size: int = 480,
                 nb_erb: int = 32, nb_df: int = 96, norm_alpha: Optional[float] = None,
                 min_nb_erb_freqs: int = 2):
        self.td = td
        self.fft_size = fft_size
        self.hop_size = hop_size
        self.nb_erb = nb_erb
        self.nb_df = nb_df
        self.window = vorbis_window(fft_size)
        self.wnorm = wnorm(fft_size, hop_size)
        self.widths = erb_widths(td.sr, fft_size, nb_erb, min_nb_erb_freqs)
        self.erb_fb = erb_fb_matrices(self.widths, normalized=True, inverse=False)
        self.alpha = norm_alpha if norm_alpha is not None else get_norm_alpha(
            td.sr, hop_size, 1.0
        )

    def __len__(self):
        return len(self.td)

    def _stft(self, x: np.ndarray) -> np.ndarray:
        t = x.shape[-1] // self.hop_size
        pad = self.fft_size - self.hop_size
        xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, 0)])
        idx = np.arange(t)[:, None] * self.hop_size + np.arange(self.fft_size)[None, :]
        frames = xp[..., idx] * self.window
        return (np.fft.rfft(frames, axis=-1) * self.wnorm).astype(np.complex64)

    def get_sample(self, idx: int, seed: Optional[int] = None) -> Dict:
        from scipy.signal import lfilter

        s = self.td.get_sample(idx, seed)
        spec_clean = self._stft(s["speech"])
        spec_noisy = self._stft(s["noisy"])
        if s["max_freq"] < self.td.sr // 2:
            # spectral bandwidth extension of the (bandlimited) noisy input
            # so the model always sees full-band features (dataset.rs:876-901)
            from deepfilternet_torch.ops.bandwidth import ext_bandwidth_spectral

            cbin = int(s["max_freq"] / (self.td.sr / self.fft_size))
            spec_noisy = ext_bandwidth_spectral(spec_noisy, cbin, self.td.sr,
                                                n_bins_overlap=4)
        # exponential norms as first-order IIR filters over time
        # (scipy.lfilter with zi = alpha * s_init reproduces the sequential
        # recurrence s_t = (1-a) x_t + a s_{t-1} exactly)
        power = np.abs(spec_noisy) ** 2
        erb_db = 10.0 * np.log10(power @ self.erb_fb + 1e-10)
        a = self.alpha

        def ema(x, s_init):
            # x: [C, T, F]; returns the state track s_t, same shape
            zi = (a * s_init)[:, None, :]  # lfilter state per (C, F)
            y, _ = lfilter([1.0 - a], [1.0, -a], x, axis=1,
                           zi=np.broadcast_to(zi, (x.shape[0], 1, x.shape[2])).copy())
            return y

        m_init = np.tile(mean_norm_init(self.nb_erb), (erb_db.shape[0], 1))
        s_track = ema(erb_db, m_init)
        feat_erb = ((erb_db - s_track) / 40.0).astype(np.float32)
        lo = spec_noisy[..., : self.nb_df]
        u_init = np.tile(unit_norm_init(self.nb_df), (lo.shape[0], 1))
        u_track = ema(np.abs(lo), u_init)
        feat_spec = lo / np.sqrt(u_track)
        s.update(
            spec_clean=spec_clean,
            spec_noisy=spec_noisy,
            feat_erb=feat_erb,
            feat_spec=feat_spec.astype(np.complex64),
        )
        return s
