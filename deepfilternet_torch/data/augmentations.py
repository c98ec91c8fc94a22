"""Data augmentations (reference: libDF/src/augmentations.rs), the port's
copy of `deepfilternet_tpu.data.augmentations`: a sample drawn from the same
seeded generator is bit for bit the JAX package's.

NumPy host-side implementations of the reference's Transform suite with the
same sampling ranges and probability gates. Each transform is a callable
``t(x, rng) -> x`` over float32 [C, T] audio; `Compose` chains them. The
seeded per-(epoch, idx) `np.random.Generator` is threaded through
explicitly (the analog of the reference's thread-local Xoshiro RNG).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deepfilternet_torch.data import _native
from deepfilternet_torch.utils.audio_io import resample


def rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(x)))) if x.size else 0.0


# ---------------------------------------------------------------------------
# biquad designs (augmentations.rs:179-270, RBJ cookbook)
# ---------------------------------------------------------------------------


def _rbj(center_freq, sr, q):
    w0 = 2.0 * math.pi * center_freq / sr
    return w0, math.sin(w0) / 2.0 / q


def high_shelf(freq, gain_db, q, sr):
    w0, alpha = _rbj(freq, sr, q)
    amp = 10.0 ** (gain_db / 40.0)
    cos = math.cos(w0)
    sq = 2.0 * math.sqrt(amp) * alpha
    b = [amp * ((amp + 1) + (amp - 1) * cos + sq),
         -2.0 * amp * ((amp - 1) + (amp + 1) * cos),
         amp * ((amp + 1) + (amp - 1) * cos - sq)]
    a = [(amp + 1) - (amp - 1) * cos + sq,
         2.0 * ((amp - 1) - (amp + 1) * cos),
         (amp + 1) - (amp - 1) * cos - sq]
    return b, a


def low_shelf(freq, gain_db, q, sr):
    w0, alpha = _rbj(freq, sr, q)
    amp = 10.0 ** (gain_db / 40.0)
    cos = math.cos(w0)
    sq = 2.0 * math.sqrt(amp) * alpha
    b = [amp * ((amp + 1) - (amp - 1) * cos + sq),
         2.0 * amp * ((amp - 1) - (amp + 1) * cos),
         amp * ((amp + 1) - (amp - 1) * cos - sq)]
    a = [(amp + 1) + (amp - 1) * cos + sq,
         -2.0 * ((amp - 1) + (amp + 1) * cos),
         (amp + 1) + (amp - 1) * cos - sq]
    return b, a


def high_pass(freq, q, sr):
    w0, alpha = _rbj(freq, sr, q)
    cos = math.cos(w0)
    b = [(1 + cos) / 2.0, -(1 + cos), (1 + cos) / 2.0]
    a = [1 + alpha, -2.0 * cos, 1 - alpha]
    return b, a


def low_pass(freq, q, sr):
    w0, alpha = _rbj(freq, sr, q)
    cos = math.cos(w0)
    b = [(1 - cos) / 2.0, 1 - cos, (1 - cos) / 2.0]
    a = [1 + alpha, -2.0 * cos, 1 - alpha]
    return b, a


def peaking_eq(freq, gain_db, q, sr):
    w0, alpha = _rbj(freq, sr, q)
    amp = 10.0 ** (gain_db / 40.0)
    cos = math.cos(w0)
    b = [1 + alpha * amp, -2.0 * cos, 1 - alpha * amp]
    a = [1 + alpha / amp, -2.0 * cos, 1 - alpha / amp]
    return b, a


def notch(freq, q, sr):
    w0, alpha = _rbj(freq, sr, q)
    cos = math.cos(w0)
    b = [1.0, -2.0 * cos, 1.0]
    a = [1 + alpha, -2.0 * cos, 1 - alpha]
    return b, a


def biquad_inplace(x: np.ndarray, b: Sequence[float], a: Sequence[float]) -> np.ndarray:
    """f64-accumulated biquad per channel (transforms.rs:21-56) via the
    native kernel."""
    coefs = np.array([b[0], b[1], b[2], a[0], a[1], a[2]], np.float64)
    for c in range(x.shape[0]):
        x[c] = _native.biquad_chain(x[c], coefs)
    return x


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


class Transform:
    name = "Transform"

    def __init__(self, prob: float = 1.0):
        self.prob = prob

    def _gate(self, rng: np.random.Generator) -> bool:
        return self.prob > 0 and (self.prob >= 1.0 or rng.uniform(0, 1) <= self.prob)

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if not self._gate(rng):
            return x
        return self.apply(x, rng)

    def apply(self, x, rng):  # pragma: no cover - abstract
        raise NotImplementedError


class Compose:
    def __init__(self, transforms: List[Transform]):
        self.transforms = list(transforms)

    def push(self, t: Transform):
        self.transforms.append(t)

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        for t in self.transforms:
            x = t(x, rng)
        return x


class RandRemoveDc(Transform):
    """Subtract the mean (augmentations.rs:636-664)."""

    name = "RandRemoveDc"

    def apply(self, x, rng):
        return x - np.mean(x, axis=-1, keepdims=True)


class RandLFilt(Transform):
    """Random first-order b/a filter pairs, uniform [-3/8, 3/8]
    (augmentations.rs:137-178, RNNoise-style)."""

    name = "RandLFilt"

    def __init__(self, prob=1.0, a=-3.0 / 8.0, b=3.0 / 8.0):
        super().__init__(prob)
        self.lo, self.hi = a, b

    def apply(self, x, rng):
        a = [1.0, rng.uniform(self.lo, self.hi), rng.uniform(self.lo, self.hi)]
        b = [1.0, rng.uniform(self.lo, self.hi), rng.uniform(self.lo, self.hi)]
        return biquad_inplace(x.copy(), b, a)


class RandBiquadFilter(Transform):
    """Random biquads with the reference's frequency/gain/Q ranges
    (augmentations.rs:179-398)."""

    name = "RandBiquadFilter"
    FILTERS = ("high_shelf", "low_shelf", "high_pass", "low_pass", "peaking_eq", "notch")

    def __init__(self, prob=1.0, sr=48000, n_freqs=3, gain_db_low=-15, gain_db_high=15):
        super().__init__(prob)
        self.sr = sr
        self.n_freqs = n_freqs
        self.gain_lo = gain_db_low
        self.gain_hi = gain_db_high

    def apply(self, x, rng):
        x = x.copy()
        for _ in range(rng.integers(1, self.n_freqs + 1)):
            kind = self.FILTERS[rng.integers(0, len(self.FILTERS))]
            f_lo, f_hi = {
                "low_pass": (4000, 8000),
                "high_shelf": (1000, 8000),
                "high_pass": (40, 400),
                "low_shelf": (40, 1000),
            }.get(kind, (40, 4000))
            freq = math.exp(rng.uniform(math.log(f_lo), math.log(f_hi)))
            q = rng.uniform(0.5, 1.5)
            gain = rng.uniform(self.gain_lo, self.gain_hi)
            fn = {
                "high_shelf": lambda: high_shelf(freq, gain, q, self.sr),
                "low_shelf": lambda: low_shelf(freq, gain, q, self.sr),
                "high_pass": lambda: high_pass(freq, q, self.sr),
                "low_pass": lambda: low_pass(freq, q, self.sr),
                "peaking_eq": lambda: peaking_eq(freq, gain, q, self.sr),
                "notch": lambda: notch(freq, q, self.sr),
            }[kind]
            b, a = fn()
            biquad_inplace(x, b, a)
        return x


class RandResample(Transform):
    """Speed/pitch perturbation 0.9-1.1x, rounded to 500 Hz
    (augmentations.rs:400-473). Output is length-adjusted to the input."""

    name = "RandResample"

    def __init__(self, prob=1.0, sr=48000, r_low=0.9, r_high=1.1):
        super().__init__(prob)
        self.sr = sr
        self.r_low = r_low
        self.r_high = r_high

    def apply(self, x, rng):
        new_sr = rng.uniform(self.r_low, self.r_high) * self.sr
        new_sr = int(round(new_sr / 500.0) * 500)
        if new_sr == self.sr:
            return x
        return resample(x, self.sr, new_sr)


class RandVTLP(Transform):
    """Vocal-tract-length perturbation: piecewise-linear warp of the STFT
    frequency axis (Jaitly & Hinton 2013 formulation). Shifts formants by
    a factor alpha while keeping duration and pitch contour — synthesizes
    "new speakers" from a tiny corpus, complementing RandResample (which
    scales formants AND pitch AND duration together). No reference analog;
    added for the fixture-demo data-ceiling experiment."""

    name = "RandVTLP"

    def __init__(self, prob=1.0, sr=48000, alpha_range=(0.88, 1.12),
                 f_hi=0.85):
        super().__init__(prob)
        self.sr = sr
        self.alpha_range = alpha_range
        self.f_hi = f_hi  # fraction of Nyquist where the warp bends

    def apply(self, x, rng):
        from scipy.signal import istft, stft

        alpha = float(rng.uniform(*self.alpha_range))
        if abs(alpha - 1.0) < 1e-3:
            return x
        n = x.shape[-1]
        nfft = 1024
        _, _, z = stft(x, nperseg=nfft, axis=-1)  # [C, F, T']
        nf = z.shape[-2]
        f_in = np.arange(nf, dtype=np.float64)
        # monotonic warp of the input bins: linear scale by alpha up to the
        # bend, then linear to Nyquist (keeps the full band covered)
        f0 = self.f_hi * (nf - 1) * min(alpha, 1.0) / alpha
        fmax = float(nf - 1)
        lo = f_in * alpha
        hi = fmax - (fmax - f0 * alpha) * (fmax - f_in) / max(fmax - f0, 1e-9)
        warp = np.where(f_in <= f0, lo, hi)
        # warp the MAGNITUDE envelope onto the uniform output grid and keep
        # the original phase (the standard waveform-VTLP compromise: phase
        # stays OLA-consistent, so the inverse STFT does not cancel);
        # (warp(f_in), |S|(f_in)) are samples of the warped magnitude
        zw = np.empty_like(z)
        flat = z.reshape(-1, nf, z.shape[-1])
        out = zw.reshape(-1, nf, z.shape[-1])
        for c in range(flat.shape[0]):
            for t in range(flat.shape[2]):
                col = flat[c, :, t]
                mag = np.interp(f_in, warp, np.abs(col))
                ph = np.exp(1j * np.angle(col))
                out[c, :, t] = mag * ph
        _, y = istft(zw, nperseg=nfft)
        y = np.asarray(y, x.dtype)
        if y.shape[-1] < n:
            y = np.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, n - y.shape[-1])])
        y = y[..., :n].reshape(x.shape)
        # level-preserve (warp losses are content-dependent)
        r_in, r_out = rms(x), rms(y)
        if r_out > 1e-10:
            y = y * (r_in / r_out)
        return y


class RandClipping(Transform):
    """Clamp to c * max(|x|), c sampled in a range (augmentations.rs:476-575).

    With `eq_snr` set, solves for c hitting a target SDR via bisection
    (the reference uses Brent root finding)."""

    name = "RandClipping"

    def __init__(self, prob=1.0, c_range=(0.05, 0.9), eq_snr: Optional[Tuple[float, float]] = None):
        super().__init__(prob)
        self.c_range = c_range
        self.eq_snr = eq_snr

    @staticmethod
    def _clip(x, c):
        m = np.abs(x).max() + 1e-10
        return np.clip(x, -c * m, c * m)

    def apply(self, x, rng):
        if self.eq_snr is not None:
            from scipy.optimize import brentq

            target = rng.uniform(*self.eq_snr)

            def sdr_err(c):
                y = self._clip(x, c)
                e = x - y
                sdr = 10 * np.log10((np.sum(x**2) + 1e-10) / (np.sum(e**2) + 1e-10))
                return sdr - target

            try:
                c = brentq(sdr_err, 0.01, 0.99, xtol=1e-3)
            except ValueError:
                c = rng.uniform(*self.c_range)
            return self._clip(x, c)
        c = rng.uniform(*self.c_range)
        return self._clip(x, c)


class RandZeroingTD(Transform):
    """Zero random 120-1800-sample runs up to 10% of the signal
    (augmentations.rs:577-634)."""

    name = "RandZeroingTD"

    def __init__(self, prob=1.0, run_range=(120, 1800), max_frac=0.1):
        super().__init__(prob)
        self.run_range = run_range
        self.max_frac = max_frac

    def apply(self, x, rng):
        x = x.copy()
        t = x.shape[-1]
        budget = int(t * self.max_frac)
        while budget > 0:
            run = int(rng.integers(self.run_range[0], self.run_range[1] + 1))
            run = min(run, budget)
            start = int(rng.integers(0, max(t - run, 1)))
            x[..., start : start + run] = 0.0
            budget -= run
            if rng.uniform(0, 1) < 0.5:
                break
        return x


def gen_noise(f_decay: float, num_channels: int, num_samples: int, sr: int,
              rng: np.random.Generator) -> np.ndarray:
    """Colored noise via f^-decay spectral shaping (augmentations.rs:666-737).

    decays: white 0, pink 1, brown 2, blue -1, purple -2.
    """
    noise = rng.standard_normal((num_channels, sr)).astype(np.float32)
    if f_decay != 0.0:
        spec = np.fft.rfft(noise, axis=-1)
        mask = np.linspace(1.0, math.sqrt(sr / 2 + 1), sr // 2 + 1) ** f_decay
        noise = np.fft.irfft(spec / mask, n=sr, axis=-1).astype(np.float32) * sr
    f = rng.uniform(0.01, 0.95) / max(np.abs(noise).max(), 1.0)
    noise *= f
    reps = int(math.ceil(num_samples / sr))
    return np.tile(noise, (1, reps))[:, :num_samples]


class NoiseGenerator:
    """maybe_generate_random_noise (augmentations.rs:774-808)."""

    def __init__(self, sr: int, p: float):
        self.sr = sr
        self.p = p

    def maybe_generate(self, f_lo: float, f_hi: float, ch: int, n: int,
                       rng: np.random.Generator) -> Optional[np.ndarray]:
        if self.p == 0.0 or self.p < rng.uniform(0, 1):
            return None
        f_decay = rng.uniform(f_lo, f_hi)
        return gen_noise(f_decay, ch, n, self.sr, rng)


def _good_fft_size(n: int) -> int:
    """Smallest 2^a*3^b*5^c*7^d*11^e >= n (augmentations.rs:862-880).

    The JAX package's depth-first search reaches the same product along many
    paths (near half a second of Python for a 3 s clip and a 0.5 s RIR, with
    the interpreter lock held, so the loader's threads wait on it); this visits
    each odd product up to the power of two at or above n once, with its
    smallest power-of-two multiple >= n, and gives the same number."""
    limit = 1 << (n - 1).bit_length()
    best = limit
    p11 = 1
    while p11 <= limit:
        p7 = p11
        while p7 <= limit:
            p5 = p7
            while p5 <= limit:
                p3 = p5
                while p3 <= limit:
                    v = p3
                    while v < n:
                        v *= 2
                    best = min(best, v)
                    p3 *= 3
                p5 *= 5
            p7 *= 7
        p11 *= 11
    return best


class RandReverbSim:
    """RIR reverberation with dereverberated target (augmentations.rs:810-1090).

    transform(speech, noise, rir, rng) -> (speech_target, noise, speech_rev)
    where speech_rev (if not None) replaces the speech in the noisy mix.
    """

    def __init__(self, p: float, sr: int, rt60: float = 0.5, offset_late: int = 20,
                 drr_f: Optional[float] = 0.3):
        self.prob_speech = p
        self.prob_noise = p
        self.prob_resample = p
        self.prob_decay = max(p, 0.5)
        self.sr = sr
        self.rt60 = rt60
        self.offset_late = offset_late
        self.drr_f = drr_f

    def _suppress_late(self, rir: np.ndarray, offset: int, rt60: float) -> np.ndarray:
        length = rir.shape[-1]
        if offset >= length:
            return rir
        rt60_level = 10.0 ** (-60 / 20)
        tau = -rt60 / math.log10(rt60_level)
        dt = 1.0 / self.sr
        decay = np.ones((1, length), np.float32)
        decay[0, offset:] = 10.0 ** (-np.arange(length - offset) * dt / tau)
        return rir * decay

    def _trim(self, rir: np.ndarray, ref_idx: int) -> np.ndarray:
        min_db = -80.0
        ref_level = np.abs(rir[:, ref_idx]).max() + 1e-10
        min_level = 10.0 ** ((min_db + math.log10(ref_level) * 20.0) / 20.0)
        keep = np.nonzero(np.abs(rir).max(axis=0) > min_level)[0]
        if keep.size == 0:
            return rir
        return rir[:, : keep[-1] + 1]

    def _convolve(self, x: np.ndarray, rir: np.ndarray, truncate: int) -> np.ndarray:
        n = _good_fft_size(x.shape[-1] + rir.shape[-1] - 1)
        xf = np.fft.rfft(x, n=n, axis=-1)
        rf = np.fft.rfft(rir, n=n, axis=-1)
        out = np.fft.irfft(xf * rf, n=n, axis=-1).astype(np.float32)
        return out[..., :truncate]

    def transform(self, speech: np.ndarray, noise: np.ndarray, rir: np.ndarray,
                  rng: np.random.Generator
                  ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        if self.prob_speech == 0.0 and self.prob_noise == 0.0:
            return speech, noise, None
        apply_speech = self.prob_speech > rng.uniform(0, 1)
        apply_noise = self.prob_noise > rng.uniform(0, 1)
        if not (apply_speech or apply_noise):
            return speech, noise, None
        orig_len = speech.shape[-1]
        if self.prob_resample > rng.uniform(0, 1):
            new_sr = int(round(rng.uniform(0.8, 1.2) * self.sr / 500.0) * 500)
            rir = resample(rir, self.sr, new_sr)
        rir_mono = rir.mean(axis=0)
        max_idx = int(np.argmax(np.abs(rir_mono)))
        if self.prob_decay > rng.uniform(0, 1):
            rt60 = rng.uniform(0.2, 1.0)
            rir = self._suppress_late(rir, max_idx, rt60)
        rir = self._trim(rir, min(max_idx, rir.shape[-1] - 1))
        rir_noise = rir / (np.sqrt(np.sum(rir**2)) + 1e-10)

        speech_rev = None
        if apply_speech:
            speech_rms = rms(speech)
            speech_rev = self._convolve(speech, rir_noise, orig_len)
            offset = max_idx + self.offset_late * self.sr // 1000
            rir_speech = self._suppress_late(rir_noise, offset, self.rt60)
            rir_speech = rir_speech / (np.sqrt(np.sum(rir_speech**2)) + 1e-10)
            speech_little_rev = self._convolve(speech, rir_speech, orig_len)
            if self.drr_f is not None:
                speech = speech * self.drr_f + (1.0 - self.drr_f) * speech_little_rev
            else:
                speech = speech_little_rev
            speech = speech * (speech_rms / (rms(speech) + 1e-10))
        if apply_noise:
            noise = self._convolve(noise, rir_noise, orig_len)
        return speech, noise, speech_rev


class BandwidthLimiterAugmentation(Transform):
    """Low-pass via down+up resampling to a random cutoff below max_freq
    (augmentations.rs:1092-1126). Returns (x, cutoff_freq)."""

    name = "BandwidthLimiter"
    CUTOFFS = (4000, 6000, 8000, 10000, 12000, 16000, 20000, 22050)

    def __init__(self, prob=1.0, sr=48000):
        super().__init__(prob)
        self.sr = sr

    def transform(self, x: np.ndarray, max_freq: int,
                  rng: np.random.Generator) -> Tuple[np.ndarray, int]:
        if not self._gate(rng):
            return x, max_freq
        valid = [f for f in self.CUTOFFS if f < max_freq]
        if not valid:
            return x, max_freq
        cutoff = int(valid[rng.integers(0, len(valid))])
        y = low_pass_resample(x, cutoff, self.sr)
        return y[..., : x.shape[-1]], cutoff


def low_pass_resample(x: np.ndarray, cutoff: int, sr: int) -> np.ndarray:
    """Down- then upsample (transforms.rs:421-436)."""
    down = resample(x, sr, cutoff * 2)
    return resample(down, cutoff * 2, sr)


class AirAbsorptionAugmentation(Transform):
    """Distance-dependent air absorption as an FD low-pass filterbank
    (augmentations.rs:1128-1290).

    A temperature/humidity condition is drawn uniformly from the published
    pyroomacoustics absorption-coefficient tables [1e-3/m]; per-band
    amplitude attenuation is exp(-distance * coef), linearly interpolated
    over the STFT bins with flat extension below the first and above the
    last center frequency (augmentations.rs:1211-1232)."""

    name = "AirAbsorption"
    CENTER_FREQS = (125.0, 250.0, 500.0, 1000.0, 2000.0, 4000.0, 8000.0,
                    16000.0, 24000.0)
    # key -> coefficients [1e-3/m] at CENTER_FREQS (augmentations.rs:1155-1199;
    # the two "Strong-High" rows are the reference's artificial strong-
    # absorption entries)
    COEF_TABLE = {
        "10C_30-50%": (0.1, 0.2, 0.5, 1.1, 2.7, 9.4, 29.0, 91.5, 289.0),
        "10C_50-70%": (0.1, 0.2, 0.5, 0.8, 1.8, 5.9, 21.1, 76.6, 280.2),
        "10C_70-90%": (0.1, 0.2, 0.5, 0.7, 1.4, 4.4, 15.8, 58.0, 214.9),
        "20C_30-50": (0.1, 0.3, 0.6, 1.0, 1.9, 5.8, 20.3, 72.3, 259.9),
        "20C_50-70%": (0.1, 0.3, 0.6, 1.0, 1.7, 4.1, 13.5, 44.4, 148.7),
        "20C_70-90%": (0.1, 0.3, 0.6, 1.1, 1.7, 3.5, 10.6, 31.2, 93.8),
        "Strong-High-1": (0.1, 0.2, 0.7, 1.5, 3.9, 8.1, 21.6, 80.2, 213.1),
        "Strong-High-2": (0.1, 0.3, 0.9, 3.8, 8.9, 21.1, 44.6, 80.2, 153.1),
    }

    def __init__(self, prob=1.0, distance_range=(1.0, 20.0)):
        super().__init__(prob)
        self.distance_range = distance_range

    def attenuation(self, coefs, distance: float, sr: int,
                    n_freqs: int) -> np.ndarray:
        """Per-bin amplitude attenuation for one condition/distance."""
        atten = np.exp(-distance * np.asarray(coefs) * 1e-3)
        freqs = np.linspace(0.0, sr / 2, n_freqs)
        # flat extension: value a[0] below the first center, a[-1] above
        # the last (interp_atten prepends (0, a0) / appends (sr/2, a_last))
        xs = np.concatenate([[0.0], self.CENTER_FREQS])
        ys = np.concatenate([[atten[0]], atten])
        if sr / 2 > self.CENTER_FREQS[-1]:
            xs = np.append(xs, sr / 2)
            ys = np.append(ys, atten[-1])
        return np.interp(freqs, xs, ys)

    def apply_spectrum(self, spec: np.ndarray, sr: int,
                       rng: np.random.Generator) -> np.ndarray:
        """spec: [C, T, F] complex (2048-FFT domain)."""
        if not self._gate(rng):
            return spec
        d = rng.uniform(*self.distance_range)
        key = sorted(self.COEF_TABLE)[rng.integers(0, len(self.COEF_TABLE))]
        gain = self.attenuation(self.COEF_TABLE[key], d, sr, spec.shape[-1])
        return spec * gain.astype(np.float32)
