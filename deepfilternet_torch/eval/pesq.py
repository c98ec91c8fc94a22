"""PESQ (ITU-T P.862) perceptual speech-quality metric, from spec, in NumPy.

The reference framework consumes PESQ through the ``pesq`` wheel
(reference df/evaluation_utils.py:583-597 and df/sepm.py:499 call
``pesq(fs, clean, deg, "wb")``); that wheel wraps the licensed ITU
reference C implementation and is not available in this environment
(zero egress). This module is a from-scratch reimplementation of the
P.862 algorithm structure with the P.862.2 wideband mode:

  level alignment -> input IIR filter -> VAD -> crude + per-utterance
  fine time alignment -> 32 ms Hann-framed power spectra -> Bark-band
  warping -> frequency-response compensation (ref towards deg) ->
  short-term gain compensation (deg towards ref) -> Zwicker loudness ->
  masked disturbance + asymmetric disturbance -> (L6 over split-seconds,
  L2 over time) aggregation -> raw MOS -> MOS-LQO mapping.

Fidelity notes (documented deviations):
  * The ITU band tables (centre/width of band, power-density correction,
    absolute threshold) are hand-tuned constants in the reference code.
    Here the Bark bands are derived from the published Zwicker scale
    ``z(f) = 13 atan(0.00076 f) + 3.5 atan((f/7500)^2)`` with the P.862
    band counts (49 bands for 16 kHz, 42 for 8 kHz), and the absolute
    threshold from Terhardt's threshold-in-quiet formula. Scores are on
    the PESQ scale, satisfy PESQ(x, x) = 4.5 raw, and are strongly
    rank-correlated with the ITU implementation, but are not bit-equal.
  * The bad-interval re-alignment loop and utterance split-on-delay-jump
    refinements of the ITU code are omitted; they only engage for
    pathological time-varying delays, which speech-enhancement eval
    (aligned clean/enhanced pairs) never produces.

Property tests in tests/test_pesq.py pin: identity -> max score,
monotonic decrease with additive-noise SNR, delay invariance, score
range, and composite() integration.

The port's copy of `deepfilternet_tpu.eval.pesq` (numpy and scipy only).
"""

from __future__ import annotations

import numpy as np

# --- P.862 constants -------------------------------------------------------

_ZWICKER_POWER = 0.23
_SL = 0.1866055  # loudness scaling (Sl in the reference code)
_MASK_FACTOR = 0.25
_ASYM_EXPONENT = 1.2
_ASYM_GATE = 3.0
_ASYM_CAP = 12.0
_D_POW_F = 2.0  # band aggregation exponent, symmetric disturbance
_A_POW_F = 1.0  # band aggregation exponent, asymmetric disturbance
_SPLIT_SECOND_LEN = 20  # frames per split-second interval (50% overlap)
_POW_SPLIT = 6.0
_POW_TIME = 2.0
_FRAME_CAP = 45.0

# P.862.2 wideband input filter (single biquad, applied to ref and deg).
_WB_IIR_B = np.array([2.6657628, -5.3315255, 2.6657628])
_WB_IIR_A = np.array([1.0, -1.8890331, 0.89487434])

_RATE_CFG = {
    16000: dict(frame=512, downsample=64, nb=49),
    8000: dict(frame=256, downsample=32, nb=42),
}


def _bark(f: np.ndarray) -> np.ndarray:
    """Zwicker critical-band rate (Bark) scale."""
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _terhardt_threshold_db(f: np.ndarray) -> np.ndarray:
    """Threshold in quiet (dB SPL), Terhardt 1979."""
    khz = np.maximum(np.asarray(f, np.float64), 20.0) / 1000.0
    return (
        3.64 * khz**-0.8
        - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
        + 1e-3 * khz**4
    )


class _BarkBands:
    """FFT-bin -> Bark-band warping for one sample rate."""

    def __init__(self, fs: int, frame: int, nb: int):
        n_bins = frame // 2 + 1
        freqs = np.arange(n_bins) * (fs / frame)
        z_max = float(_bark(np.array([fs / 2.0]))[0])
        edges_z = np.linspace(0.0, z_max, nb + 1)
        # bin 0 (DC) is excluded from the perceptual model
        z_bins = _bark(freqs)
        idx = np.clip(np.searchsorted(edges_z, z_bins, side="right") - 1, 0, nb - 1)
        idx[0] = -1  # DC
        self.nb = nb
        self.bin_band = idx
        self.width_bark = np.diff(edges_z)  # uniform, kept for clarity
        centres_z = 0.5 * (edges_z[:-1] + edges_z[1:])
        # invert z(f) numerically for band centre frequencies
        grid_f = np.linspace(1.0, fs / 2.0, 4096)
        self.centre_hz = np.interp(centres_z, _bark(grid_f), grid_f)
        # Absolute threshold per band from Terhardt's curve, calibrated to
        # the P.862 internal power units: raw |FFT|^2 band sums scaled by
        # Sp, where an active speech frame at the nominal level (1e7
        # mean-square after level alignment) totals ~1e7 across bands (the
        # units the literal P.862 constants 1000 / 5e3 / 50 / 1e5 assume).
        # In those units a ~72 dB SPL formant band is ~3e5, so 0 dB SPL
        # maps to ~0.02; the 1 kHz threshold (~2 dB SPL) lands at ~0.03.
        thr_db = _terhardt_threshold_db(self.centre_hz)
        thr_db_1k = _terhardt_threshold_db(np.array([1000.0]))[0]
        self.abs_thresh = 0.03 * 10.0 ** ((thr_db - thr_db_1k) / 10.0)
        # power-density scale (Sp in the reference code)
        self.sp = 6.910853e-6 if fs == 16000 else 2.764344e-5

    def warp(self, power_spec: np.ndarray) -> np.ndarray:
        """[T, n_bins] Hz power spectra -> [T, nb] Bark power densities."""
        t = power_spec.shape[0]
        out = np.zeros((t, self.nb))
        valid = self.bin_band >= 0
        np.add.at(out.T, self.bin_band[valid], power_spec[:, valid].T)
        return out * self.sp


def _iir(b: np.ndarray, a: np.ndarray, x: np.ndarray) -> np.ndarray:
    from scipy.signal import lfilter

    return lfilter(b, a, x)


def _bandpass_power(x: np.ndarray, fs: int, lo: float = 325.0, hi: float = 3250.0) -> float:
    """Mean-square power of x restricted to [lo, hi] Hz (FFT mask, used for
    P.862 level alignment to the nominal 1e7 power)."""
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    spec[(freqs < lo) | (freqs > hi)] = 0.0
    y = np.fft.irfft(spec, len(x))
    return float(np.mean(y * y)) + 1e-20


def _fix_level(x: np.ndarray, fs: int) -> np.ndarray:
    return x * np.sqrt(1e7 / _bandpass_power(x, fs))


def _input_filter(x: np.ndarray, fs: int, mode: str) -> np.ndarray:
    if mode == "wb":
        return _iir(_WB_IIR_B, _WB_IIR_A, x)
    # nb mode: IRS-receive-like bandpass approximated in the FFT domain
    # (the ITU code uses a hand-tuned IIR cascade; P.48 IRS receive is a
    # 300-3400 Hz bandpass with a rising response).
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    gain_db = np.full_like(freqs, -60.0)
    band = (freqs >= 200.0) & (freqs <= 3600.0)
    gain_db[band] = 6.0 * np.log2(np.maximum(freqs[band], 1.0) / 1000.0)
    lo_roll = (freqs >= 100.0) & (freqs < 200.0)
    gain_db[lo_roll] = -30.0
    spec *= 10.0 ** (gain_db / 20.0)
    return np.fft.irfft(spec, len(x))


def _block_power(x: np.ndarray, block: int) -> np.ndarray:
    n = len(x) // block
    return np.mean(x[: n * block].reshape(n, block) ** 2, axis=1)


def _vad(p: np.ndarray) -> np.ndarray:
    """ISODATA two-class threshold on block powers -> log-VAD envelope
    (0 for inactive blocks), the crude-alignment feature of P.862."""
    thr = float(np.mean(p))
    for _ in range(24):
        hi, lo = p[p > thr], p[p <= thr]
        if len(hi) == 0 or len(lo) == 0:
            break
        new = 0.5 * (float(np.mean(hi)) + float(np.mean(lo)))
        if abs(new - thr) < 1e-6 * thr:
            break
        thr = new
    logvad = np.where(p > thr, np.log(np.maximum(p / max(thr, 1e-20), 1.0)), 0.0)
    return logvad


def _crude_align(lv_ref: np.ndarray, lv_deg: np.ndarray) -> int:
    """Delay of deg relative to ref, in blocks, via FFT cross-correlation
    of the log-VAD envelopes."""
    n = 1 << int(np.ceil(np.log2(len(lv_ref) + len(lv_deg))))
    r = np.fft.rfft(lv_ref, n)
    d = np.fft.rfft(lv_deg, n)
    corr = np.fft.irfft(d * np.conj(r), n)
    lags = np.concatenate([np.arange(n // 2), np.arange(-(n - n // 2), 0)])
    k = int(np.argmax(corr))
    return int(lags[k])


def _utterances(logvad: np.ndarray, min_len: int, max_gap: int):
    """Contiguous active regions (block indices), gaps <= max_gap joined,
    regions < min_len dropped. Returns list of (start, end) blocks."""
    active = logvad > 0
    if not active.any():
        return []
    idx = np.flatnonzero(active)
    spans = []
    start = prev = idx[0]
    for i in idx[1:]:
        if i - prev > max_gap:
            spans.append((start, prev + 1))
            start = i
        prev = i
    spans.append((start, prev + 1))
    return [(s, e) for s, e in spans if e - s >= min_len]


def _fine_align(
    ref_full: np.ndarray,
    deg_full: np.ndarray,
    a: int,
    b: int,
    crude: int,
    max_lag: int,
) -> int:
    """Sample-resolution delay refinement for ref_full[a:b] around the
    crude estimate, via cross-correlation of the (filtered) slices."""
    lo = max(0, a + crude)
    hi = min(len(deg_full), b + crude)
    if hi - lo < 4 * max_lag:
        return crude
    r = ref_full[lo - crude : hi - crude]
    d = deg_full[lo:hi]
    n = 1 << int(np.ceil(np.log2(len(r) + 2 * max_lag)))
    fr = np.fft.rfft(r, n)
    fd = np.fft.rfft(d, n)
    corr = np.fft.irfft(fd * np.conj(fr), n)
    cand = np.concatenate([corr[: max_lag + 1], corr[-max_lag:]])
    lags = np.concatenate([np.arange(max_lag + 1), np.arange(-max_lag, 0)])
    return crude + int(lags[int(np.argmax(cand))])


def _frame_spectra(x: np.ndarray, starts: np.ndarray, frame: int) -> np.ndarray:
    """Hann-windowed power spectra [T, frame//2+1] at the given starts.

    Unnormalized |FFT|^2, matching the P.862 internal unit convention
    (band sums scaled by Sp land at ~1e7 total for active frames)."""
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(frame) / frame))
    pad = np.concatenate([x, np.zeros(frame)])
    frames = pad[starts[:, None] + np.arange(frame)[None, :]] * window
    spec = np.fft.rfft(frames, axis=-1)
    return spec.real**2 + spec.imag**2


def _lp(values: np.ndarray, p: float, axis=-1) -> np.ndarray:
    return np.mean(np.abs(values) ** p, axis=axis) ** (1.0 / p)


def pesq_indicator(fs: int, ref: np.ndarray, deg: np.ndarray,
                   mode: str = "wb") -> float:
    """Combined disturbance indicator v = 0.1*D + 0.0309*DA (the P.862
    linear-combination input, before the raw-MOS mapping). Exposed so the
    raw->MOS calibration can be fit on anchor sets (scripts/calibrate_pesq)."""
    if mode not in ("wb", "nb"):
        raise ValueError(f"mode must be 'wb' or 'nb', got {mode!r}")
    if fs not in _RATE_CFG:
        raise ValueError(f"fs must be 8000 or 16000, got {fs}")
    if mode == "wb" and fs != 16000:
        raise ValueError("wb mode requires fs=16000")
    cfg = _RATE_CFG[fs]
    frame, down, nb = cfg["frame"], cfg["downsample"], cfg["nb"]

    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)
    n = min(len(ref), len(deg))
    if n < 4 * frame:
        raise ValueError("signals too short for PESQ")
    ref, deg = ref[:n], deg[:n]

    # -- level alignment + input filtering
    ref = _fix_level(ref, fs)
    deg = _fix_level(deg, fs)
    ref_f = _input_filter(ref, fs, mode)
    deg_f = _input_filter(deg, fs, mode)

    # -- VAD + time alignment
    p_ref = _block_power(ref_f, down)
    p_deg = _block_power(deg_f, down)
    lv_ref = _vad(p_ref)
    lv_deg = _vad(p_deg)
    crude_blocks = _crude_align(lv_ref, lv_deg)
    crude = crude_blocks * down
    # ~200 ms minimum utterance, ~200 ms max join gap (in 4 ms blocks)
    utts = _utterances(lv_ref, min_len=50, max_gap=50)
    if not utts:
        utts = [(0, len(lv_ref))]
    delays = [
        _fine_align(ref_f, deg_f, s * down, e * down, crude, 2 * down)
        for s, e in utts
    ]

    # -- frame loop over ref; matching deg frame via per-utterance delay
    step = frame // 2
    starts_ref = np.arange(0, n - frame + 1, step)
    frame_block = (starts_ref + frame // 2) // down
    frame_utt = np.zeros(len(starts_ref), np.int64)
    for ui, (s, e) in enumerate(utts):
        frame_utt[(frame_block >= s) & (frame_block < e)] = ui
    # frames before the first / after the last utterance inherit the
    # nearest utterance's delay
    first_s = utts[0][0]
    frame_utt[frame_block < first_s] = 0
    frame_utt[frame_block >= utts[-1][1]] = len(utts) - 1
    d_per_frame = np.array([delays[u] for u in frame_utt])
    starts_deg = np.clip(starts_ref + d_per_frame, 0, n - 1)

    spec_ref = _frame_spectra(ref_f, starts_ref, frame)
    spec_deg = _frame_spectra(deg_f, starts_deg, frame)

    bands = _BarkBands(fs, frame, nb)
    ppd_ref = bands.warp(spec_ref)  # [T, nb] pitch power densities
    ppd_deg = bands.warp(spec_deg)

    # -- frequency-response compensation: equalize REF towards DEG using
    # band means over speech-active frames (P.862 partial compensation)
    total_ref = ppd_ref.sum(axis=1)
    active = total_ref > 1e-2 * max(float(total_ref.max()), 1e-20)
    if not active.any():
        active = np.ones_like(active)
    avg_ref = ppd_ref[active].mean(axis=0)
    avg_deg = ppd_deg[active].mean(axis=0)
    band_factor = np.clip((avg_deg + 1e3) / (avg_ref + 1e3), 0.01, 100.0)
    ppd_ref_eq = ppd_ref * band_factor[None, :]

    # -- short-term gain compensation: equalize DEG towards REF per frame,
    # first-order smoothed over time
    num = ppd_ref_eq.sum(axis=1) + 5e3
    den = ppd_deg.sum(axis=1) + 5e3
    raw_scale = np.clip(num / den, 3e-4, 5.0)
    scale = np.empty_like(raw_scale)
    s_prev = 1.0
    for t in range(len(raw_scale)):
        s_prev = 0.8 * s_prev + 0.2 * raw_scale[t]
        scale[t] = s_prev
    ppd_deg_eq = ppd_deg * scale[:, None]

    # -- Zwicker loudness
    thr = bands.abs_thresh[None, :]
    sl_scale = _SL * (thr / 0.5) ** _ZWICKER_POWER

    def loudness(p):
        l = sl_scale * ((0.5 + 0.5 * p / thr) ** _ZWICKER_POWER - 1.0)
        return np.where(p > thr, l, 0.0)

    loud_ref = loudness(ppd_ref_eq)
    loud_deg = loudness(ppd_deg_eq)

    # -- masked disturbance
    d = loud_deg - loud_ref
    m = _MASK_FACTOR * np.minimum(loud_deg, loud_ref)
    d = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)

    # -- asymmetric disturbance (additive distortions penalized harder)
    h = ((ppd_deg_eq + 50.0) / (ppd_ref_eq + 50.0)) ** _ASYM_EXPONENT
    h = np.where(h < _ASYM_GATE, 0.0, np.minimum(h, _ASYM_CAP))
    d_asym = d * h

    # -- per-frame band aggregation (width-weighted Lp)
    w = bands.width_bark[None, :]
    d_frame = (np.sum(w * np.abs(d) ** _D_POW_F, axis=1) / np.sum(w)) ** (1.0 / _D_POW_F)
    da_frame = np.sum(w * np.abs(d_asym), axis=1) / np.sum(w)

    # -- frame weighting by reference loudness (quiet frames count less)
    frame_weight = ((total_ref + 1e5) / 1e7) ** 0.04
    d_frame = np.minimum(d_frame / frame_weight, _FRAME_CAP)
    da_frame = np.minimum(da_frame / frame_weight, _FRAME_CAP)

    # -- (L6 over 50%-overlapped split-second intervals, L2 over time)
    def lpq(values):
        ln, stp = _SPLIT_SECOND_LEN, _SPLIT_SECOND_LEN // 2
        if len(values) < ln:
            return float(_lp(values, _POW_SPLIT))
        sub = np.array([
            _lp(values[i : i + ln], _POW_SPLIT)
            for i in range(0, len(values) - ln + 1, stp)
        ])
        return float(_lp(sub, _POW_TIME))

    d_ind = lpq(d_frame)
    da_ind = lpq(da_frame)
    return float(0.1 * d_ind + 0.0309 * da_ind)


# Raw-MOS mapping calibration (see scripts/calibrate_pesq.py). P.862
# combines the indicators linearly (4.5 - 0.1 D - 0.0309 DA) in the units
# of its hand-tuned tables; with the derived tables used here the
# indicator scale is compressed, so the combined indicator v is mapped
# through a power law raw = 4.5 - A * v**P fit by least squares against
# APPROXIMATE published-behavior targets of the ITU implementation over a
# multi-family anchor set (additive white/pink noise at several SNRs,
# low-pass filtering, clipping, reverb, level offsets) — not white noise
# alone. Identity still maps to 4.5 raw. Scores remain a LOCAL scale:
# rank-correlated with ITU PESQ but not ITU-conformant, and in particular
# not comparable to the reference's committed golden values.
_CAL_A = 3.7858
_CAL_P = 0.3916


def pesq(fs: int, ref: np.ndarray, deg: np.ndarray, mode: str = "wb") -> float:
    """P.862 PESQ score (MOS-LQO, local calibration — see module doc).
    ``mode``: "wb" (P.862.2, fs=16000) or "nb" (P.862/P.862.1, fs=8000 or
    16000). Signature matches the `pesq` wheel consumed by the reference
    (df/sepm.py:499)."""
    v = pesq_indicator(fs, ref, deg, mode)
    raw = 4.5 - _CAL_A * v**_CAL_P
    raw = float(np.clip(raw, -0.5, 4.5))
    if mode == "wb":
        # P.862.2 mapping to MOS-LQO
        return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))
    # P.862.1 mapping to MOS-LQO
    return 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))
