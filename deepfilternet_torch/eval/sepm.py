"""Speech-enhancement performance measures (reference: df/sepm.py).

NumPy implementations of the classic Loizou composite-measure suite:
segmental SNR, frequency-weighted segmental SNR, log-likelihood ratio
(LPC-based), weighted spectral slope, and the Hu & Loizou CSIG/CBAK/COVL
regressions (published constants; sepm.py:490-510).

PESQ (ITU-T P.862): the reference consumes the `pesq` wheel
(df/sepm.py:499). `composite()` uses that wheel when installed, else the
from-spec NumPy implementation in eval/pesq.py; a custom callable with
the same signature can be injected via `pesq_fn`.

The port's copy of `deepfilternet_tpu.eval.sepm` (numpy and scipy only).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np

EPS = np.finfo(np.float64).eps


def _frames(x: np.ndarray, winlength: int, skiprate: int,
            window: Optional[np.ndarray] = None) -> np.ndarray:
    n = (len(x) - winlength) // skiprate + 1
    idx = np.arange(n)[:, None] * skiprate + np.arange(winlength)[None, :]
    out = x[idx]
    if window is not None:
        out = out * window
    return out


def snr_seg(clean: np.ndarray, processed: np.ndarray, fs: int,
            frame_len: float = 0.03, overlap: float = 0.75) -> float:
    """Segmental SNR, hann-windowed 30 ms frames, clamped [-10, 35] dB,
    last frame dropped (sepm.py:28-52)."""
    winlength = round(frame_len * fs)
    skiprate = int(np.floor((1 - overlap) * frame_len * fs))
    win = 0.5 * (1 - np.cos(2 * np.pi * np.arange(1, winlength + 1) / (winlength + 1)))
    c = _frames(clean.astype(np.float64), winlength, skiprate, win)
    p = _frames(processed.astype(np.float64), winlength, skiprate, win)
    sig = np.sum(c**2, -1)
    noise = np.sum((c - p) ** 2, -1)
    seg = 10 * np.log10(sig / (noise + EPS) + EPS)
    seg = np.clip(seg, -10, 35)[:-1]
    return float(np.mean(seg))


# 25 critical bands (center, bandwidth) used by fwSNRseg/WSS (Loizou tables)
_CENT_FREQ = np.array([
    50.0, 120.0, 190.0, 260.0, 330.0, 400.0, 470.0, 540.0, 617.372, 703.378,
    798.717, 904.128, 1020.38, 1148.30, 1288.72, 1442.54, 1610.70, 1794.16,
    1993.93, 2211.08, 2446.71, 2701.97, 2978.04, 3276.17, 3597.63,
])
_BANDWIDTH = np.array([
    70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 77.3724, 86.0056, 95.3398,
    105.411, 116.256, 127.914, 140.423, 153.823, 168.154, 183.457, 199.776,
    217.153, 235.631, 255.255, 276.072, 298.126, 321.465, 346.136,
])


def _crit_band_filters(n_fftby2: int, fs: float) -> np.ndarray:
    """Gaussian-shaped critical band filters over the rfft half spectrum."""
    num_crit = len(_CENT_FREQ)
    max_freq = fs / 2
    # Loizou: gaussian window centered at cf with 'bw' controlling spread
    min_factor = math.exp(-30.0 / (2 * 2.303))
    filters = np.zeros((num_crit, n_fftby2))
    j = np.arange(n_fftby2)
    for i in range(num_crit):
        cf = (_CENT_FREQ[i] / max_freq) * n_fftby2
        bw = (_BANDWIDTH[i] / max_freq) * n_fftby2
        norm_factor = math.log(bw) if bw > 1 else 0.0
        filters[i] = np.exp(-11 * (((j - math.floor(cf)) / bw) ** 2) + norm_factor)
        filters[i][filters[i] < min_factor] = 0.0
    return filters


def fw_snr_seg(clean: np.ndarray, processed: np.ndarray, fs: int,
               frame_len: float = 0.03, overlap: float = 0.75) -> float:
    """Frequency-weighted segmental SNR over 25 critical bands with
    magnitude^gamma weighting (gamma=0.2; sepm.py:54-182)."""
    clean = clean.astype(np.float64) + EPS
    processed = processed.astype(np.float64) + EPS
    winlength = round(frame_len * fs)
    skiprate = int(np.floor((1 - overlap) * frame_len * fs))
    n_fft = int(2 ** np.ceil(np.log2(2 * winlength)))
    n_fftby2 = n_fft // 2
    gamma = 0.2
    win = 0.5 * (1 - np.cos(2 * np.pi * np.arange(1, winlength + 1) / (winlength + 1)))
    c = _frames(clean, winlength, skiprate, win)
    p = _frames(processed, winlength, skiprate, win)
    c_spec = np.abs(np.fft.fft(c, n_fft, axis=-1))[:, :n_fftby2]
    p_spec = np.abs(np.fft.fft(p, n_fft, axis=-1))[:, :n_fftby2]
    filters = _crit_band_filters(n_fftby2, fs)
    c_e = (c_spec**2) @ filters.T
    p_e = (p_spec**2) @ filters.T
    w = c_e**gamma
    snr = 10 * np.log10((c_e + EPS) / (np.abs(c_e - p_e) + EPS))
    snr = np.clip(snr, -10, 35)
    fw = np.sum(w * snr, -1) / np.sum(w, -1)
    return float(np.mean(fw))


def lpcoeff(frame: np.ndarray, order: int) -> Tuple[np.ndarray, np.ndarray]:
    """Levinson-Durbin LPC (autocorrelation method). Returns (A, R)."""
    winlength = len(frame)
    r = np.array([np.dot(frame[: winlength - k], frame[k:]) for k in range(order + 1)])
    a = np.ones(order)
    e = np.zeros(order + 1)
    rcoeff = np.zeros(order)
    a_past = np.zeros(order)
    e[0] = r[0]
    for i in range(order):
        a_past[:i] = a[:i]
        sum_term = np.dot(a_past[:i], r[i:0:-1])
        rcoeff[i] = (r[i + 1] - sum_term) / max(e[i], EPS)
        a[i] = rcoeff[i]
        if i > 0:
            a[:i] = a_past[:i] - rcoeff[i] * a_past[i - 1 :: -1]
        e[i + 1] = (1 - rcoeff[i] * rcoeff[i]) * e[i]
    acorr = r
    lpparams = np.concatenate([[1.0], -a])
    return lpparams, acorr


def llr(clean: np.ndarray, processed: np.ndarray, fs: int,
        frame_len: float = 0.03, overlap: float = 0.75) -> float:
    """Log-likelihood ratio via LPC (sepm.py:241-296), mean over the lower
    95% of frames (standard outlier trimming)."""
    order = 10 if fs < 10000 else 16
    winlength = round(frame_len * fs)
    skiprate = int(np.floor((1 - overlap) * frame_len * fs))
    win = 0.5 * (1 - np.cos(2 * np.pi * np.arange(1, winlength + 1) / (winlength + 1)))
    c = _frames(clean.astype(np.float64), winlength, skiprate, win)
    p = _frames(processed.astype(np.float64), winlength, skiprate, win)
    vals = []
    for i in range(c.shape[0]):
        a_c, r_c = lpcoeff(c[i], order)
        a_p, _ = lpcoeff(p[i], order)
        # toeplitz autocorrelation matrix of the clean frame
        from scipy.linalg import toeplitz

        rmat = toeplitz(r_c[: order + 1])
        num = a_p @ rmat @ a_p
        den = a_c @ rmat @ a_c
        if den <= 0 or num <= 0:
            continue
        vals.append(np.log(num / den))
    vals = np.sort(np.asarray(vals))
    vals = vals[: int(round(len(vals) * 0.95))]
    return float(np.mean(vals)) if len(vals) else 0.0


def wss(clean: np.ndarray, processed: np.ndarray, fs: int,
        frame_len: float = 0.03, overlap: float = 0.75) -> float:
    """Weighted spectral slope distance (Klatt 1982; sepm.py:299-487)."""
    clean = clean.astype(np.float64)
    processed = processed.astype(np.float64)
    winlength = round(frame_len * fs)
    skiprate = int(np.floor((1 - overlap) * frame_len * fs))
    max_freq = fs / 2
    num_crit = len(_CENT_FREQ)
    n_fft = int(2 ** np.ceil(np.log2(2 * winlength)))
    n_fftby2 = n_fft // 2
    Kmax = 20.0
    Klocmax = 1.0
    win = 0.5 * (1 - np.cos(2 * np.pi * np.arange(1, winlength + 1) / (winlength + 1)))
    c = _frames(clean, winlength, skiprate, win)
    p = _frames(processed, winlength, skiprate, win)
    c_spec = np.abs(np.fft.fft(c, n_fft, axis=-1))[:, :n_fftby2]
    p_spec = np.abs(np.fft.fft(p, n_fft, axis=-1))[:, :n_fftby2]
    filters = _crit_band_filters(n_fftby2, fs)
    c_e = 10 * np.log10(np.maximum((c_spec**2) @ filters.T, 1e-10))
    p_e = 10 * np.log10(np.maximum((p_spec**2) @ filters.T, 1e-10))

    distortion = []
    for m in range(c_e.shape[0]):
        ce, pe = c_e[m], p_e[m]
        c_slope = np.diff(ce)
        p_slope = np.diff(pe)
        # nearest local peak above each band
        def peaks(e, slope):
            pk = np.zeros(num_crit - 1)
            for i in range(num_crit - 1):
                if slope[i] > 0:
                    j = i
                    while j < num_crit - 1 and slope[j] > 0:
                        j += 1
                    pk[i] = e[j]
                else:
                    j = i
                    while j > 0 and slope[j - 1] <= 0:
                        j -= 1
                    pk[i] = e[j]
            return pk

        c_peak = peaks(ce, c_slope)
        p_peak = peaks(pe, p_slope)
        dbmax_c = ce.max()
        dbmax_p = pe.max()
        w_max_c = Kmax / (Kmax + dbmax_c - ce[: num_crit - 1])
        w_locmax_c = Klocmax / (Klocmax + c_peak - ce[: num_crit - 1])
        w_c = w_max_c * w_locmax_c
        w_max_p = Kmax / (Kmax + dbmax_p - pe[: num_crit - 1])
        w_locmax_p = Klocmax / (Klocmax + p_peak - pe[: num_crit - 1])
        w_p = w_max_p * w_locmax_p
        w = (w_c + w_p) / 2.0
        distortion.append(np.sum(w * (c_slope - p_slope) ** 2) / np.sum(w))
    distortion = np.sort(np.asarray(distortion))
    distortion = distortion[: int(round(len(distortion) * 0.95))]
    return float(np.mean(distortion))


def composite(
    clean: np.ndarray,
    processed: np.ndarray,
    fs: int,
    pesq_fn: Optional[Callable[[int, np.ndarray, np.ndarray, str], float]] = None,
) -> Tuple[float, float, float, float, float]:
    """(PESQ, CSIG, CBAK, COVL, SegSNR) with the Hu & Loizou regressions
    (sepm.py:490-510). PESQ-dependent values are NaN without a pesq_fn."""
    assert fs == 16000, "composite operates at 16 kHz"
    wss_dist = wss(clean, processed, fs)
    llr_mean = llr(clean, processed, fs)
    seg_snr = snr_seg(clean, processed, fs)
    if pesq_fn is None:
        try:
            # prefer the ITU reference implementation when the wheel exists
            from pesq import pesq as pesq_fn  # type: ignore
        except ImportError:
            from .pesq import pesq as pesq_fn  # from-spec NumPy P.862
    pesq_mos = float(pesq_fn(fs, clean, processed, "wb"))
    csig = float(np.clip(3.093 - 1.029 * llr_mean + 0.603 * pesq_mos
                         - 0.009 * wss_dist, 1, 5))
    cbak = float(np.clip(1.634 + 0.478 * pesq_mos - 0.007 * wss_dist
                         + 0.063 * seg_snr, 1, 5))
    covl = float(np.clip(1.594 + 0.805 * pesq_mos - 0.512 * llr_mean
                         - 0.007 * wss_dist, 1, 5))
    return pesq_mos, csig, cbak, covl, seg_snr
