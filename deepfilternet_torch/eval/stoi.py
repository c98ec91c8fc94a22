"""Short-Time Objective Intelligibility (STOI), Taal et al. 2011.

NumPy implementation of the standard algorithm (the reference ships a
torch port in df/stoi.py): resample to 10 kHz, 512-FFT / 256-window / 50%
overlap analysis, silent-frame removal at 40 dB below the clean maximum,
15 one-third-octave bands from 150 Hz, 384 ms (N=30 frame) segments with
per-band normalization + SDR clipping at beta = -15 dB, averaged band
correlation.

The port's copy of `deepfilternet_tpu.eval.stoi` (numpy and scipy only).
"""

from __future__ import annotations

import numpy as np

FS = 10000
N_FRAME = 256
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N = 30  # segment length in frames
BETA = -15.0
DYN_RANGE = 40.0


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = cf * 2 ** (-1.0 / 6)
    hi = cf * 2 ** (1.0 / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo_i = np.argmin((f - lo[i]) ** 2)
        hi_i = np.argmin((f - hi[i]) ** 2)
        obm[i, lo_i:hi_i] = 1.0
    return obm


def _stft_frames(x: np.ndarray) -> np.ndarray:
    hop = N_FRAME // 2
    n = (len(x) - N_FRAME) // hop + 1
    if n <= 0:
        return np.zeros((0, NFFT // 2 + 1))
    idx = np.arange(n)[:, None] * hop + np.arange(N_FRAME)[None, :]
    w = np.hanning(N_FRAME + 2)[1:-1]
    frames = x[idx] * w
    return np.fft.rfft(frames, NFFT, axis=-1)


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    hop = N_FRAME // 2
    n = (len(x) - N_FRAME) // hop + 1
    idx = np.arange(n)[:, None] * hop + np.arange(N_FRAME)[None, :]
    w = np.hanning(N_FRAME + 2)[1:-1]
    xf = x[idx] * w
    yf = y[idx] * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=-1) + 1e-10)
    mask = energies > energies.max() - DYN_RANGE
    xf, yf = xf[mask], yf[mask]
    # overlap-add back
    def ola(frames):
        out = np.zeros((len(frames) - 1) * hop + N_FRAME if len(frames) else 0)
        for i, fr in enumerate(frames):
            out[i * hop : i * hop + N_FRAME] += fr
        return out

    return ola(xf), ola(yf)


def stoi(clean: np.ndarray, processed: np.ndarray, fs: int,
         extended: bool = False) -> float:
    """STOI in [0, 1]. clean/processed: 1-D float arrays at `fs` Hz."""
    clean = np.asarray(clean, np.float64).reshape(-1)
    processed = np.asarray(processed, np.float64).reshape(-1)
    if fs != FS:
        from deepfilternet_torch.utils.audio_io import resample

        clean = resample(clean[None], fs, FS)[0].astype(np.float64)
        processed = resample(processed[None], fs, FS)[0].astype(np.float64)
    clean, processed = _remove_silent_frames(clean, processed)
    if len(clean) < N_FRAME * 2:
        return float("nan")
    x_spec = _stft_frames(clean)
    y_spec = _stft_frames(processed)
    obm = _thirdoct(FS, NFFT, NUM_BANDS, MIN_FREQ)
    x = np.sqrt(np.maximum(obm @ (np.abs(x_spec.T) ** 2), 1e-20))  # [bands, T]
    y = np.sqrt(np.maximum(obm @ (np.abs(y_spec.T) ** 2), 1e-20))
    t = x.shape[1]
    if t < N:
        return float("nan")
    d_sum = 0.0
    count = 0
    clip_factor = 10 ** (-BETA / 20.0)
    for m in range(N, t + 1):
        xm = x[:, m - N : m]
        ym = y[:, m - N : m]
        alpha = np.linalg.norm(xm, axis=1, keepdims=True) / (
            np.linalg.norm(ym, axis=1, keepdims=True) + 1e-20
        )
        ym_n = np.minimum(ym * alpha, xm * (1 + clip_factor))
        xm_c = xm - xm.mean(axis=1, keepdims=True)
        ym_c = ym_n - ym_n.mean(axis=1, keepdims=True)
        num = np.sum(xm_c * ym_c, axis=1)
        den = np.linalg.norm(xm_c, axis=1) * np.linalg.norm(ym_c, axis=1) + 1e-20
        d_sum += float(np.sum(num / den))
        count += NUM_BANDS
    return d_sum / count
