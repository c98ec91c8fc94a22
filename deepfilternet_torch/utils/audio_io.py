"""WAV audio I/O with int16 scaling, as in the JAX package's
`utils/audio_io.py`.

Stdlib `wave` + NumPy, no soundfile/torchaudio dependency; reads PCM 8/16/24/32
WAVs and writes PCM16. Audio arrays are float32 [C, T] in [-1, 1]. Resampling
is polyphase (`scipy.signal.resample_poly`).
"""

from __future__ import annotations

import wave
from typing import Optional, Tuple

import numpy as np


def load_audio(path: str, sr: Optional[int] = None, verbose: bool = True
               ) -> Tuple[np.ndarray, int]:
    """Load a WAV file -> (audio [C, T] float32, sample_rate).

    If `sr` is given and differs from the file rate, resamples (polyphase,
    see `resample`).
    """
    with wave.open(path, "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        # could be PCM32 or float32; wave module doesn't expose format tag,
        # assume PCM32 (reference fixtures are PCM16)
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        x = ints.astype(np.float32) / 8388608.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported sample width {width}")
    audio = x.reshape(-1, n_ch).T.copy()  # [C, T]
    if sr is not None and sr != rate:
        audio = resample(audio, rate, sr)
        rate = sr
    return audio, rate


def save_audio(path: str, audio: np.ndarray, sr: int, dtype: str = "int16"):
    """Save [C, T] or [T] float32 audio as PCM16 WAV (int16 scaling)."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    data = np.clip(audio, -1.0, 1.0)
    pcm = (data * 32767.0).round().astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.T.tobytes())


def resample(audio: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling (the host-side analog of the reference's rubato
    FftFixedInOut synchronous resampler, transforms.rs:363-436)."""
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, new_sr)
    return resample_poly(audio, new_sr // g, orig_sr // g, axis=-1).astype(np.float32)
