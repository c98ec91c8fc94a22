"""ctypes bindings to the native data-engine library (native/dfdata.cpp),
as `deepfilternet_tpu.data._native` binds it: the same sources and the same
`native/libdfdata.so`.

Builds libdfdata.so on demand with make/g++ (the toolchain is part of the
runtime image). Falls back gracefully: `available()` is False when the
library cannot be built, and codec decode raises a clear error.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdfdata.so")

_lib = None
_lock = threading.Lock()


def _build() -> bool:
    """make the library into a file of this process's own, then rename it
    over native/libdfdata.so, so that no process loads a half-written file
    (the JAX package's bindings make the same file in place, and a loader
    that opens it mid-link fails with "file too short")."""
    tmp = f".libdfdata.{os.getpid()}.so"
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, f"TARGET={tmp}", tmp],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(os.path.join(_NATIVE_DIR, tmp)):
            os.remove(os.path.join(_NATIVE_DIR, tmp))


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.isfile(_LIB_PATH) or (
            os.path.isfile(os.path.join(_NATIVE_DIR, "dfdata.cpp"))
            and os.path.getmtime(os.path.join(_NATIVE_DIR, "dfdata.cpp"))
            > os.path.getmtime(_LIB_PATH)
        ):
            if not _build() and not os.path.isfile(_LIB_PATH):
                return None
        for attempt in range(3):
            try:
                lib = ctypes.CDLL(_LIB_PATH)
                break
            except OSError:
                # another process is writing the file in place: make a whole
                # one of our own and load that
                if attempt == 2 or not _build():
                    raise
        lib.df_decode_flac.restype = ctypes.c_int64
        lib.df_decode_flac.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.df_decode_vorbis.restype = ctypes.c_int64
        lib.df_decode_vorbis.argtypes = lib.df_decode_flac.argtypes
        lib.df_biquad_chain.restype = None
        lib.df_biquad_chain.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _decode(fn_name: str, data: bytes, n_samples_hint: int) -> Tuple[np.ndarray, int]:
    """Returns (audio [C, T] float32 in [-1,1], sample_rate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "Native decoder library unavailable (native/libdfdata.so failed to build)"
        )
    max_frames = max(int(n_samples_hint) + 48000, 48000)
    out = np.empty(max_frames * 8, np.int16)  # up to 8 channels
    channels = ctypes.c_int(0)
    sr = ctypes.c_int(0)
    fn = getattr(lib, fn_name)
    n = fn(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        max_frames,
        ctypes.byref(channels), ctypes.byref(sr),
    )
    if n == -2:
        raise RuntimeError("libvorbisfile not found on this system")
    if n < 0:
        raise ValueError(f"{fn_name}: decode error")
    c = max(channels.value, 1)
    audio = out[: n * c].reshape(n, c).T.astype(np.float32) / 32768.0
    return audio, sr.value


def decode_flac(data: bytes, n_samples_hint: int = 0) -> Tuple[np.ndarray, int]:
    return _decode("df_decode_flac", data, n_samples_hint)


def decode_vorbis(data: bytes, n_samples_hint: int = 0) -> Tuple[np.ndarray, int]:
    return _decode("df_decode_vorbis", data, n_samples_hint)


def biquad_chain(x: np.ndarray, coefs: np.ndarray) -> np.ndarray:
    """In sequence apply biquad sections (each [b0,b1,b2,a0,a1,a2]) with f64
    state, matching transforms.rs:21-56. x: [T] float32 (copied)."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float32).copy()
    coefs = np.ascontiguousarray(np.atleast_2d(coefs), np.float64)
    if lib is None:
        # scipy fallback
        from scipy.signal import lfilter

        for c in coefs:
            b = c[:3] / c[3]
            a = np.array([1.0, c[4] / c[3], c[5] / c[3]])
            x = lfilter(b, a, x.astype(np.float64)).astype(np.float32)
        return x
    lib.df_biquad_chain(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size,
        coefs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), coefs.shape[0],
    )
    return x
