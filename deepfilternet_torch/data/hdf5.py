"""HDF5 dataset reading + key caches (reference: libDF/src/dataset.rs:123-214,
1487-1972 and hdf5_key_cache.rs), the port's copy of
`deepfilternet_tpu.data.hdf5` over its own HDF5 reader (`data/h5file.py`),
so a corpus is read where h5py is not installed.

Layout: one HDF5 file per corpus with groups `speech` / `noise` / `rir`,
root attrs `sr`, `max_freq`, `codec` (pcm|vorbis|flac), `dtype`
(int16|float32), per-key datasets (PCM: [C, T] or [T]; compressed codecs:
uint8 byte streams with an `n_samples` attr). Sidecar key caches
(`.cache_<name>.cfg` JSON validated by mtime+size) avoid re-listing large
files.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepfilternet_torch.data import _native
from deepfilternet_torch.data.h5file import H5File


class _DecodeCache:
    """Bounded LRU cache of decoded clips, shared across datasets.

    The reference decodes vorbis incrementally via granule seeking
    (dataset.rs:1487-1972); here whole-clip decodes are cached instead —
    noise clips are redrawn constantly, so caching removes the decode from
    the per-sample hot path entirely.
    """

    def __init__(self, max_bytes: int = 512 << 20):
        self._od = OrderedDict()
        self._bytes = 0
        self._max = max_bytes
        self._lock = threading.Lock()  # the loader's threads share the cache

    def get(self, key):
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
                return self._od[key]
        return None

    def put(self, key, value: np.ndarray):
        with self._lock:
            if key in self._od:
                return
            self._od[key] = value
            self._bytes += value.nbytes
            while self._bytes > self._max and len(self._od) > 1:
                _, old = self._od.popitem(last=False)
                self._bytes -= old.nbytes


_DECODE_CACHE = _DecodeCache()


def _attr_str(value) -> str:
    """A string attribute: h5py gives a variable-length one as `str` and a
    fixed-length one as `np.bytes_`."""
    return value.decode("utf-8") if isinstance(value, bytes) else str(value)


class Hdf5Dataset:
    def __init__(self, path: str, sr: Optional[int] = None,
                 max_freq: Optional[int] = None):
        self.path = path
        self.name = os.path.basename(path)
        self.file = H5File(path)
        attrs = dict(self.file.attrs)
        self.sr = int(attrs.get("sr", sr or 48000))
        self.max_freq = int(attrs.get("max_freq", max_freq or self.sr // 2))
        self.codec = _attr_str(attrs.get("codec", "pcm"))
        self.dtype = _attr_str(attrs.get("dtype", "int16"))
        self.groups = [g for g in ("speech", "noise", "rir") if g in self.file]

    def keys(self, group: str) -> List[str]:
        if group not in self.file:
            return []
        return load_key_cache(self.path, group) or sorted(self.file[group].keys())

    def sample_len(self, group: str, key: str) -> int:
        ds = self.file[group][key]
        if self.codec == "pcm":
            return ds.shape[-1]
        # n_samples may be a scalar (reference fix_n_samples writes ints)
        # or a length-1 array (our writers)
        return int(np.atleast_1d(ds.attrs.get("n_samples", 0))[0])

    def read(self, group: str, key: str, max_len: Optional[int] = None,
             rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Read (and decode) a sample -> float32 [C, T].

        For PCM, long samples are slice-read with a random offset when
        max_len is given (dataset.rs:976-1035); compressed codecs decode the
        full clip then crop.
        """
        ds = self.file[group][key]
        if self.codec == "pcm":
            total = ds.shape[-1]
            if max_len is not None and total > max_len:
                start = int(rng.integers(0, total - max_len)) if rng is not None else 0
                raw = ds[..., start : start + max_len]
            else:
                raw = ds[...]
            audio = self._to_float(np.atleast_2d(raw))
        else:
            cache_key = (self.path, group, key)
            audio = _DECODE_CACHE.get(cache_key)
            if audio is None:
                data = bytes(np.asarray(ds[...], np.uint8).tobytes())
                hint = self.sample_len(group, key)
                if self.codec == "vorbis":
                    audio, _ = _native.decode_vorbis(data, hint)
                elif self.codec == "flac":
                    audio, _ = _native.decode_flac(data, hint)
                else:
                    raise ValueError(f"Unknown codec {self.codec}")
                _DECODE_CACHE.put(cache_key, audio)
            if max_len is not None and audio.shape[-1] > max_len:
                start = int(rng.integers(0, audio.shape[-1] - max_len)) if rng is not None else 0
                audio = audio[..., start : start + max_len]
        return np.ascontiguousarray(audio, np.float32)

    def _to_float(self, x: np.ndarray) -> np.ndarray:
        if x.dtype == np.int16:
            return x.astype(np.float32) / 32768.0
        return x.astype(np.float32)

    def close(self):
        self.file.close()


# -- key cache (hdf5_key_cache.rs:6-67) -------------------------------------


def _cache_path(h5_path: str) -> str:
    d, name = os.path.split(h5_path)
    return os.path.join(d, f".cache_{os.path.splitext(name)[0]}.cfg")


def _file_hash(h5_path: str) -> Tuple[float, int]:
    st = os.stat(h5_path)
    return (st.st_mtime, st.st_size)


def store_key_cache(h5_path: str, keys_by_group: Dict[str, List[str]]):
    payload = {"hash": list(_file_hash(h5_path)), "keys": keys_by_group}
    try:
        with open(_cache_path(h5_path), "w") as f:
            json.dump(payload, f)
    except OSError:
        pass  # read-only dataset dir; cache is best-effort


def load_key_cache(h5_path: str, group: str) -> Optional[List[str]]:
    path = _cache_path(h5_path)
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if tuple(payload.get("hash", ())) != _file_hash(h5_path):
        return None  # stale
    return payload.get("keys", {}).get(group)
