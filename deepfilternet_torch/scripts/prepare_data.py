"""Create training HDF5 datasets from audio files, the port's copy of
`deepfilternet_tpu.scripts.prepare_data`, written by the port's own HDF5
writer (`data/h5file.py`), so it runs where h5py is not installed.

Reference: df/scripts/prepare_data.py: one HDF5 per corpus with a group per
content type (speech|noise|rir), root attrs sr/max_freq/codec/dtype/db_name/
db_id, one gzip-2 dataset per input file with an `n_samples` attr. PCM int16
or float32 (vorbis/flac *reading* is supported by the data engine through
the native decoders; encoding is not vendored — store PCM).

Like the JAX script (h5py's mode "a"), it edits an existing file in
place (`H5Writer(output, "a")`): the new clips and the changed groups are
appended, a key written again is unlinked and written anew, and the root
attributes are set anew; every other clip stays where it is. A file that
does not exist is created. A call that fails (a file that does not load)
leaves the output as it was.

Usage:
    python -m deepfilternet_torch.scripts.prepare_data speech out.hdf5 \
        file1.wav file2.wav ... [--sr 48000] [--dtype int16]
    python -m deepfilternet_torch.scripts.prepare_data noise out.hdf5 --glob 'dir/*.wav'
"""

from __future__ import annotations

import argparse
import glob as globmod
import os
import time

import numpy as np

from deepfilternet_torch.data.h5file import H5Writer
from deepfilternet_torch.utils.audio_io import load_audio, resample


def sanitize_key(path: str) -> str:
    return path.strip("/").replace("/", "_").replace("\\", "_")


def prepare(
    content: str,
    output: str,
    files: list,
    sr: int = 48000,
    dtype: str = "int16",
    max_freq: int | None = None,
    mono: bool = False,
):
    assert content in ("speech", "noise", "rir")
    assert dtype in ("int16", "float32")
    with H5Writer(output, "a") as f:
        f.set_attr("/", "sr", sr)
        f.set_attr("/", "max_freq", max_freq or sr // 2)
        f.set_attr("/", "codec", "pcm")
        f.set_attr("/", "dtype", dtype)
        f.set_attr("/", "db_name", os.path.basename(output))
        f.set_attr("/", "db_id", int(time.time()))
        f.require_group(content)
        n_written = 0
        for path in files:
            audio, fsr = load_audio(path)
            if fsr != sr:
                audio = resample(audio, fsr, sr)
            if mono and audio.shape[0] > 1:
                audio = audio.mean(axis=0, keepdims=True)
            if dtype == "int16":
                data = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
            else:
                data = audio.astype(np.float32)
            key = f"{content}/{sanitize_key(path)}"
            if key in f:
                f.delete(key)
            # gzip-2 chunks of every channel and one second at 48 kHz
            f.create_dataset(key, data, attrs={"n_samples": np.array([audio.shape[-1]])})
            n_written += 1
    print(f"Wrote {n_written} {content} samples to {output}")
    return n_written


def main(argv=None):
    parser = argparse.ArgumentParser(description="Create a DeepFilterNet HDF5 dataset")
    parser.add_argument("content", choices=["speech", "noise", "rir"])
    parser.add_argument("output")
    parser.add_argument("files", nargs="*")
    parser.add_argument("--glob", default=None)
    parser.add_argument("--sr", type=int, default=48000)
    parser.add_argument("--dtype", default="int16", choices=["int16", "float32"])
    parser.add_argument("--max-freq", type=int, default=None)
    parser.add_argument("--mono", action="store_true")
    args = parser.parse_args(argv)
    files = list(args.files)
    if args.glob:
        files += sorted(globmod.glob(args.glob))
    if not files:
        parser.error("no input files")
    prepare(args.content, args.output, files, sr=args.sr, dtype=args.dtype,
            max_freq=args.max_freq, mono=args.mono)


if __name__ == "__main__":
    main()
