"""Grow a clean speech pool with VTLP-synthesized "new speakers", the port's
copy of the repository's `scripts/make_vtlp_pool.py`, over the port's
`RandVTLP`, `Hdf5Dataset` and HDF5 writer (`data/h5file.py`), so it runs
where h5py is not installed.

Each warp factor alpha is one consistent pseudo-speaker: every clip of SRC
is warped at every alpha (vocal-tract-length perturbation: the magnitude
envelope's frequency axis scaled by alpha, the phase kept). The pool feeds
training as an extra clean corpus (`scripts/train_demo.py`'s
`DEMO_EXTRA_CLEAN=<file>:<factor>`).

    python -m deepfilternet_torch.scripts.make_vtlp_pool SRC.hdf5 OUT.hdf5 \
        [--alphas 0.9,0.95,1.05,1.1] [--include-original]

Writes a PCM int16 HDF5 (root attributes sr, max_freq, codec, dtype,
db_name) with one clip <key>_vtlp<alpha> per key and alpha, after the
unwarped clip under its own key with --include-original; each clip with
`n_samples` and `n_channels`. Its samples equal the root script's bit for
bit; the port's writer stores each clip chunked at deflate level 2, where
h5py's default is contiguous, which no reader sees.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from deepfilternet_torch.data.augmentations import RandVTLP
from deepfilternet_torch.data.h5file import H5Writer
from deepfilternet_torch.data.hdf5 import Hdf5Dataset


def make_pool(src_path: str, out_path: str, alphas, include_original: bool = False) -> int:
    """Write the pool of `src_path` warped at each of `alphas` into
    `out_path` (a new file). Returns the clips written."""
    src = Hdf5Dataset(src_path)
    rng = np.random.default_rng(0)  # unused: each alpha range is one value
    n = 0
    try:
        with H5Writer(out_path, "w") as dst:
            dst.set_attr("/", "sr", src.sr)
            dst.set_attr("/", "max_freq", src.max_freq)
            dst.set_attr("/", "codec", "pcm")
            dst.set_attr("/", "dtype", "int16")
            dst.set_attr("/", "db_name", os.path.basename(out_path))
            for g in src.groups:
                dst.require_group(g)
                for k in src.keys(g):
                    audio = src.read(g, k)  # [C, T] float32
                    variants = [("", audio)] if include_original else []
                    for a in alphas:
                        warp = RandVTLP(prob=1.0, sr=src.sr, alpha_range=(a, a))
                        variants.append((f"_vtlp{a:g}", warp.apply(audio.copy(), rng)))
                    for suffix, y in variants:
                        pcm = np.clip(y * 32768.0, -32768, 32767).astype(np.int16)
                        dst.create_dataset(f"{g}/{k}{suffix}", pcm,
                                           attrs={"n_samples": int(pcm.shape[-1]),
                                                  "n_channels": int(pcm.shape[0])})
                        n += 1
    finally:
        src.close()
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description="Grow a clean speech pool with VTLP pseudo-speakers")
    ap.add_argument("src")
    ap.add_argument("out")
    ap.add_argument("--alphas", default="0.9,0.95,1.05,1.1")
    ap.add_argument("--include-original", action="store_true",
                    help="also copy the unwarped clips into OUT")
    args = ap.parse_args(argv)
    alphas = [float(a) for a in args.alphas.split(",") if a]
    n = make_pool(args.src, args.out, alphas, args.include_original)
    print(f"wrote {args.out}: {n} clips "
          f"({len(alphas)} warps{' + original' if args.include_original else ''})")


if __name__ == "__main__":
    main()
