"""HDF5 dataset utilities (reference: df/scripts hdf5 helpers + the
sample-hdf5/sample-dataset debug binaries), the port's copy of
`deepfilternet_tpu.scripts.hdf5_tool` over its own HDF5 reader and writer
(`data/h5file.py`), so it runs where h5py is not installed.

Subcommands:
    list    out keys, lengths, attrs of a dataset file
    sample  decode one key (or a random one) to a wav for listening
    split   split a dataset's keys into train/valid/test HDF5 files
    trim    copy a dataset keeping only keys shorter than a max length
    fix     repair sr/max_freq/n_samples/n_channels attrs
            (reference: df/scripts/fix_n_samples_hdf5.py)

`split` and `trim` copy every chunked dataset as h5py's `copy` does: its
chunks byte for byte, in its own chunk shape and filters (int16 or float32
PCM, the uint8 byte streams of vorbis and FLAC), with its attributes. `fix`
edits the attributes in place (`H5Writer(file, "a")`, as h5py's mode
"r+"): the new headers are appended and no sample is moved.

Usage:
    python -m deepfilternet_torch.scripts.hdf5_tool list file.hdf5
    python -m deepfilternet_torch.scripts.hdf5_tool sample file.hdf5 out.wav [--key K]
    python -m deepfilternet_torch.scripts.hdf5_tool split file.hdf5 outdir --ratios 0.8,0.1,0.1
    python -m deepfilternet_torch.scripts.hdf5_tool trim file.hdf5 out.hdf5 --max-len-s 30
    python -m deepfilternet_torch.scripts.hdf5_tool fix file.hdf5 [--sr 48000] [--max-freq F]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from deepfilternet_torch.data.h5file import Group, H5File, H5Writer, copy_group
from deepfilternet_torch.data.hdf5 import Hdf5Dataset
from deepfilternet_torch.utils.audio_io import save_audio


def cmd_list(args):
    ds = Hdf5Dataset(args.file)
    print(f"{ds.name}: sr={ds.sr} max_freq={ds.max_freq} codec={ds.codec} "
          f"dtype={ds.dtype}")
    for g in ds.groups:
        keys = ds.keys(g)
        total = sum(ds.sample_len(g, k) for k in keys)
        print(f"  [{g}] {len(keys)} keys, {total / ds.sr / 3600:.2f} h")
        for k in keys[: args.max_keys]:
            print(f"    {k}: {ds.sample_len(g, k) / ds.sr:.2f}s")
    ds.close()


def cmd_sample(args):
    ds = Hdf5Dataset(args.file)
    group = args.group or ds.groups[0]
    keys = ds.keys(group)
    key = args.key or keys[np.random.default_rng(args.seed).integers(0, len(keys))]
    audio = ds.read(group, key)
    ds.close()
    save_audio(args.out, audio, ds.sr)
    print(f"Wrote {group}/{key} ({audio.shape[-1] / ds.sr:.2f}s) to {args.out}")


def _groups(src: H5File):
    """The root's groups, in h5py's order."""
    root = src["/"]
    return [g for g in root.keys() if isinstance(root[g], Group)]


def cmd_split(args):
    ratios = [float(r) for r in args.ratios.split(",")]
    assert abs(sum(ratios) - 1.0) < 1e-6 and len(ratios) == 3
    rng = np.random.default_rng(args.seed)
    splits = ("train", "valid", "test")
    with H5File(args.file) as src:
        keys = {s: set() for s in splits}
        for g in _groups(src):
            ks = sorted(src[g].keys())
            rng.shuffle(ks)
            n = len(ks)
            bounds = [0, int(n * ratios[0]), int(n * (ratios[0] + ratios[1])), n]
            for split, lo, hi in zip(splits, bounds[:-1], bounds[1:]):
                keys[split] |= {f"{g}/{k}" for k in ks[lo:hi]}
        stem = os.path.splitext(os.path.basename(args.file))[0]
        every = set.union(*keys.values())
        for split in splits:
            with H5Writer(os.path.join(args.outdir, f"{stem}_{split}.hdf5")) as out:
                copy_group(src["/"], out, "", every - keys[split])
            counts = {g: sum(k.startswith(f"{g}/") for k in keys[split]) for g in _groups(src)}
            print(f"{split}: {counts}")


def cmd_trim(args):
    with H5File(args.file) as src, H5Writer(args.out) as dst:
        sr = int(src.attrs.get("sr", 48000))
        max_len = int(args.max_len_s * sr)
        longer = set()
        for g in _groups(src):
            for k in src[g].keys():
                ds = src[g][k]
                if int(np.atleast_1d(ds.attrs.get("n_samples", ds.shape[-1]))[0]) > max_len:
                    longer.add(f"{g}/{k}")
        copy_group(src["/"], dst, "", longer)
        kept = sum(len(src[g].keys()) for g in _groups(src)) - len(longer)
    print(f"kept {kept}, dropped {len(longer)} (> {args.max_len_s}s)")


def cmd_fix(args):
    """Repair dataset attrs in place (reference: df/scripts/
    fix_n_samples_hdf5.py): ensure file-level sr/max_freq exist, decode
    every entry and rewrite its n_samples/n_channels attrs from the actual
    audio shape, and drop the legacy n_ch attr."""
    reader = Hdf5Dataset(args.file)  # picks up sr/max_freq/codec defaults
    sr, max_freq, codec = reader.sr, reader.max_freq, reader.codec
    if args.sr:
        sr = args.sr
    if args.max_freq:
        max_freq = args.max_freq
    fixed = 0
    try:
        with H5Writer(args.file, "a") as h5f:
            h5f.set_attr("/", "sr", sr)
            h5f.set_attr("/", "max_freq", max_freq)
            src = reader.file
            for g in _groups(src):
                for k in src[g].keys():
                    audio = reader.read(g, k)  # [C, T] float
                    n_samples = int(audio.shape[-1])
                    n_channels = int(audio.shape[0]) if audio.ndim == 2 else 1
                    assert n_channels <= 16, (k, audio.shape)
                    attrs = src[g][k].attrs
                    old = attrs.get("n_samples", None)
                    if old is not None and int(np.atleast_1d(old)[0]) != n_samples:
                        print(f"  {g}/{k}: n_samples {old} -> {n_samples}")
                        fixed += 1
                    h5f.set_attr(f"{g}/{k}", "n_samples", n_samples)
                    h5f.set_attr(f"{g}/{k}", "n_channels", n_channels)
                    if "n_ch" in attrs:
                        h5f.del_attr(f"{g}/{k}", "n_ch")
    finally:
        reader.close()
    print(f"fixed {fixed} entries (sr={sr} max_freq={max_freq} codec={codec})")


def main(argv=None):
    parser = argparse.ArgumentParser(description="HDF5 dataset utilities")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("list")
    p.add_argument("file")
    p.add_argument("--max-keys", type=int, default=10)
    p = sub.add_parser("sample")
    p.add_argument("file")
    p.add_argument("out")
    p.add_argument("--key", default=None)
    p.add_argument("--group", default=None)
    p.add_argument("--seed", type=int, default=0)
    p = sub.add_parser("split")
    p.add_argument("file")
    p.add_argument("outdir")
    p.add_argument("--ratios", default="0.8,0.1,0.1")
    p.add_argument("--seed", type=int, default=0)
    p = sub.add_parser("trim")
    p.add_argument("file")
    p.add_argument("out")
    p.add_argument("--max-len-s", type=float, required=True)
    p = sub.add_parser("fix")
    p.add_argument("file")
    p.add_argument("--sr", type=int, default=None)
    p.add_argument("--max-freq", type=int, default=None)
    args = parser.parse_args(argv)
    {"list": cmd_list, "sample": cmd_sample, "split": cmd_split,
     "trim": cmd_trim, "fix": cmd_fix}[args.cmd](args)


if __name__ == "__main__":
    main()
