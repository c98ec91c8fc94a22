"""Dataset-level evaluation script, the port's copy of
`deepfilternet_tpu.scripts.eval_dir`.

Reference: df/scripts/test_dns_2020.py / test_voicebank_demand.py — run a
model over a directory of (noisy, clean) pairs and report per-file and
mean metrics with CSV export.

Conventions supported:
  * --noisy-dir/--clean-dir with matching file names (VoiceBank-DEMAND);
  * DNS layout: noisy files named `*_fileid_N.wav`, clean
    `clean_fileid_N.wav` (use --dns).

The model runs on the CUDA device unless `--device cpu` is given; without
a GPU and without `--device` it raises. The metrics run on the host.

Usage:
    python -m deepfilternet_torch.scripts.eval_dir -m MODEL_DIR \
        --noisy-dir noisy/ --clean-dir clean/ [--csv out.csv] \
        [--metrics stoi,sisdr,snrseg] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys


def pair_files(noisy_dir: str, clean_dir: str, dns: bool = False):
    noisy = sorted(glob.glob(os.path.join(noisy_dir, "*.wav")))
    pairs = []
    for n in noisy:
        base = os.path.basename(n)
        if dns:
            m = re.search(r"fileid_(\d+)\.wav$", base)
            if not m:
                continue
            c = os.path.join(clean_dir, f"clean_fileid_{m.group(1)}.wav")
        else:
            c = os.path.join(clean_dir, base)
        if os.path.isfile(c):
            pairs.append((n, c))
    return pairs


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate a model over a dataset dir")
    parser.add_argument("--model-base-dir", "-m", default=None)
    parser.add_argument("--noisy-dir", required=True)
    parser.add_argument("--clean-dir", required=True)
    parser.add_argument("--dns", action="store_true", help="DNS fileid naming")
    parser.add_argument("--csv", default=None)
    parser.add_argument("--metrics", default="stoi,sisdr,snrseg")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--pf", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device for the model (default: the CUDA device; "
                             "'cpu' for the CPU)")
    args = parser.parse_args(argv)

    from deepfilternet_torch.enhance import init_df
    from deepfilternet_torch.eval.evaluation import evaluation_loop

    pairs = pair_files(args.noisy_dir, args.clean_dir, args.dns)
    if not pairs:
        print("No (noisy, clean) pairs found", file=sys.stderr)
        sys.exit(2)
    model, df_state, _ = init_df(args.model_base_dir, post_filter=args.pf, device=args.device)
    means = evaluation_loop(
        model, df_state,
        [n for n, _ in pairs], [c for _, c in pairs],
        metrics=tuple(args.metrics.split(",")),
        n_workers=args.workers,
        csv_path=args.csv,
    )
    print(" | ".join(f"{k}: {v:.4f}" for k, v in sorted(means.items())))
    return means


if __name__ == "__main__":
    main()
