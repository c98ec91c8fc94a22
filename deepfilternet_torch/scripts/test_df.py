"""Golden-metric regression harness (reference: df/scripts/test_df.py), the
port's copy of `deepfilternet_tpu.scripts.test_df`.

Enhances assets/noisy_snr0.wav with each configured model and asserts
STOI / SI-SDR / SNRseg / the composite measures against golden values
stored in a JSON next to the model dir (the reference hard-codes goldens
for its released checkpoints; without those weights, goldens are generated
from your own trained checkpoints with --update-golden and asserted
thereafter at atol/rtol 1e-4). The default inputs are the reference
repository's `assets/` files, relative to the working directory (run from
a DeepFilterNet checkout's root, as the reference does); a missing input
raises `FileNotFoundError` naming it.

The goldens bundled under `pretrained/*/golden_metrics.json` were computed
on those assets; they can be rerun only where the assets are. The model
runs on the CUDA device unless `--device cpu` is given.

Usage:
    python -m deepfilternet_torch.scripts.test_df MODEL_DIR [...] \
        [--noisy wav] [--clean wav] [--update-golden] [--rtol 1e-4] \
        [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np

DEFAULT_NOISY = os.path.join("assets", "noisy_snr0.wav")
DEFAULT_CLEAN = os.path.join("assets", "clean_freesound_33711.wav")
METRICS = ("stoi", "sisdr", "snrseg", "composite")


def eval_model(model_dir: str, noisy_path: str, clean_path: str,
               device=None) -> Dict[str, float]:
    from deepfilternet_torch.enhance import enhance, init_df
    from deepfilternet_torch.eval.evaluation import compute_metrics
    from deepfilternet_torch.utils.audio_io import load_audio, resample

    for path in (noisy_path, clean_path):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no such audio file: {path}")
    model, df_state, suffix = init_df(model_dir, device=device)
    noisy, sr = load_audio(noisy_path)
    if sr != df_state.sr:
        noisy = resample(noisy, sr, df_state.sr)
    clean, csr = load_audio(clean_path)
    if csr != df_state.sr:
        clean = resample(clean, csr, df_state.sr)
    enhanced = enhance(model, df_state, noisy)
    n = min(clean.shape[-1], enhanced.shape[-1])
    return compute_metrics(clean[0, :n], enhanced[0, :n], df_state.sr, METRICS)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Golden metric regression")
    parser.add_argument("model_dirs", nargs="+")
    parser.add_argument("--noisy", default=DEFAULT_NOISY)
    parser.add_argument("--clean", default=DEFAULT_CLEAN)
    parser.add_argument("--update-golden", action="store_true")
    parser.add_argument("--rtol", type=float, default=1e-4)
    parser.add_argument("--atol", type=float, default=1e-4)
    parser.add_argument("--device", default=None,
                        help="torch device for the model (default: the CUDA device; "
                             "'cpu' for the CPU)")
    args = parser.parse_args(argv)

    failed = False
    for model_dir in args.model_dirs:
        golden_path = os.path.join(model_dir, "golden_metrics.json")
        got = eval_model(model_dir, args.noisy, args.clean, device=args.device)
        print(f"{model_dir}: " + " ".join(f"{k}={v:.5f}" for k, v in got.items()))
        if args.update_golden:
            payload = dict(got)
            payload["_pesq_scale"] = (
                "local from-spec calibration (eval/pesq.py, multi-family "
                "anchors) — NOT comparable to ITU P.862 values such as the "
                "reference's committed goldens"
            )
            with open(golden_path, "w") as f:
                json.dump(payload, f, indent=2)
            print(f"  wrote {golden_path}")
            continue
        if not os.path.isfile(golden_path):
            print(f"  WARNING: no golden file at {golden_path}; run with "
                  "--update-golden first")
            continue
        with open(golden_path) as f:
            golden = json.load(f)
        for k, v in golden.items():
            if k.startswith("_"):
                continue
            if k in got and not np.isclose(got[k], v, rtol=args.rtol, atol=args.atol):
                print(f"  FAIL {k}: got {got[k]:.6f}, golden {v:.6f}")
                failed = True
            else:
                print(f"  ok  {k}")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
