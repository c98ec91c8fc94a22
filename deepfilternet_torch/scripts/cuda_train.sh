#!/usr/bin/env bash
# Cluster training wrapper for the port's trainer (the counterpart of the
# repository's scripts/tpu_train.sh): run training under a walltime; the
# trainer writes `continue` on SIGUSR1 (sent by the scheduler before the
# walltime); this wrapper resubmits itself while the continue file exists:
# with sbatch inside a SLURM job, else by running itself again.
#
# Usage: deepfilternet_torch/scripts/cuda_train.sh DATA_CFG DATA_DIR BASE_DIR [EXTRA_ARGS...]
# EXTRA_ARGS go to `python3 -m deepfilternet_torch.train.run`, `--device cpu`
# among them to train on the CPU (without it the trainer wants CUDA).
set -euo pipefail

DATA_CFG=$1; DATA_DIR=$2; BASE_DIR=$3; shift 3

rm -f "$BASE_DIR/continue"
python3 -m deepfilternet_torch.train.run "$DATA_CFG" "$DATA_DIR" "$BASE_DIR" "$@"

if [[ -f "$BASE_DIR/continue" ]]; then
    echo "continue file found - resubmitting"
    if command -v sbatch >/dev/null 2>&1 && [[ -n "${SLURM_JOB_NAME:-}" ]]; then
        sbatch "$0" "$DATA_CFG" "$DATA_DIR" "$BASE_DIR" "$@"
    else
        exec "$0" "$DATA_CFG" "$DATA_DIR" "$BASE_DIR" "$@"
    fi
fi
