#!/usr/bin/env bash
# One-GPU batch job for the PyTorch/CUDA port (relightable3dgaussians_w_torch)
# on an NVIDIA H100. It keeps the contract of the reference's Slurm job
# (batch_relit3DGW.sh): one GPU, the scene staged to node-local scratch, the
# full pipeline (train -> render -> metrics -> GT-envmap evaluation) through
# cli.full_eval, and whatever output exists copied back even when the run
# fails. It also runs under plain bash, without Slurm.
#
# Usage:
#   DATA_ROOT=/data/nerfosr OUT_ROOT=/results sbatch deploy/batch_relit3dgw_h100.sh <scene> [key=value ...]
#   DATA_ROOT=/data/nerfosr OUT_ROOT=/results bash deploy/batch_relit3dgw_h100.sh <scene> [key=value ...]
#
# DATA_ROOT holds <scene>/ (and test_configs/<scene>/ for the GT-envmap step);
# the results land in $OUT_ROOT/<scene>. Arguments after the scene go to
# cli.full_eval as config overrides. $PYTHON names the interpreter (default
# python3); $REPO the checkout (default: the submit directory under Slurm, else
# this script's parent directory), put on PYTHONPATH when it holds the package.
# The exit code is full_eval's.
#
#SBATCH --job-name=relit3dgw-h100
#SBATCH --gpus=1
#SBATCH --cpus-per-task=8
#SBATCH --mem=64G
#SBATCH --time=24:00:00
set -u

SCENE="${1:?usage: $0 <scene> [key=value overrides]}"
shift
DATA_ROOT="${DATA_ROOT:?set DATA_ROOT to the directory that holds <scene>/}"
OUT_ROOT="${OUT_ROOT:?set OUT_ROOT to the directory that receives <scene>/}"
PYTHON="${PYTHON:-python3}"
if [ -n "${SLURM_JOB_ID:-}" ]; then
    REPO="${REPO:-${SLURM_SUBMIT_DIR:-$PWD}}"
else
    REPO="${REPO:-$(cd "$(dirname "$0")/.." && pwd)}"
fi
if [ -d "$REPO/relightable3dgaussians_w_torch" ]; then
    export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
fi
WORK="${SLURM_TMPDIR:-${TMPDIR:-/tmp}}/relit3dgw-${SCENE}-${SLURM_JOB_ID:-$$}"

rescue() {
    rc=$?
    # Copy back whatever output exists, on success and on failure alike.
    if [ -d "$WORK/out/$SCENE" ]; then
        mkdir -p "$OUT_ROOT/$SCENE"
        cp -r "$WORK/out/$SCENE/." "$OUT_ROOT/$SCENE/" || echo "rescue: copy failed" >&2
    fi
    rm -rf "$WORK"
    exit "$rc"
}
trap rescue EXIT

mkdir -p "$WORK/data" "$WORK/out" || exit 1
cp -r "$DATA_ROOT/$SCENE" "$WORK/data/" || exit 1
if [ -d "$DATA_ROOT/test_configs/$SCENE" ]; then
    mkdir -p "$WORK/data/test_configs" || exit 1
    cp -r "$DATA_ROOT/test_configs/$SCENE" "$WORK/data/test_configs/" || exit 1
fi

"$PYTHON" -m relightable3dgaussians_w_torch.cli.full_eval \
    --data_root="$WORK/data" --output="$WORK/out" --scenes="$SCENE" "$@"
