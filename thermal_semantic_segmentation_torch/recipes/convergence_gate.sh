#!/usr/bin/env bash
# Synthetic convergence gate on the PyTorch/CUDA port: proves the port can
# actually TRAIN a segmenter, end to end through its CLIs, not just run
# steps.
#
#   1. Write a learnable-by-construction Freiburg tree (labels are a
#      function of pixel intensity, recipes/synthetic_trees.py
#      make_learnable_freiburg_tree; a working trainer reaches ~1.0 mIoU).
#   2. segmentation_train CLI (small --layers config, full 256x512 protocol).
#   3. segmentation_evaluate CLI on the synthetic IR test split.
#   4. Assert mean IoU >= MIN_MIOU (default 0.9) via recipes/assert_miou.py,
#      the same check full_pipeline.sh makes with the 0.52 threshold.
#
# Every stage runs thermal_semantic_segmentation_torch.cli.* on the CUDA
# card (DEVICE=cpu runs them on the CPU). All knobs are environment
# variables:
#   thermal_semantic_segmentation_torch/recipes/convergence_gate.sh
#   WORKDIR=/path STEPS=0 EPOCHS=4 .../convergence_gate.sh
#   smoke:  EPOCHS=1 STEPS=2 MIN_MIOU=0 .../convergence_gate.sh
#   full width:  LAYERS=3,4,23,3 LR=0.001 .../convergence_gate.sh
set -euo pipefail

HERE="$(cd "$(dirname "$0")" && pwd)"
REPO="$(cd "${HERE}/../.." && pwd)"
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"

WORKDIR=${WORKDIR:-$(mktemp -d "${TMPDIR:-/tmp}/tss_convergence.XXXX")}
EPOCHS=${EPOCHS:-100}             # ~25 steps/epoch; the intensity rule needs
STEPS=${STEPS:-0}                 # ~2000+ steps to beat view memorization
BATCH=${BATCH:-8}
LAYERS=${LAYERS:-1,1,1,1}
LR=${LR:-0.003}
MIN_MIOU=${MIN_MIOU:-0.9}
N_TRAIN=${N_TRAIN:-256}
CKPT=${CKPT:-convergence_gate.pth}
DEVICE=${DEVICE:-}                # empty = the CUDA card; cpu = the CPU

cd "${WORKDIR}"
python -c "
from thermal_semantic_segmentation_torch.recipes.synthetic_trees import (
    make_learnable_freiburg_tree)
make_learnable_freiburg_tree('datasets/freiburg', n_train=${N_TRAIN},
                             n_test=8, n_bands=3)
print('[gate] synthetic learnable tree at', '${WORKDIR}/datasets/freiburg')
"

run() {
  local mod=$1; shift
  echo "+ [gate] ${mod} $*"
  python -u -m "thermal_semantic_segmentation_torch.cli.${mod}" "$@" \
      ${DEVICE:+--device "${DEVICE}"}
}

run segmentation_train -dataset freiburg_ir -net_mode one_channel \
    -epochs "${EPOCHS}" -batch_size "${BATCH}" -val_batch_size "${BATCH}" \
    -lr "${LR}" -max_steps "${STEPS}" --layers "${LAYERS}" \
    --decode_cache_mb 1024 -new_checkpoint_name "${CKPT}"

EVAL_LOG=$(mktemp "${TMPDIR:-/tmp}/tss_convergence_eval.XXXX")
run segmentation_evaluate -dataset freiburg_ir -checkpoint_name "${CKPT}" \
    --layers "${LAYERS}" | tee "${EVAL_LOG}"

python "${HERE}/assert_miou.py" "${EVAL_LOG}" "${MIN_MIOU}"
