#!/usr/bin/env bash
# Full RGB->thermal domain-adaptation recipe on the PyTorch/CUDA port, end
# to end, in the reference order:
#
#   1. CycleGAN translation training            (reference main.py)
#   2. Offline translation of the RGB source    (translator.py)
#   3. Supervised seg training on translations  (segmentation_train.py)
#   4. Pseudo-label generation (soft + hard)    (generate_pseudo_label.py)
#   5. Class-prototype calculation              (cal_prototype.py)
#   6. Prototype-rectified self-training        (self_train_main.py)
#   7. Final evaluation on the Freiburg IR test (segmentation_evaluate.py)
#      -> asserts mean IoU >= MIN_MIOU (0.52 = the reference's own best-run
#         save threshold, self_train_main.py:53).
#
# Every stage runs thermal_semantic_segmentation_torch.cli.* on the CUDA
# card (DEVICE=cpu runs them on the CPU). Run from a working directory that
# contains datasets/freiburg in the reference layout
# (train/seq_*/NN/{fl_ir_aligned,fl_rgb,fl_rgb_labels},
# test/day/{ImagesIR,SegmentationClass}). All knobs are environment
# variables, so the same script drives the real recipe and a smoke run on
# a synthetic tree:
#
#   smoke:  MAX_STEPS=2 GAN_EPOCHS=1 SEG_EPOCHS=1 ST_EPOCHS=1 MIN_MIOU=0 \
#           BATCH=2 thermal_semantic_segmentation_torch/recipes/full_pipeline.sh
#   real:   thermal_semantic_segmentation_torch/recipes/full_pipeline.sh
set -euo pipefail

HERE="$(cd "$(dirname "$0")" && pwd)"
REPO="$(cd "${HERE}/../.." && pwd)"
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"

GAN_EPOCHS=${GAN_EPOCHS:-65}        # reference options.py:15 default
SEG_EPOCHS=${SEG_EPOCHS:-30}
ST_EPOCHS=${ST_EPOCHS:-1}
BATCH=${BATCH:-4}
SEG_BATCH=${SEG_BATCH:-8}
MAX_STEPS=${MAX_STEPS:-0}           # 0 = full epochs; >0 = smoke cap
MIN_MIOU=${MIN_MIOU:-0.52}          # self_train_main.py:53 threshold
TRANSLATION=${TRANSLATION:-translation}
GAN_CKPT=${GAN_CKPT:-recipe_gan.pth}
SEG_CKPT=${SEG_CKPT:-recipe_seg.pth}
ST_CKPT=${ST_CKPT:-recipe_st.pth}
SKIP_GAN=${SKIP_GAN:-0}             # 1 = reuse an existing ${GAN_CKPT}
DEVICE=${DEVICE:-}                  # empty = the CUDA card; cpu = the CPU
# Translation-fidelity losses of the GAN stage: the contour loss needs no
# checkpoint; the semantic loss needs per-domain seg checkpoints.
WITH_CONTOUR=${WITH_CONTOUR:-true}
SEM_S=${SEM_S:-}                    # RGB-domain seg ckpt  -> -sem_loss on
SEM_T=${SEM_T:-}                    # thermal-domain seg ckpt
SEM_MODE=${SEM_MODE:-module2}       # module2 (seg ckpts) | legacy
GAN_FIDELITY=(-with_contour "${WITH_CONTOUR}")
if [ -n "${SEM_S}" ] && [ -n "${SEM_T}" ]; then
  GAN_FIDELITY+=(-sem_loss true -sem_mode "${SEM_MODE}" \
                 -sem_checkpoint_s "${SEM_S}" -sem_checkpoint_t "${SEM_T}")
fi

run() {
  local mod=$1; shift
  echo "+ [recipe] ${mod} $*"
  python -u -m "thermal_semantic_segmentation_torch.cli.${mod}" "$@" \
      ${DEVICE:+--device "${DEVICE}"}
}

if [ "${SKIP_GAN}" != "1" ]; then
  run main -source_dataset freiburg_rgb -target_dataset freiburg_ir \
      -batch_size "${BATCH}" -num_epoch "${GAN_EPOCHS}" -max_steps "${MAX_STEPS}" \
      -checkpoint_name "${GAN_CKPT}" -new_checkpoint_name "${GAN_CKPT}" \
      "${GAN_FIDELITY[@]}"
fi

run translator -dataset freiburg_rgb -checkpoint_name "${GAN_CKPT}" \
    -input_nc 3 -output_nc 1 -save_image_size 320 700 \
    -translation_name_suffix "" --root .

run segmentation_train -dataset freiburg_translation -net_mode one_channel \
    -translation_name "${TRANSLATION}" -epochs "${SEG_EPOCHS}" \
    -batch_size "${SEG_BATCH}" -val_batch_size "${SEG_BATCH}" \
    -max_steps "${MAX_STEPS}" -new_checkpoint_name "${SEG_CKPT}"

run generate_pseudo_label --root . -checkpoint_name "${SEG_CKPT}" \
    -pseudo_type hard
run generate_pseudo_label --root . -checkpoint_name "${SEG_CKPT}" \
    -pseudo_type soft --soft true

run cal_prototype -checkpoint_name "${SEG_CKPT}" -dataset freiburg_ir -root .

run self_train_main --root . -checkpoint_name "${SEG_CKPT}" \
    -new_checkpoint_name "${ST_CKPT}" -batch_size "${BATCH}" \
    --epochs "${ST_EPOCHS}" -max_steps "${MAX_STEPS}" --val_interval 500 \
    -translation_name "${TRANSLATION}"

# Final eval: the best self-train checkpoint on the Freiburg IR test split.
EVAL_LOG=$(mktemp)
run segmentation_evaluate -dataset freiburg_ir -checkpoint_name "best${ST_CKPT}" \
    --root . | tee "${EVAL_LOG}"

python "${HERE}/assert_miou.py" "$EVAL_LOG" "$MIN_MIOU"

# Deployment artifact from the gated checkpoint (EXPORT=0 to skip): a
# torch.export program servable by `serve --artifact`, as the int8
# weight-only container by default, self-checked against the live model.
if [ "${EXPORT:-1}" = "1" ]; then
  run export_stablehlo -checkpoint_name "best${ST_CKPT}" \
      --quantize "${EXPORT_QUANTIZE:-int8}" --check true
fi
