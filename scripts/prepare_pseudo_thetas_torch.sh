#!/usr/bin/env bash
# Generate pseudo-theta files for every DB variant with the PyTorch port:
# the loop of scripts/prepare_pseudo_thetas.sh, over the same DBs in the same
# order, through python -m tepose_tpu_torch.preprocess.pseudo_theta on CUDA
# device $TEPOSE_GPU (default 0; TEPOSE_GPU=cpu runs on the host).
set -euo pipefail
GPU=${TEPOSE_GPU:-0}
for name in 3dpw_train 3dpw_train_occ 3dpw_val 3dpw_test 3dpw_test_all \
            mpii3d_train_scale12 mpii3d_train_scale12_occ \
            mpii3d_train_scale12_new_occ mpii3d_train_scale1 \
            mpii3d_val_scale12 posetrack_train posetrack_train_occ \
            insta_train pennaction_train_scale12 \
            h36m_train_25fps_tight h36m_train_25fps h36m_train_25fps_occ \
            h36m_test_25fps h36m_test_front_25fps_tight; do
  if [ -f "${TEPOSE_DB_DIR:-data/preprocessed_data}/${name}_db.pt" ] || \
     [ -f "${TEPOSE_DB_DIR:-data/preprocessed_data}/${name}_db.h5" ]; then
    python -m tepose_tpu_torch.preprocess.pseudo_theta --file_name "$name" --gpu "$GPU"
  fi
done
