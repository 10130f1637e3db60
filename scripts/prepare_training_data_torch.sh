#!/usr/bin/env bash
# Build all training/eval DBs with the PyTorch port: the steps of
# scripts/prepare_training_data.sh, in the same order, through
# python -m tepose_tpu_torch.preprocess.<builder>. Feature extraction runs on
# CUDA device $TEPOSE_GPU (default 0; TEPOSE_GPU=cpu runs on the host).
# Expects raw datasets under data/ (see python -m
# tepose_tpu_torch.preprocess.<builder> --help).
set -euo pipefail
GPU=${TEPOSE_GPU:-0}
python -m tepose_tpu_torch.preprocess.amass     --dir data/amass
python -m tepose_tpu_torch.preprocess.threedpw  --dir data/3dpw --set all --gpu "$GPU"
python -m tepose_tpu_torch.preprocess.mpii3d    --dir data/mpi_inf_3dhp --set train --gpu "$GPU"
python -m tepose_tpu_torch.preprocess.mpii3d    --dir data/mpi_inf_3dhp --set val --gpu "$GPU"
python -m tepose_tpu_torch.preprocess.h36m      --dir data/h36m --set train --variant tight --gpu "$GPU"
python -m tepose_tpu_torch.preprocess.h36m      --dir data/h36m --set train --variant occ --gpu "$GPU"
python -m tepose_tpu_torch.preprocess.posetrack --dir data/posetrack --set train --gpu "$GPU"
python -m tepose_tpu_torch.preprocess.insta     --dir data/insta_variety --gpu "$GPU"
