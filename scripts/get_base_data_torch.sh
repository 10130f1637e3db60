#!/usr/bin/env bash
# Convert user-downloaded base assets for the PyTorch port: the steps of
# scripts/get_base_data.sh, in the same order, through the port's JAX-free
# converters (python -m tepose_tpu_torch.convert_smpl / .convert_checkpoint).
# The converters run on the host; they need neither JAX nor joblib.
#
# Usage: scripts/get_base_data_torch.sh <downloads_dir> [out_dir=data/base_data]
set -euo pipefail
SRC=${1:?downloads dir}
OUT=${2:-data/base_data}
mkdir -p "$OUT"

[ -f "$SRC/SMPL_NEUTRAL.pkl" ] && \
  python -m tepose_tpu_torch.convert_smpl "$SRC/SMPL_NEUTRAL.pkl" "$OUT/smpl_neutral.npz" \
    --j-regressor-extra "$SRC/J_regressor_extra.npy"
for g in male female; do
  up=$(echo "$g" | tr '[:lower:]' '[:upper:]')
  [ -f "$SRC/SMPL_${up}.pkl" ] && \
    python -m tepose_tpu_torch.convert_smpl "$SRC/SMPL_${up}.pkl" "$OUT/smpl_${g}.npz" \
      --j-regressor-extra "$SRC/J_regressor_extra.npy"
done
[ -f "$SRC/spin_model_checkpoint.pth.tar" ] && \
  python -m tepose_tpu_torch.convert_checkpoint "$SRC/spin_model_checkpoint.pth.tar" \
    "$OUT/spin_model_checkpoint.npz" --kind spin
for v in vibe_wo_3dpw vibe_w_3dpw; do
  [ -f "$SRC/$v.pth.tar" ] && \
    python -m tepose_tpu_torch.convert_checkpoint "$SRC/$v.pth.tar" "$OUT/$v.npz" --kind vibe
done
for f in J_regressor_h36m.npy smpl_mean_params.npz; do
  [ -f "$SRC/$f" ] && cp "$SRC/$f" "$OUT/"
done
echo "base data ready in $OUT"
