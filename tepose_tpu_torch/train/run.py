"""Training CLI of the port.

Counterpart of the repository's `train.py` (JAX):

  python -m tepose_tpu_torch.train --cfg configs/repr_wopw_3dpw_model.yaml
  python -m tepose_tpu_torch.train --cfg ... --synthetic   # generated data
      [--smoke-iters N] [--smoke-verts V] [--gpu 0|cpu]

`run_train(cfg, ...)` is what the CLI calls: TePose with the fast encoder
(as `train.py` builds it) from `torch.Generator().manual_seed(0)`, the GCN
motion discriminator from seed 1, the regressor warm-started from
`TRAIN.PRETRAINED_REGRESSOR` when that file exists, the loaders (synthetic
DBs with `--synthetic`), both optimizers, and `train.fit.TrainLoop.fit`.
Matmuls and cuDNN run in strict float32; `--precision` accepts `float32`
only. `--devices` and `--profile` are not ported and raise. With
`cfg.DEBUG` the loop writes prediction-overlay videos, drawing the mesh
with the SMPL assets' faces, or for the synthetic model a triangle soup
over its vertices, as `train.py` does.
"""

from __future__ import annotations

import os.path as osp
import sys
from typing import Optional

import numpy as np
import torch

from tepose_tpu_torch.evaluate import strict_f32, synthetic_j_regressor

UNPORTED_FLAGS = ("--devices", "--profile")


def build_train_loop(cfg, *, synthetic: bool = False,
                     smoke_iters: Optional[int] = None,
                     smoke_verts: Optional[int] = None,
                     device: torch.device | str = "cuda",
                     cfg_file: Optional[str] = None):
    """Models, data and optimizers on `device`; returns (TrainLoop,
    outer batches per epoch)."""
    from tepose_tpu_torch.config import BASE_DATA_DIR
    from tepose_tpu_torch.data.loaders import get_data_loaders
    from tepose_tpu_torch.data.synthetic import synthetic_loaders
    from tepose_tpu_torch.models.gcn import MotionDiscriminator
    from tepose_tpu_torch.models.smpl import (
        load_smpl_assets, load_smpl_faces, synthetic_smpl_model)
    from tepose_tpu_torch.models.tepose import TePose, TePoseConfig
    from tepose_tpu_torch.train.fit import TrainLoop
    from tepose_tpu_torch.train.loss import LossWeights
    from tepose_tpu_torch.train.optim import make_optimizer
    from tepose_tpu_torch.train.trainer import TrainHyper
    from tepose_tpu_torch.utils.logging import prepare_output_dir
    from tepose_tpu_torch.weights import (
        load_checkpoint, state_dict_from_jax_tree)

    if str(cfg.TRAIN.PRECISION) not in ("", "f32", "float32", "default"):
        raise SystemExit(f"TRAIN.PRECISION {cfg.TRAIN.PRECISION!r}: the "
                         "port trains in float32 only (bf16 compute is not "
                         "ported)")
    strict_f32()
    logdir = prepare_output_dir(cfg, cfg_file)
    if cfg.SEED_VALUE >= 0:
        np.random.seed(cfg.SEED_VALUE)

    model_cfg = TePoseConfig(seqlen=cfg.DATASET.SEQLEN,
                             n_layers=cfg.MODEL.TGRU.NUM_LAYERS,
                             hidden_size=cfg.MODEL.TGRU.HIDDEN_SIZE,
                             fast_encoder=True)
    smpl_npz = osp.join(BASE_DATA_DIR, "smpl_neutral.npz")
    if osp.isfile(smpl_npz):
        smpl = load_smpl_assets(smpl_npz, device)
        faces = load_smpl_faces(smpl_npz)
    elif synthetic:
        smpl = (synthetic_smpl_model(0, smoke_verts, device=device)
                if smoke_verts else synthetic_smpl_model(0, device=device))
        # triangle soup so the DEBUG mesh-overlay path renders something
        idx = np.arange(smpl.num_verts - 2)
        faces = np.stack([idx, idx + 1, idx + 2], axis=1)[::7].astype(np.int32)
    else:
        raise FileNotFoundError(f"{smpl_npz} missing — see tools/convert_smpl")

    gen = TePose(model_cfg, generator=torch.Generator().manual_seed(0),
                 device=device)
    gcn = cfg.TRAIN.MOT_DISCR.GCN
    disc = MotionDiscriminator(
        generator=torch.Generator().manual_seed(1), device=device,
        num_class=gcn.num_class, num_point=gcn.num_point,
        num_gcn_scales=gcn.num_gcn_scales, num_g3d_scales=gcn.num_g3d_scales)

    # warm-start the regressor from converted SPIN weights
    if cfg.TRAIN.PRETRAINED_REGRESSOR and \
            osp.isfile(cfg.TRAIN.PRETRAINED_REGRESSOR):
        trees, _ = load_checkpoint(cfg.TRAIN.PRETRAINED_REGRESSOR)
        reg = trees.get("gen", {}).get("regressor", {})
        gen.regressor.load_state_dict(state_dict_from_jax_tree(reg),
                                      strict=False)
        print(f"=> loaded pretrained regressor from "
              f"'{cfg.TRAIN.PRETRAINED_REGRESSOR}'")

    loaders = synthetic_loaders(cfg) if synthetic else get_data_loaders(cfg)
    n_2d = int(cfg.TRAIN.BATCH_SIZE * cfg.TRAIN.DATA_2D_RATIO)
    hp = TrainHyper(
        seqlen=cfg.DATASET.SEQLEN, n_2d=n_2d,
        n_3d=cfg.TRAIN.BATCH_SIZE - n_2d,
        update_theta_rate=cfg.TRAIN.UPDATE_THETA_RATE,
        disc_update_steps=cfg.TRAIN.MOT_DISCR.UPDATE_STEPS,
        num_gcn_scales=gcn.num_gcn_scales, num_g3d_scales=gcn.num_g3d_scales)
    gen_opt = make_optimizer(cfg.TRAIN.GEN_OPTIM, gen, cfg.TRAIN.GEN_LR,
                             cfg.TRAIN.GEN_WD, cfg.TRAIN.GEN_MOMENTUM)
    d = cfg.TRAIN.MOT_DISCR
    disc_opt = make_optimizer(d.OPTIM, disc, d.LR, d.WD, d.MOMENTUM)
    weights = LossWeights(kp_2d=cfg.LOSS.KP_2D_W, kp_3d=cfg.LOSS.KP_3D_W,
                          pose=cfg.LOSS.POSE_W, shape=cfg.LOSS.SHAPE_W,
                          d_motion=cfg.LOSS.D_MOTION_LOSS_W)

    jreg_path = osp.join(BASE_DATA_DIR, "J_regressor_h36m.npy")
    j_regressor = (np.load(jreg_path).astype(np.float32)
                   if osp.isfile(jreg_path)
                   else synthetic_j_regressor(smpl.num_verts))

    loop = TrainLoop(cfg=cfg, gen=gen, disc=disc, smpl=smpl, hp=hp,
                     gen_opt=gen_opt, disc_opt=disc_opt, weights=weights,
                     loaders=loaders, j_regressor=j_regressor, logdir=logdir,
                     num_iters_per_epoch=smoke_iters
                     or cfg.TRAIN.NUM_ITERS_PER_EPOCH,
                     seed=max(cfg.SEED_VALUE, 0),
                     faces=faces if len(faces) else None)
    # the reference consumes len(train_3d)/8 outer batches per epoch
    num_outer = 1 if synthetic else max(1, len(loop.train_3d) // 8)
    return loop, num_outer


def close_loaders(loop) -> None:
    for loader in (loop.train_2d, loop.train_3d, loop.disc_loader,
                   loop.valid):
        loader.close()


def run_train(cfg, **kw):
    """Train `cfg.TRAIN.START_EPOCH`..`END_EPOCH` (see `build_train_loop`
    for the options); returns the finished `TrainLoop`."""
    loop, num_outer = build_train_loop(cfg, **kw)
    try:
        loop.fit(cfg.TRAIN.END_EPOCH, num_outer)
    finally:
        close_loaders(loop)
    return loop


def _take(flag: str, cast=str):
    """Remove `flag VALUE` from sys.argv; returns VALUE or None."""
    if flag not in sys.argv:
        return None
    i = sys.argv.index(flag)
    if i + 1 >= len(sys.argv):
        raise SystemExit(f"{flag} needs a value")
    value = cast(sys.argv[i + 1])
    del sys.argv[i:i + 2]
    return value


def main():
    from tepose_tpu_torch.config import parse_args

    for flag in UNPORTED_FLAGS:
        if flag in sys.argv:
            raise SystemExit(f"{flag} is not ported to tepose_tpu_torch; "
                             "the port trains on one device")
    synthetic = "--synthetic" in sys.argv
    if synthetic:
        sys.argv.remove("--synthetic")
    smoke_iters = _take("--smoke-iters", int)
    smoke_verts = _take("--smoke-verts", int)
    if "--precision" in sys.argv:
        i = sys.argv.index("--precision")
        precision = sys.argv[i + 1] if i + 1 < len(sys.argv) else None
        if precision not in ("float32", "f32"):
            raise SystemExit(
                f"--precision {precision!r}: the port trains in float32 "
                "only; bf16 compute is not ported")
        del sys.argv[i:i + 2]
    cfg, cfg_file, args = parse_args()
    device = "cpu" if args.gpu == "cpu" else f"cuda:{int(args.gpu)}"
    return run_train(cfg, synthetic=synthetic, smoke_iters=smoke_iters,
                     smoke_verts=smoke_verts, device=device,
                     cfg_file=cfg_file)
