"""Training CLI of the port.

Counterpart of the repository's `train.py` (JAX):

  python -m tepose_tpu_torch.train --cfg configs/repr_wopw_3dpw_model.yaml
  python -m tepose_tpu_torch.train --cfg ... --synthetic   # generated data
      [--smoke-iters N] [--smoke-verts V] [--gpu 0|cpu] [--devices N|auto]

`run_train(cfg, ...)` is what the CLI calls: TePose with the fast encoder
(as `train.py` builds it) from `torch.Generator().manual_seed(0)`, the GCN
motion discriminator from seed 1, the regressor warm-started from
`TRAIN.PRETRAINED_REGRESSOR` when that file exists, the loaders (synthetic
DBs with `--synthetic`), both optimizers, and `train.fit.TrainLoop.fit`.
Matmuls and cuDNN run in strict float32. `--precision bf16` (or
`TRAIN.PRECISION: bf16`, as `configs/fast_train.yaml` sets it; the flag
wins) trains with bf16 compute (`TrainHyper.compute_dtype`: bf16 parameters
and activations inside the step, float32 master weights, optimizer state,
BN statistics and metrics); `f32`, `float32` and `default` train in
float32, and other values exit as the JAX `train.py`'s do. `--profile DIR` records `loop.fit` with `torch.profiler`
(`utils.profiling.trace`) into DIR. With `cfg.DEBUG` the loop writes prediction-overlay videos, drawing the
mesh with the SMPL assets' faces, or for the synthetic model a triangle
soup over its vertices, as `train.py` does.

Data-parallel training runs one process per device over
`torch.distributed` (`parallel/distributed.py`, `parallel/dp.py`):
`--devices N` (`auto`: every visible CUDA device) starts N ranks of this
CLI on this host, rank r on cuda:r over NCCL (with `--gpu cpu`, N CPU
ranks over gloo); the `TEPOSE_COORDINATOR` / `TEPOSE_NUM_PROCESSES` /
`TEPOSE_PROCESS_ID` environment joins a launch of its own, across hosts
too (rank r on cuda:(r mod the visible count)). Each rank loads its rows
of every batch (the loaders' `num_shards`); the 2D and 3D batch splits
must divide by the number of ranks (`parallel.dp.check_divisible`).
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import socket
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from tepose_tpu_torch.evaluate import synthetic_j_regressor
from tepose_tpu_torch.parallel import distributed
from tepose_tpu_torch.precision import parse_train_precision, strict_f32


def build_train_loop(cfg, *, synthetic: bool = False,
                     smoke_iters: Optional[int] = None,
                     smoke_verts: Optional[int] = None,
                     device: torch.device | str = "cuda",
                     cfg_file: Optional[str] = None,
                     precision: Optional[str] = None):
    """Models, data and optimizers on `device`; returns (TrainLoop,
    outer batches per epoch). `precision` (the `--precision` flag's value)
    wins over `cfg.TRAIN.PRECISION`."""
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
    from tepose_tpu_torch.parallel.dp import check_divisible
    from tepose_tpu_torch.train.trainer import TrainHyper
    from tepose_tpu_torch.utils.logging import prepare_output_dir
    from tepose_tpu_torch.weights import (
        load_checkpoint, state_dict_from_jax_tree)

    compute_dtype = (parse_train_precision(precision) if precision is not None
                     else parse_train_precision(cfg.TRAIN.PRECISION or
                                                "float32", "TRAIN.PRECISION"))
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
        raise FileNotFoundError(f"{smpl_npz} missing — convert it with python "
                                "-m tepose_tpu_torch.convert_smpl")

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

    n_2d = int(cfg.TRAIN.BATCH_SIZE * cfg.TRAIN.DATA_2D_RATIO)
    hp = TrainHyper(
        seqlen=cfg.DATASET.SEQLEN, n_2d=n_2d,
        n_3d=cfg.TRAIN.BATCH_SIZE - n_2d,
        update_theta_rate=cfg.TRAIN.UPDATE_THETA_RATE,
        disc_update_steps=cfg.TRAIN.MOT_DISCR.UPDATE_STEPS,
        num_gcn_scales=gcn.num_gcn_scales, num_g3d_scales=gcn.num_g3d_scales,
        compute_dtype=compute_dtype)
    # each process loads its rows of every training batch
    check_divisible(hp, distributed.process_count())
    shard_kw = dict(num_shards=distributed.process_count(),
                    shard_index=distributed.process_index())
    loaders = (synthetic_loaders(cfg, **shard_kw) if synthetic
               else get_data_loaders(cfg, **shard_kw))
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


def run_train(cfg, profile: Optional[str] = None, **kw):
    """Train `cfg.TRAIN.START_EPOCH`..`END_EPOCH` (see `build_train_loop`
    for the options), under a `torch.profiler` trace written into
    `profile` when it is given; returns the finished `TrainLoop`."""
    from tepose_tpu_torch.utils.profiling import trace

    loop, num_outer = build_train_loop(cfg, **kw)
    try:
        with (trace(profile, kw.get("device", "cuda")) if profile
              else contextlib.nullcontext()):
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(n: int, argv: list) -> int:
    """Run this CLI as n ranks on this host (`argv` without --devices),
    joined through the TEPOSE_* environment; a rank that fails stops the
    others. Returns the first non-zero exit code, or 0."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ)
        env.update({distributed.ENV_COORDINATOR: f"localhost:{port}",
                    distributed.ENV_NUM_PROCESSES: str(n),
                    distributed.ENV_PROCESS_ID: str(rank)})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tepose_tpu_torch.train"] + argv,
            env=env))
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                return failed[0] if failed else 0
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            p.wait()


def join_process_group(device: str) -> str:
    """Join the process group the TEPOSE_* environment names (NCCL on
    CUDA, gloo on the CPU); returns this rank's device: cuda:(rank mod the
    visible count) on CUDA."""
    if not os.environ.get(distributed.ENV_COORDINATOR):
        return device
    if device == "cpu":
        distributed.maybe_initialize(backend="gloo")
        return device
    rank = int(os.environ[distributed.ENV_PROCESS_ID])
    device = f"cuda:{rank % max(torch.cuda.device_count(), 1)}"
    torch.cuda.set_device(device)
    distributed.maybe_initialize(backend="nccl")
    return device


def rank_count(devices: str, device: str) -> int:
    """The number of ranks `--devices` asks for; more CUDA devices than
    are visible exit, naming the count."""
    visible = torch.cuda.device_count()
    if devices == "auto":
        return 1 if device == "cpu" else visible
    try:
        n = int(devices)
    except ValueError:
        raise SystemExit(f"--devices expects an integer or 'auto', "
                         f"got {devices!r}")
    if device != "cpu" and n > visible:
        raise SystemExit(f"--devices {n} requested but only {visible} CUDA "
                         f"devices are visible")
    return n


def main():
    from tepose_tpu_torch.config import gpu_device, parse_args

    argv = sys.argv[1:]
    profile = _take("--profile")
    devices = _take("--devices")
    if devices is not None:
        i = argv.index("--devices")
        argv = argv[:i] + argv[i + 2:]
    synthetic = "--synthetic" in sys.argv
    if synthetic:
        sys.argv.remove("--synthetic")
    smoke_iters = _take("--smoke-iters", int)
    smoke_verts = _take("--smoke-verts", int)
    precision = None
    if "--precision" in sys.argv:
        if sys.argv.index("--precision") + 1 >= len(sys.argv):
            raise SystemExit("--precision needs a value (bf16 or float32)")
        precision = _take("--precision")
        parse_train_precision(precision)
    cfg, cfg_file, args = parse_args()
    device = gpu_device(args.gpu)
    if devices is not None and not os.environ.get(
            distributed.ENV_COORDINATOR):
        n = rank_count(devices, device)
        if n > 1:
            rc = launch_ranks(n, argv)
            if rc:
                raise SystemExit(rc)
            return None
    device = join_process_group(device)
    try:
        return run_train(cfg, profile=profile, synthetic=synthetic,
                         smoke_iters=smoke_iters, smoke_verts=smoke_verts,
                         device=device, cfg_file=cfg_file,
                         precision=precision)
    finally:
        distributed.shutdown()
