"""Epoch-level training orchestration: segments, validation, LR plateaus,
checkpoints, NaN rollback.

Port of `tepose_tpu/train/fit.py::TrainLoop`. Per epoch: the outer loop
over (2D batch, 3D batch) pairs runs one `train.trainer.train_segment` of
`num_iters_per_epoch` windows each, then validation, `ReduceLROnPlateau` on
PA-MPJPE for both optimizers, and a checkpoint (+ best copy). The
parameters live on the device as the modules' own; the JAX loop's
FlatPacker carry and AOT compile have no counterpart. With `cfg.DEBUG`,
every `DEBUG_FREQ`-th segment writes a prediction-overlay mp4 of its 3D
batch (`_debug_visualize`, cv2 and `utils/vis.py`), as the JAX loop does.

In a multi-process run (`parallel/distributed.py`) each process trains on
its rows through `parallel.dp.sharded_train_segment`, from rank 0's
weights; the loaders hand it its rows and `_amass_windows` keeps its
`batch_size/P` AMASS rows. The primary alone writes checkpoints,
`best.txt` and debug renders, and a barrier follows every checkpoint, so a
NaNGuard rollback on any process never reads a half-written file. Every
process validates every video and takes the primary's metrics, so
`best_performance` and the plateau schedulers agree everywhere.
"""

from __future__ import annotations

import os.path as osp
import time
from typing import Dict, Optional

import numpy as np
import torch

from tepose_tpu_torch.parallel import distributed
from tepose_tpu_torch.parallel.dp import (
    replicate_from_primary, sharded_train_segment)
from tepose_tpu_torch.train import checkpoint as ckpt
from tepose_tpu_torch.train.optim import ReduceLROnPlateau, get_lr, set_lr
from tepose_tpu_torch.train.trainer import train_segment
from tepose_tpu_torch.train.validate import validate_epoch
from tepose_tpu_torch.utils.logging import (
    AverageMeter, MetricWriter, create_logger)
from tepose_tpu_torch.utils.profiling import NaNGuard


class TrainLoop:
    """Host orchestration around the device-resident modules.

    `segment_seconds` records each segment's host-clock time, ending in its
    metrics readback (which waits for the device)."""

    def __init__(self, *, cfg, gen, disc, smpl, hp, gen_opt, disc_opt,
                 weights, loaders, j_regressor: np.ndarray, logdir: str,
                 num_iters_per_epoch: int, seed: int = 0, faces=None):
        self.cfg = cfg
        self.gen, self.disc, self.smpl = gen, disc, smpl
        self.hp = hp
        self.gen_opt, self.disc_opt = gen_opt, disc_opt
        self.weights = weights
        self.train_2d, self.train_3d, self.disc_loader, self.valid = loaders
        self.j_regressor = j_regressor
        self.logdir = logdir
        self.faces = faces
        self.num_iters = num_iters_per_epoch
        self.max_valid_batches: Optional[int] = None   # None: every batch
        self.writer = MetricWriter(logdir)
        self.logger = create_logger(logdir)

        self.gen_sched = ReduceLROnPlateau(patience=cfg.TRAIN.LR_PATIENCE)
        self.disc_sched = ReduceLROnPlateau(patience=cfg.TRAIN.LR_PATIENCE)
        self.nan_guard = NaNGuard(patience=3)
        self.best_performance = float("inf")
        self.start_epoch = cfg.TRAIN.START_EPOCH
        self.generator = torch.Generator(
            device=smpl.v_template.device).manual_seed(max(seed, 0))
        self.global_step = 0
        self.segment_seconds = []
        self.segment = train_segment
        if distributed.process_count() > 1:
            replicate_from_primary(gen, disc)
            self.segment = sharded_train_segment

        if cfg.TRAIN.RESUME:
            self.resume(cfg.TRAIN.RESUME)

    # ---------------------------------------------------------------- epoch

    def _amass_windows(self, disc_iter, num_iters: int,
                       batch_size: int) -> np.ndarray:
        """(num_iters, B, S, 85) real-motion windows for a segment, one
        AMASS batch per window. Multi-process: the disc loader is sharded,
        so this process keeps its `batch_size/P` rows."""
        local = batch_size // distributed.process_count()
        out = np.zeros((num_iters, local, self.hp.seqlen, 85), np.float32)
        for i in range(num_iters):
            out[i] = next(disc_iter)["theta"][:local]
        return out

    def train_epoch(self, epoch: int, num_outer: int) -> Dict[str, float]:
        it2d, it3d = iter(self.train_2d), iter(self.train_3d)
        itd = iter(self.disc_loader)
        losses = AverageMeter()
        t0 = time.time()
        metrics: Dict[str, float] = {}
        for i in range(num_outer):
            b2, b3 = next(it2d), next(it3d)
            amass = self._amass_windows(itd, self.num_iters,
                                        self.hp.n_2d + self.hp.n_3d)
            ts = time.perf_counter()
            metrics = self.segment(
                self.gen, self.disc, self.smpl, self.gen_opt, self.disc_opt,
                self.hp, self.weights, b2, b3, amass, self.generator)
            self.segment_seconds.append(time.perf_counter() - ts)
            if np.isfinite(metrics["gen_loss"]):
                # a single NaN segment would poison the meter for the rest
                # of the epoch even after a successful rollback
                losses.update(metrics["gen_loss"])
            self.writer.add_scalars(metrics, self.global_step,
                                    prefix="train_loss/")
            if self.cfg.DEBUG and \
                    self.global_step % max(self.cfg.DEBUG_FREQ, 1) == 0:
                self._debug_visualize(b3, epoch)
            self.global_step += 1
            if not self.nan_guard.check(float(metrics["gen_loss"]),
                                        self.global_step):
                self.logger.info(
                    f"NaNGuard: {self.nan_guard.consecutive} consecutive "
                    f"non-finite segments ({metrics}) — rolling back")
                self._rollback()
            elif not np.isfinite(metrics["gen_loss"]):
                self.logger.info(f"NaN loss at segment {i}: {metrics}")
        self.logger.info(
            f"Epoch {epoch + 1} train: loss {losses.avg:.2f} "
            f"({time.time() - t0:.1f}s, {num_outer} segments x "
            f"{self.num_iters} windows)")
        return metrics

    def _debug_visualize(self, batch_3d, epoch: int) -> None:
        """Prediction-mesh debug grid for the current 3D batch: run the
        current generator over the batch's first windows and overlay the
        predicted skeleton and mesh with the GT skeleton (ref: trainer.py:
        272-279 -> vis.py:330-382; without image crops in the feature-based
        batches, overlays draw on blank canvases). Writes
        debug_epochEEE_stepSSSSSS.mp4 under the log directory (the
        primary's file)."""
        if not distributed.is_primary():
            return
        try:
            import cv2

            from tepose_tpu_torch.utils.vis import batch_visualize_vid_preds

            S = self.hp.seqlen
            dev = self.smpl.v_template.device
            n = min(4, int(np.asarray(batch_3d["features"]).shape[0]))
            feats = np.asarray(batch_3d["features"], np.float32)[:n]
            pseu = np.asarray(batch_3d["theta_pseu"], np.float32)[:n]
            kp2d_gt = np.asarray(batch_3d["kp_2d"])[:n]
            W = min(8, feats.shape[1] - S + 1)

            preds = {"theta": [], "kp_2d": [], "verts": []}
            with torch.no_grad():
                for j in range(W):  # pseudo-theta feedback: debug only
                    fb = np.concatenate(
                        [pseu[:, j:j + S - 1],
                         np.zeros((n, 1, 85), np.float32)], axis=1)
                    x = np.concatenate([feats[:, j:j + S], fb], axis=-1)
                    out = self.gen(torch.from_numpy(x).to(dev), self.smpl)
                    for k in preds:
                        preds[k].append(out[k].cpu().numpy())
            preds = {k: np.stack(v, axis=1) for k, v in preds.items()}

            video = np.zeros((n, W, 224, 224, 3), np.uint8)
            target = {"kp_2d": kp2d_gt[:, S - 1:S - 1 + W]}
            grid = batch_visualize_vid_preds(video, preds, target,
                                             self.faces, max_items=n)

            path = osp.join(self.logdir,
                            f"debug_epoch{epoch:03d}_"
                            f"step{self.global_step:06d}.mp4")
            h, w = grid.shape[1:3]
            wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5,
                                 (w, h))
            for f in grid:
                wr.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            wr.release()
        except Exception:  # visualization must never kill training
            self.logger.exception("debug visualization failed")

    def _rollback(self) -> None:
        """Restore the last saved checkpoint after persistent non-finite
        losses; raise if none exists yet."""
        path = osp.join(self.logdir, "checkpoint.npz")
        if not osp.isfile(path):
            raise RuntimeError(
                "NaNGuard: losses stayed non-finite for "
                f"{self.nan_guard.consecutive} segments and no checkpoint "
                "exists to roll back to — halting")
        trees, _ = ckpt.load_checkpoint(path)
        ckpt.load_training_trees(trees, self.gen, self.disc, self.gen_opt,
                                 self.disc_opt)
        self.nan_guard = NaNGuard(self.nan_guard.patience)
        self.logger.info(f"NaNGuard: restored parameters from '{path}'")

    def validate(self) -> Dict[str, float]:
        """Every video on this process's device; the primary's metrics on
        every process."""
        return distributed.broadcast_object(validate_epoch(
            self.gen, self.smpl, self.valid, self.j_regressor,
            self.hp.seqlen,
            max_batches=self.max_valid_batches or len(self.valid)))

    # ---------------------------------------------------------------- fit

    def fit(self, end_epoch: int, num_outer: int) -> None:
        for epoch in range(self.start_epoch, end_epoch):
            self.train_epoch(epoch, num_outer)
            perf_dict = self.validate()
            performance = perf_dict["pa-mpjpe"]
            self.writer.add_scalars(perf_dict, epoch, prefix="error/")
            self.logger.info(
                "Epoch %d eval: %s", epoch + 1,
                " ".join(f"{k.upper()}: {v:.4f}," for k, v in
                         perf_dict.items()))
            lr = self.gen_sched.step(performance, get_lr(self.gen_opt))
            dlr = self.disc_sched.step(performance, get_lr(self.disc_opt))
            set_lr(self.gen_opt, lr)
            set_lr(self.disc_opt, dlr)
            self.writer.add_scalar("lr/gen_lr", lr, epoch)
            self.writer.add_scalar("lr/dis_lr", dlr, epoch)
            self.save(epoch, performance)
        self.writer.close()

    # ---------------------------------------------------------------- ckpt

    def save(self, epoch: int, performance: float) -> None:
        path = osp.join(self.logdir, "checkpoint.npz")
        is_best = performance < self.best_performance
        if is_best:
            self.best_performance = performance
        if distributed.is_primary():
            ckpt.save_checkpoint(
                path, ckpt.training_trees(self.gen, self.disc, self.gen_opt,
                                          self.disc_opt),
                {"epoch": epoch, "performance": self.best_performance,
                 "gen_sched": self.gen_sched.state_dict(),
                 "disc_sched": self.disc_sched.state_dict()})
            if is_best:
                self.logger.info("Best performance achieved, saving it!")
                ckpt.mark_best(self.logdir)
                with open(osp.join(self.logdir, "best.txt"), "w") as f:
                    f.write(str(float(performance)))
        # readers (NaNGuard rollback on any process) must never see a
        # half-written checkpoint
        distributed.barrier("checkpoint_saved")

    def resume(self, path: str) -> None:
        if not osp.isfile(path):
            self.logger.info(f"=> no checkpoint found at '{path}'")
            return
        trees, scalars = ckpt.load_checkpoint(path)
        ckpt.load_training_trees(trees, self.gen, self.disc, self.gen_opt,
                                 self.disc_opt)
        self.start_epoch = int(scalars.get("epoch", -1)) + 1
        self.best_performance = float(scalars.get("performance",
                                                  float("inf")))
        if "gen_sched" in scalars:
            self.gen_sched.load_state_dict(scalars["gen_sched"])
            self.disc_sched.load_state_dict(scalars["disc_sched"])
        self.logger.info(
            f"=> loaded checkpoint '{path}' (epoch {self.start_epoch}, "
            f"performance {self.best_performance})")
