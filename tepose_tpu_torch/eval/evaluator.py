"""Batched theta-feedback evaluation rollout and host metric aggregation.

`eval_rollout` is the counterpart of
`tepose_tpu/eval/evaluator.py::_eval_fn_body` (what `make_eval_scan` jits):

  1. VIBE bootstrap over each video's first `seqlen` frames gives the
     predictions for frames 0..seqlen-2;
  2. a loop over the window index advances all videos in lockstep, carrying
     each video's (seqlen-1, 85) theta ring buffer, initialised from the
     pseudo-thetas, into the next window's input;
  3. per frame it emits the J14 (or 49) joints, the theta and the MPVPE
     against a GT mesh rebuilt through SMPL from the target theta.

The JAX `lax.scan` becomes a Python loop; every SMPL forward, in the
windows and in the GT rebuild, skins through the CUDA kernel on a CUDA
device. `make_sharded_eval_rollout` is the counterpart of
`make_sharded_eval_scan`: videos split over a `parallel.mesh.Mesh`, one
replica a device, no collectives. `EvalAccumulator` and `spin49_to_eval_format` are numpy copies of
the JAX package's, pinned equal to them by tests/test_torch_eval.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from tepose_tpu_torch.data.kp_utils import convert_kps, perm_idxs
from tepose_tpu_torch.eval import metrics as M
from tepose_tpu_torch.models.smpl import SmplModel, smpl_forward
from tepose_tpu_torch.models.tepose import TePose, Vibe
from tepose_tpu_torch.parallel.mesh import (
    Mesh, gather_rows, replicate, shard_batch)


@torch.inference_mode()
def eval_rollout(gen: TePose, vibe: Vibe, smpl: SmplModel,
                 feats: torch.Tensor, theta_pseu: torch.Tensor,
                 theta_gt: torch.Tensor, j_regressor: Optional[torch.Tensor],
                 num_windows: int,
                 compute_dtype: Optional[torch.dtype] = None
                 ) -> Dict[str, torch.Tensor]:
    """Evaluate videos padded to T frames.

    feats (B, T, 2048), theta_pseu (B, S-1, 85), theta_gt (B, T, 85) and
    j_regressor (17, V) (None for the 49-joint output) on one device.
    Returns pred_j3d (B, T', K, 3), pred_theta (B, T', 85) and mpvpe
    (B, T') for the first T' = num_windows + S - 1 frames.

    With `compute_dtype` (the bfloat16 tier: `gen` and `vibe` hold bf16
    parameters) the window inputs enter the networks in that dtype; SMPL,
    the skinning, the theta feedback and the outputs keep feats' dtype.
    """
    S = gen.cfg.seqlen
    B, T = feats.shape[:2]
    if not 1 <= num_windows <= T - S + 1:
        # slicing past T would silently truncate the last windows
        raise ValueError(
            f"num_windows={num_windows} not in [1, T-S+1={T - S + 1}] "
            f"(T={T}, S={S})")

    def cast(x):
        return x if compute_dtype is None else x.to(compute_dtype)

    vibe_out = vibe(cast(feats[:, :S]), smpl, j_regressor=j_regressor)
    boot_j3d = vibe_out["kp_3d"][:, :S - 1]
    boot_theta = vibe_out["theta"][:, :S - 1].to(feats.dtype)
    boot_verts = vibe_out["verts"][:, :S - 1]

    zero_fb = torch.zeros_like(theta_pseu[:, :1])
    theta_buf = theta_pseu
    j3d, thetas, mpvpe = [], [], []
    for k in range(num_windows):
        fb = torch.cat([theta_buf, zero_fb], dim=1)
        inp = torch.cat([feats[:, k:k + S], fb], dim=-1)
        out = gen(cast(inp), smpl, j_regressor=j_regressor)
        theta = out["theta"].to(feats.dtype)
        theta_buf = torch.cat([theta_buf[:, 1:], theta[:, None]], dim=1)
        th = theta_gt[:, k + S - 1]
        gt = smpl_forward(smpl, th[:, 75:], th[:, 3:75], pose2rot=True)
        j3d.append(out["kp_3d"])
        thetas.append(theta)
        mpvpe.append(M.vertex_error(out["verts"], gt["verts"]))

    # bootstrap MPVPE: one batched GT rebuild over the S-1 frames
    th_boot = theta_gt[:, :S - 1].reshape(B * (S - 1), 85)
    gt_boot = smpl_forward(smpl, th_boot[:, 75:], th_boot[:, 3:75],
                           pose2rot=True)["verts"]
    boot_mpvpe = M.vertex_error(boot_verts,
                               gt_boot.reshape((B, S - 1) + gt_boot.shape[1:]))

    return {
        "pred_j3d": torch.cat([boot_j3d, torch.stack(j3d, dim=1)], dim=1),
        "pred_theta": torch.cat([boot_theta, torch.stack(thetas, dim=1)],
                                dim=1),
        "mpvpe": torch.cat([boot_mpvpe, torch.stack(mpvpe, dim=1)], dim=1),
    }


def make_sharded_eval_rollout(gen: TePose, vibe: Vibe, smpl: SmplModel,
                              j_regressor: Optional[torch.Tensor],
                              mesh: Mesh,
                              compute_dtype: Optional[torch.dtype] = None):
    """Mesh-parallel eval rollout: videos split over the mesh's devices.

    Each video's theta-feedback chain is independent (no BN, no cross-video
    coupling), so every device runs its contiguous block of rows through
    `eval_rollout` on its own replica of the weights and SMPL buffers (each
    replica skins on its own device) with no collectives. Returns
    fn(feats, theta_pseu, theta_gt, num_windows) -> the `eval_rollout`
    outputs on the host, rows in input order; B must divide over the mesh.
    The shards are queued device by device before any is read back.
    `compute_dtype` is `eval_rollout`'s, on every replica."""
    replicas = replicate((gen, vibe, smpl, j_regressor), mesh)

    def fn(feats, theta_pseu, theta_gt, num_windows: int):
        shards = shard_batch((feats, theta_pseu, theta_gt), mesh)
        outs = [eval_rollout(g, v, s, f, p, t, jr, num_windows,
                             compute_dtype)
                for (g, v, s, jr), (f, p, t) in zip(replicas, shards)]
        return {k: gather_rows([o[k] for o in outs]) for k in outs[0]}

    return fn


@dataclasses.dataclass
class EvalAccumulator:
    """Host-side per-video metric aggregation, reference conventions: the
    per-frame values are concatenated across videos and averaged at the
    end."""

    dataset: str = "3dpw"
    mpjpe: list = dataclasses.field(default_factory=list)
    pa_mpjpe: list = dataclasses.field(default_factory=list)
    mpvpe: list = dataclasses.field(default_factory=list)
    accel_err: list = dataclasses.field(default_factory=list)

    def add_video(self, pred_j3d: np.ndarray, target_j3d: np.ndarray,
                  mpvpe: Optional[np.ndarray] = None,
                  valid_map: Optional[np.ndarray] = None) -> None:
        """Add one video's frames. pred/target (T, K, 3) already in the
        evaluation joint format (14-joint common or 17-joint mpii3d_test)."""
        T = pred_j3d.shape[0]
        if valid_map is None:
            valid_map = np.arange(T)

        if self.dataset == "mpii3d":
            pred_pel = pred_j3d[:, [-3]]
            tgt_pel = target_j3d[:, [-3]]
        else:
            pred_pel = (pred_j3d[:, [2]] + pred_j3d[:, [3]]) / 2.0
            tgt_pel = (target_j3d[:, [2]] + target_j3d[:, [3]]) / 2.0
        pred = pred_j3d - pred_pel
        tgt = target_j3d - tgt_pel

        m2mm = 1000.0
        errs, errs_pa = M.host_joint_errors(pred, tgt)
        self.mpjpe.append(errs[valid_map] * m2mm)
        self.pa_mpjpe.append(errs_pa[valid_map] * m2mm)

        if mpvpe is not None:
            # deliberately NOT filtered by valid_map, as in the reference
            self.mpvpe.append(np.asarray(mpvpe) * m2mm)

        # accel error: zero-padded at both ends, boundary frames dropped
        # from valid_map
        accel = np.zeros(T)
        accel[1:-1] = M.accel_error_eval(pred, tgt) * m2mm
        vm = valid_map
        if len(vm) > 1:
            if vm[0] == 0:
                vm = vm[1:]
            if len(vm) and vm[-1] == T - 1:
                vm = vm[:-1]
            self.accel_err.append(accel[vm])

    def summarize(self) -> Dict[str, float]:
        out = {}
        for name in ("mpjpe", "pa_mpjpe", "mpvpe", "accel_err"):
            vals = getattr(self, name)
            if vals:
                out[name] = float(np.mean(np.concatenate(vals)))
        return out


def spin49_to_eval_format(j3d: np.ndarray, dataset: str) -> np.ndarray:
    """Reduce 49-joint spin predictions to the dataset's eval joints."""
    if dataset == "mpii3d":
        return convert_kps(j3d, "spin", "mpii3d_test")
    return j3d[:, np.asarray(perm_idxs("spin", "common"))]
