"""Pose error metrics with the reference's conventions, on the host.

Port of `tepose_tpu/eval/metrics.py` (`align_pelvis`, `mpjpe`, `pa_mpjpe`,
`vertex_error`, `host_joint_errors`, `accel_error_eval`, and copies of the numpy
`accel_magnitude_masked` / `accel_error_masked` that trainer validation
uses, and of `plot_accel`, the `--plot` figure, with matplotlib imported
inside it). Distances are in the input unit
(metres for SMPL); callers multiply by 1000 for millimetres.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tepose_tpu_torch.ops.procrustes import batch_similarity_transform


def align_pelvis(joints: torch.Tensor, left: int = 2,
                 right: int = 3) -> torch.Tensor:
    """Subtract the mid-hip from every joint. joints (..., K, 3)."""
    pelvis = (joints[..., left, :] + joints[..., right, :]) / 2.0
    return joints - pelvis[..., None, :]


def mpjpe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-frame mean-per-joint position error. (N, K, 3) -> (N,)."""
    return torch.sqrt(((pred - target) ** 2).sum(-1)).mean(-1)


def pa_mpjpe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Procrustes-aligned MPJPE. (N, K, 3) -> (N,)."""
    aligned = batch_similarity_transform(pred, target)
    return torch.sqrt(((aligned - target) ** 2).sum(-1)).mean(-1)


def vertex_error(pred_verts: torch.Tensor,
                 target_verts: torch.Tensor) -> torch.Tensor:
    """MPVPE over the mesh surface. (N, V, 3) -> (N,)."""
    return torch.sqrt(((pred_verts - target_verts) ** 2).sum(-1)).mean(-1)


def host_joint_errors(pred: np.ndarray, target: np.ndarray):
    """(mpjpe, pa_mpjpe) per frame as numpy, computed on the host CPU."""
    p = torch.from_numpy(np.ascontiguousarray(pred))
    t = torch.from_numpy(np.ascontiguousarray(target))
    return mpjpe(p, t).numpy(), pa_mpjpe(p, t).numpy()


def accel_error_eval(pred: np.ndarray, target: np.ndarray,
                     vis: Optional[np.ndarray] = None) -> np.ndarray:
    """Flat per-frame acceleration error || d2 pred - d2 target ||.

    (N, K, 3) -> (N-2,).
    """
    accel_gt = target[:-2] - 2 * target[1:-1] + target[2:]
    accel_pred = pred[:-2] - 2 * pred[1:-1] + pred[2:]
    normed = np.linalg.norm(accel_pred - accel_gt, axis=2)
    if vis is not None:
        invis = ~vis
        new_invis = invis | np.roll(invis, -1) | np.roll(invis, -2)
        normed = normed[~new_invis[:-2]]
    return normed.mean(axis=1)


def accel_magnitude_masked(joints: np.ndarray, vidlen_each: np.ndarray,
                           seqlen: int) -> float:
    """Mean accel magnitude over the valid region of padded videos.

    joints (B, T, K, 3) padded to T frames; vidlen_each (B,) true lengths.
    Sums ||d2||-per-frame over frames [seqlen-1, vidlen-2) of each video and
    divides by sum(vidlen) - B*(seqlen+1). ref: eval_utils.py:53-70.
    """
    vel = joints[:, 1:] - joints[:, :-1]
    acc = vel[:, 1:] - vel[:, :-1]
    normed = np.mean(np.linalg.norm(acc, axis=3), axis=2)  # (B, T-2)
    total = 0.0
    for i in range(normed.shape[0]):
        total += np.sum(normed[i, seqlen - 1:int(vidlen_each[i]) - 2])
    denom = np.sum(vidlen_each) - vidlen_each.shape[0] * (seqlen + 1) + 1e-8
    return float(total / denom)


def accel_error_masked(pred: np.ndarray, target: np.ndarray,
                       vidlen_each: np.ndarray, seqlen: int) -> float:
    """Mean accel error over the valid region of padded videos.

    Same normalisation quirks as the reference: frames
    [seqlen-1, vidlen-4), denominator sum(vidlen) - B*(seqlen+3).
    ref: eval_utils.py:73-107.
    """
    accel_gt = target[:, :-2] - 2 * target[:, 1:-1] + target[:, 2:]
    accel_pred = pred[:, :-2] - 2 * pred[:, 1:-1] + pred[:, 2:]
    normed = np.mean(np.linalg.norm(accel_pred - accel_gt, axis=3), axis=2)
    total = 0.0
    for i in range(normed.shape[0]):
        total += np.sum(normed[i, seqlen - 1:int(vidlen_each[i]) - 4])
    denom = np.sum(vidlen_each) - vidlen_each.shape[0] * (seqlen + 3) + 1e-8
    return float(total / denom)


def plot_accel(joints_pred: np.ndarray, joints_gt: np.ndarray, out_dir: str,
               name: str = "") -> str:
    """Save an acceleration-error-over-time plot (the --plot flag).

    ref: eval_utils.py:10-50 (plot_accel). joints (T, K, 3); returns the
    saved figure path.
    """
    import os

    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    accel_err = accel_error_eval(np.asarray(joints_pred),
                                 np.asarray(joints_gt)) * 1000.0
    t = np.arange(len(accel_err))
    plt.figure(figsize=(15, 8))
    plt.plot(t, accel_err, label="TePose (ours)", color="#FF7F0E")
    plt.xlabel("time step", fontsize=10)
    plt.ylabel("acceleration error ($mm/s^2$)", fontsize=10)
    plt.tick_params(axis="x", which="both", bottom=False, top=False,
                    labelbottom=False)
    plt.xlim(-10, len(accel_err) + 10)
    plt.ylim(bottom=-3)
    plot_dir = os.path.join(out_dir, "plot")
    os.makedirs(plot_dir, exist_ok=True)
    path = os.path.join(plot_dir, f"tepose_accel_pred_error_{name}.png")
    plt.savefig(path, bbox_inches="tight")
    plt.close()
    np.save(os.path.join(plot_dir, f"tepose_accel_pred_{name}.npy"),
            accel_err)
    return path
