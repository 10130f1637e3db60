"""Pose error metrics with the reference's conventions, on the host.

Port of `tepose_tpu/eval/metrics.py` (`mpjpe`, `pa_mpjpe`,
`host_joint_errors`, `accel_error_eval`). Distances are in the input unit
(metres for SMPL); callers multiply by 1000 for millimetres.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tepose_tpu_torch.ops.procrustes import batch_similarity_transform


def mpjpe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-frame mean-per-joint position error. (N, K, 3) -> (N,)."""
    return torch.sqrt(((pred - target) ** 2).sum(-1)).mean(-1)


def pa_mpjpe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Procrustes-aligned MPJPE. (N, K, 3) -> (N,)."""
    aligned = batch_similarity_transform(pred, target)
    return torch.sqrt(((aligned - target) ** 2).sum(-1)).mean(-1)


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
