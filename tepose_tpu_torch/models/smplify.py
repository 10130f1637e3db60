"""Temporal SMPLify: gradient-based refinement of SMPL fits to 2D keypoints.

Port of `tepose_tpu/models/smplify.py` (`SmplifyConfig`, `smplify_refine`).
Adam (`train.optim`'s, with optax's `adam` semantics) runs over the 6d
pose, betas and camera of every frame of a tracklet at once, on the
objective of the JAX module, term by term:

  conf-weighted 2D reprojection (`models.regressor.projection`)
  + shape prior ||betas||^2
  + temporal smoothness of consecutive frames' 6d pose and camera
  + elbow/knee bending-direction angle prior (through
    `ops.geometry.rotmat_to_angle_axis`)

The objective reads only the 49 joints, so it takes them from
`models.smpl.smpl_joints_reduced`, which builds no mesh: neither its
forward nor its backward skins (the skinning kernel is forward only). Only
the final `smpl_forward`, on the refined parameters, skins through it. The
JAX module's `lax.fori_loop` is a Python loop of `num_iters` steps here;
the per-iteration losses stay on the device until the caller reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from tepose_tpu_torch.models.regressor import projection
from tepose_tpu_torch.models.smpl import (
    SmplModel, smpl_forward, smpl_joints_reduced)
from tepose_tpu_torch.ops.geometry import (
    rot6d_to_rotmat, rotmat_to_angle_axis, rotmat_to_rot6d)
from tepose_tpu_torch.train.optim import make_optimizer, take_step


@dataclasses.dataclass(frozen=True)
class SmplifyConfig:
    num_iters: int = 60
    lr: float = 0.02
    kp_weight: float = 1.0
    shape_prior_weight: float = 1e-3
    smooth_pose_weight: float = 1.0
    smooth_cam_weight: float = 0.1
    angle_prior_weight: float = 1e-2


# SMPL joints whose bending direction is anatomically constrained
# (left/right knee, left/right elbow) and the sign of the natural bend.
_ANGLE_PRIOR_JOINTS = (4, 5, 18, 19)
_ANGLE_PRIOR_SIGNS = (1.0, -1.0, -1.0, 1.0)


def _angle_prior(pose_aa: torch.Tensor) -> torch.Tensor:
    """Penalise unnatural knee/elbow hyper-extension (SMPLify-style)."""
    terms = []
    for j, s in zip(_ANGLE_PRIOR_JOINTS, _ANGLE_PRIOR_SIGNS):
        # knees bend about x, elbows about y; use the dominant axis component
        axis = 0 if j in (4, 5) else 1
        terms.append(torch.exp(pose_aa[:, j, axis] * s) ** 2)
    return torch.stack(terms, dim=1).sum(-1)


class SmplifyParams(nn.Module):
    """The optimised leaves, named as the JAX module's params dict."""

    def __init__(self, pose6d: torch.Tensor, betas: torch.Tensor,
                 cam: torch.Tensor):
        super().__init__()
        self.pose6d = nn.Parameter(pose6d.detach().clone())   # (T, 24, 6)
        self.betas = nn.Parameter(betas.detach().clone())     # (T, 10)
        self.cam = nn.Parameter(cam.detach().clone())         # (T, 3)


def smplify_objective(smpl: SmplModel, p: SmplifyParams, kp_2d: torch.Tensor,
                      cfg: SmplifyConfig = SmplifyConfig()) -> torch.Tensor:
    """The scalar objective at `p` against kp_2d (T, 49, 3): normalised
    [-1, 1] keypoints and their confidence."""
    T = p.pose6d.shape[0]
    rotmat = rot6d_to_rotmat(p.pose6d.reshape(-1, 6)).reshape(T, 24, 3, 3)
    joints49 = smpl_joints_reduced(smpl, p.betas, rotmat)
    pred2d = projection(joints49, p.cam)
    conf, target = kp_2d[..., 2:], kp_2d[..., :2]
    reproj = (conf * (pred2d - target) ** 2).sum((1, 2))

    pose_aa = rotmat_to_angle_axis(rotmat.reshape(-1, 3, 3)).reshape(T, 24, 3)
    shape_prior = (p.betas ** 2).sum(-1)
    zero = p.cam.new_zeros(1)
    smooth_pose = torch.cat(
        [zero, ((p.pose6d[1:] - p.pose6d[:-1]) ** 2).sum((1, 2))])
    smooth_cam = torch.cat([zero, ((p.cam[1:] - p.cam[:-1]) ** 2).sum(-1)])
    angle = _angle_prior(pose_aa)

    total = (cfg.kp_weight * reproj
             + cfg.shape_prior_weight * shape_prior
             + cfg.smooth_pose_weight * smooth_pose
             + cfg.smooth_cam_weight * smooth_cam
             + cfg.angle_prior_weight * angle)
    return total.sum()


def smplify_refine(
    smpl: SmplModel,
    init_rotmat: torch.Tensor,     # (T, 24, 3, 3)
    init_betas: torch.Tensor,      # (T, 10)
    init_cam: torch.Tensor,        # (T, 3)
    kp_2d: torch.Tensor,           # (T, 49, 3) normalised [-1,1] + confidence
    cfg: SmplifyConfig = SmplifyConfig(),
) -> Dict[str, torch.Tensor]:
    """Refine a tracklet's SMPL fits against its 2D keypoints.

    Returns {"theta", "verts", "kp_3d", "kp_2d", "rotmat", "losses"} as
    tensors on the inputs' device, with the conventions of the regressor
    output; `losses` is the per-iteration objective trace. Runs with
    autograd on whatever the caller's grad mode (inputs made under
    `torch.inference_mode` are copied out of it).
    """
    with torch.inference_mode(False), torch.enable_grad():
        kp_2d = kp_2d.clone()
        p = SmplifyParams(rotmat_to_rot6d(init_rotmat.clone()),
                          init_betas.clone(), init_cam.clone())
        opt = make_optimizer("adam", p, cfg.lr)
        losses = kp_2d.new_zeros(cfg.num_iters)
        for i in range(cfg.num_iters):
            opt.zero_grad()
            loss = smplify_objective(smpl, p, kp_2d, cfg)
            loss.backward()
            take_step(opt)
            losses[i] = loss.detach()

    with torch.no_grad():
        T = p.pose6d.shape[0]
        rotmat = rot6d_to_rotmat(p.pose6d.reshape(-1, 6)).reshape(
            T, 24, 3, 3)
        out = smpl_forward(smpl, p.betas.detach(), rotmat)
        pose_aa = rotmat_to_angle_axis(rotmat.reshape(-1, 3, 3)).reshape(
            T, 72)
        cam = p.cam.detach()
        return {
            "theta": torch.cat([cam, pose_aa, p.betas.detach()], dim=1),
            "verts": out["verts"],
            "kp_3d": out["joints49"],
            "kp_2d": projection(out["joints49"], cam),
            "rotmat": rotmat,
            "losses": losses,
        }
