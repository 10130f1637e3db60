"""Iterative-error-feedback SMPL regressor + weak-perspective projection,
eval mode.

Port of `tepose_tpu/models/regressor.py` (`regressor_init`,
`ief_iterations`, `projection`, `regressor_apply` with the J14 path).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tepose_tpu_torch.models.layers import make_linear
from tepose_tpu_torch.models.smpl import (
    H36M_TO_J14, SmplModel, regress_h36m_joints, smpl_forward)
from tepose_tpu_torch.ops.geometry import rot6d_to_rotmat, rotmat_to_angle_axis

NPOSE = 24 * 6  # 144
FEAT_DIM = 2048
THETA_DIM = 85  # cam 3 + pose 72 + shape 10
N_ITER = 3


def projection(pred_joints: torch.Tensor, pred_camera: torch.Tensor,
               img_size: float = 224.0) -> torch.Tensor:
    """Weak-perspective camera (s, tx, ty) -> normalised 2D keypoints.

    Depth is 2 * 5000 / (224 s + 1e-9); the pinhole projection has an
    identity rotation, zero centre and focal length 5000.
    """
    cam_t = torch.stack(
        [pred_camera[:, 1], pred_camera[:, 2],
         2.0 * 5000.0 / (img_size * pred_camera[:, 0] + 1e-9)], dim=-1)
    p = pred_joints + cam_t[:, None, :]
    kp2d = 5000.0 * (p[..., :2] / p[..., 2:3])
    return kp2d / (img_size / 2.0)


class Regressor(nn.Module):
    """fc1 -> fc2 -> (decpose, decshape, deccam), three IEF steps.

    The initial estimate (buffers, overwritten by a loaded checkpoint) is
    the identity rotation in 6d for all 24 joints — [1,0,0,1,0,0], since
    the 6-vector reads as a C-order (3, 2) matrix — zero shape and cam
    [0.9, 0, 0].
    """

    def __init__(self, *, generator: torch.Generator,
                 device: torch.device | str):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.fc1 = make_linear(FEAT_DIM + NPOSE + 13, 1024, **kw)
        self.fc2 = make_linear(1024, 1024, **kw)
        self.decpose = make_linear(1024, NPOSE, w_scale=0.01, **kw)
        self.decshape = make_linear(1024, 10, w_scale=0.01, **kw)
        self.deccam = make_linear(1024, 3, w_scale=0.01, **kw)

        def row(v):
            return torch.tensor([v], dtype=torch.float32, device=device)

        self.register_buffer("init_pose", row([1.0, 0.0, 0.0, 1.0, 0.0, 0.0]
                                              * 24))
        self.register_buffer("init_shape", row([0.0] * 10))
        self.register_buffer("init_cam", row([0.9, 0.0, 0.0]))

    def ief_iterations(self, x: torch.Tensor):
        """Returns (pose6d (B, 144), shape (B, 10), cam (B, 3))."""
        B = x.shape[0]
        pred_pose = self.init_pose.expand(B, NPOSE)
        pred_shape = self.init_shape.expand(B, 10)
        pred_cam = self.init_cam.expand(B, 3)
        for _ in range(N_ITER):
            xc = torch.cat([x, pred_pose, pred_shape, pred_cam], dim=1)
            xc = self.fc2(self.fc1(xc))
            pred_pose = self.decpose(xc) + pred_pose
            pred_shape = self.decshape(xc) + pred_shape
            pred_cam = self.deccam(xc) + pred_cam
        return pred_pose, pred_shape, pred_cam

    def forward(self, x: torch.Tensor, smpl: SmplModel, *,
                j_regressor: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """x (B, 2048) -> theta (B, 85) = [cam, pose aa, shape], verts
        (B, V, 3), kp_2d (B, K, 2), kp_3d (B, K, 3) and rotmat
        (B, 24, 3, 3); K = 49, or 14 through `j_regressor` (H36M J14)."""
        B = x.shape[0]
        pred_pose, pred_shape, pred_cam = self.ief_iterations(x)
        pred_rotmat = rot6d_to_rotmat(pred_pose.reshape(-1, 6)).reshape(
            B, 24, 3, 3)

        smpl_out = smpl_forward(smpl, pred_shape, pred_rotmat)
        pred_vertices = smpl_out["verts"]
        pred_joints = smpl_out["joints49"]
        if j_regressor is not None:
            pred_joints = regress_h36m_joints(pred_vertices, j_regressor,
                                              subset=H36M_TO_J14)

        pose_aa = rotmat_to_angle_axis(pred_rotmat.reshape(-1, 3, 3)).reshape(
            B, 72)
        return {
            "theta": torch.cat([pred_cam, pose_aa, pred_shape], dim=1),
            "verts": pred_vertices,
            "kp_2d": projection(pred_joints, pred_cam),
            "kp_3d": pred_joints,
            "rotmat": pred_rotmat,
        }
