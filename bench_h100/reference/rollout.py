"""The reference's outputs for the paths the cells drive.

TePose feeds each window's theta back into the next window's input. The
reference does not run that chain on its own: it reads the fed-back thetas
from the program's outputs, which it judges anyway, as a served model's
reference reads the served tokens. So every window is computed from the
same inputs the program's window had and is compared on its own, and the
windows run side by side in blocks. The chain's start is checked apart:
the ring of the first window holds the initial thetas (identity camera,
zero pose and shape, or a video's pseudo-thetas), and the first S-1 frames
come from VIBE over the first frames.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bench_h100.reference.model import Reference, rodrigues

Out = Dict[str, torch.Tensor]


def cat_outs(parts: List[Out]) -> Out:
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def regressed(r: Out) -> Out:
    """`Reference.regressor`'s outputs in `compare.gaps`' terms."""
    return {"rot": r["rotmat"],
            "camshape": torch.cat([r["cam"], r["shape"]], dim=1),
            "kp_3d": r["kp_3d"], "verts": r["verts"]}


def judged_from_theta(theta: torch.Tensor, kp_3d: torch.Tensor,
                      verts: Optional[torch.Tensor] = None) -> Out:
    """The program's theta (N, 85) = [cam, axis-angle pose, shape], joints
    and vertices in `compare.gaps`' terms."""
    N = theta.shape[0]
    out = {"rot": rodrigues(theta[:, 3:75].reshape(N, 24, 3)),
           "camshape": torch.cat([theta[:, :3], theta[:, 75:]], dim=1),
           "kp_3d": kp_3d}
    if verts is not None:
        out["verts"] = verts
    return out


def features(ref: Reference, resnet: dict, crops: torch.Tensor,
             block: int = 64) -> torch.Tensor:
    """ResNet-50 features of uint8 crops (N, 3, H, W)."""
    return torch.cat([ref.resnet50(resnet, ref.normalize(crops[i:i + block]))
                      for i in range(0, len(crops), block)])


def vibe_frames(ref: Reference, vibe: dict, smpl: dict, feats: torch.Tensor,
                j_regressor=None, block: int = 512) -> Out:
    """VIBE on sequences feats (B, T, 2048): outputs of every frame, in
    (b, t) order."""
    y = ref.vibe_encoder(vibe, feats).reshape(-1, feats.shape[-1])
    return cat_outs([regressed(ref.regressor(vibe, smpl, y[i:i + block],
                                             j_regressor))
                     for i in range(0, len(y), block)])


def tepose_windows(ref: Reference, tepose: dict, smpl: dict,
                   feats: torch.Tensor, ring: torch.Tensor, j_regressor=None,
                   block: int = 512) -> Out:
    """TePose on windows: feats (N, S, 2048) and the S-1 fed-back thetas
    ring (N, S-1, 85); the window's last slot feeds back zeros."""
    fb = torch.cat([ring, torch.zeros_like(ring[:, :1])], dim=1)
    x = torch.cat([feats, fb], dim=-1)
    return cat_outs([regressed(ref.regressor(
        tepose, smpl, ref.tepose_encoder(tepose, x[i:i + block]),
        j_regressor)) for i in range(0, len(x), block)])


def tracklet(ref: Reference, w: dict, smpl: dict, feats: torch.Tensor,
             ring0: torch.Tensor, theta: torch.Tensor, S: int,
             j_regressor=None) -> Out:
    """One tracklet's frames (T) as the program's offline paths make them:
    VIBE over the first S frames gives frames 0..S-2; window k gives frame
    k+S-1 from frames k..k+S-1 and the thetas fed back, which are ring0
    (S-1, 85) followed by the program's own thetas (T, 85) from frame S-1
    on."""
    T = feats.shape[0]
    boot = vibe_frames(ref, w["vibe"], smpl, feats[None, :S], j_regressor)
    fed = torch.cat([ring0, theta[S - 1:]])
    idx = torch.arange(T - S + 1, device=feats.device)[:, None]
    wins = tepose_windows(ref, w["tepose"], smpl,
                          feats[idx + torch.arange(S, device=feats.device)],
                          fed[idx + torch.arange(S - 1, device=feats.device)],
                          j_regressor)
    return {k: torch.cat([boot[k][:S - 1], wins[k]]) for k in wins}


def vertex_error_mm(verts: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-frame mean vertex distance, mm."""
    return torch.linalg.norm(verts.double() - gt.double(), dim=-1).mean(-1) \
        * 1000.0


def joint_errors_mm(pred: np.ndarray, target: np.ndarray):
    """Per-frame MPJPE and PA-MPJPE (mm) of J14 joints (N, 14, 3), each set
    centred on its hips (joints 2 and 3); PA after the similarity transform
    (scale, rotation, translation) that best maps pred onto target."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    pred = pred - (pred[:, 2:3] + pred[:, 3:4]) / 2.0
    target = target - (target[:, 2:3] + target[:, 3:4]) / 2.0
    mpjpe = np.linalg.norm(pred - target, axis=-1).mean(-1)
    mu1, mu2 = pred.mean(1, keepdims=True), target.mean(1, keepdims=True)
    X1, X2 = pred - mu1, target - mu2
    K = np.einsum("nki,nkj->nij", X1, X2)
    U, _, Vt = np.linalg.svd(K)
    Z = np.tile(np.eye(3), (len(K), 1, 1))
    Z[:, 2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = np.swapaxes(Vt, 1, 2) @ Z @ np.swapaxes(U, 1, 2)
    scale = np.einsum("nii->n", R @ K) / (X1 ** 2).sum((1, 2))
    aligned = scale[:, None, None] * np.einsum("nij,nkj->nki", R, X1) + mu2
    pa = np.linalg.norm(aligned - target, axis=-1).mean(-1)
    return mpjpe * 1000.0, pa * 1000.0
