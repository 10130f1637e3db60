"""Rotation-representation conversions in torch.

Port of `tepose_tpu/ops/geometry.py`, quirk for quirk, because the eval
rollout feeds its own predictions back and amplifies any difference:

  * `batch_rodrigues` takes the angle as ||v + 1e-8|| (the epsilon is added
    to the vector, not the norm);
  * `rotmat_to_quat` keeps the reference's 4-branch mask logic;
  * `rotmat_to_angle_axis` zeroes NaNs in its output;
  * `_normalize` clamps the sum of squares before the sqrt.

All functions are batch-first and broadcast over leading axes.
"""

from __future__ import annotations

import torch


def _safe_div(num: torch.Tensor, den: torch.Tensor,
              eps_mask: torch.Tensor) -> torch.Tensor:
    """num / den, with den replaced by 1 where `eps_mask` is True."""
    return num / torch.where(eps_mask, torch.ones_like(den), den)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) (..., 4) -> rotation matrix (..., 3, 3)."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]

    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z

    rot = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return rot.reshape(quat.shape[:-1] + (3, 3))


def batch_rodrigues(axisang: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3) via quaternions."""
    angle = torch.linalg.norm(axisang + 1e-8, dim=-1, keepdim=True)
    normalized = axisang / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * normalized], dim=-1)
    return quat_to_rotmat(quat)


def rotmat_to_quat(rotmat: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) (w, x, y, z)."""
    m = rotmat.transpose(-1, -2)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    mask_d2 = m22 < eps
    mask_d0_d1 = m00 > m11
    mask_d0_nd1 = m00 < -m11

    t0 = 1 + m00 - m11 - m22
    q0 = torch.stack([m12 - m21, t0, m01 + m10, m20 + m02], dim=-1)
    t1 = 1 - m00 + m11 - m22
    q1 = torch.stack([m20 - m02, m01 + m10, t1, m12 + m21], dim=-1)
    t2 = 1 - m00 - m11 + m22
    q2 = torch.stack([m01 - m10, m20 + m02, m12 + m21, t2], dim=-1)
    t3 = 1 + m00 + m11 + m22
    q3 = torch.stack([t3, m12 - m21, m20 - m02, m01 - m10], dim=-1)

    mask_c0 = mask_d2 & mask_d0_d1
    mask_c1 = mask_d2 & ~mask_d0_d1
    mask_c2 = ~mask_d2 & mask_d0_nd1

    def pick(a, b, c, d, m0, m1, m2):
        return torch.where(m0, a, torch.where(m1, b, torch.where(m2, c, d)))

    t = pick(t0, t1, t2, t3, mask_c0, mask_c1, mask_c2)
    q = pick(q0, q1, q2, q3,
             mask_c0[..., None], mask_c1[..., None], mask_c2[..., None])
    bad = t <= 0.0
    q = _safe_div(q, torch.sqrt(torch.where(bad, torch.ones_like(t), t))[..., None],
                  bad[..., None])
    return q * 0.5


def quat_to_angle_axis(quaternion: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) (w, x, y, z) -> axis-angle (..., 3)."""
    q1, q2, q3 = quaternion[..., 1], quaternion[..., 2], quaternion[..., 3]
    sin_sq = q1 * q1 + q2 * q2 + q3 * q3
    zero = sin_sq <= 0.0
    sin_theta = torch.sqrt(torch.where(zero, torch.ones_like(sin_sq), sin_sq))
    cos_theta = quaternion[..., 0]
    two_theta = 2.0 * torch.where(
        cos_theta < 0.0,
        torch.atan2(-sin_theta, -cos_theta),
        torch.atan2(sin_theta, cos_theta),
    )
    k = torch.where(zero, 2.0 * torch.ones_like(sin_theta),
                    two_theta / sin_theta)
    return torch.stack([q1 * k, q2 * k, q3 * k], dim=-1)


def rotmat_to_angle_axis(rotmat: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), NaNs zeroed."""
    aa = quat_to_angle_axis(rotmat_to_quat(rotmat))
    return torch.where(torch.isnan(aa), torch.zeros_like(aa), aa)


def _normalize(v: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """v / max(||v||, eps), with the sum of squares clamped before the sqrt."""
    sumsq = torch.sum(v * v, dim=-1, keepdim=True)
    n = torch.sqrt(torch.clamp(sumsq, min=1e-30))
    return v / torch.clamp(n, min=eps)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation (..., 6), read as a C-order (3, 2) matrix -> (..., 3, 3)
    whose columns are the Gram-Schmidt basis (b1, b2, b3)."""
    x = x.reshape(x.shape[:-1] + (3, 2))
    a1 = x[..., 0]
    a2 = x[..., 1]
    b1 = _normalize(a1)
    dot = torch.sum(b1 * a2, dim=-1, keepdim=True)
    b2 = _normalize(a2 - dot * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)
