"""A copy of `tepose_tpu/ops/quaternion.py` (numpy only), pinned equal to
it by tests/test_torch_host.py.

Host-side quaternion utilities for temporal smoothing.

ref: lib/utils/slerp_filter_utils.py (the vendored transformations.py — only
quaternion_from_matrix / quaternion_slerp / quaternion_matrix are used, by
evaluate.py:32-59) and evaluate.py:32-59 (MEVA-style slerp smoothing).

Written fresh from the standard algorithms (Shepperd's method for
matrix->quaternion; classic slerp), numpy-only (smoothing is a cheap host-side
post-process on (T, 24, 3, 3) rotations).
"""

from __future__ import annotations

import numpy as np


def quaternion_from_matrix(matrix: np.ndarray) -> np.ndarray:
    """Rotation matrix (3, 3) or (4, 4) -> unit quaternion (w, x, y, z)."""
    M = np.asarray(matrix, dtype=np.float64)[:3, :3]
    t = np.trace(M)
    if t > 0.0:
        r = np.sqrt(1.0 + t)
        s = 0.5 / r
        return np.array([0.5 * r,
                         (M[2, 1] - M[1, 2]) * s,
                         (M[0, 2] - M[2, 0]) * s,
                         (M[1, 0] - M[0, 1]) * s])
    # pick the largest diagonal element
    i = int(np.argmax(np.diagonal(M)))
    j, k = (i + 1) % 3, (i + 2) % 3
    r = np.sqrt(1.0 + M[i, i] - M[j, j] - M[k, k])
    s = 0.5 / r
    q = np.empty(4)
    q[0] = (M[k, j] - M[j, k]) * s
    q[1 + i] = 0.5 * r
    q[1 + j] = (M[j, i] + M[i, j]) * s
    q[1 + k] = (M[k, i] + M[i, k]) * s
    return q


def quaternion_matrix(quaternion: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> 4x4 homogeneous rotation matrix."""
    q = np.asarray(quaternion, dtype=np.float64)
    n = q @ q
    out = np.identity(4)
    if n < 1e-12:
        return out
    q = q * np.sqrt(2.0 / n)
    qq = np.outer(q, q)
    out[:3, :3] = np.array([
        [1.0 - qq[2, 2] - qq[3, 3], qq[1, 2] - qq[3, 0], qq[1, 3] + qq[2, 0]],
        [qq[1, 2] + qq[3, 0], 1.0 - qq[1, 1] - qq[3, 3], qq[2, 3] - qq[1, 0]],
        [qq[1, 3] - qq[2, 0], qq[2, 3] + qq[1, 0], 1.0 - qq[1, 1] - qq[2, 2]],
    ])
    return out


def quaternion_slerp(q0: np.ndarray, q1: np.ndarray, fraction: float,
                     spin: int = 0, shortestpath: bool = True) -> np.ndarray:
    """Spherical linear interpolation between two unit quaternions."""
    q0 = np.asarray(q0, np.float64) / np.linalg.norm(q0)
    q1 = np.asarray(q1, np.float64) / np.linalg.norm(q1)
    if fraction == 0.0:
        return q0
    if fraction == 1.0:
        return q1
    d = float(np.dot(q0, q1))
    if abs(abs(d) - 1.0) < 1e-12:
        return q0
    if shortestpath and d < 0.0:
        d = -d
        q1 = -q1
    d = np.clip(d, -1.0, 1.0)
    angle = np.arccos(d) + spin * np.pi
    if abs(angle) < 1e-12:
        return q0
    isin = 1.0 / np.sin(angle)
    return (np.sin((1.0 - fraction) * angle) * isin) * q0 + \
        (np.sin(fraction * angle) * isin) * q1


def quat_correct_sequence(quats: np.ndarray) -> np.ndarray:
    """Flip quaternion signs so consecutive frames stay on the same
    hemisphere (ref: evaluate.py:32-37 quat_correct)."""
    out = quats.copy()
    for t in range(1, len(out)):
        if np.linalg.norm(out[t - 1] - out[t]) > \
                np.linalg.norm(out[t - 1] + out[t]):
            out[t] = -out[t]
    return out


def smooth_rotmats_slerp(rotmats: np.ndarray, ratio: float = 0.3) -> np.ndarray:
    """Slerp low-pass over a rotation sequence.

    rotmats (T, J, 3, 3); each joint's quaternion track is sign-corrected then
    recursively slerped toward the incoming frame with `ratio`
    (ref: evaluate.py:40-59 quat_smooth / smooth_pose_mat).
    """
    T, J = rotmats.shape[:2]
    out = np.empty_like(rotmats)
    for j in range(J):
        quats = np.stack([quaternion_from_matrix(rotmats[t, j])
                          for t in range(T)])
        quats = quat_correct_sequence(quats)
        for t in range(1, T):
            quats[t] = quaternion_slerp(quats[t - 1], quats[t], ratio)
        out[:, j] = np.stack([quaternion_matrix(q)[:3, :3] for q in quats])
    return out.astype(rotmats.dtype)
