"""Bbox-crop geometry: affine patch transform + keypoint normalisation.

A copy of `tepose_tpu/data/transforms.py` (numpy, closed-form affine, no
cv2), pinned equal to it by tests/test_torch_train_loop.py.
"""

from __future__ import annotations

import numpy as np


def patch_affine(center_x, center_y, src_width, src_height,
                 patch_width: float = 224.0, patch_height: float = 224.0,
                 scale: float = 1.0, rot: float = 0.0) -> np.ndarray:
    """2x3 affine mapping image coords -> patch coords.

    Matches gen_trans_from_patch_cv (ref: _img_utils.py:53-86): the source
    box (src_width*scale x src_height*scale around the center, rotated by
    `rot` degrees) maps onto the full patch.

    Scalars or (N,) arrays accepted; returns (2, 3) or (N, 2, 3).
    """
    cx = np.asarray(center_x, np.float64)
    cy = np.asarray(center_y, np.float64)
    sw = np.asarray(src_width, np.float64) * scale
    sh = np.asarray(src_height, np.float64) * scale

    rot_rad = np.pi * rot / 180.0
    cs, sn = np.cos(rot_rad), np.sin(rot_rad)

    # Forward map: p_patch = S R^-1 (p - c) + patch_center, where R rotates
    # the source frame; with the reference's triangle construction this is
    # equivalent to inverting [rightdir downdir] into the dst basis.
    sx = patch_width / sw
    sy = patch_height / sh

    # rotation of the *source* axes by rot means the inverse rotation applies
    # to points: R(-rot)
    a00 = sx * cs
    a01 = sx * sn
    a10 = -sy * sn
    a11 = sy * cs

    t0 = patch_width * 0.5 - (a00 * cx + a01 * cy)
    t1 = patch_height * 0.5 - (a10 * cx + a11 * cy)

    rows = np.stack([
        np.stack([np.broadcast_to(a00, cx.shape),
                  np.broadcast_to(a01, cx.shape), t0], axis=-1),
        np.stack([np.broadcast_to(a10, cx.shape),
                  np.broadcast_to(a11, cx.shape), t1], axis=-1),
    ], axis=-2)
    return rows.astype(np.float32)


def transform_keypoints(kp_2d: np.ndarray, bbox: np.ndarray,
                        patch_size: float = 224.0,
                        scale: float = 1.2) -> np.ndarray:
    """Map (T, K, 2) image keypoints into patch coords per frame.

    bbox (T, 4) = (center_x, center_y, width, height); the default scale=1.2
    matches transfrom_keypoints with do_augment=False
    (ref: _img_utils.py:130-153).
    """
    trans = patch_affine(bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3],
                         patch_size, patch_size, scale=scale)   # (T, 2, 3)
    hom = np.concatenate(
        [kp_2d, np.ones_like(kp_2d[..., :1])], axis=-1)          # (T, K, 3)
    return np.einsum("tij,tkj->tki", trans, hom).astype(kp_2d.dtype)


def normalize_2d_kp(kp_2d: np.ndarray, crop_size: float = 224.0,
                    inv: bool = False) -> np.ndarray:
    """Patch coords <-> [-1, 1] (ref: _img_utils.py:311-320)."""
    if not inv:
        return 2.0 * kp_2d / crop_size - 1.0
    return (kp_2d + 1.0) * crop_size / 2.0
