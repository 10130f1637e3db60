"""A copy of `tepose_tpu/ops/filters.py` (numpy and scipy only), pinned
equal to it by tests/test_torch_host.py.

Temporal smoothing filters: 1-euro pose filter and bbox smoothing.

ref: lib/utils/one_euro_filter.py (1-euro low-pass), lib/utils/smooth_pose.py
(pose smoothing wrapper that re-runs SMPL), lib/utils/smooth_bbox.py
(kp->bbox params, missing-detection interpolation, median+gaussian filter).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter1d
from scipy.signal import medfilt


# ---------------------------------------------------------------- one-euro


def _smoothing_factor(t_e: np.ndarray, cutoff) -> np.ndarray:
    r = 2 * np.pi * cutoff * t_e
    return r / (r + 1)


def _exp_smooth(a, x, x_prev):
    return a * x + (1 - a) * x_prev


class OneEuroFilter:
    """Vectorised 1-euro filter (Casiez et al.); ref: one_euro_filter.py:5-46.

    Operates elementwise on arrays of any shape.
    """

    def __init__(self, t0: float, x0: np.ndarray, dx0: float = 0.0,
                 min_cutoff: float = 1.0, beta: float = 0.0,
                 d_cutoff: float = 1.0):
        self.min_cutoff = float(min_cutoff)
        self.beta = float(beta)
        self.d_cutoff = float(d_cutoff)
        self.x_prev = np.asarray(x0, np.float64)
        self.dx_prev = np.full_like(self.x_prev, dx0)
        # scalar or per-element timestamps (the reference passes arrays,
        # smooth_pose.py:29-31)
        self.t_prev = np.asarray(t0, np.float64)

    def __call__(self, t: float, x: np.ndarray) -> np.ndarray:
        t_e = t - self.t_prev
        a_d = _smoothing_factor(t_e, self.d_cutoff)
        dx = (np.asarray(x, np.float64) - self.x_prev) / t_e
        dx_hat = _exp_smooth(a_d, dx, self.dx_prev)

        cutoff = self.min_cutoff + self.beta * np.abs(dx_hat)
        a = _smoothing_factor(t_e, cutoff)
        x_hat = _exp_smooth(a, x, self.x_prev)

        self.x_prev = x_hat
        self.dx_prev = dx_hat
        self.t_prev = t
        return x_hat


def smooth_pose_params(pred_pose: np.ndarray, pred_betas: np.ndarray,
                       min_cutoff: float = 0.004, beta: float = 0.7):
    """1-euro-filter a (T, 72) pose track; betas pass through UNfiltered.

    The reference's smooth_pose filters only the pose and re-runs SMPL
    with each frame's RAW betas (ref: smooth_pose.py:28-65) — filtering
    the shape track too would lag the mesh's shape for many frames after
    any estimate jump and diverge from the --smooth pipeline this
    reproduces. Returns (smoothed_pose, betas); the caller re-runs SMPL
    to refresh verts/joints.
    """
    pose = pred_pose.copy()
    f_pose = OneEuroFilter(0, pose[0], min_cutoff=min_cutoff, beta=beta)
    for t in range(1, len(pose)):
        pose[t] = f_pose(t, pose[t])
    return pose, pred_betas


# ---------------------------------------------------------------- bbox


def kp_to_bbox_param(kp: np.ndarray, vis_thresh: float = 0.3,
                     person_height_px: float = 150.0):
    """Keypoints (K, 3) -> (cx, cy, scale) or None.

    ref: smooth_bbox.py:36-59 — person height is the DIAGONAL norm of the
    visible-keypoint extent; boxes smaller than 0.5 px are rejected; scale
    maps the person to 150 px.
    """
    if kp is None:
        return None
    vis = kp[:, 2] > vis_thresh
    if not np.any(vis):
        return None
    min_pt = np.min(kp[vis, :2], axis=0)
    max_pt = np.max(kp[vis, :2], axis=0)
    height = float(np.linalg.norm(max_pt - min_pt))
    if height < 0.5:
        return None
    center = (min_pt + max_pt) / 2.0
    return np.append(center, person_height_px / height).astype(np.float32)


def get_all_bbox_params(kps, vis_thresh: float = 2.0):
    """Per-frame bbox params with interior-gap linear interpolation.

    ref: smooth_bbox.py:62-103. Returns (params (M, 3), start_idx incl,
    end_idx excl) — the contiguous interval that has detections.
    """
    num_to_interp = 0
    start_index = -1
    params = np.empty((0, 3), np.float32)
    i = -1
    for i, kp in enumerate(kps):
        p = kp_to_bbox_param(kp, vis_thresh=vis_thresh)
        if p is None:
            num_to_interp += 1
            continue
        if start_index == -1:
            start_index = i
            num_to_interp = 0
        if num_to_interp > 0:
            prev = params[-1]
            interp = np.array(
                [np.linspace(a, b, num_to_interp + 2)
                 for a, b in zip(prev, p)])
            params = np.vstack((params, interp.T[1:-1]))
            num_to_interp = 0
        params = np.vstack((params, p))
    return params, start_index, i - num_to_interp + 1


def smooth_bbox_params(params: np.ndarray, kernel_size: int = 11,
                       sigma: float = 8.0) -> np.ndarray:
    """Median + gaussian filter over (T, 3) bbox params
    (ref: smooth_bbox.py:106-121)."""
    k = kernel_size if kernel_size % 2 == 1 else kernel_size + 1
    out = params.copy().astype(np.float64)
    if len(params) >= k >= 3:
        for c in range(params.shape[1]):
            out[:, c] = medfilt(out[:, c], k)
    for c in range(params.shape[1]):
        out[:, c] = gaussian_filter1d(out[:, c], sigma)
    return out.astype(np.float32)


def get_smooth_bbox_params(kps, vis_thresh: float = 2.0,
                           kernel_size: int = 11, sigma: float = 3.0):
    """Full pipeline: kp->bbox per frame, interpolate interior gaps, smooth.

    Returns (smoothed params (end, 3), start_idx, end_idx) exactly like the
    reference's get_smooth_bbox_params (smooth_bbox.py:9-33, incl. the
    zeros prefix for frames before start_idx, so params[i] aligns with
    frame i; slice [start:end] for the detected interval). Used by the DB
    builders with sigma=8 (threedpw_utils.py:117).
    """
    params, t0, t1 = get_all_bbox_params(kps, vis_thresh)
    if len(params) == 0:
        return params, t0, t1
    smoothed = smooth_bbox_params(params, kernel_size, sigma)
    smoothed = np.vstack([np.zeros((t0, 3), smoothed.dtype), smoothed])
    return smoothed, t0, t1


def bbox_params_to_cxcywh(params: np.ndarray,
                          expand: float = 1.1) -> np.ndarray:
    """(cx, cy, scale) -> (cx, cy, w, h) with the reference's 150px scaling
    and 1.1 expansion (ref: threedpw_utils.py:128-134)."""
    w = 150.0 / params[:, 2] * expand
    return np.stack([params[:, 0], params[:, 1], w, w], axis=1)
