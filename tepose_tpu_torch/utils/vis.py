"""A copy of `tepose_tpu/utils/vis.py` (numpy; cv2 only inside the
functions that use it) reading the port's `data/kp_utils.py` and
`native`; pinned equal to it by tests/test_torch_host.py.

Training/debug visualisation: skeleton and mesh overlays, video grids.

ref: lib/utils/vis.py (batch_visualize_vid_preds at :330-382 used by the
trainer's DEBUG path, draw_skeleton at :384-414). Rendering uses the native
rasterizer (tepose_tpu_torch.native) instead of pyrender.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def infer_kp_format(num_joints: int) -> Optional[str]:
    """Best-effort keypoint format from the joint count. A count resolves
    only when exactly ONE registered format has that many joints (the
    model's own output layouts all do: 49->spin, 25->insta, 21->staf) —
    None when ambiguous or unknown, because guessing would wire bones
    between the wrong joints (17 is coco AND h36m AND posetrack AND
    mpii3d_test; 14 is common AND aich AND 3dpw — pass fmt explicitly,
    e.g. fmt="common" for metric-space keypoints)."""
    from tepose_tpu_torch.data import kp_utils

    matches = [f for f in kp_utils._REGISTRY
               if len(kp_utils.joint_names(f)) == num_joints]
    return matches[0] if len(matches) == 1 else None


def draw_skeleton(image: np.ndarray, kp_2d: np.ndarray,
                  fmt: Optional[str] = None, unnormalize: bool = True,
                  thickness: int = 2, radius: int = 3) -> np.ndarray:
    """Draw a 2D skeleton over an image (in place; returns image).

    kp_2d (K, 2|3) — normalised [-1,1] when `unnormalize` (model outputs) or
    pixel coords otherwise. `fmt` picks the bone-edge table from the keypoint
    registry (kp_utils.skeleton); when None it is inferred from K, so a
    49-joint SPIN overlay now draws the full face/feet/hand topology (ref:
    vis.py:384-414 draw_skeleton + _kp_utils get_*_skeleton; the reference's
    own loop is dead code — it trips a leftover pdb.set_trace at vis.py:404).
    Colours mirror the reference: green joints; bones alternate blue/red
    (left/right via COMMON_LR for the common format).
    """
    import cv2

    from tepose_tpu_torch.data import kp_utils

    kp = kp_2d.copy().astype(np.float32)
    if unnormalize:
        # per-axis: x scales by width, y by height (identical on the
        # square 224-crops, wrong on full frames otherwise)
        kp[:, 0] = (kp[:, 0] + 1.0) * 0.5 * image.shape[1]
        kp[:, 1] = (kp[:, 1] + 1.0) * 0.5 * image.shape[0]
    if fmt is None:
        fmt = infer_kp_format(kp.shape[0])
    edges = kp_utils.skeleton(fmt) if fmt is not None else []
    pts = kp[:, :2].astype(int)
    conf = kp[:, 2] if kp.shape[1] > 2 else np.ones(len(kp))
    rcolor, lcolor, pcolor = (255, 0, 0), (0, 0, 255), (0, 255, 0)
    for i, (a, b) in enumerate(edges):
        # bounds guard: an explicit fmt whose edge table exceeds the given
        # keypoint count degrades to drawing the in-range bones, not crashing
        if a >= len(pts) or b >= len(pts):
            continue
        if conf[a] > 0.3 and conf[b] > 0.3:
            if fmt == "common":
                color = rcolor if kp_utils.COMMON_LR[i] == 0 else lcolor
            else:
                color = lcolor if i % 2 == 0 else rcolor
            cv2.line(image, tuple(pts[a]), tuple(pts[b]), color, thickness)
    for i, p in enumerate(pts):
        if conf[i] > 0.3:
            cv2.circle(image, tuple(p), radius, pcolor, -1)
    return image


def overlay_mesh_on_crop(crop: np.ndarray, verts: np.ndarray,
                         cam: np.ndarray, faces: np.ndarray,
                         color=(1.0, 1.0, 0.9)) -> np.ndarray:
    """Render a mesh over a square crop using its weak-perspective cam
    (s, tx, ty) — crop-coordinate equivalent of the demo overlay."""
    from tepose_tpu_torch.native import render_mesh

    cam4 = np.array([cam[0], cam[0], cam[1], cam[2]], np.float32)
    return render_mesh(verts, faces, cam4, crop.copy(), color=color)


def batch_visualize_vid_preds(video: np.ndarray, preds: Dict,
                              target: Dict, faces: Optional[np.ndarray],
                              max_items: int = 4) -> np.ndarray:
    """Build a (T, H, W*min(B, max_items), 3) one-row prediction-overlay
    video grid for a batch.

    ref: vis.py:330-382 — per sample: input crop (+ mesh when faces given)
    + predicted skeleton + GT skeleton. The mesh is rendered FIRST so the
    near-opaque overlay cannot hide the skeletons drawn on top. video
    (B, T, H, W, 3) uint8; preds with kp_2d (B, T, K, 2) and optionally
    verts/theta.
    """
    B, T = video.shape[:2]
    n = min(B, max_items)
    frames = []
    for t in range(T):
        row = []
        for b in range(n):
            img = video[b, t].copy()
            if faces is not None and "verts" in preds and "theta" in preds:
                cam = np.asarray(preds["theta"][b, t, :3])
                img = overlay_mesh_on_crop(
                    img, np.asarray(preds["verts"][b, t]), cam, faces)
            if "kp_2d" in preds:
                draw_skeleton(img, np.asarray(preds["kp_2d"][b, t]))
            if "kp_2d" in target:
                draw_skeleton(img, np.asarray(target["kp_2d"][b, t]),
                              thickness=1, radius=2)
            row.append(img)
        frames.append(np.concatenate(row, axis=1))
    return np.stack(frames)


def draw_wireframe(image: np.ndarray, verts: np.ndarray, cam: np.ndarray,
                   faces: np.ndarray, color=(200, 200, 180),
                   max_edges: int = 20000) -> np.ndarray:
    """Edge-line mesh overlay (the --wireframe demo flag; the reference
    delegates to pyrender's wireframe mode, renderer.py/demo.py:482).

    cam (4,) = (sx, sy, tx, ty) in original-image coords (same mapping as the
    native rasterizer).
    """
    import cv2

    h, w = image.shape[:2]
    sx, sy, tx, ty = [float(c) for c in cam]
    px = ((1.0 + sx * (verts[:, 0] + tx)) * 0.5 * w).astype(np.int32)
    py = ((1.0 + sy * (-verts[:, 1] + ty)) * 0.5 * h).astype(np.int32)
    edges = set()
    for f in faces[:max_edges]:
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            edges.add((min(a, b), max(a, b)))
    for a, b in edges:
        cv2.line(image, (px[a], py[a]), (px[b], py[b]), color, 1)
    return image
