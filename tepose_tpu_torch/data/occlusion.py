"""Occlusion & camera-noise data augmentation (robustness fault injection).

A copy of `tepose_tpu/data/occlusion.py` (importing it would import JAX
through the `tepose_tpu` package), pinned equal to it function for function
by tests/test_torch_preprocess.py.

ref: lib/data_utils/_occ_utils.py — used offline to build the `*_occ_db.pt`
DB variants: paste Pascal-VOC object cut-outs over crops (static or moving
linearly across a window) and perturb bbox tracks with synthetic camera
zoom/pan. cv2 is imported by the functions that need it.
"""

from __future__ import annotations

import os
import os.path as osp
import random
import xml.etree.ElementTree as ET
from typing import List, Optional, Sequence, Tuple

import numpy as np


def resize_by_factor(im: np.ndarray, factor: float) -> np.ndarray:
    import cv2

    new_size = tuple(np.round(
        np.array([im.shape[1], im.shape[0]]) * factor).astype(int))
    if min(new_size) < 1:
        raise ValueError("degenerate resize")
    interp = cv2.INTER_LINEAR if factor > 1.0 else cv2.INTER_AREA
    return cv2.resize(im, new_size, interpolation=interp)


def load_occluders(pascal_voc_root: str,
                   min_area: int = 500) -> List[np.ndarray]:
    """Extract RGBA object cut-outs from Pascal VOC segmentation data.

    ref: _occ_utils.py:40-95 — segmented, non-difficult, non-truncated,
    non-person objects; mask border softened; downscaled by 0.5.
    """
    import cv2

    occluders: List[np.ndarray] = []
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (8, 8))
    ann_dir = osp.join(pascal_voc_root, "Annotations")
    for name in sorted(os.listdir(ann_dir)):
        path = osp.join(ann_dir, name)
        if not osp.isfile(path):
            continue
        root = ET.parse(path).getroot()
        if root.find("segmented") is None or \
                root.find("segmented").text == "0":
            continue
        boxes = []
        for i_obj, obj in enumerate(root.findall("object")):
            if obj.find("difficult").text != "0":
                continue
            if obj.find("truncated").text != "0":
                continue
            bb = obj.find("bndbox")
            boxes.append((i_obj, [int(bb.find(s).text) for s in
                                  ("xmin", "ymin", "xmax", "ymax")]))
        if not boxes:
            continue
        im_file = root.find("filename").text
        im_path = osp.join(pascal_voc_root, "JPEGImages", im_file)
        seg_path = osp.join(pascal_voc_root, "SegmentationObject",
                            im_file.replace("jpg", "png"))
        if not (osp.isfile(im_path) and osp.isfile(seg_path)):
            continue
        im = cv2.cvtColor(cv2.imread(im_path), cv2.COLOR_BGR2RGB)
        labels = cv2.imread(seg_path, cv2.IMREAD_GRAYSCALE)
        for i_obj, (xmin, ymin, xmax, ymax) in boxes:
            mask = (labels[ymin:ymax, xmin:xmax] == i_obj + 1).astype(
                np.uint8) * 255
            if cv2.countNonZero(mask) < min_area:
                continue
            eroded = cv2.erode(mask, kernel)
            mask[eroded < mask] = 192
            rgba = np.concatenate(
                [im[ymin:ymax, xmin:xmax], mask[..., None]], axis=-1)
            if rgba.size == 0:
                continue
            try:
                occluders.append(resize_by_factor(rgba, 0.5))
            except ValueError:
                continue
    return occluders


def synthetic_occluders(rng: np.random.RandomState,
                        count: int = 16) -> List[np.ndarray]:
    """Procedural RGBA blobs for tests / when VOC data is absent."""
    out = []
    for _ in range(count):
        h, w = rng.randint(30, 90, 2)
        rgba = np.zeros((h, w, 4), np.uint8)
        rgba[..., :3] = rng.randint(0, 255, (h, w, 3))
        yy, xx = np.mgrid[:h, :w]
        ellipse = (((yy - h / 2) / (h / 2)) ** 2
                   + ((xx - w / 2) / (w / 2)) ** 2) <= 1.0
        rgba[..., 3] = ellipse.astype(np.uint8) * 255
        out.append(rgba)
    return out


def paste_over(im_src: np.ndarray, im_dst: np.ndarray,
               center: np.ndarray) -> np.ndarray:
    """Alpha-blend an RGBA patch onto an RGB image in place
    (ref: _occ_utils.py:151-183)."""
    wh_src = np.asarray([im_src.shape[1], im_src.shape[0]])
    wh_dst = np.asarray([im_dst.shape[1], im_dst.shape[0]])
    center = np.round(center).astype(np.int32)
    raw_start = center - wh_src // 2
    raw_end = raw_start + wh_src
    start = np.clip(raw_start, 0, wh_dst)
    end = np.clip(raw_end, 0, wh_dst)
    region_dst = im_dst[start[1]:end[1], start[0]:end[0]]
    s_src = start - raw_start
    e_src = wh_src + (end - raw_end)
    region_src = im_src[s_src[1]:e_src[1], s_src[0]:e_src[0]]
    if region_src.size == 0 or region_dst.size == 0:
        return im_dst
    color = region_src[..., :3].astype(np.float32)
    alpha = region_src[..., 3:].astype(np.float32) / 255.0
    im_dst[start[1]:end[1], start[0]:end[0]] = (
        alpha * color + (1 - alpha) * region_dst).astype(im_dst.dtype)
    return im_dst


def occlude_with_objects(im: np.ndarray, occluders: Sequence[np.ndarray],
                         rng: Optional[random.Random] = None) -> np.ndarray:
    """Paste 1..7 randomly scaled occluders at random positions
    (ref: _occ_utils.py:125-148)."""
    rng = rng or random
    result = im.copy()
    wh = np.asarray([im.shape[1], im.shape[0]])
    im_scale = min(wh) / 256.0
    for _ in range(rng.randint(1, 7)):
        occ = rng.choice(list(occluders))
        try:
            occ = resize_by_factor(occ, rng.uniform(0.2, 1.0) * im_scale)
        except ValueError:
            continue
        center = np.array([rng.uniform(0, wh[0]), rng.uniform(0, wh[1])])
        paste_over(occ, result, center)
    return result


def get_motion_occlusions(img_shape, occluders: Sequence[np.ndarray],
                          seqlen: int,
                          rng: Optional[random.Random] = None):
    """Occluders moving linearly across a window: either staying put or
    drifting to an image edge (ref: _occ_utils.py:97-122).

    Returns (occluder list, per-occluder (seqlen, 2) center tracks).
    """
    rng = rng or random
    wh = np.asarray([img_shape[1], img_shape[0]], np.float64)
    im_scale = min(wh) / 256.0
    occ_list, motion_list = [], []
    for _ in range(rng.randint(1, 7)):
        occ = rng.choice(list(occluders))
        try:
            occ = resize_by_factor(occ, rng.uniform(0.2, 1.0) * im_scale)
        except ValueError:
            continue
        start = np.array([rng.uniform(0, wh[0]), rng.uniform(0, wh[1])])
        end = np.array([
            rng.choice([start[0], start[0], 0.0, wh[0]]),
            rng.choice([start[1], start[1], 0.0, wh[1]])])
        occ_list.append(occ)
        motion_list.append(np.linspace(start, end, num=seqlen))
    return occ_list, motion_list


def apply_motion_occlusions(frames: Sequence[np.ndarray],
                            occ_list, motion_list) -> List[np.ndarray]:
    """Composite the moving occluders over a window of frames."""
    out = []
    for t, frame in enumerate(frames):
        f = frame.copy()
        for occ, motion in zip(occ_list, motion_list):
            paste_over(occ, f, motion[min(t, len(motion) - 1)])
        out.append(f)
    return out


def get_cam_noise(bboxes: np.ndarray, img_width: float, img_height: float,
                  seqlen: int,
                  rng: Optional[random.Random] = None) -> np.ndarray:
    """Synthetic camera zoom/pan over a bbox track
    (ref: _occ_utils.py:201-245: zoom in/out, pan to each edge, or no-op)."""
    rng = rng or random
    choice = rng.choice([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12])
    result = bboxes.copy()
    base = result[0]
    if choice == 1:  # zoom out
        s = rng.randint(2, 3)
        result[:, 2:] *= np.linspace(1, s, num=seqlen)[:, None]
    elif choice == 2:  # zoom in
        s = rng.uniform(0.3, 0.5)
        result[:, 2:] *= np.linspace(1, s, num=seqlen)[:, None]
    elif choice == 4:  # pan left
        result[:, 0] -= np.linspace(0, base[0], num=seqlen)
    elif choice == 5:  # pan right
        result[:, 0] += np.linspace(0, img_width - base[0], num=seqlen)
    elif choice == 6:  # pan up
        result[:, 1] -= np.linspace(0, base[1], num=seqlen)
    elif choice == 7:  # pan down
        result[:, 1] += np.linspace(0, img_height - base[1], num=seqlen)
    return result
