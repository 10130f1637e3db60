"""Keypoint-format registry and name-based conversion.

A copy of the registry, `convert_kps` and `perm_idxs` of
`tepose_tpu/data/kp_utils.py` (numpy only), pinned equal to them by
tests/test_torch_eval.py. The skeleton tables come with the rendering slice.
Conversion matches destination joint names against source names and leaves
unmatched joints zeroed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

_REGISTRY: Dict[str, List[str]] = {}


def register(name: str, joints: List[str]) -> None:
    _REGISTRY[name] = joints


def joint_names(fmt: str) -> List[str]:
    return list(_REGISTRY[fmt])


register("spin", [
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip",
    "OP RHip", "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
    "OP REye", "OP LEye", "OP REar", "OP LEar",
    "OP LBigToe", "OP LSmallToe", "OP LHeel",
    "OP RBigToe", "OP RSmallToe", "OP RHeel",
    "rankle", "rknee", "rhip", "lhip", "lknee", "lankle",
    "rwrist", "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist",
    "neck", "headtop", "hip", "thorax",
    "Spine (H36M)", "Jaw (H36M)", "Head (H36M)",
    "nose", "leye", "reye", "lear", "rear",
])

register("common", [
    "rankle", "rknee", "rhip", "lhip", "lknee", "lankle",
    "rwrist", "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist",
    "neck", "headtop",
])

# 17-joint MPI-INF-3DHP test format; joint -3 (index 14, 'hip') is the pelvis
# used for alignment at eval (ref: evaluate.py:421-422).
register("mpii3d_test", [
    "headtop", "neck",
    "rshoulder", "relbow", "rwrist",
    "lshoulder", "lelbow", "lwrist",
    "rhip", "rknee", "rankle",
    "lhip", "lknee", "lankle",
    "hip", "Spine (H36M)", "Head (H36M)",
])

register("mpii3d", [
    "spine3", "spine4", "spine2", "Spine (H36M)", "hip", "neck",
    "Head (H36M)", "headtop", "left_clavicle", "lshoulder", "lelbow",
    "lwrist", "left_hand", "right_clavicle", "rshoulder", "relbow", "rwrist",
    "right_hand", "lhip", "lknee", "lankle", "left_foot", "left_toe",
    "rhip", "rknee", "rankle", "right_foot", "right_toe",
])

register("h36m", [
    "hip", "lhip", "lknee", "lankle", "rhip", "rknee", "rankle",
    "Spine (H36M)", "neck", "Head (H36M)", "headtop",
    "lshoulder", "lelbow", "lwrist", "rshoulder", "relbow", "rwrist",
])

register("insta", [
    "OP RHeel", "OP RKnee", "OP RHip", "OP LHip", "OP LKnee", "OP LHeel",
    "OP RWrist", "OP RElbow", "OP RShoulder", "OP LShoulder", "OP LElbow",
    "OP LWrist", "OP Neck", "headtop", "OP Nose", "OP LEye", "OP REye",
    "OP LEar", "OP REar", "OP LBigToe", "OP RBigToe", "OP LSmallToe",
    "OP RSmallToe", "OP LAnkle", "OP RAnkle",
])

register("staf", [
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip",
    "OP RHip", "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
    "OP REye", "OP LEye", "OP REar", "OP LEar",
    "Neck (LSP)", "Top of Head (LSP)",
])

register("posetrack", [
    "nose", "neck", "headtop", "lear", "rear",
    "lshoulder", "rshoulder", "lelbow", "relbow", "lwrist", "rwrist",
    "lhip", "rhip", "lknee", "rknee", "lankle", "rankle",
])

register("pennaction", [
    "headtop", "lshoulder", "rshoulder", "lelbow", "relbow", "lwrist",
    "rwrist", "lhip", "rhip", "lknee", "rknee", "lankle", "rankle",
])

register("coco", [
    "nose", "leye", "reye", "lear", "rear",
    "lshoulder", "rshoulder", "lelbow", "relbow", "lwrist", "rwrist",
    "lhip", "rhip", "lknee", "rknee", "lankle", "rankle",
])

register("mpii", [
    "rankle", "rknee", "rhip", "lhip", "lknee", "lankle",
    "hip", "thorax", "neck", "headtop",
    "rwrist", "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist",
])

register("aich", [
    "rshoulder", "relbow", "rwrist", "lshoulder", "lelbow", "lwrist",
    "rhip", "rknee", "rankle", "lhip", "lknee", "lankle",
    "headtop", "neck",
])

register("3dpw", [
    "nose", "thorax", "rshoulder", "relbow", "rwrist",
    "lshoulder", "lelbow", "lwrist",
    "rhip", "rknee", "rankle", "lhip", "lknee", "lankle",
])

register("smplcoco", [
    "rankle", "rknee", "rhip", "lhip", "lknee", "lankle",
    "rwrist", "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist",
    "neck", "headtop", "nose", "leye", "reye", "lear", "rear",
])

register("smpl", [
    "hips", "leftUpLeg", "rightUpLeg", "spine", "leftLeg", "rightLeg",
    "spine1", "leftFoot", "rightFoot", "spine2", "leftToeBase",
    "rightToeBase", "neck", "leftShoulder", "rightShoulder", "head",
    "leftArm", "rightArm", "leftForeArm", "rightForeArm", "leftHand",
    "rightHand", "leftHandIndex1", "rightHandIndex1",
])


def convert_kps(joints: np.ndarray, src: str, dst: str) -> np.ndarray:
    """Convert (N, K_src, C) keypoints to (N, K_dst, 3) by name matching.

    Unmatched destination joints stay zero (confidence 0). When the source has
    only 2 channels, a confidence of 1 is NOT added — mirror of the reference,
    which zero-pads the channel dimension to 3.
    """
    src_names = joint_names(src)
    dst_names = joint_names(dst)
    out = np.zeros((joints.shape[0], len(dst_names), 3), dtype=joints.dtype)
    for i, name in enumerate(dst_names):
        if name in src_names:
            out[:, i, :joints.shape[2]] = joints[:, src_names.index(name)]
    return out


def perm_idxs(src: str, dst: str) -> List[int]:
    """Indices into `src` for each dst joint present in src."""
    src_names = joint_names(src)
    return [src_names.index(n) for n in joint_names(dst) if n in src_names]
