"""Keypoint-format registry and name-based conversion.

A copy of the registry, the skeleton tables, `skeleton`, `convert_kps` and
`perm_idxs` of `tepose_tpu/data/kp_utils.py` (numpy only), pinned equal to
them by tests/test_torch_eval.py and tests/test_torch_host.py.
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


# ---------------------------------------------------------------------------
# Skeleton (bone-edge) tables, stored as JOINT-NAME pairs and resolved against
# the format's name table — the registry redesign of the reference's ten
# hard-coded index arrays (ref: _kp_utils.py get_spin_skeleton:288-316,
# get_common_skeleton:396-413, get_insta_skeleton:128-156,
# get_staf_skeleton:159-183, get_coco_skeleton:438-478,
# get_mpii_skeleton:500-536, get_aich_skeleton:555-587,
# get_3dpw_skeleton:606-624, get_smplcoco_skeleton:648-672,
# get_smpl_skeleton:701-727). Name pairs are self-documenting and make the
# topology verifiable against the reference index tables by construction
# (pinned in tests/test_kp_utils.py).
# ---------------------------------------------------------------------------

_SKELETONS: Dict[str, List] = {}

# OpenPose-body topology shared by the OP-named formats (spin/staf/insta all
# draw these limbs; each format keeps the subset whose joints it has).
_OP_BODY = [
    ("OP Nose", "OP Neck"),
    ("OP Neck", "OP RShoulder"), ("OP RShoulder", "OP RElbow"),
    ("OP RElbow", "OP RWrist"),
    ("OP Neck", "OP LShoulder"), ("OP LShoulder", "OP LElbow"),
    ("OP LElbow", "OP LWrist"),
    ("OP Neck", "OP MidHip"),
    ("OP MidHip", "OP RHip"), ("OP RHip", "OP RKnee"),
    ("OP RKnee", "OP RAnkle"),
    ("OP MidHip", "OP LHip"), ("OP LHip", "OP LKnee"),
    ("OP LKnee", "OP LAnkle"),
    ("OP Nose", "OP REye"), ("OP Nose", "OP LEye"),
    ("OP REye", "OP REar"), ("OP LEye", "OP LEar"),
]

_OP_FEET = [
    ("OP LHeel", "OP LBigToe"), ("OP LBigToe", "OP LSmallToe"),
    ("OP LAnkle", "OP LHeel"),
    ("OP RAnkle", "OP RHeel"), ("OP RHeel", "OP RBigToe"),
    ("OP RBigToe", "OP RSmallToe"),
]

_SKELETONS["spin"] = _OP_BODY + _OP_FEET + [("OP Nose", "headtop")]

_SKELETONS["staf"] = _OP_BODY + [
    ("OP RShoulder", "OP RHip"), ("OP LShoulder", "OP LHip"),
    ("OP Neck", "Neck (LSP)"), ("Top of Head (LSP)", "Neck (LSP)"),
]

_SKELETONS["insta"] = [
    ("OP RHeel", "OP RKnee"), ("OP RKnee", "OP RHip"),
    ("OP RHip", "OP LHip"), ("OP LHip", "OP LKnee"),
    ("OP LKnee", "OP LHeel"),
    ("OP RWrist", "OP RElbow"), ("OP RElbow", "OP RShoulder"),
    ("OP RShoulder", "OP LShoulder"), ("OP LShoulder", "OP LElbow"),
    ("OP RHip", "OP RShoulder"), ("OP LHip", "OP LShoulder"),
    ("OP LElbow", "OP LWrist"),
    ("OP RShoulder", "OP Neck"), ("OP LShoulder", "OP Neck"),
    ("OP Neck", "headtop"), ("OP Neck", "OP Nose"),
    ("OP Nose", "OP LEye"), ("OP Nose", "OP REye"),
    ("OP LEye", "OP LEar"), ("OP REye", "OP REar"),
    ("OP RHeel", "OP RBigToe"), ("OP RBigToe", "OP RSmallToe"),
    ("OP LHeel", "OP LBigToe"), ("OP LBigToe", "OP LSmallToe"),
    ("OP LHeel", "OP LAnkle"), ("OP RHeel", "OP RAnkle"),
]

_SKELETONS["common"] = [
    ("rankle", "rknee"), ("rknee", "rhip"),
    ("lhip", "lknee"), ("lknee", "lankle"),
    ("rwrist", "relbow"), ("relbow", "rshoulder"),
    ("rshoulder", "rhip"), ("rshoulder", "lshoulder"),
    ("lshoulder", "lhip"), ("rhip", "lhip"),
    ("rshoulder", "neck"), ("lshoulder", "lelbow"),
    ("neck", "lshoulder"), ("lelbow", "lwrist"),
    ("neck", "headtop"),
]

# per-edge left(1)/right(0) flags for 'common' (ref: vis.py:397 common_lr),
# used to colour bones by body side
COMMON_LR = [0, 0, 1, 1, 0, 0, 0, 0, 1, 0, 0, 1, 1, 1, 0]

_SKELETONS["coco"] = [
    ("lankle", "lknee"), ("lknee", "lhip"),
    ("rankle", "rknee"), ("rknee", "rhip"),
    ("lhip", "rhip"), ("lshoulder", "lhip"), ("rshoulder", "rhip"),
    ("lshoulder", "rshoulder"),
    ("lshoulder", "lelbow"), ("rshoulder", "relbow"),
    ("lelbow", "lwrist"), ("relbow", "rwrist"),
    ("leye", "reye"), ("nose", "leye"), ("nose", "reye"),
    ("leye", "lear"), ("reye", "rear"),
    ("lear", "lshoulder"), ("rear", "rshoulder"),
]

_SKELETONS["mpii"] = [
    ("rankle", "rknee"), ("rknee", "rhip"), ("rhip", "hip"),
    ("hip", "lhip"), ("lhip", "lknee"), ("lknee", "lankle"),
    ("hip", "thorax"), ("thorax", "neck"), ("neck", "headtop"),
    ("thorax", "rshoulder"), ("rshoulder", "relbow"),
    ("relbow", "rwrist"),
    ("thorax", "lshoulder"), ("lshoulder", "lelbow"),
    ("lelbow", "lwrist"),
]

_SKELETONS["aich"] = [
    ("rshoulder", "relbow"), ("relbow", "rwrist"),
    ("lshoulder", "lelbow"), ("lelbow", "lwrist"),
    ("rhip", "rknee"), ("rknee", "rankle"),
    ("lhip", "lknee"), ("lknee", "lankle"),
    ("headtop", "neck"), ("neck", "rshoulder"), ("neck", "lshoulder"),
    ("rshoulder", "rhip"), ("lshoulder", "lhip"),
]

_SKELETONS["3dpw"] = [
    ("nose", "thorax"),
    ("thorax", "rshoulder"), ("rshoulder", "relbow"),
    ("relbow", "rwrist"),
    ("thorax", "lshoulder"), ("lshoulder", "lelbow"),
    ("lelbow", "lwrist"),
    ("rshoulder", "rhip"), ("lshoulder", "lhip"), ("rhip", "lhip"),
    ("rhip", "rknee"), ("rknee", "rankle"),
    ("lhip", "lknee"), ("lknee", "lankle"),
]

_SKELETONS["smplcoco"] = [
    ("rankle", "rknee"), ("rknee", "rhip"),
    ("lhip", "lknee"), ("lknee", "lankle"),
    ("rwrist", "relbow"), ("relbow", "rshoulder"),
    ("rshoulder", "neck"), ("neck", "lshoulder"),
    ("lshoulder", "lelbow"), ("lelbow", "lwrist"),
    ("neck", "headtop"),
    ("nose", "leye"), ("leye", "lear"), ("reye", "rear"),
    ("nose", "reye"),
    ("rshoulder", "rhip"), ("lshoulder", "lhip"), ("rhip", "lhip"),
]


def skeleton(fmt: str) -> np.ndarray:
    """(E, 2) int array of bone edges as indices into `joint_names(fmt)`.

    'smpl' derives from the kinematic tree (the reference's get_smpl_skeleton
    IS the parent list, ref: _kp_utils.py:701-727); other formats resolve
    their name-pair tables. Formats without a table (h36m, mpii3d, ...) fall
    back to the subset of the common-14 bones whose joints they have — the
    reference offers nothing at all for those.
    """
    names = joint_names(fmt)
    if fmt == "smpl":
        from tepose_tpu_torch.models.smpl import SMPL_PARENTS

        return np.array([[p, i] for i, p in enumerate(SMPL_PARENTS)
                         if p >= 0], np.int64)
    pairs = _SKELETONS.get(fmt, _SKELETONS["common"])
    idx = {n: i for i, n in enumerate(names)}
    return np.array([[idx[a], idx[b]] for a, b in pairs
                     if a in idx and b in idx], np.int64)


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
