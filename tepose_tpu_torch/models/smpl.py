"""SMPL body model in torch: blend shapes, pose correctives, kinematic chain,
linear blend skinning.

Port of `tepose_tpu/models/smpl.py` (constants, `SmplModel`,
`load_smpl_assets`, `load_smpl_faces`, `synthetic_smpl_model`,
`_rigid_transform`,
`smpl_forward`, `joint_reduction_tensors`, `smpl_joints_reduced`,
`regress_h36m_joints`). Step 5 of the forward, the skinning,
goes through `ops.lbs_skinning.lbs_skinning`: the CUDA kernel on a CUDA
device, its plain einsum on the CPU.

Joint conventions are the reference's: joints 0..23 are the posed skeleton,
24..44 surface-vertex keypoints, 45..53 the `J_regressor_extra` joints, and
the 49-joint output reorders those 54 by JOINT_MAP/JOINT_NAMES.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tepose_tpu_torch.ops.geometry import batch_rodrigues
from tepose_tpu_torch.ops.lbs_skinning import lbs_skinning

JOINT_MAP = {
    "OP Nose": 24, "OP Neck": 12, "OP RShoulder": 17,
    "OP RElbow": 19, "OP RWrist": 21, "OP LShoulder": 16,
    "OP LElbow": 18, "OP LWrist": 20, "OP MidHip": 0,
    "OP RHip": 2, "OP RKnee": 5, "OP RAnkle": 8,
    "OP LHip": 1, "OP LKnee": 4, "OP LAnkle": 7,
    "OP REye": 25, "OP LEye": 26, "OP REar": 27,
    "OP LEar": 28, "OP LBigToe": 29, "OP LSmallToe": 30,
    "OP LHeel": 31, "OP RBigToe": 32, "OP RSmallToe": 33, "OP RHeel": 34,
    "Right Ankle": 8, "Right Knee": 5, "Right Hip": 45,
    "Left Hip": 46, "Left Knee": 4, "Left Ankle": 7,
    "Right Wrist": 21, "Right Elbow": 19, "Right Shoulder": 17,
    "Left Shoulder": 16, "Left Elbow": 18, "Left Wrist": 20,
    "Neck (LSP)": 47, "Top of Head (LSP)": 48,
    "Pelvis (MPII)": 49, "Thorax (MPII)": 50,
    "Spine (H36M)": 51, "Jaw (H36M)": 52,
    "Head (H36M)": 53, "Nose": 24, "Left Eye": 26,
    "Right Eye": 25, "Left Ear": 28, "Right Ear": 27,
}

JOINT_NAMES = [
    "OP Nose", "OP Neck", "OP RShoulder",
    "OP RElbow", "OP RWrist", "OP LShoulder",
    "OP LElbow", "OP LWrist", "OP MidHip",
    "OP RHip", "OP RKnee", "OP RAnkle",
    "OP LHip", "OP LKnee", "OP LAnkle",
    "OP REye", "OP LEye", "OP REar",
    "OP LEar", "OP LBigToe", "OP LSmallToe",
    "OP LHeel", "OP RBigToe", "OP RSmallToe", "OP RHeel",
    "Right Ankle", "Right Knee", "Right Hip",
    "Left Hip", "Left Knee", "Left Ankle",
    "Right Wrist", "Right Elbow", "Right Shoulder",
    "Left Shoulder", "Left Elbow", "Left Wrist",
    "Neck (LSP)", "Top of Head (LSP)",
    "Pelvis (MPII)", "Thorax (MPII)",
    "Spine (H36M)", "Jaw (H36M)",
    "Head (H36M)", "Nose", "Left Eye",
    "Right Eye", "Left Ear", "Right Ear",
]

H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]
H36M_TO_J14 = H36M_TO_J17[:14]

# Surface-vertex keypoint ids on the SMPL mesh: face(5) + feet(6) + hand
# tips(10), appended after the 24 skeleton joints.
VERTEX_JOINT_IDS = np.array(
    [
        332, 6260, 2800, 4071, 583,
        3216, 3226, 3387, 6617, 6624, 6787,
        2746, 2319, 2445, 2556, 2673,
        6191, 5782, 5905, 6016, 6133,
    ],
    dtype=np.int32,
)

NUM_SMPL_JOINTS = 24
NUM_BETAS = 10
NUM_VERTS = 6890

# The SMPL kinematic tree (parent of joint i; -1 = root).
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9,
     12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int32,
)


def _default_joint_map() -> tuple:
    return tuple(JOINT_MAP[name] for name in JOINT_NAMES)


class SmplModel(nn.Module):
    """SMPL tensors as buffers (float32), plus the static tree and maps.

    Shapes (V vertices, J = 24, 10 betas):
      v_template (V, 3); shapedirs (V, 3, 10); posedirs (207, V*3);
      j_regressor (J, V); lbs_weights (V, J); j_regressor_extra (9, V).
    `lbs_weights_t` is the (J, V) transpose, made contiguous once here so
    the skinning kernel's neighbouring threads read neighbouring addresses.
    """

    def __init__(self, v_template: torch.Tensor, shapedirs: torch.Tensor,
                 posedirs: torch.Tensor, j_regressor: torch.Tensor,
                 lbs_weights: torch.Tensor, j_regressor_extra: torch.Tensor,
                 parents: Sequence[int], vertex_joint_ids: Sequence[int],
                 joint_map: Optional[Sequence[int]] = None):
        super().__init__()
        self.register_buffer("v_template", v_template)
        self.register_buffer("shapedirs", shapedirs)
        self.register_buffer("posedirs", posedirs)
        self.register_buffer("j_regressor", j_regressor)
        self.register_buffer("lbs_weights", lbs_weights)
        self.register_buffer("j_regressor_extra", j_regressor_extra)
        self.register_buffer("lbs_weights_t", lbs_weights.t().contiguous(),
                             persistent=False)
        self.parents = tuple(int(p) for p in parents)
        self.vertex_joint_ids = tuple(int(v) for v in vertex_joint_ids)
        self.joint_map = tuple(joint_map or _default_joint_map())
        dev = v_template.device
        self.register_buffer("_parent_idx", torch.tensor(
            self.parents[1:], dtype=torch.long, device=dev), persistent=False)
        self.register_buffer("_vertex_joint_idx", torch.tensor(
            self.vertex_joint_ids, dtype=torch.long, device=dev),
            persistent=False)
        self.register_buffer("_joint_map_idx", torch.tensor(
            self.joint_map, dtype=torch.long, device=dev), persistent=False)

    @classmethod
    def from_numpy(cls, *, v_template, shapedirs, posedirs, j_regressor,
                   lbs_weights, j_regressor_extra,
                   parents: Sequence[int] = tuple(SMPL_PARENTS.tolist()),
                   vertex_joint_ids: Sequence[int] = tuple(
                       VERTEX_JOINT_IDS.tolist()),
                   joint_map: Optional[Sequence[int]] = None,
                   device: torch.device | str = "cpu") -> "SmplModel":
        """Build from array-likes, e.g. the JAX `SmplModel`'s fields."""
        def f32(a):
            return torch.as_tensor(np.array(a, np.float32), device=device)

        return cls(f32(v_template), f32(shapedirs), f32(posedirs),
                   f32(j_regressor), f32(lbs_weights), f32(j_regressor_extra),
                   parents, vertex_joint_ids, joint_map)

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]


def load_smpl_assets(npz_path: str, device: torch.device | str,
                     allow_missing_extra: bool = False) -> SmplModel:
    """Load a converted SMPL `.npz` (see `tepose_tpu_torch.convert_smpl`).

    The extra-joint regressor is required unless `allow_missing_extra`:
    without it joints 45-53 of the 49-joint output would silently be zeros.
    """
    with np.load(npz_path) as z:
        if "j_regressor_extra" in z:
            j_extra = z["j_regressor_extra"]
        elif allow_missing_extra:
            j_extra = np.zeros((9, z["v_template"].shape[0]), np.float32)
        else:
            raise KeyError(
                f"{npz_path} has no 'j_regressor_extra' — re-run "
                "python -m tepose_tpu_torch.convert_smpl with "
                "--j-regressor-extra "
                "J_regressor_extra.npy; without it joints 45-53 of the "
                "49-joint output are zeros. Pass allow_missing_extra=True to "
                "load anyway.")
        parents = (tuple(np.asarray(z["parents"]).astype(int).tolist())
                   if "parents" in z else tuple(SMPL_PARENTS.tolist()))
        return SmplModel.from_numpy(
            v_template=z["v_template"],
            shapedirs=np.asarray(z["shapedirs"], np.float32)[..., :NUM_BETAS],
            posedirs=z["posedirs"], j_regressor=z["j_regressor"],
            lbs_weights=z["lbs_weights"], j_regressor_extra=j_extra,
            parents=parents, device=device)


def load_smpl_faces(npz_path: str) -> np.ndarray:
    """Triangle faces (F, 3) for rendering/export; empty if absent."""
    with np.load(npz_path) as z:
        if "faces" in z:
            return np.asarray(z["faces"], np.int32)
    return np.zeros((0, 3), np.int32)


def hull_faces(model: SmplModel) -> np.ndarray:
    """Faces for a model without any: the convex hull of its template, as
    the JAX `demo.py` and `evaluate.py` build for the synthetic model."""
    from scipy.spatial import ConvexHull

    pts = model.v_template.detach().cpu().numpy()
    return ConvexHull(pts).simplices.astype(np.int32)


def synthetic_smpl_model(seed: int = 0, num_verts: int = NUM_VERTS,
                         device: torch.device | str = "cpu") -> SmplModel:
    """A random-but-valid SMPL-shaped model, element for element equal to
    `tepose_tpu.models.smpl.synthetic_smpl_model(seed, num_verts)`: the same
    `np.random.RandomState` stream drawn in the same order."""
    rs = np.random.RandomState(seed)
    J = NUM_SMPL_JOINTS
    v_template = rs.randn(num_verts, 3).astype(np.float32) * 0.3
    shapedirs = rs.randn(num_verts, 3, NUM_BETAS).astype(np.float32) * 0.01
    posedirs = rs.randn((J - 1) * 9, num_verts * 3).astype(np.float32) * 0.001

    def norm_rows(m):
        m = np.abs(m)
        return (m / m.sum(axis=1, keepdims=True)).astype(np.float32)

    j_regressor = norm_rows(rs.rand(J, num_verts) ** 8)
    lbs_w = norm_rows(rs.rand(num_verts, J) ** 8)
    j_extra = norm_rows(rs.rand(9, num_verts) ** 8)
    vjid = (
        tuple(VERTEX_JOINT_IDS.tolist())
        if num_verts >= NUM_VERTS
        else tuple(rs.randint(0, num_verts, size=21).tolist())
    )
    return SmplModel.from_numpy(
        v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
        j_regressor=j_regressor, lbs_weights=lbs_w, j_regressor_extra=j_extra,
        vertex_joint_ids=vjid, device=device)


def _rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                     parents: Sequence[int], parent_idx: torch.Tensor):
    """Pose the kinematic tree.

    rot_mats (B, J, 3, 3), joints (B, J, 3) rest-pose joints; `parent_idx`
    holds parents[1:] as a long tensor on the joints' device.
    Returns (posed_joints (B, J, 3), rel_transforms (B, J, 4, 4)).
    """
    B, J = joints.shape[:2]
    rel_joints = joints - torch.cat(
        [torch.zeros_like(joints[:, :1]), joints[:, parent_idx]], dim=1)
    top = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)   # (B,J,3,4)
    # bottom row [0, 0, 0, 1] made on the device: a tensor built from host
    # data would be a blocking upload, which waits for the device's queue
    local = F.pad(top, (0, 0, 0, 1))                             # (B,J,4,4)
    local[..., 3, 3] = 1.0

    results = [local[:, 0]]
    for i in range(1, J):
        results.append(results[parents[i]] @ local[:, i])
    global_tf = torch.stack(results, dim=1)

    posed_joints = global_tf[..., :3, 3]
    # Subtract the rest-pose joint's contribution so the transform maps
    # rest-pose vertices: A - pad(A @ [j, 0]).
    correction = torch.einsum("bjik,bjk->bji", global_tf[..., :3, :3], joints)
    rel = torch.cat(
        [torch.cat([global_tf[..., :3, :3],
                    (global_tf[..., :3, 3] - correction)[..., None]], dim=-1),
         global_tf[..., 3:, :]], dim=-2)
    return posed_joints, rel


def smpl_forward(model: SmplModel, betas: torch.Tensor, pose: torch.Tensor,
                 pose2rot: bool = False):
    """SMPL forward.

    betas (B, 10); pose (B, 24, 3, 3) rotation matrices, or (B, 72)
    axis-angle with `pose2rot`. Returns a dict with verts (B, V, 3),
    joints49 (B, 49, 3) and joints24 (B, 24, 3), in the model's dtype:
    bf16 inputs are cast to it at this boundary.
    """
    B = betas.shape[0]
    rot_mats = (batch_rodrigues(pose.reshape(B, NUM_SMPL_JOINTS, 3))
                if pose2rot else pose)
    dtype = model.v_template.dtype
    betas, rot_mats = betas.to(dtype), rot_mats.to(dtype)

    # 1. Shape blendshapes.
    v_shaped = model.v_template + torch.einsum(
        "bl,mkl->bmk", betas, model.shapedirs)
    # 2. Rest-pose joints from the shaped mesh.
    joints_rest = torch.einsum("jv,bvk->bjk", model.j_regressor, v_shaped)
    # 3. Pose-corrective blendshapes over the 23 body joints.
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)       # (B, 207)
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(B, -1, 3)
    # 4. Kinematic chain.
    posed_joints, rel_tf = _rigid_transform(rot_mats, joints_rest,
                                            model.parents, model._parent_idx)
    # 5. Linear blend skinning (the CUDA kernel on a CUDA device).
    verts = lbs_skinning(model.lbs_weights_t, rel_tf.contiguous(),
                         v_posed.contiguous())
    # 6. Skeleton(24) + surface keypoints(21) + 9 regressed joints, reordered
    #    to the 49-joint output.
    vertex_joints = verts[:, model._vertex_joint_idx]
    extra_joints = torch.einsum("jv,bvk->bjk", model.j_regressor_extra, verts)
    joints54 = torch.cat([posed_joints, vertex_joints, extra_joints], dim=1)
    return {
        "verts": verts,
        "joints49": joints54[:, model._joint_map_idx],
        "joints24": posed_joints,
    }


def joint_reduction_tensors(model: SmplModel):
    """The 49-joint output's dependence on the mesh folded into small
    tensors (`tepose_tpu/models/smpl.py::joint_reduction_tensors`).

    The 30 non-skeleton joints are linear in the posed vertices (21 vertex
    picks, 9 rows of `j_regressor_extra`); folding that (30, V) selection
    through the skinning weights gives per-(joint, bone) blended rest points
    linear in betas and in the pose feature. Returns (A0 (30, 24, 3),
    AS (30, 24, 3, 10), AP (30, 24, 3, 207), W1 (30, 24)).
    """
    V = model.num_verts
    sel = torch.zeros((21, V), dtype=model.v_template.dtype,
                      device=model.v_template.device)
    sel[torch.arange(21, device=sel.device), model._vertex_joint_idx] = 1.0
    w_sel = torch.cat([sel, model.j_regressor_extra], dim=0)     # (30, V)
    WW = torch.einsum("jv,vk->jvk", w_sel, model.lbs_weights)    # (30, V, 24)
    A0 = torch.einsum("jvk,vc->jkc", WW, model.v_template)
    AS = torch.einsum("jvk,vcl->jkcl", WW, model.shapedirs)
    pd = model.posedirs.reshape(model.posedirs.shape[0], V, 3)
    AP = torch.einsum("jvk,pvc->jkcp", WW, pd)
    return A0, AS, AP, WW.sum(dim=1)


def _reduced(model: SmplModel):
    """`joint_reduction_tensors` plus the rest-joint regressions, computed
    once per model as non-persistent buffers (they follow `.to()`), outside
    autograd and inference mode so any later caller may use them."""
    if not hasattr(model, "_red_AP"):
        with torch.inference_mode(False), torch.no_grad():
            A0, AS, AP, W1 = joint_reduction_tensors(model)
            J0 = torch.einsum("jv,vk->jk", model.j_regressor,
                              model.v_template)
            JS = torch.einsum("jv,vkl->jkl", model.j_regressor,
                              model.shapedirs)
        for name, t in (("A0", A0), ("AS", AS), ("AP", AP), ("W1", W1),
                        ("J0", J0), ("JS", JS)):
            model.register_buffer(f"_red_{name}", t, persistent=False)
    return (model._red_A0, model._red_AS, model._red_AP, model._red_W1,
            model._red_J0, model._red_JS)


def smpl_joints_reduced(model: SmplModel, betas: torch.Tensor,
                        rot_mats: torch.Tensor) -> torch.Tensor:
    """The 49-joint output without the mesh
    (`tepose_tpu/models/smpl.py::smpl_joints_reduced`): the LBS algebra
    reordered through `joint_reduction_tensors`, equal to
    `smpl_forward(...)["joints49"]` within float reassociation. The train
    step takes it, so neither its forward nor its backward skins.
    betas (B, 10); rot_mats (B, 24, 3, 3). Returns (B, 49, 3) in the
    model's dtype. Under bf16 compute the inputs are bf16: the pose feature
    is taken in bf16 and everything after it runs in the model's float32,
    where JAX promotes against its float32 SMPL tensors."""
    B = betas.shape[0]
    A0, AS, AP, W1, J0, JS = _reduced(model)
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1).to(A0.dtype)
    betas, rot_mats = betas.to(A0.dtype), rot_mats.to(A0.dtype)
    joints_rest = J0 + torch.einsum("bl,jkl->bjk", betas, JS)
    posed_joints, rel_tf = _rigid_transform(rot_mats, joints_rest,
                                            model.parents, model._parent_idx)
    # blended rest points per (selected joint, bone): linear in betas and
    # in the pose feature
    p_sel = (A0 + torch.einsum("bl,jkcl->bjkc", betas, AS)
             + torch.einsum("bp,jkcp->bjkc", pose_feature, AP))   # (B,30,24,3)
    joints_sel = (torch.einsum("bkic,bjkc->bji", rel_tf[..., :3, :3], p_sel)
                  + torch.einsum("jk,bki->bji", W1, rel_tf[..., :3, 3]))
    joints54 = torch.cat([posed_joints, joints_sel], dim=1)
    return joints54[:, model._joint_map_idx]


@functools.cache
def _subset_index(subset: tuple, device: torch.device) -> torch.Tensor:
    """`subset` as a long tensor on `device`, made once: indexing with a
    Python list uploads it at every call, a blocking copy that waits for the
    device's queue and that a CUDA graph cannot capture."""
    with torch.inference_mode(False):
        return torch.tensor(subset, device=device)


def regress_h36m_joints(verts: torch.Tensor, j_regressor_h36m: torch.Tensor,
                        subset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """17-joint H36M regression off the posed mesh, optionally subset."""
    joints = torch.einsum("jv,bvk->bjk", j_regressor_h36m, verts)
    if subset is not None:
        joints = joints[:, _subset_index(tuple(subset), joints.device)]
    return joints
