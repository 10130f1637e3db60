"""LBS skinning: the CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of `tepose_tpu/ops/lbs_pallas.py::lbs_skinning_pallas` (the
repository's one Pallas TPU kernel). The kernel is `csrc/lbs_skinning.cu`,
built by `tepose_tpu_torch.kernels`; its source notes what bounds it.

`lbs_skinning` dispatches on where its tensors lie: on the CPU it computes
`lbs_skinning_reference`, the einsum of `tepose_tpu/models/smpl.py:338-341`;
on a CUDA device it launches the kernel or raises. There is no fallback from
the kernel to the einsum. Forward only: the CUDA path refuses inputs that
require grad while grad is enabled (training reads joints through the
vertex-free path and never skins the mesh).
"""

from __future__ import annotations

import ctypes

import torch

# Number of kernel launches, bumped where the kernel is launched and nowhere
# else, so a run can show that its path went through the kernel.
LAUNCHES = 0

MAX_JOINTS = 32
MAX_BATCH = 65535  # gridDim.y


def lbs_skinning_reference(wT: torch.Tensor, rel_tf: torch.Tensor,
                           v_posed: torch.Tensor) -> torch.Tensor:
    """Plain version: wT (J, V), rel_tf (B, J, 4, 4), v_posed (B, V, 3)."""
    T = torch.einsum("jv,bjik->bvik", wT, rel_tf)  # (B, V, 4, 4)
    return (torch.einsum("bvik,bvk->bvi", T[..., :3, :3], v_posed)
            + T[..., :3, 3])


def _check_shapes(wT, rel_tf, v_posed):
    if wT.dim() != 2 or rel_tf.dim() != 4 or v_posed.dim() != 3:
        raise ValueError(
            f"lbs_skinning expects wT (J, V), rel_tf (B, J, 4, 4), v_posed "
            f"(B, V, 3); got {tuple(wT.shape)}, {tuple(rel_tf.shape)}, "
            f"{tuple(v_posed.shape)}")
    J, V = wT.shape
    B = v_posed.shape[0]
    if tuple(rel_tf.shape) != (B, J, 4, 4) or tuple(v_posed.shape) != (B, V, 3):
        raise ValueError(
            f"lbs_skinning shape mismatch: wT {tuple(wT.shape)}, rel_tf "
            f"{tuple(rel_tf.shape)}, v_posed {tuple(v_posed.shape)}")
    return B, V, J


def lbs_skinning(wT: torch.Tensor, rel_tf: torch.Tensor,
                 v_posed: torch.Tensor) -> torch.Tensor:
    """Skinned vertices (B, V, 3) from wT (J, V), rel_tf (B, J, 4, 4) and
    v_posed (B, V, 3)."""
    global LAUNCHES
    B, V, J = _check_shapes(wT, rel_tf, v_posed)
    devices = {t.device for t in (wT, rel_tf, v_posed)}
    if devices == {torch.device("cpu")}:
        return lbs_skinning_reference(wT, rel_tf, v_posed)
    if len(devices) != 1 or wT.device.type != "cuda":
        raise ValueError(f"lbs_skinning needs all inputs on one CUDA device "
                         f"or all on the CPU; got {sorted(map(str, devices))}")
    for name, t in (("wT", wT), ("rel_tf", rel_tf), ("v_posed", v_posed)):
        if t.dtype != torch.float32:
            raise TypeError(f"lbs_skinning kernel takes float32; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lbs_skinning kernel needs contiguous inputs; "
                             f"{name} has strides {t.stride()}")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("lbs_skinning kernel is forward only; "
                               f"{name} requires grad")
    if not 1 <= J <= MAX_JOINTS:
        raise ValueError(f"lbs_skinning kernel takes 1..{MAX_JOINTS} joints, "
                         f"got {J}")
    if B > MAX_BATCH:
        raise ValueError(f"lbs_skinning kernel takes at most {MAX_BATCH} "
                         f"samples per call, got {B}")

    from tepose_tpu_torch.kernels import lbs_library

    lib = lbs_library()
    out = torch.empty((B, V, 3), dtype=torch.float32, device=v_posed.device)
    stream = torch.cuda.current_stream(v_posed.device).cuda_stream
    err = lib.tepose_lbs_skin_f32(
        ctypes.c_void_p(wT.data_ptr()), ctypes.c_void_p(rel_tf.data_ptr()),
        ctypes.c_void_p(v_posed.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        B, V, J, ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.tepose_cuda_error_string(err).decode()
        raise RuntimeError(f"lbs_skinning kernel launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out
