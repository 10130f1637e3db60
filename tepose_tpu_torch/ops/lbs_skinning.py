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

The kernel keeps each thread's vertex weights in registers across a run of
samples. It is compiled for four vertices per thread at 24 joints (SMPL),
for batches of `FOUR_VERTEX_MIN_BATCH` samples or more, and for one vertex
per thread at 24 and at 32 joints, which takes any other count in 1..32 with
the missing joints zero. `_launch_config` picks the launch shape from
(B, V, J) and the SM count in Python, so the CPU tests can check the index
arithmetic.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

# Number of kernel launches, bumped where the kernel is launched and nowhere
# else, so a run can show that its path went through the kernel.
LAUNCHES = 0

MAX_JOINTS = 32
MAX_GRID_Y = 65_535
# Threads of a block, by vertices per thread, as csrc/lbs_skinning.cu's
# __launch_bounds__ allow them (four blocks an SM fit by registers).
THREADS = {1: 128, 4: 64}
BLOCKS_PER_SM = 4
# From this batch size up a thread blends four vertices (24 joints only):
# below it, latency and not the FMA rate sets the time.
FOUR_VERTEX_MIN_BATCH = 16


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """One launch of the kernel: grid (tiles, groups) of blocks of
    `threads`, each thread `verts_per_thread` vertices of every sample of
    its block's group."""
    threads: int
    verts_per_thread: int
    tiles: int
    groups: int

    @property
    def tile(self) -> int:
        """Vertices of one block."""
        return self.threads * self.verts_per_thread


def smem_bytes(J: int) -> int:
    """Static shared memory of one block: two samples' transforms, 12 floats
    a joint, for the joint count the kernel is instantiated for."""
    return 4 * 2 * 12 * (24 if J == 24 else MAX_JOINTS)


def sample_range(group: int, B: int, groups: int) -> tuple[int, int]:
    """Samples [begin, end) of sample group `group`, as the kernel splits B:
    runs of B // groups, the first B % groups of them one longer."""
    per, extra = divmod(B, groups)
    begin = group * per + min(group, extra)
    return begin, begin + per + (group < extra)


@functools.cache
def _launch_config(B: int, V: int, J: int, num_sms: int) -> LaunchConfig:
    """Four vertices per thread for 24 joints from FOUR_VERTEX_MIN_BATCH
    samples up, else one; as many sample groups as fill one wave of
    BLOCKS_PER_SM blocks on each of `num_sms` SMs, at most one per sample
    (more groups split the samples finer but load each block's weights
    again)."""
    vpt = 4 if J == 24 and B >= FOUR_VERTEX_MIN_BATCH else 1
    threads = THREADS[vpt]
    tiles = math.ceil(V / (threads * vpt))
    groups = max(1, min(B, MAX_GRID_Y, BLOCKS_PER_SM * num_sms // tiles))
    return LaunchConfig(threads, vpt, tiles, groups)


@functools.cache
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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

    out = torch.empty((B, V, 3), dtype=torch.float32, device=v_posed.device)
    if B == 0 or V == 0:
        return out
    return _launch(wT, rel_tf, v_posed, out,
                   _launch_config(B, V, J, _num_sms(v_posed.device)))


def _launch(wT, rel_tf, v_posed, out, cfg: LaunchConfig) -> torch.Tensor:
    """Launch the kernel with shape `cfg` on inputs `lbs_skinning` checked."""
    global LAUNCHES
    from tepose_tpu_torch.kernels import lbs_library

    lib = lbs_library()
    J, V = wT.shape
    stream = torch.cuda.current_stream(v_posed.device).cuda_stream
    err = lib.tepose_lbs_skin_f32(
        ctypes.c_void_p(wT.data_ptr()), ctypes.c_void_p(rel_tf.data_ptr()),
        ctypes.c_void_p(v_posed.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        v_posed.shape[0], V, J, cfg.threads, cfg.verts_per_thread,
        cfg.groups, ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.tepose_cuda_error_string(err).decode()
        raise RuntimeError(f"lbs_skinning kernel launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out
