"""ViT-H's linear layers: the 3xTF32 CUDA GEMM's wrapper and its plain
PyTorch version.

`vit_linear(x, weight, bias, gelu=..., residual=...)` computes
`epi(x @ weight.T + bias)` for x (..., K) and an `nn.Linear` weight (N, K),
where `epi` is nothing (`attn.qkv`), the exact GELU (`mlp.fc1`) or
`residual + ...` (`attn.proj` and `mlp.fc2`, the block's `x + ...`).

It dispatches on where its tensors lie: on the CPU (and on the meta
device, for shapes) it computes `vit_linear_reference` (`F.linear`, then
`F.gelu` or the residual add); on a CUDA device it launches
`csrc/vit_gemm_3xtf32.cu` or raises. There is no fallback from the
kernel. The kernel replaces no TPU kernel (the JAX package
has no ViT): it takes the ViT's products off cuBLAS's SIMT SGEMM onto the
tensor cores at float32 accuracy; its source notes the split and the
design. Forward only.

The launch goes through the dispatcher operator `tepose::vit_linear_3xtf32`,
so a profiler credits the kernels to the host events around the call (the
spans `hmr2.*`), as it credits cuBLAS's kernels to `aten::linear`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

# Number of kernel launches, bumped where the kernel is launched and nowhere
# else, so a run can show that its path went through the kernel.
LAUNCHES = 0

BLOCK_M = 128           # rows of an output tile (two consumer warpgroups)
K_MULTIPLE = 32         # columns of K a pipeline stage holds
BLOCK_NS = (128, 64)    # the tile widths it is built for, widest first
# A 64-wide tile's time per column over a 128-wide one's: 1.26-1.30 at the
# ViT's four shapes at M = 24,576 on an H100 (the wider tile reads and
# splits the X fragment once for twice the columns).
NARROW_TILE_COST = 1.3

EPILOGUES = {"bias": 0, "gelu": 1, "residual": 2}


def vit_linear_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor | None = None, *,
                         gelu: bool = False,
                         residual: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Plain version: `F.linear`, then the exact GELU or `residual + out`."""
    out = F.linear(x, weight, bias)
    if gelu:
        out = F.gelu(out)
    if residual is not None:
        out = residual + out
    return out


def block_n(M: int, N: int, num_sms: int) -> int:
    """The tile width for an (M, N) output: of the widths in `BLOCK_NS`
    that divide N, the one whose waves of tiles over `num_sms` SMs cost
    least, a wave of 64-wide tiles counted `NARROW_TILE_COST` times half a
    wave of 128-wide ones; the widest on a tie. Where none divides N, the
    narrowest, which `check_shapes` then refuses."""
    def cost(bn):
        waves = math.ceil(math.ceil(M / BLOCK_M) * (N // bn) / num_sms)
        return waves * bn * (1.0 if bn == BLOCK_NS[0] else NARROW_TILE_COST)
    widths = [bn for bn in BLOCK_NS if N % bn == 0] or [min(BLOCK_NS)]
    return min(widths, key=cost)


def check_shapes(M: int, N: int, K: int, bn: int) -> None:
    """What the kernel takes, as its C entry checks it: M >= 1, K a positive
    multiple of `K_MULTIPLE`, N a multiple of the tile width `bn`."""
    if M < 1:
        raise ValueError(f"vit_linear kernel needs at least one row; got "
                         f"M={M}")
    if K < K_MULTIPLE or K % K_MULTIPLE:
        raise ValueError(f"vit_linear kernel takes K in multiples of "
                         f"{K_MULTIPLE}; got K={K}")
    if bn not in BLOCK_NS or N % bn:
        raise ValueError(f"vit_linear kernel takes N in multiples of its "
                         f"tile width {bn}; got N={N}")


def _check_tensors(x, weight, bias, residual) -> None:
    """Device, dtype, layout and shapes the CUDA path takes."""
    named = [("x", x), ("weight", weight), ("bias", bias),
             ("residual", residual)]
    named = [(n, t) for n, t in named if t is not None]
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"vit_linear needs all inputs on one device; got "
                         f"{sorted(map(str, devices))}")
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"vit_linear kernel takes float32; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"vit_linear kernel needs contiguous inputs; "
                             f"{name} has strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"vit_linear kernel needs 16-byte aligned "
                             f"inputs; {name} is at {t.data_ptr():#x}")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"vit_linear kernel is forward only; {name} "
                               f"requires grad")


def _shapes(x, weight, bias, residual) -> tuple[int, int, int]:
    """(M, N, K) of a call, or ValueError."""
    if weight.dim() != 2 or x.dim() < 1 or x.shape[-1] != weight.shape[1]:
        raise ValueError(f"vit_linear expects x (..., K) and weight (N, K); "
                         f"got {tuple(x.shape)} and {tuple(weight.shape)}")
    N, K = weight.shape
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"vit_linear expects bias ({N},); got "
                         f"{tuple(bias.shape)}")
    out_shape = (*x.shape[:-1], N)
    if residual is not None and tuple(residual.shape) != out_shape:
        raise ValueError(f"vit_linear expects residual {out_shape}; got "
                         f"{tuple(residual.shape)}")
    return x.numel() // K if K else 0, N, K


def vit_linear(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None = None, *, gelu: bool = False,
               residual: torch.Tensor | None = None) -> torch.Tensor:
    """`epi(x @ weight.T + bias)` of shape (..., N): the plain version on
    the CPU, the 3xTF32 kernel on a CUDA device (module docstring)."""
    if gelu and residual is not None:
        raise ValueError("vit_linear takes one epilogue: gelu or residual")
    M, N, K = _shapes(x, weight, bias, residual)
    tensors = [t for t in (x, weight, bias, residual) if t is not None]
    if all(t.device.type in ("cpu", "meta") for t in tensors):
        return vit_linear_reference(x, weight, bias, gelu=gelu,
                                    residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"vit_linear needs all inputs on one CUDA device "
                         f"or all on the CPU; x is on {x.device}")
    _check_tensors(x, weight, bias, residual)
    bn = block_n(M, N, _num_sms(x.device))
    check_shapes(M, N, K, bn)
    epilogue = ("gelu" if gelu else
                "residual" if residual is not None else "bias")
    y = _operator()[1](x, weight, bias, residual, EPILOGUES[epilogue], bn)
    return y.view(*x.shape[:-1], N)


@functools.cache
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _operator():
    """`tepose::vit_linear_3xtf32(x, weight, bias, residual, epilogue,
    block_n) -> Tensor`, defined at first use, its CUDA kernel
    `_launch`: a profiler credits a kernel to the operator on the host's
    stack at its launch."""
    lib = torch.library.Library("tepose", "FRAGMENT")
    lib.define("vit_linear_3xtf32(Tensor x, Tensor weight, Tensor? bias, "
               "Tensor? residual, int epilogue, int block_n) -> Tensor")
    lib.impl("vit_linear_3xtf32", _launch, "CUDA")
    return lib, torch.ops.tepose.vit_linear_3xtf32


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launch(x, weight, bias, residual, epilogue: int,
            bn: int) -> torch.Tensor:
    """Split W and launch the product on inputs `vit_linear` checked."""
    global LAUNCHES
    from tepose_tpu_torch.kernels import vit_library

    lib = vit_library()
    N, K = weight.shape
    M = x.numel() // K
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    w_split = torch.empty((2, N, K), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tepose_vit_linear_f32(
            _ptr(x), _ptr(weight), _ptr(w_split), _ptr(bias), _ptr(residual),
            _ptr(y), M, N, K, epilogue, bn, ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.tepose_vit_error_string(err).decode()
        raise RuntimeError(f"vit_linear kernel launch failed: {msg} ({err})")
    LAUNCHES += 1
    return y
