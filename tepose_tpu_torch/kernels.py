"""Build and load the port's CUDA kernels.

Each kernel is CUDA C++ under `csrc/` with a plain C interface. At first use
it is compiled by `nvcc` for sm_90a into a shared library under
`build/tepose_tpu_torch/` at the repository root (listed in `.gitignore`)
and loaded with ctypes. The library's name carries a hash of its sources and
flags, so an edited source builds anew. Concurrent builds (pytest-xdist
workers) write to a temporary name and `os.replace` it into place.

Nothing falls back: a missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "tepose_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# seconds the last `build` of each library took in this process
BUILD_SECONDS: dict[str, float] = {}


def find_nvcc() -> str:
    """Path of `nvcc`: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda: the "
        "port's CUDA kernels are built from source at first use")


def library_path(name: str, sources: list[str]) -> Path:
    """Where the library built from `sources` (file names in csrc/) lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.encode())
        h.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str, sources: list[str]) -> Path:
    """Compile `sources` into lib<name>_<hash>.so unless it is there; the
    seconds it took (finding it, or compiling it) go to BUILD_SECONDS."""
    t0 = time.perf_counter()
    out = library_path(name, sources)
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(CSRC_DIR / s) for s in sources]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


@functools.cache
def lbs_library() -> ctypes.CDLL:
    """The LBS skinning library, built on first call, with typed entries."""
    lib = ctypes.CDLL(str(build("tepose_lbs", ["lbs_skinning.cu"])))
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.tepose_lbs_skin_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.tepose_lbs_skin_f32.restype = i
    lib.tepose_lbs_blocks_per_sm.argtypes = [i, i, i]
    lib.tepose_lbs_blocks_per_sm.restype = i
    lib.tepose_cuda_error_string.argtypes = [i]
    lib.tepose_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def vit_library() -> ctypes.CDLL:
    """The ViT's 3xTF32 GEMM library, built on first call, with typed
    entries."""
    lib = ctypes.CDLL(str(build("tepose_vit_gemm", ["vit_gemm_3xtf32.cu"])))
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.tepose_vit_linear_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.tepose_vit_linear_f32.restype = i
    lib.tepose_vit_error_string.argtypes = [i]
    lib.tepose_vit_error_string.restype = ctypes.c_char_p
    return lib


def build_all() -> None:
    """Build and load every kernel library of the port."""
    lbs_library()
    vit_library()
