"""ctypes bindings for the native host rasterizer and crops.

A copy of `tepose_tpu/native/__init__.py` (`render_mesh`, `crop_normalize`
with its `crop_u8` variant, and their numpy versions) over a copy of its
C++ source, `tepose_native.cpp`, with one difference: the library is built
at first use by g++ into `build/tepose_tpu_torch/` at the repository root
(listed in `.gitignore`), named by a hash of its source and flags as
`kernels.py` names the CUDA libraries, and nothing falls back. A missing
g++ or a failed build raises; the numpy versions
(`render_mesh_reference`, `crop_normalize_reference`) are the plain
versions the tests hold the library to and are not called by the entry
points.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "tepose_native.cpp"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]


def library_path() -> Path:
    """Where the library built from `tepose_native.cpp` lives."""
    from tepose_tpu_torch.kernels import BUILD_DIR

    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtepose_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library with g++ unless it is there; raise on failure.
    Concurrent builds write to a temporary name and `os.replace` it."""
    out = library_path()
    if out.is_file():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the port's native host "
                           "library is built from source at first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The native library, built on first call, with typed entries."""
    lib = ctypes.CDLL(str(build()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.render_mesh.argtypes = [
        f32p, ctypes.c_int, i32p, ctypes.c_int, f32p, u8p,
        ctypes.c_int, ctypes.c_int, f32p, ctypes.c_float]
    lib.render_mesh.restype = None
    lib.crop_normalize.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, f32p]
    lib.crop_normalize.restype = None
    lib.crop_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, u8p]
    lib.crop_u8.restype = None
    return lib


# ---------------------------------------------------------------------------
# numpy versions (the plain versions the library is tested against)
# ---------------------------------------------------------------------------


# Three directional lights + ambient + emissive, mirroring the reference's
# pyrender scene (ref: renderer.py:84-100) — see the comment block above
# render_mesh in tepose_native.cpp for the full mapping rationale.
_LIGHTS = np.array([[0.0, 1.0, 1.0], [0.0, -1.0, 1.0], [1.0, -1.0, 2.0]])
_LIGHTS = _LIGHTS / np.linalg.norm(_LIGHTS, axis=1, keepdims=True)
_LIGHT_INTENSITY = 0.8 / np.pi  # Lambert BRDF
_AMBIENT, _EMISSIVE = 0.3, 0.1


def _shade_from_normals(n):
    """(..., 3) interpolated (unnormalised) normals -> scalar shade."""
    nn = np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
    d = np.abs((n / nn) @ _LIGHTS.T)  # double-sided
    return np.minimum(
        1.0, _AMBIENT + _EMISSIVE + _LIGHT_INTENSITY * d.sum(-1))


def render_mesh_reference(verts, faces, cam, image, color=(1.0, 1.0, 0.9),
                          alpha: float = 0.9):
    """numpy version of `render_mesh` (in place; returns image)."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    color = np.ascontiguousarray(color, np.float32)
    h, w = image.shape[:2]
    sx, sy, tx, ty = [float(c) for c in cam]
    px = (1.0 + sx * (verts[:, 0] + tx)) * 0.5 * w
    py = (1.0 + sy * (-verts[:, 1] + ty)) * 0.5 * h
    pz = -verts[:, 2]

    zbuf = np.full((h, w), 1e30, np.float32)
    shade = np.full((h, w), -1.0, np.float32)

    # area-weighted vertex normals (smooth shading, matching the C++ path)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    vn = np.zeros_like(verts, dtype=np.float64)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)

    for f in range(len(faces)):
        a, b, c = faces[f]
        x0, y0, z0 = px[a], py[a], pz[a]
        x1, y1, z1 = px[b], py[b], pz[b]
        x2, y2, z2 = px[c], py[c], pz[c]
        xmin = max(0, int(np.floor(min(x0, x1, x2))))
        xmax = min(w - 1, int(np.ceil(max(x0, x1, x2))))
        ymin = max(0, int(np.floor(min(y0, y1, y2))))
        ymax = min(h - 1, int(np.ceil(max(y0, y1, y2))))
        if xmin > xmax or ymin > ymax:
            continue
        denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        if abs(denom) < 1e-12:
            continue
        xs, ys = np.meshgrid(np.arange(xmin, xmax + 1),
                             np.arange(ymin, ymax + 1))
        w0 = ((y1 - y2) * (xs - x2) + (x2 - x1) * (ys - y2)) / denom
        w1 = ((y2 - y0) * (xs - x2) + (x0 - x2) * (ys - y2)) / denom
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        z = w0 * z0 + w1 * z1 + w2 * z2
        sub_z = zbuf[ymin:ymax + 1, xmin:xmax + 1]
        closer = inside & (z < sub_z)
        sub_z[closer] = z[closer]
        n_pix = (w0[..., None] * vn[a] + w1[..., None] * vn[b]
                 + w2[..., None] * vn[c])
        shade[ymin:ymax + 1, xmin:xmax + 1][closer] = \
            _shade_from_normals(n_pix[closer])

    mask = shade >= 0
    mesh_rgb = (255.0 * np.asarray(color)[None, :]
                * shade[mask][:, None])
    image[mask] = np.clip(alpha * mesh_rgb + (1 - alpha) * image[mask],
                          0, 255).astype(np.uint8)
    return image


def render_mesh(verts: np.ndarray, faces: np.ndarray, cam: np.ndarray,
                image: np.ndarray, color=(1.0, 1.0, 0.9),
                alpha: float = 0.9) -> np.ndarray:
    """Z-buffered smooth-shaded mesh overlay (in place; returns image).

    Weak-perspective cam (sx, sy, tx, ty) in original-image coords
    (use streaming.demo_utils.convert_crop_cam_to_orig_img). Lighting:
    three directional lights + ambient + emissive matching the reference's
    pyrender scene (ref: renderer.py:84-100), per-pixel interpolated vertex
    normals. Pixel output is pinned by the golden images
    (tests/golden/*.png).
    """
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    cam = np.ascontiguousarray(cam, np.float32)
    color_a = np.ascontiguousarray(color, np.float32)
    image = np.ascontiguousarray(image, np.uint8)
    get_lib().render_mesh(verts, len(verts), faces, len(faces), cam, image,
                          image.shape[0], image.shape[1], color_a,
                          float(alpha))
    return image


def crop_normalize_reference(image, bboxes, out_size: int = 224,
                             scale: float = 1.2, normalize: bool = True):
    """numpy version of `crop_normalize` (and, without `normalize`, of its
    uint8 variant)."""
    from tepose_tpu_torch.models.backbone import IMAGENET_MEAN, IMAGENET_STD

    bboxes = np.asarray(bboxes, np.float32).reshape(-1, 4)
    h, w = image.shape[:2]
    n = len(bboxes)
    out = np.zeros((n, 3, out_size, out_size), np.float32)
    for i, (cx, cy, bw, bh) in enumerate(bboxes):
        bw, bh = bw * scale, bh * scale
        step_x, step_y = bw / out_size, bh / out_size
        xs = cx - bw / 2 + (np.arange(out_size) + 0.5) * step_x
        ys = cy - bh / 2 + (np.arange(out_size) + 0.5) * step_y
        gx, gy = np.meshgrid(xs, ys)
        valid = (gx >= 0) & (gx <= w - 1) & (gy >= 0) & (gy <= h - 1)
        gxc = np.clip(gx, 0, w - 1)
        gyc = np.clip(gy, 0, h - 1)
        ix, iy = gxc.astype(int), gyc.astype(int)
        fx, fy = gxc - ix, gyc - iy
        ix1 = np.minimum(ix + 1, w - 1)
        iy1 = np.minimum(iy + 1, h - 1)
        img = image.astype(np.float32)
        for ch in range(3):
            v = ((1 - fy) * ((1 - fx) * img[iy, ix, ch]
                             + fx * img[iy, ix1, ch])
                 + fy * ((1 - fx) * img[iy1, ix, ch]
                         + fx * img[iy1, ix1, ch]))
            v = np.where(valid, v, 0.0)
            if normalize:
                out[i, ch] = (v / 255.0 - IMAGENET_MEAN[ch]) \
                    / IMAGENET_STD[ch]
            else:
                out[i, ch] = v + 0.5  # truncated to uint8 below
    return out if normalize else out.astype(np.uint8)


def crop_normalize(image: np.ndarray, bboxes: np.ndarray,
                   out_size: int = 224, scale: float = 1.2,
                   normalize: bool = True) -> np.ndarray:
    """Batched bilinear bbox crops (N, 3, S, S).

    ref: _img_utils.py get_single_image_crop + transforms; bbox =
    (cx, cy, w, h) scaled by `scale`. With `normalize` the output is
    ImageNet-normalised float32; without, raw uint8, which the engine and
    the live session upload and normalise on the device.
    """
    image = np.ascontiguousarray(image, np.uint8)
    bboxes = np.ascontiguousarray(bboxes, np.float32).reshape(-1, 4)
    lib = get_lib()
    dtype = np.float32 if normalize else np.uint8
    out = np.empty((len(bboxes), 3, out_size, out_size), dtype)
    fn = lib.crop_normalize if normalize else lib.crop_u8
    fn(image, image.shape[0], image.shape[1], bboxes, len(bboxes), out_size,
       float(scale), out)
    return out
