#!/usr/bin/env python
"""Write the JAX golden of the InstaVariety path without h5py
(`chip_smoke.py` phase 15), and the MATLAB v7.3-style `annot_data.mat`
that the MPI-INF-3DHP test reader is held to.

The GPU host has neither JAX nor h5py, so this script runs the JAX tools
here, on the CPU, through h5py, on inputs and weights the port rebuilds
from seeds alone:

  * a small InstaVariety tfrecord set (`fabricate_insta`): 3 shards, 25
    videos of 10-22 frames (one too short to keep: 24 kept, so a batch of
    19 InstaVariety rows finds one video each), 120 x 160 frames
    PNG-encoded (lossless, so any decoder gives the same pixels) and 25
    'insta' keypoints a frame, some frames with no visible keypoint (the
    builder drops them), written with the port's TFRecord codec;
  * the preprocess golden's ResNet-50, VIBE (2 x 1024) and SMPL (6890
    vertices), from `tools/make_torch_preprocess_golden.py`'s seeds;
  * `MPII3D_ANNOT`, written by `write_matlab_annot` (h5py behind a 512-byte
    MATLAB header, deflate-chunked, as MATLAB stores the arrays) and
    committed; its frames come from a numpy seed (`mpii3d_frames`).

The JAX InstaVariety builder (`tools/preprocess/insta.py::read_data`)
writes the DB with h5py; the golden keeps its arrays (`db/*`), the JAX
pseudo-thetas over it at VIBE batch 450 (`pseudo_theta`), the JAX `Insta`
items at `ITEMS` (`item<i>/*`, from the DB and its pseudo-theta sidecar),
the JAX MPI-INF-3DHP test reader's DB on `MPII3D_ANNOT` (`mpii3d/*`), the
spec, the weights' checksums and the inputs' SHA-256.

  python tools/make_torch_insta_golden.py   # writes GOLDEN_PATH (~1 min)
  python tools/make_torch_insta_golden.py annot   # rewrites MPII3D_ANNOT

Only `jax_outputs`, `write_matlab_annot` and `main` import JAX or h5py,
so the rest imports on the GPU host.
"""

from __future__ import annotations

import hashlib
import json
import os
import os.path as osp
import sys
import tempfile
from typing import Dict, List

import numpy as np

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
for _p in (REPO, osp.join(REPO, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import make_torch_preprocess_golden as pg  # noqa: E402

GOLDEN_PATH = osp.join(REPO, "tests", "golden", "torch_port_insta_f32.npz")
MPII3D_ANNOT = osp.join(REPO, "tests", "golden", "mpii3d_annot_data.mat")

# arrays the builders compute on the host from the same inputs: equal
HOST_KEYS = ("vid_name", "frame_id", "joints2D", "bbox")
MPII3D_HOST_KEYS = ("vid_name", "frame_id", "joints2D", "joints3D", "bbox",
                    "valid_i", "img_name")
FEATURE_RTOL = pg.FEATURE_RTOL    # of the features' largest magnitude
# pseudo-thetas on the same features, of the golden's largest |theta|: the
# ResNet-50 features (~3e3) drive thetas to ~21, where float32 spaces values
# 1.9e-6 apart, so phase 11b's absolute 1e-6 (thetas < 1) is under one ulp;
# chip_smoke.py phase 15b shows that TF32 misses this bar
THETA_RTOL = 1e-5

# the models of the preprocess golden (phase 11), and the InstaVariety set
SPEC = dict({k: pg.FULL_SPEC[k] for k in (
    "num_verts", "smpl_seed", "backbone_seed", "vibe_seed", "vibe_n_layers",
    "vibe_hidden_size", "vibe_batch")},
    insta_seed=21, height=120, width=160,
    videos=[[18, 6, 12, 21, 15, 10, 19, 14, 22],
            [20, 11, 16, 13, 22, 17, 12, 18],
            [10, 21, 15, 19, 13, 20, 16, 14]], hide_every=17,
    item_seqlen=6, item_vidlen=24, items=[0, 6, 13],
    mpii3d_seed=23, mpii3d_frames=8)


def _frames(rs: np.random.RandomState, n: int, h: int, w: int) -> np.ndarray:
    """(n, h, w, 3) uint8: 8 x 8 blocks of random colour over a ramp, so
    the PNGs stay small."""
    blocks = rs.randint(0, 200, (n, h // 8, w // 8, 3))
    img = blocks.repeat(8, 1).repeat(8, 2)
    ramp = (np.arange(w) * 50 // w)[None, None, :, None]
    return (img + ramp).astype(np.uint8)


def _png(img: np.ndarray) -> bytes:
    """RGB uint8 -> PNG bytes (zlib, no image library)."""
    import struct
    import zlib

    h, w, _ = img.shape
    raw = b"".join(b"\0" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


def decode_png(buf: bytes) -> np.ndarray:
    """A PNG written by `_png` (8-bit RGB, no filters) -> RGB uint8
    (H, W, 3): what cv2 decodes from it, without an image library."""
    import struct
    import zlib

    p, w, h, idat = 8, 0, 0, b""
    while p < len(buf):
        n, tag = struct.unpack(">I4s", buf[p:p + 8])
        data = buf[p + 8:p + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", data[:8])
            if data[8:13] != bytes([8, 2, 0, 0, 0]):
                raise ValueError("decode_png reads 8-bit RGB PNGs only")
        elif tag == b"IDAT":
            idat += data
        p += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    if rows[:, 0].any():
        raise ValueError("decode_png reads unfiltered rows only")
    return rows[:, 1:].reshape(h, w, 3).copy()


def _example(insta, frames: List[bytes], xys: np.ndarray,
             vis: np.ndarray) -> bytes:
    """One InstaVariety SequenceExample through the codec's encoder (as
    tests/test_builders.py::_make_insta_example)."""
    T = len(frames)
    return insta.serialize_sequence_example(
        {"image/encoded": [insta.feature_bytes([f]) for f in frames],
         "image/xys": [insta.feature_floats(xys[t]) for t in range(T)],
         "image/vis": [insta.feature_ints(vis[t]) for t in range(T)]},
        context={"meta/N": insta.feature_ints([T])})


def fabricate_insta(root: str, spec: Dict = SPEC) -> str:
    """The tfrecord shards under `root/insta/train/`; returns `root/insta`
    (the builder's `--dir`). A person walks across each video; every
    `hide_every`-th frame has no visible keypoint, and the 6-frame video is
    shorter than the builder's minimum of 8 frames."""
    from tepose_tpu_torch.preprocess import insta

    rs = np.random.RandomState(spec["insta_seed"])
    H, W = spec["height"], spec["width"]
    folder = osp.join(root, "insta")
    os.makedirs(osp.join(folder, "train"), exist_ok=True)
    for shard, lengths in enumerate(spec["videos"]):
        records = []
        for T in lengths:
            imgs = _frames(rs, T, H, W)
            centre = np.stack([np.linspace(0.3, 0.7, T) * W,
                               np.full(T, 0.5 * H)], 1)
            xys = (centre[:, :, None]
                   + rs.randn(T, 2, 25) * [[W / 10], [H / 5]]).astype(
                np.float32)
            vis = (rs.rand(T, 25) > 0.15).astype(np.int64)
            vis[::spec["hide_every"]] = 0
            records.append(_example(insta, [_png(f) for f in imgs], xys,
                                    vis))
        insta.write_tfrecord(osp.join(folder, "train",
                                      f"shard{shard}.tfrecord"), records)
    return folder


def mpii3d_frames(spec: Dict = SPEC) -> np.ndarray:
    """The MPI-INF-3DHP test frames, (T, 96, 128, 3) uint8."""
    rs = np.random.RandomState(spec["mpii3d_seed"])
    return _frames(rs, spec["mpii3d_frames"], 96, 128)


def write_mpii3d_test_set(root: str, spec: Dict = SPEC) -> str:
    """`root/mpii3d/mpi_inf_3dhp_test_set/TS1/` with the committed
    `annot_data.mat` and the frames it indexes (PNG bytes under the `.jpg`
    names the reader opens); returns `root/mpii3d`."""
    import shutil

    ts = osp.join(root, "mpii3d", "mpi_inf_3dhp_test_set", "TS1")
    os.makedirs(osp.join(ts, "imageSequence"), exist_ok=True)
    shutil.copyfile(MPII3D_ANNOT, osp.join(ts, "annot_data.mat"))
    for i, img in enumerate(mpii3d_frames(spec)):
        with open(osp.join(ts, "imageSequence", f"img_{i + 1:06d}.jpg"),
                  "wb") as f:
            f.write(_png(img))
    return osp.join(root, "mpii3d")


def write_matlab_annot(path: str, spec: Dict = SPEC) -> None:
    """A MATLAB v7.3 `annot_data.mat` in miniature: HDF5 after a 512-byte
    MATLAB header, each array deflate-chunked and stored as MATLAB stores
    it (dimensions reversed: annot2 (T, 1, 17, 2), univ_annot3
    (T, 1, 17, 3), valid_frame (1, T)), with MATLAB_class attributes."""
    import h5py

    rs = np.random.RandomState(spec["mpii3d_seed"] + 1)
    T = spec["mpii3d_frames"]
    a2 = np.stack([64 + rs.randn(T, 1, 17) * 14,
                   48 + rs.randn(T, 1, 17) * 12], -1)
    a3 = rs.randn(T, 1, 17, 3) * 300 + [0, 0, 4000]
    valid = (rs.rand(1, T) > 0.3).astype(np.float64)
    tmp = path + ".tmp"
    with h5py.File(tmp, "w", userblock_size=512, track_order=False) as m:
        for name, a in (("annot2", a2), ("univ_annot3", a3),
                        ("valid_frame", valid)):
            chunks = (1, 4) if name == "valid_frame" else (2,) + a.shape[1:]
            d = m.create_dataset(name, data=a, chunks=chunks,
                                 compression="gzip", track_times=False)
            d.attrs["MATLAB_class"] = np.bytes_(b"double")
    header = (b"MATLAB 7.3 MAT-file, Platform: GLNXA64, Created on: "
              b"fabricated for tests, HDF5 schema 1.00 .").ljust(116, b" ")
    with open(tmp, "r+b") as f:
        f.write(header + b"\0" * 8 + b"\x00\x02IM")
    os.replace(tmp, path)


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def input_checksums(insta_dir: str) -> Dict[str, str]:
    """SHA-256 of each tfrecord shard, the committed annot file and the
    MPI-INF-3DHP frames."""
    train = osp.join(insta_dir, "train")
    out = {f: sha256(osp.join(train, f)) for f in sorted(os.listdir(train))}
    out["annot_data.mat"] = sha256(MPII3D_ANNOT)
    out["mpii3d_frames"] = hashlib.sha256(mpii3d_frames().tobytes()
                                          ).hexdigest()
    return out


def item_keys() -> tuple:
    return ("features", "kp_2d", "theta_pseu", "switch_id", "vidlen_each")


def jax_outputs(workdir: str) -> Dict[str, np.ndarray]:
    """The JAX builder, pseudo-thetas, `Insta` items and MPI-INF-3DHP test
    reader (strict float32, CPU) on the port's weights."""
    import jax
    import joblib

    from tepose_tpu.data.datasets import Insta
    from tepose_tpu.models.smpl import synthetic_smpl_model
    from tepose_tpu.models.tepose import VibeConfig
    from tepose_tpu_torch.weights import jax_tree_from_state_dict

    sys.path.insert(0, osp.join(REPO, "tools", "preprocess"))
    import insta as J_insta
    import mpii3d as J_mpii3d
    from pseudo_theta import pseudo_thetas_for_features

    spec = dict(pg.FULL_SPEC, **{k: SPEC[k] for k in SPEC
                                 if k in pg.FULL_SPEC})
    setup = pg.port_setup(spec, "cpu")
    backbone, vibe = (jax_tree_from_state_dict(setup[k].state_dict())
                      for k in ("backbone", "vibe"))
    smpl = synthetic_smpl_model(spec["smpl_seed"], spec["num_verts"])
    vcfg = VibeConfig(seqlen=16, n_layers=spec["vibe_n_layers"],
                      hidden_size=spec["vibe_hidden_size"], add_linear=True)
    folder = fabricate_insta(workdir)
    db_path = osp.join(workdir, "insta_train_db.h5")
    out = {}
    with jax.default_matmul_precision("float32"):
        J_insta.read_data(folder, db_path, backbone=backbone)
        import h5py
        with h5py.File(db_path, "r") as f:
            for k in f:
                out[f"db/{k}"] = f[k][()]
        thetas = pseudo_thetas_for_features(
            out["db/vid_name"], out["db/features"], vibe, smpl, vcfg,
            spec["vibe_batch"])
        out["pseudo_theta"] = np.asarray(thetas, np.float32)
        joblib.dump(out["pseudo_theta"],
                    osp.join(workdir, "insta_train_pseudotheta.pt"))
        ds = Insta("x", SPEC["item_seqlen"], SPEC["item_vidlen"],
                   h5_path=db_path)
        out["n_items"] = np.asarray(len(ds))
        for i in SPEC["items"]:
            item = ds[i]
            for k in item_keys():
                out[f"item{i}/{k}"] = np.asarray(item[k])
        root = write_mpii3d_test_set(workdir)
        db = J_mpii3d.read_test_data(root, backbone=backbone)
    for k, v in db.items():
        v = np.asarray(v)
        if k == "img_name":
            v = np.array([osp.relpath(p, root) for p in v])
        out[f"mpii3d/{k}"] = v
    out["input_sha256"] = np.asarray(json.dumps(
        input_checksums(folder), sort_keys=True))
    return out


def load_golden(path: str = GOLDEN_PATH) -> Dict:
    with np.load(path, allow_pickle=False) as z:
        golden = {k: z[k] for k in z.files}
    golden["spec"] = json.loads(str(golden["spec"]))
    golden["input_sha256"] = json.loads(str(golden["input_sha256"]))
    return golden


def main():
    if sys.argv[1:] == ["annot"]:
        write_matlab_annot(MPII3D_ANNOT)
        print(f"wrote {MPII3D_ANNOT} ({osp.getsize(MPII3D_ANNOT)} bytes)")
        return
    import jax

    jax.config.update("jax_platforms", "cpu")
    if not osp.isfile(MPII3D_ANNOT):
        write_matlab_annot(MPII3D_ANNOT)
    with tempfile.TemporaryDirectory() as tmp:
        golden = jax_outputs(tmp)
    golden["spec"] = np.asarray(json.dumps(SPEC, sort_keys=True))
    spec = dict(pg.FULL_SPEC, **{k: SPEC[k] for k in SPEC
                                 if k in pg.FULL_SPEC})
    golden["weight_checksums"] = pg.weight_checksums(pg.port_setup(spec,
                                                                   "cpu"))
    tmp = GOLDEN_PATH + ".tmp.npz"
    np.savez_compressed(tmp, **golden)
    os.replace(tmp, GOLDEN_PATH)
    print(f"wrote {GOLDEN_PATH} ({osp.getsize(GOLDEN_PATH)} bytes): "
          + ", ".join(f"{k} {np.shape(v)}" for k, v in golden.items()))


if __name__ == "__main__":
    main()
