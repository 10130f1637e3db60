"""DB access: joblib `.pt` dictionaries + pseudo-theta files.

A copy of `tepose_tpu/data/db.py` (`train_db_paths`, `eval_db_paths`,
`load_db`, `load_pseudotheta`, `key_eval_db_by_video`), pinned equal to it
by tests/test_torch_eval.py and tests/test_torch_train_loop.py, except that
the files are read by `read_joblib`, which needs no joblib: the DBs and
pseudo-thetas are uncompressed joblib dumps of numpy arrays. The port writes
them with `write_db` (`save_db` for a DB), as plain pickles, which
`joblib.load` reads as well.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from typing import Any, Dict, Optional

import numpy as np

from tepose_tpu_torch.config import TePose_DB_DIR


def train_db_paths(load_opt: str, dataset_name: str, split: str = "train",
                   db_dir: Optional[str] = None):
    """(db_file, pseudotheta_file) per config TITLE x dataset.

    ref: dataset_3d.py:93-153, dataset_2d.py:56-73 — the per-experiment DB
    variant matrix (occlusion-augmented, scale, tight-bbox variants).
    """
    d = db_dir or TePose_DB_DIR
    name = f"{dataset_name}_{split}"
    variant = ""
    if split == "train":
        table = {
            "repr_wpw_3dpw_model": {
                "3dpw": "_occ", "mpii3d": "_scale12_occ", "h36m": "_25fps_occ",
                "posetrack": "_occ"},
            "repr_wpw_h36m_mpii3d_model": {
                "3dpw": "", "mpii3d": "_scale12", "h36m": "_25fps",
                "posetrack": ""},
            "repr_wopw_3dpw_model": {
                "mpii3d": "_scale12_new_occ", "h36m": "_25fps_occ",
                "posetrack": "_occ"},
            "repr_wopw_h36m_model": {
                "mpii3d": "_scale1", "h36m": "_25fps_tight", "posetrack": ""},
            "repr_wopw_mpii3d_model": {
                "mpii3d": "_scale12", "h36m": "_25fps", "posetrack": ""},
        }
        variant = table.get(load_opt, {}).get(dataset_name, "")
    elif split == "val":
        if dataset_name == "mpii3d":
            variant = "_scale12"
        elif dataset_name == "h36m" and load_opt == "repr_wopw_h36m_model":
            name = f"{dataset_name}_test"
            variant = "_front_25fps_tight"
    db_file = osp.join(d, f"{name}{variant}_db.pt")
    pse_file = osp.join(d, f"{name}{variant}_pseudotheta.pt")
    return db_file, pse_file


def eval_db_paths(dataset: str, title: str, render: bool = False,
                  db_dir: Optional[str] = None):
    """Benchmark-eval DB paths (ref: evaluate.py:146-166)."""
    d = db_dir or TePose_DB_DIR
    if dataset == "3dpw":
        opt = "_all" if render else ""
        stem = f"3dpw_test{opt}"
    elif dataset == "h36m":
        if title == "repr_wpw_h36m_mpii3d_model":
            stem = "h36m_test_25fps_nosmpl"
        else:  # repr_wopw_h36m_model
            stem = "h36m_test_front_25fps_tight_nosmpl"
    elif dataset == "mpii3d":
        stem = "mpii3d_val_scale12"
    else:
        raise ValueError(f"unknown eval dataset {dataset!r}")
    return osp.join(d, f"{stem}_db.pt"), osp.join(d, f"{stem}_pseudotheta.pt")


# magic numbers of joblib's compressed formats (joblib/compressor.py)
_COMPRESSED_MAGIC = {b"ZF": "joblib < 0.10 zfile", b"\x78": "zlib",
                     b"\x1f\x8b": "gzip", b"BZ": "bz2",
                     b"\xfd\x37\x7a\x58\x5a": "xz", b"\x5d\x00": "lzma",
                     b"\x04\x22\x4d\x18": "lz4"}


class _ArrayHeader:
    """Unpickled in place of joblib's `NumpyArrayWrapper`: the shape,
    order and dtype of the array whose bytes follow it in the file."""

    def __setstate__(self, state):
        self.__dict__.update(state)


class _JoblibUnpickler(pickle._Unpickler):
    """joblib's uncompressed format is a pickle in which each numpy array is
    a `NumpyArrayWrapper` object followed, after its BUILD opcode, by the
    array's raw bytes (plain dtypes: one pad-length byte, that much
    padding when `numpy_array_alignment_bytes` is set, then the elements in
    the wrapper's `order`) or by a nested pickle (object dtypes). BUILD
    replaces the header on the stack with the array read from the file."""

    dispatch = pickle._Unpickler.dispatch.copy()

    def __init__(self, f, name: str):
        super().__init__(f)
        self._f, self._name = f, name

    def find_class(self, module, name):
        if module.split(".")[0] == "joblib":
            if name == "NumpyArrayWrapper":
                return _ArrayHeader
            raise ValueError(f"{self._name}: joblib object {module}.{name} "
                             "is not readable without joblib")
        return super().find_class(module, name)

    def _read_array(self, h: _ArrayHeader) -> np.ndarray:
        dtype = np.dtype(h.dtype)
        if dtype.hasobject:
            arr = pickle.load(self._f)
        else:
            if getattr(h, "numpy_array_alignment_bytes", None) is not None:
                pad = self._f.read(1)
                self._f.read(pad[0] if pad else 0)
            count = int(np.prod(h.shape, dtype=np.int64))
            buf = bytearray(count * dtype.itemsize)
            if self._f.readinto(buf) != len(buf):
                raise EOFError(f"{self._name}: truncated array data")
            arr = np.frombuffer(buf, dtype, count)
            arr = (arr.reshape(h.shape[::-1]).T if h.order == "F"
                   else arr.reshape(h.shape))
        if not arr.dtype.isnative:
            arr = arr.astype(arr.dtype.newbyteorder("="))
        return arr

    def load_build(self):
        super().load_build()
        if isinstance(self.stack[-1], _ArrayHeader):
            self.stack[-1] = self._read_array(self.stack[-1])

    dispatch[pickle.BUILD[0]] = load_build


def read_joblib(path: str) -> Any:
    """What `joblib.load(path)` returns for an uncompressed joblib dump or a
    plain pickle, read without joblib. A compressed dump raises."""
    with open(path, "rb") as f:
        head = f.read(8)
        for magic, kind in _COMPRESSED_MAGIC.items():
            if head.startswith(magic):
                raise ValueError(
                    f"{path} is a {kind}-compressed joblib file; the port "
                    "reads uncompressed dumps only: rewrite it with "
                    "joblib.dump(joblib.load(path), path) where joblib is "
                    "installed")
        f.seek(0)
        return _JoblibUnpickler(f, path).load()


# protocol 4 pickles objects over 4 GB (a whole dataset's features)
PICKLE_PROTOCOL = 4


def write_db(obj: Any, path: str) -> str:
    """Write a DB dict or a pseudo-theta array as a plain pickle (protocol
    4), where `joblib.dump` wrote a joblib file
    (`tools/preprocess/common.py::save_db`, `pseudo_theta.py`).
    `joblib.load`, `read_joblib` and `pickle.load` all read it. The file
    appears whole: it is written under a temporary name and renamed."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(obj, f, protocol=PICKLE_PROTOCOL)
        os.replace(tmp, path)
    finally:
        if osp.exists(tmp):
            os.unlink(tmp)
    return path


def save_db(dataset: Dict[str, np.ndarray], name: str,
            db_dir: Optional[str] = None) -> str:
    """`<db_dir>/<name>_db.pt` (default TEPOSE_DB_DIR), as
    `tools/preprocess/common.py::save_db` names and reports it."""
    d = db_dir or TePose_DB_DIR
    os.makedirs(d, exist_ok=True)
    path = osp.join(d, f"{name}_db.pt")
    for k, v in dataset.items():
        print(f"  {k}: {np.asarray(v).shape}")
    write_db(dataset, path)
    print(f"Saved DB to {path}")
    return path


def load_db(db_file: str) -> Dict[str, np.ndarray]:
    if not osp.isfile(db_file):
        raise FileNotFoundError(f"{db_file} does not exist — run the "
                                "preprocessing tools (python -m "
                                "tepose_tpu_torch.preprocess.<dataset>) or "
                                "point TEPOSE_DB_DIR at your DB directory")
    return read_joblib(db_file)


def load_pseudotheta(pse_file: str) -> np.ndarray:
    if not osp.isfile(pse_file):
        raise FileNotFoundError(f"{pse_file} does not exist — generate it "
                                "with python -m "
                                "tepose_tpu_torch.preprocess.pseudo_theta")
    return read_joblib(pse_file)


def key_eval_db_by_video(db: Dict[str, np.ndarray], psetheta: np.ndarray,
                         target_action: str = "",
                         is_mpii3d: bool = False) -> Dict[str, Dict]:
    """Group an eval DB into per-video dicts with validity masking and the
    pseudo-theta camera forced to [1, 0, 0] (ref: evaluate.py:171-207)."""
    pse = psetheta.copy()
    pse[:, :3] = np.array([1.0, 0.0, 0.0], pse.dtype)

    out: Dict[str, Dict] = {}
    for name in np.unique(db["vid_name"]):
        if target_action and target_action not in str(name):
            continue
        sel = db["vid_name"] == name
        if "valid" in db:
            valids = db["valid"][sel].astype(bool)
        else:
            valids = np.ones(int(sel.sum()), bool)
        entry = {
            "features": db["features"][sel][valids],
            "joints3D": db["joints3D"][sel][valids],
            "vid_name": db["vid_name"][sel][valids],
            "imgname": db["img_name"][sel][valids]
            if "img_name" in db else None,
            "bbox": db["bbox"][sel][valids] if "bbox" in db else None,
            "theta_pseu": pse[sel][valids],
        }
        n = int(valids.sum())
        if is_mpii3d:
            entry["pose"] = np.zeros((n, 72), np.float32)
            entry["shape"] = np.zeros((n, 10), np.float32)
            entry["valid_i"] = db["valid_i"][sel][valids]
        else:
            entry["pose"] = db["pose"][sel][valids]
            entry["shape"] = db["shape"][sel][valids]
        out[str(name)] = entry
    return out
