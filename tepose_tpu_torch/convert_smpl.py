"""Convert official SMPL pickle models to the `.npz` format both packages
read.

A copy of `tools/convert_smpl.py` (the package does not reach into
`tools/`), pinned equal to it by tests/test_torch_release.py:

  python -m tepose_tpu_torch.convert_smpl SMPL_NEUTRAL.pkl \
      data/base_data/smpl_neutral.npz \
      [--j-regressor-extra J_regressor_extra.npy]

The SMPL body model files are license-gated (https://smpl.is.tue.mpg.de)
and must be downloaded by the user. The official pickles embed `chumpy`
arrays; a small import shim unpickles them without the chumpy package.
SPIN's J_regressor_extra.npy is bundled into the output when given.
"""

import argparse
import os
import os.path as osp
import pickle
import sys
import types

import numpy as np


class _ChumpyShim:
    """Unpickles chumpy.Ch arrays as plain objects exposing .r / asarray."""

    def __init__(self, *args, **kwargs):
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        self.__dict__.update(state)

    @property
    def r(self):
        for key in ("x", "a", "v"):
            if key in self.__dict__:
                return np.asarray(self.__dict__[key])
        raise AttributeError("no data in chumpy shim")


def _install_chumpy_shim():
    ch = types.ModuleType("chumpy")
    ch.Ch = _ChumpyShim
    ch_ch = types.ModuleType("chumpy.ch")
    ch_ch.Ch = _ChumpyShim
    ch.ch = ch_ch
    ch_r = types.ModuleType("chumpy.reordering")
    for name in ("Select", "transpose", "Transpose"):
        setattr(ch_r, name, _ChumpyShim)
    sys.modules.setdefault("chumpy", ch)
    sys.modules.setdefault("chumpy.ch", ch_ch)
    sys.modules.setdefault("chumpy.reordering", ch_r)


def to_np(x) -> np.ndarray:
    if hasattr(x, "toarray"):  # scipy sparse (J_regressor often is)
        return np.asarray(x.toarray())
    if isinstance(x, _ChumpyShim):
        return np.asarray(x.r)
    return np.asarray(x)


def convert(pkl_path: str, out_path: str,
            j_regressor_extra: str = "") -> None:
    _install_chumpy_shim()
    with open(pkl_path, "rb") as f:
        data = pickle.load(f, encoding="latin1")

    v_template = to_np(data["v_template"]).astype(np.float32)     # (6890, 3)
    shapedirs = to_np(data["shapedirs"]).astype(np.float32)       # (6890,3,10+)
    posedirs = to_np(data["posedirs"]).astype(np.float32)         # (6890,3,207)
    # our layout: (207, 6890*3) so pose_feature @ posedirs is one matmul
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T.copy()
    j_regressor = to_np(data["J_regressor"]).astype(np.float32)   # (24, 6890)
    lbs_weights = to_np(data["weights"]).astype(np.float32)       # (6890, 24)
    parents = np.asarray(data["kintree_table"])[0].astype(np.int64)
    parents[0] = -1
    faces = to_np(data["f"]).astype(np.int32)

    out = {
        "v_template": v_template,
        "shapedirs": shapedirs,
        "posedirs": posedirs,
        "j_regressor": j_regressor,
        "lbs_weights": lbs_weights,
        "parents": parents.astype(np.int32),
        "faces": faces,
    }
    if j_regressor_extra:
        if not osp.isfile(j_regressor_extra):
            # a silent skip here would produce an npz load_smpl_assets
            # rejects (extra joints 45-53 would be zeros) — fail at the
            # conversion step where the typo is fixable
            raise FileNotFoundError(
                f"--j-regressor-extra: {j_regressor_extra!r} not found")
        out["j_regressor_extra"] = np.load(j_regressor_extra).astype(
            np.float32)
    else:
        print("warning: no --j-regressor-extra given; the output npz will "
              "need load_smpl_assets(allow_missing_extra=True) and extra "
              "joints 45-53 will be zeros")

    os.makedirs(osp.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **out)
    print(f"wrote {out_path}: "
          + ", ".join(f"{k}{v.shape}" for k, v in out.items()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("src", help="SMPL .pkl (e.g. SMPL_NEUTRAL.pkl)")
    ap.add_argument("dst", help="output .npz path")
    ap.add_argument("--j-regressor-extra", default="",
                    help="SPIN J_regressor_extra.npy to bundle")
    args = ap.parse_args()
    convert(args.src, args.dst, args.j_regressor_extra)


if __name__ == "__main__":
    main()
