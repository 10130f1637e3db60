"""The comparison that decides `correct`.

A cell's driver hands over what the program produced and what the
reference computes from the same inputs, each as a dict of tensors on one
device:

  rot       (N, 24, 3, 3) rotations: the program's are its axis-angle pose
            through Rodrigues' formula, so the sign an axis-angle takes near
            pi does not count;
  camshape  (N, 13) the weak-perspective camera and the 10 shape values;
  kp_3d     (N, K, 3) joints, metres;
  verts     (N, V, 3) mesh vertices, metres (where the cell serves them);
  mpjpe_mm, pa_mpjpe_mm, mpvpe_mm (N,) per-frame eval metrics (eval).

`gaps` turns the pair into the numbers compared, each against the limit in
`limits/<workload>.json`. A NaN anywhere reads as a gap of NaN, which no
limit passes.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _absmax(x: torch.Tensor) -> float:
    return float(x.abs().max()) if x.numel() else 0.0


def _rel(judged: torch.Tensor, ref: torch.Tensor) -> float:
    scale = _absmax(ref)
    return _absmax(judged.double() - ref.double()) / max(scale, 1e-30)


def gaps(judged: Dict[str, torch.Tensor],
         ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Largest gaps of `judged` from `ref`: `verts_rel` and `joints_rel`
    relative to the reference's largest magnitude, `theta_gap` the larger
    of the rotations' absolute gap and the camera and shape's relative one,
    and the eval metrics' absolute gaps in mm."""
    out = {}
    if "verts" in ref:
        out["verts_rel"] = _rel(judged["verts"], ref["verts"])
    out["joints_rel"] = _rel(judged["kp_3d"], ref["kp_3d"])
    out["theta_gap"] = max(_absmax(judged["rot"].double()
                                   - ref["rot"].double()),
                           _rel(judged["camshape"], ref["camshape"]))
    for k in ("mpvpe_mm", "mpjpe_mm", "pa_mpjpe_mm"):
        if k in ref:
            out[k] = _absmax(judged[k].double() - ref[k].double())
    for k, judged_t in judged.items():
        if not bool(torch.isfinite(judged_t).all()):
            out = {name: math.nan for name in out}
    return out


def within(values: Dict[str, float], limits: Dict[str, dict]) -> bool:
    """True when every number has a limit and is at or under it."""
    return bool(values) and all(
        name in limits and v <= limits[name]["limit"]
        for name, v in values.items())
