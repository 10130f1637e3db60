"""Weights and SMPL tensors made on the device from a seed.

Each model's leaves are cut from one large draw on the card (a
`torch.Generator` there), scaled leaf by leaf to the initialisation the
published models use: He-normal convolutions with zero biases (ResNet-50
with its BatchNorm folded in), U(-1/sqrt(H), 1/sqrt(H)) for GRUs,
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for linears, Xavier-uniform with gain
0.01 for the regressor's output heads, and the regressor's initial pose
(identity rotations), shape (zeros) and camera (0.9, 0, 0). The
configuration may scale the ResNet-50 stem (`stem_gain`): with zero biases
the backbone is positively homogeneous, so the stem's scale is the
features' scale and changes nothing else. The SMPL tensors
are drawn as a random but valid body model of 6,890 vertices: a template,
shape and pose blend shapes, and row-normalised joint regressors and
skinning weights.

The same dicts go to the program (loaded into its modules) and to the
reference, which reads them by the models' torch names.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterable, Tuple

import torch

from bench_h100.reference import tables as T

Shapes = Iterable[Tuple[str, Tuple[int, ...]]]


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of draws of a run's seed."""
    h = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def _fan_in(shapes: Dict[str, tuple], name: str) -> int:
    """Inputs of the layer that leaf `name` belongs to."""
    base = name.rsplit(".", 1)[0]
    if ".gru" in name:
        # a GRU leaf: 1 / sqrt(H) for every tensor of the GRU
        key = name.rsplit(".", 1)[1]
        sfx = key.split("_", 2)[2] if key.count("_") >= 2 else ""
        hh = f"{base}.weight_hh_{sfx}"
        return shapes[hh][1]
    w = shapes.get(f"{base}.weight")
    return w[1] if w is not None else shapes[name][1]


def make_weights(shapes: Shapes, seed: int, stream: str, device,
                 stem_gain: float = 1.0) -> Dict[str, torch.Tensor]:
    """Leaves `shapes` (name, shape) of one model, on `device`; the
    ResNet-50 stem's weights are `stem_gain` times He-normal."""
    shapes = dict(shapes)
    g = generator(seed, stream, device)
    uniform = [n for n in shapes if not n.endswith((".w", ".b"))
               and not n.startswith("regressor.init_")]
    normal = [n for n in shapes if n.endswith(".w")]
    count = lambda names: sum(math.prod(shapes[n]) for n in names)  # noqa
    u = torch.rand(count(uniform), generator=g, device=device) * 2.0 - 1.0
    z = torch.randn(count(normal), generator=g, device=device)

    out, ofs = {}, 0
    for n in uniform:
        k = math.prod(shapes[n])
        if n.startswith("regressor.dec") and n.endswith(".weight"):
            o, i = shapes[n]
            limit = 0.01 * math.sqrt(6.0 / (i + o))
        else:
            limit = 1.0 / math.sqrt(_fan_in(shapes, n))
        out[n] = (u[ofs:ofs + k] * limit).reshape(shapes[n])
        ofs += k
    ofs = 0
    for n in normal:
        k = math.prod(shapes[n])
        fan_in = math.prod(shapes[n][1:])
        gain = stem_gain if n == "stem.w" else 1.0
        out[n] = (z[ofs:ofs + k] * gain
                  * math.sqrt(2.0 / fan_in)).reshape(shapes[n])
        ofs += k
    for n in shapes:
        if n.endswith(".b"):
            out[n] = torch.zeros(shapes[n], device=device)
    init = {"regressor.init_pose": [1.0, 0.0, 0.0, 1.0, 0.0, 0.0] * 24,
            "regressor.init_shape": [0.0] * 10,
            "regressor.init_cam": [0.9, 0.0, 0.0]}
    for n, v in init.items():
        if n in shapes:
            out[n] = torch.tensor([v], device=device)
    missing = set(shapes) - set(out)
    if missing:
        raise ValueError(f"no initialisation for {sorted(missing)}")
    return out


def make_smpl(seed: int, device, num_verts: int = T.NUM_VERTS
              ) -> Dict[str, torch.Tensor]:
    """A random SMPL-shaped body model of `num_verts` vertices and the H36M
    joint regressor `j_h36m` (17, V)."""
    g = generator(seed, "smpl", device)
    V, J = num_verts, T.NUM_JOINTS
    z = torch.randn(V * 3 + V * 3 * T.NUM_BETAS + (J - 1) * 9 * V * 3,
                    generator=g, device=device)
    a, b = V * 3, V * 3 + V * 3 * T.NUM_BETAS
    u = torch.rand(J * V + V * J + 9 * V + 17 * V, generator=g,
                   device=device) ** 8

    def rows(x, n, m):
        x = x.reshape(n, m)
        return x / x.sum(dim=1, keepdim=True)

    c = [0, J * V, 2 * J * V, 2 * J * V + 9 * V, 2 * J * V + 26 * V]
    return {
        "v_template": z[:a].reshape(V, 3) * 0.3,
        "shapedirs": z[a:b].reshape(V, 3, T.NUM_BETAS) * 0.01,
        "posedirs": z[b:].reshape((J - 1) * 9, V * 3) * 0.001,
        "j_regressor": rows(u[c[0]:c[1]], J, V),
        "lbs_weights": rows(u[c[1]:c[2]], V, J),
        "j_regressor_extra": rows(u[c[2]:c[3]], 9, V),
        "j_h36m": rows(u[c[3]:c[4]], 17, V),
    }
