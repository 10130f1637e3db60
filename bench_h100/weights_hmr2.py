"""HMR 2.0's weights made on the device from a seed.

The leaves are the program's `state_dict` names, which are 4D-Humans'
(`backbone.blocks.{i}.attn.qkv.weight`, `smpl_head.decpose.bias`, ...), cut
from two large draws on the card (a `torch.Generator` there, the stream
"hmr2" of the run's seed) and scaled leaf by leaf to the published random
initialisation: in the ViT (`backbone.`) truncated normal (std 0.02) for
the linears' weights and `pos_embed`, zero linear biases, PyTorch's default
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the patch convolution; in the head
(`smpl_head.`) PyTorch's defaults, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
the linears' weights and biases and N(0, 1) for `pos_embedding`, with
Xavier-uniform weights of gain `head_gain` on `decpose`, `decshape` and
`deccam` (published 0.01; the configuration's `weights` may set it);
LayerNorm (1, 0) everywhere; and the mean parameters the IEF step starts
from: identity rotations in HMR 2.0's 6D layout (a1 = x[:3], a2 = x[3:],
so [1, 0, 0, 0, 1, 0] a joint), zero betas, camera (0.9, 0, 0).

The same dict goes to the program (loaded into its module) and to the
reference (`reference/hmr2.py`), which reads it by those names.
"""

from __future__ import annotations

import math
import re
from typing import Dict

import torch

from bench_h100.weights import Shapes, generator

MEAN_POSE6D = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0] * 24
MEAN_CAM = [0.9, 0.0, 0.0]
DECODERS = ("smpl_head.decpose.weight", "smpl_head.decshape.weight",
            "smpl_head.deccam.weight")
_NORM = re.compile(r"(^|\.)(norm\d?|last_norm)\.(weight|bias)$")


def _kind(name: str, shape: tuple) -> str:
    """How leaf `name` is drawn: "one", "zero", "normal" (times a scale
    `_scale` gives), "uniform" or a constant."""
    if _NORM.search(name):
        return "one" if name.endswith(".weight") else "zero"
    if name.startswith("smpl_head.init_"):
        return "const"
    if name in ("backbone.pos_embed", "smpl_head.transformer.pos_embedding"):
        return "normal"
    if name.startswith("backbone.") and "patch_embed" not in name:
        return "normal" if name.endswith(".weight") else "zero"
    return "uniform"


def _scale(name: str, shapes: Dict[str, tuple], head_gain: float) -> float:
    """The standard deviation of a normal leaf, the bound of a uniform
    one."""
    if name == "smpl_head.transformer.pos_embedding":
        return 1.0
    if name.startswith("backbone.") and "patch_embed" not in name:
        return 0.02
    w = shapes[name.rsplit(".", 1)[0] + ".weight"]
    fan_in = math.prod(w[1:])
    if name in DECODERS:
        return head_gain * math.sqrt(6.0 / (fan_in + w[0]))
    return 1.0 / math.sqrt(fan_in)


def make_hmr2_weights(shapes: Shapes, seed: int, device,
                      head_gain: float = 0.01) -> Dict[str, torch.Tensor]:
    """Leaves `shapes` (name, shape) of HMR 2.0, on `device`."""
    shapes = {n: tuple(s) for n, s in shapes}
    kinds = {n: _kind(n, s) for n, s in shapes.items()}
    g = generator(seed, "hmr2", device)

    def draw(kind, fn):
        names = [n for n in shapes if kinds[n] == kind]
        flat = fn(sum(math.prod(shapes[n]) for n in names))
        out, ofs = {}, 0
        for n in names:
            k = math.prod(shapes[n])
            out[n] = (flat[ofs:ofs + k]
                      * _scale(n, shapes, head_gain)).reshape(shapes[n])
            ofs += k
        return out

    out = draw("normal", lambda k: torch.randn(k, generator=g, device=device))
    for n, v in out.items():
        if n.startswith("backbone."):
            v.clamp_(-2.0, 2.0)      # timm's trunc_normal_ bounds
    out.update(draw("uniform", lambda k: torch.rand(
        k, generator=g, device=device) * 2.0 - 1.0))
    for n, kind in kinds.items():
        if kind in ("one", "zero"):
            out[n] = torch.full(shapes[n], float(kind == "one"),
                                device=device)
    init = {"smpl_head.init_body_pose": MEAN_POSE6D,
            "smpl_head.init_betas": [0.0] * 10,
            "smpl_head.init_cam": MEAN_CAM}
    for n, v in init.items():
        if n in shapes:
            out[n] = torch.tensor([v], device=device)
    missing = set(shapes) - set(out)
    if missing:
        raise ValueError(f"no initialisation for {sorted(missing)}")
    return out
