"""The program under test, `tepose_tpu_torch`, built from the benchmark's
weights.

Each module is made on the meta device (its own initialisation draws
nothing there), moved to the card empty and loaded with the weights of
`bench_h100.weights`. The program gets copies: nothing it does to its
tensors reaches the dicts the reference reads.
"""

from __future__ import annotations

from typing import Dict

import torch

from bench_h100 import weights as W
from bench_h100.reference import tables as T


def _on_meta(make):
    with torch.device("meta"):
        return make(torch.Generator())


def _load(module, w: Dict[str, torch.Tensor], device):
    module = module.to_empty(device=device)
    module.load_state_dict(w, strict=True)
    return module.eval()


def shapes(module) -> list:
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()]


def tepose_module(config: dict):
    from tepose_tpu_torch.models.tepose import TePose, TePoseConfig

    cfg = TePoseConfig(seqlen=config["seqlen"], n_layers=config["n_layers"],
                       hidden_size=config["hidden_size"])
    return _on_meta(lambda g: TePose(cfg, generator=g, device="meta"))


def vibe_module(config: dict):
    from tepose_tpu_torch.models.tepose import Vibe, VibeConfig

    v = config["vibe"]
    cfg = VibeConfig(seqlen=v["seqlen"], n_layers=v["n_layers"],
                     hidden_size=v["hidden_size"], add_linear=v["add_linear"],
                     bidirectional=v["bidirectional"],
                     use_residual=v["use_residual"])
    return _on_meta(lambda g: Vibe(cfg, generator=g, device="meta"))


def resnet_module():
    from tepose_tpu_torch.models.backbone import ResNet50

    return _on_meta(lambda g: ResNet50(device="meta"))


def smpl_module(s: Dict[str, torch.Tensor]):
    from tepose_tpu_torch.models.smpl import SmplModel

    return SmplModel(*(s[k].clone() for k in (
        "v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
        "j_regressor_extra")), T.PARENTS, T.VERTEX_JOINT_IDS, T.JOINT_MAP)


class Models:
    """The benchmark's weights for one configuration (`w`, the dicts the
    reference reads) and the program's modules loaded with copies of them.
    `parts` names the modules a cell needs: "tepose", "vibe", "resnet"."""

    def __init__(self, config: dict, seed: int, device, parts,
                 num_verts: int = T.NUM_VERTS):
        self.w: Dict[str, Dict[str, torch.Tensor]] = {}
        self.smpl_w = W.make_smpl(seed, device, num_verts)
        self.smpl = smpl_module(self.smpl_w)
        makers = {"tepose": lambda: tepose_module(config),
                  "vibe": lambda: vibe_module(config),
                  "resnet": resnet_module}
        self.modules = {}
        for part in parts:
            meta = makers[part]()
            self.w[part] = W.make_weights(shapes(meta), seed, part, device,
                                          **config.get("weights", {}))
            self.modules[part] = _load(
                meta, {k: v.clone() for k, v in self.w[part].items()}, device)

    def free(self) -> None:
        """Drop the program's modules, keeping the weights."""
        self.modules.clear()
        self.smpl = None
