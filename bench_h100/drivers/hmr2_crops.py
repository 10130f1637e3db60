"""HMR 2.0 on the offline engine: `StreamingEngine.run_tracklets_from_crops`
with an `HMR2` model, the engine's per-frame route.

One client in a closed loop sends clips of tracklets of uint8 crops, the
next clip once the last one's outputs are on the host. The tracklets'
lengths are the traffic file's; the crops are drawn on the card from the
seed in set-up (`clips` different clips, sent in turn) and kept in host
memory, as a demo holds its tracklets' crops. The program is built from
`weights_hmr2`'s weights: the module on the meta device, moved to the card
empty and loaded with copies, as `bench_h100/program.py` builds the other
models. The client, the window and the judged outputs are
`engine_crops.Cell`'s.

The rate (the traffic file's `metric`) counts the tracklets' frames over
the whole window: whole calls, from the first call's start to the end of
the first call that ends after `seconds`. A traced slice counts the crops
the program ran by its own counter (`models/hmr2.py::HMR2_STATS`); without
that counter the FLOP-based readings read nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_h100 import flops_hmr2 as FH
from bench_h100 import weights as W
from bench_h100.drivers.base import Reservoir, pick, uint8_crops
from bench_h100.drivers.engine_crops import Cell as EngineCell
from bench_h100.program import _load, shapes, smpl_module
from bench_h100.reference import hmr2 as RH
from bench_h100.reference import rollout as R
from bench_h100.weights_hmr2 import make_hmr2_weights


def hmr2_module(config: dict):
    """The program's HMR2 at the configuration's widths, on the meta
    device."""
    from tepose_tpu_torch.models.hmr2 import HMR2, HMR2Config
    from tepose_tpu_torch.models.vit import ViTConfig

    v, h = config["vit"], config["head"]
    cfg = HMR2Config(
        image_size=config["image_size"], crop_margin=config["crop_margin"],
        vit=ViTConfig(img_size=tuple(v["img_size"]),
                      patch_size=v["patch_size"],
                      patch_padding=v["patch_padding"],
                      embed_dim=v["embed_dim"], depth=v["depth"],
                      num_heads=v["num_heads"], mlp_ratio=v["mlp_ratio"],
                      qkv_bias=v["qkv_bias"], ln_eps=v["ln_eps"]),
        dim=h["dim"], depth=h["depth"], heads=h["heads"],
        dim_head=h["dim_head"], mlp_dim=h["mlp_dim"],
        focal_length=config["focal_length"])
    with torch.device("meta"):
        return HMR2(cfg, device="meta")


def _stats():
    """The program's crop counter, or None where it has none."""
    try:
        from tepose_tpu_torch.models.hmr2 import HMR2_STATS
    except ImportError:
        return None
    return HMR2_STATS


class Cell(EngineCell):
    """`engine_crops.Cell`'s client, clips, calls and judged outputs, with
    HMR 2.0 in the engine."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from tepose_tpu_torch.streaming.engine import StreamingEngine

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        meta = hmr2_module(config)
        self.w = make_hmr2_weights(shapes(meta), seed, device,
                                   **config.get("weights", {}))
        self.smpl_w = W.make_smpl(seed, device, config["smpl_vertices"])
        self.hmr2 = _load(meta, {k: v.clone() for k, v in self.w.items()},
                          device)
        self.engine = StreamingEngine(
            smpl_module(self.smpl_w), self.hmr2,
            crop_batch=traffic["crop_batch"],
            window_bucket=traffic["window_bucket"],
            max_frames_per_call=traffic["max_frames_per_call"],
            preset=traffic["preset"])
        self.lengths = [int(L) for L in traffic["lengths"]]
        ofs = np.cumsum([0] + self.lengths)
        self.clips = []
        for c in range(traffic["clips"]):
            flat = uint8_crops(seed, f"clip{c}", int(ofs[-1]),
                               traffic["crop_size"], device)
            self.clips.append([flat[a:b] for a, b in zip(ofs, ofs[1:])])
        self.check_ids = pick(seed, "check", len(self.lengths),
                              traffic["check_tracklets"],
                              int(np.argmax(self.lengths)))
        self.kept = Reservoir(seed)
        self.calls = 0

    def traced_slice(self) -> dict:
        n = self.traffic["trace_calls"]
        self.kept = Reservoir(self.seed)
        stats = _stats()
        before = None if stats is None else stats["crops"]
        for _ in range(n):
            self._call()
        info = {"units": n, "flops": None, "vit_flops": None,
                "head_flops": None}
        if stats is not None:
            crops = stats["crops"] - before
            cfg = self.config
            info.update(
                crops=crops, vit_flops=crops * FH.vit_flops(cfg),
                head_flops=crops * (FH.hmr2_head_flops(cfg)
                                    + FH.smpl_flops(cfg["smpl_vertices"])),
                flops=crops * FH.hmr2_flops(cfg))
        return info

    def free_program(self) -> None:
        self.engine = None
        self.hmr2 = None

    def reference_outputs(self, ref) -> dict:
        c, _ = self.kept.kept
        with ref.scope():
            return R.cat_outs([RH.frames(
                ref, self.w, self.smpl_w,
                torch.from_numpy(self.clips[c][i]).to(self.device),
                self.config, self.traffic["reference_block"])
                for i in self.check_ids])
