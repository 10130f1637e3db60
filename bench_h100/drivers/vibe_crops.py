"""VIBE over image crops: `models/tepose.py::vibe_demo_forward`.

One client in a closed loop sends chunks of (batch, frames) uint8 crops,
VIBE demo's `vibe_batch_size` chunking of a video. Each call uploads the
chunk, normalises it on the card (`normalize_crop`), runs ResNet-50, the
VIBE GRU over the chunk's frames, the regressor and SMPL, and reads theta,
the vertices and the joints back. The crops are drawn on the card from the
seed in set-up (`clips` chunks, sent in turn) and kept in pinned host
memory.

The rate (the traffic file's `metric`) counts the chunks' frames over
whole calls, from the first call's start to the end of the first call that
ends after `seconds`.
"""

from __future__ import annotations

import time

import torch

from bench_h100 import flops as F
from bench_h100.drivers.base import Reservoir, uint8_crops
from bench_h100.program import Models
from bench_h100.reference import rollout as R

KEYS = ("theta", "verts", "kp_3d")


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.models = Models(config, seed, device, ("vibe", "resnet"),
                             config["smpl_vertices"])
        self.B, self.T = traffic["batch"], traffic["frames"]
        size = traffic["crop_size"]
        self.clips = []
        for c in range(traffic["clips"]):
            x = torch.from_numpy(uint8_crops(seed, f"clip{c}",
                                             self.B * self.T, size, device))
            if self.device.type == "cuda":
                x = x.pin_memory()
            self.clips.append(x.reshape(self.B, self.T, 3, size, size))
        self.kept = Reservoir(seed)
        self.calls = 0

    def _call(self) -> None:
        from tepose_tpu_torch.models.backbone import normalize_crop
        from tepose_tpu_torch.models.tepose import vibe_demo_forward
        from tepose_tpu_torch.streaming.engine import device_scope

        c = self.calls % len(self.clips)
        m = self.models.modules
        with device_scope():
            x = self.clips[c].to(self.device, non_blocking=True)
            images = normalize_crop(x.flatten(0, 1)).reshape(x.shape)
            out = vibe_demo_forward(m["vibe"], m["resnet"], self.models.smpl,
                                    images)
            host = {k: out[k].cpu() for k in KEYS}
        self.calls += 1
        self.kept.offer(lambda: (c, host))

    def warm_unit(self) -> None:
        self._call()

    def window(self, seconds: float) -> dict:
        self.kept = Reservoir(self.seed)
        t0 = time.perf_counter()
        n = 0
        while True:
            self._call()
            n += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        rate = n * self.B * self.T / elapsed
        return {"metrics": {self.traffic["metric"]: rate},
                "attempted": n, "failed": 0}

    def traced_slice(self) -> dict:
        n = self.traffic["trace_calls"]
        self.kept = Reservoir(self.seed)
        for _ in range(n):
            self._call()
        v, size = self.config["vibe"], self.traffic["crop_size"]
        frames = n * self.B * self.T
        resnet = frames * F.resnet50_flops(size, size)
        flops = resnet + n * self.B * F.vibe_frames_flops(
            self.T, v["hidden_size"], v["n_layers"],
            self.config["smpl_vertices"])
        return {"units": n, "flops": flops, "resnet_flops": resnet}

    def free_program(self) -> None:
        self.models.free()

    def judged(self) -> dict:
        _, host = self.kept.kept
        t = {k: v.flatten(0, 1).to(self.device) for k, v in host.items()}
        return R.judged_from_theta(t["theta"], t["kp_3d"], t["verts"])

    def reference_outputs(self, ref) -> dict:
        c, _ = self.kept.kept
        w = self.models.w
        with ref.scope():
            crops = self.clips[c].to(self.device).flatten(0, 1)
            feats = R.features(ref, w["resnet"], crops)
            return R.vibe_frames(ref, w["vibe"], self.models.smpl_w,
                                 feats.reshape(self.B, self.T, -1))
