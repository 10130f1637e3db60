"""The offline engine on crops: `StreamingEngine.run_tracklets_from_crops`.

One client in a closed loop sends clips of tracklets of uint8 crops, the
next clip once the last one's outputs are on the host. The tracklets'
lengths are the traffic file's; the crops are drawn on the card from the
seed in set-up (`clips` different clips, sent in turn) and kept in host
memory, as a demo holds its tracklets' crops.

The rate (the traffic file's `metric`) counts the tracklets' own frames,
not padding, over the whole window: whole calls, from the first call's
start to the end of the first call that ends after `seconds`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_h100 import flops as F
from bench_h100.drivers.base import Reservoir, pick, ring0, uint8_crops
from bench_h100.program import Models
from bench_h100.reference import rollout as R

KEYS = ("theta", "verts", "kp_3d")


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from tepose_tpu_torch.streaming.engine import StreamingEngine

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.S = config["seqlen"]
        self.models = Models(config, seed, device,
                             ("tepose", "vibe", "resnet"),
                             config["smpl_vertices"])
        m = self.models.modules
        self.engine = StreamingEngine(
            self.models.smpl, m["tepose"], m["vibe"], m["resnet"],
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

    def _call(self) -> None:
        c = self.calls % len(self.clips)
        outs = self.engine.run_tracklets_from_crops(self.clips[c])
        self.calls += 1
        self.kept.offer(lambda: (c, [{k: outs[i][k] for k in KEYS}
                                     for i in self.check_ids]))

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
        frames = n * sum(self.lengths)
        return {"metrics": {self.traffic["metric"]: frames / elapsed},
                "attempted": n, "failed": 0}

    def traced_slice(self) -> dict:
        n = self.traffic["trace_calls"]
        self.kept = Reservoir(self.seed)
        for _ in range(n):
            self._call()
        cfg, S, V = self.config, self.S, self.config["smpl_vertices"]
        crops = n * sum(self.lengths)
        windows = n * sum(L - S + 1 for L in self.lengths)
        size = self.traffic["crop_size"]
        resnet = crops * F.resnet50_flops(size, size)
        flops = (resnet + F.tepose_frames_flops(windows, S, cfg["n_layers"],
                                         cfg["hidden_size"], V)
                 + n * len(self.lengths) * F.vibe_frames_flops(
                     S, cfg["vibe"]["hidden_size"], cfg["vibe"]["n_layers"],
                     V))
        return {"units": n, "flops": flops,
                "resnet_flops": resnet}

    def free_program(self) -> None:
        self.engine = None
        self.models.free()

    def judged(self) -> dict:
        _, outs = self.kept.kept
        t = {k: torch.from_numpy(np.concatenate([o[k] for o in outs])).to(
            self.device) for k in KEYS}
        return R.judged_from_theta(t["theta"], t["kp_3d"], t["verts"])

    def reference_outputs(self, ref) -> dict:
        c, outs = self.kept.kept
        w, S = self.models.w, self.S
        parts = []
        with ref.scope():
            for i, o in zip(self.check_ids, outs):
                crops = torch.from_numpy(self.clips[c][i]).to(self.device)
                feats = R.features(ref, w["resnet"], crops)
                theta = torch.from_numpy(o["theta"]).to(self.device)
                parts.append(R.tracklet(ref, w, self.models.smpl_w, feats,
                                        ring0(S, self.device), theta, S))
        return R.cat_outs(parts)
