"""The eval pass on 2048-d features: `evaluate.py`'s loop.

The videos' lengths are the traffic file's (60 videos shaped like the 3DPW
test set). The driver plans the pass with the program's
`plan_eval_batches` at `max_batch` videos a chunk, runs each chunk through
`rollout_chunk` (host padding, upload, the theta-feedback rollout, the
readback) and adds every video to an `EvalAccumulator` (MPJPE and PA-MPJPE
on the host, MPVPE from the card), as `evaluate.py` does. Features,
pseudo-thetas, ground-truth thetas and joints are drawn on the card from
the seed in set-up and kept in host memory, as the eval DB is.

The rate (the traffic file's `metric`) counts the videos' own frames
over whole passes: the window ends at the first pass boundary after
`seconds`, so every window holds the same mix of chunks.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_h100 import flops as F
from bench_h100 import weights as W
from bench_h100.drivers.base import Reservoir, pick
from bench_h100.program import Models
from bench_h100.reference import rollout as R


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from tepose_tpu_torch.evaluate import plan_eval_batches

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.S = S = config["seqlen"]
        self.models = Models(config, seed, device, ("tepose", "vibe"),
                             config["smpl_vertices"])
        self.jreg = self.models.smpl_w["j_h36m"]
        self.lengths = {f"v{i:02d}": int(L)
                        for i, L in enumerate(traffic["lengths"])}
        self.plan = plan_eval_batches(self.lengths, S, traffic["max_batch"])
        self.data = self._data(seed)
        longest = max(self.lengths, key=self.lengths.get)
        names = list(self.lengths)
        self.check = [names[i] for i in pick(
            seed, "check", len(names), traffic["check_videos"],
            names.index(longest))]
        # the traced chunk, and the videos checked in a traced run
        self.trace_chunk = self.plan[traffic["trace_chunk"]]
        chunk = self.trace_chunk[1]
        first = max(chunk, key=self.lengths.get)
        self.trace_check = [chunk[i] for i in pick(
            seed, "trace-check", len(chunk), traffic["check_videos"],
            chunk.index(first))]
        self.kept = Reservoir(seed)

    def _data(self, seed: int) -> dict:
        """One array per field for all frames, cut into per-video views."""
        g = W.generator(seed, "eval-data", self.device)
        N = sum(self.lengths.values())

        def draw(*shape, scale):
            return (torch.randn((N,) + shape, generator=g, device=self.device)
                    * scale).cpu().numpy()

        pseu = draw(85, scale=0.1)
        pseu[:, :3] = [1.0, 0.0, 0.0]
        fields = {"features": draw(2048, scale=0.1), "theta_pseu": pseu,
                  "pose": draw(72, scale=0.2), "shape": draw(10, scale=0.2),
                  "joints3D": draw(14, 3, scale=0.2)}
        data, ofs = {}, 0
        for name, L in self.lengths.items():
            data[name] = {k: v[ofs:ofs + L] for k, v in fields.items()}
            ofs += L
        return data

    def _chunk(self, T_pad, chunk, B, acc, check) -> dict:
        from tepose_tpu_torch.evaluate import rollout_chunk

        m = self.models.modules
        out = rollout_chunk((self.models.smpl, m["tepose"], m["vibe"],
                             self.jreg), self.data, chunk, T_pad, B,
                            self.device)
        kept = {}
        for b, n in enumerate(chunk):
            L = self.lengths[n]
            acc.add_video(out["pred_j3d"][b, :L], self.data[n]["joints3D"],
                          mpvpe=out["mpvpe"][b, :L])
            if n in check:
                kept[n] = {"pred_j3d": out["pred_j3d"][b, :L],
                           "pred_theta": out["pred_theta"][b, :L],
                           "mpjpe_mm": acc.mpjpe[-1],
                           "pa_mpjpe_mm": acc.pa_mpjpe[-1],
                           "mpvpe_mm": acc.mpvpe[-1]}
        return kept

    def _pass(self) -> None:
        from tepose_tpu_torch.eval.evaluator import EvalAccumulator

        acc = EvalAccumulator(dataset="3dpw")
        kept = {}
        for T_pad, chunk, B in self.plan:
            kept.update(self._chunk(T_pad, chunk, B, acc, self.check))
        acc.summarize()
        self.kept.offer(lambda: (self.check, kept))

    def warm_unit(self) -> None:
        """Each chunk shape of the pass, each for `warm_windows` windows."""
        from tepose_tpu_torch.eval.evaluator import eval_rollout
        from tepose_tpu_torch.evaluate import make_eval_batch

        m = self.models.modules
        for T_pad, chunk, B in self.plan:
            T = min(T_pad, self.traffic["warm_windows"] + self.S - 1)
            cut = {n: {k: v[:T] for k, v in self.data[n].items()}
                   for n in chunk}
            batch = make_eval_batch(cut, chunk, self.S, T, B)
            x = {k: torch.from_numpy(v).to(self.device)
                 for k, v in batch.items()}
            out = eval_rollout(m["tepose"], m["vibe"], self.models.smpl,
                               x["feats"], x["theta_pseu"], x["theta_gt"],
                               self.jreg, T - self.S + 1)
            out["pred_j3d"].cpu()

    def window(self, seconds: float) -> dict:
        self.kept = Reservoir(self.seed)
        t0 = time.perf_counter()
        n = 0
        while True:
            self._pass()
            n += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        frames = n * sum(self.lengths.values())
        return {"metrics": {self.traffic["metric"]: frames / elapsed},
                "attempted": n * len(self.plan), "failed": 0}

    def traced_slice(self) -> dict:
        from tepose_tpu_torch.eval.evaluator import EvalAccumulator

        T_pad, chunk, B = self.trace_chunk
        acc = EvalAccumulator(dataset="3dpw")
        kept = self._chunk(T_pad, chunk, B, acc, self.trace_check)
        self.kept = Reservoir(self.seed)
        self.kept.offer(lambda: (self.trace_check, kept))
        cfg, S, V = self.config, self.S, self.config["smpl_vertices"]
        lens = [self.lengths[n] for n in chunk]
        W_steps = T_pad - S + 1
        flops = sum(F.vibe_frames_flops(S, cfg["vibe"]["hidden_size"],
                                        cfg["vibe"]["n_layers"], V)
                    + F.tepose_frames_flops(L - S + 1, S, cfg["n_layers"],
                                            cfg["hidden_size"], V)
                    + L * F.smpl_flops(V) for L in lens)
        return {"units": 1, "windows": W_steps,
                "flops": flops,
                "lbs_batches": [B * S, B * (S - 1)] + [B, B] * W_steps}

    def free_program(self) -> None:
        self.models.free()

    def judged(self) -> dict:
        names, kept = self.kept.kept
        cat = {k: torch.from_numpy(np.concatenate([kept[n][k]
                                                   for n in names])).to(
            self.device) for k in ("pred_theta", "pred_j3d", "mpjpe_mm",
                                   "pa_mpjpe_mm", "mpvpe_mm")}
        out = R.judged_from_theta(cat["pred_theta"], cat["pred_j3d"])
        out.update({k: cat[k] for k in ("mpjpe_mm", "pa_mpjpe_mm",
                                        "mpvpe_mm")})
        return out

    def reference_outputs(self, ref) -> dict:
        names, kept = self.kept.kept
        w, smpl, S = self.models.w, self.models.smpl_w, self.S
        parts = []
        with ref.scope():
            for n in names:
                d = self.data[n]
                dev = self.device
                feats = torch.from_numpy(d["features"]).to(dev)
                theta = torch.from_numpy(kept[n]["pred_theta"]).to(dev)
                ring = torch.from_numpy(d["theta_pseu"][:S - 1]).to(dev)
                out = R.tracklet(ref, w, smpl, feats, ring, theta, S,
                                 self.jreg)
                gt = torch.cat([
                    ref.smpl(smpl, sh, R.rodrigues(po.reshape(-1, 24, 3)))[
                        "verts"] for sh, po in zip(
                        torch.from_numpy(d["shape"]).to(dev).split(512),
                        torch.from_numpy(d["pose"]).to(dev).split(512))])
                mpvpe = torch.cat([R.vertex_error_mm(v, g) for v, g in zip(
                    out.pop("verts").split(512), gt.split(512))])
                mpjpe, pa = R.joint_errors_mm(out["kp_3d"].cpu().numpy(),
                                              d["joints3D"])
                out.update(mpvpe_mm=mpvpe, mpjpe_mm=torch.from_numpy(mpjpe),
                           pa_mpjpe_mm=torch.from_numpy(pa))
                parts.append({k: v.to(dev) for k, v in out.items()})
        return R.cat_outs(parts)
