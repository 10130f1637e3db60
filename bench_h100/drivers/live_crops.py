"""Live multi-person streams: `LiveSession.push` with a ResNet-50 backbone,
at the demo's `--live` defaults (float32 backbone, outputs theta, the
vertices and the joints).

`streams` slots each take one uint8 crop a tick, ticks due every
1 / `fps` s from the window's start: an open loop, so a push that runs late
makes the next ones late, and each tick's latency counts from its due time
to `push`'s return. The crops come from a pool drawn on the card from the
seed in set-up; which pool crop a slot shows at a tick, and the ticks at
which a slot takes a new person (a reset, `reset_mean_frames` apart on
average), are drawn from the seed. The window's first tick resets every
slot, so the window does not depend on the warm-up before it.
"""

from __future__ import annotations

import math
import statistics
import sys
import time

import numpy as np
import torch

from bench_h100 import weights as W
from bench_h100.drivers.base import pick, ring0, uint8_crops
from bench_h100.program import Models
from bench_h100.reference import rollout as R

KEYS = ("theta", "verts", "kp_3d")


class Schedule:
    """Pool indices (ticks, K) and resets (ticks, K) of a stretch of ticks,
    every slot reset at its first tick."""

    def __init__(self, seed: int, stream: str, ticks: int, K: int,
                 pool: int, reset_mean: float):
        rng = np.random.default_rng(W.sub_seed(seed, stream))
        self.crop = rng.integers(0, pool, size=(ticks, K))
        self.reset = rng.random((ticks, K)) < 1.0 / reset_mean
        self.reset[0] = True


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from tepose_tpu_torch.streaming.live import LiveSession

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.S = config["seqlen"]
        self.K = traffic["streams"]
        self.period = 1.0 / traffic["fps"]
        self.models = Models(config, seed, device,
                             ("tepose", "vibe", "resnet"),
                             config["smpl_vertices"])
        m = self.models.modules
        self.session = LiveSession(self.models.smpl, m["tepose"], m["vibe"],
                                   n_streams=self.K, backbone=m["resnet"],
                                   outputs=KEYS)
        self.pool = uint8_crops(seed, "pool", traffic["pool"],
                                traffic["crop_size"], device)
        self.warm = Schedule(
            seed, "warm", int(traffic["warm_max_seconds"] * traffic["fps"])
            + traffic["warm_units"] + 1, self.K, traffic["pool"],
            traffic["reset_mean_frames"])
        self.warm_ticks = 0
        self.next_due = None

    def _push(self, sched: Schedule, t: int):
        x = self.pool[sched.crop[t]]
        reset = sched.reset[t]
        return self.session.push(x, reset=reset if reset.any() else None)

    def warm_unit(self) -> None:
        """One warm-up tick, paced as the window's ticks are."""
        now = time.perf_counter()
        if self.next_due is None or self.next_due < now:
            self.next_due = now
        time.sleep(max(0.0, self.next_due - now))
        self._push(self.warm, self.warm_ticks % len(self.warm.crop))
        self.warm_ticks += 1
        self.next_due += self.period

    def _run(self, ticks: int, sample) -> list:
        """`ticks` paced ticks of a fresh schedule; keeps every tick's
        theta and, at the ticks in `sample`, all outputs. Returns each
        tick's (due, start, end) on the host clock."""
        self.sched = Schedule(self.seed, "window", ticks, self.K,
                              self.traffic["pool"],
                              self.traffic["reset_mean_frames"])
        self.thetas = np.zeros((ticks, self.K, 85), np.float32)
        self.sample = {int(t): None for t in sample}
        times = []
        x = self.pool[self.sched.crop[0]]
        t0 = time.perf_counter() + self.period
        for t in range(ticks):
            due = t0 + t * self.period
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            start = time.perf_counter()
            reset = self.sched.reset[t]
            out = self.session.push(x, reset=reset if reset.any() else None)
            end = time.perf_counter()
            times.append((due, start, end))
            self.thetas[t] = out["theta"]
            if t in self.sample:
                self.sample[t] = {k: out[k] for k in KEYS}
            if t + 1 < ticks:
                x = self.pool[self.sched.crop[t + 1]]
        return times

    def window(self, seconds: float) -> dict:
        ticks = max(1, math.ceil(seconds / self.period))
        n_check = min(self.traffic["check_ticks"], ticks)
        sample = pick(self.seed, "check", ticks, n_check, ticks - 1)
        self.times = times = self._run(ticks, sample)
        lat = [1e3 * (end - due) for due, _, end in times]
        late = [1e3 * max(0.0, start - due) for due, start, _ in times]
        q = max(1, ticks // 4)
        print(f"live: {ticks} ticks of {self.K} streams; generator late "
              f"p50 {statistics.median(late):.3f} ms, max {max(late):.3f} "
              f"ms; latency first quarter mean "
              f"{statistics.mean(lat[:q]):.3f} ms, last quarter "
              f"{statistics.mean(lat[-q:]):.3f} ms", file=sys.stderr)
        p = np.percentile(lat, [50, 95])
        return {"metrics": {"live_p50_ms": float(p[0]),
                            "live_p95_ms": float(p[1])},
                "attempted": ticks, "failed": 0}

    def traced_slice(self) -> dict:
        ticks = self.traffic["trace_ticks"]
        self._run(ticks, pick(self.seed, "check", ticks,
                              min(self.traffic["check_ticks"], ticks),
                              ticks - 1))
        return {"units": ticks, "pushes": ticks}

    def free_program(self) -> None:
        self.session = None
        self.models.free()

    def _sampled(self):
        """(tick, slot, age) of every slot at every sampled tick; age is the
        frames since the slot's last reset."""
        last = np.zeros(self.K, int)
        out = []
        for t in range(max(self.sample) + 1):
            last = np.where(self.sched.reset[t], t, last)
            if t in self.sample:
                out += [(t, s, t - int(last[s])) for s in range(self.K)]
        return out

    def judged(self) -> dict:
        rows = self._sampled()
        t = {k: torch.from_numpy(np.stack([self.sample[tick][k][s]
                                           for tick, s, _ in rows])).to(
            self.device) for k in KEYS}
        return R.judged_from_theta(t["theta"], t["kp_3d"], t["verts"])

    def reference_outputs(self, ref) -> dict:
        """Slots still filling their first S-1 frames get VIBE over the
        frames since their reset; the others TePose's window over their last
        S frames with the thetas the program fed back."""
        S, dev, w = self.S, self.device, self.models.w
        rows = self._sampled()
        with ref.scope():
            feats = R.features(ref, w["resnet"],
                               torch.from_numpy(self.pool).to(dev))
            parts = [None] * len(rows)
            live = [i for i, (_, _, a) in enumerate(rows) if a >= S - 1]
            if live:
                r0 = ring0(S, dev)
                win, ring = [], []
                for i in live:
                    t, s, a = rows[i]
                    win.append(feats[self.sched.crop[t - S + 1:t + 1, s]])
                    fed = torch.cat([r0, torch.from_numpy(
                        self.thetas[t - a + S - 1:t, s]).to(dev)])
                    ring.append(fed[-(S - 1):])
                out = R.tepose_windows(ref, w["tepose"], self.models.smpl_w,
                                       torch.stack(win), torch.stack(ring))
                for j, i in enumerate(live):
                    parts[i] = {k: v[j:j + 1] for k, v in out.items()}
            for i, (t, s, a) in enumerate(rows):
                if a < S - 1:
                    seq = feats[self.sched.crop[t - a:t + 1, s]][None]
                    out = R.vibe_frames(ref, w["vibe"], self.models.smpl_w,
                                        seq)
                    parts[i] = {k: v[-1:] for k, v in out.items()}
        return R.cat_outs(parts)
