#!/usr/bin/env python
"""Write the bit-level golden of `StreamingEngine`'s TePose route on the CPU.

The engine serves two kinds of model: TePose through its window scan, and
per-frame models (HMR 2.0). This golden pins the TePose route's outputs
bit for bit, so a change to the engine that is meant to leave that route
alone can be shown to: `tests/test_torch_hmr2.py` rebuilds the same
modules and inputs from seeds and compares with `np.array_equal`.

Everything is the port's own at tests/test_torch_spans.py's size (TePose
and VIBE 1 x 16, 64 vertices, 64 x 64 crops), float32 on the CPU with two
intra-op threads, through four calls: the fused crop path over two length
buckets, the two-stage fallback, the features path with a pseudo-theta,
and `extract_features_multi`.

  python tools/make_torch_engine_golden.py      # writes GOLDEN_PATH
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

GOLDEN_PATH = os.path.join(REPO, "tests", "golden",
                           "torch_port_engine_tepose_f32.npz")
THREADS = 2


def setup() -> Dict:
    """The modules and inputs, from seeds alone."""
    from tepose_tpu_torch.models.backbone import resnet50_init
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model
    from tepose_tpu_torch.models.tepose import (
        TePose, TePoseConfig, Vibe, VibeConfig)

    g = torch.Generator().manual_seed(0)
    rs = np.random.RandomState(11)

    def u8(n):
        return (rs.rand(n, 3, 64, 64) * 255).astype(np.uint8)

    return dict(
        smpl=synthetic_smpl_model(0, 64),
        gen=TePose(TePoseConfig(6, 1, 16), generator=g, device="cpu").eval(),
        vibe=Vibe(VibeConfig(6, 1, 16), generator=g, device="cpu").eval(),
        bb=resnet50_init(g, "cpu").eval(),
        crops=[u8(8), u8(20)], long=[u8(8), u8(44), u8(20)],
        feats=[rs.randn(n, 2048).astype(np.float32) * 0.1
               for n in (14, 14, 30)],
        pseu=rs.randn(5, 85).astype(np.float32) * 0.1)


def outputs(s: Dict) -> Dict[str, np.ndarray]:
    """Every array the four calls return, under `<call>/<tracklet>/<key>`."""
    from tepose_tpu_torch.streaming.engine import StreamingEngine

    def engine(**kw):
        return StreamingEngine(s["smpl"], s["gen"], s["vibe"], s["bb"],
                               crop_batch=8, window_bucket=16, **kw)

    calls: Dict[str, List] = {
        "fused": engine().run_tracklets_from_crops(s["crops"]),
        "fallback": engine(max_frames_per_call=40).run_tracklets_from_crops(
            s["long"]),
        "features": engine().run_tracklets(s["feats"],
                                           [None, s["pseu"], None]),
        "extract": [{"feats": f} for f in
                    engine(max_frames_per_call=4).extract_features_multi(
                        [s["crops"][0][:5], s["crops"][1][:6]])],
    }
    return {f"{name}/{i}/{k}": v for name, outs in calls.items()
            for i, out in enumerate(outs) for k, v in out.items()}


def main() -> None:
    torch.set_num_threads(THREADS)
    out = outputs(setup())
    np.savez_compressed(GOLDEN_PATH, **out)
    print(f"wrote {GOLDEN_PATH}: {len(out)} arrays, "
          f"{os.path.getsize(GOLDEN_PATH)} bytes")


if __name__ == "__main__":
    main()
