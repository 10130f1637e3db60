#!/usr/bin/env python
"""Write the bit-level golden of `StreamingEngine`'s two routes on the CPU.

The engine serves two kinds of model: TePose through its window scan, and
per-frame models (HMR 2.0). This golden pins both routes' outputs bit for
bit, so a change to the engine that is meant to leave them alone can be
shown to: `tests/test_torch_hmr2.py` rebuilds the same modules and inputs
from seeds and compares with `np.array_equal`.

Everything is the port's own, float32 on the CPU with two intra-op
threads. The TePose route runs at tests/test_torch_spans.py's size (TePose
and VIBE 1 x 16, 64 vertices, 64 x 64 crops) through four calls on one
device: the fused crop path over two length buckets, the two-stage
fallback, the features path with a pseudo-theta, and
`extract_features_multi`; then the crop, features and extract calls again
on a mesh of two CPU devices, the features call with float16 outputs. The
per-frame route runs tests/test_torch_hmr2.py's small HMR 2.0
(`hmr2_model`) over tracklets of `LENGTHS` frames in super-chunks of 7, so
that one tracklet straddles two, on one device and on the two-device mesh.

  python tools/make_torch_engine_golden.py      # writes GOLDEN_PATH
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict, List

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

GOLDEN_PATH = os.path.join(REPO, "tests", "golden",
                           "torch_port_engine_tepose_f32.npz")
THREADS = 2
# the per-frame route's tracklet lengths
LENGTHS = (1, 5, 9, 2, 3)


def hmr2_config():
    """HMR 2.0 at a small size: ViT width 64, 2 blocks of 4 heads, a
    decoder of width 64 with 2 layers of 4 heads of 32, 64 x 64 crops read
    at columns 8:-8."""
    from tepose_tpu_torch.models.hmr2 import HMR2Config
    from tepose_tpu_torch.models.vit import ViTConfig

    return HMR2Config(image_size=64, crop_margin=8,
                      vit=ViTConfig(img_size=(64, 48), embed_dim=64, depth=2,
                                    num_heads=4),
                      dim=64, depth=2, heads=4, dim_head=32, mlp_dim=64)


def hmr2_model():
    """`hmr2_config`'s model from seed 0, the decoders' Xavier gain 1 so
    the image reaches every output."""
    from tepose_tpu_torch.models import hmr2 as H

    model = H.HMR2(hmr2_config(),
                   generator=torch.Generator().manual_seed(0)).eval()
    head = model.smpl_head
    with torch.no_grad():
        for dec in (head.decpose, head.decshape, head.deccam):
            dec.weight.mul_(1.0 / H.DECODER_GAIN)
    return model


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
        pseu=rs.randn(5, 85).astype(np.float32) * 0.1,
        hmr2=hmr2_model(), frames=[u8(n) for n in LENGTHS])


# the golden's calls: TePose's fused crop path, its two-stage fallback, the
# features path with a pseudo-theta, `extract_features_multi`, then on a
# mesh of two CPU devices; the per-frame route on one device and the mesh
CALLS = ("fused", "fallback", "features", "extract", "fused_mesh",
         "features_mesh_f16", "extract_mesh", "frames", "frames_mesh")


def engine_call(s: Dict, name: str, **kw) -> Callable[[], List[Dict]]:
    """The golden's call `name` (one of `CALLS`) on one engine, as a
    function of no arguments that returns the per-tracklet output dicts.
    `kw` replaces the golden's engine arguments: `crop_batch` 8 (HMR 2.0:
    4), `window_bucket` 16, `max_frames_per_call` 4096 (fallback 40,
    extract 4, HMR 2.0 7)."""
    from tepose_tpu_torch.parallel.mesh import make_mesh
    from tepose_tpu_torch.streaming.engine import StreamingEngine

    base = name.split("_mesh")[0]
    opts = {"mesh": make_mesh(devices=["cpu", "cpu"])} if "_mesh" in name \
        else {}
    if base == "frames":
        eng = StreamingEngine(s["smpl"], s["hmr2"], **{
            **opts, "crop_batch": 4, "max_frames_per_call": 7, **kw})
        return lambda: eng.run_tracklets_from_crops(s["frames"])
    opts.update(crop_batch=8, window_bucket=16,
                **{"fallback": {"max_frames_per_call": 40},
                   "extract": {"max_frames_per_call": 4}}.get(base, {}))
    if name == "features_mesh_f16":
        opts.update(outputs=("theta", "kp_3d"), output_dtype=torch.float16)
    eng = StreamingEngine(s["smpl"], s["gen"], s["vibe"], s["bb"],
                          **{**opts, **kw})
    if base == "features":
        return lambda: eng.run_tracklets(s["feats"], [None, s["pseu"], None])
    if base == "extract":
        return lambda: [{"feats": f} for f in eng.extract_features_multi(
            [s["crops"][0][:5], s["crops"][1][:6]])]
    crops = s["crops"] if base == "fused" else s["long"]
    return lambda: eng.run_tracklets_from_crops(crops)


def outputs(s: Dict) -> Dict[str, np.ndarray]:
    """Every array the calls return, under `<call>/<tracklet>/<key>`."""
    return {f"{name}/{i}/{k}": v for name in CALLS
            for i, out in enumerate(engine_call(s, name)())
            for k, v in out.items()}


def main() -> None:
    torch.set_num_threads(THREADS)
    out = outputs(setup())
    np.savez_compressed(GOLDEN_PATH, **out)
    print(f"wrote {GOLDEN_PATH}: {len(out)} arrays, "
          f"{os.path.getsize(GOLDEN_PATH)} bytes")


if __name__ == "__main__":
    main()
