#!/usr/bin/env python
"""Write the JAX serving golden that the PyTorch port's engine is held to.

The GPU host has no JAX, so this script runs the JAX
`StreamingEngine.run_tracklets_from_crops` (strict float32) here, on the CPU,
on weights and crops that the port rebuilds from seeds alone:

  * TePose, VIBE and ResNet-50 weights drawn by the port's own modules from
    `torch.Generator().manual_seed(...)`, exported with
    `tepose_tpu_torch.weights.jax_tree_from_state_dict`;
  * `synthetic_smpl_model(seed)`, equal element for element in both
    packages;
  * uint8 crops from `np.random.RandomState(crop_seed)`.

The file keeps the spec (seeds and shapes), the weights' checksums and the
outputs per tracklet: theta, kp_3d, kp_2d and every `vert_stride`-th vertex.
`chip_smoke.py` rebuilds the rest.

  python tools/make_torch_serve_golden.py      # writes GOLDEN_PATH

Only `jax_serve` and `main` import JAX, so the torch-side helpers here can
be imported on a host without it.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

GOLDEN_PATH = os.path.join(REPO, "tests", "golden",
                           "torch_port_serve_f32.npz")

OUTPUTS = ("theta", "kp_3d", "kp_2d", "verts")

THETA_ATOL = 1e-3
METRE_ATOL = 1e-4    # 0.1 mm, the reproduction bar (BASELINE.md:64)
KP2D_RTOL = 1e-4

# Full width of configs/repr_wopw_3dpw_model.yaml, the bootstrap VIBE and
# ResNet-50 on 224 x 224 crops; two tracklets of 7 and 12 frames make one
# bucket of B_pad 2 and T_pad 16.
FULL_SPEC = dict(seqlen=6, n_layers=2, hidden_size=1024,
                 vibe_n_layers=2, vibe_hidden_size=1024,
                 num_verts=6890, smpl_seed=0, gen_seed=0, vibe_seed=1,
                 backbone_seed=2, crop_seed=3, crop_size=224,
                 lengths=[7, 12], window_bucket=16, vert_stride=50)


def port_setup(spec: Dict, device: torch.device | str) -> Dict:
    """The engine's models and crops on `device`, rebuilt from `spec`."""
    from tepose_tpu_torch.models.backbone import resnet50_init
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model
    from tepose_tpu_torch.models.tepose import (
        TePose, TePoseConfig, Vibe, VibeConfig)

    mcfg = TePoseConfig(spec["seqlen"], spec["n_layers"], spec["hidden_size"])
    vcfg = VibeConfig(n_layers=spec["vibe_n_layers"],
                      hidden_size=spec["vibe_hidden_size"])
    gen = TePose(mcfg, device=device,
                 generator=torch.Generator().manual_seed(spec["gen_seed"]))
    vibe = Vibe(vcfg, device=device,
                generator=torch.Generator().manual_seed(spec["vibe_seed"]))
    backbone = resnet50_init(
        torch.Generator().manual_seed(spec["backbone_seed"]), device)
    rs = np.random.RandomState(spec["crop_seed"])
    size = spec["crop_size"]
    crops = [rs.randint(0, 256, (n, 3, size, size)).astype(np.uint8)
             for n in spec["lengths"]]
    return {
        "gen": gen.eval(), "vibe": vibe.eval(), "backbone": backbone.eval(),
        "smpl": synthetic_smpl_model(spec["smpl_seed"], spec["num_verts"],
                                     device=device),
        "crops": crops, "spec": spec,
    }


def weight_checksums(setup: Dict) -> np.ndarray:
    """(sum, sum of |.|) in float64 over each model's state_dict, to catch a
    change in the generator's stream before comparing outputs."""
    sums = []
    for name in ("gen", "vibe", "backbone"):
        vals = [v.detach().cpu().numpy().astype(np.float64).ravel()
                for v in setup[name].state_dict().values()]
        flat = np.concatenate(vals)
        sums += [flat.sum(), np.abs(flat).sum()]
    return np.asarray(sums)


def port_engine(setup: Dict, **kw):
    """The port's `StreamingEngine` over the setup's models."""
    from tepose_tpu_torch.streaming.engine import StreamingEngine

    return StreamingEngine(setup["smpl"], setup["gen"], setup["vibe"],
                           setup["backbone"],
                           window_bucket=setup["spec"]["window_bucket"], **kw)


def golden_outputs(results: List[Dict[str, np.ndarray]],
                   spec: Dict) -> Dict[str, np.ndarray]:
    """Per-tracklet engine results -> the golden's keys ("theta_0", ...),
    float32, verts cut to every `vert_stride`-th vertex."""
    out = {}
    for i, res in enumerate(results):
        for k in OUTPUTS:
            v = np.asarray(res[k], np.float32)
            if k == "verts":
                v = v[:, ::spec["vert_stride"]]
            out[f"{k}_{i}"] = v
    return out


def port_serve(setup: Dict, path: str = "crops") -> Dict[str, np.ndarray]:
    """The port engine's outputs on the setup's device: `path` "crops" is
    the fused `run_tracklets_from_crops`, "features" is
    `extract_features_multi` followed by `run_tracklets`."""
    engine = port_engine(setup)
    if path == "crops":
        results = engine.run_tracklets_from_crops(setup["crops"])
    else:
        results = engine.run_tracklets(
            engine.extract_features_multi(setup["crops"]))
    return golden_outputs(results, setup["spec"])


def golden_deviation(got: Dict[str, np.ndarray],
                     golden: Dict) -> Dict[str, tuple]:
    """{output: (max abs deviation over the tracklets, its bar)}.

    theta within THETA_ATOL and kp_3d and verts within METRE_ATOL (0.1 mm).
    kp_2d is in normalised image units, not metres: the random He-init
    ResNet-50 gives features near 1e3, which drive the camera scale to ~35
    and the joints close to the projection's depth, so kp_2d reaches ~700,
    where float32 spacing alone is 6e-5. Its bar is KP2D_RTOL times its
    largest magnitude in the golden."""
    n = len(golden["spec"]["lengths"])
    dev = {}
    for k in OUTPUTS:
        pairs = [(got[f"{k}_{i}"], golden[f"{k}_{i}"]) for i in range(n)]
        for g, w in pairs:
            if g.shape != w.shape or not np.isfinite(g).all():
                raise ValueError(f"{k}: shape {g.shape} vs {w.shape}, or "
                                 f"non-finite values")
        d = max(float(np.abs(g - w).max()) for g, w in pairs)
        if k == "theta":
            bar = THETA_ATOL
        elif k == "kp_2d":
            bar = KP2D_RTOL * max(float(np.abs(w).max()) for _, w in pairs)
        else:
            bar = METRE_ATOL
        dev[k] = (d, bar)
    return dev


def jax_serve(spec: Dict) -> Dict[str, np.ndarray]:
    """The JAX engine (strict float32, CPU) on the port's weights."""
    import jax

    from tepose_tpu.models.smpl import synthetic_smpl_model
    from tepose_tpu.models.tepose import TePoseConfig, VibeConfig
    from tepose_tpu.streaming.engine import StreamingEngine
    from tepose_tpu_torch.weights import jax_tree_from_state_dict

    setup = port_setup(spec, "cpu")
    mcfg = TePoseConfig(spec["seqlen"], spec["n_layers"], spec["hidden_size"])
    vcfg = VibeConfig(n_layers=spec["vibe_n_layers"],
                      hidden_size=spec["vibe_hidden_size"])
    engine = StreamingEngine(
        synthetic_smpl_model(spec["smpl_seed"], spec["num_verts"]),
        *(jax_tree_from_state_dict(setup[k].state_dict())
          for k in ("gen", "vibe", "backbone")),
        mcfg, vcfg, window_bucket=spec["window_bucket"])
    with jax.default_matmul_precision("float32"):
        results = engine.run_tracklets_from_crops(setup["crops"])
    return golden_outputs(results, spec)


def make_golden(spec: Dict) -> Dict[str, np.ndarray]:
    """Everything the golden file holds, for `spec`."""
    out = jax_serve(spec)
    out["spec"] = np.asarray(json.dumps(spec, sort_keys=True))
    out["weight_checksums"] = weight_checksums(port_setup(spec, "cpu"))
    return out


def load_golden(path: str = GOLDEN_PATH) -> Dict:
    with np.load(path, allow_pickle=False) as z:
        golden = {k: z[k] for k in z.files}
    golden["spec"] = json.loads(str(golden["spec"]))
    return golden


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    golden = make_golden(FULL_SPEC)
    os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
    tmp = GOLDEN_PATH + ".tmp.npz"
    np.savez_compressed(tmp, **golden)
    os.replace(tmp, GOLDEN_PATH)
    print(f"wrote {GOLDEN_PATH} ({os.path.getsize(GOLDEN_PATH)} bytes): "
          + ", ".join(f"{k} {v.shape}" for k, v in golden.items()))


if __name__ == "__main__":
    main()
