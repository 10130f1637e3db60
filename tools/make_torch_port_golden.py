#!/usr/bin/env python
"""Write the JAX golden that the PyTorch port is held to on the GPU.

The GPU host has no JAX, so this script runs the JAX eval rollout
(`tepose_tpu.eval.evaluator.make_eval_scan`, strict float32) here, on the
CPU, on inputs and weights that the port can rebuild from seeds alone:

  * TePose and VIBE weights drawn by the port's own modules from
    `torch.Generator().manual_seed(...)`, exported with
    `tepose_tpu_torch.weights.jax_tree_from_state_dict`;
  * `synthetic_smpl_model(seed)` and the synthetic H36M J_regressor, equal
    element for element in both packages;
  * videos from `synthetic_eval_data` (numpy RandomState), padded into one
    batch by the port's `make_eval_batch`.

The file keeps only the spec (seeds and shapes), weight checksums and the
outputs (pred_j3d, pred_theta, mpvpe). `chip_smoke.py` rebuilds the rest.

  python tools/make_torch_port_golden.py      # writes GOLDEN_PATH

Only `jax_rollout` imports JAX, so the torch-side helpers here can be
imported on a host without it.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

GOLDEN_PATH = os.path.join(REPO, "tests", "golden", "torch_port_eval_f32.npz")

# Full width of configs/repr_wopw_3dpw_model.yaml and the bootstrap VIBE.
FULL_SPEC = dict(seqlen=6, n_layers=2, hidden_size=1024,
                 vibe_n_layers=2, vibe_hidden_size=1024,
                 num_verts=6890, smpl_seed=0, gen_seed=0, vibe_seed=1,
                 data_seed=5, num_videos=2, min_len=40, max_len=44)


def port_setup(spec: Dict, device: torch.device | str) -> Dict:
    """The rollout's models and inputs on `device`, rebuilt from `spec`."""
    from tepose_tpu_torch.evaluate import (
        make_eval_batch, synthetic_eval_data, synthetic_j_regressor)
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
    smpl = synthetic_smpl_model(spec["smpl_seed"], spec["num_verts"],
                                device=device)
    data = synthetic_eval_data(spec["num_videos"], spec["min_len"],
                               spec["max_len"], spec["data_seed"])
    names = sorted(data)
    T_pad = max(len(data[n]["features"]) for n in names)
    batch = make_eval_batch(data, names, spec["seqlen"], T_pad, len(names))
    return {
        "gen": gen.eval(), "vibe": vibe.eval(), "smpl": smpl,
        "j_regressor": torch.as_tensor(
            synthetic_j_regressor(spec["num_verts"]), device=device),
        "batch": batch,
        "num_windows": T_pad - spec["seqlen"] + 1,
    }


def weight_checksums(setup: Dict) -> np.ndarray:
    """(sum, sum of |.|) in float64 over each model's state_dict, to catch a
    change in the generator's stream before comparing outputs."""
    sums = []
    for name in ("gen", "vibe"):
        vals = [v.detach().cpu().numpy().astype(np.float64).ravel()
                for v in setup[name].state_dict().values()]
        flat = np.concatenate(vals)
        sums += [flat.sum(), np.abs(flat).sum()]
    return np.asarray(sums)


def port_rollout(setup: Dict) -> Dict[str, np.ndarray]:
    """The port's eval rollout on the setup's device, as numpy."""
    from tepose_tpu_torch.eval.evaluator import eval_rollout

    dev = setup["j_regressor"].device
    b = {k: torch.from_numpy(v).to(dev) for k, v in setup["batch"].items()}
    out = eval_rollout(setup["gen"], setup["vibe"], setup["smpl"], b["feats"],
                       b["theta_pseu"], b["theta_gt"], setup["j_regressor"],
                       setup["num_windows"])
    return {k: v.cpu().numpy() for k, v in out.items()}


def jax_rollout(spec: Dict) -> Dict[str, np.ndarray]:
    """The JAX eval rollout (strict float32, CPU) on the port's weights."""
    import jax

    from tepose_tpu.eval.evaluator import make_eval_scan
    from tepose_tpu.models.smpl import synthetic_smpl_model
    from tepose_tpu.models.tepose import TePoseConfig, VibeConfig
    from tepose_tpu_torch.weights import jax_tree_from_state_dict

    setup = port_setup(spec, "cpu")
    mcfg = TePoseConfig(spec["seqlen"], spec["n_layers"], spec["hidden_size"])
    vcfg = VibeConfig(n_layers=spec["vibe_n_layers"],
                      hidden_size=spec["vibe_hidden_size"])
    smpl = synthetic_smpl_model(spec["smpl_seed"], spec["num_verts"])
    fn = make_eval_scan(smpl, mcfg, vcfg, setup["num_windows"],
                        use_j_regressor=True)
    b = setup["batch"]
    with jax.default_matmul_precision("float32"):
        out = fn(jax_tree_from_state_dict(setup["gen"].state_dict()),
                 jax_tree_from_state_dict(setup["vibe"].state_dict()),
                 b["feats"], b["theta_pseu"], b["theta_gt"],
                 setup["j_regressor"].numpy())
    return {k: np.asarray(v) for k, v in out.items()}


def make_golden(spec: Dict) -> Dict[str, np.ndarray]:
    """Everything the golden file holds, for `spec`."""
    out = jax_rollout(spec)
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
