#!/usr/bin/env python
"""The bf16 training gate: one window of bf16 compute against float32.

`TrainHyper(compute_dtype="bfloat16")` must give the gradients of the
float32 step up to bf16 rounding. As the JAX package's gate
(tests/test_trainer.py::test_bf16_compute_gradient_agreement), one window
runs from the same weights with SGD at lr 1, update_theta_rate 1 and the
same dropout draws, so the parameters' change is the (negated) gradient of
both nets, and the two changes are compared:

  * cosine > 0.98, relative norm of the difference < 0.2;
  * gen_loss and dis_loss within 5 % relative;
  * every metric float32 and finite; the master parameters, their
    gradients, the optimizer state and the BN running statistics float32.

`port_window` runs the port (any device, for chip_smoke.py's full-width
gate), `jax_window` the JAX segment on the port's weights and batch (the
CPU tests only; it imports JAX), `gate` returns each measure beside its
bar. Weights and data come from `make_torch_train_golden.port_setup` and
`make_batch` for a spec.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import make_torch_train_golden as tg  # noqa: E402

COSINE_MIN, REL_NORM_MAX, LOSS_RTOL = 0.98, 0.2, 0.05
DROPOUT_SEED = 7


def _flat_params(setup: Dict) -> Dict[str, np.ndarray]:
    from tepose_tpu_torch.weights import (
        disc_jax_trees_from_state_dict, flatten_tree,
        jax_tree_from_state_dict)

    dp, _ = disc_jax_trees_from_state_dict(setup["disc"].state_dict())
    gen = flatten_tree(jax_tree_from_state_dict(setup["gen"].state_dict()))
    return {**{f"gen/{k}": np.array(v) for k, v in gen.items()},
            **{f"disc/{k}": np.array(v) for k, v in flatten_tree(dp).items()}}


def float32_state(setup: Dict) -> list:
    """Names of the master parameters, gradients, optimizer state entries
    and BN running statistics that are not float32 (empty: all are)."""
    bad = []
    for group in ("gen", "disc"):
        m, opt = setup[group], setup[f"{group}_opt"]
        for name, p in m.named_parameters():
            if p.dtype != torch.float32:
                bad.append(f"{group} parameter {name}")
            if p.grad is not None and p.grad.dtype != torch.float32:
                bad.append(f"{group} gradient {name}")
        for name, b in m.named_buffers():
            if name.endswith(("running_mean", "running_var")) and \
                    b.dtype != torch.float32:
                bad.append(f"{group} buffer {name}")
        for state in opt.state.values():
            for k, v in state.items():
                if torch.is_tensor(v) and v.is_floating_point() and \
                        v.dtype != torch.float32:
                    bad.append(f"{group} optimizer state {k}")
    return bad


def port_window(spec: Dict, device, compute_dtype: Optional[str],
                dropout: bool = True, **hp) -> Dict:
    """One window of the port's segment with SGD at lr 1 from the spec's
    seeded weights. Returns {"delta": the parameters' change (flat, JAX
    leaf names sorted), "metrics", "float32_state": `float32_state`}."""
    from tepose_tpu_torch.train.optim import make_optimizer
    from tepose_tpu_torch.train.trainer import train_segment

    setup = tg.port_setup(spec, device)
    setup["hp"] = dataclasses.replace(setup["hp"], update_theta_rate=1.0,
                                      compute_dtype=compute_dtype, **hp)
    for group in ("gen", "disc"):
        setup[f"{group}_opt"] = make_optimizer("sgd", setup[group], 1.0)
    before = _flat_params(setup)
    gen = (torch.Generator(device=device).manual_seed(DROPOUT_SEED)
           if dropout else None)
    metrics = train_segment(
        setup["gen"], setup["disc"], setup["smpl"], setup["gen_opt"],
        setup["disc_opt"], setup["hp"], setup["weights"], setup["batch_2d"],
        setup["batch_3d"], setup["amass"][:1], gen)
    after = _flat_params(setup)
    return {"delta": np.concatenate([(after[k] - before[k]).ravel()
                                     for k in sorted(before)]),
            "metrics": metrics, "float32_state": float32_state(setup)}


def jax_window(spec: Dict, compute_dtype: Optional[str]) -> Dict:
    """The JAX segment's one window (make_train_segment, SGD at lr 1,
    dropout off, update_theta_rate 1) on the port's weights and batch for
    `spec`: {"delta", "metrics"} in `port_window`'s layout."""
    import jax
    import jax.numpy as jnp

    from tepose_tpu.models.smpl import synthetic_smpl_model
    from tepose_tpu.models.tepose import TePoseConfig
    from tepose_tpu.train.loss import LossWeights
    from tepose_tpu.train.optim import make_optimizer
    from tepose_tpu.train.trainer import TrainHyper, make_train_segment
    from tepose_tpu_torch.weights import (
        disc_jax_trees_from_state_dict, flatten_tree,
        jax_tree_from_state_dict)

    setup = tg.port_setup(spec, "cpu")
    gen0 = jax_tree_from_state_dict(setup["gen"].state_dict())
    dp0, ds0 = disc_jax_trees_from_state_dict(setup["disc"].state_dict())
    hp = TrainHyper(**{k: getattr(setup["hp"], k) for k in (
        "seqlen", "n_2d", "n_3d", "disc_update_steps", "num_gcn_scales",
        "num_g3d_scales")}, update_theta_rate=1.0,
        compute_dtype=compute_dtype)
    tx = make_optimizer("sgd", 1.0)
    seg = make_train_segment(
        synthetic_smpl_model(spec["smpl_seed"], spec["num_verts"]),
        TePoseConfig(spec["seqlen"], spec["n_layers"], spec["hidden_size"],
                     fast_encoder=True), hp, tx, tx, LossWeights(), 1)

    def fresh(t):  # the segment donates its arguments
        return jax.tree_util.tree_map(lambda x: jnp.array(np.asarray(x)), t)

    def tree(d):
        return {k: jnp.asarray(v) for k, v in d.items()}

    with tg.jax_dropout_off(), jax.default_matmul_precision("float32"):
        gp, dp, _, _, _, metrics = seg(
            fresh(gen0), fresh(dp0), fresh(ds0), tx.init(fresh(gen0)),
            tx.init(fresh(dp0)), tree(setup["batch_2d"]),
            tree(setup["batch_3d"]), jnp.asarray(setup["amass"][:1]),
            jax.random.PRNGKey(0))
    before = {**{f"gen/{k}": v for k, v in flatten_tree(gen0).items()},
              **{f"disc/{k}": v for k, v in flatten_tree(dp0).items()}}
    after = {**{f"gen/{k}": v for k, v in
                flatten_tree(jax.device_get(gp)).items()},
             **{f"disc/{k}": v for k, v in
                flatten_tree(jax.device_get(dp)).items()}}
    return {"delta": np.concatenate([
                (np.asarray(after[k]) - np.asarray(before[k])).ravel()
                for k in sorted(before)]),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "metric_dtypes": {k: str(np.asarray(v).dtype)
                              for k, v in metrics.items()}}


def gate(want: Dict, got: Dict) -> Dict[str, tuple]:
    """(measure, bar, passed) of `got` (bf16) against `want` (float32 or
    another bf16 run): update cosine, relative norm of the difference,
    gen_loss and dis_loss relative; and, for a port run, whether every
    metric is finite and all state float32."""
    a = want["delta"].astype(np.float64)
    b = got["delta"].astype(np.float64)
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))
    rel = float(np.linalg.norm(b - a) / (np.linalg.norm(a) + 1e-30))
    out = {"cosine": (cos, COSINE_MIN, cos > COSINE_MIN),
           "relative_norm": (rel, REL_NORM_MAX, rel < REL_NORM_MAX)}
    for k in ("gen_loss", "dis_loss"):
        x, y = want["metrics"][k], got["metrics"][k]
        r = abs(x - y) / (abs(x) + 1e-9)
        out[k] = (r, LOSS_RTOL, r < LOSS_RTOL)
    if "float32_state" in got:
        finite = all(np.isfinite(v) for v in got["metrics"].values())
        out["metrics_finite"] = (float(finite), 1.0, finite)
        n_bad = len(got["float32_state"])
        out["non_float32_state"] = (float(n_bad), 0.0, n_bad == 0)
    return out
