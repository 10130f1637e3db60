#!/usr/bin/env python
"""Write the JAX training golden that the PyTorch port is held to on the GPU.

The GPU host has no JAX, so this script runs the JAX training segment
(`tepose_tpu.train.trainer.make_train_segment`, float32) here, on the CPU,
on weights and data that the port rebuilds from seeds alone:

  * TePose (fast encoder) and the GCN motion discriminator drawn by the
    port's own modules from `torch.Generator().manual_seed(...)`, exported
    to JAX trees (`weights.jax_tree_from_state_dict`,
    `disc_jax_trees_from_state_dict`);
  * `synthetic_smpl_model(seed, num_verts)`, equal in both packages;
  * one batch of the loaders' shapes from `np.random.RandomState`
    (`make_batch`): 2D rows with a clip-channel switch, 3D rows with and
    without SMPL labels, one 3D row whose video ends after two windows,
    and an AMASS window per training window.

Dropout is off on both sides (patched out of `tepose_tpu.models.layers` in
this process only) and `update_theta_rate` is 1.0, so no random draw
enters. For K = 1 and K = 3 windows from the same start it stores the
segment's mean losses, the discriminator's BN running statistics, a few
parameter leaves and both optimizers' Adam step counts after the segment,
and sum ||g||^2 over both nets' gradients of window 1 (from the JAX
segment's `mode="grad"`), plus the spec and the weights' checksums.

  python tools/make_torch_train_golden.py     # writes GOLDEN_PATH

Only `jax_segments` and `main` import JAX, so the torch-side helpers here
can be imported on a host without it.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Dict

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

GOLDEN_PATH = os.path.join(REPO, "tests", "golden",
                           "torch_port_train_f32.npz")

# Full width of configs/repr_wopw_3dpw_model.yaml (train.py's model: fast
# encoder; batch 32 = 19 2D + 13 3D rows; both optimizers as configured).
FULL_SPEC = dict(seqlen=6, n_layers=2, hidden_size=1024, num_verts=6890,
                 n_2d=19, n_3d=13, vidlen=10, num_gcn_scales=13,
                 num_g3d_scales=6, gen_lr=5e-5, gen_wd=0.0, disc_lr=1e-4,
                 disc_wd=1e-4, disc_update_steps=1, smpl_seed=0, gen_seed=0,
                 disc_seed=1, data_seed=11, windows=(1, 3))

# Parameter leaves kept after each segment (state_dict names).
GEN_LEAVES = ("regressor.deccam.weight", "regressor.deccam.bias",
              "regressor.init_cam", "encoder.gru_fwd.bias_hh_l0")
DISC_LEAVES = ("fc.weight", "fc.bias")


def make_batch(spec: Dict) -> Dict[str, np.ndarray]:
    """One training batch as the loaders give it, plus AMASS windows for
    the longest segment, from `spec["data_seed"]`."""
    rs = np.random.RandomState(spec["data_seed"])
    S, VL = spec["seqlen"], spec["vidlen"]
    b2, b3 = spec["n_2d"], spec["n_3d"]
    K = max(spec["windows"])
    # 2D rows: channel 0 active, then channel 1 from a per-row frame that
    # falls inside the segment's targets for half of the rows
    switch = np.zeros((b2, 2, VL), np.float32)
    for b in range(b2):
        at = S + b % 3 if b % 2 == 0 else VL
        switch[b, 0, :at] = 1
        switch[b, 1, at:] = 1
    batch_2d = {
        "features": rs.randn(b2, 2, VL, 2048).astype(np.float32) * 0.1,
        "theta_pseu": rs.randn(b2, 2, VL, 85).astype(np.float32) * 0.1,
        "kp_2d": np.concatenate(
            [rs.randn(b2, VL, 49, 2) * 0.5,
             rs.rand(b2, VL, 49, 1)], -1).astype(np.float32),
        "switch_id": switch,
        "vidlen_each": np.full((b2,), VL, np.float32),
    }
    w_smpl = np.ones((b3, VL), np.float32)
    w_smpl[1::3] = 0.0                       # 3D rows in the GAN
    vidlen3 = np.full((b3,), VL, np.float32)
    vidlen3[2] = S + 1                       # valid at windows 0 and 1 only
    theta = rs.randn(b3, VL, 85).astype(np.float32) * 0.2
    theta[..., :3] = [1.0, 0.0, 0.0]
    batch_3d = {
        "features": rs.randn(b3, VL, 2048).astype(np.float32) * 0.1,
        "theta_pseu": rs.randn(b3, VL, 85).astype(np.float32) * 0.1,
        "kp_2d": np.concatenate(
            [rs.randn(b3, VL, 49, 2) * 0.5,
             rs.rand(b3, VL, 49, 1)], -1).astype(np.float32),
        "kp_3d": rs.randn(b3, VL, 49, 3).astype(np.float32) * 0.3,
        "theta": theta,
        "w_3d": np.ones((b3, VL), np.float32),
        "w_smpl": w_smpl,
        "vidlen_each": vidlen3,
    }
    amass = rs.randn(K, b2 + b3, S, 85).astype(np.float32) * 0.2
    amass[..., :3] = [1.0, 0.0, 0.0]
    return {"batch_2d": batch_2d, "batch_3d": batch_3d, "amass": amass}


def port_setup(spec: Dict, device: torch.device | str) -> Dict:
    """The port's models, optimizers and hyperparameters for `spec`, on
    `device`, and the numpy batch."""
    from tepose_tpu_torch.models.gcn import MotionDiscriminator
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model
    from tepose_tpu_torch.models.tepose import TePose, TePoseConfig
    from tepose_tpu_torch.train.loss import LossWeights
    from tepose_tpu_torch.train.optim import make_optimizer
    from tepose_tpu_torch.train.trainer import TrainHyper

    gen = TePose(TePoseConfig(spec["seqlen"], spec["n_layers"],
                              spec["hidden_size"], fast_encoder=True),
                 generator=torch.Generator().manual_seed(spec["gen_seed"]),
                 device=device)
    disc = MotionDiscriminator(
        generator=torch.Generator().manual_seed(spec["disc_seed"]),
        device=device, num_gcn_scales=spec["num_gcn_scales"],
        num_g3d_scales=spec["num_g3d_scales"])
    hp = TrainHyper(seqlen=spec["seqlen"], n_2d=spec["n_2d"],
                    n_3d=spec["n_3d"], update_theta_rate=1.0,
                    disc_update_steps=spec["disc_update_steps"],
                    num_gcn_scales=spec["num_gcn_scales"],
                    num_g3d_scales=spec["num_g3d_scales"])
    return {
        "spec": spec, "gen": gen, "disc": disc, "hp": hp,
        "smpl": synthetic_smpl_model(spec["smpl_seed"], spec["num_verts"],
                                     device=device),
        "gen_opt": make_optimizer("adam", gen, spec["gen_lr"],
                                  spec["gen_wd"]),
        "disc_opt": make_optimizer("adam", disc, spec["disc_lr"],
                                   spec["disc_wd"]),
        "weights": LossWeights(),
        **make_batch(spec),
    }


def weight_checksums(setup: Dict) -> np.ndarray:
    """(sum, sum of |.|) in float64 over each model's state_dict."""
    sums = []
    for name in ("gen", "disc"):
        flat = np.concatenate(
            [v.detach().cpu().numpy().astype(np.float64).ravel()
             for v in setup[name].state_dict().values()])
        sums += [flat.sum(), np.abs(flat).sum()]
    return np.asarray(sums)


def grad_sq(modules) -> float:
    """sum ||g||^2 over the modules' parameter gradients."""
    return float(sum((p.grad.double() ** 2).sum()
                     for m in modules for p in m.parameters()
                     if p.grad is not None))


def adam_steps(opt: torch.optim.Optimizer) -> list:
    """The distinct update counts in torch Adam's own per-parameter state
    (0 for a parameter that never stepped): one value when every parameter
    took every step."""
    return sorted({int(opt.state[p]["step"]) if p in opt.state else 0
                   for p in opt.param_groups[0]["params"]})


def port_segment(setup: Dict, K: int) -> Dict:
    """Run K windows of the port's training segment (dropout off: no
    generator) from the setup's current state, which it advances. Returns
    the mean losses, the state after the segment and, at K = 1, window 1's
    sum ||g||^2 (the step leaves the gradients in `.grad`)."""
    from tepose_tpu_torch.train.trainer import train_segment

    out = {"losses": train_segment(
        setup["gen"], setup["disc"], setup["smpl"], setup["gen_opt"],
        setup["disc_opt"], setup["hp"], setup["weights"],
        setup["batch_2d"], setup["batch_3d"], setup["amass"][:K], None)}
    if K == 1:
        out["grad_sq"] = grad_sq((setup["gen"], setup["disc"]))
    out.update(port_state(setup))
    return out


def port_state(setup: Dict) -> Dict:
    """The modules' state as JAX-layout numpy (gen / disc params, disc
    state) and each optimizer's `adam_steps`."""
    from tepose_tpu_torch.weights import (
        disc_jax_trees_from_state_dict, flatten_tree,
        jax_tree_from_state_dict)

    dp, ds = disc_jax_trees_from_state_dict(setup["disc"].state_dict())
    return {"gen": flatten_tree(jax_tree_from_state_dict(
                setup["gen"].state_dict())),
            "disc": flatten_tree(dp), "disc_state": flatten_tree(ds),
            "adam_steps": {"gen": adam_steps(setup["gen_opt"]),
                           "disc": adam_steps(setup["disc_opt"])}}


@contextlib.contextmanager
def jax_dropout_off():
    """Dropout out of the JAX regressor, in this process only."""
    from tepose_tpu.models import layers

    saved = layers.dropout
    layers.dropout = lambda rng, x, rate, train: x
    try:
        yield
    finally:
        layers.dropout = saved


def jax_segments(spec: Dict) -> Dict:
    """The JAX segment on the port's weights and batch, from the same start
    for each K in spec["windows"] (mode "full"), and K = 1 in mode "grad".
    Returns {K: {"losses", "gen", "disc", "disc_state", "gen_opt",
    "disc_opt"}} (flattened numpy) and "grad_sq"."""
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

    setup = port_setup(spec, "cpu")
    gen0 = jax_tree_from_state_dict(setup["gen"].state_dict())
    dp0, ds0 = disc_jax_trees_from_state_dict(setup["disc"].state_dict())
    smpl = synthetic_smpl_model(spec["smpl_seed"], spec["num_verts"])
    mcfg = TePoseConfig(spec["seqlen"], spec["n_layers"], spec["hidden_size"],
                        fast_encoder=True)
    hp = TrainHyper(**{k: getattr(setup["hp"], k) for k in (
        "seqlen", "n_2d", "n_3d", "update_theta_rate", "disc_update_steps",
        "num_gcn_scales", "num_g3d_scales")})
    gen_tx = make_optimizer("adam", spec["gen_lr"], spec["gen_wd"])
    disc_tx = make_optimizer("adam", spec["disc_lr"], spec["disc_wd"])

    def tree(d):
        return {k: jnp.asarray(v) for k, v in d.items()}

    def fresh(t):  # the segment donates its arguments
        return jax.tree_util.tree_map(lambda x: jnp.array(np.asarray(x)), t)

    res = {}
    runs = [(K, "full") for K in spec["windows"]] + [(1, "grad")]
    with jax_dropout_off(), jax.default_matmul_precision("float32"):
        for K, mode in runs:
            seg = make_train_segment(smpl, mcfg, hp, gen_tx, disc_tx,
                                     LossWeights(), K, mode=mode)
            gp, dp, ds = fresh(gen0), fresh(dp0), fresh(ds0)
            gp, dp, ds, go, do, metrics = seg(
                gp, dp, ds, gen_tx.init(fresh(gen0)), disc_tx.init(fresh(dp0)),
                tree(setup["batch_2d"]), tree(setup["batch_3d"]),
                jnp.asarray(setup["amass"][:K]), jax.random.PRNGKey(0))
            metrics = {k: float(v) for k, v in metrics.items()}
            if mode == "grad":
                res["grad_sq"] = metrics["grad_keepalive"]
                continue
            res[K] = {
                "losses": metrics,
                "gen": flatten_tree(jax.device_get(gp)),
                "disc": flatten_tree(jax.device_get(dp)),
                "disc_state": flatten_tree(jax.device_get(ds)),
                "gen_opt": [np.asarray(x) for x in
                            jax.tree_util.tree_leaves(go)],
                "disc_opt": [np.asarray(x) for x in
                             jax.tree_util.tree_leaves(do)],
            }
    return res


# Adam's own update count among optax's `inject_hyperparams` leaves
# ([count, learning_rate, adam count, mu..., nu...], as opt_state_leaves)
ADAM_COUNT_LEAF = 2


def _bn_keys(disc_state: Dict) -> list:
    return sorted(k for k in disc_state
                  if k.endswith(("running_mean", "running_var")))


def golden_from(spec: Dict, res: Dict) -> Dict[str, np.ndarray]:
    """What the golden file keeps of `jax_segments`' results."""
    out = {"spec": np.asarray(json.dumps(spec, sort_keys=True)),
           "grad_sq": np.asarray(res["grad_sq"], np.float64),
           "weight_checksums": weight_checksums(port_setup(spec, "cpu"))}
    for K in spec["windows"]:
        r = res[K]
        for name, v in r["losses"].items():
            out[f"K{K}/loss/{name}"] = np.asarray(v, np.float64)
        for k in _bn_keys(r["disc_state"]):
            out[f"K{K}/bn/{k}"] = r["disc_state"][k]
        for k in GEN_LEAVES:
            out[f"K{K}/gen/{k}"] = r["gen"][k.replace(".", "/")]
        for k in DISC_LEAVES:
            out[f"K{K}/disc/{k}"] = r["disc"][k.replace(".", "/")]
        for group in ("gen", "disc"):
            out[f"K{K}/adam_steps/{group}"] = np.asarray(
                r[f"{group}_opt"][ADAM_COUNT_LEAF], np.int64)
    return out


def golden_deviation(golden: Dict, port: Dict, K: int) -> Dict[str, tuple]:
    """Per group, (largest deviation, its bar) of a port segment of K
    windows against the golden: mean losses relative, BN running
    statistics relative to each array's largest magnitude, parameter leaves
    absolute (2 * K * lr of their optimizer) and their RMS deviation
    (0.05 lr: a skipped or empty step leaves every element about lr off),
    the optimizers whose Adam step counts differ from JAX's (bar 0), and at
    K = 1 window 1's sum ||g||^2 relative (1e-3).

    The loss and BN bars are 1e-4 at K = 1, where every pass runs before
    any update, and 1e-3 beyond: Adam moves each element by about +-lr
    whatever its gradient's size, and the discriminator's float32 gradient
    has elements whose rounding error exceeds their size (against float64,
    `tools/train_golden_drift.py disc`). JAX and the port round those
    differently and step some of them opposite ways, so the later windows
    see discriminator weights that differ by up to 2 lr there.
    `pair_deviation` holds the card to the port on the CPU at 1e-4."""
    spec = golden["spec"]
    dev = {}
    bar = 1e-4 if K == 1 else 1e-3
    worst = 0.0
    for name, v in port["losses"].items():
        want = float(golden[f"K{K}/loss/{name}"])
        worst = max(worst, abs(v - want) / max(abs(want), 1e-12))
    dev["losses"] = (worst, bar)
    worst = 0.0
    for key in golden:
        if key.startswith(f"K{K}/bn/"):
            want = golden[key]
            got = port["disc_state"][key[len(f"K{K}/bn/"):]]
            worst = max(worst, float(np.abs(got - want).max()
                                     / max(np.abs(want).max(), 1e-12)))
    dev["bn_stats"] = (worst, bar)
    for group, names, lr in (("gen", GEN_LEAVES, spec["gen_lr"]),
                             ("disc", DISC_LEAVES, spec["disc_lr"])):
        d = np.concatenate([(port[group][k.replace(".", "/")]
                             - golden[f"K{K}/{group}/{k}"]).ravel()
                            for k in names])
        dev[f"{group}_leaves"] = (float(np.abs(d).max()), 2.0 * K * lr)
        dev[f"{group}_leaves_rms"] = (float(np.sqrt(np.mean(d ** 2))),
                                      0.05 * lr)
    dev["adam_steps"] = (sum(
        port["adam_steps"][g] != [int(golden[f"K{K}/adam_steps/{g}"])]
        for g in ("gen", "disc")), 0)
    if K == 1:
        want = float(golden["grad_sq"])
        dev["grad_sq"] = (abs(port["grad_sq"] - want) / want, 1e-3)
    return dev


def pair_deviation(got: Dict, want: Dict) -> Dict[str, tuple]:
    """(largest deviation, bar) of one port segment against the same
    segment on another device: mean losses relative and BN running
    statistics relative to each array's largest magnitude, both 1e-4 at
    any K. The port's float32 op sequence is the same on both devices, so
    the opposite Adam steps that part it from JAX do not occur between
    them."""
    losses = max(abs(got["losses"][k] - v) / max(abs(v), 1e-12)
                 for k, v in want["losses"].items())
    bn = max(float(np.abs(got["disc_state"][k] - v).max()
                   / max(np.abs(v).max(), 1e-12))
             for k, v in want["disc_state"].items()
             if k.endswith(("running_mean", "running_var")))
    return {"losses": (losses, 1e-4), "bn_stats": (bn, 1e-4)}


def make_golden(spec: Dict) -> Dict[str, np.ndarray]:
    return golden_from(spec, jax_segments(spec))


def load_golden(path: str = GOLDEN_PATH) -> Dict:
    with np.load(path, allow_pickle=False) as z:
        golden = {k: z[k] for k in z.files}
    golden["spec"] = json.loads(str(golden["spec"]))
    golden["spec"]["windows"] = tuple(golden["spec"]["windows"])
    return golden


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    golden = make_golden(FULL_SPEC)
    os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
    tmp = GOLDEN_PATH + ".tmp.npz"
    np.savez_compressed(tmp, **golden)
    os.replace(tmp, GOLDEN_PATH)
    print(f"wrote {GOLDEN_PATH} ({os.path.getsize(GOLDEN_PATH)} bytes); "
          f"grad_sq {float(golden['grad_sq']):.6e}; "
          + ", ".join(f"{k} {float(v):.6f}" for k, v in golden.items()
                      if "/loss/" in k))


if __name__ == "__main__":
    main()
