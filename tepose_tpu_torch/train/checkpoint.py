"""Training checkpoints in the JAX package's npz + json container.

Port of `tepose_tpu/train/checkpoint.py` (`save_checkpoint`,
`load_checkpoint`, `mark_best`): one `.npz` of the flattened trees ("a/b/c"
keys) and a JSON sidecar of scalars, written atomically. The trees are the
JAX layouts, so a checkpoint of either package resumes in the other:

  gen         the generator's param tree (`TePose.state_dict` paths);
  disc        the discriminator's params, disc_state its BN statistics and
              adjacency constants (`weights.disc_jax_trees_from_state_dict`);
  gen_opt,    {"leaves": [...]}: the optimizer state in optax's flatten
  disc_opt    order (`train.optim.opt_state_leaves`).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from tepose_tpu_torch.train.optim import (
    load_opt_state_leaves, opt_state_leaves)
from tepose_tpu_torch.weights import (  # noqa: F401  (load_checkpoint)
    disc_jax_trees_from_state_dict, disc_state_dict_from_jax, flatten_tree,
    jax_tree_from_state_dict, load_checkpoint, state_dict_from_jax_tree)


def _json_sidecar(path: str) -> str:
    return os.path.splitext(path)[0] + ".json"


def save_checkpoint(path: str, trees: Dict[str, Any],
                    scalars: Optional[Dict[str, Any]] = None) -> None:
    """Save named trees of numpy arrays + scalar metadata; `path` ends in
    .npz. Writes go through a temporary file and `os.replace`."""
    flat: Dict[str, np.ndarray] = {}
    for name, tree in trees.items():
        flat.update(flatten_tree(tree, name))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    meta = _json_sidecar(path)
    with open(meta + ".tmp", "w") as f:
        json.dump(scalars or {}, f, indent=2)
    os.replace(meta + ".tmp", meta)


def mark_best(logdir: str) -> None:
    """Copy checkpoint.npz -> model_best.npz (and its sidecar)."""
    src = os.path.join(logdir, "checkpoint.npz")
    shutil.copyfile(src, os.path.join(logdir, "model_best.npz"))
    meta = _json_sidecar(src)
    if os.path.isfile(meta):
        shutil.copyfile(meta, os.path.join(logdir, "model_best.json"))


def training_trees(gen: torch.nn.Module, disc: torch.nn.Module,
                   gen_opt: torch.optim.Optimizer,
                   disc_opt: torch.optim.Optimizer) -> Dict[str, Any]:
    """The training state as the JAX checkpoint's trees."""
    disc_params, disc_state = disc_jax_trees_from_state_dict(
        disc.state_dict())
    return {"gen": jax_tree_from_state_dict(gen.state_dict()),
            "disc": disc_params, "disc_state": disc_state,
            "gen_opt": {"leaves": opt_state_leaves(gen_opt)},
            "disc_opt": {"leaves": opt_state_leaves(disc_opt)}}


def load_training_trees(trees: Dict[str, Any], gen: torch.nn.Module,
                        disc: torch.nn.Module,
                        gen_opt: Optional[torch.optim.Optimizer] = None,
                        disc_opt: Optional[torch.optim.Optimizer] = None
                        ) -> None:
    """Load checkpoint trees (either package's) into the generator (a
    `TePose`, whose cached eval pack is dropped), the discriminator and,
    when the checkpoint has them, the optimizers."""
    with torch.no_grad():
        gen.load_state_dict(state_dict_from_jax_tree(trees["gen"]))
        disc.load_state_dict(disc_state_dict_from_jax(trees["disc"],
                                                      trees["disc_state"]))
    gen.drop_fast_pack()
    if "gen_opt" in trees and gen_opt is not None:
        load_opt_state_leaves(gen_opt, trees["gen_opt"]["leaves"])
    if "disc_opt" in trees and disc_opt is not None:
        load_opt_state_leaves(disc_opt, trees["disc_opt"]["leaves"])
