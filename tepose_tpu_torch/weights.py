"""Checkpoints and JAX param trees <-> the port's state_dicts.

Port of the numpy parts of `tepose_tpu/train/checkpoint.py`:
`flatten_tree`, `unflatten_tree` and `load_checkpoint` read the JAX
package's `.npz` + `.json` checkpoints (`train.checkpoint` writes them). A
JAX param tree's paths joined with "." are the port modules' `state_dict`
keys (the same renaming as `export_torch_generator`), so conversion is
renaming only; the discriminator's params and state trees together make the
`MotionDiscriminator` state_dict.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

SEP = "/"


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a nested dict/list tree of arrays to {'a/b/0/c': array}."""
    out: Dict[str, np.ndarray] = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{path}{SEP}{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{path}{SEP}{i}" if path else str(i))
        elif node is not None:
            out[path] = np.asarray(node)

    rec(tree, prefix)
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Any:
    """Inverse of flatten_tree. Integer path segments become lists."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read a JAX-package checkpoint: returns (trees, scalars), where trees
    maps each saved name ("gen", ...) to its param tree of numpy arrays."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta_path = os.path.splitext(path)[0] + ".json"
    scalars = {}
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            scalars = json.load(f)
    return unflatten_tree(flat), scalars


def state_dict_from_jax_tree(tree: Any) -> Dict[str, torch.Tensor]:
    """A JAX generator, VIBE or backbone param tree (numpy leaves) -> a
    float32 state_dict for `TePose` / `Vibe` / `ResNet50`; the backbone's
    list-valued `layer1..4` become `layer1.0.conv1.w`, ..."""
    return {k.replace(SEP, "."): torch.from_numpy(np.array(v, np.float32))
            for k, v in flatten_tree(tree).items()}


def jax_tree_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Any:
    """Inverse of `state_dict_from_jax_tree`: numpy param tree for JAX."""
    return unflatten_tree({k.replace(".", SEP): v.detach().cpu().numpy()
                           for k, v in state_dict.items()})


# Leaves of the JAX discriminator's `state` tree; every other leaf is a param.
DISC_STATE_LEAVES = ("running_mean", "running_var", "A_powers", "A_scales")


def disc_state_dict_from_jax(params: Any, state: Any
                             ) -> Dict[str, torch.Tensor]:
    """The JAX discriminator's `(params, state)` trees
    (`motion_discriminator_init`) -> a float32 state_dict for
    `models.gcn.MotionDiscriminator`: the two trees' paths are disjoint and
    together are its keys."""
    out = state_dict_from_jax_tree(params)
    out.update(state_dict_from_jax_tree(state))
    return out


def disc_jax_trees_from_state_dict(state_dict: Mapping[str, torch.Tensor]):
    """Inverse of `disc_state_dict_from_jax`: numpy `(params, state)`."""
    params, state = {}, {}
    for k, v in state_dict.items():
        dst = state if k.rsplit(".", 1)[-1] in DISC_STATE_LEAVES else params
        dst[k] = v
    return jax_tree_from_state_dict(params), jax_tree_from_state_dict(state)
