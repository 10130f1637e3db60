"""Training checkpoints in the JAX package's npz + json container, and the
released PyTorch checkpoints' conversion to and from it.

Port of `tepose_tpu/train/checkpoint.py` (`save_checkpoint`,
`load_checkpoint`, `mark_best`, and the converters `strip_module_prefix`,
`convert_torch_generator`, `convert_torch_discriminator`,
`export_torch_generator`, `export_torch_discriminator`): one `.npz` of the
flattened trees ("a/b/c" keys) and a JSON sidecar of scalars, written
atomically. The trees are the JAX layouts, so a checkpoint of either
package resumes in the other:

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
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tepose_tpu_torch.train.optim import (
    load_opt_state_leaves, opt_state_leaves)
from tepose_tpu_torch.weights import (  # noqa: F401  (load_checkpoint)
    SEP, disc_jax_trees_from_state_dict, disc_state_dict_from_jax,
    flatten_tree, jax_tree_from_state_dict, load_checkpoint,
    state_dict_from_jax_tree)


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


# ---------------------------------------------------------------------------
# Released PyTorch state_dicts <-> the JAX param trees (numpy leaves)
# ---------------------------------------------------------------------------


def _to_np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t,
                      dtype=np.float32)


def strip_module_prefix(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Drop the 'module.' prefix DataParallel-era torch checkpoints carry."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def convert_torch_generator(state_dict: Dict[str, Any]) -> Dict:
    """A TePose/VIBE generator torch state_dict -> the generator's param tree:

      encoder.{gru_fwd,gru_rec,gru}.*          -> encoder/<gru>/...
      encoder.{linear_fwd,linear_rec,linear}.* -> encoder/<linear>/...
      regressor.{fc1,fc2,decpose,decshape,deccam}.*, regressor.init_*
                                               -> regressor/...
      encoder.attention.*, regressor.smpl.*    -> dropped (unused by the
                                                  forward; SMPL constants
                                                  live in the SmplModel)

    Layouts are identical (Linear (out, in); GRU (3H, in), gates r, z, n),
    so conversion is renaming only."""
    params: Dict[str, Any] = {"encoder": {}, "regressor": {}}
    for key, val in strip_module_prefix(state_dict).items():
        parts = key.split(".")
        if parts[0] == "encoder":
            if parts[1] in ("gru_fwd", "gru_rec", "gru", "linear_fwd",
                            "linear_rec", "linear"):
                params["encoder"].setdefault(parts[1], {})[parts[2]] = \
                    _to_np(val)
        elif parts[0] == "regressor":
            if parts[1] in ("fc1", "fc2", "decpose", "decshape", "deccam"):
                params["regressor"].setdefault(parts[1], {})[parts[2]] = \
                    _to_np(val)
            elif parts[1] in ("init_pose", "init_shape", "init_cam"):
                params["regressor"][parts[1]] = _to_np(val)
    return params


def _put(tree, path, val) -> None:
    node = tree
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = np.asarray(val, np.float32)


def _put_mlp(params, state, block, parts, v, sub) -> None:
    """Torch MLP Sequential: layers.0 = Conv2d, layers.1 = BN; parts =
    [..., 'mlp', 'layers', idx, leaf]. The JAX MLP has one [conv, bn]
    pair."""
    idx, leaf = int(parts[-2]), parts[-1]
    p_block = params[block] if sub is None else params[block][sub]
    s_block = state[block] if sub is None else state[block][sub]
    if idx % 3 == 0:  # conv
        _put(p_block, ["mlp", "layers", 0, "conv", leaf],
             v[..., 0, 0] if leaf == "weight" else v)
    elif leaf in ("weight", "bias"):
        _put(p_block, ["mlp", "layers", 0, "bn", leaf], v)
    elif leaf in ("running_mean", "running_var"):
        _put(s_block, ["mlp", "layers", 0, "bn", leaf], v)


def convert_torch_discriminator(state_dict: Dict[str, Any]
                                ) -> Tuple[Dict, Dict]:
    """A MotionDiscriminatorGCN torch state_dict -> the JAX discriminator's
    (params, state) trees. The skeleton is the port's `MotionDiscriminator`
    at its defaults (its constant adjacencies `A_powers` / `A_scales`, which
    the reference does not save); torch conv kernels are squeezed:

      Conv2d 1x1 (O, I, 1, 1)           -> (O, I)
      TemporalConv (O, I, k, 1)         -> (O, I, k)
      MS-G3D out Conv3d (O, C, 1, w, 1) -> (O, C, w)

    As in the JAX converter, a residual or out BN's `num_batches_tracked`
    lands in the state tree."""
    from tepose_tpu_torch.models.gcn import MotionDiscriminator

    params, state = disc_jax_trees_from_state_dict(MotionDiscriminator(
        generator=torch.Generator().manual_seed(0), device="cpu"
    ).state_dict())
    for key, val in strip_module_prefix(state_dict).items():
        v = _to_np(val)
        parts = key.split(".")
        name = parts[0]
        if name == "data_bn":
            if parts[1] in ("weight", "bias"):
                _put(params, ["data_bn", parts[1]], v)
            elif parts[1] in ("running_mean", "running_var"):
                _put(state, ["data_bn", parts[1]], v)
        elif name == "fc":
            _put(params, ["fc", parts[1]], v)
        elif name.startswith("residual_"):
            if parts[1] == "conv":
                _put(params, [name, "conv", parts[2]],
                     v[..., 0] if parts[2] == "weight" else v)
            elif parts[1] == "bn":
                tgt = params if parts[2] in ("weight", "bias") else state
                _put(tgt, [name, "bn", parts[2]], v)
        elif name.startswith("sgcn"):
            if parts[1] == "A_res":
                _put(params, [name, "A_res"], v)
            elif parts[1] == "mlp":
                _put_mlp(params, state, name, parts, v, sub=None)
        elif name.startswith("gcn3d"):
            if parts[1] == "gcn3d":  # Sequential: [1] = SpatialTemporal GCN
                if parts[3] == "A_res":
                    _put(params, [name, "st", "A_res"], v)
                elif parts[3] == "mlp":
                    _put_mlp(params, state, name, parts[2:], v, sub="st")
            elif parts[1] == "out_conv":
                _put(params, [name, "out_conv", parts[2]],
                     v[:, :, 0, :, 0] if parts[2] == "weight" else v)
            elif parts[1] == "out_bn":
                tgt = params if parts[2] in ("weight", "bias") else state
                _put(tgt, [name, "out_bn", parts[2]], v)
    return params, state


def export_torch_generator(params: Dict) -> Dict[str, np.ndarray]:
    """Inverse of `convert_torch_generator`: the generator's param tree ->
    a flat torch-layout dict (renaming only). The reference module also
    owns `regressor.smpl.*` constant buffers; `convert_checkpoint
    --reverse --like` copies them from a template checkpoint."""
    return {k.replace(SEP, "."): np.asarray(v, np.float32)
            for k, v in flatten_tree(params).items()}


def _disc_torch_key(parts) -> str:
    """One of the JAX discriminator's tree paths -> the torch key:

      gcn3dN/st/...            -> gcn3dN.gcn3d.1....   (Sequential slot 1)
      .../mlp/layers/0/conv/x  -> ....mlp.layers.0.x   (Conv2d at idx 3k)
      .../mlp/layers/0/bn/x    -> ....mlp.layers.1.x   (BN at idx 3k+1)
    """
    if parts[0].startswith("gcn3d") and parts[1] == "st":
        base, rest = [parts[0], "gcn3d", "1"], parts[2:]
    else:
        base, rest = [parts[0]], parts[1:]
    if rest[:2] == ["mlp", "layers"]:
        idx = int(rest[2]) * 3 + (0 if rest[3] == "conv" else 1)
        return ".".join(base + ["mlp", "layers", str(idx), rest[4]])
    return ".".join(base + rest)


def export_torch_discriminator(params: Dict, state: Dict
                               ) -> Dict[str, np.ndarray]:
    """Inverse of `convert_torch_discriminator`: (params, state) -> a flat
    torch-layout dict, the squeezed conv kernels expanded again

      TemporalConv (O, I, k) -> Conv2d (O, I, k, 1)
      MLP conv     (O, I)    -> Conv2d (O, I, 1, 1)
      MS-G3D out   (O, C, w) -> Conv3d (O, C, 1, w, 1)

    The constant adjacencies are left out (plain attributes in the
    reference), and every BN gets a zero `num_batches_tracked`."""
    out: Dict[str, np.ndarray] = {}
    for key, val in flatten_tree(params).items():
        parts = key.split(SEP)
        v = np.asarray(val, np.float32)
        if parts[-1] == "weight":
            if "out_conv" in parts:
                v = v[:, :, None, :, None]
            elif parts[0].startswith("residual_") and "conv" in parts:
                v = v[..., None]
            elif "mlp" in parts and "conv" in parts:
                v = v[..., None, None]
        out[_disc_torch_key(parts)] = v
    for key, val in flatten_tree(state).items():
        parts = key.split(SEP)
        if parts[-1] in ("A_powers", "A_scales"):
            continue
        out[_disc_torch_key(parts)] = np.asarray(val, np.float32)
        if parts[-1] == "running_mean":
            tracked = _disc_torch_key(parts[:-1] + ["num_batches_tracked"])
            out[tracked] = np.asarray(0, np.int64)
    return out
