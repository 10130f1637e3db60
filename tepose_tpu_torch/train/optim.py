"""Optimisers, their optax-layout state, and LR scheduling.

Port of `tepose_tpu/train/optim.py`. `make_optimizer` builds torch's Adam or
SGD with the semantics of the JAX package's optax chains:

  * Adam: L2 decay added to the gradient before the moments
    (`add_decayed_weights` then `scale_by_adam`), i.e. torch Adam's
    `weight_decay`, not AdamW; b1 0.9, b2 0.999, eps 1e-8.
  * SGD: decay added to the gradient, then torch momentum
    (buf = mu * buf + grad; step -lr * buf), which is `optax.trace`.

The parameters are passed by name in the flatten order of the JAX param
tree (dict keys sorted, list entries by index), so the optimizer state maps
leaf for leaf onto optax's `inject_hyperparams` state: `opt_state_leaves` /
`load_opt_state_leaves` read and write it as the list the JAX checkpoints
store under `{"leaves": [...]}`. `take_step` is the only place a step is
taken; it also counts steps, optax's `count`.

`ReduceLROnPlateau` is a copy of the JAX package's (torch semantics,
mode 'min', relative threshold), pinned equal by tests/test_torch_train.py.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
from torch import nn


def jax_leaf_order(names) -> List[str]:
    """Dotted state_dict names in the flatten order of the JAX tree whose
    paths they are: dict keys sorted, list indices in order."""
    return sorted(names, key=lambda n: tuple(
        (0, int(s), "") if s.isdigit() else (1, 0, s) for s in n.split(".")))


def make_optimizer(name: str, module: nn.Module, lr: float,
                   weight_decay: float = 0.0,
                   momentum: float = 0.9) -> torch.optim.Optimizer:
    """torch Adam or SGD over `module`'s parameters in JAX leaf order."""
    params = dict(module.named_parameters())
    named = [(n, params[n]) for n in jax_leaf_order(params)]
    name = name.lower()
    if name == "adam":
        opt = torch.optim.Adam(named, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=weight_decay)
    elif name == "sgd":
        opt = torch.optim.SGD(named, lr=lr, momentum=momentum,
                              weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    opt.param_groups[0]["count"] = 0
    return opt


def take_step(opt: torch.optim.Optimizer) -> None:
    """One update from the parameters' gradients. A parameter the loss did
    not reach gets a zero gradient first, so, as under optax, every leaf
    steps (weight decay and the moments move it all the same)."""
    for p in opt.param_groups[0]["params"]:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()
    opt.param_groups[0]["count"] += 1


def get_lr(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


def set_lr(opt: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    for g in opt.param_groups:
        g["lr"] = float(lr)
    return opt


def _is_adam(opt) -> bool:
    return isinstance(opt, torch.optim.Adam)


def opt_state_leaves(opt: torch.optim.Optimizer) -> List[np.ndarray]:
    """The optimizer's state as optax flattens its `inject_hyperparams`
    state: [count, learning_rate, (Adam: count, mu..., nu...) or (SGD:
    trace...)], leaves in JAX param order."""
    g = opt.param_groups[0]
    count = np.asarray(g["count"], np.int32)
    out = [count, np.asarray(g["lr"], np.float32)]
    slots = (("exp_avg", "exp_avg_sq") if _is_adam(opt)
             else ("momentum_buffer",))
    if _is_adam(opt):
        out.append(count.copy())
    for slot in slots:
        for p in g["params"]:
            buf = opt.state.get(p, {}).get(slot)
            out.append(np.zeros(tuple(p.shape), np.float32) if buf is None
                       else buf.detach().cpu().numpy().copy())
    return out


def load_opt_state_leaves(opt: torch.optim.Optimizer, leaves) -> None:
    """Inverse of `opt_state_leaves`: set the state from optax-order leaves
    (a checkpoint of either package)."""
    g = opt.param_groups[0]
    params = g["params"]
    adam = _is_adam(opt)
    n_slots = 2 if adam else 1
    head = 3 if adam else 2
    if len(leaves) != head + n_slots * len(params):
        raise ValueError(f"optimizer state has {len(leaves)} leaves, "
                         f"expected {head + n_slots * len(params)}")
    g["count"] = int(np.asarray(leaves[0]))
    set_lr(opt, float(np.asarray(leaves[1])))
    opt.state.clear()
    step = int(np.asarray(leaves[2])) if adam else g["count"]
    if step == 0:
        return
    slots = ("exp_avg", "exp_avg_sq") if adam else ("momentum_buffer",)
    for i, p in enumerate(params):
        st = {}
        for s, slot in enumerate(slots):
            st[slot] = torch.as_tensor(
                np.asarray(leaves[head + s * len(params) + i], np.float32),
                device=p.device).clone()
        if adam:
            st["step"] = torch.tensor(float(step))
        opt.state[p] = st


@dataclasses.dataclass
class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (mode='min',
    threshold_mode='rel', the defaults used at train.py:86-100)."""

    patience: int = 5
    factor: float = 0.1
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: Optional[float] = None
    num_bad_epochs: int = 0

    def step(self, metric: float, lr: float) -> float:
        """Feed the epoch metric; returns the (possibly reduced) lr."""
        if self.best is None or metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            return max(lr * self.factor, self.min_lr)
        return lr

    def state_dict(self) -> dict:
        return {"patience": self.patience, "factor": self.factor,
                "threshold": self.threshold, "min_lr": self.min_lr,
                "best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)
