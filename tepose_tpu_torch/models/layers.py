"""Linear and GRU layers with the JAX package's initialisations.

Port of `tepose_tpu/models/layers.py`, dropout included. The layers are
`nn.Linear` and
`nn.GRU`, whose parameter names (`weight`, `bias`, `weight_ih_l{k}`,
`bias_hh_l{k}_reverse`, ...), layouts ((out, in); (3H, in)) and GRU gate
order (r, z, n) are the ones the JAX param trees use, so converted trees
load as they are.

Every draw comes from the caller's `torch.Generator` on the CPU and is then
copied to the layer's device, so one seed gives the same weights on any
device. Layers are created on the meta device first so that building them
does not touch the global RNG.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn


def _uniform_(t: torch.Tensor, low: float, high: float,
              generator: torch.Generator) -> None:
    draw = torch.rand(t.shape, generator=generator, dtype=torch.float32)
    t.copy_(draw * (high - low) + low)


@torch.no_grad()
def make_linear(in_dim: int, out_dim: int, *, generator: torch.Generator,
                device: torch.device | str,
                w_scale: Optional[float] = None) -> nn.Linear:
    """nn.Linear with torch's default init, U(-1/sqrt(in), 1/sqrt(in)) for
    weight and bias; with `w_scale`, the weight is Xavier-uniform with that
    gain instead (the regressor heads use 0.01)."""
    lin = nn.Linear(in_dim, out_dim, device="meta").to_empty(device=device)
    bound = 1.0 / np.sqrt(in_dim)
    limit = bound if w_scale is None else w_scale * np.sqrt(
        6.0 / (in_dim + out_dim))
    _uniform_(lin.weight, -limit, limit, generator)
    _uniform_(lin.bias, -bound, bound, generator)
    return lin


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from `generator` (on x's device): each element
    kept with probability 1 - p and scaled by 1 / (1 - p), as
    `tepose_tpu/models/layers.py::dropout`. With no generator it is off,
    the contract of the JAX regressor's `rng=None`."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def gru_update(x_proj: torch.Tensor, h_proj: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    """One GRU step from both projections, torch's gate math (order r, z,
    n), as `tepose_tpu/models/layers.py::_gru_cell`:

      r = sigmoid(x_r + h_r); z = sigmoid(x_z + h_z)
      n = tanh(x_n + r * h_n); h' = (1 - z) * n + z * h

    x_proj = W_ih x + b_ih and h_proj = W_hh h + b_hh, both (..., 3H).
    """
    xr, xz, xn = x_proj.chunk(3, dim=-1)
    hr, hz, hn = h_proj.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


@torch.no_grad()
def make_gru(input_size: int, hidden_size: int, num_layers: int, *,
             bidirectional: bool, generator: torch.Generator,
             device: torch.device | str) -> nn.GRU:
    """Sequence-first nn.GRU, every tensor U(-1/sqrt(H), 1/sqrt(H))."""
    gru = nn.GRU(input_size, hidden_size, num_layers,
                 bidirectional=bidirectional, device="meta")
    gru = gru.to_empty(device=device)
    k = 1.0 / np.sqrt(hidden_size)
    for p in gru.parameters():
        _uniform_(p, -k, k, generator)
    return gru
