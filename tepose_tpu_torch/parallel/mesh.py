"""A list of devices for the one-process inference paths, and placement.

Port of `tepose_tpu/parallel/mesh.py`. JAX runs a mesh of devices inside
one process and lets GSPMD split the work; the port's inference paths
(`evaluate --devices`, `StreamingEngine(mesh=)`, `LiveSession(mesh=)`,
`FeatureExtractor(mesh=)`) do the same by hand, with no collectives (eval
and serving rows are independent):

  * `make_mesh` gives a `Mesh`: the devices in order and the axis name;
  * `shard_batch` splits every leaf's leading axis into contiguous row
    blocks, one a device, as `NamedSharding(P("data"))` does;
  * `replicate` copies a module or a tensor tree onto each device;
  * each device runs its rows on its own replica, and outputs come back in
    row order (`gather_rows`).

A device may repeat in an explicit list: torch has no virtual CPU devices,
so tests use `["cpu"] * 4`, and one card runs two shards as
`["cuda:0", "cuda:0"]`. Training shards over processes instead
(`parallel/distributed.py`, `parallel/dp.py`).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices along one data axis."""

    devices: tuple
    axis_name: str = DATA_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D data mesh over `devices` (any torch devices, repeats allowed)
    or, without them, over the first `n_devices` visible CUDA devices (all
    of them by default). Asking for more CUDA devices than are visible
    raises, naming the count."""
    visible = torch.cuda.device_count()
    if devices is None:
        n = visible if n_devices is None else int(n_devices)
        if n < 1 or n > visible:
            raise ValueError(f"{n} CUDA devices requested but only "
                             f"{visible} are visible")
        devices = [f"cuda:{i}" for i in range(n)]
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    for d in devs:
        if d.type == "cuda" and (d.index or 0) >= visible:
            raise ValueError(f"{d} requested but only {visible} CUDA "
                             f"devices are visible")
    return Mesh(devs)


def split_rows(n: int, parts: int) -> List[slice]:
    """`n` rows as `parts` contiguous blocks whose sizes differ by at most
    one (some empty when n < parts)."""
    bounds = [i * n // parts for i in range(parts + 1)]
    return [slice(a, b) for a, b in zip(bounds[:-1], bounds[1:])]


def row_blocks(n: int, mesh: Mesh) -> List[slice]:
    """The contiguous row range of each device in an `n`-row batch; `n`
    must divide over the mesh."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} rows does not divide over the "
                         f"{mesh.size}-device mesh")
    return split_rows(n, mesh.size)


def _place(x: Any, device: torch.device) -> Any:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return x


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def shard_batch(tree: Any, mesh: Mesh) -> List[Any]:
    """One copy of `tree` a device, each leaf cut to that device's rows of
    its leading axis and placed there (numpy leaves become tensors); 0-d
    leaves are replicated."""
    out = []
    for i, dev in enumerate(mesh.devices):
        def cut(x, i=i, dev=dev):
            if not isinstance(x, (torch.Tensor, np.ndarray)) or x.ndim == 0:
                return _place(x, dev)
            return _place(x[row_blocks(x.shape[0], mesh)[i]], dev)
        out.append(_map(tree, cut))
    return out


def replicate(tree: Any, mesh: Mesh) -> List[Any]:
    """One copy of `tree` a device: a module is deep-copied onto it (a
    TePose's cached eval pack is dropped, so each replica packs its own
    weights), tensors and numpy arrays are placed there."""
    out = []
    for dev in mesh.devices:
        def put(x, dev=dev):
            if isinstance(x, nn.Module):
                m = copy.deepcopy(x).to(dev)
                if hasattr(m, "drop_fast_pack"):
                    m.drop_fast_pack()
                return m
            return _place(x, dev)
        out.append(_map(tree, put))
    return out


def gather_rows(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row blocks concatenated on the host, in row order: one readback
    when they all lie on one device, else one a block."""
    if len({p.device for p in parts}) == 1:
        return (parts[0] if len(parts) == 1 else torch.cat(parts)).cpu()
    return torch.cat([p.cpu() for p in parts])
