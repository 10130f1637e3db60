"""Multi-process runtime plumbing on `torch.distributed`.

Port of `tepose_tpu/parallel/distributed.py`. One process per device, joined
through `torch.distributed.init_process_group`: NCCL on CUDA, gloo on the
CPU. The launcher's environment names the group, as the JAX module's does:

  TEPOSE_COORDINATOR     host:port of rank 0's store (tcp://)
  TEPOSE_NUM_PROCESSES   world size
  TEPOSE_PROCESS_ID      this process's rank

Every helper is a no-op (or the identity) in a single process, so the entry
points call them unconditionally:

  * `maybe_initialize` joins the group; `process_count`, `process_index`,
    `is_primary` read it;
  * `host_local_rows` / `host_slice_tree`: process p of P owns rows
    [p*B/P, (p+1)*B/P) of a global batch of B, the layout
    `data/loaders.py`'s `num_shards` loaders assemble;
  * `barrier` (a collective) and `service_barrier` (on the group's store,
    with a timeout: it lines processes up without a device collective);
  * `broadcast_str` (the primary's string, e.g. the timestamped logdir),
    `fetch_global` (rows of every process, gathered in rank order) and
    `put_global`, which places host data on this process's device: JAX
    assembled a global array from the processes' local slices
    (`jax.make_array_from_process_local_data`); in PyTorch each process
    keeps its own rows and the collectives do the rest;
  * `sum_across` / `sum_across_with_grad`: the cross-process sums that the
    data-parallel training step takes its global statistics from. They
    reduce only inside `reducing()`, the scope the sharded segment
    (`parallel/dp.py`) opens; elsewhere (eval, a plain training segment)
    they are the identity, so no other path issues a collective.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Any, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

ENV_COORDINATOR = "TEPOSE_COORDINATOR"
ENV_NUM_PROCESSES = "TEPOSE_NUM_PROCESSES"
ENV_PROCESS_ID = "TEPOSE_PROCESS_ID"

DEFAULT_TIMEOUT_S = 600.0

_STATE = {"reducing": False, "barriers": {}}


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def maybe_initialize(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group if one is configured.

    Reads `TEPOSE_COORDINATOR` / `TEPOSE_NUM_PROCESSES` /
    `TEPOSE_PROCESS_ID` when arguments are omitted; returns False (and does
    nothing) when no coordinator is configured. Idempotent. `backend`
    defaults to NCCL when CUDA is available, else gloo; the caller passes
    "gloo" for CPU ranks, or for several ranks sharing one GPU, which NCCL
    refuses. Every collective of the group fails after `timeout_s`."""
    if initialized():
        return True
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if not coordinator:
        return False
    num_processes = int(num_processes if num_processes is not None
                        else os.environ[ENV_NUM_PROCESSES])
    process_id = int(process_id if process_id is not None
                     else os.environ[ENV_PROCESS_ID])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def is_primary() -> bool:
    """True on the process that owns file artifacts (checkpoints, logs,
    debug renders). The logdir is on a filesystem every process reads;
    only the primary writes it."""
    return process_index() == 0


def _device() -> torch.device:
    """Where the group's collectives take their tensors: the current CUDA
    device under NCCL, the CPU under gloo."""
    if initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def put_global(x: Any, device: torch.device | str) -> torch.Tensor:
    """This process's rows (or a replicated value) on its device."""
    return torch.as_tensor(x, device=device)


def host_local_rows(n_global: int) -> slice:
    """The contiguous row range this process owns of an `n_global`-row
    batch."""
    P = process_count()
    if n_global % P:
        raise ValueError(
            f"global batch of {n_global} rows does not divide across "
            f"{P} processes")
    per = n_global // P
    p = process_index()
    return slice(p * per, (p + 1) * per)


def host_slice_tree(tree: Any) -> Any:
    """Every >= 1-d leaf of a global batch tree (dicts, lists, tuples of
    arrays) cut to this process's rows; 0-d leaves pass through. For
    harnesses and tests that start from a full deterministic batch; the
    loaders assemble local slices directly."""
    if isinstance(tree, dict):
        return {k: host_slice_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_slice_tree(v) for v in tree)
    x = tree if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return x if x.ndim == 0 else x[host_local_rows(x.shape[0])]


def service_barrier(name: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Line processes up on the group's key-value store, not a device
    collective; raises after `timeout_s`. Each name may be used any number
    of times, in the same order on every process. No-op single-process."""
    if process_count() == 1:
        return
    count = _STATE["barriers"].get(name, 0) + 1
    _STATE["barriers"][name] = count
    key = f"tepose/barrier/{name}/{count}"
    store = dist.distributed_c10d._get_default_store()
    if store.add(key, 1) == process_count():
        store.set(key + "/done", "1")
    store.wait([key + "/done"], datetime.timedelta(seconds=timeout_s))


def barrier(name: str) -> None:
    """Block until every process reaches this point (no-op single-process).

    Used around checkpoint writes: the primary writes `checkpoint.npz`
    while other processes may need to read it (NaNGuard rollback,
    train/fit.py); without the barrier a reader can see a half-written
    file."""
    if process_count() == 1:
        return
    service_barrier(f"pre:{name}")
    dist.all_reduce(torch.zeros(1, device=_device()))


def broadcast_str(s: str) -> str:
    """The primary's string on every process (the timestamped experiment
    dir, which must be one path for checkpoint rollback and resume)."""
    return broadcast_object(s)


def broadcast_object(obj: Any) -> Any:
    """The primary's picklable object on every process."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def fetch_global(x: Any) -> np.ndarray:
    """Every process's rows of `x` (the same shape on each), concatenated
    in rank order, as host numpy on every process."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if process_count() == 1:
        return t.detach().cpu().numpy()
    t = t.detach().to(_device()).contiguous()
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.cat(parts).cpu().numpy()


def broadcast_module(module: torch.nn.Module) -> None:
    """Copy rank 0's parameters and buffers into `module` on every process
    (the replicated weights of data-parallel training)."""
    if process_count() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.device.type == _device().type:
                dist.broadcast(t.data, src=0)
            else:
                tmp = t.data.to(_device())
                dist.broadcast(tmp, src=0)
                t.data.copy_(tmp)


# ------------------------------------------------ the training step's sums


@contextlib.contextmanager
def reducing() -> Iterator[None]:
    """Inside, `sum_across` and `sum_across_with_grad` sum over the
    processes of the group (when there is one)."""
    saved = _STATE["reducing"]
    _STATE["reducing"] = initialized()
    try:
        yield
    finally:
        _STATE["reducing"] = saved


def reducing_world() -> int:
    """The number of processes `sum_across` sums over (1 outside
    `reducing()`)."""
    return process_count() if _STATE["reducing"] else 1


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum of `t` over the group, through the backend's device
    (`t` itself without a group). A profiler trace shows each call as a
    `tepose:all_reduce` span."""
    if not initialized():
        return t
    dev = _device()
    with torch.profiler.record_function("tepose:all_reduce"):
        if t.device == dev or (dev.type == "cpu" and t.device.type == "cpu"):
            dist.all_reduce(t)
            return t
        tmp = t.to(dev)
        dist.all_reduce(tmp)
        t.copy_(tmp)
    return t


def sum_across(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the processes, no gradient (counts, metrics)."""
    if not _STATE["reducing"]:
        return t
    return all_reduce_sum_(t.detach().clone())


class _SumAcrossRanks(torch.autograd.Function):
    """y = sum over ranks of x; the gradient of each rank's x is the sum
    over ranks of dL_r/dy, so a loss that is the sum of per-rank terms gets
    the gradient of the whole through the shared statistics."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone())


def sum_across_with_grad(t: torch.Tensor) -> torch.Tensor:
    """`sum_across` that carries gradients (the masked BatchNorm's
    statistics, an |mean| loss)."""
    if not _STATE["reducing"]:
        return t
    return _SumAcrossRanks.apply(t)
