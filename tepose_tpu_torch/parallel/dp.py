"""Data-parallel training segment over `torch.distributed`.

Port of `tepose_tpu/parallel/dp.py`. One process per device; both nets and
both optimizers are replicated (rank 0's weights broadcast once,
`replicate_from_primary`), each process trains on its rows of every batch
(`distributed.host_local_rows`; the loaders' `num_shards` assemble them),
and the segment is numerically the single-device one, not per-replica DDP:

  * the loss's masked means divide by global counts and the masked
    BatchNorm takes its statistics over every process's rows, gradients
    included (`train/loss.py`, `models/gcn.py`, inside
    `distributed.reducing()`);
  * one all-reduce of a flat buffer per window sums both nets' gradients
    (each process's loss is its rows' sum over the global count, so the sum
    is the global gradient) and the window's metrics;
  * every process then takes the same Adam step, and the step decisions
    (a valid row anywhere, a GAN row anywhere, dis_loss != 0) are taken on
    global values, so the replicas never part ways;
  * random draws take the global shape from a generator seeded alike on
    every process and keep this process's rows (`RowShard.draws`).

A window's rows are [2D rows, 3D rows]: process p owns a block of each, so
its generator rows are two blocks; its AMASS rows are the p-th block of the
real-motion batch, which shards on axis 1 (`RowShard.amass_rows`).

JAX's `MeshTreePlacer` placed carry and batch pytrees on a mesh: the carry
replicated, the batch rows sharded on axis 0 and the AMASS rows on axis 1.
Here the modules stay resident on each process's device
(`replicate_from_primary`), and `RowShard` holds that split of the rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from tepose_tpu_torch.models.layers import RowDraws
from tepose_tpu_torch.parallel import distributed
from tepose_tpu_torch.train.trainer import train_segment


def check_divisible(hp, n_devices: int) -> None:
    """Data-parallel batches must split evenly across the processes."""
    for name, n in (("n_2d", hp.n_2d), ("n_3d", hp.n_3d)):
        if n % n_devices:
            raise ValueError(
                f"TRAIN.BATCH_SIZE split {name}={n} is not divisible by "
                f"--devices {n_devices}; pick a batch size whose 2D/3D split "
                f"is a multiple of the device count")


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This process's rows of a global training batch of n_2d 2D and n_3d
    3D rows over `world` processes."""

    rank: int
    world: int
    n_2d: int
    n_3d: int

    @classmethod
    def current(cls, hp) -> "RowShard":
        world = distributed.process_count()
        check_divisible(hp, world)
        return cls(distributed.process_index(), world, hp.n_2d, hp.n_3d)

    def rows(self) -> np.ndarray:
        """This process's generator rows in the global window: its block of
        the 2D rows, then its block of the 3D rows."""
        p2, p3 = self.n_2d // self.world, self.n_3d // self.world
        return np.concatenate([
            np.arange(self.rank * p2, (self.rank + 1) * p2),
            self.n_2d + np.arange(self.rank * p3, (self.rank + 1) * p3)])

    def amass_rows(self) -> slice:
        per = (self.n_2d + self.n_3d) // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def draws(self, generator: torch.Generator, device) -> RowDraws:
        return RowDraws(generator, torch.as_tensor(self.rows(),
                                                   device=device),
                        self.n_2d + self.n_3d)

    def sum_gradients(self, optimizers: Sequence[torch.optim.Optimizer],
                      metrics: torch.Tensor) -> torch.Tensor:
        """Sum every optimized parameter's gradient (a missing one counts
        as zeros and is set so, as `train.optim.take_step` would) and
        `metrics` over the processes, in one all-reduce of a flat buffer.
        Returns the summed metrics."""
        params = [p for opt in optimizers for p in opt.param_groups[0]["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1) for p in params]
                         + [metrics.reshape(-1)])
        distributed.all_reduce_sum_(flat)
        ofs = 0
        for p in params:
            n = p.numel()
            p.grad.copy_(flat[ofs:ofs + n].view_as(p))
            ofs += n
        return flat[ofs:]


def replicate_from_primary(*modules: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers in every process's modules."""
    for m in modules:
        distributed.broadcast_module(m)


def sharded_train_segment(gen, disc, smpl, gen_opt, disc_opt, hp, weights,
                          batch_2d: Dict[str, np.ndarray],
                          batch_3d: Dict[str, np.ndarray],
                          amass_theta: np.ndarray, generator
                          ) -> Dict[str, float]:
    """`train.trainer.train_segment` as this process's part of the global
    segment: batch_2d / batch_3d hold this process's rows
    (`host_local_rows` of the global batches), amass_theta (num_iters,
    B/P, S, 85) its block of the real-motion rows. Returns the global
    per-segment metrics, the same on every process."""
    return train_segment(gen, disc, smpl, gen_opt, disc_opt, hp, weights,
                         batch_2d, batch_3d, amass_theta, generator,
                         shard=RowShard.current(hp))


def local_batches(batch_2d, batch_3d, amass_theta):
    """This process's rows of global batches (harnesses and tests start
    from the full deterministic batch; the loaders slice on their own)."""
    amass = np.asarray(amass_theta)
    return (distributed.host_slice_tree(batch_2d),
            distributed.host_slice_tree(batch_3d),
            amass[:, distributed.host_local_rows(amass.shape[1])])
