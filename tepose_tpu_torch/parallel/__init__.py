"""Scale-out: one process over a list of devices for inference
(`parallel.mesh`), one process per device over `torch.distributed` for
training (`parallel.distributed`, `parallel.dp`), and the multi-process
check (`parallel.mp_dryrun`). Port of `tepose_tpu/parallel/`.

Weights are replicated and batches split on their leading axis. Training's
masked means, BatchNorm statistics and gradients are summed across
processes, so a data-parallel segment computes the single-device one, not
per-replica DDP.
"""

from tepose_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
)
