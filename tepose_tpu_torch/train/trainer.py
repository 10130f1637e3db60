"""The TePose training step: window assembly, theta feedback, the GAN
updates, over one training segment.

Port of `tepose_tpu/train/trainer.py` (`TrainHyper`, `assemble_window`, the
window step and the segment of `make_train_segment`). The JAX `lax.scan`
over the window index becomes a Python loop; per window:

  * `assemble_window` cuts the (B, S, 2133) input from the two-channel 2D
    batch and the 3D batch, draws scheduled sampling (forced off across a
    2D clip-channel switch) and resets rows that do not feed back to their
    pseudo-thetas;
  * the generator's train forward (both encoder branches, dropout, the
    vertex-free joints) and `tepose_loss`, whose three discriminator passes
    run in the reference's order: the generator's adversarial pass with the
    discriminator's parameters frozen (the gradient reaches the input only),
    the fake pass on detached motion, the real pass. BN running statistics
    advance on all three;
  * one backward of gen_loss + dis_loss gives both nets' gradients, as
    `jax.grad(..., argnums=(0, 1))`;
  * the generator steps unless no row is valid, the discriminator only when
    also `j % disc_update_steps == 0` and dis_loss != 0; a skipped update
    takes no optimizer step at all (a torch step on zero gradients would
    still move Adam's parameters and count);
  * the ring buffer shifts in the mean predicted theta for valid rows.

Window validity, the generator's skip and the discriminator's cadence are
known on the host from the batch; `dis_loss != 0` is read from the device
once per window on which the discriminator could step. `mode`, `ablate`,
`share_fake_disc`, `compute_dtype` and the packed segment of the JAX module
are not ported (measurement knobs and remote-link plumbing).

With a `shard` (`parallel.dp.RowShard`) the segment is one process's part of
a data-parallel segment that computes the single-device one: the batches
are this process's rows, random draws take the global shape and keep these
rows, the step decisions and metrics are global, and one all-reduce of a
flat buffer per window sums both nets' gradients and the metrics.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from tepose_tpu_torch.models.gcn import MotionDiscriminator
from tepose_tpu_torch.models.layers import uniform
from tepose_tpu_torch.models.smpl import SmplModel
from tepose_tpu_torch.models.tepose import TePose
from tepose_tpu_torch.parallel.distributed import fetch_global, reducing
from tepose_tpu_torch.train.loss import LossWeights, tepose_loss
from tepose_tpu_torch.train.optim import take_step

METRIC_NAMES = ("gen_loss", "dis_loss", "loss_kp_2d", "loss_kp_3d",
                "loss_shape", "loss_pose", "e_m_disc_loss", "d_m_disc_real",
                "d_m_disc_fake", "d_m_disc_loss")


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    """Static training hyperparameters."""

    seqlen: int = 6
    n_2d: int = 19               # 2D rows per batch (BATCH_SIZE*DATA_2D_RATIO)
    n_3d: int = 13
    update_theta_rate: float = 0.9
    disc_update_steps: int = 1
    num_gcn_scales: int = 13
    num_g3d_scales: int = 6


def assemble_window(batch_2d: Dict[str, torch.Tensor],
                    batch_3d: Dict[str, torch.Tensor],
                    theta_buf: torch.Tensor, j: int, hp: TrainHyper,
                    generator):
    """The (B, S, 2133) input of window j.

    Returns (inp, new_theta_buf, update (B,), valid (B,), targets). Rows
    with update 0 take their pseudo-thetas as feedback and reset the ring
    buffer to them. `generator` (a `torch.Generator` or, for one process's
    rows, a `models.layers.RowDraws`) draws the scheduled sampling
    (Bernoulli(update_theta_rate) per row); at rates 0 and 1 it is not
    drawn from. B is the batches' rows, 2D rows then 3D rows."""
    S = hp.seqlen
    t = j + S - 1
    sw = batch_2d["switch_id"]                                  # (B2,2,VL)
    sel = sw[:, :, t]                                           # (B2, 2)
    feats2 = torch.einsum("bc,bcsf->bsf", sel,
                          batch_2d["features"][:, :, j:j + S])
    pseu2 = torch.einsum("bc,bcsf->bsf", sel,
                         batch_2d["theta_pseu"][:, :, j:j + S - 1])
    # scheduled sampling is forced off at channel switches
    prev_idx = max(j + S - 2, S - 1)
    switch_2d = 1.0 - (sw[:, 0, t] - sw[:, 0, prev_idx]).abs()  # (B2,)

    feats = torch.cat([feats2, batch_3d["features"][:, j:j + S]])
    pseu = torch.cat([pseu2, batch_3d["theta_pseu"][:, j:j + S - 1]])

    B, n_3d = feats.shape[0], batch_3d["features"].shape[0]
    if hp.update_theta_rate >= 1.0:
        bern = torch.ones(B, device=feats.device)
    elif hp.update_theta_rate <= 0.0:
        bern = torch.zeros(B, device=feats.device)
    else:
        bern = (uniform((B,), generator, feats.device)
                < hp.update_theta_rate).float()
    update = bern * torch.cat([switch_2d, torch.ones(n_3d,
                                                     device=feats.device)])
    theta_buf = torch.where(update[:, None, None] > 0, theta_buf, pseu)

    inp = torch.cat([feats, torch.cat([theta_buf,
                                       torch.zeros_like(theta_buf[:, :1])],
                                      dim=1)], dim=-1)
    vidlen = torch.cat([batch_2d["vidlen_each"], batch_3d["vidlen_each"]])
    valid = (j < vidlen.reshape(-1) - S + 1).float()

    kp_2d = torch.cat([batch_2d["kp_2d"][:, t], batch_3d["kp_2d"][:, t]])
    targets = {
        "kp_2d": kp_2d[:, None].expand(-1, 2, -1, -1),
        "kp_3d": batch_3d["kp_3d"][:, t, None].expand(-1, 2, -1, -1),
        "theta": batch_3d["theta"][:, t, None].expand(-1, 2, -1),
        "w_3d": batch_3d["w_3d"][:, t],
        "w_smpl": batch_3d["w_smpl"][:, t],
    }
    return inp, theta_buf, update, valid, targets


def initial_theta_buf(batch_2d: Dict[str, torch.Tensor],
                      batch_3d: Dict[str, torch.Tensor],
                      seqlen: int) -> torch.Tensor:
    """The ring buffer at window 0: the first S-1 pseudo-thetas of each
    row's active channel."""
    S = seqlen
    sel0 = batch_2d["switch_id"][:, :, S - 1]
    pseu2 = torch.einsum("bc,bcsf->bsf", sel0,
                         batch_2d["theta_pseu"][:, :, :S - 1])
    return torch.cat([pseu2, batch_3d["theta_pseu"][:, :S - 1]])


@contextlib.contextmanager
def frozen(module: torch.nn.Module):
    """The module's parameters as constants for the ops run inside: their
    gradient is not recorded, the inputs' still is."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def upload(batch: Dict[str, np.ndarray],
           device: torch.device | str) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in batch.items()}


def train_segment(gen: TePose, disc: MotionDiscriminator, smpl: SmplModel,
                  gen_opt: torch.optim.Optimizer,
                  disc_opt: torch.optim.Optimizer, hp: TrainHyper,
                  weights: LossWeights, batch_2d: Dict[str, np.ndarray],
                  batch_3d: Dict[str, np.ndarray], amass_theta: np.ndarray,
                  generator: Optional[torch.Generator],
                  shard=None) -> Dict[str, float]:
    """`num_iters = len(amass_theta)` windows of GAN training over one
    (2D batch, 3D batch) pair, on the device of `smpl`.

    batch_2d / batch_3d are the loaders' numpy batches; amass_theta
    (num_iters, B, S, 85) the real-motion windows, one per window.
    `generator` (on that device) draws scheduled sampling and the
    regressor's dropout; None turns dropout off. The last window's
    gradients stay in `.grad`. Returns the per-segment mean of each metric
    (`METRIC_NAMES`), read back once.

    With `shard` (a `parallel.dp.RowShard`; `parallel.dp.
    sharded_train_segment` passes it) the batches and amass_theta hold this
    process's rows only and the segment runs as its part of the global
    one."""
    device = smpl.v_template.device
    S = hp.seqlen
    b2, b3 = upload(batch_2d, device), upload(batch_3d, device)
    amass = torch.as_tensor(np.asarray(amass_theta, np.float32),
                            device=device)
    # host copies of what decides the optimizer steps, for the global batch
    vidlen2 = np.asarray(batch_2d["vidlen_each"], np.float32).reshape(-1)
    vidlen3 = np.asarray(batch_3d["vidlen_each"], np.float32).reshape(-1)
    w_smpl_host = np.asarray(batch_3d["w_smpl"], np.float32)
    draws, real_masks = generator, None
    if shard is not None:
        vidlen2, vidlen3, w_smpl_host = (
            fetch_global(x) for x in (vidlen2, vidlen3, w_smpl_host))
        if generator is not None:
            draws = shard.draws(generator, device)
    vidlen = np.concatenate([vidlen2, vidlen3])
    n_2d = len(vidlen2)
    K = len(amass_theta)
    valid_host = np.stack([j < vidlen - S + 1 for j in range(K)])   # (K, B)
    gan_rows = np.concatenate(
        [np.ones((K, n_2d), bool),
         (w_smpl_host[:, S - 1:S - 1 + K] == 0).T], axis=1) & valid_host
    if shard is not None:
        # the real pass masks this process's AMASS rows, which are other
        # rows of the global batch than its generator rows
        real_masks = torch.as_tensor(gan_rows[:, shard.amass_rows()],
                                     device=device)
    gen.train()
    disc.train()

    theta_buf = initial_theta_buf(b2, b3, S)
    per_window = []
    for j in range(K):
        inp, theta_buf, _, valid, targets = assemble_window(
            b2, b3, theta_buf, j, hp, draws)
        gen_opt.zero_grad(set_to_none=True)
        disc_opt.zero_grad(set_to_none=True)
        preds = gen(inp, smpl, train=True, generator=draws,
                    compute_verts=False)
        calls = [0]

        def disc_fn(x, mask):
            calls[0] += 1
            if calls[0] == 1:     # the generator's adversarial pass
                with frozen(disc):
                    return disc(x, mask)
            return disc(x, mask)

        with (reducing() if shard is not None
              else contextlib.nullcontext()):
            gen_loss, dis_loss, ld = tepose_loss(
                preds, kp_2d_gt=targets["kp_2d"], kp_3d_gt=targets["kp_3d"],
                theta_gt=targets["theta"], w_3d=targets["w_3d"],
                w_smpl=targets["w_smpl"], valid=valid,
                n_2d=b2["features"].shape[0],
                prev_thetas=theta_buf.detach(), real_motion=amass[j],
                disc_fn=disc_fn, weights=weights,
                real_mask=None if real_masks is None else real_masks[j])
            mean_theta = preds["theta"].mean(dim=1).detach()
            (gen_loss + dis_loss).backward()
        metrics = torch.stack([gen_loss.detach(), dis_loss.detach()]
                              + [ld[k].detach() for k in METRIC_NAMES[2:]])
        if shard is not None:
            # each process holds its rows' terms: sum gradients and metrics
            metrics = shard.sum_gradients((gen_opt, disc_opt), metrics)

        if valid_host[j].any():
            take_step(gen_opt)
            gen.drop_fast_pack()
            if (j % hp.disc_update_steps == 0 and gan_rows[j].any()
                    and bool(metrics[1] != 0)):
                take_step(disc_opt)

        shifted = torch.cat([theta_buf[:, 1:], mean_theta[:, None]], dim=1)
        theta_buf = torch.where(valid[:, None, None] > 0, shifted, theta_buf)
        per_window.append(metrics)
    means = torch.stack(per_window).mean(dim=0).cpu().tolist()
    return dict(zip(METRIC_NAMES, means))
