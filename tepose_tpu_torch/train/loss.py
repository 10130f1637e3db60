"""TePose training loss: keypoint/SMPL supervision + LSGAN motion prior.

Port of `tepose_tpu/train/loss.py`, all of it. Rows the reference drops
(invalid windows, rows without SMPL labels, rows outside the GAN) are
masked means instead: sum(x * rowmask) / (count(rowmask) * per-row
elements), which equals the mean over the kept rows and keeps every shape
static. The discriminator takes the same row mask for its BatchNorm
statistics (`models.gcn.MaskedBatchNorm`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from tepose_tpu_torch.ops.geometry import batch_rodrigues


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """configs/repr_*.yaml LOSS.*."""

    kp_2d: float = 300.0
    kp_3d: float = 300.0
    pose: float = 60.0
    shape: float = 0.06
    d_motion: float = 0.5


def _where_any(count: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    return torch.where(count > 0, value, torch.zeros_like(value))


def _masked_row_mean(err: torch.Tensor,
                     row_mask: torch.Tensor) -> torch.Tensor:
    """Mean over the rows of `row_mask`, as `err[mask].mean()`; 0 when the
    mask is empty (the reference skips the term then)."""
    m = row_mask.to(err.dtype)
    per_row = err.reshape(err.shape[0], -1).mean(dim=1)
    count = m.sum()
    return _where_any(count, (per_row * m).sum() / torch.clamp(count, min=1.0))


def keypoint_2d_loss(pred_2d: torch.Tensor, gt_2d: torch.Tensor,
                     row_mask: torch.Tensor, openpose_weight: float = 1.0,
                     gt_weight: float = 1.0) -> torch.Tensor:
    """Confidence-weighted 2D MSE. pred (N, 49, 2); gt (N, 49, 3) with the
    confidence in channel 2; joints < 25 are OpenPose-format, >= 25
    GT-format, each with its own weight."""
    conf = gt_2d[..., 2:3]
    # made on the device: an upload from host memory would wait for its queue
    w = torch.full((49,), gt_weight, dtype=pred_2d.dtype,
                   device=pred_2d.device)
    w[:25] = openpose_weight
    err = conf * w[None, :, None] * (pred_2d - gt_2d[..., :2]) ** 2
    return _masked_row_mean(err, row_mask)


def keypoint_3d_loss(pred_3d: torch.Tensor, gt_3d: torch.Tensor,
                     row_mask: torch.Tensor) -> torch.Tensor:
    """Pelvis-aligned 3D MSE on joints 25:39. pred/gt (N, 49, 3)."""
    pred = pred_3d[:, 25:39]
    gt = gt_3d[:, 25:39]
    gt_pelvis = (gt[:, 2] + gt[:, 3]) / 2.0
    pred_pelvis = (pred[:, 2] + pred[:, 3]) / 2.0
    err = ((pred - pred_pelvis[:, None]) - (gt - gt_pelvis[:, None])) ** 2
    return _masked_row_mean(err, row_mask)


def smpl_losses(pred_pose_aa: torch.Tensor, pred_betas: torch.Tensor,
                gt_pose_aa: torch.Tensor, gt_betas: torch.Tensor,
                row_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotation-matrix MSE on the 72-dim pose + MSE on betas."""
    N = pred_pose_aa.shape[0]
    pred_rm = batch_rodrigues(pred_pose_aa.reshape(N, 24, 3))
    gt_rm = batch_rodrigues(gt_pose_aa.reshape(N, 24, 3))
    loss_pose = _masked_row_mean((pred_rm - gt_rm) ** 2, row_mask)
    loss_shape = _masked_row_mean((pred_betas - gt_betas) ** 2, row_mask)
    return loss_pose, loss_shape


def encoder_disc_l2_loss(disc_value: torch.Tensor,
                         row_mask: torch.Tensor) -> torch.Tensor:
    """Generator-side LSGAN loss sum((D-1)^2)/k."""
    m = row_mask.to(disc_value.dtype)
    k = torch.clamp(m.sum(), min=1.0)
    return _where_any(m.sum(), (((disc_value - 1.0) ** 2) * m).sum() / k)


def adv_disc_l2_loss(real_value: torch.Tensor, fake_value: torch.Tensor,
                     real_mask: torch.Tensor, fake_mask: torch.Tensor):
    """Discriminator-side LSGAN losses: (loss_real, loss_fake, total)."""
    mr = real_mask.to(real_value.dtype)
    mf = fake_mask.to(fake_value.dtype)
    ka = torch.clamp(mr.sum(), min=1.0)
    kb = torch.clamp(mf.sum(), min=1.0)
    la = _where_any(mr.sum(), (((real_value - 1.0) ** 2) * mr).sum() / ka)
    lb = _where_any(mf.sum(), ((fake_value ** 2) * mf).sum() / kb)
    return la, lb, la + lb


def encoder_disc_wasserstein_loss(disc_value: torch.Tensor,
                                  row_mask: torch.Tensor) -> torch.Tensor:
    """Generator-side Wasserstein loss -sum(D)/k (defined, unused by the
    reference's TePoseLoss)."""
    m = row_mask.to(disc_value.dtype)
    k = torch.clamp(m.sum(), min=1.0)
    return _where_any(m.sum(), -(disc_value * m).sum() / k)


def adv_disc_wasserstein_loss(real_value: torch.Tensor,
                              fake_value: torch.Tensor,
                              real_mask: torch.Tensor,
                              fake_mask: torch.Tensor):
    """Discriminator-side Wasserstein losses: (loss_real, loss_fake, total)
    (defined, unused by the reference's TePoseLoss)."""
    mr = real_mask.to(real_value.dtype)
    mf = fake_mask.to(fake_value.dtype)
    ka = torch.clamp(mr.sum(), min=1.0)
    kb = torch.clamp(mf.sum(), min=1.0)
    la = _where_any(mr.sum(), -(real_value * mr).sum() / ka)
    lb = _where_any(mf.sum(), (fake_value * mf).sum() / kb)
    return la, lb, la + lb


def smooth_pose_loss(pred_theta: torch.Tensor,
                     row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """|mean(temporal pose diffs)| (the abs of the mean, as the reference;
    defined, unused). pred_theta (N, T, 85)."""
    diff = pred_theta[:, 1:, 3:75] - pred_theta[:, :-1, 3:75]
    if row_mask is None:
        return diff.mean().abs()
    return _masked_row_mean(diff, row_mask).abs()


def smooth_shape_loss(pred_theta: torch.Tensor,
                      row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """|mean(temporal shape diffs)| (defined, unused)."""
    diff = pred_theta[:, 1:, 75:] - pred_theta[:, :-1, 75:]
    if row_mask is None:
        return diff.mean().abs()
    return _masked_row_mean(diff, row_mask).abs()


def tepose_loss(
    preds: Dict[str, torch.Tensor],
    *,
    kp_2d_gt: torch.Tensor,
    kp_3d_gt: torch.Tensor,
    theta_gt: torch.Tensor,
    w_3d: torch.Tensor,
    w_smpl: torch.Tensor,
    valid: torch.Tensor,
    n_2d: int,
    prev_thetas: torch.Tensor,
    real_motion: torch.Tensor,
    disc_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    weights: LossWeights = LossWeights(),
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Generator + discriminator loss of one window step.

    The first `n_2d` rows are 2D-dataset samples, the rest 3D; the model
    emits both encoder branches per row. preds: the train forward, each
    (B, 2, ...). kp_2d_gt (B, 2, 49, 3); kp_3d_gt (n_3d, 2, 49, 3);
    theta_gt (n_3d, 2, 85); w_3d, w_smpl (n_3d,); valid (B,); prev_thetas
    (B, S-1, 85), detached by the caller; real_motion (B, S, 85);
    disc_fn(x (N, T, 72), mask (N,)) -> (N,), called three times in order:
    the generator's adversarial pass, the fake pass on detached motion, the
    real pass. Returns (gen_loss, motion_disc_loss, loss_dict).
    """
    def merge(x):
        return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])

    valid2 = valid.repeat_interleave(2)
    valid2_3d = valid[n_2d:].repeat_interleave(2)
    w_3d2 = w_3d.bool().repeat_interleave(2)
    w_smpl2 = w_smpl.bool().repeat_interleave(2)

    pred_j2d = merge(preds["kp_2d"])                # (2B, 49, 2)
    pred_j3d = merge(preds["kp_3d"][n_2d:])         # (2*n_3d, 49, 3)
    pred_theta = merge(preds["theta"][n_2d:])       # (2*n_3d, 85)

    loss_kp_2d = keypoint_2d_loss(pred_j2d, merge(kp_2d_gt),
                                  valid2) * weights.kp_2d
    loss_kp_3d = keypoint_3d_loss(pred_j3d, merge(kp_3d_gt),
                                  w_3d2 & (valid2_3d > 0)) * weights.kp_3d

    gt_theta = merge(theta_gt)
    loss_pose, loss_shape = smpl_losses(
        pred_theta[:, 3:75], pred_theta[:, 75:],
        gt_theta[:, 3:75], gt_theta[:, 75:], w_smpl2 & (valid2_3d > 0))
    loss_pose = loss_pose * weights.pose
    loss_shape = loss_shape * weights.shape

    # adversarial motion prior: fake motion = previous thetas + the mean of
    # the two predicted branches
    mean_theta = preds["theta"].mean(dim=1)                  # (B, 85)
    pred_motion = torch.cat([prev_thetas, mean_theta[:, None]], dim=1)
    # rows entering the GAN: 2D rows and 3D rows without SMPL labels
    motion_mask = torch.cat([
        torch.ones(n_2d, dtype=torch.bool, device=valid.device),
        ~w_smpl.bool()]) & (valid > 0)

    disc_gen = disc_fn(pred_motion[:, :, 3:75], motion_mask)
    e_m_disc_loss = encoder_disc_l2_loss(disc_gen, motion_mask) \
        * weights.d_motion

    fake_motion = pred_motion.detach()
    disc_fake = disc_fn(fake_motion[:, :, 3:75], motion_mask)
    disc_real = disc_fn(real_motion[:, :, 3:75], motion_mask)
    d_real, d_fake, d_loss = adv_disc_l2_loss(
        disc_real, disc_fake, motion_mask, motion_mask)

    loss_dict = {
        "loss_kp_2d": loss_kp_2d,
        "loss_kp_3d": loss_kp_3d,
        "loss_shape": loss_shape,
        "loss_pose": loss_pose,
        "e_m_disc_loss": e_m_disc_loss,
        "d_m_disc_real": d_real * weights.d_motion,
        "d_m_disc_fake": d_fake * weights.d_motion,
        "d_m_disc_loss": d_loss * weights.d_motion,
    }
    gen_loss = (loss_kp_2d + loss_kp_3d + loss_shape + loss_pose
                + e_m_disc_loss)
    return gen_loss, d_loss * weights.d_motion, loss_dict
