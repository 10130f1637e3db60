"""Per-epoch validation: the theta-feedback scan and the trainer's metrics.

Port of `tepose_tpu/train/validate.py` (`make_validate_scan`,
`validate_epoch`). Unlike benchmark eval (`eval.evaluator`), trainer
validation has no VIBE bootstrap: the theta buffer starts from the
pseudo-thetas and only frames seqlen-1..T-1 get predictions; metrics are
masked to each video's true window range and the accel metrics use the
window-boundary-excluding normalisations (`eval.metrics.accel_*_masked`).

The scan runs under `torch.no_grad()` with the generator in eval mode:
each window skins its prediction and the GT rebuild through the LBS kernel
on a CUDA device (two launches per window at the valid batch).
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from tepose_tpu_torch.eval import metrics as M
from tepose_tpu_torch.models.smpl import SmplModel, smpl_forward
from tepose_tpu_torch.models.tepose import TePose


@torch.no_grad()
def validate_scan(gen: TePose, smpl: SmplModel, feats: torch.Tensor,
                  theta_pseu: torch.Tensor, theta_gt: torch.Tensor,
                  j_regressor: torch.Tensor,
                  num_windows: int) -> Dict[str, torch.Tensor]:
    """Videos padded to T = num_windows + S - 1 frames: feats (B, T, 2048),
    theta_pseu (B, S-1, 85), theta_gt (B, T, 85), j_regressor (17, V).
    Returns pred_j3d (B, W, 14, 3) and pve (B, W), the per-window-frame
    vertex error against the GT-theta mesh."""
    S = gen.cfg.seqlen
    theta_buf = theta_pseu
    zero_fb = torch.zeros_like(theta_pseu[:, :1])
    j3d, pve = [], []
    for k in range(num_windows):
        fb = torch.cat([theta_buf, zero_fb], dim=1)
        out = gen(torch.cat([feats[:, k:k + S], fb], dim=-1), smpl,
                  j_regressor=j_regressor)
        th_gt = theta_gt[:, k + S - 1]
        gt_verts = smpl_forward(smpl, th_gt[:, 75:], th_gt[:, 3:75],
                                pose2rot=True)["verts"]
        pve.append(torch.sqrt(((out["verts"] - gt_verts) ** 2).sum(-1))
                   .mean(-1))
        j3d.append(out["kp_3d"])
        theta_buf = torch.cat([theta_buf[:, 1:], out["theta"][:, None]],
                              dim=1)
    return {"pred_j3d": torch.stack(j3d, dim=1), "pve": torch.stack(pve, 1)}


def validate_epoch(gen: TePose, smpl: SmplModel, valid_loader: Iterable,
                   j_regressor: np.ndarray, seqlen: int,
                   max_batches: int = 10**9) -> Dict[str, float]:
    """Trainer-style validation on the device of `smpl`: MPJPE / PA-MPJPE
    over valid window frames, accel / accel_err with masked normalisation,
    PVE against the GT-theta SMPL rebuild (mm). 'pa-mpjpe' is the
    checkpoint-selection metric."""
    S = seqlen
    device = smpl.v_template.device
    jreg = torch.as_tensor(np.asarray(j_regressor, np.float32), device=device)
    gen.eval()

    pred_list, tgt_list, pve_list = [], [], []
    pred_tsr, tgt_tsr, vlens = [], [], []
    batches = 0
    for batch in valid_loader:
        feats = batch["features"]
        B, T = feats.shape[:2]
        W = T - S + 1

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        out = validate_scan(gen, smpl, dev(feats),
                            dev(batch["theta_pseu"][:, :S - 1]),
                            dev(batch["theta"]), jreg, W)
        pred_j3d = out["pred_j3d"].cpu().numpy()      # (B, W, 14, 3)
        pve = out["pve"].cpu().numpy()
        tgt_j3d = batch["kp_3d"]                      # (B, T, 14, 3)
        vl = batch["vidlen_each"].reshape(-1)

        for b in range(B):
            n_valid = int(max(0, min(W, vl[b] - S + 1)))
            pred_list.append(pred_j3d[b, :n_valid])
            tgt_list.append(tgt_j3d[b, S - 1:S - 1 + n_valid])
            pve_list.append(pve[b, :n_valid])

        # padded (B, T, ...) tracks for the accel metrics: predictions
        # written at frame j+S-1
        p_tsr = np.zeros((B, T) + pred_j3d.shape[2:], np.float32)
        p_tsr[:, S - 1:] = pred_j3d
        pred_tsr.append(p_tsr)
        tgt_tsr.append(np.asarray(tgt_j3d, np.float32))
        vlens.append(np.asarray(vl, np.float32))

        batches += 1
        if batches >= max_batches:
            break

    pred = np.concatenate(pred_list, axis=0)
    tgt = np.concatenate(tgt_list, axis=0).astype(np.float32)

    # pelvis align (common-format joints 2, 3)
    pred = pred - (pred[:, [2]] + pred[:, [3]]) / 2.0
    tgt = tgt - (tgt[:, [2]] + tgt[:, [3]]) / 2.0

    m2mm = 1000.0
    errs, errs_pa = M.host_joint_errors(pred, tgt)

    T_max = max(p.shape[1] for p in pred_tsr)

    def pad_T(x):
        out = np.zeros((x.shape[0], T_max) + x.shape[2:], np.float32)
        out[:, :x.shape[1]] = x
        return out

    p_all = np.concatenate([pad_T(p) for p in pred_tsr], axis=0)
    t_all = np.concatenate([pad_T(t) for t in tgt_tsr], axis=0)
    v_all = np.concatenate(vlens, axis=0)
    p_all = p_all - (p_all[:, :, [2]] + p_all[:, :, [3]]) / 2.0
    # the reference "aligns" the target with TIME indices [2], [3], a
    # time-constant offset that cancels in the accel second difference;
    # kept literally so accel_err matches its numbers
    t_all = t_all - (t_all[:, [2]] + t_all[:, [3]]) / 2.0

    accel = M.accel_magnitude_masked(p_all, v_all, S) * m2mm
    accel_err = M.accel_error_masked(p_all, t_all, v_all, S) * m2mm
    return {
        "mpjpe": float(errs.mean()) * m2mm,
        "pa-mpjpe": float(errs_pa.mean()) * m2mm,
        "accel": float(accel),
        "accel_err": float(accel_err),
        "pve": float(np.mean(np.concatenate(pve_list))) * m2mm,
    }
