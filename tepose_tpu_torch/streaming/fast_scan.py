"""The theta-feedback window scan on the lane-batched fast encoder.

Port of `tepose_tpu/streaming/fast_scan.py::fast_stream_scan`. It computes
what the plain loop of `TePose` windows computes (tests hold the two equal)
with two savings: the encoder's lanes are batched (`models.fast_encoder`),
and every frame's layer-0 feature projection is made once for the whole
clip, in one large GEMM, and sliced per window, instead of being made again
in each of the S windows that hold the frame. The JAX `lax.scan` becomes a
Python loop over windows.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from tepose_tpu_torch.models.fast_encoder import (
    fast_encoder_window, project_frame_features)
from tepose_tpu_torch.models.smpl import SmplModel
from tepose_tpu_torch.models.tepose import TePose

# Projecting every frame at once materialises a (B, T, 3, 3H) f32 tensor;
# above this many bytes each window projects its own frames instead. The JAX
# package's value is kept: 6 GiB is 7.5 % of the H100's 80 GB, and the
# serving engine's buckets stay far below it (max_frames_per_call = 4096
# frames make 151 MB at H = 1024), so the switch only turns precompute off
# for a direct caller with more than about 174k frames at full width.
PRECOMPUTE_PROJ_BYTES = 6 << 30


@torch.inference_mode()
def fast_stream_scan(gen: TePose, smpl: SmplModel, feats: torch.Tensor,
                     theta_buf0: torch.Tensor, num_windows: int,
                     j_regressor: Optional[torch.Tensor] = None,
                     outputs: Sequence[str] = ("theta", "kp_3d"),
                     precompute_projections: Optional[bool] = None
                     ) -> Dict[str, torch.Tensor]:
    """Run the theta-feedback stream over `num_windows` windows.

    feats (B, T, 2048); theta_buf0 (B, S-1, 85). Returns the per-window
    outputs named in `outputs`, each stacked to (B, W, ...). The encoder's
    weights come from `gen.fast_pack()`, whatever `gen.cfg.fast_encoder`
    says. `precompute_projections` projects every frame once before the
    loop; None decides by PRECOMPUTE_PROJ_BYTES.
    """
    S = gen.cfg.seqlen
    B, T = feats.shape[:2]
    if not 1 <= num_windows <= T - S + 1:
        # slicing past T would silently drop the last windows, where JAX's
        # dynamic_slice would clamp and repeat one: make it loud
        raise ValueError(
            f"num_windows={num_windows} not in [1, T-S+1={T - S + 1}] "
            f"(T={T}, seqlen={S})")
    fast = gen.fast_pack()
    lane_dim = fast["layers"][0]["w_feat"].shape[0]            # 3 * 3H
    if precompute_projections is None:
        precompute_projections = (B * T * lane_dim * feats.element_size()
                                  <= PRECOMPUTE_PROJ_BYTES)
    all_proj = (project_frame_features(fast, feats)
                if precompute_projections else None)

    def window(k, theta_fb):
        if all_proj is not None:
            proj = all_proj[:, k:k + S]
        else:
            proj = project_frame_features(fast, feats[:, k:k + S])
        return gen.regressor(fast_encoder_window(fast, proj, theta_fb), smpl,
                             j_regressor=j_regressor)

    return _feedback_loop(window, theta_buf0, num_windows, outputs)


@torch.inference_mode()
def plain_stream_scan(gen: TePose, smpl: SmplModel, feats: torch.Tensor,
                      theta_buf0: torch.Tensor, num_windows: int,
                      j_regressor: Optional[torch.Tensor] = None,
                      outputs: Sequence[str] = ("theta", "kp_3d")
                      ) -> Dict[str, torch.Tensor]:
    """The same stream through the plain `TemporalEncoder` forward, one
    [feat | theta] window at a time: the loop `fast_stream_scan`
    restructures, kept as its reference (tests, `chip_smoke.py` phase 7)."""
    S = gen.cfg.seqlen

    def window(k, theta_fb):
        x = torch.cat([feats[:, k:k + S], theta_fb], dim=-1)
        return gen.regressor(gen.encoder(x), smpl, j_regressor=j_regressor)

    return _feedback_loop(window, theta_buf0, num_windows, outputs)


def _feedback_loop(window, theta_buf0: torch.Tensor, num_windows: int,
                   outputs: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Run `window(k, theta_feedback (B, S, 85))` for k < num_windows,
    feeding each window's theta into the next one's ring; the outputs named
    in `outputs`, stacked to (B, W, ...)."""
    zero_fb = torch.zeros_like(theta_buf0[:, :1])
    theta_buf = theta_buf0
    per_window = {k: [] for k in outputs}
    for k in range(num_windows):
        out = window(k, torch.cat([theta_buf, zero_fb], dim=1))
        theta_buf = torch.cat([theta_buf[:, 1:], out["theta"][:, None]],
                              dim=1)
        for key in outputs:
            per_window[key].append(out[key])
    return {k: torch.stack(v, dim=1) for k, v in per_window.items()}
