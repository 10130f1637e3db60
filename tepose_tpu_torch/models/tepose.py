"""TePose and the bootstrap VIBE as nn.Modules, eval mode.

Port of `tepose_tpu/models/tepose.py` (`TePoseConfig`, `tepose_apply`,
`VibeConfig`, `vibe_apply`). The modules' `state_dict` keys are the JAX
param-tree paths joined with "." (`encoder.gru_fwd.weight_ih_l0`,
`regressor.init_pose`, ...), so `weights.state_dict_from_jax_tree` output
loads with `strict=True`. The lane-batched `fast_encoder` is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from tepose_tpu_torch.models.regressor import Regressor
from tepose_tpu_torch.models.smpl import SmplModel
from tepose_tpu_torch.models.temporal import TemporalEncoder, VibeEncoder


@dataclasses.dataclass(frozen=True)
class TePoseConfig:
    """Static hyperparameters (configs/*.yaml MODEL.TGRU, DATASET.SEQLEN)."""

    seqlen: int = 6
    n_layers: int = 2
    hidden_size: int = 1024


@dataclasses.dataclass(frozen=True)
class VibeConfig:
    """The bootstrap VIBE: 2 layers, hidden 1024, add_linear, unidirectional,
    residual."""

    seqlen: int = 16
    n_layers: int = 2
    hidden_size: int = 1024
    add_linear: bool = True
    bidirectional: bool = False
    use_residual: bool = True


class TePose(nn.Module):
    """Causal sliding-window model: (B, T, 2048 + 85) -> predictions for the
    window's last frame."""

    def __init__(self, cfg: TePoseConfig, *, generator: torch.Generator,
                 device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        self.encoder = TemporalEncoder(cfg.n_layers, cfg.hidden_size,
                                       generator=generator, device=device)
        self.regressor = Regressor(generator=generator, device=device)

    def forward(self, x: torch.Tensor, smpl: SmplModel, *,
                j_regressor: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """x (B, T, 2133) -> theta (B, 85), verts (B, V, 3), kp_2d, kp_3d,
        rotmat."""
        return self.regressor(self.encoder(x), smpl, j_regressor=j_regressor)


class Vibe(nn.Module):
    """VIBE: (B, T, 2048) -> per-frame predictions (B, T, ...)."""

    def __init__(self, cfg: VibeConfig, *, generator: torch.Generator,
                 device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        self.encoder = VibeEncoder(cfg.n_layers, cfg.hidden_size,
                                   cfg.add_linear, cfg.bidirectional,
                                   cfg.use_residual, generator=generator,
                                   device=device)
        self.regressor = Regressor(generator=generator, device=device)

    def forward(self, x: torch.Tensor, smpl: SmplModel, *,
                j_regressor: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        B, T = x.shape[:2]
        feature = self.encoder(x).reshape(B * T, -1)
        out = self.regressor(feature, smpl, j_regressor=j_regressor)
        return {k: v.reshape((B, T) + v.shape[1:]) for k, v in out.items()}
