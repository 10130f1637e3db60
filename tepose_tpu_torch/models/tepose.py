"""TePose and the bootstrap VIBE as nn.Modules.

Port of `tepose_tpu/models/tepose.py` (`TePoseConfig`, `tepose_apply` in
eval and train mode, `VibeConfig`, `vibe_apply`, `vibe_demo_apply`). The
modules' `state_dict` keys are the JAX param-tree paths joined with "."
(`encoder.gru_fwd.weight_ih_l0`, `regressor.init_pose`, ...), so
`weights.state_dict_from_jax_tree` output loads with `strict=True`.
`TePoseConfig.fast_encoder` routes the forward through the lane-batched
`models.fast_encoder`, which computes the same.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from tepose_tpu_torch.models.backbone import ResNet50, resnet50_features
from tepose_tpu_torch.models.fast_encoder import (
    FEAT_DIM, fast_encoder_window, pack_fast_encoder, project_frame_features,
    stack_fast_encoder)
from tepose_tpu_torch.models.regressor import Regressor
from tepose_tpu_torch.models.smpl import SmplModel
from tepose_tpu_torch.models.temporal import TemporalEncoder, VibeEncoder
from tepose_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class TePoseConfig:
    """Static hyperparameters (configs/*.yaml MODEL.TGRU, DATASET.SEQLEN).

    `fast_encoder` routes `TePose.forward` through `models.fast_encoder`
    (lane-batched GRUs, the same function)."""

    seqlen: int = 6
    n_layers: int = 2
    hidden_size: int = 1024
    fast_encoder: bool = False


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
    window's last frame.

    The fast encoder's eval pack is cached (`fast_pack`); a trainer calls
    `drop_fast_pack` after every optimizer step, or evaluation would read
    the weights of before the step. The train forward packs afresh."""

    def __init__(self, cfg: TePoseConfig, *, generator: torch.Generator,
                 device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        self.encoder = TemporalEncoder(cfg.n_layers, cfg.hidden_size,
                                       generator=generator, device=device)
        self.regressor = Regressor(generator=generator, device=device)
        self._fast: Optional[Dict] = None

    def fast_pack(self) -> Dict:
        """The encoder's lane-stacked weights (`pack_fast_encoder`), packed
        at the first call. The pack is a copy: a later `load_state_dict` or
        `.to()` does not reach it."""
        if self._fast is None:
            self._fast = pack_fast_encoder(self.encoder)
        return self._fast

    def drop_fast_pack(self) -> None:
        """Forget the cached eval pack; the next eval forward packs the
        encoder's current weights."""
        self._fast = None

    def __getstate__(self):
        """A copy or a pickle leaves the cached pack out: it packs its own
        weights at first use (the pack holds the scan's captured CUDA
        graphs, which neither copy nor pickle)."""
        return {**self.__dict__, "_fast": None}

    def forward(self, x: torch.Tensor, smpl: SmplModel, *,
                j_regressor: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                compute_verts: bool = True) -> Dict[str, torch.Tensor]:
        """x (B, T, 2133) -> theta (B, 85), verts (B, V, 3), kp_2d, kp_3d,
        rotmat. `train` returns both encoder branches, each (B, 2, ...),
        [fwd, rec], with dropout from `generator` (none: off);
        `compute_verts=False` drops "verts" (the vertex-free joints)."""
        if self.cfg.fast_encoder:
            fast = stack_fast_encoder(self.encoder) if train \
                else self.fast_pack()
            feature = fast_encoder_window(
                fast, project_frame_features(fast, x[..., :FEAT_DIM]),
                x[..., FEAT_DIM:], train=train)
        else:
            feature = self.encoder(x, train=train)
        out = self.regressor(feature.reshape(-1, feature.shape[-1]), smpl,
                             j_regressor=j_regressor, train=train,
                             generator=generator, compute_verts=compute_verts)
        if train:
            B = x.shape[0]
            out = {k: v.reshape((B, 2) + v.shape[1:]) for k, v in out.items()}
        return out


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


def vibe_demo_forward(vibe: Vibe, backbone: ResNet50, smpl: SmplModel,
                      images: torch.Tensor, *,
                      j_regressor: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """VIBE over image crops (VIBE_Demo.forward): ImageNet-NORMALISED crops
    (B, T, 3, H, W) -> ResNet-50 features of the B T crops -> `vibe` ->
    per-frame predictions (B, T, ...), under the spans `vibe.backbone` and
    `vibe.temporal` (`utils.profiling.span`). Normalise with
    `backbone.normalize_crop` first: raw [0, 255] pixels would give garbage
    features without an error. SMPL skins the B T frames in one launch of
    the LBS kernel on CUDA."""
    B, T = images.shape[:2]
    with span("vibe.backbone"):
        feats = resnet50_features(backbone, images.flatten(0, 1))
    with span("vibe.temporal"):
        return vibe(feats.reshape(B, T, -1), smpl, j_regressor=j_regressor)
