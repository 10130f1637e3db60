"""HMR 2.0 (4D-Humans, "Humans in 4D", arXiv:2305.20091) as an nn.Module.

Written from `hmr2/models/hmr2.py`, `heads/smpl_head.py` and
`components/pose_transformer.py` under the experiment config
`hmr_vit_transformer.yaml`, at inference:

  * the 256 x 256 crop is read at columns 32:-32 (256 x 192) by the
    ViTPose-H backbone (`models.vit`), which gives 192 tokens of width 1280;
  * `SMPLTransformerDecoderHead`: one query token, `Linear(1, 1024)` of a
    zero input plus a learned `pos_embedding`, through 6 pre-LN layers of
    self-attention, cross-attention to the image tokens and a GELU
    feed-forward (8 heads of 64, no bias on the attention's input
    projections), then one IEF step from the mean parameters:
    pose6d = init + decpose(t), betas = init + decshape(t),
    cam = init + deccam(t);
  * each joint's 6-vector read as two rows (`x.reshape(-1, 2, 3)
    .permute(0, 2, 1)` in 4D-Humans, the transpose of SPIN's layout), its
    Gram-Schmidt rotation, SMPL;
  * camera translation [cam1, cam2, 2 f / (256 cam0 + 1e-9)] at f = 5000,
    keypoints projected at focal length 5000 / 256.

The module tree and `state_dict` names are the published ones
(`backbone.blocks.{i}.attn.qkv`, `smpl_head.transformer.transformer.layers.
{i}.1.fn.to_kv`, `smpl_head.decpose`, `smpl_head.init_body_pose`, ...), so a
converted checkpoint loads with `strict=True`.

Departures, each forced by what the port serves: SMPL is the port's
(`models.smpl.smpl_forward`, 24 rotations, the skinning kernel on a CUDA
device), whose 49-joint map the outputs use where 4D-Humans' SMPL wrapper
gives 44 joints; the outputs are the port's: theta (N, 85) = [cam,
axis-angle pose (72), betas] as TePose's regressor returns it, verts,
kp_3d (the 49 joints) and kp_2d (HMR 2.0's projection of them).

`hmr2_forward` is the per-frame function the engine runs a chunk of crops
through, under the spans `hmr2.backbone` (the ViT) and `hmr2.head` (the
decoder, 6D to theta, SMPL, the projection); `HMR2_STATS` counts the crops
and chunks it has run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tepose_tpu_torch.models.regressor import perspective_projection
from tepose_tpu_torch.models.smpl import SmplModel, smpl_forward
from tepose_tpu_torch.models.vit import (
    ViT, ViTConfig, draw_, materialise, uniform_draw, vit_init_)
from tepose_tpu_torch.ops.geometry import rot6d_to_rotmat, rotmat_to_angle_axis
from tepose_tpu_torch.utils.profiling import span

NUM_JOINTS = 24
NPOSE = 6 * NUM_JOINTS

# crops and chunks `hmr2_forward` has run, for a benchmark's counts
HMR2_STATS = {"crops": 0, "chunks": 0}


@dataclasses.dataclass(frozen=True)
class HMR2Config:
    """HMR 2.0 at its published size. `crop_margin` columns are dropped on
    each side of the `image_size` square crop (32 of 256), the ViT reads
    what is left; the head's widths are `SMPL_HEAD.TRANSFORMER_DECODER`'s.
    `focal_length` is `EXTRA.FOCAL_LENGTH`."""

    image_size: int = 256
    crop_margin: int = 32
    vit: ViTConfig = ViTConfig()
    dim: int = 1024
    depth: int = 6
    heads: int = 8
    dim_head: int = 64
    mlp_dim: int = 1024
    focal_length: float = 5000.0

    def __post_init__(self):
        want = (self.image_size, self.image_size - 2 * self.crop_margin)
        if tuple(self.vit.img_size) != want:
            raise ValueError(f"the ViT reads {self.vit.img_size}; a "
                             f"{self.image_size} crop less {self.crop_margin}"
                             f" columns a side is {want}")


class PreNorm(nn.Module):
    """`fn(LayerNorm(x), ...)`: the head's `norm` then its `fn`."""

    def __init__(self, dim: int, fn: nn.Module, device):
        super().__init__()
        self.norm = nn.LayerNorm(dim, device=device)
        self.fn = fn

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return self.fn(self.norm(x), **kw)


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, N, h d) -> (B, h, N, d)."""
    B, N, _ = t.shape
    return t.reshape(B, N, h, -1).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(B, h, N, d) -> (B, N, h d)."""
    B, h, N, d = t.shape
    return t.transpose(1, 2).reshape(B, N, h * d)


class SelfAttention(nn.Module):
    """`Attention` of pose_transformer.py: `to_qkv` without a bias,
    `to_out.0` with one."""

    def __init__(self, cfg: HMR2Config, device):
        super().__init__()
        inner = cfg.heads * cfg.dim_head
        self.heads = cfg.heads
        self.to_qkv = nn.Linear(cfg.dim, 3 * inner, bias=False, device=device)
        self.to_out = nn.Sequential(nn.Linear(inner, cfg.dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, -1))
        return self.to_out(_merge(F.scaled_dot_product_attention(q, k, v)))


class CrossAttention(nn.Module):
    """`CrossAttention` of pose_transformer.py: queries from the token,
    keys and values from the image tokens (`to_kv` reads width 1280)."""

    def __init__(self, cfg: HMR2Config, device):
        super().__init__()
        inner = cfg.heads * cfg.dim_head
        self.heads = cfg.heads
        self.to_kv = nn.Linear(cfg.vit.embed_dim, 2 * inner, bias=False,
                               device=device)
        self.to_q = nn.Linear(cfg.dim, inner, bias=False, device=device)
        self.to_out = nn.Sequential(nn.Linear(inner, cfg.dim, device=device))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        k, v = (_heads(t, self.heads)
                for t in self.to_kv(context).chunk(2, -1))
        q = _heads(self.to_q(x), self.heads)
        return self.to_out(_merge(F.scaled_dot_product_attention(q, k, v)))


class FeedForward(nn.Module):
    """`net`: Linear, GELU, Dropout, Linear, Dropout (dropout 0)."""

    def __init__(self, cfg: HMR2Config, device):
        super().__init__()
        self.net = nn.Sequential(
            nn.Linear(cfg.dim, cfg.mlp_dim, device=device), nn.GELU(),
            nn.Dropout(0.0), nn.Linear(cfg.mlp_dim, cfg.dim, device=device),
            nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class TransformerCrossAttn(nn.Module):
    """`layers.{i}` = [PreNorm(self-attention), PreNorm(cross-attention),
    PreNorm(feed-forward)], each added to its input."""

    def __init__(self, cfg: HMR2Config, device):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleList([
            PreNorm(cfg.dim, SelfAttention(cfg, device), device),
            PreNorm(cfg.dim, CrossAttention(cfg, device), device),
            PreNorm(cfg.dim, FeedForward(cfg, device), device)])
            for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        for sa, ca, ff in self.layers:
            x = sa(x) + x
            x = ca(x, context=context) + x
            x = ff(x) + x
        return x


class TransformerDecoder(nn.Module):
    """`to_token_embedding` (token width 1 -> 1024), `pos_embedding`, the
    layers."""

    def __init__(self, cfg: HMR2Config, device):
        super().__init__()
        self.to_token_embedding = nn.Linear(1, cfg.dim, device=device)
        self.pos_embedding = nn.Parameter(torch.empty(1, 1, cfg.dim,
                                                      device=device))
        self.transformer = TransformerCrossAttn(cfg, device)

    def forward(self, token: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        x = self.to_token_embedding(token) + self.pos_embedding
        return self.transformer(x, context=context)


class SMPLTransformerDecoderHead(nn.Module):
    """The decoder on a zero token, one IEF step from the mean parameters
    (`init_body_pose`, `init_betas`, `init_cam`: buffers, as published)."""

    def __init__(self, cfg: HMR2Config, device):
        super().__init__()
        self.transformer = TransformerDecoder(cfg, device)
        self.decpose = nn.Linear(cfg.dim, NPOSE, device=device)
        self.decshape = nn.Linear(cfg.dim, 10, device=device)
        self.deccam = nn.Linear(cfg.dim, 3, device=device)
        self.register_buffer("init_body_pose",
                             torch.empty(1, NPOSE, device=device))
        self.register_buffer("init_betas", torch.empty(1, 10, device=device))
        self.register_buffer("init_cam", torch.empty(1, 3, device=device))

    def forward(self, context: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Image tokens (B, N, 1280) -> (pose6d (B, 144), betas (B, 10),
        cam (B, 3))."""
        B = context.shape[0]
        token = context.new_zeros(B, 1, 1)
        t = self.transformer(token, context=context)[:, 0]
        return (self.init_body_pose + self.decpose(t),
                self.init_betas + self.decshape(t),
                self.init_cam + self.deccam(t))


def rot6d_rows_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """HMR 2.0's 6-vectors (..., 6), read as two rows (a1 = x[:3],
    a2 = x[3:]) -> rotations whose columns are their Gram-Schmidt basis,
    through the port's `rot6d_to_rotmat` (which reads columns)."""
    cols = x.reshape(x.shape[:-1] + (2, 3)).transpose(-1, -2)
    return rot6d_to_rotmat(cols.reshape(x.shape))


class HMR2(nn.Module):
    """`backbone` (ViTPose-H) and `smpl_head`, run by `hmr2_forward`. With
    a `generator` the weights are drawn as the published random
    initialisation (`hmr2_init_`); without one they are left
    uninitialised, for a checkpoint to fill."""

    def __init__(self, cfg: HMR2Config = HMR2Config(), *,
                 generator: torch.Generator | None = None,
                 device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = cfg
        self.backbone = ViT(cfg.vit, device="meta")
        self.smpl_head = SMPLTransformerDecoderHead(cfg, "meta")
        materialise(self, generator, device, hmr2_init_)


def hmr2_forward(model: HMR2, smpl: SmplModel,
                 images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """ImageNet-normalised crops (N, 3, S, S) -> theta (N, 85), verts
    (N, V, 3), kp_3d (N, 49, 3) and kp_2d (N, 49, 2), as HMR 2.0's
    `forward_step` computes them (module docstring)."""
    cfg = model.cfg
    N = images.shape[0]
    HMR2_STATS["crops"] += N
    HMR2_STATS["chunks"] += 1
    m = cfg.crop_margin
    with span("hmr2.backbone"):
        tokens = model.backbone(images[..., m:images.shape[-1] - m])
    with span("hmr2.head"):
        pose6d, betas, cam = model.smpl_head(tokens)
        rotmat = rot6d_rows_to_rotmat(pose6d.reshape(N, NUM_JOINTS, 6))
        smpl_out = smpl_forward(smpl, betas, rotmat)
        joints = smpl_out["joints49"]
        f = cfg.focal_length
        cam_t = torch.stack([cam[:, 1], cam[:, 2],
                             2.0 * f / (cfg.image_size * cam[:, 0] + 1e-9)],
                            dim=-1)
        pose_aa = rotmat_to_angle_axis(rotmat).reshape(N, 3 * NUM_JOINTS)
        return {"theta": torch.cat([cam, pose_aa, betas], dim=1),
                "verts": smpl_out["verts"], "kp_3d": joints,
                "kp_2d": perspective_projection(joints, cam_t,
                                                f / cfg.image_size)}


# the Xavier gain of decpose, decshape and deccam (INIT_DECODER_XAVIER)
DECODER_GAIN = 0.01
# identity rotations in HMR 2.0's row layout, zero betas, cam (0.9, 0, 0)
MEAN_POSE6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0) * NUM_JOINTS
MEAN_CAM = (0.9, 0.0, 0.0)


@torch.no_grad()
def hmr2_init_(model: HMR2, generator: torch.Generator) -> None:
    """The published random initialisation: the ViT's (`vit_init_`), then
    in the head PyTorch's defaults (U(+-1/sqrt(fan_in)) for Linear weights
    and biases, N(0, 1) for `pos_embedding`, LayerNorm (1, 0)), Xavier-
    uniform with gain `DECODER_GAIN` on the weights of `decpose`,
    `decshape` and `deccam`, and the mean parameters `MEAN_POSE6D`, zero
    betas and `MEAN_CAM` (the repository holds no `smpl_mean_params.npz`).
    Drawn from `generator` on the CPU in module order."""
    vit_init_(model.backbone, generator)
    head = model.smpl_head

    decoders = {id(head.decpose), id(head.decshape), id(head.deccam)}
    for m in head.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            w = (DECODER_GAIN * math.sqrt(6.0 / (m.in_features
                                                 + m.out_features))
                 if id(m) in decoders else bound)
            draw_(m.weight, uniform_draw(generator, w))
            if m.bias is not None:
                draw_(m.bias, uniform_draw(generator, bound))
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    draw_(head.transformer.pos_embedding,
           lambda shape: torch.randn(shape, generator=generator))
    head.init_body_pose.copy_(torch.tensor([MEAN_POSE6D]))
    head.init_betas.zero_()
    head.init_cam.copy_(torch.tensor([MEAN_CAM]))
