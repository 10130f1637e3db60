"""ViTPose-H, the image backbone of HMR 2.0, as an nn.Module.

Written from 4D-Humans' `hmr2/models/backbones/vit.py` (`vit(cfg)`: the
ViTPose-H backbone): a 16 x 16 patch embedding with 2 pixels of padding,
a learned position embedding whose first row (a class token's, in the
pretraining model) is added to every patch's, 32 pre-LN blocks of 16-head
attention and a GELU MLP, and a final LayerNorm. The module tree and the
`state_dict` names are the published ones (`patch_embed.proj`,
`pos_embed`, `blocks.{i}.norm1`, `blocks.{i}.attn.qkv`,
`blocks.{i}.attn.proj`, `blocks.{i}.mlp.fc1`, `last_norm`, ...), so a
converted checkpoint loads with `strict=True`. Dropout and drop-path are
training-only and left out.

Attention goes through `F.scaled_dot_product_attention`, which computes
softmax(q k^T / sqrt(d)) v as the published code writes it out; in
float32 on an H100 that is PyTorch's memory-efficient kernel. A block's
four linear layers go through `ops.vit_linear.vit_linear`, which on the
card is one 3xTF32 GEMM with the bias, fc1's GELU and the block's residual
adds in its epilogue, and on the CPU `F.linear` and the same elementwise
ops; the `nn.Linear` modules hold the weights under their published names.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tepose_tpu_torch.ops.vit_linear import vit_linear


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """The published ViTPose-H (`vit(cfg)` in 4D-Humans): 256 x 192 input,
    16-pixel patches, width 1280, 32 blocks of 16 heads, MLP ratio 4, qkv
    with a bias, LayerNorm eps 1e-6."""

    img_size: Tuple[int, int] = (256, 192)
    patch_size: int = 16
    patch_padding: int = 2
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: int = 4
    qkv_bias: bool = True
    ln_eps: float = 1e-6

    @property
    def grid(self) -> Tuple[int, int]:
        """Patches down and across: (16, 12) at the published size."""
        p = self.patch_size
        return tuple(self.img_size[i] // p for i in range(2))

    @property
    def num_patches(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


class PatchEmbed(nn.Module):
    """`Conv2d(3, dim, patch, stride=patch, padding=2)`, flattened to
    tokens (B, N, dim) in row-major patch order, contiguous (the block's
    residual, which the fused linears read row by row)."""

    def __init__(self, cfg: ViTConfig, device):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.patch_size,
                              padding=cfg.patch_padding, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2).contiguous()


class Attention(nn.Module):
    """Multi-head self-attention: one `qkv` projection, `proj` out, to
    which `residual`, where given, is added."""

    def __init__(self, cfg: ViTConfig, device):
        super().__init__()
        self.num_heads = cfg.num_heads
        dim = cfg.embed_dim
        self.qkv = nn.Linear(dim, 3 * dim, bias=cfg.qkv_bias, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        B, N, C = x.shape
        qkv = vit_linear(x, self.qkv.weight, self.qkv.bias).reshape(
            B, N, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        return vit_linear(out.transpose(1, 2).reshape(B, N, C),
                          self.proj.weight, self.proj.bias, residual=residual)


class Mlp(nn.Module):
    """fc1, exact GELU, fc2, to which `residual`, where given, is added."""

    def __init__(self, dim: int, hidden: int, device):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        h = vit_linear(x, self.fc1.weight, self.fc1.bias, gelu=True)
        return vit_linear(h, self.fc2.weight, self.fc2.bias,
                          residual=residual)


class Block(nn.Module):
    """Pre-LN: x + attn(norm1(x)), then x + mlp(norm2(x))."""

    def __init__(self, cfg: ViTConfig, device):
        super().__init__()
        dim = cfg.embed_dim
        self.norm1 = nn.LayerNorm(dim, eps=cfg.ln_eps, device=device)
        self.attn = Attention(cfg, device)
        self.norm2 = nn.LayerNorm(dim, eps=cfg.ln_eps, device=device)
        self.mlp = Mlp(dim, dim * cfg.mlp_ratio, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attn(self.norm1(x), residual=x)
        return self.mlp(self.norm2(x), residual=x)


class ViT(nn.Module):
    """Normalised images (B, 3, H, W) at `cfg.img_size` -> tokens
    (B, N, dim) after the last LayerNorm, N = `cfg.num_patches` in
    row-major patch order (the published forward returns the same as
    (B, dim, Hp, Wp), which its head flattens back).

    With a `generator` the weights are drawn as the published random
    initialisation (`vit_init_`); without one they are left uninitialised,
    for a checkpoint to fill. The layers are built on the meta device
    first, so building draws nothing from the global RNG; on the meta
    device nothing is drawn at all."""

    def __init__(self, cfg: ViTConfig = ViTConfig(), *,
                 generator: torch.Generator | None = None,
                 device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, "meta")
        self.pos_embed = nn.Parameter(torch.empty(
            1, cfg.num_patches + 1, cfg.embed_dim, device="meta"))
        self.blocks = nn.ModuleList(Block(cfg, "meta")
                                    for _ in range(cfg.depth))
        self.last_norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps,
                                      device="meta")
        materialise(self, generator, device, vit_init_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for blk in self.blocks:
            x = blk(x)
        return self.last_norm(x)


def materialise(module: nn.Module, generator, device, init_) -> None:
    """Move a module built on the meta device to `device`, empty, and fill
    it with `init_(module, generator)` where there is a generator and a
    real device."""
    if torch.device(device).type == "meta":
        return
    module.to_empty(device=device)
    if generator is not None:
        init_(module, generator)


def uniform_draw(generator: torch.Generator, bound: float):
    """A draw of U(-bound, bound) in any shape from `generator`."""
    return lambda shape: (torch.rand(shape, generator=generator) * 2.0
                          - 1.0) * bound


def draw_(t: torch.Tensor, draw) -> None:
    """Fill `t` with `draw(shape)`, a CPU tensor, copied to t's device."""
    t.copy_(draw(t.shape).to(t.device))


@torch.no_grad()
def vit_init_(vit: ViT, generator: torch.Generator) -> None:
    """The published random initialisation (`ViT.__init__` and
    `init_weights(pretrained=None)`): truncated normal (std 0.02) for every
    Linear weight and `pos_embed`, zero Linear biases, LayerNorm (1, 0),
    PyTorch's default U(+-1/sqrt(fan_in)) for the patch convolution. Drawn
    from `generator` on the CPU in module order and copied to the module's
    device, so one seed gives the same weights on any device."""
    def trunc(shape):
        return nn.init.trunc_normal_(torch.empty(shape), std=0.02,
                                     generator=generator)

    proj = vit.patch_embed.proj
    bound = 1.0 / math.sqrt(proj.weight[0].numel())
    draw_(proj.weight, uniform_draw(generator, bound))
    draw_(proj.bias, uniform_draw(generator, bound))
    draw_(vit.pos_embed, trunc)
    for m in vit.modules():
        if isinstance(m, nn.Linear):
            draw_(m.weight, trunc)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
