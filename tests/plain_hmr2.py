"""HMR 2.0's forward pass in plain PyTorch: the CPU tests' reference.

Written from the equations of 4D-Humans ("Humans in 4D", arXiv:2305.20091;
`hmr2/models/hmr2.py`, `backbones/vit.py`, `heads/smpl_head.py`,
`components/pose_transformer.py`, experiment `hmr_vit_transformer.yaml`),
in float32, one matrix product at a time, with the softmax of every
attention written out. It imports nothing of the port and no JAX: weights
come in as a dict under the published names (`backbone.blocks.0.attn.qkv.
weight`, `smpl_head.decpose.bias`, ...), SMPL as a dict of tensors and
tables, and the widths as a dict (`CONFIG`'s keys).

Departures from the published model, each the port's too:
  * SMPL's joints are the port's 49-joint map (24 posed skeleton joints,
    21 vertex keypoints and 9 regressed joints, reordered by `joint_map`),
    where 4D-Humans' SMPL wrapper gives 44;
  * the mean parameters the IEF step starts from are the benchmark's
    (identity rotations, zero betas, camera (0.9, 0, 0)), read from the
    weights' `init_*` buffers like any other weight.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

# the published widths; a test may shrink any of them
CONFIG = dict(image_size=256, crop_margin=32, patch_size=16, patch_padding=2,
              embed_dim=1280, depth=32, num_heads=16, mlp_ratio=4,
              vit_eps=1e-6, dim=1024, head_depth=6, heads=8, dim_head=64,
              mlp_dim=1024, head_eps=1e-5, focal_length=5000.0)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(crops: torch.Tensor) -> torch.Tensor:
    """uint8 (N, 3, H, W) -> ImageNet-normalised float32."""
    x = crops.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN)[:, None, None]
    std = torch.tensor(IMAGENET_STD)[:, None, None]
    return (x - mean) / std


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v per head; q (B, Nq, h d), k and v
    (B, Nk, h d) -> (B, Nq, h d)."""
    B, Nq, C = q.shape
    d = C // heads
    q = q.reshape(B, Nq, heads, d).transpose(1, 2)
    k = k.reshape(B, -1, heads, d).transpose(1, 2)
    v = v.reshape(B, -1, heads, d).transpose(1, 2)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * d ** -0.5
    scores = scores - scores.amax(dim=-1, keepdim=True)
    p = scores.exp()
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return out.transpose(1, 2).reshape(B, Nq, C)


def layer_norm(w: Weights, prefix: str, x: torch.Tensor,
               eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w[prefix + ".weight"] \
        + w[prefix + ".bias"]


def linear(w: Weights, prefix: str, x: torch.Tensor) -> torch.Tensor:
    y = x @ w[prefix + ".weight"].t()
    b = w.get(prefix + ".bias")
    return y if b is None else y + b


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU, x Phi(x)."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def vit_block(w: Weights, prefix: str, x: torch.Tensor,
              cfg: dict) -> torch.Tensor:
    """x + attn(LN(x)), then x + mlp(LN(x)); qkv with a bias."""
    h = layer_norm(w, prefix + "norm1", x, cfg["vit_eps"])
    q, k, v = linear(w, prefix + "attn.qkv", h).chunk(3, dim=-1)
    x = x + linear(w, prefix + "attn.proj",
                   attention(q, k, v, cfg["num_heads"]))
    h = layer_norm(w, prefix + "norm2", x, cfg["vit_eps"])
    return x + linear(w, prefix + "mlp.fc2",
                      gelu(linear(w, prefix + "mlp.fc1", h)))


def vit(w: Weights, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Normalised (N, 3, S, S - 2 margin) -> tokens (N, P, dim): the
    padded patch convolution, the position embedding with its first row
    added to every patch's, the blocks, the last LayerNorm."""
    x = F.conv2d(x, w["backbone.patch_embed.proj.weight"],
                 w["backbone.patch_embed.proj.bias"], cfg["patch_size"],
                 cfg["patch_padding"])
    x = x.flatten(2).transpose(1, 2)
    pos = w["backbone.pos_embed"]
    x = x + pos[:, 1:] + pos[:, :1]
    for i in range(cfg["depth"]):
        x = vit_block(w, f"backbone.blocks.{i}.", x, cfg)
    return layer_norm(w, "backbone.last_norm", x, cfg["vit_eps"])


def head(w: Weights, tokens: torch.Tensor, cfg: dict):
    """The transformer decoder on a zero token against the image tokens,
    one IEF step from the `init_*` buffers: (pose6d (N, 144), betas (N, 10),
    cam (N, 3))."""
    p = "smpl_head.transformer."
    N = tokens.shape[0]
    x = linear(w, p + "to_token_embedding", torch.zeros(N, 1, 1)) \
        + w[p + "pos_embedding"]
    eps, heads = cfg["head_eps"], cfg["heads"]
    for i in range(cfg["head_depth"]):
        q = f"{p}transformer.layers.{i}."
        h = layer_norm(w, q + "0.norm", x, eps)
        qq, k, v = linear(w, q + "0.fn.to_qkv", h).chunk(3, dim=-1)
        x = x + linear(w, q + "0.fn.to_out.0", attention(qq, k, v, heads))
        h = layer_norm(w, q + "1.norm", x, eps)
        k, v = linear(w, q + "1.fn.to_kv", tokens).chunk(2, dim=-1)
        x = x + linear(w, q + "1.fn.to_out.0",
                       attention(linear(w, q + "1.fn.to_q", h), k, v, heads))
        h = layer_norm(w, q + "2.norm", x, eps)
        x = x + linear(w, q + "2.fn.net.3",
                       gelu(linear(w, q + "2.fn.net.0", h)))
    t = x[:, 0]
    return (w["smpl_head.init_body_pose"] + linear(w, "smpl_head.decpose", t),
            w["smpl_head.init_betas"] + linear(w, "smpl_head.decshape", t),
            w["smpl_head.init_cam"] + linear(w, "smpl_head.deccam", t))


def rot6d_rows(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) read as rows a1 = x[:3], a2 = x[3:] -> rotation matrices
    (..., 3, 3) with columns b1, b2, b1 x b2 (Gram-Schmidt)."""
    a1, a2 = x[..., :3], x[..., 3:]
    b1 = a1 / a1.norm(dim=-1, keepdim=True)
    u = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = u / u.norm(dim=-1, keepdim=True)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    theta = aa.norm(dim=-1, keepdim=True)
    kx, ky, kz = (aa / theta.clamp(min=1e-12)).unbind(-1)
    zero = torch.zeros_like(kx)
    K = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero],
                    dim=-1).reshape(aa.shape[:-1] + (3, 3))
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    return torch.eye(3) + s * K + (1.0 - c) * (K @ K)


def smpl(s: dict, betas: torch.Tensor, rotmat: torch.Tensor):
    """SMPL with linear blend skinning: verts (B, V, 3) and the 49 joints.
    `s` holds v_template, shapedirs, posedirs, j_regressor, lbs_weights,
    j_regressor_extra and the tables parents, vertex_joint_ids,
    joint_map."""
    B = betas.shape[0]
    v_shaped = s["v_template"] + torch.einsum("bl,vkl->bvk", betas,
                                              s["shapedirs"])
    j_rest = torch.einsum("jv,bvk->bjk", s["j_regressor"], v_shaped)
    pose_feature = (rotmat[:, 1:] - torch.eye(3)).reshape(B, -1)
    v_posed = v_shaped + (pose_feature @ s["posedirs"]).reshape(B, -1, 3)
    G = []
    for j, parent in enumerate(s["parents"]):
        local = torch.zeros(B, 4, 4)
        local[:, :3, :3] = rotmat[:, j]
        local[:, :3, 3] = j_rest[:, j] - (j_rest[:, parent] if parent >= 0
                                          else 0.0)
        local[:, 3, 3] = 1.0
        G.append(local if parent < 0 else G[parent] @ local)
    G = torch.stack(G, dim=1)
    A = G[:, :, :3, :].clone()
    A[..., 3] = A[..., 3] - torch.einsum("bjik,bjk->bji", G[:, :, :3, :3],
                                         j_rest)
    blended = torch.einsum("vj,bjik->bvik", s["lbs_weights"], A)
    verts = torch.einsum("bvik,bvk->bvi", blended[..., :3], v_posed) \
        + blended[..., 3]
    extra = torch.einsum("jv,bvk->bjk", s["j_regressor_extra"], verts)
    keypoints = verts[:, list(s["vertex_joint_ids"])]
    joints54 = torch.cat([G[:, :, :3, 3], keypoints, extra], dim=1)
    return verts, joints54[:, list(s["joint_map"])]


def hmr2(w: Weights, s: dict, crops: torch.Tensor, cfg: dict) -> dict:
    """uint8 crops (N, 3, S, S) -> rotmat (N, 24, 3, 3), cam (N, 3), betas
    (N, 10), verts, kp_3d (N, 49, 3) and kp_2d (N, 49, 2): columns
    margin:-margin of the normalised crop through the ViT and the head,
    SMPL, translation [cam1, cam2, 2 f / (S cam0 + 1e-9)], projection at
    focal length f / S."""
    m, S, f = cfg["crop_margin"], cfg["image_size"], cfg["focal_length"]
    x = normalize(crops)[..., m:S - m]
    pose6d, betas, cam = head(w, vit(w, x, cfg), cfg)
    rotmat = rot6d_rows(pose6d.reshape(-1, 24, 6))
    verts, joints = smpl(s, betas, rotmat)
    t = torch.stack([cam[:, 1], cam[:, 2], 2.0 * f / (S * cam[:, 0] + 1e-9)],
                    dim=-1)
    p = joints + t[:, None]
    return {"rotmat": rotmat, "cam": cam, "betas": betas, "verts": verts,
            "kp_3d": joints, "kp_2d": (f / S) * p[..., :2] / p[..., 2:]}
