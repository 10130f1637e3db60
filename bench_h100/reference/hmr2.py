"""HMR 2.0's forward pass in plain PyTorch, for the cell `hmr2-engine-crops`.

Written from 4D-Humans ("Humans in 4D", arXiv:2305.20091; `hmr2/models/
hmr2.py`, `backbones/vit.py`, `heads/smpl_head.py`, `components/
pose_transformer.py`, experiment `hmr_vit_transformer.yaml`) with the
widths of `configs/hmr2.json`: the crop's columns 32:-32, the padded
16 x 16 patch convolution, the position embedding with its first row added
to every patch's, 32 pre-LN blocks (LayerNorm eps 1e-6, 16 heads, qkv with
a bias, exact GELU), the last LayerNorm; the decoder on a zero token (6
pre-LN layers of self-attention, cross-attention to the 192 image tokens
and a GELU feed-forward, eps 1e-5), one IEF step from the weights'
`init_*`, each joint's 6-vector read as two rows and turned into a
rotation by Gram-Schmidt, SMPL (`Reference.smpl`, the 49 joints the
program's SMPL gives).

Every product goes through `Reference.linear`, `.einsum` or `.conv`, so
the control (`Reference(tf32=True)`) computes each in TF32; the softmax of
every attention is written out, not `scaled_dot_product_attention`.
Crops go through in blocks, so the 631 M-parameter ViT's activations fit
beside the weights.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from bench_h100.reference.model import Reference

Weights = Dict[str, torch.Tensor]


def _linear(ref: Reference, w: Weights, prefix: str, x: torch.Tensor):
    return ref.linear(x, w[prefix + ".weight"], w.get(prefix + ".bias"))


def _norm(w: Weights, prefix: str, x: torch.Tensor, eps: float):
    return F.layer_norm(x, x.shape[-1:], w[prefix + ".weight"],
                        w[prefix + ".bias"], eps)


def attention(ref: Reference, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v per head: q (B, Nq, h d), k and v
    (B, Nk, h d) -> (B, Nq, h d)."""
    B, Nq, C = q.shape
    d = C // heads
    q, k, v = (t.reshape(B, t.shape[1], heads, d).transpose(1, 2)
               for t in (q, k, v))
    scores = ref.einsum("bhqd,bhkd->bhqk", q, k) * d ** -0.5
    p = torch.softmax(scores, dim=-1)
    out = ref.einsum("bhqk,bhkd->bhqd", p, v)
    return out.transpose(1, 2).reshape(B, Nq, C)


def vit(ref: Reference, w: Weights, x: torch.Tensor,
        config: dict) -> torch.Tensor:
    """Normalised crops' columns (N, 3, 256, 192) -> tokens (N, 192, 1280)."""
    v = config["vit"]
    eps, heads = v["ln_eps"], v["num_heads"]
    x = ref.conv(x, w["backbone.patch_embed.proj.weight"],
                 w["backbone.patch_embed.proj.bias"], v["patch_size"],
                 v["patch_padding"])
    x = x.flatten(2).transpose(1, 2)
    pos = w["backbone.pos_embed"]
    x = x + pos[:, 1:] + pos[:, :1]
    for i in range(v["depth"]):
        p = f"backbone.blocks.{i}."
        q, k, val = _linear(ref, w, p + "attn.qkv",
                            _norm(w, p + "norm1", x, eps)).chunk(3, dim=-1)
        x = x + _linear(ref, w, p + "attn.proj",
                        attention(ref, q, k, val, heads))
        h = F.gelu(_linear(ref, w, p + "mlp.fc1",
                           _norm(w, p + "norm2", x, eps)))
        x = x + _linear(ref, w, p + "mlp.fc2", h)
    return _norm(w, "backbone.last_norm", x, eps)


def head(ref: Reference, w: Weights, tokens: torch.Tensor, config: dict):
    """The decoder on a zero token and one IEF step: (pose6d (N, 144),
    betas (N, 10), cam (N, 3))."""
    h = config["head"]
    eps, heads = h["ln_eps"], h["heads"]
    p = "smpl_head.transformer."
    N = tokens.shape[0]
    x = _linear(ref, w, p + "to_token_embedding",
                tokens.new_zeros(N, 1, h["token_dim"]))
    x = x + w[p + "pos_embedding"]
    for i in range(h["depth"]):
        q = f"{p}transformer.layers.{i}."
        qq, k, v = _linear(ref, w, q + "0.fn.to_qkv",
                           _norm(w, q + "0.norm", x, eps)).chunk(3, dim=-1)
        x = x + _linear(ref, w, q + "0.fn.to_out.0",
                        attention(ref, qq, k, v, heads))
        k, v = _linear(ref, w, q + "1.fn.to_kv", tokens).chunk(2, dim=-1)
        qq = _linear(ref, w, q + "1.fn.to_q", _norm(w, q + "1.norm", x, eps))
        x = x + _linear(ref, w, q + "1.fn.to_out.0",
                        attention(ref, qq, k, v, heads))
        f = F.gelu(_linear(ref, w, q + "2.fn.net.0",
                           _norm(w, q + "2.norm", x, eps)))
        x = x + _linear(ref, w, q + "2.fn.net.3", f)
    t = x[:, 0]
    return tuple(
        w[f"smpl_head.init_{a}"] + _linear(ref, w, f"smpl_head.{b}", t)
        for a, b in (("body_pose", "decpose"), ("betas", "decshape"),
                     ("cam", "deccam")))


def rot6d_rows(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) read as rows a1 = x[:3], a2 = x[3:] -> rotations whose
    columns are b1, b2 and b1 x b2 (Gram-Schmidt)."""
    b1 = F.normalize(x[..., :3], dim=-1, eps=1e-6)
    a2 = x[..., 3:]
    b2 = F.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1,
                     eps=1e-6)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def frames(ref: Reference, w: Weights, smpl: Weights, crops: torch.Tensor,
           config: dict, block: int = 32) -> Dict[str, torch.Tensor]:
    """uint8 crops (N, 3, 256, 256) -> the judged outputs in
    `compare.gaps`' terms: rot (N, 24, 3, 3), camshape (N, 13), kp_3d
    (N, 49, 3), verts (N, V, 3)."""
    m, S = config["crop_margin"], config["image_size"]
    parts = []
    for i in range(0, len(crops), block):
        x = ref.normalize(crops[i:i + block])[..., m:S - m]
        pose6d, betas, cam = head(ref, w, vit(ref, w, x, config), config)
        rot = rot6d_rows(pose6d.reshape(-1, 24, 6))
        out = ref.smpl(smpl, betas, rot)
        parts.append({"rot": rot, "camshape": torch.cat([cam, betas], dim=1),
                      "kp_3d": out["joints49"], "verts": out["verts"]})
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
