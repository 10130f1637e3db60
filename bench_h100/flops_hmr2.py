"""Operations of HMR 2.0's forward pass, one crop, from the configuration's
widths (`configs/hmr2.json`). One multiply-add counts as 2 FLOPs, as in
`bench_h100/flops.py`, whose `smpl_flops` counts the SMPL forward and whose
peaks every share is taken against. Normalisation, LayerNorm, softmax and
GELU are left out: they are a few FLOPs a value where the products are
thousands.
"""

from __future__ import annotations

from bench_h100.flops import smpl_flops


def tokens(config: dict) -> int:
    """Patches the ViT reads: 192 at 256 x 192 and 16-pixel patches."""
    v = config["vit"]
    h, w = v["img_size"]
    return (h // v["patch_size"]) * (w // v["patch_size"])


def vit_flops(config: dict) -> int:
    """The patch convolution, and per block the qkv, output and two MLP
    products and the attention's two (q k^T and the weights times v) over
    the image tokens."""
    v = config["vit"]
    N, D, p = tokens(config), v["embed_dim"], v["patch_size"]
    patch = 2 * N * 3 * p * p * D
    gemms = 2 * N * D * (3 * D + D + 2 * v["mlp_ratio"] * D)
    attention = 2 * 2 * N * N * D
    return patch + v["depth"] * (gemms + attention)


def hmr2_head_flops(config: dict) -> int:
    """The decoder on one query token: per layer self-attention (qkv,
    attention over one key, out), cross-attention (q, the keys and values
    of the image tokens, attention over them, out) and the feed-forward;
    then the token embedding and the three decoders."""
    h = config["head"]
    D, inner, N = h["dim"], h["heads"] * h["dim_head"], tokens(config)
    self_attn = 2 * D * 3 * inner + 2 * 2 * inner + 2 * inner * D
    cross = (2 * D * inner + 2 * N * h["context_dim"] * 2 * inner
             + 2 * 2 * N * inner + 2 * inner * D)
    ff = 2 * D * h["mlp_dim"] * 2
    return (h["depth"] * (self_attn + cross + ff) + 2 * h["token_dim"] * D
            + 2 * D * (24 * 6 + 10 + 3))


def hmr2_flops(config: dict) -> int:
    """One crop: the ViT, the head and SMPL."""
    return (vit_flops(config) + hmr2_head_flops(config)
            + smpl_flops(config["smpl_vertices"]))
