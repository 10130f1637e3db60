"""`ops/vit_linear.py` on the CPU: the plain path of ViT-H's linear layers,
the ViT that calls it against the ViT as it was written before (each
linear through `nn.Linear`, the residual adds and the GELU outside), the
numerical argument of the CUDA kernel's 3xTF32 split in a float32
emulation, and the checks the CUDA path makes before a launch.

No JAX: the ViT has no counterpart in the JAX package. The kernel itself
is held to float64 on the card (tests/test_torch_cuda.py).
"""

import pytest
import torch
import torch.nn.functional as F

from tepose_tpu_torch.models.vit import ViT, ViTConfig
from tepose_tpu_torch.ops import vit_linear as VL


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual", "no_bias"])
def test_vit_linear_on_cpu_is_the_plain_version(epilogue):
    """Bit for bit `F.linear`, then `F.gelu` or `residual + out`."""
    g = _gen(0)
    x = torch.randn(2, 7, 64, generator=g)
    w = torch.randn(96, 64, generator=g) * 0.02
    b = None if epilogue == "no_bias" else torch.randn(96, generator=g)
    r = torch.randn(2, 7, 96, generator=g)
    want = F.linear(x, w, b)
    if epilogue == "gelu":
        got = VL.vit_linear(x, w, b, gelu=True)
        want = F.gelu(want)
    elif epilogue == "residual":
        got = VL.vit_linear(x, w, b, residual=r)
        want = r + want
    else:
        got = VL.vit_linear(x, w, b)
    assert got.shape == (2, 7, 96)
    assert torch.equal(got, want)


def _parent_vit(vit: ViT, images: torch.Tensor) -> torch.Tensor:
    """The ViT's forward as written before the fused linears: every linear
    an `nn.Linear` call, GELU and the residual adds as separate ops."""
    x = vit.patch_embed(images)
    x = x + vit.pos_embed[:, 1:] + vit.pos_embed[:, :1]
    for blk in vit.blocks:
        attn = blk.attn
        B, N, C = x.shape
        qkv = attn.qkv(blk.norm1(x)).reshape(
            B, N, 3, attn.num_heads, -1).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        x = x + attn.proj(out.transpose(1, 2).reshape(B, N, C))
        x = x + blk.mlp.fc2(F.gelu(blk.mlp.fc1(blk.norm2(x))))
    return vit.last_norm(x)


@pytest.mark.parametrize("cfg,batch", [
    (ViTConfig(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4), 3),
    (ViTConfig(depth=1), 1),
], ids=["small", "published_block"])
def test_vit_equals_the_unfused_forward(cfg, batch):
    """Same seed, same weights (the biases drawn too, not left zero): the
    ViT with the new calls gives the old forward's output exactly."""
    vit = ViT(cfg, generator=_gen(0)).eval()
    g = _gen(1)
    with torch.no_grad():
        for m in vit.modules():
            if isinstance(m, torch.nn.Linear) and m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.02)
        images = torch.randn(batch, 3, *cfg.img_size, generator=g)
        got = vit(images)
        want = _parent_vit(vit, images)
    assert got.shape == (batch, cfg.num_patches, cfg.embed_dim)
    assert torch.allclose(got, want, rtol=0, atol=0)


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """float32 to the nearest TF32 value (10 mantissa bits), ties away from
    zero, as `cvt.rna.tf32.f32` rounds: add half of the 13 dropped bits'
    unit to the magnitude's bits, then clear them."""
    bits = a.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = tf32_round(a)
    return big, tf32_round(a - big)


def test_tf32_split_reconstructs_float32():
    """big and small are TF32 values (low 13 bits clear), big is a rounded
    to nearest, and big + small is a within 2^-22 of |a|: float32's own
    rounding (2^-24) and the small part's (2^-11 of 2^-11)."""
    a = torch.randn(1 << 20, generator=_gen(2)) * torch.exp(
        torch.randn(1 << 20, generator=_gen(3)) * 4)
    big, small = split_tf32(a)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert float(((a - big).abs() / a.abs()).max()) <= 2.0 ** -11
    err = ((big + small).double() - a.double()).abs() / a.double().abs()
    assert float(err.max()) <= 2.0 ** -22


def _blocked_3xtf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x w^T in float32 as the kernel sums it: per 32 columns of K the three
    products a_small b_big + a_big b_small + a_big b_big, then the blocks'
    sums added one after the other."""
    (xb, xs), (wb, ws) = split_tf32(x), split_tf32(w)
    M, K = x.shape
    blocks = K // VL.K_MULTIPLE

    def prod(a, b):
        return torch.einsum("mbk,nbk->bmn", a.view(M, blocks, -1),
                            b.view(b.shape[0], blocks, -1))

    part = prod(xs, wb) + prod(xb, ws) + prod(xb, wb)
    acc = torch.zeros(M, w.shape[0])
    for blk in part:
        acc = acc + blk
    return acc


@pytest.mark.parametrize("K", [1280, 5120])
def test_3xtf32_product_is_float32_accurate(K):
    """At the ViT's depths (K of qkv, proj, fc1 and of fc2), the emulated
    3xTF32 product's worst error from float64, over the largest output,
    is within 4x of a float32 product's; plain TF32 is far outside it."""
    g = _gen(K)
    x = torch.randn(64, K, generator=g)
    w = torch.randn(128, K, generator=g) * 0.02
    want = x.double() @ w.double().T
    scale = float(want.abs().max())

    def rel(y):
        return float((y.double() - want).abs().max()) / scale

    f32 = rel(x @ w.T)
    split = rel(_blocked_3xtf32(x, w))
    tf32 = rel(tf32_round(x) @ tf32_round(w).T)
    assert split <= 4 * f32
    assert tf32 > 50 * f32


@pytest.mark.parametrize("M,N,K", [(24_576, 3840, 100), (192, 1280, 16),
                                   (2112, 5120, 1288), (192, 96, 1280),
                                   (0, 1280, 1280)])
def test_refuses_what_the_kernel_does_not_take(M, N, K):
    """K must be a multiple of 32 and N of the tile width; the rule hands
    the narrowest width where none divides N, and the check refuses it."""
    bn = VL.block_n(max(M, 1), N, 132)
    with pytest.raises(ValueError):
        VL.check_shapes(M, N, K, bn)


@pytest.mark.parametrize("name,N,K", [("qkv", 3840, 1280),
                                      ("proj", 1280, 1280),
                                      ("fc1", 5120, 1280),
                                      ("fc2", 1280, 5120)])
@pytest.mark.parametrize("M", [24_576, 2112, 192])
def test_the_vit_shapes_pass_the_checks(name, N, K, M):
    bn = VL.block_n(M, N, 132)
    assert bn in VL.BLOCK_NS and N % bn == 0
    VL.check_shapes(M, N, K, bn)


def test_tile_rule_counts_waves():
    """Where the wide tiles fill whole waves the rule keeps them; where
    they leave most of a last wave idle it takes the narrow ones."""
    assert VL.block_n(24_576, 3840, 132) == 128   # 5,760 tiles, 43.6 waves
    # 170 wide tiles are 1.3 waves; 340 narrow ones 2.6
    assert VL.block_n(2112, 1280, 132) == 64
    assert VL.block_n(192, 1280, 132) == 64


def test_cpu_path_refuses_bad_calls():
    x = torch.randn(4, 64)
    w = torch.randn(96, 64)
    with pytest.raises(ValueError):
        VL.vit_linear(x, w, gelu=True, residual=torch.randn(4, 96))
    with pytest.raises(ValueError):
        VL.vit_linear(x, torch.randn(96, 32))
    with pytest.raises(ValueError):
        VL.vit_linear(x, w, torch.randn(95))
    with pytest.raises(ValueError):
        VL.vit_linear(x, w, residual=torch.randn(4, 95))
