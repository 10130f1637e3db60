"""The GCN motion discriminator as an nn.Module, with row-masked BatchNorm.

Port of `tepose_tpu/models/gcn.py` (`bn_apply`, `conv1x1`,
`temporal_conv_apply`, `mlp_apply`, `ms_gcn_apply`,
`unfold_temporal_windows`, `st_ms_gcn_apply`, `ms_g3d_apply`,
`motion_discriminator_init` / `_apply`). It scores theta sequences
(N, T, 72) for realism: data BN, three blocks of MS-GCN (spatial
multi-scale) + MS-G3D (windowed spatial-temporal) + a 1x1 temporal-conv
residual, global average pooling, FC and softmax, returning P(real).

The module's `state_dict` keys are the JAX `(params, state)` tree paths
joined with "." (`gcn3d1.st.mlp.layers.0.bn.running_mean`, ...):
`weights.disc_state_dict_from_jax` / `disc_jax_trees_from_state_dict` map
between them. Parameters are the JAX params (`A_res` is trained); the BN
running statistics and the constant adjacencies `A_powers` / `A_scales` are
buffers, as they are JAX state.

torch's BatchNorm cannot do what `bn_apply` does, so `MaskedBatchNorm`
does it: statistics over the rows of `row_mask` only, the running
variance's unbiased factor from the masked count, and running statistics
left as they are when every row is masked. The update is written with
`torch.where`, so a CUDA caller never waits on the mask's count. In a
data-parallel segment (`parallel/dp.py`) the masked sums and the row count
are summed over every process's rows, with gradients, as `SyncBatchNorm`
does and as GSPMD does for the JAX module under a mesh; stock
`SyncBatchNorm` has no row mask. The unmasked statistics stay local (the
training step always passes a mask).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tepose_tpu_torch.models.graph import (
    multi_scale_adjacency, smpl_graph_binary, spatial_temporal_adjacency)
from tepose_tpu_torch.parallel.distributed import (
    reducing_world, sum_across_with_grad)

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def _uniform(shape, bound: float, generator: torch.Generator,
             device) -> nn.Parameter:
    """U(-bound, bound), drawn on the CPU from `generator`."""
    draw = torch.rand(shape, generator=generator, dtype=torch.float32)
    return nn.Parameter((draw * (2.0 * bound) - bound).to(device))


class MaskedBatchNorm(nn.Module):
    """BatchNorm over every axis but 1, torch semantics, with `row_mask`
    (N,) restricting the statistics to the selected rows (`bn_apply`).
    Masked-out rows are still normalised. Statistics are float32."""

    def __init__(self, num_features: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor,
                row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        axes = tuple(i for i in range(x.dim()) if i != 1)
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        if not self.training:
            mean, var = self.running_mean, self.running_var
        elif row_mask is not None:
            m = row_mask.float().reshape((-1,) + (1,) * (x.dim() - 1))
            per_row = x.numel() / (x.shape[0] * x.shape[1])
            cnt = row_mask.float().sum()
            total = (x * m).sum(dim=axes)
            if reducing_world() > 1:
                # under a data-parallel segment the sums cover every
                # process's rows, gradients included: one all-reduce for
                # the sums and the count
                sums = sum_across_with_grad(torch.cat([total, cnt[None]]))
                total, cnt = sums[:-1], sums[-1].detach()
            n = torch.clamp(cnt * per_row, min=1.0)
            mean = total / n
            var = sum_across_with_grad(
                (((x - mean.reshape(shape)) ** 2) * m).sum(dim=axes)) / n
            unbiased = var * n / torch.clamp(n - 1, min=1.0)
            # all rows masked: the reference skips the forward, so the
            # running statistics must not move
            self._update(mean, unbiased, cnt > 0)
        else:
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, unbiased=False)
            n = x.numel() / x.shape[1]
            self._update(mean, var * n / max(n - 1, 1), None)
        inv = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean.reshape(shape)) * inv.reshape(shape) \
            + self.bias.reshape(shape)

    @torch.no_grad()
    def _update(self, mean, unbiased, any_rows) -> None:
        new_mean = (1 - BN_MOMENTUM) * self.running_mean + BN_MOMENTUM * mean
        new_var = (1 - BN_MOMENTUM) * self.running_var \
            + BN_MOMENTUM * unbiased
        if any_rows is not None:
            new_mean = torch.where(any_rows, new_mean, self.running_mean)
            new_var = torch.where(any_rows, new_var, self.running_var)
        self.running_mean.copy_(new_mean)
        self.running_var.copy_(new_var)


class _Affine(nn.Module):
    """A weight and a bias, applied by the owner (keeps the JAX key names)."""

    def __init__(self, w_shape, bound: float, generator, device):
        super().__init__()
        self.weight = _uniform(w_shape, bound, generator, device)
        self.bias = _uniform((w_shape[0],), bound, generator, device)


def conv1x1(conv: _Affine, x: torch.Tensor) -> torch.Tensor:
    """1x1 Conv2d over (N, C, T, V)."""
    return torch.einsum("oc,nctv->notv", conv.weight, x) \
        + conv.bias[None, :, None, None]


class TemporalConv(nn.Module):
    """Conv2d kernel (k, 1) + BN (`temporal_conv_apply`)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *,
                 generator, device):
        super().__init__()
        self.conv = _Affine((out_ch, in_ch, kernel_size),
                            1.0 / np.sqrt(in_ch * kernel_size), generator,
                            device)
        self.bn = MaskedBatchNorm(out_ch, device)

    def forward(self, x, row_mask=None):
        k = self.conv.weight.shape[-1]
        out = F.conv2d(x, self.conv.weight[..., None], self.conv.bias,
                       padding=((k - 1) // 2, 0))
        return self.bn(out, row_mask)


class _MLPLayer(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, *, generator, device):
        super().__init__()
        self.conv = _Affine((out_ch, in_ch), 1.0 / np.sqrt(in_ch), generator,
                            device)
        self.bn = MaskedBatchNorm(out_ch, device)


class MLP(nn.Module):
    """Stack of [Conv2d 1x1 -> BN -> act] (`mlp_apply`)."""

    def __init__(self, in_ch: int, out_chs, *, generator, device):
        super().__init__()
        chs = [in_ch] + list(out_chs)
        self.layers = nn.ModuleList(
            _MLPLayer(a, b, generator=generator, device=device)
            for a, b in zip(chs[:-1], chs[1:]))

    def forward(self, x, row_mask=None, activation: str = "relu"):
        for layer in self.layers:
            x = layer.bn(conv1x1(layer.conv, x), row_mask)
            if activation == "relu":
                x = torch.relu(x)
        return x


def _aggregate(A: torch.Tensor, x: torch.Tensor, num_scales: int):
    """Multi-scale graph aggregation: A (S*V, V) over x (N, C, T, V) ->
    (N, S*C, T, V), scales major."""
    N, C, T, V = x.shape
    support = torch.einsum("vu,nctu->nctv", A, x)
    support = support.reshape(N, C, T, num_scales, V)
    return support.movedim(3, 1).reshape(N, num_scales * C, T, V)


class MSGCN(nn.Module):
    """Multi-scale spatial graph conv (`ms_gcn_apply`)."""

    def __init__(self, num_scales: int, in_ch: int, out_ch: int,
                 A_binary: np.ndarray, *, generator, device):
        super().__init__()
        self.num_scales = num_scales
        A_powers = multi_scale_adjacency(A_binary, num_scales)
        self.mlp = MLP(in_ch * num_scales, [out_ch], generator=generator,
                       device=device)
        self.A_res = _uniform(A_powers.shape, 1e-6, generator, device)
        self.register_buffer("A_powers",
                             torch.as_tensor(A_powers, device=device))

    def forward(self, x, row_mask=None):
        A = self.A_powers + self.A_res
        return self.mlp(_aggregate(A, x, self.num_scales), row_mask)


def unfold_temporal_windows(x: torch.Tensor,
                            window_size: int) -> torch.Tensor:
    """(N, C, T, V) -> (N, C, T', window*V) sliding temporal windows
    (stride 1, dilation 1: the only ones the discriminator uses)."""
    N, C, T, V = x.shape
    pad = (window_size - 1) // 2
    xp = F.pad(x, (0, 0, pad, pad))
    Tout = T + 2 * pad - window_size + 1
    slices = [xp[:, :, w:w + Tout] for w in range(window_size)]
    # (N, C, T', window, V) -> (N, C, T', window*V)
    return torch.stack(slices, dim=3).reshape(N, C, Tout, window_size * V)


class STMSGCN(nn.Module):
    """Spatial-temporal multi-scale GCN over the unfolded window graph
    (`st_ms_gcn_apply`): linear MLP, then ReLU."""

    def __init__(self, in_ch: int, out_ch: int, A_binary: np.ndarray,
                 num_scales: int, window_size: int, *, generator, device):
        super().__init__()
        self.num_scales = num_scales
        A_scales = multi_scale_adjacency(
            spatial_temporal_adjacency(A_binary, window_size), num_scales)
        self.mlp = MLP(in_ch * num_scales, [out_ch], generator=generator,
                       device=device)
        self.A_res = _uniform(A_scales.shape, 1e-6, generator, device)
        self.register_buffer("A_scales",
                             torch.as_tensor(A_scales, device=device))

    def forward(self, x, row_mask=None):
        A = self.A_scales + self.A_res
        agg = _aggregate(A, x, self.num_scales)
        return torch.relu(self.mlp(agg, row_mask, activation="linear"))


class MSG3D(nn.Module):
    """MS-G3D pathway (`ms_g3d_apply`): the first block (in = 3) embeds to
    out_ch inside the ST-GCN, later blocks keep channels and embed in the
    collapse conv, a Conv3d (1, window, 1) held as (O, C_embed, window)."""

    def __init__(self, in_ch: int, out_ch: int, A_binary: np.ndarray,
                 num_scales: int, window_size: int = 3, *, generator, device):
        super().__init__()
        self.window_size = window_size
        embed_out = out_ch if in_ch == 3 else in_ch
        self.st = STMSGCN(in_ch, embed_out, A_binary, num_scales, window_size,
                          generator=generator, device=device)
        self.out_conv = _Affine((out_ch, embed_out, window_size),
                                1.0 / np.sqrt(embed_out * window_size),
                                generator, device)
        self.out_bn = MaskedBatchNorm(out_ch, device)

    def forward(self, x, row_mask=None):
        N, C, T, V = x.shape
        out = self.st(unfold_temporal_windows(x, self.window_size), row_mask)
        out = out.reshape(N, out.shape[1], out.shape[2], self.window_size, V)
        out = torch.einsum("ocw,nctwv->notv", self.out_conv.weight, out) \
            + self.out_conv.bias[None, :, None, None]
        return self.out_bn(out, row_mask)


class MotionDiscriminator(nn.Module):
    """(N, T, 72) pose sequences -> (N,) P(real)
    (`motion_discriminator_init` / `motion_discriminator_apply`).

    Weights are drawn from `generator` on the CPU in the JAX init's
    distributions: U(+-1/sqrt(fan_in)) for convs and FC, U(+-1e-6) for
    `A_res`, BN weight 1 and bias 0, running mean 0 and variance 1.
    In training mode (`train()`) every BN normalises with the statistics of
    the rows of `row_mask` and advances its running statistics."""

    def __init__(self, *, generator: torch.Generator,
                 device: torch.device | str, num_class: int = 2,
                 num_point: int = 24, in_channels: int = 3,
                 num_gcn_scales: int = 13, num_g3d_scales: int = 6,
                 window_size: int = 3):
        super().__init__()
        self.num_point, self.in_channels = num_point, in_channels
        A_binary = smpl_graph_binary()
        kw = dict(generator=generator, device=device)
        self.data_bn = MaskedBatchNorm(num_point * in_channels, device)
        dims = [(in_channels, 64), (64, 128), (128, 256)]
        for i, (ci, co) in enumerate(dims, start=1):
            self.add_module(f"gcn3d{i}", MSG3D(ci, co, A_binary,
                                               num_g3d_scales, window_size,
                                               **kw))
            self.add_module(f"sgcn{i}", MSGCN(num_gcn_scales, ci, co,
                                              A_binary, **kw))
            self.add_module(f"residual_{i}", TemporalConv(ci, co, 1, **kw))
        self.fc = _Affine((num_class, dims[-1][1]),
                          1.0 / np.sqrt(dims[-1][1]), generator, device)

    def forward(self, x: torch.Tensor,
                row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        N, T, _ = x.shape
        xt = self.data_bn(x.transpose(1, 2), row_mask)       # (N, V*C, T)
        h = xt.reshape(N, self.num_point, self.in_channels, T).permute(
            0, 2, 3, 1)                                       # (N, C, T, V)
        for i in (1, 2, 3):
            res = getattr(self, f"residual_{i}")(h, row_mask)
            g3d = getattr(self, f"gcn3d{i}")(h, row_mask)
            sg = getattr(self, f"sgcn{i}")(h, row_mask)
            h = torch.relu(torch.relu(sg + g3d) + res)
        out = h.reshape(N, h.shape[1], -1).mean(dim=2)       # GAP over (T, V)
        logits = F.linear(out, self.fc.weight, self.fc.bias)
        return torch.softmax(logits, dim=1)[:, 0]
