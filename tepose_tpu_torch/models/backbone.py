"""ResNet-50 image backbone (the SPIN feature extractor), inference only.

Port of `tepose_tpu/models/backbone.py`. The backbone runs frozen, so every
BatchNorm is folded into its convolution (`_fold_bn`,
`convert_torch_resnet50`: numpy copies of the JAX package's), and each
conv carries a weight `w` (OIHW) and a bias `b`. `ResNet50`'s `state_dict`
keys are the JAX param-tree paths joined with "." (`stem.w`,
`layer1.0.conv1.w`, `layer1.0.downsample.b`, ...), so
`weights.state_dict_from_jax_tree(tree)` loads a JAX or converted tree with
`strict=True`.

The convolutions are `F.conv2d` (cuDNN on a CUDA device); the JAX
package's NHWC transposes were TPU layout and are not carried over. The
activations take the weights' memory format: float32 weights stay NCHW,
whose cuDNN fp32 kernels need no layout transposes, and `to_serving_layout`
puts reduced-precision weights in `channels_last`, the layout Hopper's
tensor cores read (measured on an H100: NCHW 1.2x faster in float32,
channels_last 1.27x faster in bfloat16 at 128 crops a chunk). The public
layout stays NCHW. In float32 a caller must turn cuDNN's TF32 off
(`torch.backends.cudnn.allow_tf32 = False`) for parity: it is on by default
for convolutions.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BOTTLENECK_LAYERS = (3, 4, 6, 3)  # ResNet-50
EXPANSION = 4
FEAT_DIM = 2048

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _fold_bn(conv_w: np.ndarray, bn: Dict[str, np.ndarray], eps: float = 1e-5):
    """Fold BatchNorm (eval) into the preceding conv: returns (w, b)."""
    gamma, beta = bn["weight"], bn["bias"]
    mean, var = bn["running_mean"], bn["running_var"]
    scale = gamma / np.sqrt(var + eps)
    w = conv_w * scale[:, None, None, None]
    b = beta - mean * scale
    return w.astype(np.float32), b.astype(np.float32)


def convert_torch_resnet50(sd: Dict) -> Dict:
    """Folded-BN backbone param tree (numpy) from an HMR torch state_dict
    whose values are tensors or numpy arrays."""
    def np_(k):
        v = sd[k]
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                          else v, np.float32)

    def bn(prefix):
        return {s: np_(f"{prefix}.{s}")
                for s in ("weight", "bias", "running_mean", "running_var")}

    def conv(w, b):
        return {"w": w, "b": b}

    params: Dict = {"stem": conv(*_fold_bn(np_("conv1.weight"), bn("bn1")))}
    for li, blocks in enumerate(BOTTLENECK_LAYERS, start=1):
        layer = []
        for bi in range(blocks):
            p = f"layer{li}.{bi}"
            blk = {f"conv{ci}": conv(*_fold_bn(np_(f"{p}.conv{ci}.weight"),
                                               bn(f"{p}.bn{ci}")))
                   for ci in (1, 2, 3)}
            if f"{p}.downsample.0.weight" in sd:
                blk["downsample"] = conv(*_fold_bn(
                    np_(f"{p}.downsample.0.weight"), bn(f"{p}.downsample.1")))
            layer.append(blk)
        params[f"layer{li}"] = layer
    return params


class _Conv(nn.Module):
    """A convolution with folded BN: weight `w` (O, I, k, k), bias `b`."""

    def __init__(self, out_ch: int, in_ch: int, k: int, stride: int,
                 padding: int, device: torch.device | str):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.w = nn.Parameter(torch.empty(out_ch, in_ch, k, k, device=device),
                              requires_grad=False)
        self.b = nn.Parameter(torch.empty(out_ch, device=device),
                              requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.w, self.b, self.stride, self.padding)


class _Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1, residual add, ReLU (spin.py:16-56)."""

    def __init__(self, inplanes: int, planes: int, stride: int,
                 downsample: bool, device: torch.device | str):
        super().__init__()
        self.conv1 = _Conv(planes, inplanes, 1, 1, 0, device)
        self.conv2 = _Conv(planes, planes, 3, stride, 1, device)
        self.conv3 = _Conv(planes * EXPANSION, planes, 1, 1, 0, device)
        self.downsample = (_Conv(planes * EXPANSION, inplanes, 1, stride, 0,
                                 device) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x), inplace=True)
        out = F.relu(self.conv2(out), inplace=True)
        out = self.conv3(out)
        out += self.downsample(x) if self.downsample is not None else x
        return F.relu(out, inplace=True)


class ResNet50(nn.Module):
    """The HMR ResNet-50 feature extractor with folded BN, parameters
    uninitialised (see `resnet50_init`, or load a converted tree). Block 0
    of every stage has a downsample conv, as in the JAX tree."""

    def __init__(self, *, device: torch.device | str):
        super().__init__()
        self.stem = _Conv(64, 3, 7, 2, 3, device)
        inplanes = 64
        for li, blocks in enumerate(BOTTLENECK_LAYERS, start=1):
            planes = 64 * 2 ** (li - 1)
            stride = 1 if li == 1 else 2
            layer = nn.ModuleList()
            for bi in range(blocks):
                layer.append(_Bottleneck(inplanes, planes,
                                         stride if bi == 0 else 1,
                                         downsample=bi == 0, device=device))
                inplanes = planes * EXPANSION
            setattr(self, f"layer{li}", layer)

    @property
    def dtype(self) -> torch.dtype:
        return self.stem.w.dtype

    @property
    def memory_format(self) -> torch.memory_format:
        """The weights' layout, which `resnet50_features` gives the
        activations too."""
        return (torch.channels_last if self.stem.w.is_contiguous(
            memory_format=torch.channels_last) else torch.contiguous_format)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """`resnet50_features(self, x)`."""
        return resnet50_features(self, x)


@torch.no_grad()
def resnet50_init(generator: torch.Generator,
                  device: torch.device | str) -> ResNet50:
    """Random folded-form weights, as the JAX `resnet50_init` draws them:
    each conv weight N(0, 2 / fan_in) (He), every bias zero. The draws come
    from `generator` on the CPU in the JAX tree's order (stem, then conv1,
    conv2, conv3, downsample of each block) and are copied to `device`, so
    one seed gives the same weights on any device.

    With zero biases and no BN the net is positively homogeneous, and each
    residual block adds its branch to its input: the features' magnitude
    grows with depth (see `tools/make_torch_serve_golden.py`).
    """
    model = ResNet50(device=device)
    for conv in model.modules():
        if isinstance(conv, _Conv):
            fan_in = conv.w[0].numel()
            conv.w.copy_(torch.randn(conv.w.shape, generator=generator)
                         * math.sqrt(2.0 / fan_in))
            conv.b.zero_()
    return model


def resnet50_features(model: ResNet50, x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) normalised crops -> (B, 2048) features, in the model's
    dtype: stem conv 7x7/2 and max pool 3x3/2, four bottleneck stages,
    global average pool (spin.py:127-141)."""
    out = F.relu(model.stem(x.contiguous(memory_format=model.memory_format)),
                 inplace=True)
    out = F.max_pool2d(out, 3, 2, 1)   # -inf padding, as reduce_window's
    for li in range(1, 5):
        for blk in getattr(model, f"layer{li}"):
            out = blk(out)
    return out.mean(dim=(2, 3))


def to_serving_layout(model: ResNet50,
                      dtype: Optional[torch.dtype]) -> ResNet50:
    """The backbone to serve in `dtype`: the model itself when that is its
    dtype (or None), else a copy cast once, in `channels_last` (the JAX
    package casts the weights inside every call)."""
    if dtype is None or dtype == model.dtype:
        return model
    return copy.deepcopy(model).to(dtype=dtype,
                                   memory_format=torch.channels_last)


def normalize_crop(x: torch.Tensor) -> torch.Tensor:
    """uint8 or float [0, 255] (B, 3, H, W) -> ImageNet-normalised float32
    (ToTensor + Normalize, _img_utils.py:322-330).

    The float32 mean and std enter as scalars, one channel at a time: a
    tensor of them built from host data would be a blocking upload, which
    waits for the device's queue."""
    x = x.float() / 255.0
    return torch.stack([(x[:, c] - float(m)) / float(s) for c, (m, s)
                        in enumerate(zip(IMAGENET_MEAN, IMAGENET_STD))], dim=1)


def backbone_chunk(backbone: ResNet50, crops: torch.Tensor) -> torch.Tensor:
    """float32 features (N, 2048) of one chunk of crops (N, 3, H, W).

    uint8 crops are raw pixels, normalised here on the device (a quarter of
    the bytes of float32 to upload); float crops must be normalised
    already. The crops are cast to the backbone's dtype, so a bfloat16 copy
    of the backbone runs its conv stack in bfloat16.
    """
    if crops.dtype == torch.uint8:
        crops = normalize_crop(crops)
    return backbone(crops.to(backbone.dtype)).float()


def hmr_forward(backbone: ResNet50, regressor, smpl, images: torch.Tensor,
                n_iter: int = 3, return_features: bool = False):
    """Single-frame HMR (spin.py:143-206): normalised crops (B, 3, 224,
    224) -> ResNet-50 features -> `n_iter` IEF steps -> SMPL outputs.
    `regressor` is a `models.regressor.Regressor`."""
    xf = backbone(images)
    out = regressor(xf, smpl, n_iter=n_iter)
    if return_features:
        return xf, out
    return out

