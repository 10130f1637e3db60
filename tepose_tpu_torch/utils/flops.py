"""Analytic FLOP accounting for the flagship models, FLOPs counted by
PyTorch, and the H100's peak rates.

The formulas (`conv2d_flops` ... `model_flops_per_frame`) are a copy of
`tepose_tpu/utils/flops.py`, pinned equal to it and within 6 % of
`counted_flops` on the port's modules by tests/test_torch_flops.py. One
multiply-add counts as 2 FLOPs, as `torch.utils.flop_counter` counts.
`peak_flops` replaces the JAX module's TPU table with the H100's, and
`counted_flops` replaces its `xla_flops`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# ---------------------------------------------------------------- card peaks

# Dense peak rates per card, FLOP/s, from NVIDIA's H100 Tensor Core GPU
# datasheet ("Technical Specifications": the H100 SXM, H100 PCIe and H100
# NVL columns; its tensor-core figures are with 2:4 sparsity and are halved
# here for dense work). "float32" is the CUDA cores' FP32 rate, the ceiling
# of the port's strict-float32 paths (TF32 off); "tf32" and "bfloat16" are
# the tensor cores'. Keys are `torch.cuda.get_device_name` prefixes.
H100_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "tf32": 494.5e12,
                              "bfloat16": 989.5e12},      # SXM5
    "NVIDIA H100 PCIe": {"float32": 51e12, "tf32": 378e12,
                         "bfloat16": 756.5e12},
    "NVIDIA H100 NVL": {"float32": 60e12, "tf32": 417.5e12,
                        "bfloat16": 835.5e12},
}


def _peak_key(dtype) -> str:
    if dtype in ("tf32", "tensorfloat32"):
        return "tf32"
    if dtype in (torch.bfloat16, torch.float16, "bfloat16", "float16"):
        return "bfloat16"
    if dtype in (torch.float32, "float32"):
        return "float32"
    raise ValueError(f"no peak rate for dtype {dtype!r}")


def peak_flops_for(kind: str, dtype=torch.float32) -> Optional[float]:
    """Dense peak FLOP/s of the card named `kind` for `dtype` (float32,
    "tf32", bfloat16 or float16), from the entry with the longest matching
    prefix; None for a card without an entry."""
    key = _peak_key(dtype)
    best = max((k for k in H100_PEAK_FLOPS if kind.startswith(k)),
               key=len, default=None)
    return None if best is None else H100_PEAK_FLOPS[best][key]


def peak_flops(device=None, dtype=torch.float32) -> Optional[float]:
    """Dense peak FLOP/s of `device` (default: the current CUDA device) for
    `dtype`; None on the CPU or on a card without an entry."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return peak_flops_for(torch.cuda.get_device_name(device), dtype)


def _cudnn_rnn_flops(input_shape, weight, weight_stride0, weight_buf, hx, cx,
                     mode, hidden_size, proj_size, num_layers, batch_first,
                     dropout, train, bidirectional, *args, out_shape=None,
                     **kwargs) -> int:
    """cuDNN's fused RNN, which `FlopCounterMode` has no formula for: per
    step, direction and layer the input and hidden projections of every
    gate (`gru_flops` for a GRU), times the batch."""
    gates = {0: 1, 1: 1, 2: 4, 3: 3}[int(mode)]   # RNN relu/tanh, LSTM, GRU
    T, B, in_size = ((input_shape[1], input_shape[0], input_shape[2])
                     if batch_first else tuple(input_shape))
    dirs = 2 if bidirectional else 1
    H, total = int(hidden_size), 0
    for layer in range(int(num_layers)):
        in_l = in_size if layer == 0 else H * dirs
        total += dirs * T * B * 2 * gates * H * (in_l + H)
    return total


def counted_flops(fn, *args, **kwargs) -> float:
    """FLOPs of `fn(*args, **kwargs)` as `torch.utils.flop_counter` counts
    them (matmuls, convolutions, attention; cuDNN's RNN through
    `_cudnn_rnn_flops`). Elementwise work and the custom CUDA kernels
    launched through ctypes are not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    mapping = {}
    if hasattr(torch.ops.aten, "_cudnn_rnn"):
        mapping[torch.ops.aten._cudnn_rnn] = _cudnn_rnn_flops
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


# ------------------------------------------------------------ conv networks

def conv2d_flops(h_out: int, w_out: int, c_in: int, c_out: int,
                 kh: int, kw: int) -> int:
    return 2 * h_out * w_out * c_in * c_out * kh * kw


def resnet50_flops(h: int = 224, w: int = 224) -> int:
    """One forward pass of the SPIN ResNet-50 feature extractor per crop
    (ref: spin.py:127-141; our models/backbone.py: stride on the 3x3,
    torchvision v1.5 convention, folded BN so convs are the whole cost)."""
    total = conv2d_flops(h // 2, w // 2, 3, 64, 7, 7)          # stem /2
    hh, ww = h // 4, w // 4                                     # maxpool /2
    c_in = 64
    stages = ((64, 256, 3, 1), (128, 512, 4, 2),
              (256, 1024, 6, 2), (512, 2048, 3, 2))
    for mid, c_out, blocks, stride in stages:
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            ho, wo = hh // s, ww // s
            total += conv2d_flops(hh, ww, c_in, mid, 1, 1)      # 1x1 in
            total += conv2d_flops(ho, wo, mid, mid, 3, 3)       # 3x3 (s)
            total += conv2d_flops(ho, wo, mid, c_out, 1, 1)     # 1x1 out
            if bi == 0:
                total += conv2d_flops(ho, wo, c_in, c_out, 1, 1)  # downsample
            hh, ww, c_in = ho, wo, c_out
    return total


# ----------------------------------------------------------------- recurrent

def gru_flops(T: int, input_size: int, hidden: int, n_layers: int,
              bidirectional: bool) -> int:
    """T timesteps of a stacked (possibly bidirectional) GRU: per step,
    direction and layer the input and hidden projections each produce the
    3H gate pre-activations (torch layout, models/layers.gru)."""
    dirs = 2 if bidirectional else 1
    total = 0
    for layer in range(n_layers):
        in_l = input_size if layer == 0 else hidden * dirs
        total += dirs * T * (2 * in_l * 3 * hidden
                             + 2 * hidden * 3 * hidden)
    return total


def encoder_window_flops(seqlen: int, n_layers: int, hidden: int,
                         input_dim: int = 2048 + 85) -> int:
    """One TePose TemporalEncoder window (ref: tepose.py:41-76): a forward
    GRU + a bidirectional GRU over the S-frame window, plus the output
    linears (H->2048 on the last frame; 2H->2048 on the fused frame)."""
    return (gru_flops(seqlen, input_dim, hidden, n_layers, False)
            + gru_flops(seqlen, input_dim, hidden, n_layers, True)
            + 2 * hidden * 2048
            + 2 * (2 * hidden) * 2048)


def fast_scan_window_flops(seqlen: int = 6, n_layers: int = 2,
                           hidden: int = 1024) -> int:
    """One steady-state window of streaming/fast_scan.py with precomputed
    frame projections: the per-frame layer-0 FEATURE projections are
    amortized (one new frame per window), so a window pays the theta
    projections, the recurrent h-projections of every lane/step, the
    layer-1+ input projections, the output linears and the IEF+SMPL-free
    head is counted separately by callers. Mirrors fast_encoder.py's lane
    structure (3 lanes; last layer runs 2 full lanes + 1 single step)."""
    H3 = 3 * hidden
    total = 0
    # one new frame's feature projection, all 3 lanes (amortized precompute)
    total += 3 * 2 * 2048 * H3
    # theta projections for all S frames, 3 lanes (recomputed every window:
    # the feedback channel changes each step)
    total += seqlen * 3 * 2 * 85 * H3
    # layer 0: h-projections, 3 lanes, S steps
    total += seqlen * 3 * 2 * hidden * H3
    for li in range(1, n_layers):
        last = li == n_layers - 1
        # input projections from the (2H-wide) previous-layer sequences
        lanes_full = 2 if last else 3
        total += seqlen * lanes_full * 2 * (2 * hidden) * H3
        total += seqlen * lanes_full * 2 * hidden * H3      # h-projections
        if last:  # rec-forward lane: a single step (tail truncation)
            total += 2 * (2 * hidden) * H3 + 2 * hidden * H3
    # output linears (H->2048 and 2H->2048)
    total += 2 * hidden * 2048 + 2 * (2 * hidden) * 2048
    return total


# --------------------------------------------------------------- regression

NPOSE = 24 * 6


def regressor_ief_flops(n_iter: int = 3) -> int:
    """SPIN IEF head (models/regressor.py:41-45; ref: spin.py:156-239):
    per iteration fc1 (2205->1024), fc2 (1024->1024) and the three decoders."""
    per_iter = (2 * (2048 + NPOSE + 13) * 1024
                + 2 * 1024 * 1024
                + 2 * 1024 * (NPOSE + 10 + 3))
    return n_iter * per_iter


def smpl_flops(num_verts: int = 6890, num_joints: int = 24,
               num_kp: int = 49) -> int:
    """One SMPL forward (models/smpl.py): shape/pose blendshapes, joint
    regression, kinematic chain, LBS skinning, keypoint regression."""
    V, J, K = num_verts, num_joints, num_kp
    return (2 * V * 3 * 10            # shapedirs
            + 2 * V * 3 * 207         # posedirs
            + 2 * J * V * 3           # J_regressor (template joints)
            + J * (9 * 6 + 50)        # rodrigues + 4x4 chain composition
            + 2 * V * J * 16          # blend weights x joint transforms
            + V * 3 * 9               # apply per-vertex transform
            + 2 * K * V * 3)          # 49-keypoint regression


def streaming_flops_per_call(n_streams: int, frames: int, seqlen: int = 6,
                             n_layers: int = 2, hidden: int = 1024,
                             num_verts: int = 6890,
                             crop_hw: int = 224) -> float:
    """Total FLOPs of one fused crops->features->scan->verts engine call
    (streaming/engine.py), composed analytically: backbone per crop,
    encoder+IEF+SMPL per window, plus the (sub-percent) VIBE bootstrap
    approximated as one extra window pass per stream with per-frame
    regression."""
    W = frames - seqlen + 1
    if W <= 0:
        raise ValueError(f"frames={frames} < seqlen={seqlen}: no windows "
                         "(a negative W would silently corrupt MFU math)")
    # the engine runs the projection-reuse fast scan, not the naive window
    per_window = (fast_scan_window_flops(seqlen, n_layers, hidden)
                  + regressor_ief_flops() + smpl_flops(num_verts))
    backbone = n_streams * frames * resnet50_flops(crop_hw, crop_hw)
    vibe = n_streams * (gru_flops(seqlen, 2048, hidden, n_layers, False)
                        + seqlen * (regressor_ief_flops()
                                    + smpl_flops(num_verts)))
    return float(backbone + n_streams * W * per_window + vibe)


def train_iter_flops(batch: int, seqlen: int = 6, n_layers: int = 2,
                     hidden: int = 1024, regressor_fwd: float = 0.0,
                     disc_fwd: float = 0.0) -> float:
    """FLOPs of ONE GAN training iteration (train/trainer.window_step):
    the batch's encoder windows (analytic), the train-mode regressor (2
    feature rows per sample) and the 3 discriminator passes
    (gen-adversarial, disc-fake, disc-real) — `regressor_fwd`/`disc_fwd`
    are counted at the call site (`counted_flops`) — all times 3 for the
    combined backward (bwd ~= 2x fwd)."""
    fwd = (batch * encoder_window_flops(seqlen, n_layers, hidden)
           + regressor_fwd + 3 * disc_fwd)
    return 3.0 * fwd


def model_flops_per_frame(seqlen: int = 6, n_layers: int = 2,
                          hidden: int = 1024,
                          num_verts: int = 6890) -> Dict[str, float]:
    """Steady-state streaming cost of ONE output frame on the flagship path
    (each new frame = one crop through the backbone + one window through
    encoder + IEF + SMPL).

    `encoder_window` is the NAIVE standalone window (every frame's input
    projections recomputed); `encoder_window_fast_scan` is what the
    shipped projection-reuse scan actually pays per window
    (streaming/fast_scan.py) — `total` uses the naive figure, i.e. an
    upper bound a standalone-window consumer would pay."""
    parts = {
        "backbone": float(resnet50_flops()),
        "encoder_window": float(
            encoder_window_flops(seqlen, n_layers, hidden)),
        "encoder_window_fast_scan": float(
            fast_scan_window_flops(seqlen, n_layers, hidden)),
        "ief": float(regressor_ief_flops()),
        "smpl": float(smpl_flops(num_verts)),
    }
    parts["total"] = (parts["backbone"] + parts["encoder_window"]
                      + parts["ief"] + parts["smpl"])
    return parts
