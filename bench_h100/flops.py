"""Operations and bytes of the work a cell does, and the H100's peaks.

The FLOP formulas are copies of `tepose_tpu_torch/utils/flops.py`
(`resnet50_flops`, `gru_flops`, `fast_scan_window_flops`,
`regressor_ief_flops`, `smpl_flops`), which hold within 6 % of what
`torch.utils.flop_counter` counts on the program's modules; the skinning
kernel's operations and bytes are those of `tools/kernel_timing.py`'s
`lbs_bound`. One multiply-add counts as 2 FLOPs.

Every share is taken against the H100 SXM's published dense TF32 rate,
494.5 TFLOP/s, and its 3.35 TB/s of HBM3 (NVIDIA's data sheet), not the
67 TFLOP/s of its CUDA cores: a later kernel that keeps float32 accuracy on
the tensor cores must still read under 100 %.
"""

from __future__ import annotations

PEAK_FLOPS = 494.5e12
PEAK_BYTES_PER_S = 3.35e12
NPOSE = 24 * 6


def conv2d_flops(h_out, w_out, c_in, c_out, kh, kw) -> int:
    return 2 * h_out * w_out * c_in * c_out * kh * kw


def resnet50_flops(h: int = 224, w: int = 224) -> int:
    """One crop through the ResNet-50 feature extractor (folded BN)."""
    total = conv2d_flops(h // 2, w // 2, 3, 64, 7, 7)
    hh, ww = h // 4, w // 4
    c_in = 64
    for mid, c_out, blocks, stride in ((64, 256, 3, 1), (128, 512, 4, 2),
                                       (256, 1024, 6, 2), (512, 2048, 3, 2)):
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            ho, wo = hh // s, ww // s
            total += conv2d_flops(hh, ww, c_in, mid, 1, 1)
            total += conv2d_flops(ho, wo, mid, mid, 3, 3)
            total += conv2d_flops(ho, wo, mid, c_out, 1, 1)
            if bi == 0:
                total += conv2d_flops(ho, wo, c_in, c_out, 1, 1)
            hh, ww, c_in = ho, wo, c_out
    return total


def gru_flops(T: int, input_size: int, hidden: int, n_layers: int,
              bidirectional: bool) -> int:
    """T steps of a stacked GRU: input and hidden projections of the 3
    gates, per direction and layer."""
    dirs = 2 if bidirectional else 1
    total = 0
    for layer in range(n_layers):
        in_l = input_size if layer == 0 else hidden * dirs
        total += dirs * T * (2 * in_l * 3 * hidden + 2 * hidden * 3 * hidden)
    return total


def fast_scan_window_flops(seqlen: int = 6, n_layers: int = 2,
                           hidden: int = 1024) -> int:
    """One TePose window when each frame's feature projection is made once
    and reused by the S windows that hold it: the least work a window
    needs."""
    H3 = 3 * hidden
    total = 3 * 2 * 2048 * H3
    total += seqlen * 3 * 2 * 85 * H3
    total += seqlen * 3 * 2 * hidden * H3
    for li in range(1, n_layers):
        last = li == n_layers - 1
        lanes = 2 if last else 3
        total += seqlen * lanes * 2 * (2 * hidden) * H3
        total += seqlen * lanes * 2 * hidden * H3
        if last:
            total += 2 * (2 * hidden) * H3 + 2 * hidden * H3
    total += 2 * hidden * 2048 + 2 * (2 * hidden) * 2048
    return total


def regressor_ief_flops(n_iter: int = 3) -> int:
    """The IEF head: fc1, fc2 and the three decoders, `n_iter` times."""
    return n_iter * (2 * (2048 + NPOSE + 13) * 1024 + 2 * 1024 * 1024
                     + 2 * 1024 * (NPOSE + 10 + 3))


def smpl_flops(num_verts: int = 6890, num_joints: int = 24,
               num_kp: int = 49) -> int:
    """One SMPL forward: blend shapes, joints, chain, skinning, keypoints."""
    V, J, K = num_verts, num_joints, num_kp
    return (2 * V * 3 * 10 + 2 * V * 3 * 207 + 2 * J * V * 3 + J * (9 * 6 + 50)
            + 2 * V * J * 16 + V * 3 * 9 + 2 * K * V * 3)


def vibe_frames_flops(frames: int, hidden: int = 1024, n_layers: int = 2,
                      num_verts: int = 6890) -> int:
    """VIBE over `frames` frames of one sequence: its GRU, the linear back
    to 2048, and the regressor and SMPL on every frame."""
    return (gru_flops(frames, 2048, hidden, n_layers, False)
            + frames * (2 * hidden * 2048 + regressor_ief_flops()
                        + smpl_flops(num_verts)))


def tepose_frames_flops(windows: int, seqlen: int = 6, n_layers: int = 2,
                        hidden: int = 1024, num_verts: int = 6890) -> int:
    """`windows` TePose windows with their regressor and SMPL."""
    return windows * (fast_scan_window_flops(seqlen, n_layers, hidden)
                      + regressor_ief_flops() + smpl_flops(num_verts))


def lbs_bound_s(B: int, V: int = 6890, J: int = 24) -> float:
    """Least time of one skinning launch of B samples: 24 J + 18 FLOPs a
    sample and vertex, against v_posed, the output, the weights and the
    transforms moved once."""
    flops = (24 * J + 18) * B * V
    nbytes = 4 * (2 * B * V * 3 + J * V + B * J * 16)
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)
