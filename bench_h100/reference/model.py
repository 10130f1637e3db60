"""The forward passes of ResNet-50, VIBE, TePose and SMPL in plain PyTorch.

Written from the published models (SPIN's ResNet-50 with its BatchNorm
folded into each convolution, VIBE's residual GRU, TePose's dual-GRU window
encoder, SPIN's 3-step IEF regressor, SMPL with linear blend skinning), in
float32 and step by step: every GRU step is its own matrix products, the
skinning is one einsum. Weights are dicts of tensors under the torch names
of the published models (`encoder.gru_fwd.weight_ih_l0`, `stem.w`, ...).

`Reference(tf32=True)` is the control: on a CUDA device it lets cuBLAS and
cuDNN compute in TF32; on the CPU, which has no TF32, it rounds the operands
of every matrix product and convolution to TF32's 10 mantissa bits, which is
what the tensor cores do to them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from bench_h100.reference import tables as T

Weights = Dict[str, torch.Tensor]
N_ITER = 3


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


class Reference:
    """The reference computations at one precision: float32 (TF32 off), or
    TF32 for the control."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    @contextlib.contextmanager
    def scope(self):
        """TF32 flags as this reference wants them, restored on exit."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            with torch.no_grad():
                yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    # ------------------------------------------------------------ products

    def _ops(self, *xs):
        """Operands of one product; rounded to TF32 for the control on the
        CPU (on a card the flags make the library round them)."""
        if self.tf32 and xs[0].device.type == "cpu":
            return tuple(round_tf32(x) for x in xs)
        return xs

    def linear(self, x, w, b=None):
        x, w = self._ops(x, w)
        return F.linear(x, w, b)

    def einsum(self, eq, *xs):
        return torch.einsum(eq, *self._ops(*xs))

    def conv(self, x, w, b, stride, pad):
        x, w = self._ops(x, w)
        return F.conv2d(x, w, b, stride, pad)

    # ------------------------------------------------------------ ResNet-50

    @staticmethod
    def normalize(crops: torch.Tensor) -> torch.Tensor:
        """uint8 (N, 3, H, W) -> ImageNet-normalised float32."""
        x = crops.float() / 255.0
        mean = torch.tensor(T.IMAGENET_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(T.IMAGENET_STD, device=x.device)[:, None, None]
        return (x - mean) / std

    def resnet50(self, w: Weights, x: torch.Tensor) -> torch.Tensor:
        """Normalised crops (N, 3, 224, 224) -> features (N, 2048): the stem
        (7x7/2 and a 3x3/2 max pool), 3, 4, 6 and 3 bottlenecks with the
        stride on the 3x3, a projection on each stage's first block, the
        global mean."""
        out = F.relu(self.conv(x, w["stem.w"], w["stem.b"], 2, 3))
        out = F.max_pool2d(out, 3, 2, 1)
        for li, blocks in enumerate((3, 4, 6, 3), start=1):
            for bi in range(blocks):
                p = f"layer{li}.{bi}."
                stride = 2 if li > 1 and bi == 0 else 1
                y = F.relu(self.conv(out, w[p + "conv1.w"], w[p + "conv1.b"],
                                     1, 0))
                y = F.relu(self.conv(y, w[p + "conv2.w"], w[p + "conv2.b"],
                                     stride, 1))
                y = self.conv(y, w[p + "conv3.w"], w[p + "conv3.b"], 1, 0)
                short = (self.conv(out, w[p + "downsample.w"],
                                   w[p + "downsample.b"], stride, 0)
                         if bi == 0 else out)
                out = F.relu(y + short)
        return out.mean(dim=(2, 3))

    # ------------------------------------------------------------ GRUs

    def gru_layer(self, w: Weights, prefix: str, layer: int, x: torch.Tensor,
                  reverse: bool = False) -> torch.Tensor:
        """One GRU layer and direction over x (T, B, F) from a zero state,
        gates r, z, n; outputs (T, B, H) in x's time order."""
        sfx = f"_l{layer}" + ("_reverse" if reverse else "")
        w_hh, b_hh = w[f"{prefix}.weight_hh{sfx}"], w[f"{prefix}.bias_hh{sfx}"]
        xp = self.linear(x, w[f"{prefix}.weight_ih{sfx}"],
                         w[f"{prefix}.bias_ih{sfx}"])
        h = x.new_zeros(x.shape[1], w_hh.shape[1])
        out = [None] * x.shape[0]
        for t in (reversed(range(x.shape[0])) if reverse
                  else range(x.shape[0])):
            hp = self.linear(h, w_hh, b_hh)
            xr, xz, xn = xp[t].chunk(3, dim=-1)
            hr, hz, hn = hp.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            out[t] = h
        return torch.stack(out)

    def gru(self, w: Weights, prefix: str, x: torch.Tensor, layers: int,
            bidirectional: bool) -> torch.Tensor:
        """A stacked GRU over x (T, B, F); each layer reads the previous
        one's outputs, both directions side by side."""
        for layer in range(layers):
            x = torch.cat([self.gru_layer(w, prefix, layer, x, reverse)
                           for reverse in ((False, True) if bidirectional
                                           else (False,))], dim=-1)
        return x

    # ------------------------------------------------------------ encoders

    def vibe_encoder(self, w: Weights, feats: torch.Tensor) -> torch.Tensor:
        """VIBE's temporal encoder: a 2-layer unidirectional GRU over
        (B, T, 2048), a linear on its ReLU, the input added back."""
        x = feats.transpose(0, 1)
        y = self.gru(w, "encoder.gru", x, 2, False)
        y = self.linear(F.relu(y), w["encoder.linear.weight"],
                        w["encoder.linear.bias"]) + x
        return y.transpose(0, 1)

    def tepose_encoder(self, w: Weights, x: torch.Tensor) -> torch.Tensor:
        """TePose's window encoder on windows x (N, S, 2133): the forward
        GRU's last step and the bidirectional GRU's first step over the
        reversed window, each through ReLU and a linear, averaged."""
        xt = x.transpose(0, 1)
        y_fwd = self.gru(w, "encoder.gru_fwd", xt, 2, False)[-1]
        y_rec = self.gru(w, "encoder.gru_rec", torch.flip(xt, dims=(0,)), 2,
                         True)[0]
        y_fwd = self.linear(F.relu(y_fwd), w["encoder.linear_fwd.weight"],
                            w["encoder.linear_fwd.bias"])
        y_rec = self.linear(F.relu(y_rec), w["encoder.linear_rec.weight"],
                            w["encoder.linear_rec.bias"])
        return (y_fwd + y_rec) / 2.0

    # ------------------------------------------------------------ regressor

    def regressor(self, w: Weights, smpl: Weights, x: torch.Tensor,
                  j_regressor: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
        """SPIN's IEF head on features (N, 2048): three steps from the
        initial pose, shape and camera, rot6d to rotation matrices, SMPL.
        Returns rotmat (N, 24, 3, 3), cam (N, 3), shape (N, 10), verts
        (N, V, 3) and kp_3d (N, 49, 3), or (N, 14, 3) through the H36M
        `j_regressor` (17, V)."""
        N = x.shape[0]
        pose = w["regressor.init_pose"].expand(N, -1)
        shape = w["regressor.init_shape"].expand(N, -1)
        cam = w["regressor.init_cam"].expand(N, -1)
        for _ in range(N_ITER):
            xc = torch.cat([x, pose, shape, cam], dim=1)
            xc = self.linear(xc, w["regressor.fc1.weight"],
                             w["regressor.fc1.bias"])
            xc = self.linear(xc, w["regressor.fc2.weight"],
                             w["regressor.fc2.bias"])
            pose = self.linear(xc, w["regressor.decpose.weight"],
                               w["regressor.decpose.bias"]) + pose
            shape = self.linear(xc, w["regressor.decshape.weight"],
                                w["regressor.decshape.bias"]) + shape
            cam = self.linear(xc, w["regressor.deccam.weight"],
                              w["regressor.deccam.bias"]) + cam
        rotmat = rot6d_to_rotmat(pose.reshape(N, 24, 6))
        out = self.smpl(smpl, shape, rotmat)
        kp_3d = out["joints49"]
        if j_regressor is not None:
            kp_3d = self.einsum("jv,bvk->bjk", j_regressor,
                                out["verts"])[:, list(T.H36M_TO_J14)]
        return {"rotmat": rotmat, "cam": cam, "shape": shape,
                "verts": out["verts"], "kp_3d": kp_3d}

    # ------------------------------------------------------------ SMPL

    def smpl(self, s: Weights, betas: torch.Tensor,
             rotmat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """SMPL: shape and pose blend shapes, rest joints, the kinematic
        chain, linear blend skinning, the 49 output joints. betas (B, 10),
        rotmat (B, 24, 3, 3)."""
        B = betas.shape[0]
        v_shaped = s["v_template"] + self.einsum("bl,vkl->bvk", betas,
                                                 s["shapedirs"])
        j_rest = self.einsum("jv,bvk->bjk", s["j_regressor"], v_shaped)
        eye = torch.eye(3, device=betas.device)
        pose_feature = (rotmat[:, 1:] - eye).reshape(B, -1)
        v_posed = v_shaped + self.einsum(
            "bp,pq->bq", pose_feature, s["posedirs"]).reshape(B, -1, 3)

        # world transforms G of the joints, parent first
        G = [None] * T.NUM_JOINTS
        for j, parent in enumerate(T.PARENTS):
            t = j_rest[:, j] - (j_rest[:, parent] if parent >= 0 else 0.0)
            local = torch.zeros(B, 4, 4, device=betas.device)
            local[:, :3, :3] = rotmat[:, j]
            local[:, :3, 3] = t
            local[:, 3, 3] = 1.0
            G[j] = local if parent < 0 else self.einsum(
                "bik,bkl->bil", G[parent], local)
        G = torch.stack(G, dim=1)                           # (B, 24, 4, 4)
        posed_joints = G[:, :, :3, 3]
        # the transform of rest-pose points: translation less R j_rest
        A = G[:, :, :3, :].clone()
        A[..., 3] = A[..., 3] - self.einsum("bjik,bjk->bji", G[:, :, :3, :3],
                                            j_rest)
        blended = self.einsum("vj,bjik->bvik", s["lbs_weights"], A)
        verts = (self.einsum("bvik,bvk->bvi", blended[..., :3], v_posed)
                 + blended[..., 3])
        extra = self.einsum("jv,bvk->bjk", s["j_regressor_extra"], verts)
        joints54 = torch.cat(
            [posed_joints, verts[:, list(T.VERTEX_JOINT_IDS)], extra], dim=1)
        return {"verts": verts, "joints49": joints54[:, list(T.JOINT_MAP)]}


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6-vectors (..., 6) read as (3, 2) column pairs -> rotations whose
    columns are their Gram-Schmidt basis."""
    x = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = x[..., 0], x[..., 1]
    b1 = F.normalize(a1, dim=-1, eps=1e-6)
    b2 = F.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1,
                     eps=1e-6)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    theta = torch.linalg.norm(aa, dim=-1, keepdim=True)
    k = aa / theta.clamp(min=1e-12)
    kx, ky, kz = k.unbind(-1)
    zero = torch.zeros_like(kx)
    K = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero],
                    dim=-1).reshape(aa.shape[:-1] + (3, 3))
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + s * K + (1.0 - c) * (K @ K)
