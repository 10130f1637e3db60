"""Frame-at-a-time live inference over several concurrent streams.

Port of `tepose_tpu/streaming/live.py` (`LiveSession`, `_vibe_gru_step`).
The carry lives on the device: the VIBE bootstrap GRU's hidden state, the
ring of the last S-1 frames' fast-encoder projections, the theta-feedback
ring and each stream's frame count. One `push` runs one step and returns
that frame's predictions.

Pushing frames 0..T-1 gives, frame for frame, the predictions of the
offline `StreamingEngine` on the whole clip: the VIBE bootstrap is
unidirectional, so its first S-1 outputs are causal, and from frame S-1 on
the engine's window k = t-S+1 holds exactly the frames the rings hold.

With `mesh=` (a `parallel.mesh.Mesh`) the streams split into contiguous
blocks, one a device (`n_streams` must divide over the mesh): each device
holds a replica of the modules and its streams' carry, steps them with no
collectives (streams are independent), and a reset reaches the device that
holds its slot. The JAX session's compile warm-up (`_warm_reset_step`) and
its flat-packed donated state (a remote-link workaround) have no
counterpart.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tepose_tpu_torch.models.backbone import (
    ResNet50, backbone_chunk, to_serving_layout)
from tepose_tpu_torch.models.fast_encoder import (
    fast_encoder_window, project_frame_features)
from tepose_tpu_torch.models.layers import gru_update
from tepose_tpu_torch.models.smpl import SmplModel
from tepose_tpu_torch.models.tepose import TePose, Vibe
from tepose_tpu_torch.parallel.mesh import (
    check_device, replicate, row_blocks, upload)
from tepose_tpu_torch.precision import device_scope
from tepose_tpu_torch.streaming.engine import ENGINE_PRESETS

LIVE_OUTPUTS = ("theta", "verts", "kp_2d", "kp_3d")


def _vibe_gru_step(gru: nn.GRU, h_stack: torch.Tensor,
                   x: torch.Tensor):
    """One timestep of the unidirectional multi-layer VIBE GRU.

    h_stack (n_layers, B, H); x (B, F). Running layer by layer per timestep
    with each layer's hidden state carried equals the stacked GRU over the
    whole sequence. Returns (new h_stack, last layer's output (B, H)).
    """
    hs = []
    y = x
    for layer in range(gru.num_layers):
        h = h_stack[layer]
        y = gru_update(
            F.linear(y, getattr(gru, f"weight_ih_l{layer}"),
                     getattr(gru, f"bias_ih_l{layer}")),
            F.linear(h, getattr(gru, f"weight_hh_l{layer}"),
                     getattr(gru, f"bias_hh_l{layer}")), h)
        hs.append(y)
    return torch.stack(hs), y


class _Shard:
    """One device's modules, its streams' carry and its step."""

    def __init__(self, smpl, tepose, vibe, backbone, n_streams: int,
                 theta_ring0: np.ndarray, outputs):
        self.smpl, self.tepose, self.vibe = smpl, tepose, vibe
        self.backbone = backbone
        self.device = smpl.v_template.device
        self.model_cfg = tepose.cfg
        self.n_streams = n_streams
        self.outputs = outputs
        self._fast = tepose.fast_pack()
        S, B, dev = self.model_cfg.seqlen, n_streams, self.device
        lane_dim = self._fast["layers"][0]["w_feat"].shape[0]   # 3 * 3H
        # `age`, the per-stream frame count, is float32: small integers are
        # exact in it below 2^24 frames (7.7 days at 25 fps)
        self._carry0 = {
            "vibe_h": torch.zeros(vibe.cfg.n_layers, B, vibe.cfg.hidden_size,
                                  device=dev),
            "proj_ring": torch.zeros(B, S - 1, 3, lane_dim // 3, device=dev),
            "theta_ring": torch.from_numpy(theta_ring0).to(dev),
            "age": torch.zeros(B, device=dev),
        }
        self._carry = dict(self._carry0)  # steps make new tensors

    def _core(self, carry: Dict[str, torch.Tensor], x: torch.Tensor,
              reset: Optional[torch.Tensor]):
        """One step: (new carry, packed outputs (B, N) float32)."""
        S, B = self.model_cfg.seqlen, self.n_streams
        if reset is not None:
            # re-seed the chosen streams before the frame, so it is the
            # new tracklet's frame 0
            c0 = self._carry0
            carry = {
                "vibe_h": torch.where(reset[None, :, None], c0["vibe_h"],
                                      carry["vibe_h"]),
                "proj_ring": torch.where(reset[:, None, None, None],
                                         c0["proj_ring"], carry["proj_ring"]),
                "theta_ring": torch.where(reset[:, None, None],
                                          c0["theta_ring"],
                                          carry["theta_ring"]),
                "age": torch.where(reset, c0["age"], carry["age"]),
            }
        feat = backbone_chunk(self.backbone, x) if x.dim() == 4 else x

        # causal VIBE bootstrap step (the output of frames t < S-1)
        enc = self.vibe.encoder
        vibe_h, y = _vibe_gru_step(enc.gru, carry["vibe_h"], feat)
        if enc.linear is not None:
            y = enc.linear(torch.relu(y))
        if enc.use_residual and y.shape[-1] == feat.shape[-1]:
            y = y + feat
        vibe_out = self.vibe.regressor(y, self.smpl)

        # TePose window step (frames t >= S-1)
        proj = project_frame_features(self._fast, feat)         # (B, 3, 3H)
        proj_win = torch.cat([carry["proj_ring"], proj[:, None]], dim=1)
        thetas = torch.cat([carry["theta_ring"],
                            torch.zeros_like(carry["theta_ring"][:, :1])],
                           dim=1)
        win_out = self.tepose.regressor(
            fast_encoder_window(self._fast, proj_win, thetas), self.smpl)

        live = carry["age"] >= S - 1                            # (B,)
        outs = [torch.where(live.reshape((B,) + (1,) * (win_out[k].dim() - 1)),
                            win_out[k], vibe_out[k]).reshape(B, -1)
                for k in self.outputs]
        # the theta ring advances only once the stream is live: before that
        # the offline scan has not started and the ring holds the
        # pseudo-thetas
        theta_ring = torch.where(
            live[:, None, None],
            torch.cat([carry["theta_ring"][:, 1:],
                       win_out["theta"][:, None]], dim=1),
            carry["theta_ring"])
        new_carry = {
            "vibe_h": vibe_h,
            "proj_ring": torch.cat([carry["proj_ring"][:, 1:],
                                    proj[:, None]], dim=1),
            "theta_ring": theta_ring,
            "age": carry["age"] + 1.0,
        }
        packed = torch.cat([o.float() for o in outs]
                           + [live.float()[:, None]], dim=1)
        return new_carry, packed

    def step(self, x: np.ndarray, reset: Optional[np.ndarray]):
        """Queue one step of this shard's streams; returns the packed
        outputs on the device."""
        xd = upload(x, self.device)
        r = (upload(np.asarray(reset, bool), self.device)
             if reset is not None and np.any(reset) else None)
        with device_scope():
            self._carry, packed = self._core(self._carry, xd, r)
        return packed

    def restart(self) -> None:
        self._carry = dict(self._carry0)


class LiveSession:
    """Frame-at-a-time streaming over `n_streams` concurrent tracklets.

    `push` takes one frame per stream, as features (B, 2048) or, with a
    `backbone`, crops (B, 3, H, W) uint8 (raw) or float32 (normalised), and
    returns {"valid": (B,) bool, **outputs} as numpy arrays. `valid` is
    False while that stream's theta window is filling: frames 0..S-2 get
    the causal VIBE bootstrap predictions, as the offline engine's first
    frames do.

    Streams are independent slots: `push(..., reset=mask)` re-seeds the
    masked slots before the frame, so a slot can take a new person
    mid-session. Each push makes one device->host copy per device, a
    single float32 tensor holding every requested output and the live mask
    of its streams.
    """

    def __init__(self, smpl: SmplModel, tepose: TePose, vibe: Vibe,
                 n_streams: int = 1, backbone: Optional[ResNet50] = None,
                 outputs: Sequence[str] = ("theta", "kp_3d"),
                 theta_pseu: Optional[np.ndarray] = None, mesh=None,
                 backbone_dtype: Optional[torch.dtype] = None, preset=None):
        # for the live path the serving presets mean the bf16 backbone:
        # outputs already default to joints, and the one packed readback
        # costs a sync, not bytes
        if preset not in (None,) + ENGINE_PRESETS:
            raise ValueError(
                f"unknown preset {preset!r}; choose from {ENGINE_PRESETS}")
        if preset in ("serving", "serving-joints") and backbone_dtype is None:
            backbone_dtype = torch.bfloat16
        if not outputs:
            raise ValueError("outputs must be non-empty")
        bad = set(outputs) - set(LIVE_OUTPUTS)
        if bad:
            raise ValueError(f"unknown outputs {sorted(bad)}; "
                             f"choose from {LIVE_OUTPUTS}")
        if mesh is not None and n_streams % mesh.size:
            raise ValueError(f"n_streams={n_streams} must divide the "
                             f"{mesh.size}-device mesh")
        if vibe.cfg.bidirectional:
            raise ValueError("live mode needs a causal (unidirectional) "
                             "VIBE bootstrap")
        self.device = smpl.v_template.device
        check_device(self.device, tepose=tepose, vibe=vibe,
                     backbone=backbone)
        self.smpl, self.tepose, self.vibe = smpl, tepose, vibe
        self.model_cfg, self.vibe_cfg = tepose.cfg, vibe.cfg
        self.n_streams = n_streams
        self.outputs = tuple(outputs)
        self.backbone = (None if backbone is None
                         else to_serving_layout(backbone, backbone_dtype))

        S, B = self.model_cfg.seqlen, n_streams
        if theta_pseu is None:
            theta_ring0 = np.zeros((B, S - 1, 85), np.float32)
            theta_ring0[:, :, 0] = 1.0  # identity cam, the engine's default
        else:
            theta_ring0 = np.broadcast_to(
                np.asarray(theta_pseu, np.float32), (B, S - 1, 85)).copy()
        modules = (smpl, tepose, vibe, self.backbone)
        if mesh is None:
            self._blocks = [slice(0, B)]
            reps = [modules]
        else:
            self._blocks = row_blocks(B, mesh)
            reps = replicate(modules, mesh)
        self._shards = [_Shard(*m, rows.stop - rows.start, theta_ring0[rows],
                               self.outputs)
                        for m, rows in zip(reps, self._blocks)]

    def _step(self, x: np.ndarray, reset: Optional[np.ndarray]):
        """Queue every device's step before the first readback; returns
        the packed outputs, one tensor a device."""
        return [sh.step(x[rows], None if reset is None
                        else np.asarray(reset)[rows])
                for sh, rows in zip(self._shards, self._blocks)]

    def push(self, x: np.ndarray,
             reset: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Feed one frame per stream; returns this frame's predictions.

        x: (B, 2048) features, or (B, 3, H, W) crops when the session has a
        backbone. reset: optional (B,) bool, the streams to re-seed to a
        fresh session before this frame (a new person took the slot).

        If the step raises (KeyboardInterrupt, a device error), every
        stream is re-seeded to a fresh session and the exception
        propagates; the session stays usable.
        """
        x = np.asarray(x)
        if x.shape[0] != self.n_streams:
            raise ValueError(f"expected {self.n_streams} streams, "
                             f"got {x.shape[0]}")
        if x.ndim == 4 and self.backbone is None:
            raise ValueError("crops need a session built with a backbone; "
                             "push (B, 2048) features otherwise")
        try:
            parts = [p.cpu().numpy() for p in self._step(x, reset)]
            host = parts[0] if len(parts) == 1 else np.concatenate(parts)
        except BaseException:
            for sh in self._shards:
                sh.restart()
            raise
        res, ofs = {}, 0
        for k in self.outputs:
            n = int(np.prod(self._shape(k)))
            res[k] = host[:, ofs:ofs + n].reshape(
                (self.n_streams,) + self._shape(k))
            ofs += n
        res["valid"] = host[:, ofs] > 0.5
        return res

    def _shape(self, key: str) -> tuple:
        """Per-stream shape of an output."""
        K = len(self.smpl.joint_map)
        return {"theta": (85,), "verts": (self.smpl.num_verts, 3),
                "kp_2d": (K, 2), "kp_3d": (K, 3)}[key]
