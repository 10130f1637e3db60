"""The lane-batched TePose encoder with feature-projection reuse, eval and
train outputs.

Port of `tepose_tpu/models/fast_encoder.py` (`pack_fast_encoder`,
`project_frame_features`, `fast_encoder_window`). It computes what
`TemporalEncoder` computes, restructured for the sliding-window scan:

1. Feature-projection reuse. A window frame is [feat (2048) | theta (85)],
   and consecutive windows share S-1 of their S frames. The layer-0 input
   weights split into W_feat and W_theta, so each frame's feature projection
   is computed once (`project_frame_features`) and every window adds only
   its 85 -> 3H theta projection.
2. Lane batching. Each layer runs three independent recurrences ("lanes":
   0 = gru_fwd, 1 = gru_rec forward direction, 2 = gru_rec backward
   direction), which advance together as one batched matmul per step.
3. Tail truncation. The last layer's lane 1 contributes only its output at
   position 0, which is one GRU step; its other S-1 steps are skipped.

The rec lanes read the time-flipped window. Lane 2, the backward direction
over the flipped window, is computed as a forward scan over the original
order, so its output at flipped position tau is step S-1-tau of that scan.

The pack is a snapshot: `pack_fast_encoder` stacks copies of the encoder's
weights once, where the JAX code re-packs inside every traced call. A later
`load_state_dict`, `.to()` or optimizer step on the encoder does not reach
an existing pack; pack again after any of them. Training packs inside
autograd on every forward (`stack_fast_encoder`), so gradients flow back to
the encoder's own parameters.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from tepose_tpu_torch.models.layers import gru_update
from tepose_tpu_torch.models.temporal import TemporalEncoder

FEAT_DIM = 2048
THETA_DIM = 85


def _cell_batched(xp: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor,
                  b_hh: torch.Tensor) -> torch.Tensor:
    """GRU step for stacked lanes: xp (L, B, 3H), h (L, B, H), w_hh
    (L, 3H, H), b_hh (L, 3H)."""
    h_proj = torch.baddbmm(b_hh[:, None, :], h, w_hh.transpose(1, 2))
    return gru_update(xp, h_proj, h)


@torch.no_grad()
def pack_fast_encoder(encoder: TemporalEncoder) -> Dict:
    """Lane-stacked copies of a `TemporalEncoder`'s weights, outside
    autograd: the eval and serving snapshot (`stack_fast_encoder`)."""
    return stack_fast_encoder(encoder)


def stack_fast_encoder(encoder: TemporalEncoder) -> Dict:
    """Lane-stacked copies of a `TemporalEncoder`'s weights; differentiable
    when grad is on.

    Layer 0: w_feat (3, 3H, 2048) and w_theta (3, 3H, 85), the split of the
    stacked W_ih, as flat (9H, F) matrices for one GEMM each; later layers:
    w_ih_fwd (3H, H) for lane 0 and w_ih_rec (2, 3H, 2H) for lanes 1, 2.
    Every layer: b_ih, w_hh and b_hh stacked over the three lanes; the last
    layer also keeps w_hh / b_hh of lanes 0 and 2, the two it batches.
    """
    fwd, rec = encoder.gru_fwd, encoder.gru_rec
    n_layers = fwd.num_layers

    def stack(name, layer):
        return torch.stack([getattr(fwd, f"{name}_l{layer}"),
                            getattr(rec, f"{name}_l{layer}"),
                            getattr(rec, f"{name}_l{layer}_reverse")])

    layers = []
    for layer in range(n_layers):
        entry = {k: stack(name, layer) for k, name in (
            ("b_ih", "bias_ih"), ("w_hh", "weight_hh"), ("b_hh", "bias_hh"))}
        if layer == 0:
            w_ih = stack("weight_ih", 0)                    # (3, 3H, 2133)
            entry["w_feat"] = w_ih[..., :FEAT_DIM].reshape(-1, FEAT_DIM)
            entry["w_theta"] = w_ih[..., FEAT_DIM:].reshape(-1, THETA_DIM)
        else:
            entry["w_ih_fwd"] = getattr(fwd, f"weight_ih_l{layer}").clone()
            entry["w_ih_rec"] = torch.stack(
                [getattr(rec, f"weight_ih_l{layer}"),
                 getattr(rec, f"weight_ih_l{layer}_reverse")])
        if layer == n_layers - 1:
            entry["w_hh_02"] = entry["w_hh"][0::2].clone()
            entry["b_hh_02"] = entry["b_hh"][0::2].clone()
        layers.append(entry)
    return {
        "layers": layers,
        "hidden": fwd.hidden_size,
        "linear_fwd": (encoder.linear_fwd.weight.clone(),
                       encoder.linear_fwd.bias.clone()),
        "linear_rec": (encoder.linear_rec.weight.clone(),
                       encoder.linear_rec.bias.clone()),
        "lane_steps": {},
    }


def project_frame_features(fast: Dict, feats: torch.Tensor) -> torch.Tensor:
    """Per-frame layer-0 feature projections of all three lanes:
    feats (..., 2048) -> (..., 3, 3H). Computed once per frame and reused
    by every window that holds the frame."""
    return F.linear(feats, fast["layers"][0]["w_feat"]).unflatten(
        -1, (3, -1))


def _lane_steps(fast: Dict, S: int, device: torch.device):
    """Index tensors of the per-step lane gather: lane 0 and lane 2 read
    frame t at step t, lane 1 reads frame S-1-t. Made on the device once per
    window length, so a window uploads nothing."""
    key = (S, device)
    if key not in fast["lane_steps"]:
        t = torch.arange(S, device=device)
        fast["lane_steps"][key] = (torch.stack([t, S - 1 - t, t], dim=1),
                                   torch.arange(3, device=device))
    return fast["lane_steps"][key]


def _scan(xs: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
          keep_all: bool) -> torch.Tensor:
    """Run stacked lanes over xs (S, L, B, 3H) from a zero state: all
    states (S, L, B, H) with `keep_all`, else the final one (L, B, H)."""
    h = xs.new_zeros(xs.shape[1:-1] + (w_hh.shape[-1],))
    states = []
    for t in range(xs.shape[0]):
        h = _cell_batched(xs[t], h, w_hh, b_hh)
        states.append(h)
    return torch.stack(states) if keep_all else h


def fast_encoder_window(fast: Dict, feat_proj_win: torch.Tensor,
                        thetas: torch.Tensor,
                        train: bool = False) -> torch.Tensor:
    """Encode one window from its frames' feature projections.

    feat_proj_win (B, S, 3, 3H); thetas (B, S, 85), the theta-feedback part
    of each frame (zeros on the last frame, as in the plain input). Returns
    eval (B, 2048) or train (B, 2, 2048) = [fwd, rec] branches, as
    `TemporalEncoder` and JAX `temporal_encoder_apply` do.
    """
    S = thetas.shape[1]
    H = fast["hidden"]
    l0 = fast["layers"][0]

    # layer-0 inputs of all lanes: reused feature part + theta part + bias
    theta_proj = F.linear(thetas, l0["w_theta"], l0["b_ih"].reshape(-1))
    xp = feat_proj_win + theta_proj.unflatten(-1, (3, -1))
    steps, lanes = _lane_steps(fast, S, xp.device)
    xs = xp.permute(1, 2, 0, 3)[steps, lanes]                 # (S, 3, B, 3H)
    ys = _scan(xs, l0["w_hh"], l0["b_hh"], keep_all=True)    # (S, 3, B, H)
    fwd_seq, recf_seq, recb_scan = ys[:, 0], ys[:, 1], ys[:, 2]

    n_layers = len(fast["layers"])
    if n_layers == 1:
        y_fwd = fwd_seq[-1]
        y_rec0 = torch.cat([recf_seq[0], recb_scan[-1]], dim=-1)
    for li in range(1, n_layers):
        l = fast["layers"][li]
        # rec-lane input at flipped position tau:
        #   z[tau] = [recf_seq[tau], recb_scan[S-1-tau]]
        z = torch.cat([recf_seq, torch.flip(recb_scan, (0,))], dim=-1)
        z_rev = torch.cat([torch.flip(recf_seq, (0,)), recb_scan], dim=-1)
        x_fwd = F.linear(fwd_seq, l["w_ih_fwd"], l["b_ih"][0])  # (S, B, 3H)
        x_recb = F.linear(z_rev, l["w_ih_rec"][1], l["b_ih"][2])
        if li == n_layers - 1:
            # lanes 0 and 2 run the whole window; lane 1 takes one step on
            # z[0] from the zero state, whose h-projection is just b_hh
            h_fin = _scan(torch.stack([x_fwd, x_recb], dim=1), l["w_hh_02"],
                          l["b_hh_02"], keep_all=False)
            xf = F.linear(z[0], l["w_ih_rec"][0], l["b_ih"][1])
            recf_out0 = gru_update(xf, l["b_hh"][1].expand_as(xf),
                                   xf.new_zeros(xf.shape[:-1] + (H,)))
            y_fwd = h_fin[0]
            y_rec0 = torch.cat([recf_out0, h_fin[1]], dim=-1)
        else:
            x_recf = F.linear(z, l["w_ih_rec"][0], l["b_ih"][1])
            ys = _scan(torch.stack([x_fwd, x_recf, x_recb], dim=1),
                       l["w_hh"], l["b_hh"], keep_all=True)
            fwd_seq, recf_seq, recb_scan = ys[:, 0], ys[:, 1], ys[:, 2]

    y_fwd_out = F.linear(torch.relu(y_fwd), *fast["linear_fwd"])
    y_rec_out = F.linear(torch.relu(y_rec0), *fast["linear_rec"])
    if not train:
        return (y_fwd_out + y_rec_out) / 2.0
    return torch.stack([y_fwd_out, y_rec_out], dim=1)
