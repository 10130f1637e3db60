"""Temporal encoders: TePose dual-GRU and VIBE residual-GRU, eval mode.

Port of `tepose_tpu/models/temporal.py` (`temporal_encoder_apply`,
`vibe_encoder_apply`). Inputs are batch-first (B, T, F) at the module
boundary, as in JAX; the GRUs run sequence-first inside.
"""

from __future__ import annotations

import torch
from torch import nn

from tepose_tpu_torch.models.layers import make_gru, make_linear

INPUT_DIM = 2048 + 85  # features + theta feedback


class TemporalEncoder(nn.Module):
    """`gru_fwd` reads the window forward and emits its last step; the
    bidirectional `gru_rec` reads the time-flipped window and emits its
    first step; each goes through ReLU and a linear to 2048, and eval mode
    averages the two branches."""

    def __init__(self, n_layers: int, hidden_size: int, *,
                 generator: torch.Generator, device: torch.device | str,
                 input_size: int = INPUT_DIM):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.gru_fwd = make_gru(input_size, hidden_size, n_layers,
                                bidirectional=False, **kw)
        self.gru_rec = make_gru(input_size, hidden_size, n_layers,
                                bidirectional=True, **kw)
        self.linear_fwd = make_linear(hidden_size, 2048, **kw)
        self.linear_rec = make_linear(hidden_size * 2, 2048, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, F) -> (B, 2048)."""
        xt = x.transpose(0, 1)                                  # (T, B, F)
        y_fwd_seq, _ = self.gru_fwd(xt)
        y_fwd = self.linear_fwd(torch.relu(y_fwd_seq[-1]))
        y_rec_seq, _ = self.gru_rec(torch.flip(xt, dims=(0,)))
        y_rec = self.linear_rec(torch.relu(y_rec_seq[0]))
        return (y_fwd + y_rec) / 2.0


class VibeEncoder(nn.Module):
    """GRU (+ linear on its ReLU when `add_linear` or bidirectional) with a
    residual to the input when the widths match."""

    def __init__(self, n_layers: int, hidden_size: int, add_linear: bool,
                 bidirectional: bool, use_residual: bool, *,
                 generator: torch.Generator, device: torch.device | str):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.use_residual = use_residual
        self.gru = make_gru(2048, hidden_size, n_layers,
                            bidirectional=bidirectional, **kw)
        if bidirectional:
            self.linear = make_linear(hidden_size * 2, 2048, **kw)
        elif add_linear:
            self.linear = make_linear(hidden_size, 2048, **kw)
        else:
            self.linear = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, 2048) -> (B, T, 2048)."""
        xt = x.transpose(0, 1)
        y, _ = self.gru(xt)
        if self.linear is not None:
            y = self.linear(torch.relu(y))
        if self.use_residual and y.shape[-1] == 2048:
            y = y + xt
        return y.transpose(0, 1)
