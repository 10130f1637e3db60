"""Validation-only engine (stage-2 model testing).

Copy of `tepose_tpu/eval/tester.py::Tester` (ref: lib/core/tester.py:40-336,
a validation-only clone of the reference's Trainer that it never imports),
a thin wrapper over the port's `train.validate.validate_epoch`. It takes a
`TePose` module where the JAX class takes `gen_params` and a model config.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from tepose_tpu_torch.models.smpl import SmplModel
from tepose_tpu_torch.models.tepose import TePose


class Tester:
    """Run trainer-style validation for a pretrained generator."""

    def __init__(self, *, cfg, gen: TePose, smpl: SmplModel, valid_loader,
                 j_regressor: np.ndarray):
        self.cfg = cfg
        self.gen = gen
        self.smpl = smpl
        self.valid_loader = valid_loader
        self.j_regressor = j_regressor

    def test(self) -> Dict[str, float]:
        """ref: tester.py:202 (.test()) -> the trainer-eval metric dict."""
        from tepose_tpu_torch.train.validate import validate_epoch

        it = iter(self.valid_loader)
        n = len(self.valid_loader)
        return validate_epoch(self.gen, self.smpl,
                              (next(it) for _ in range(n)),
                              self.j_regressor, self.gen.cfg.seqlen)
