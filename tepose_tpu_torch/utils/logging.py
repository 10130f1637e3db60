"""Logging and metric sinks of the training loop.

Copies of `tepose_tpu/utils/logging.py` (`create_logger`,
`prepare_output_dir`, `MetricWriter`, `AverageMeter`; importing that module
would import JAX through the `tepose_tpu` package), pinned equal to them by
tests/test_torch_train_loop.py. The port trains in one process, so the
copies drop the multi-process primary gate: this process writes every file.

Scalars go to the python logger, to a JSONL metrics file (always) and to
tensorboard when torch's SummaryWriter imports.
"""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
import time
from typing import Dict, Optional


def create_logger(logdir: str, phase: str = "train") -> logging.Logger:
    logger = logging.getLogger()
    if logger.handlers:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()  # else old FileHandler fds leak across re-inits
    os.makedirs(logdir, exist_ok=True)
    handlers = [logging.FileHandler(osp.join(logdir, f"{phase}_log.txt")),
                logging.StreamHandler()]
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        handlers=handlers)
    return logger


def prepare_output_dir(cfg, cfg_file: Optional[str] = None) -> str:
    """Timestamped experiment dir + config snapshot."""
    logtime = time.strftime("%d-%m-%Y_%H-%M-%S")
    logdir = osp.join(cfg.OUTPUT_DIR, f"{logtime}_{cfg.EXP_NAME}")
    cfg.LOGDIR = logdir
    os.makedirs(logdir, exist_ok=True)
    with open(osp.join(logdir, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    return logdir


class MetricWriter:
    """Scalar sink: JSONL always; tensorboard when available."""

    def __init__(self, logdir: str):
        self._f = None
        self._tb = None
        os.makedirs(logdir, exist_ok=True)
        self._f = open(osp.join(logdir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=logdir)
        except Exception:
            pass

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(global_step),
             "time": time.time()}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step)

    def add_scalars(self, metrics: Dict[str, float], step: int,
                    prefix: str = "") -> None:
        for k, v in metrics.items():
            self.add_scalar(f"{prefix}{k}", v, step)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()


class AverageMeter:
    def __init__(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
