"""Pieces the drivers share."""

from __future__ import annotations

import numpy as np
import torch

from bench_h100 import weights as W


class Reservoir:
    """Keeps one of the units offered so far, each with the same chance,
    drawn from the run's seed: the unit whose outputs are compared."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(W.sub_seed(seed, "reservoir"))
        self.seen = 0
        self.kept = None

    def offer(self, make):
        """`make()` builds what to keep; it is called only when kept."""
        self.seen += 1
        if self.rng.integers(self.seen) == 0:
            self.kept = make()


def uint8_crops(seed: int, stream: str, n: int, size: int,
                device) -> np.ndarray:
    """n random uint8 crops (n, 3, size, size), drawn on the device, on the
    host."""
    g = W.generator(seed, stream, device)
    return torch.randint(0, 256, (n, 3, size, size), generator=g,
                         device=device, dtype=torch.uint8).cpu().numpy()


def pick(seed: int, stream: str, n: int, k: int, first: int) -> list:
    """`first` and k - 1 other indices of range(n), drawn from the seed."""
    rng = np.random.default_rng(W.sub_seed(seed, stream))
    others = [i for i in range(n) if i != first]
    return [first] + sorted(rng.choice(others, size=min(k - 1, len(others)),
                                       replace=False).tolist())


def ring0(S: int, device) -> torch.Tensor:
    """The initial fed-back thetas: identity camera, zero pose and shape."""
    r = torch.zeros(S - 1, 85, device=device)
    r[:, 0] = 1.0
    return r

