"""SMPL kinematic-tree graph and multi-scale adjacency builders (numpy).

A copy of `tepose_tpu/models/graph.py` (importing that module would import
JAX through the `tepose_tpu` package), pinned equal to it by
tests/test_torch_gcn.py. The matrices become constant buffers of the
motion discriminator (`models.gcn`).
"""

from __future__ import annotations

import numpy as np

NUM_NODES = 24

# Child->parent bone list of the SMPL pose graph, 1-indexed in the reference
# (ref: lib/graph/smplx_theta.py:11-14); stored 0-indexed here.
_INWARD_1IDX = [
    (1, 4), (4, 7), (10, 7), (13, 10), (16, 13), (14, 10), (17, 14),
    (19, 17), (21, 19), (23, 21), (15, 10), (18, 15), (20, 18),
    (22, 20), (24, 22), (2, 1), (5, 2), (8, 5), (11, 8),
    (3, 1), (6, 3), (9, 6), (12, 9),
]
INWARD = [(i - 1, j - 1) for i, j in _INWARD_1IDX]
OUTWARD = [(j, i) for i, j in INWARD]
NEIGHBOR = INWARD + OUTWARD


def adjacency_from_edges(edges, num_nodes: int = NUM_NODES) -> np.ndarray:
    A = np.zeros((num_nodes, num_nodes), dtype=np.float32)
    for e in edges:
        A[e] = 1.0
    return A


def normalize_adjacency(A: np.ndarray) -> np.ndarray:
    """Symmetric normalisation D^-1/2 A D^-1/2 (ref: tools.py:42-46)."""
    deg = A.sum(-1)
    # The reference computes deg**-0.5 directly (inf for isolated nodes, which
    # never occurs on these graphs); mirror that but guard zeros.
    with np.errstate(divide="ignore"):
        dinv = np.power(deg, -0.5)
    dinv[np.isinf(dinv)] = 0.0
    D = np.eye(len(deg)) * dinv
    return (D @ A @ D).astype(np.float32)


def k_adjacency(A: np.ndarray, k: int, with_self: bool = False,
                self_factor: float = 1.0) -> np.ndarray:
    """Exact k-hop adjacency (disentangled aggregation, ref: tools.py:30-39).

    A_k = min((A+I)^k, 1) - min((A+I)^(k-1), 1)  [+ self_factor * I]
    """
    I = np.eye(len(A), dtype=A.dtype)
    if k == 0:
        return I
    Ak = (np.minimum(np.linalg.matrix_power(A + I, k), 1)
          - np.minimum(np.linalg.matrix_power(A + I, k - 1), 1))
    if with_self:
        Ak = Ak + self_factor * I
    return Ak


def multi_scale_adjacency(A_binary: np.ndarray,
                          num_scales: int) -> np.ndarray:
    """Stacked normalised k-hop adjacencies, (num_scales * V, V).

    ref: ms_gcn.py:27-30 (disentangled_agg=True path).
    """
    powers = [k_adjacency(A_binary, k, with_self=True)
              for k in range(num_scales)]
    return np.concatenate([normalize_adjacency(g) for g in powers], axis=0)


def spatial_temporal_adjacency(A_binary: np.ndarray,
                               window_size: int) -> np.ndarray:
    """Tile (A + I) into a (window*V, window*V) block-dense graph connecting
    every frame pair inside the temporal window (ref: ms_gtcn.py:85-92)."""
    A_with_I = A_binary + np.eye(len(A_binary), dtype=A_binary.dtype)
    return np.tile(A_with_I, (window_size, window_size)).copy()


def smpl_graph_binary() -> np.ndarray:
    """A_binary of the 24-joint SMPL pose graph (ref: smplx_theta.py:20-27)."""
    return adjacency_from_edges(NEIGHBOR)
