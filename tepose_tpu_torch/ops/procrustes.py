"""Procrustes / similarity-transform alignment (the PA in PA-MPJPE).

Port of `tepose_tpu/ops/procrustes.py` (`similarity_transform`,
`batch_similarity_transform`): SVD-based
orthogonal Procrustes with the reflection fix and scale/translation recovery.
The rotation V Z U^T does not depend on the signs the SVD picks for its
singular-vector pairs, so `torch.linalg.svd` and `jnp.linalg.svd` agree.
"""

from __future__ import annotations

import torch


def similarity_transform(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """Align the point set S1 (N, 3) to S2 (N, 3) by a similarity
    transform (s, R, t); returns s * R @ S1 + t as (N, 3)."""
    return batch_similarity_transform(S1[None], S2[None])[0]


def batch_similarity_transform(S1: torch.Tensor,
                               S2: torch.Tensor) -> torch.Tensor:
    """Align S1 (B, N, 3) to S2 (B, N, 3); returns S1_hat (B, N, 3)."""
    X1 = S1.transpose(-1, -2)  # (B, 3, N)
    X2 = S2.transpose(-1, -2)

    mu1 = X1.mean(dim=-1, keepdim=True)
    mu2 = X2.mean(dim=-1, keepdim=True)
    X1c = X1 - mu1
    X2c = X2 - mu2

    var1 = torch.sum(X1c ** 2, dim=(-1, -2))  # (B,)
    K = torch.einsum("bin,bjn->bij", X1c, X2c)  # (B, 3, 3)

    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(-1, -2)

    Z = torch.eye(3, dtype=S1.dtype, device=S1.device).expand_as(K).clone()
    det = torch.linalg.det(torch.einsum("bij,bkj->bik", U, V))  # det(U V^T)
    Z[:, -1, -1] = Z[:, -1, -1] * torch.sign(det)

    R = torch.einsum("bij,bjk,blk->bil", V, Z, U)  # V @ Z @ U^T
    scale = torch.einsum("bij,bji->b", R, K) / var1
    t = mu2 - scale[:, None, None] * torch.einsum("bij,bjk->bik", R, mu1)

    S1_hat = scale[:, None, None] * torch.einsum("bij,bjn->bin", R, X1) + t
    return S1_hat.transpose(-1, -2)
