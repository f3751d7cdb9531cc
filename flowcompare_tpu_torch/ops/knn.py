"""Self k-nearest-neighbour search and neighbour gathers.

Counterpart of `flowcompare_tpu/ops/knn.py` (`pairwise_sqdist`, `knn_self`,
`gather_neighbors`). Ties break by the lower index, the order `lax.top_k`
gives: a stable sort on distance keeps equal distances in index order,
which `torch.topk` does not promise. The gather is a plain index gather;
the JAX package's one-hot matmul gather is a TPU workaround.
"""

from __future__ import annotations

import torch


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances. x: (..., N, D), y: (..., M, D) -> (..., N, M)."""
    xf = x.float()
    yf = y.float()
    inner = torch.matmul(xf, yf.transpose(-1, -2))
    xx = (xf * xf).sum(-1)[..., :, None]
    yy = (yf * yf).sum(-1)[..., None, :]
    return xx - 2.0 * inner + yy


def knn_self(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, D) -> int64 (B, N, k): each point's k nearest points, self
    included, nearest first, equal distances in index order. Self is not
    pinned to slot 0 (only membership matters to the max-pooling callers)."""
    d = pairwise_sqdist(x, x)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def gather_neighbors(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M, K) -> (B, M, K, C)."""
    b, m, k = idx.shape
    flat = idx.reshape(b, m * k, 1).expand(b, m * k, features.shape[-1])
    return torch.gather(features, 1, flat).reshape(b, m, k, features.shape[-1])
