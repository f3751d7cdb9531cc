"""k-nearest-neighbour search, ball query, neighbour gathers and 3-NN interpolation.

Counterpart of `flowcompare_tpu/ops/knn.py` (`pairwise_sqdist`,
`knn_indices`, `knn_self`, `ball_query`, `gather_neighbors`,
`three_nn_interpolate`, `nearest_neighbor_gather`).
Ties break by the lower index, the order `lax.top_k` gives: a stable sort on
distance keeps equal distances in index order, which `torch.topk` does not
promise. The gather is a plain index gather; the JAX package's one-hot
matmul gather and its scatter-free matmul backward (`gather_neighbors_mm`)
are TPU workarounds, and torch autograd's gather backward takes their place.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances. x: (..., N, D), y: (..., M, D) -> (..., N, M)."""
    xf = x.float()
    yf = y.float()
    inner = torch.matmul(xf, yf.transpose(-1, -2))
    xx = (xf * xf).sum(-1)[..., :, None]
    yy = (yf * yf).sum(-1)[..., None, :]
    return xx - 2.0 * inner + yy


# Bytes of (distance, sorted distance, int64 index) entries a plain kNN
# sort holds at once: larger problems sort query rows a block at a time.
SORT_BYTES = 2 ** 30


def row_blocks(rows: int, cols: int, batch: int) -> list:
    """Slices of `rows` query rows whose (batch, rows, cols) sort takes at
    most SORT_BYTES (16 bytes an entry): one slice for every shape the tests
    run, several for clouds of tens of thousands of points."""
    step = max(1, SORT_BYTES // (16 * max(1, batch) * max(1, cols)))
    return [slice(r, min(r + step, rows)) for r in range(0, rows, step)]


def knn_indices(query: torch.Tensor, points: torch.Tensor, k: int,
                self_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """query (..., M, D), points (..., N, D) -> int64 (..., M, k): the k
    nearest points of each query, nearest first, equal distances in index
    order. `self_idx` (..., M) is each query's own index among the points
    (FPS centres): it pins slot 0 to the centre whatever its rounded
    distance. When k > N the tail is padded with index 0. Query rows are
    sorted a block at a time (`row_blocks`)."""
    n = points.shape[-2]
    batch = math.prod(query.shape[:-2])
    parts = []
    for rows in row_blocks(query.shape[-2], n, batch):
        d = pairwise_sqdist(query[..., rows, :], points)
        if self_idx is not None:
            is_self = torch.arange(n, device=d.device) == self_idx[..., rows, None]
            d = torch.where(is_self, float("-inf"), d)
        # a copy: a view would keep the block's whole sort alive
        parts.append(torch.sort(d, dim=-1, stable=True).indices[..., :min(k, n)].contiguous())
    idx = parts[0] if len(parts) == 1 else torch.cat(parts, -2)
    if k > n:
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1] + (k - n,))], -1)
    return idx


def knn_self(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, D) -> int64 (B, N, k): each point's k nearest points, self
    included, nearest first, equal distances in index order. Self is not
    pinned to slot 0 (only membership matters to the max-pooling callers)."""
    d = pairwise_sqdist(x, x)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def ball_query(radius: float, nsample: int, points: torch.Tensor,
               query: torch.Tensor) -> torch.Tensor:
    """The first `nsample` points (in index order) within `radius` of each
    query, padded with the first hit; index 0 where the ball is empty.
    points (..., N, D), query (..., M, D) -> int32 (..., M, nsample)."""
    in_ball = pairwise_sqdist(query, points) < radius * radius
    order = torch.arange(points.shape[-2], device=points.device, dtype=torch.float32)
    key = torch.where(in_ball, order, float("inf"))
    idx = torch.sort(key, dim=-1, stable=True).indices[..., :nsample]
    idx = torch.where(torch.gather(in_ball, -1, idx), idx, idx[..., :1])
    idx = torch.where(in_ball.any(-1, keepdim=True), idx, torch.zeros_like(idx))
    return idx.to(torch.int32)


def gather_neighbors(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M, K) -> (B, M, K, C)."""
    b, m, k = idx.shape
    flat = idx.reshape(b, m * k, 1).expand(b, m * k, features.shape[-1])
    return torch.gather(features, 1, flat).reshape(b, m, k, features.shape[-1])


def three_nn_interpolate(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                         known_feats: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-squared-distance 3-NN interpolation (PointNet++ feature
    propagation): unknown (B, n, 3), known (B, m, 3), known_feats (B, m, C)
    -> (B, n, C) in known_feats' dtype. The 3 nearest by f32 squared
    distance, ties by index; with m < 3 the missing slots take index 0 at
    distance 1e20. Weights 1 / (max(d^2, 0) + eps), normalised; the weighted
    sum accumulates in f32."""
    m = known_xyz.shape[-2]
    d2 = pairwise_sqdist(unknown_xyz, known_xyz)
    d2, idx = torch.sort(d2, dim=-1, stable=True)
    d2, idx = d2[..., :min(3, m)], idx[..., :min(3, m)]
    if m < 3:
        pad = idx.shape[:-1] + (3 - m,)
        idx = torch.cat([idx, idx.new_zeros(pad)], -1)
        d2 = torch.cat([d2, d2.new_full(pad, 1e20)], -1)
    recip = 1.0 / (d2.clamp_min(0.0) + eps)
    weight = recip / recip.sum(-1, keepdim=True)
    gathered = gather_neighbors(known_feats, idx)
    return torch.einsum("bnk,bnkc->bnc", weight, gathered.float()).to(known_feats.dtype)


def nearest_neighbor_gather(query_xyz: torch.Tensor, points_xyz: torch.Tensor,
                            feats: torch.Tensor) -> torch.Tensor:
    """1-NN feature redistribution (pointops' featuredistribute and
    featuregather): query_xyz (B, M, D), points_xyz (B, N, D), feats
    (B, N, C) -> (B, M, C), each query taking the features of its nearest
    point by f32 squared distance, equal distances to the lower index."""
    idx = knn_indices(query_xyz, points_xyz, 1)
    return torch.gather(feats, 1, idx.expand(-1, -1, feats.shape[-1]))
