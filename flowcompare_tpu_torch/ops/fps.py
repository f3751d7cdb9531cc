"""Farthest-point sampling's entry points: the picks and the subsample.

Counterpart of `flowcompare_tpu/ops/fps.py` (`furthest_point_sampling`,
`fps_subsample`). The picks are B8's (`fps_cuda`): on a CUDA tensor one
launch of the kernel, on a CPU tensor its plain version. The first pick is
index 0 and each next one the first index of the largest running minimum
of f32 squared distances, the JAX package's order.
"""

from __future__ import annotations

import torch

from .fps_cuda import furthest_point_sampling


def fps_subsample(points: torch.Tensor, m: int) -> torch.Tensor:
    """The m farthest-point picks of (B, N, D) points, by their first three
    columns -> (B, m, D) rows of `points`."""
    idx = furthest_point_sampling(points[..., :3], m)
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))


__all__ = ["fps_subsample", "furthest_point_sampling"]
