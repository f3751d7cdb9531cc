"""Point-cloud normalizations and voxel cropping.

Counterpart of `flowcompare_tpu/data/transforms.py`, without JAX: the numpy
helpers of the host data path are the same code (so items come out equal
bit for bit), and `unit_sphere` / `co_unit_sphere`, jnp there, take torch
tensors here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native


def unit_sphere(points: torch.Tensor, return_inverse: bool = False):
    """Zero-mean, unit-ball normalize xyz (first 3 channels); rgb untouched."""
    mean = points[:, :3].mean(dim=0)
    xyz = points[:, :3] - mean
    furthest = torch.linalg.vector_norm(xyz, dim=-1).max()
    out = torch.cat([xyz / furthest, points[:, 3:]], dim=-1)
    if return_inverse:
        return out, {"furthest_distance": furthest, "mean": mean}
    return out


def co_unit_sphere(points_0: torch.Tensor, points_1: torch.Tensor,
                   return_inverse: bool = False):
    """Joint zero-mean unit-ball normalization of a pair."""
    l0 = points_0.shape[0]
    joint, inverse = unit_sphere(torch.cat((points_0, points_1)), return_inverse=True)
    if return_inverse:
        return joint[:l0], joint[l0:], inverse
    return joint[:l0], joint[l0:]


def get_voxel_mask(cloud_xyz: np.ndarray, center: np.ndarray,
                   size) -> np.ndarray:
    """Boolean mask of points inside the axis-aligned box center +- size/2."""
    size = np.asarray(size)
    lo = np.asarray(center) - size / 2
    hi = np.asarray(center) + size / 2
    return np.all((cloud_xyz >= lo) & (cloud_xyz < hi), axis=-1)


def get_voxel(cloud: np.ndarray, center, size) -> np.ndarray:
    """Crop the points of `cloud` inside the voxel box."""
    mask = get_voxel_mask(cloud[:, :3], center, size)
    return cloud[mask]


def oversample_cloud(cloud: np.ndarray, n_points: int,
                     rng: np.random.Generator | None = None) -> np.ndarray:
    """Repeat random points until the cloud reaches n_points."""
    n0 = cloud.shape[0]
    if n0 >= n_points:
        return cloud
    rng = rng or np.random.default_rng(0)
    extra = rng.integers(0, n0, n_points - n0)
    return np.concatenate((cloud, cloud[extra]))


def random_subsample(cloud: np.ndarray, n_points: int,
                     rng: np.random.Generator | None = None) -> np.ndarray:
    n0 = cloud.shape[0]
    if n0 <= n_points:
        return cloud
    rng = rng or np.random.default_rng(0)
    idx = rng.choice(n0, n_points, replace=False)
    return cloud[idx]


def rotate_xy(rad: float) -> np.ndarray:
    c, s = np.cos(rad), np.sin(rad)
    return np.array([[c, -s], [s, c]], dtype=np.float32)


def min_max_norm(t):
    return (t - t.min()) / (t.max() - t.min())


def fps_numpy(points: np.ndarray, m: int,
              rng: np.random.Generator | None = None) -> np.ndarray:
    """Deterministic farthest-point sampling (start index 0, as the loaders'
    random_start=False) on the native op, oversampling with `rng` when the
    cloud has no more than m points."""
    n = points.shape[0]
    if n <= m:
        return oversample_cloud(points, m, rng)
    sel = native.fps_indices(np.ascontiguousarray(points, np.float32), m)
    return points[sel]


def np_co_unit_sphere(p0: np.ndarray, p1: np.ndarray):
    """Joint zero-mean unit-ball normalization of a pair, numpy."""
    l0 = p0.shape[0]
    joint = np.concatenate((p0, p1)).astype(np.float32).copy()
    mean = joint[:, :3].mean(axis=0)
    joint[:, :3] -= mean
    furthest = np.max(np.linalg.norm(joint[:, :3], axis=-1))
    joint[:, :3] /= furthest
    inverse = {"furthest_distance": furthest, "mean": mean}
    return joint[:l0], joint[l0:], inverse


def extract_area(cloud: np.ndarray, center, clearance: float,
                 shape: str = "square") -> np.ndarray:
    """Boolean mask of points within a square/circle around (x, y)."""
    xy = cloud[:, :2] - np.asarray(center)[:2]
    if shape == "square":
        return np.all(np.abs(xy) < clearance, axis=-1)
    if shape == "circle":
        return np.linalg.norm(xy, axis=-1) < clearance
    raise ValueError(f"invalid shape {shape}")
