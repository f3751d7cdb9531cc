"""Synthetic multi-temporal voxel-pair generator.

Counterpart of `flowcompare_tpu/data/synthetic.py`, item for item the same
from the same seed (the same numpy draws in the same order; FPS on the
port's native op). Structured scenes with the `AmsVoxelLoader` item
contract: co-registered (t0 context, t1 target) voxel pairs,
FPS-downsampled to fixed sizes, jointly unit-sphere normalized, a random
z-rotation in train mode, and a height-above-ground extra-context scalar.

Scenes are planar ground + a wall + ellipsoid objects, with per-epoch
changes (an object appears) so the change-detection eval has real signal.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import numpy as np

from .transforms import fps_numpy, get_voxel, np_co_unit_sphere


def _scene_cloud(rng: np.random.Generator, *, n_ground=4000, removed=False,
                 color_shift=0.0) -> np.ndarray:
    """One ~10x10 m scene as (N, 6) xyz+rgb in [0,1]."""
    parts = []
    g = np.empty((n_ground, 6), np.float32)
    g[:, 0:2] = rng.uniform(-5, 5, (n_ground, 2))
    g[:, 2] = rng.normal(0, 0.02, n_ground)
    g[:, 3:6] = np.clip(rng.normal(0.45, 0.05, (n_ground, 3)) + color_shift, 0, 1)
    parts.append(g)
    # a wall
    w = np.empty((1500, 6), np.float32)
    w[:, 0] = rng.uniform(-3, 3, 1500)
    w[:, 1] = 1.5 + rng.normal(0, 0.02, 1500)
    w[:, 2] = rng.uniform(0, 4, 1500)
    w[:, 3:6] = np.clip(rng.normal(0.7, 0.05, (1500, 3)) + color_shift, 0, 1)
    parts.append(w)
    if not removed:  # an object that may disappear between epochs
        o = np.empty((800, 6), np.float32)
        center = np.array([rng.uniform(-2, 2), rng.uniform(-1, 0.5), 0.8])
        o[:, :3] = center + rng.normal(0, 0.35, (800, 3))
        o[:, 2] = np.abs(o[:, 2])
        o[:, 3:6] = np.clip(rng.normal(0.3, 0.08, (800, 3)), 0, 1)
        parts.append(o)
    return np.concatenate(parts)


class SyntheticVoxelDataset:
    """Re-iterable batch source with the `AmsVoxelLoader` item contract.

    Yields (extract_0 (B, Nc, 6), extract_1 (B, N, 6), extra (B, 1) | None);
    mode='train' adds a random z-rotation; include_all yields the 11-tensor
    eval items of `get_item_all` instead.
    """

    def __init__(self, *, n_items: int = 64, batch_size: int = 4,
                 sample_size: int = 1024, n_samples_context: int = 1250,
                 with_extra: bool = True, mode: str = "train",
                 include_all: bool = False, seed: int = 0,
                 final_voxel_size=(2.0, 2.0, 4.0),
                 context_voxel_size=(2.2, 2.2, 4.2),
                 change_fraction: float = 0.3):
        self.n_items = n_items
        self.batch_size = batch_size
        self.sample_size = sample_size
        self.n_samples_context = n_samples_context
        self.with_extra = with_extra
        self.mode = mode
        self.include_all = include_all
        self.seed = seed
        self.final_voxel_size = np.asarray(final_voxel_size, np.float32)
        self.context_voxel_size = np.asarray(context_voxel_size, np.float32)
        self.change_fraction = change_fraction

    def __len__(self):
        return self.n_items

    def _voxel_pair(self, idx: int):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        changed = rng.uniform() < self.change_fraction
        cloud_0 = _scene_cloud(rng, removed=True)   # base scene, no object
        cloud_1 = _scene_cloud(rng, removed=True,
                               color_shift=rng.normal(0, 0.02))
        obj_xy = np.array([rng.uniform(-2, 2), rng.uniform(-1, 0.5)],
                          np.float32)
        if changed:
            # an object APPEARS at t1 inside the voxel that will be sampled —
            # the per-point likelihood under p(t1 | t0) flags the new points
            o = np.empty((800, 6), np.float32)
            center3 = np.array([obj_xy[0], obj_xy[1], 0.8])
            o[:, :3] = center3 + rng.normal(0, 0.35, (800, 3))
            o[:, 2] = np.abs(o[:, 2])
            o[:, 3:6] = np.clip(rng.normal(0.3, 0.08, (800, 3)), 0, 1)
            cloud_1 = np.concatenate([cloud_1, o])
        # small registration residual between epochs
        cloud_1[:, :3] += rng.normal(0, 0.01, 3).astype(np.float32)
        ground_height = 0.0
        center = np.array([obj_xy[0], obj_xy[1], ground_height + 1.0],
                          np.float32)
        v1 = get_voxel(cloud_1, center, self.final_voxel_size)
        v0c = get_voxel(cloud_0, center, self.context_voxel_size)
        if len(v1) <= 64 or len(v0c) <= 64:  # fall back to any occupied spot
            for _ in range(20):
                center = np.array([rng.uniform(-3, 3), rng.uniform(-1, 1),
                                   ground_height + 1.0], np.float32)
                v1 = get_voxel(cloud_1, center, self.final_voxel_size)
                v0c = get_voxel(cloud_0, center, self.context_voxel_size)
                if len(v1) > 64 and len(v0c) > 64:
                    break
        return cloud_0, cloud_1, center, ground_height, rng

    def is_changed(self, idx: int) -> bool:
        """Ground-truth change label for eval (the generator's coin flip)."""
        rng = np.random.default_rng(self.seed * 100003 + idx)
        return bool(rng.uniform() < self.change_fraction)

    def get_item(self, idx: int):
        cloud_0, cloud_1, center, ground_height, rng = self._voxel_pair(idx)
        voxel_1_small = fps_numpy(
            get_voxel(cloud_1, center, self.final_voxel_size), self.sample_size)
        voxel_0_large = fps_numpy(
            get_voxel(cloud_0, center, self.context_voxel_size),
            self.n_samples_context)
        voxel_0_large, voxel_1_small, inverse = np_co_unit_sphere(
            voxel_0_large, voxel_1_small)
        if self.mode == "train":
            rad = rng.uniform(0, 2 * math.pi)
            c, s = math.cos(rad), math.sin(rad)
            rot = np.array([[c, -s], [s, c]], np.float32)
            voxel_0_large[:, :2] = voxel_0_large[:, :2] @ rot
            voxel_1_small[:, :2] = voxel_1_small[:, :2] @ rot
        extra = np.asarray([inverse["mean"][2] - ground_height], np.float32)
        return voxel_0_large, voxel_1_small, extra

    def get_item_all(self, idx: int):
        """Eval item: the 11-tensor contract of all_getter(include_all)."""
        cloud_0, cloud_1, center, ground_height, rng = self._voxel_pair(idx)
        fvs, cvs = self.final_voxel_size, self.context_voxel_size
        v1s = fps_numpy(get_voxel(cloud_1, center, fvs), self.sample_size)
        v0l = fps_numpy(get_voxel(cloud_0, center, cvs), self.n_samples_context)
        v0s = fps_numpy(get_voxel(cloud_0, center, fvs), self.sample_size)
        v1l = fps_numpy(get_voxel(cloud_1, center, cvs), self.n_samples_context)
        v1s_orig, v0s_orig = v1s.copy(), v0s.copy()
        v0s_self, v0l_self, _ = np_co_unit_sphere(v0s, v0l)
        v1l_self, v1s_self, _ = np_co_unit_sphere(v1l, v1s)
        v_opp_small, v_opp_large, _ = np_co_unit_sphere(v0s, v1l)
        v0l_n, v1s_n, inverse = np_co_unit_sphere(v0l, v1s)
        extra = np.asarray([inverse["mean"][2] - ground_height], np.float32)
        return (v0l_n, v1s_n, extra, v1l_self, v1s_self, v_opp_small,
                v_opp_large, v0s_self, v0l_self, v0s_orig, v1s_orig)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]]:
        getter = self.get_item_all if self.include_all else self.get_item
        n_batches = self.n_items // self.batch_size
        for b in range(n_batches):
            items = [getter(b * self.batch_size + i)
                     for i in range(self.batch_size)]
            stacked = tuple(np.stack([it[j] for it in items])
                            for j in range(len(items[0])))
            if not self.include_all and not self.with_extra:
                stacked = (stacked[0], stacked[1], None)
            yield stacked
