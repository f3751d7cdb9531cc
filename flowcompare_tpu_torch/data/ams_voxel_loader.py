"""AMS multi-temporal voxel dataset: offline build + online pair getter.

Counterpart of `flowcompare_tpu/data/ams_voxel_loader.py`, the same code on
the port's transforms, LAS/LAZ readers and native ops: the same items from
the same seed, and pickle caches that either package reads. Like the
original FlowCompare `dataloaders/ams_voxel_loader.py`:

Offline (runs once, host-side, cached):
  * parse recording metadata (`response.json`) into Scans (:43-54)
  * de-duplicate scan locations within 3 m (`filter_scans`, :29-40)
  * per scene: merge same-date clouds within 7 m, recenter on the scan,
    crop a `clearance`-square, co-register across dates
    (data/registration.py), cut below ground / above max height (:128-182)
  * enumerate valid (cloud_i, cloud_j, voxel) combinations: O(N) grid
    binning (ops/voxelize semantics — replacing the reference's O(N*V)
    kNN-to-centers), keep voxels with > n_samples_context points in both
    epochs, optional 1:1 self-pairs for training (:187-263)

Online (__getitem__ / get_item_all): crop final + context voxels,
deterministic FPS to fixed sizes, joint unit-sphere normalization,
self-pair jitter + random z-rotation in train mode, height-above-ground
extra context (:277-354). The original's tensor contract,
including the 11-tensor include_all eval items.
"""

from __future__ import annotations

import json
import math
import os
import pickle
from datetime import datetime
from itertools import combinations
from typing import Iterator, List

import numpy as np

from .. import native
from .las_io import load_cloud
from .registration import registration_pipeline
from .transforms import extract_area, fps_numpy, get_voxel, np_co_unit_sphere


class Scan:
    """One recording location (ams_voxel_loader.py:43-54)."""

    def __init__(self, recording_properties: dict, base_dir: str,
                 cloud_ext: str = ".laz"):
        self.recording_properties = recording_properties
        self.id = recording_properties["ImageId"]
        self.center = np.array([recording_properties["X"],
                                recording_properties["Y"]])
        self.height = recording_properties["Height"]
        self.ground_offset = recording_properties["GroundLevelOffset"]
        self.ground_height = self.height - self.ground_offset
        self.path = os.path.join(base_dir, f"{self.id}{cloud_ext}")
        t = recording_properties["RecordingTimeGps"]
        parts = t.split("-")
        self.datetime = datetime(int(parts[0]), int(parts[1]),
                                 int(parts[2].split("T")[0]))


def filter_scans(scans_list: List[Scan], dist: float) -> List[Scan]:
    """Greedy de-dup of scan locations closer than `dist` (:29-40)."""
    ignore: set = set()
    keep = []
    for scan in scans_list:
        if scan.id in ignore:
            continue
        keep.append(scan)
        for other in scans_list:
            if np.linalg.norm(other.center - scan.center) < dist:
                ignore.add(other.id)
    return keep


def _grid_voxelize(xyz: np.ndarray, start: np.ndarray, end: np.ndarray,
                   size: np.ndarray):
    """Point -> voxel id by O(N) grid binning (native C++ when built);
    returns (ids, centers_fn)."""
    steps = np.floor((end - start) / size).astype(np.int64) + 1
    ids = native.voxelize_grid(xyz.astype(np.float32), start, size, steps)

    def center_of(voxel_id: int) -> np.ndarray:
        rem = int(voxel_id)
        coords = []
        for s in steps:
            coords.append(rem % s)
            rem //= s
        return start + (np.asarray(coords) + 0.5) * size

    return ids, center_of


class AmsVoxelLoader:
    """Multi-temporal voxel-pair dataset with the original's item contract.

    A map-style source (`__getitem__`, `__len__`) for `batch_iterator`,
    `eval_batches` and `PrefetchedDataset`. Its items draw oversampling,
    jitter and rotation from one generator in item order, so keep it in
    one process (no DataLoader workers) to get the JAX package's items."""

    def __init__(self, directory_path_train: str, directory_path_test: str,
                 out_path: str, *, clearance: float = 10, preload: bool = False,
                 max_height: float = 15.0, n_samples: int = 2048,
                 final_voxel_size=(3.0, 3.0, 4.0), rotation_augment: bool = True,
                 n_samples_context: int = 2048,
                 context_voxel_size=(3.0, 3.0, 4.0), mode: str = "train",
                 voxel_size_final_downsample: float = 0.07,
                 include_all: bool = False, self_pairs_train: bool = True,
                 cloud_ext: str = ".laz", years=(2019, 2020),
                 min_cloud_points: int = 5000, seed: int = 0, **_unused):
        if mode not in ("train", "test"):
            raise ValueError("Invalid mode")
        self.mode = mode
        self.include_all = include_all
        self.directory_path = (directory_path_train if mode == "train"
                               else directory_path_test)
        self.out_path = out_path
        self.clearance = clearance
        self.max_height = max_height
        self.n_samples = n_samples
        self.n_samples_context = n_samples_context
        self.final_voxel_size = np.asarray(final_voxel_size, np.float64)
        self.context_voxel_size = np.asarray(context_voxel_size, np.float64)
        self.rotation_augment = rotation_augment
        self.self_pairs_train = self_pairs_train
        self.voxel_size_final_downsample = voxel_size_final_downsample
        self.cloud_ext = cloud_ext
        self.years = set(years)
        self.min_cloud_points = min_cloud_points
        self._rng = np.random.default_rng(seed)

        os.makedirs(out_path, exist_ok=True)
        save_name = f"ams_{mode}_save_dict_{clearance}"
        self.save_path = os.path.join(out_path, save_name + ".pkl")
        suffix = f"_{self_pairs_train}" if mode == "train" else ""
        self.combs_path = os.path.join(
            out_path, f"{save_name}_all_valid_combs{suffix}.pkl")

        if preload and os.path.isfile(self.save_path):
            with open(self.save_path, "rb") as f:
                self.save_dict = pickle.load(f)
        else:
            self.save_dict = self._build_scenes()
        if os.path.isfile(self.combs_path):
            with open(self.combs_path, "rb") as f:
                self.all_valid_combs = pickle.load(f)
        else:
            self.all_valid_combs = self._enumerate_combinations()

    # ------------------------------------------------------------- offline

    def _build_scenes(self) -> dict:
        with open(os.path.join(self.directory_path, "response.json")) as f:
            response = json.load(f)
        scans = [Scan(p, self.directory_path, self.cloud_ext)
                 for p in response["RecordingProperties"]]
        scans = [s for s in scans if s.datetime.year in self.years]
        filtered = filter_scans(scans, 3)

        save_dict = {}
        save_id = -1
        for scan in filtered:
            relevant = [s for s in scans
                        if np.linalg.norm(s.center - scan.center) < 7]
            by_time: dict = {}
            for s in relevant:
                by_time.setdefault(s.datetime, []).append(s)
            clouds = []
            for _, group in sorted(by_time.items()):
                cloud = np.concatenate([load_cloud(s.path) for s in group])
                cloud[:, :2] -= scan.center  # recenter xy at the scan
                mask = extract_area(cloud, (0.0, 0.0), self.clearance, "square")
                clouds.append(cloud[mask])
            clouds = [c for c in clouds if len(c) > 0]
            if len(clouds) < 1:
                continue
            clouds = registration_pipeline(
                clouds, voxel_size_icp=0.05,
                voxel_size_final=self.voxel_size_final_downsample)
            ground_cutoff = scan.ground_height - 0.05
            height_cutoff = ground_cutoff + self.max_height
            clouds = [c[(c[:, 2] > ground_cutoff) & (c[:, 2] < height_cutoff)]
                      for c in clouds]
            save_id += 1
            save_dict[save_id] = {
                "clouds": [c.astype(np.float32) for c in clouds],
                "ground_height": scan.ground_height,
            }
            if save_id % 100 == 0 and save_id != 0:
                # progress backup every 100 scenes (ams_voxel_loader.py:175-177)
                with open(self.save_path, "wb") as f:
                    pickle.dump(save_dict, f)
        with open(self.save_path, "wb") as f:
            pickle.dump(save_dict, f)
        return save_dict

    def _enumerate_combinations(self) -> list:
        all_valid = []
        for save_id, entry in self.save_dict.items():
            clouds = {i: c for i, c in enumerate(entry["clouds"])
                      if c.shape[0] > self.min_cloud_points}
            if len(clouds) < 2 and not (self.mode == "train"
                                        and self.self_pairs_train
                                        and len(clouds) == 1):
                continue
            lo = np.min([c[:, :3].min(axis=0) for c in clouds.values()], axis=0)
            hi = np.max([c[:, :3].max(axis=0) for c in clouds.values()], axis=0)
            valid_voxels = {}
            center_fn = None
            for i, c in clouds.items():
                ids, center_fn = _grid_voxelize(
                    c[:, :3], lo, hi, self.final_voxel_size)
                uniq, counts = np.unique(ids, return_counts=True)
                valid_voxels[i] = set(uniq[counts > self.n_samples_context]
                                      .tolist())
            valid_combs = []
            for i0, i1 in combinations(sorted(valid_voxels), 2):
                common = valid_voxels[i0] & valid_voxels[i1]
                valid_combs.extend((i0, i1, v) for v in sorted(common))
                if self.mode == "train" and self.self_pairs_train:
                    valid_combs.extend((i0, i0, v) for v in sorted(common))
            for i0, i1, v in valid_combs:
                center = center_fn(v)
                voxel_0 = get_voxel(clouds[i0], center, self.context_voxel_size)
                if voxel_0.shape[0] >= self.n_samples_context:
                    all_valid.append({
                        "combination": (save_id, i0, i1, v),
                        "voxel_center": center.astype(np.float32),
                    })
        with open(self.combs_path, "wb") as f:
            pickle.dump(all_valid, f)
        return all_valid

    # -------------------------------------------------------------- online

    def __len__(self) -> int:
        return len(self.all_valid_combs)

    def _crop_fps(self, cloud, center, size, n):
        return fps_numpy(get_voxel(cloud, center, size), n, self._rng)[:n]

    def get_item(self, idx: int):
        save_id, i0, i1, _v = self.all_valid_combs[idx]["combination"]
        center = self.all_valid_combs[idx]["voxel_center"]
        entry = self.save_dict[save_id]
        cloud_0, cloud_1 = entry["clouds"][i0], entry["clouds"][i1]
        voxel_1_small = self._crop_fps(cloud_1, center, self.final_voxel_size,
                                       self.n_samples)
        voxel_0_large = self._crop_fps(cloud_0, center, self.context_voxel_size,
                                       self.n_samples_context)
        if i0 == i1:
            voxel_1_small = voxel_1_small.copy()
            if self.mode == "train":  # self-pair jitter (:335-337)
                voxel_0_large = voxel_0_large.copy()
                voxel_0_large[:, :3] += self._rng.uniform(
                    0, 0.01, voxel_0_large[:, :3].shape).astype(np.float32)
        voxel_0_large, voxel_1_small, inverse = np_co_unit_sphere(
            voxel_0_large, voxel_1_small)
        if self.mode == "train" and self.rotation_augment:
            rad = self._rng.uniform(0, 2 * math.pi)
            c, s = math.cos(rad), math.sin(rad)
            rot = np.array([[c, -s], [s, c]], np.float32)
            voxel_0_large[:, :2] = voxel_0_large[:, :2] @ rot
            voxel_1_small[:, :2] = voxel_1_small[:, :2] @ rot
        extra = np.asarray(
            [inverse["mean"][2] - entry["ground_height"]], np.float32)
        return voxel_0_large, voxel_1_small, extra

    def get_item_all(self, idx: int):
        """The 11-tensor eval item (all_getter include_all path :309-352)."""
        save_id, i0, i1, _v = self.all_valid_combs[idx]["combination"]
        center = self.all_valid_combs[idx]["voxel_center"]
        entry = self.save_dict[save_id]
        cloud_0, cloud_1 = entry["clouds"][i0], entry["clouds"][i1]
        fvs, cvs = self.final_voxel_size, self.context_voxel_size
        v1s = self._crop_fps(cloud_1, center, fvs, self.n_samples)
        v0l = self._crop_fps(cloud_0, center, cvs, self.n_samples_context)
        v0s = self._crop_fps(cloud_0, center, fvs, self.n_samples)
        v1l = self._crop_fps(cloud_1, center, cvs, self.n_samples_context)
        v1s_orig, v0s_orig = v1s.copy(), v0s.copy()
        v0s_self, v0l_self, _ = np_co_unit_sphere(v0s, v0l)
        v1l_self, v1s_self, _ = np_co_unit_sphere(v1l, v1s)
        v_opp_small, v_opp_large, _ = np_co_unit_sphere(v0s, v1l)
        v0l_n, v1s_n, inverse = np_co_unit_sphere(v0l, v1s)
        extra = np.asarray(
            [inverse["mean"][2] - entry["ground_height"]], np.float32)
        return (v0l_n, v1s_n, extra, v1l_self, v1s_self, v_opp_small,
                v_opp_large, v0s_self, v0l_self, v0s_orig, v1s_orig)

    def __getitem__(self, idx: int):
        return self.get_item_all(idx) if self.include_all else self.get_item(idx)


def batch_iterator(dataset, batch_size: int, *, shuffle: bool = False,
                   seed: int = 0, epoch: int = 0,
                   drop_last: bool = True) -> Iterator:
    """Stack dataset items into batches (torch DataLoader replacement).

    `epoch` folds into the shuffle seed so each epoch draws a fresh
    permutation, like DataLoader(shuffle=True) re-sampling every epoch
    (reference train.py:41).
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed + 1_000_003 * epoch).shuffle(order)
    n = len(order) - (len(order) % batch_size if drop_last else 0)
    for start in range(0, n, batch_size):
        items = [dataset[int(i)] for i in order[start:start + batch_size]]
        yield tuple(np.stack([it[j] for it in items])
                    for j in range(len(items[0])))


def eval_batches(dataset, batch_size: int) -> Iterator:
    """Stack the 11-tensor `get_item_all` items of `dataset` in order into
    the batches `evaluate_on_test` takes, dropping a last partial batch
    (the JAX package's `flowcompare evaluate` batches them so)."""
    n = len(dataset) - len(dataset) % batch_size
    for start in range(0, n, batch_size):
        items = [dataset.get_item_all(i) for i in range(start, start + batch_size)]
        yield tuple(np.stack([it[j] for it in items]) for j in range(len(items[0])))
