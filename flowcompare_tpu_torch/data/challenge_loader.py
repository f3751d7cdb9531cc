"""Labelled change-detection evaluation dataset.

Counterpart of `flowcompare_tpu/data/challenge_loader.py`, with its CSV
read by the `csv` module instead of pandas: the same rows in the same
order, the same filter on `classification`. Like the original FlowCompare
`dataloaders/challenge_loader.py`, an eval-only dataset over CSV-labelled
locations {nochange, removed, added, change, color_change}. Per scene: a
two-epoch cloud pair is co-registered once (offline, cached), then each
labelled (x, y) yields a COLUMN of z-stacked voxels — per voxel, both
conditioning directions' context/target crops FPS-resampled to fixed
sizes, with a mean-point dummy when a voxel is empty.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Dict, List

import numpy as np

from .las_io import load_cloud
from .registration import registration_pipeline
from .transforms import extract_area, fps_numpy, get_voxel

CLASS_LABELS = ["nochange", "removed", "added", "change", "color_change"]


class ChallengeDataset:
    def __init__(self, csv_path: str, directories_list: List[str],
                 out_path: str, *, n_samples: int = 2000,
                 n_samples_context: int = 2048, preload: bool = False,
                 context_voxel_size=(3.0, 3.0, 4.0),
                 final_voxel_size=(3.0, 3.0, 4.0),
                 voxel_size: float = 0.07, seed: int = 0):
        self.n_samples = n_samples
        self.n_samples_context = n_samples_context
        self.context_voxel_size = np.asarray(context_voxel_size, np.float64)
        self.final_voxel_size = np.asarray(final_voxel_size, np.float64)
        self.voxel_size = voxel_size
        self.class_labels = list(CLASS_LABELS)
        self.class_int_dict = {c: i for i, c in enumerate(self.class_labels)}
        self.int_class_dict = {i: c for c, i in self.class_int_dict.items()}
        self._rng = np.random.default_rng(seed)

        with open(csv_path, newline="") as f:
            rows = [row for row in csv.DictReader(f)
                    if row["classification"] in self.class_int_dict]

        # scene id -> [year0 path, year1 path]; files named "<scene>_*.las"
        scene_dicts = []
        for year_path in directories_list:
            d = {}
            for fname in os.listdir(year_path):
                if fname.split(".")[-1] in ("las", "laz", "npz", "npy"):
                    d[int(os.path.basename(fname).split("_")[0])] = (
                        os.path.join(year_path, fname))
            scene_dicts.append(d)
        combined = {k: [scene_dicts[0][k], scene_dicts[1][k]]
                    for k in scene_dicts[0] if k in scene_dicts[1]}

        os.makedirs(out_path, exist_ok=True)
        save_path = os.path.join(out_path, f"challenge_{voxel_size}.pkl")
        if preload and os.path.isfile(save_path):
            with open(save_path, "rb") as f:
                self.loaded_clouds = pickle.load(f)
        else:
            self.loaded_clouds: Dict[int, list] = {}
            for scene_num, paths in combined.items():
                clouds = [load_cloud(p) for p in paths]
                registered = registration_pipeline(
                    clouds, voxel_size_icp=0.05, voxel_size_final=voxel_size)
                self.loaded_clouds[scene_num] = [
                    c.astype(np.float32) for c in registered]
            with open(save_path, "wb") as f:
                pickle.dump(self.loaded_clouds, f)

        self.pair_dict = {}
        for pair_id, row in enumerate(rows):
            self.pair_dict[pair_id] = [
                int(float(row["scene"])),
                np.asarray([float(row["x"]), float(row["y"])], np.float64),
                self.class_int_dict[row["classification"]],
            ]

    def __len__(self) -> int:
        return len(self.pair_dict)

    def _fps_or_dummy(self, voxel: np.ndarray, fallback: np.ndarray,
                      n: int) -> np.ndarray:
        if voxel.shape[0] == 0:
            # empty voxel: single mean dummy point (challenge_loader.py:80-97)
            return fallback.mean(axis=0, keepdims=True).astype(np.float32)
        return fps_numpy(voxel, n, self._rng)[:n]

    def get_voxels(self, cloud, context_cloud, vox_center):
        """(context_from_other, target, self_context) for one voxel
        (challenge_loader.py:73-107)."""
        voxel_1 = get_voxel(cloud, vox_center, self.final_voxel_size)
        voxel_0 = get_voxel(context_cloud, vox_center, self.context_voxel_size)
        voxel_1 = self._fps_or_dummy(voxel_1, voxel_0, self.n_samples)
        voxel_1_1 = get_voxel(cloud, vox_center, self.context_voxel_size)
        voxel_1_1 = self._fps_or_dummy(voxel_1_1, voxel_1, self.n_samples_context)
        voxel_0 = self._fps_or_dummy(voxel_0, voxel_1, self.n_samples_context)
        return voxel_0, voxel_1, voxel_1_1

    def voxel_center_heights(self, z_min: float, z_max: float) -> List[float]:
        h = float(self.final_voxel_size[2])
        heights = [z_min + h / 2]
        while heights[-1] + h / 2 < z_max:
            heights.append(min(heights[-1] + h, z_max))
        return heights

    def __getitem__(self, idx: int):
        scene_num, center, label = self.pair_dict[idx]
        cloud_0, cloud_1 = [
            c[extract_area(c, center, float(self.context_voxel_size[0]),
                           "square")]
            for c in self.loaded_clouds[scene_num]]
        z_max = max(cloud_0[:, 2].max(), cloud_1[:, 2].max())
        z_min = min(cloud_0[:, 2].min(), cloud_1[:, 2].min())
        voxels = {}
        for i, zc in enumerate(self.voxel_center_heights(z_min, z_max)):
            vox_center = np.concatenate([center, [zc]])
            ctx_for_1, voxel_1, ctx_0_0 = self.get_voxels(
                cloud_1, cloud_0, vox_center)
            ctx_for_0, voxel_0, ctx_1_1 = self.get_voxels(
                cloud_0, cloud_1, vox_center)
            voxels[i] = [ctx_for_1, voxel_1, ctx_0_0, ctx_for_0, voxel_0,
                         ctx_1_1, zc]
        return {"voxels": voxels, "cloud_0": cloud_0, "cloud_1": cloud_1}, label
