"""The port's data layer: loaders, LAS/LAZ IO and the host transforms.

Counterpart of `flowcompare_tpu/data/`, without JAX: the same items, packs,
LAZ bytes and pickle caches as the JAX package's modules, over the port's
own native ops (`flowcompare_tpu_torch/native/`). `eval_batches` stacks
`get_item_all` items into the 11-tensor batches `evaluate_on_test` takes.
"""

from .ams_voxel_loader import AmsVoxelLoader, Scan, batch_iterator, eval_batches, filter_scans
from .challenge_loader import ChallengeDataset
from .las_io import load_cloud, load_las, save_las
from .laz import LazError, load_cloud_laz, read_laz, write_laz
from .packed import PackedVoxelDataset, pack_dataset, write_packed
from .prefetch import PrefetchedDataset, PrefetchIterator
from .synthetic import SyntheticVoxelDataset
from .transforms import (
    co_unit_sphere,
    extract_area,
    fps_numpy,
    get_voxel,
    np_co_unit_sphere,
    oversample_cloud,
    random_subsample,
    unit_sphere,
)

__all__ = [
    "AmsVoxelLoader", "Scan", "batch_iterator", "eval_batches", "filter_scans",
    "ChallengeDataset", "load_cloud", "load_las", "save_las",
    "LazError", "load_cloud_laz", "read_laz", "write_laz",
    "PrefetchedDataset", "PrefetchIterator",
    "PackedVoxelDataset", "pack_dataset", "write_packed",
    "SyntheticVoxelDataset",
    "co_unit_sphere", "extract_area", "fps_numpy", "get_voxel",
    "np_co_unit_sphere", "oversample_cloud", "random_subsample", "unit_sphere",
]
