"""The port's point-cloud ops and its hand-written kernels' wrappers.

Counterpart of `flowcompare_tpu/ops/__init__.py`: the same sixteen names
(FPS, kNN and ball query, the neighbour gathers and interpolations, the
label statistics, PAConv's weight-bank product, voxelization). The kernels'
modules (`*_cuda.py`, `_build.py`) are imported by name.
"""

from .fps import fps_subsample, furthest_point_sampling
from .knn import (
    ball_query,
    gather_neighbors,
    knn_indices,
    knn_self,
    nearest_neighbor_gather,
    pairwise_sqdist,
    three_nn_interpolate,
)
from .labelstat import labelstat_and_ballquery, labelstat_ballrange, labelstat_idx
from .paconv_ops import paconv_assign_score
from .voxelize import all_voxel_centers, voxel_occupancy, voxelize

__all__ = [
    "fps_subsample", "furthest_point_sampling",
    "ball_query", "gather_neighbors", "knn_indices", "knn_self",
    "nearest_neighbor_gather", "pairwise_sqdist", "three_nn_interpolate",
    "paconv_assign_score",
    "labelstat_and_ballquery", "labelstat_ballrange", "labelstat_idx",
    "all_voxel_centers", "voxel_occupancy", "voxelize",
]
