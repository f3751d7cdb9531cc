"""The conditioning encoders: DGCNN (per point and global) and PAConv
(counterpart of `flowcompare_tpu/encoders/__init__.py`)."""

from .dgcnn import apply_dgcnn, edge_features, init_dgcnn
from .paconv import apply_pointnet2_paconv, init_pointnet2_paconv

__all__ = [
    "apply_dgcnn", "edge_features", "init_dgcnn",
    "apply_pointnet2_paconv", "init_pointnet2_paconv",
]
