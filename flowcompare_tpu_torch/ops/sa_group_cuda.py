"""PAConv set-abstraction grouping (B9) and its plain version.

Counterpart of the Pallas kernel
`flowcompare_tpu/ops/sa_group_pallas.py::sa_group_fused`, the eval grouping
of `flowcompare_tpu/encoders/paconv.py::_sa_level`. For each FPS centre: its
exact k nearest points by f32 squared distance with the centre pinned to
slot 0, slots 1..k-1 in ascending index order (the Pallas kernel's slot
convention; everything downstream, the per-slot ScoreNet and weight bank and
the max over slots, is invariant to the order past slot 0), point 0 in the
slots past N when k > N, and the output [x_p - centre (f32, then cast) |
feats_p] in the features' dtype.
"""

from __future__ import annotations

import torch

from . import _build
from .knn import gather_neighbors, knn_indices

# Launch counter of the sa_group kernel, bumped at its one launch site.
SA_GROUP_LAUNCHES = 0


def sa_group_plain(new_xyz: torch.Tensor, idx: torch.Tensor, xyz: torch.Tensor,
                   feats: torch.Tensor, k: int) -> torch.Tensor:
    """The grouping in plain PyTorch: `knn_indices(self_idx=idx)`, the
    selected neighbours (slots 1..min(k, N)-1) re-sorted by index, gathers."""
    n = xyz.shape[1]
    knn = knn_indices(new_xyz, xyz, k, self_idx=idx)
    r = min(k, n)
    knn = torch.cat([knn[..., :1], knn[..., 1:r].sort(-1).values, knn[..., r:]], -1)
    diff = gather_neighbors(xyz.float(), knn) - new_xyz.float()[:, :, None, :]
    return torch.cat([diff.to(feats.dtype), gather_neighbors(feats, knn)], -1)


def sa_group(new_xyz: torch.Tensor, idx: torch.Tensor, xyz: torch.Tensor, feats: torch.Tensor,
             k: int) -> torch.Tensor:
    """B9: new_xyz (B, M, 3) centres, idx (B, M) their indices in xyz
    (B, N, 3), feats (B, N, C) -> (B, M, k, 3 + C) in feats' dtype; replaces
    the Pallas kernel `sa_group_fused` (sa_group_pallas.py:126).

    A CPU tensor runs `sa_group_plain`; a CUDA tensor launches `sa_group`
    (csrc/sa_group.cu): a block of 8 warps per 8 centres of one item, the
    item's points in shared memory, one distance row per warp, the exact
    selection of knn_select.cuh with the centre pinned, and a warp-coalesced
    row gather into the output. Bound on the H100 by the output bytes and
    the selection's search sweeps over shared memory. A centre index outside
    [0, N) gives NaN rows (checking it on the host would synchronise)."""
    global SA_GROUP_LAUNCHES
    if not xyz.is_cuda:
        return sa_group_plain(new_xyz, idx, xyz, feats, k)
    b, mc, _ = new_xyz.shape
    out = torch.empty(b, mc, k, 3 + feats.shape[-1], dtype=feats.dtype, device=xyz.device)
    _build.sa_group(new_xyz.float().contiguous(), idx.long().contiguous(),
                    xyz.float().contiguous(), feats.contiguous(), out, k=k)
    SA_GROUP_LAUNCHES += 1
    return out
