"""EdgeConv's exact-kNN neighbourhood max (B3) and its plain version.

Counterpart of `flowcompare_tpu/ops/edgeconv_pallas.py::edge_neighbor_max`.
For each row i of each item: the k nearest rows j of x (self included) by
d = max(|x_i|^2 - 2 x_i.x_j + |x_j|^2, 0) computed in f32 from bf16
features, ties taken in index order, and mx_i = max over those j of u_j.
With u = sign(BN slope) * (x @ W_diff) this is the whole neighbourhood
reduction of an eval EdgeConv stage (see `encoders/dgcnn.py::fused_edge_stage`).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

# Launch counter of the knn_edge_max kernel, bumped at its one launch site
# (the B3 wrapper and the B4 encoder chain both launch through it).
EDGE_NEIGHBOR_MAX_LAUNCHES = 0


def edge_neighbor_max_plain(x: torch.Tensor, u: torch.Tensor, k: int) -> torch.Tensor:
    """x (B, N, Cq), u (B, N, Cout) -> (B, N, Cout) bf16, in plain PyTorch."""
    xf = x.to(torch.bfloat16).float()
    nrm = (xf * xf).sum(-1)
    d = (nrm[:, :, None] - 2.0 * torch.matmul(xf, xf.transpose(1, 2))
         + nrm[:, None, :]).clamp_min(0.0)
    idx = torch.sort(d, dim=-1, stable=True).indices[..., :k]          # (B, N, k)
    ub = u.to(torch.bfloat16)
    b, n, kk = idx.shape
    gathered = torch.gather(ub, 1, idx.reshape(b, n * kk, 1).expand(b, n * kk, ub.shape[-1]))
    return gathered.reshape(b, n, kk, -1).amax(2)


def launch_knn_edge_max(x2d: torch.Tensor, u2d: torch.Tensor, out2d: torch.Tensor, *,
                        n_items: int, k: int, epilogue: Optional[tuple] = None) -> None:
    """Launch the knn_edge_max kernel on (items * n, C) row-major matrices."""
    global EDGE_NEIGHBOR_MAX_LAUNCHES
    _build.knn_edge_max(x2d, u2d, out2d, n_items=n_items, k=k, epilogue=epilogue)
    EDGE_NEIGHBOR_MAX_LAUNCHES += 1


def edge_neighbor_max(x: torch.Tensor, u: torch.Tensor, k: int) -> torch.Tensor:
    """B3: per-row max of u over the exact kNN set of x; replaces the Pallas
    kernel `edge_neighbor_max` (edgeconv_pallas.py, selection
    `_knn_select_ranks`, extraction `_knn_extract_max`).

    x (B, N, Cq), u (B, N, Cout) -> (B, N, Cout) bf16. A CPU tensor runs
    `edge_neighbor_max_plain`; a CUDA tensor launches `knn_edge_max`
    (csrc/knn_edge_max.cu): one block per 16 query rows keeps their distance
    rows in shared memory, finds each row's exact k-th distance by a binary
    search on its bit pattern, admits ties in index order and gathers the k
    selected rows of u. Bound on the H100 by the N^2 * Cq distance FMAs on
    CUDA cores and the 31 search sweeps over shared memory per row."""
    if not x.is_cuda:
        return edge_neighbor_max_plain(x, u, k)
    b, n, cq = x.shape
    cout = u.shape[-1]
    xb = x.to(torch.bfloat16).contiguous().reshape(b * n, cq)
    ub = u.to(torch.bfloat16).contiguous().reshape(b * n, cout)
    out = torch.empty(b * n, cout, dtype=torch.bfloat16, device=x.device)
    launch_knn_edge_max(xb, ub, out, n_items=b, k=k)
    return out.reshape(b, n, cout)
