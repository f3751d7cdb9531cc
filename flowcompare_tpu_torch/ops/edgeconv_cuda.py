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


def knn_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, Cq) -> int64 (B, N, k): each row's exact kNN by f32 distances
    from bf16 features, nearest first, equal distances in index order (the
    kernels' selection, in plain PyTorch)."""
    xf = x.detach().to(torch.bfloat16).float()
    nrm = (xf * xf).sum(-1)
    d = (nrm[:, :, None] - 2.0 * torch.matmul(xf, xf.transpose(1, 2))
         + nrm[:, None, :]).clamp_min(0.0)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


# The radix select's digits, from bit 30 down (csrc/knn_select.cuh select_row).
RADIX_DIGITS = (8, 8, 8, 7)


def distance_bits(x: torch.Tensor) -> torch.Tensor:
    """(B, N, Cq) -> int64 (B, N, N): the f32 bit patterns of the distances
    the kernels select on, max(|x_i|^2 - 2 x_i.x_j + |x_j|^2, +0) from bf16
    features (+0, never -0; the tensor cores' order of the f32 sums aside)."""
    xf = x.detach().to(torch.bfloat16).float()
    nrm = (xf * xf).sum(-1)
    d = (nrm[:, :, None] - 2.0 * torch.matmul(xf, xf.transpose(1, 2))) + nrm[:, None, :]
    d = torch.where(d > 0, d, d.new_zeros(()))
    return d.contiguous().view(torch.int32).long()


def radix_select_emulated(bits: torch.Tensor, k: int) -> tuple:
    """The kernels' fallback selection (knn_select.cuh `radix_select`, for
    rows whose ties crowd the pool's threshold) step for step in PyTorch,
    rows of `bits` (R, n) int64 in parallel:
    per pass a 256-bin histogram of the next digit over the entries whose
    higher bits match the digits found so far, the first bin whose running
    count reaches the rank still needed, and a stop as soon as that bin
    holds exactly the entries still needed; then the admit pass (keys below
    the prefix, then ties at it in index order). Entries with bit 31 set are
    never counted or taken. -> (indices (R, k) int64 ascending, sweeps (R,)
    over each row: the histogram passes and the admit pass)."""
    rows, n = bits.shape
    dev = bits.device
    prefix = torch.zeros(rows, dtype=torch.long, device=dev)
    shift = torch.full((rows,), 31, dtype=torch.long, device=dev)
    need = torch.full((rows,), k, dtype=torch.long, device=dev)
    passes = torch.zeros(rows, dtype=torch.long, device=dev)
    active = torch.ones(rows, dtype=torch.bool, device=dev)
    for width in RADIX_DIGITS:
        nshift = shift - width
        match = ((bits >> shift[:, None]) == prefix[:, None]) & active[:, None]
        digit = torch.where(match, (bits >> nshift[:, None]) & ((1 << width) - 1), 0)
        hist = torch.zeros(rows, 256, dtype=torch.long, device=dev).scatter_add_(1, digit,
                                                                                 match.long())
        cum = hist.cumsum(1)
        found = (cum < need[:, None]).sum(1).clamp_max(255)      # first bin reaching need
        below = torch.where(found > 0, cum.gather(1, (found - 1).clamp_min(0)[:, None])[:, 0], 0)
        cnt = hist.gather(1, found[:, None])[:, 0]
        prefix = torch.where(active, (prefix << width) | found, prefix)
        shift = torch.where(active, nshift, shift)
        need = torch.where(active, need - below, need)
        passes = passes + active.long()
        active = active & (cnt != need)
    key = bits >> shift[:, None]
    tie = key == prefix[:, None]
    take = (key < prefix[:, None]) | (tie & (tie.long().cumsum(1) <= need[:, None]))
    order = torch.where(take, torch.arange(n, device=dev), n)
    return order.sort(1).values[:, :k], passes + 1


# Candidates a warp holds before it falls back to the radix select
# (knn_select.cuh CAP).
SELECT_CAP = 256


def pool_sources(n: int) -> torch.Tensor:
    """The pool source of each of n columns in B3's and B6's kernels: the
    warp that computes its tile (tile % 8) and the lane quad within it."""
    j = torch.arange(n)
    return (j // 8 % 8) * 4 + (j % 8) // 2


def knn_select_emulated(bits: torch.Tensor, k: int, sources: torch.Tensor) -> tuple:
    """The kernels' selection (knn_select.cuh `select_row`) step for step in
    PyTorch, rows of `bits` (R, n) int64 in parallel: the pool (each of 32
    sources' two smallest entries, all-ones where a source has fewer), t its
    k-th smallest, the candidates d <= t, the k smallest of them by (d,
    index); rows with more than SELECT_CAP candidates take
    `radix_select_emulated`. Entries with bit 31 set are never taken.
    -> (indices (R, k) int64 ascending, sweeps (R,) over each row,
    candidates (R,))."""
    rows, n = bits.shape
    full = 0xFFFFFFFF
    live = (bits >> 31) == 0
    pool = []
    for src in range(32):
        vals = torch.where(live & (sources.to(bits.device) == src), bits, full)
        vals = torch.cat([vals, torch.full_like(vals[:, :2], full)], 1)
        pool.append(vals.topk(2, dim=1, largest=False).values)
    t = torch.cat(pool, 1).sort(1).values[:, k - 1]
    cand = live & (bits <= t[:, None])
    count = cand.sum(1)
    key = torch.where(cand, bits, 1 << 33)
    idx = torch.sort(key, dim=1, stable=True).indices[:, :k].sort(1).values
    sweeps = torch.ones(rows, dtype=torch.long, device=bits.device)
    fallback = count > SELECT_CAP
    if bool(fallback.any()):
        ridx, rsw = radix_select_emulated(bits[fallback], k)
        idx[fallback] = ridx
        sweeps[fallback] += rsw
    return idx, sweeps, count


def knn_indices_emulated(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, Cq) -> int64 (B, N, k): each row's exact kNN as the kernels
    select it (`knn_select_emulated` on `distance_bits`), ascending."""
    b, n, _ = x.shape
    idx, _, _ = knn_select_emulated(distance_bits(x).reshape(b * n, n), k, pool_sources(n))
    return idx.reshape(b, n, k)


def edge_neighbor_max_plain(x: torch.Tensor, u: torch.Tensor, k: int) -> torch.Tensor:
    """x (B, N, Cq), u (B, N, Cout) -> (B, N, Cout) bf16, in plain PyTorch."""
    idx = knn_indices(x, k)                                             # (B, N, k)
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
    (csrc/knn_edge_max.cu): one block per 16 query rows computes their
    distance rows on the tensor cores (mma.sync, bf16 products exact in f32)
    into shared memory with a pool of 64 entries a row, takes the entries at
    or below the pool's k-th smallest in one sweep and ranks them (a radix
    select where ties crowd that threshold; `knn_select_emulated` is the
    same algorithm in PyTorch), ties in index order, and gathers the k
    selected rows of u 16 bytes a lane. Bound on the H100 by
    those gathers from L2 (k rows of u a query row) and the candidate rows'
    re-reads from L2; the products and the selection are the smaller part."""
    if not x.is_cuda:
        return edge_neighbor_max_plain(x, u, k)
    b, n, cq = x.shape
    cout = u.shape[-1]
    xb = x.to(torch.bfloat16).contiguous().reshape(b * n, cq)
    ub = u.to(torch.bfloat16).contiguous().reshape(b * n, cout)
    out = torch.empty(b * n, cout, dtype=torch.bfloat16, device=x.device)
    launch_knn_edge_max(xb, ub, out, n_items=b, k=k)
    return out.reshape(b, n, cout)
