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
from .knn import row_blocks

# Launch counter of the knn_edge_max kernel, bumped at its one launch site
# (the B3 wrapper and the B4 encoder chain both launch through it).
EDGE_NEIGHBOR_MAX_LAUNCHES = 0


def knn_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, Cq) -> int64 (B, N, k): each row's exact kNN by f32 distances
    from bf16 features, nearest first, equal distances in index order (the
    kernels' selection, in plain PyTorch), the rows sorted a block at a time
    (`knn.row_blocks`: at most `knn.SORT_BYTES` of sort a block)."""
    xf = x.detach().to(torch.bfloat16).float()
    nrm = (xf * xf).sum(-1)
    b, n, _ = xf.shape
    parts = []
    for rows in row_blocks(n, n, b):
        d = (nrm[:, rows, None] - 2.0 * torch.matmul(xf[:, rows], xf.transpose(1, 2))
             + nrm[:, None, :]).clamp_min(0.0)
        # a copy: a view would keep the block's whole (B, rows, N) sort alive
        parts.append(torch.sort(d, dim=-1, stable=True).indices[..., :k].contiguous())
    return parts[0] if len(parts) == 1 else torch.cat(parts, 1)


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


def _chunks(n: int, chunk) -> list:
    """The column ranges of the kernels' walk over a row of n: one range with
    whole rows (chunk None), else CHUNK columns at a time."""
    if chunk is None:
        return [(0, n)]
    if chunk % 8:
        raise ValueError(f"a chunk is whole 8-column tiles (got {chunk} columns)")
    return [(c0, min(c0 + chunk, n)) for c0 in range(0, n, chunk)]


def radix_select_emulated(bits: torch.Tensor, k: int, chunk=None) -> tuple:
    """The kernels' fallback selection (knn_select.cuh `radix_select`, for
    rows whose ties crowd the pool's threshold) step for step in PyTorch,
    rows of `bits` (R, n) int64 in parallel:
    per pass a 256-bin histogram of the next digit over the entries whose
    higher bits match the digits found so far, the first bin whose running
    count reaches the rank still needed, and a stop as soon as that bin
    holds exactly the entries still needed; then the admit pass (keys below
    the prefix, then ties at it in index order). Entries with bit 31 set are
    never counted or taken. With `chunk` the histograms and the admit pass
    walk the row chunk by chunk (`select_chunked`'s fallback: the ties'
    running count carried across chunks). -> (indices (R, k) int64
    ascending, sweeps (R,) over each row: the histogram passes and the admit
    pass)."""
    rows, n = bits.shape
    dev = bits.device
    spans = _chunks(n, chunk)
    prefix = torch.zeros(rows, dtype=torch.long, device=dev)
    shift = torch.full((rows,), 31, dtype=torch.long, device=dev)
    need = torch.full((rows,), k, dtype=torch.long, device=dev)
    passes = torch.zeros(rows, dtype=torch.long, device=dev)
    active = torch.ones(rows, dtype=torch.bool, device=dev)
    for width in RADIX_DIGITS:
        nshift = shift - width
        hist = torch.zeros(rows, 256, dtype=torch.long, device=dev)
        for c0, c1 in spans:
            part = bits[:, c0:c1]
            match = ((part >> shift[:, None]) == prefix[:, None]) & active[:, None]
            digit = torch.where(match, (part >> nshift[:, None]) & ((1 << width) - 1), 0)
            hist.scatter_add_(1, digit, match.long())
        cum = hist.cumsum(1)
        found = (cum < need[:, None]).sum(1).clamp_max(255)      # first bin reaching need
        below = torch.where(found > 0, cum.gather(1, (found - 1).clamp_min(0)[:, None])[:, 0], 0)
        cnt = hist.gather(1, found[:, None])[:, 0]
        prefix = torch.where(active, (prefix << width) | found, prefix)
        shift = torch.where(active, nshift, shift)
        need = torch.where(active, need - below, need)
        passes = passes + active.long()
        active = active & (cnt != need)
    take, nties = [], torch.zeros(rows, dtype=torch.long, device=dev)
    for c0, c1 in spans:
        key = bits[:, c0:c1] >> shift[:, None]
        tie = key == prefix[:, None]
        take.append((key < prefix[:, None]) | (tie & (nties[:, None] + tie.long().cumsum(1)
                                                      <= need[:, None])))
        nties = nties + tie.long().sum(1)
    order = torch.where(torch.cat(take, 1), torch.arange(n, device=dev), n)
    return order.sort(1).values[:, :k], passes + 1


# Candidates a warp holds before it falls back to the radix select
# (knn_select.cuh CAP).
SELECT_CAP = 256
# Columns of a chunk of the kernels' walk over rows that do not fit shared
# memory whole (knn_select.cuh CHUNK).
KNN_CHUNK = 1024
# knn_select.cuh: query rows a block, warps, pool entries a row (the pool's
# largest k, and a list's entries: a list past it lies in the upper half of
# its warp's candidates, beside the radix select's 256-bin histogram)
_QR, _WARPS, _POOL = 16, 8, 64


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def whole_smem_bytes(n: int, cq: int) -> int:
    """B3's and B6's shared memory with whole distance rows (knn_select.cuh
    `whole_smem_bytes`), the same at every k: 16 f32 distance rows padded to
    8 mod 32 words, a pool of 64 a row, 16 bf16 query rows of whole
    16-feature steps plus 8, and per warp 2 x 256 words of candidates and a
    list of 64."""
    return (4 * _QR * (_up(n, 32) + 8) + 4 * _QR * _POOL + 2 * _QR * (_up(cq, 16) + 8)
            + 4 * _WARPS * 2 * SELECT_CAP + 4 * _WARPS * _POOL)


def chunked_smem_bytes(cq: int) -> int:
    """The chunked walk's (`chunked_smem_bytes`): the rows of one chunk, and
    per warp the candidates and lists of its two rows."""
    rpw = _QR // _WARPS
    return (4 * _QR * (KNN_CHUNK + 8) + 4 * _QR * _POOL + 2 * _QR * (_up(cq, 16) + 8)
            + 4 * _WARPS * rpw * 2 * SELECT_CAP + 4 * _WARPS * rpw * _POOL)


def knn_chunk(n: int, cq: int):
    """The kernels' walk for clouds of n points of cq features, at any k:
    None (whole rows in shared memory, up to 3,200 points at 128 features)
    or KNN_CHUNK."""
    return None if whole_smem_bytes(n, cq) <= _build.SMEM_LIMIT else KNN_CHUNK


def knn_smem_bytes(n: int, cq: int) -> int:
    """B3's and B6's shared memory a block (`fc_knn_edge_max_smem`)."""
    return whole_smem_bytes(n, cq) if knn_chunk(n, cq) is None else chunked_smem_bytes(cq)


def pool_sources(n: int, chunk=None) -> torch.Tensor:
    """The pool source of each of n columns in B3's and B6's kernels: the
    warp that computes its tile and the lane quad within it. A walk's warps
    count the tiles from the start of its range: the whole row, or each
    chunk of `chunk` columns; the library's CHUNK is whole 64-column rounds,
    where the two agree."""
    j = torch.arange(n)
    if chunk is not None:
        j = j % chunk
    return (j // 8 % 8) * 4 + (j % 8) // 2


def _pool_kth(bits: torch.Tensor, live: torch.Tensor, sources: torch.Tensor, k: int):
    """The k-th smallest of the pool: each of 32 sources' two smallest live
    entries of `bits` (all ones where a source has fewer)."""
    full = 0xFFFFFFFF
    pool = []
    for src in range(32):
        vals = torch.where(live & (sources.to(bits.device) == src), bits, full)
        vals = torch.cat([vals, torch.full_like(vals[:, :2], full)], 1)
        pool.append(vals.topk(2, dim=1, largest=False).values)
    return torch.cat(pool, 1).sort(1).values[:, k - 1]


def knn_select_emulated(bits: torch.Tensor, k: int, sources: torch.Tensor,
                        chunk=None) -> tuple:
    """The kernels' selection (knn_select.cuh `select_row`) step for step in
    PyTorch, rows of `bits` (R, n) int64 in parallel: the pool (each of 32
    sources' two smallest entries, all-ones where a source has fewer), t its
    k-th smallest, the candidates d <= t, the k smallest of them by (d,
    index); rows with more than SELECT_CAP candidates take
    `radix_select_emulated`, and so does every row past the pool (k > 64),
    with no pool walk before it. Entries with bit 31 set are never taken.

    With `chunk` (whole 8-column tiles) the row is walked as
    `select_chunked` walks it, in one pass with a falling threshold: after
    each chunk the pool of the chunks so far, the candidates above its k-th
    smallest dropped and the chunk's entries under it added; a row whose
    candidates ever pass SELECT_CAP falls back (to the radix select over
    the chunks). It ends with the candidates d <= t of the whole row's
    pool. `sources` are the walk's (`pool_sources`).
    -> (indices (R, k) int64 ascending, walks (R,) over each row: one, the
    fallback's passes added (past the pool the radix select's alone);
    candidates (R,): the most a row held at once, past the cap as counted
    (none past the pool))."""
    rows, n = bits.shape
    most = torch.zeros(rows, dtype=torch.long, device=bits.device)
    if k > _POOL:
        idx, sweeps = radix_select_emulated(bits, k, chunk)
        return idx, sweeps, most
    live = (bits >> 31) == 0
    for c0, c1 in _chunks(n, chunk):
        t = _pool_kth(bits[:, :c1], live[:, :c1], sources[:c1], k)
        count = (live[:, :c1] & (bits[:, :c1] <= t[:, None])).sum(1)   # kept, and the chunk's
        most = torch.maximum(most, count)
    cand = live & (bits <= t[:, None])
    key = torch.where(cand, bits, 1 << 33)
    idx = torch.sort(key, dim=1, stable=True).indices[:, :k].sort(1).values
    sweeps = torch.ones(rows, dtype=torch.long, device=bits.device)
    fallback = most > SELECT_CAP
    if bool(fallback.any()):
        ridx, rsw = radix_select_emulated(bits[fallback], k, chunk)
        idx[fallback] = ridx
        sweeps[fallback] += rsw
    return idx, sweeps, most


def knn_indices_emulated(x: torch.Tensor, k: int, chunk="kernel") -> torch.Tensor:
    """(B, N, Cq) -> int64 (B, N, k): each row's exact kNN as the kernels
    select it (`knn_select_emulated` on `distance_bits`), ascending; the
    walk the kernels take at this shape (`knn_chunk`) unless `chunk` names
    one (None: whole rows)."""
    b, n, cq = x.shape
    if chunk == "kernel":
        chunk = knn_chunk(n, _up(cq, 2))
    idx, _, _ = knn_select_emulated(distance_bits(x).reshape(b * n, n), k,
                                    pool_sources(n, chunk), chunk)
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
    select where ties crowd that threshold, and for every row once k passes
    the pool's 64; `knn_select_emulated` is the same algorithm in PyTorch),
    ties in index order, and gathers the k selected rows of u 16 bytes a
    lane. Takes 1 <= k <= min(N, 256). Clouds whose 16 distance rows do
    not fit shared memory (past 3,200 points at 128 features, `knn_chunk`)
    walk the rows in chunks of KNN_CHUNK columns, one pass with a falling
    threshold: the same selection. Bound on the H100 by
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
