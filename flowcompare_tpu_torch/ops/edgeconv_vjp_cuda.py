"""The training EdgeConv reduction (B6) and its plain version.

Counterpart of `flowcompare_tpu/ops/edgeconv_vjp_pallas.py::edge_knn_reduce`.
Per row i of each item, over i's exact kNN set in x (self included, ties
in index order, the same selection as B3):

    mx = max u_j    mn = min u_j    s1 = sum u_j    s2 = sum u_j^2

all (B, N, C) float32 from bf16 u. Differentiable in u only (the selection
is integer-valued; x gets a zero gradient). A max or min tied between
neighbours routes its gradient to the first of them in ascending index
order, as the Pallas kernel does (torch.max's rule).
"""

from __future__ import annotations

import torch

from . import _build
from .edgeconv_cuda import knn_indices

# Launch counter: one per forward and one per backward of the CUDA kernels.
EDGE_KNN_REDUCE_LAUNCHES = 0


def edge_knn_reduce_plain(x: torch.Tensor, u: torch.Tensor, k: int):
    """Plain version of B6: (mx, mn, s1, s2), each (B, N, C) float32."""
    idx = knn_indices(x, k).sort(-1).values    # ascending index order, as the kernel's
    # u is read at bf16 precision, as the kernel reads it; its gradient stays
    # float32, as the kernel's does (a straight-through rounding)
    ub = u.float() + (u.to(torch.bfloat16).float() - u.float()).detach()
    b, n, kk = idx.shape
    sel = torch.gather(ub, 1, idx.reshape(b, n * kk, 1).expand(b, n * kk, ub.shape[-1]))
    sel = sel.reshape(b, n, kk, -1)
    return sel.max(2).values, sel.min(2).values, sel.sum(2), (sel * sel).sum(2)


# csrc/knn_edge_reduce.cu: rows of a count block's tile, j it counts at once
REV_TILE, REV_WINDOW = 128, 8192


def reverse_lists_emulated(idx: torch.Tensor, fill_seed: int = 0) -> tuple:
    """The backward's reverse neighbour lists as its kernels build them, in
    PyTorch: idx (B, N, k) -> (off (B, N + 1), rev (B, N * k)), the list of
    j at rev[off[j]:off[j + 1]], entries i << bits | slot in increasing i
    (bits `_build.knn_slot_bits(k)`: 6 up to k = 64, 8 past it).
    knn_rev_count: per tile of REV_TILE rows and window of REV_WINDOW j,
    each entry's place among the tile's entries of its j (the shared-memory
    atomics' order: random here, from `fill_seed`), then each (tile, j)'s
    base in j's list from an atomicAdd on j's count (the tiles in a random
    order); knn_rev_scan: the counts' exclusive scan; knn_rev_place: each
    entry at off[j] + base + place; knn_rev_rank: each entry at off[j] + its
    rank among its list's entries. The lists do not depend on the atomics'
    order."""
    b, n, k = idx.shape
    sh = _build.knn_slot_bits(k)
    idx = idx.long().reshape(b, n * k)
    gen = torch.Generator().manual_seed(fill_seed)
    entry = (torch.arange(n)[:, None] << sh | torch.arange(k)[None, :]).reshape(-1)
    tile_of = torch.arange(n * k) // k // REV_TILE
    tiles = -(-n // REV_TILE)
    off = torch.zeros(b, n + 1, dtype=torch.long)
    rev = torch.empty(b, n * k, dtype=torch.long)
    for bi in range(b):
        js = idx[bi]
        pos = torch.empty(n * k, dtype=torch.long)
        count = torch.zeros(n, dtype=torch.long)
        # the count: tiles reserve their places in each j's list in the
        # atomics' order (a random order of tiles); a window at a time
        for t in torch.randperm(tiles, generator=gen).tolist():
            for w0 in range(0, n, REV_WINDOW):
                mine = ((tile_of == t) & (js >= w0) & (js < w0 + REV_WINDOW)).nonzero()[:, 0]
                mine = mine[torch.randperm(len(mine), generator=gen)]   # smem atomics' order
                sj = js[mine]
                by_j = torch.argsort(sj, stable=True)
                ranked = sj[by_j]
                place = torch.arange(len(mine)) - torch.searchsorted(ranked, ranked)
                pos[mine[by_j]] = count[ranked] + place
                count += torch.bincount(sj, minlength=n)
        off[bi, 1:] = count.cumsum(0)
        pool = torch.empty(n * k, dtype=torch.long)
        pool[off[bi, js] + pos] = entry                          # the place kernel
        owner = js[(pool >> sh) * k + (pool & (1 << sh) - 1)]    # the rank kernel
        rank = torch.zeros(n * k, dtype=torch.long)
        for q in range(int(count.max())):
            other = off[bi, owner] + q
            live = other < off[bi, owner + 1]
            rank += live & (pool[other.clamp_max(n * k - 1)] < pool)
        rev[bi, off[bi, owner] + rank] = pool
    return off, rev


def edge_knn_reduce_bwd_emulated(u: torch.Tensor, dmx: torch.Tensor, dmn: torch.Tensor,
                                 ds1: torch.Tensor, ds2: torch.Tensor, amax: torch.Tensor,
                                 amin: torch.Tensor, off: torch.Tensor,
                                 rev: torch.Tensor) -> torch.Tensor:
    """du (B, N, C) f32 as knn_edge_reduce_bwd sums it, in PyTorch: per j
    (and 64-channel slab) over its list rev[off[j]:off[j + 1]], the two
    half-warps summing entries 0, 2, 4, ... and 1, 3, 5, ... in order, each
    entry ds1_i + 2 u_j ds2_i + dmx_i [amax_i == slot] + dmn_i [amin_i ==
    slot], then the two halves added. The kernel fuses ds1 + 2 u ds2 into
    one multiply-add; here it rounds twice. u is read at bf16 precision.
    All tensors (B, N, C) but off (B, N + 1) and rev (B, N * k) from
    `reverse_lists_emulated`."""
    b, n, c = ds1.shape
    sh = _build.knn_slot_bits(rev.shape[1] // n)
    length = off[:, 1:] - off[:, :-1]                                # (B, N)
    longest = int(length.max())
    q = torch.arange(longest)
    p = off[:, :-1, None] + q                                        # (B, N, longest)
    live = q < length[..., None]
    e = rev.gather(1, torch.where(live, p, 0).reshape(b, -1)).reshape(b, n, longest)
    i, slot = e >> sh, e & (1 << sh) - 1
    uj = u.to(torch.bfloat16).float()
    acc = [torch.zeros(b, n, c), torch.zeros(b, n, c)]
    for pos in range(longest):
        sel = (torch.arange(b)[:, None], i[:, :, pos])
        g = ds1[sel] + 2.0 * uj * ds2[sel]
        g = g + torch.where(amax[sel].long() == slot[:, :, pos, None], dmx[sel], 0.0)
        g = g + torch.where(amin[sel].long() == slot[:, :, pos, None], dmn[sel], 0.0)
        acc[pos % 2] = torch.where(live[:, :, pos, None], acc[pos % 2] + g, acc[pos % 2])
    return acc[0] + acc[1]


def edge_knn_reduce_bwd_by_groups(u: torch.Tensor, dmx: torch.Tensor, dmn: torch.Tensor,
                                  ds1: torch.Tensor, ds2: torch.Tensor, amax: torch.Tensor,
                                  amin: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """du (B, N, C) as `_build.knn_edge_reduce_bwd` computes it, in PyTorch:
    the items in its groups (`_build.knn_bwd_groups`), each group's lists
    (`reverse_lists_emulated`) and sums (`edge_knn_reduce_bwd_emulated`)."""
    b, n, k = idx.shape
    du = torch.empty(ds1.shape)
    for seed, (lo, hi) in enumerate(_build.knn_bwd_groups(b, n, k)):
        r = slice(lo, hi)
        off, rev = reverse_lists_emulated(idx[r], fill_seed=seed)
        du[r] = edge_knn_reduce_bwd_emulated(u[r], dmx[r], dmn[r], ds1[r], ds2[r], amax[r],
                                             amin[r], off, rev)
    return du


def du_scale(idx: torch.Tensor, u: torch.Tensor, cots) -> torch.Tensor:
    """The scale of du as f32 sums it, for holding two orders of the sum
    against each other: per (j, channel) the sum over the rows i that
    selected j (idx (B, N, k)) of |ds1_i| + 2 |u_j| |ds2_i| + |dmx_i| +
    |dmn_i|, the magnitudes of the terms; cots = (dmx, dmn, ds1, ds2). A
    point of a large cloud may be selected by over a thousand rows."""
    dmx, dmn, ds1, ds2 = cots
    k = idx.shape[-1]
    out = []
    for i in range(len(idx)):
        flat = idx[i].reshape(-1)
        a = torch.zeros_like(ds1[i]).index_add_(
            0, flat, (ds1[i].abs() + dmx[i].abs() + dmn[i].abs()).repeat_interleave(k, 0))
        c = torch.zeros_like(ds1[i]).index_add_(0, flat, ds2[i].abs().repeat_interleave(k, 0))
        out.append(a + 2 * u[i].abs() * c)
    return torch.stack(out)


class _EdgeKnnReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, u, k):
        global EDGE_KNN_REDUCE_LAUNCHES
        b, n, cq = x.shape
        c = u.shape[-1]
        rows, dev = b * n, x.device
        xb = x.to(torch.bfloat16).contiguous().reshape(rows, cq)
        ub = u.to(torch.bfloat16).contiguous().reshape(rows, c)
        outs = [torch.empty(rows, c, dtype=torch.float32, device=dev) for _ in range(4)]
        amax = torch.empty(rows, c, dtype=torch.uint8, device=dev)
        amin = torch.empty(rows, c, dtype=torch.uint8, device=dev)
        idx = torch.empty(rows, k, dtype=torch.int32, device=dev)
        _build.knn_edge_reduce_fwd(xb, ub, *outs, amax, amin, idx, n_items=b, k=k)
        EDGE_KNN_REDUCE_LAUNCHES += 1
        ctx.save_for_backward(ub, amax, amin, idx)
        ctx.k, ctx.shape, ctx.u_dtype = k, (b, n, c), u.dtype
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        return tuple(o.reshape(b, n, c) for o in outs)

    @staticmethod
    def backward(ctx, dmx, dmn, ds1, ds2):
        global EDGE_KNN_REDUCE_LAUNCHES
        ub, amax, amin, idx = ctx.saved_tensors
        b, n, c = ctx.shape
        cots = [torch.zeros(b * n, c, dtype=torch.float32, device=ub.device) if g is None
                else g.reshape(b * n, c).float().contiguous() for g in (dmx, dmn, ds1, ds2)]
        du = torch.empty(b * n, c, dtype=torch.float32, device=ub.device)
        _build.knn_edge_reduce_bwd(ub, *cots, amax, amin, idx, du, n_items=b, k=ctx.k)
        EDGE_KNN_REDUCE_LAUNCHES += 1
        dx = None
        if ctx.needs_input_grad[0]:   # the selection is integer-valued: x gets zeros
            dx = torch.zeros(ctx.x_shape, dtype=ctx.x_dtype, device=ub.device)
        return dx, du.reshape(b, n, c).to(ctx.u_dtype), None


def edge_knn_reduce(x: torch.Tensor, u: torch.Tensor, k: int):
    """B6: (mx, mn, s1, s2) of u over each row's exact kNN in x; replaces the
    Pallas kernels of `edge_knn_reduce` (edgeconv_vjp_pallas.py, `_fwd_kernel`
    and `_bwd_kernel`).

    x (B, N, Cq), u (B, N, C <= 256), 1 <= k <= min(N, 256) (the first
    max / min slots are bytes; past k = 64 the selection is the radix
    select alone). A CPU tensor runs
    `edge_knn_reduce_plain`; a CUDA tensor runs csrc/knn_edge_reduce.cu
    inside an autograd.Function: the forward kernel selects as B3 does
    (tensor-core distance rows in shared memory, one sweep under the pool's
    threshold, ties in index order; the rows walked in chunks past 3,200
    points) and writes mx, mn, s1, s2, the first
    max/min slots and the selected indices; the backward builds per-item
    reverse neighbour lists across the card (a counting sort by j with
    integer atomics on the counts, each list then ordered by i:
    `reverse_lists_emulated`) and sums each u row's gradient over its list
    in a fixed order (`edge_knn_reduce_bwd_emulated`), with no atomics on
    the sums, so it is deterministic.

    What bounds it on the H100: the forward, like B3, by the gathers of u
    from L2, plus its five outputs; the backward by the gathers of the
    selecting rows' ds1 and ds2 (k times per row, from L2: a random cloud's
    lists share no tile) and their slot bytes; dmx and dmn are read only
    where a slot matches. The TPU kernel's (B, N, N) rank matrix is not
    kept: the saved state is the (B, N, k) indices and two byte-wide slot
    maps. The lists take 2 n + 1 + 2 n k ints of scratch an item and no
    shared memory that grows with n, so any cloud and batch run; the batch
    runs in groups of items (`_build.knn_bwd_groups`:
    `edge_knn_reduce_bwd_by_groups`)."""
    if not x.is_cuda:
        return edge_knn_reduce_plain(x, u, k)
    return _EdgeKnnReduce.apply(x, u, k)
