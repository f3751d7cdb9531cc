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


# Rows of a reverse-list tile (csrc/knn_edge_reduce.cu REV_ROWS).
REV_ROWS = 64


def reverse_lists_tiled(idx: torch.Tensor, tile: int = REV_ROWS) -> tuple:
    """The backward's reverse neighbour lists as its three kernels build
    them, in PyTorch: idx (B, N, k) -> (off (B, N + 1), rev (B, N * k)), the
    list of j at rev[off[j]:off[j + 1]], entries i << 6 | slot in increasing
    i. knn_rev_count counts per tile of `tile` rows how many rows selected
    each j; knn_rev_scan scans those counts over the tiles and the totals
    over j; knn_rev_fill walks each tile's rows in increasing i and appends
    at j's cursor (here: an entry's place among its tile's entries of the
    same j, by a stable sort, which is the order the cursor gives)."""
    b, n, k = idx.shape
    idx = idx.long()
    tiles = -(-n // tile)
    counts = torch.zeros(b, tiles, n, dtype=torch.long)
    for t in range(tiles):
        sub = idx[:, t * tile:(t + 1) * tile].reshape(b, -1)
        counts[:, t].scatter_add_(1, sub, torch.ones_like(sub))
    tile_start = counts.cumsum(1) - counts
    off = torch.cat([torch.zeros(b, 1, dtype=torch.long), counts.sum(1).cumsum(1)], 1)
    pos = tile_start + off[:, None, :n]
    entry = (torch.arange(n)[:, None] << 6 | torch.arange(k)[None, :]).expand(b, n, k)
    rev = torch.empty(b, n * k, dtype=torch.long)
    for t in range(tiles):
        sub = idx[:, t * tile:(t + 1) * tile].reshape(b, -1)
        order = torch.argsort(sub, dim=1, stable=True)
        sj = sub.gather(1, order)
        rank = torch.arange(sj.shape[1]) - torch.searchsorted(sj, sj, right=False)
        dest = pos[:, t].gather(1, sj) + rank
        rev.scatter_(1, dest, entry[:, t * tile:(t + 1) * tile].reshape(b, -1).gather(1, order))
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
    `reverse_lists_tiled`."""
    b, n, c = ds1.shape
    length = off[:, 1:] - off[:, :-1]                                # (B, N)
    longest = int(length.max())
    q = torch.arange(longest)
    p = off[:, :-1, None] + q                                        # (B, N, longest)
    live = q < length[..., None]
    e = rev.gather(1, torch.where(live, p, 0).reshape(b, -1)).reshape(b, n, longest)
    i, slot = e >> 6, e & 63
    uj = u.to(torch.bfloat16).float()
    acc = [torch.zeros(b, n, c), torch.zeros(b, n, c)]
    for pos in range(longest):
        sel = (torch.arange(b)[:, None], i[:, :, pos])
        g = ds1[sel] + 2.0 * uj * ds2[sel]
        g = g + torch.where(amax[sel].long() == slot[:, :, pos, None], dmx[sel], 0.0)
        g = g + torch.where(amin[sel].long() == slot[:, :, pos, None], dmn[sel], 0.0)
        acc[pos % 2] = torch.where(live[:, :, pos, None], acc[pos % 2] + g, acc[pos % 2])
    return acc[0] + acc[1]


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

    x (B, N, Cq), u (B, N, C <= 256), k <= 64. A CPU tensor runs
    `edge_knn_reduce_plain`; a CUDA tensor runs csrc/knn_edge_reduce.cu
    inside an autograd.Function: the forward kernel selects as B3 does
    (tensor-core distance rows in shared memory, one sweep under the pool's
    threshold, ties in index order; the rows walked in chunks past 3,200
    points) and writes mx, mn, s1, s2, the first
    max/min slots and the selected indices; the backward builds per-item
    reverse neighbour lists across the card (counts per 64-row tile, a scan,
    a fill that keeps each list in increasing i: `reverse_lists_tiled`) and
    sums each u row's gradient over its list in a fixed order
    (`edge_knn_reduce_bwd_emulated`), with no atomics on the sums, so it is
    deterministic.

    What bounds it on the H100: the forward, like B3, by the gathers of u
    from L2, plus its five outputs; the backward by the gathers of the
    selecting rows' ds1 and ds2 (k times per row, from L2: a random cloud's
    lists share no tile) and their slot bytes; dmx and dmn are read only
    where a slot matches. The TPU kernel's (B, N, N) rank matrix is not
    kept: the saved state is the (B, N, k) indices and two byte-wide slot
    maps. The lists' kernels hold n counters in shared memory: clouds past
    about 58,000 points raise (`routes.knn_bwd_smem_bytes`)."""
    if not x.is_cuda:
        return edge_knn_reduce_plain(x, u, k)
    return _EdgeKnnReduce.apply(x, u, k)
