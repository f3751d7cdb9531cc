"""PAConv set-abstraction grouping (B9): its selection and gather, their
plain versions and emulations of their kernels.

Counterpart of the Pallas kernel
`flowcompare_tpu/ops/sa_group_pallas.py::sa_group_fused`, the eval grouping
of `flowcompare_tpu/encoders/paconv.py::_sa_level`. For each FPS centre: its
exact k nearest points by f32 squared distance with the centre pinned to
slot 0, slots 1..k-1 in ascending index order (the Pallas kernel's slot
convention; everything downstream, the per-slot ScoreNet and weight bank and
the max over slots, is invariant to the order past slot 0), point 0 in the
slots past N when k > N, and the output [x_p - centre (f32, then cast) |
feats_p] in the features' dtype.

On the card the grouping is two kernels: the selection (`sa_select_levels`),
which depends only on each level's coordinates and so runs for all four SA
levels in one launch right after B8, and the gather (`sa_gather`), one
launch a level once its features exist. `sa_group` is both for one level.
"""

from __future__ import annotations

import torch

from . import _build
from .edgeconv_cuda import knn_select_emulated
from .knn import gather_neighbors, knn_indices

# Launch counters of the selection and gather kernels, bumped at their one
# launch site each.
SA_SELECT_LAUNCHES = 0
SA_GATHER_LAUNCHES = 0


def sa_select_plain(new_xyz: torch.Tensor, idx: torch.Tensor, xyz: torch.Tensor,
                    k: int) -> torch.Tensor:
    """The slot lists in plain PyTorch: `knn_indices(self_idx=idx)`, the
    selected neighbours (slots 1..min(k, N)-1) re-sorted by index -> int64
    (B, M, k)."""
    n = xyz.shape[1]
    knn = knn_indices(new_xyz, xyz, k, self_idx=idx)
    r = min(k, n)
    return torch.cat([knn[..., :1], knn[..., 1:r].sort(-1).values, knn[..., r:]], -1)


def sa_gather_plain(sel: torch.Tensor, new_xyz: torch.Tensor, xyz: torch.Tensor,
                    feats: torch.Tensor) -> torch.Tensor:
    """[x_p - centre | feats_p] for the points p of sel (B, M, k), in plain
    PyTorch -> (B, M, k, 3 + C) in feats' dtype."""
    sel = sel.long()
    diff = gather_neighbors(xyz.float(), sel) - new_xyz.float()[:, :, None, :]
    return torch.cat([diff.to(feats.dtype), gather_neighbors(feats, sel)], -1)


def sa_group_plain(new_xyz: torch.Tensor, idx: torch.Tensor, xyz: torch.Tensor,
                   feats: torch.Tensor, k: int) -> torch.Tensor:
    """The grouping in plain PyTorch: `sa_select_plain`, then `sa_gather_plain`."""
    return sa_gather_plain(sa_select_plain(new_xyz, idx, xyz, k), new_xyz, xyz, feats)


def sa_select_levels(levels: list, k: int) -> list:
    """B9's selection for up to four levels: levels[l] = (new_xyz (B, M_l,
    3), idx (B, M_l), xyz (B, N_l, 3)) -> [sel_l (B, M_l, k)]: slot 0 the
    centre, slots 1.. its nearest other points in ascending index order,
    point 0 past N_l.

    A CPU tensor runs `sa_select_plain` a level (int64); a CUDA tensor
    launches `sa_select` (csrc/sa_group.cu) once for all levels (int32, -1 in
    slot 0 for a centre index outside [0, N_l)): the grid holds each level's
    blocks, level 0 first, a block the points of one item in shared memory
    and 8 warps of distance rows, the exact selection of knn_select.cuh
    with the centre pinned; a launch whose largest cloud does not fit that
    way (past 4,458 points, `select_rows_fit`) reads the points from global
    memory and recomputes the distances for each sweep."""
    global SA_SELECT_LAUNCHES
    if not levels[0][2].is_cuda:
        return [sa_select_plain(new_xyz, idx, xyz, k) for new_xyz, idx, xyz in levels]
    args = [(new_xyz.float().contiguous(), idx.long().contiguous(), xyz.float().contiguous())
            for new_xyz, idx, xyz in levels]
    sel = [torch.empty(*idx.shape, k, dtype=torch.int32, device=idx.device) for _, idx, _ in args]
    _build.sa_select(args, sel, k=k)
    SA_SELECT_LAUNCHES += 1
    return sel


def sa_gather(sel: torch.Tensor, new_xyz: torch.Tensor, xyz: torch.Tensor,
              feats: torch.Tensor) -> torch.Tensor:
    """B9's gather: sel (B, M, k) from `sa_select_levels`, new_xyz (B, M, 3),
    xyz (B, N, 3), feats (B, N, C) -> (B, M, k, 3 + C) in feats' dtype.

    A CPU tensor runs `sa_gather_plain`; a CUDA tensor launches `sa_gather`
    (csrc/sa_group.cu): a warp per group of a centre's slots, the group's
    rows assembled in shared memory in the output's layout (feature rows
    read 16 bytes a lane where they allow it) and written with 16-byte
    stores; NaN rows for a centre whose slot 0 is -1."""
    global SA_GATHER_LAUNCHES
    if not xyz.is_cuda:
        return sa_gather_plain(sel, new_xyz, xyz, feats)
    b, mc, k = sel.shape
    out = torch.empty(b, mc, k, 3 + feats.shape[-1], dtype=feats.dtype, device=xyz.device)
    _build.sa_gather(sel, new_xyz.float().contiguous(), xyz.float().contiguous(),
                     feats.contiguous(), out)
    SA_GATHER_LAUNCHES += 1
    return out


def sa_group(new_xyz: torch.Tensor, idx: torch.Tensor, xyz: torch.Tensor, feats: torch.Tensor,
             k: int) -> torch.Tensor:
    """B9 at one level: new_xyz (B, M, 3) centres, idx (B, M) their indices
    in xyz (B, N, 3), feats (B, N, C) -> (B, M, k, 3 + C) in feats' dtype;
    replaces the Pallas kernel `sa_group_fused` (sa_group_pallas.py:126).

    A CPU tensor runs `sa_group_plain`; a CUDA tensor launches the
    selection and the gather back to back. A centre index outside [0, N)
    gives NaN rows (checking it on the host would synchronise)."""
    if not xyz.is_cuda:
        return sa_group_plain(new_xyz, idx, xyz, feats, k)
    sel = sa_select_levels([(new_xyz, idx, xyz)], k)[0]
    return sa_gather(sel, new_xyz, xyz, feats)


# --------------------------------------------------------------- emulations

SEL_WARPS = 8


def select_rows(items: int, mc: int, sms: int) -> int:
    """Rows a warp selects at a level on a card of `sms` SMs
    (csrc/sa_group.cu select_rows)."""
    blocks = items * -(-mc // SEL_WARPS)
    return 4 if blocks >= 8 * sms else 2 if blocks >= 4 * sms else 1


def select_grid(items: int, mcs: list, sms: int) -> torch.Tensor:
    """The selection launch's grid on a card of `sms` SMs, block by block:
    int64 (blocks, 8 warps, rows a warp, 3) of (level, item, centre) per
    (block, warp, row), -1 where a row has no centre; level 0's blocks
    first."""
    rpw_max = max(select_rows(items, mc, sms) for mc in mcs)
    out = []
    for level, mc in enumerate(mcs):
        rpw = select_rows(items, mc, sms)
        blocks = -(-mc // (SEL_WARPS * rpw))
        b = torch.arange(items * blocks)
        item, blk = b // blocks, b % blocks
        r = torch.arange(rpw_max)
        ci = (blk[:, None, None] * rpw + r[None, None, :]) * SEL_WARPS + \
            torch.arange(SEL_WARPS)[None, :, None]
        live = (ci < mc) & (r < rpw)[None, None, :]
        rows = torch.stack([torch.full_like(ci, level), item[:, None, None].expand_as(ci), ci], -1)
        out.append(torch.where(live[..., None], rows, -1))
    return torch.cat(out)


def centre_distance_bits(new_xyz: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """int64 (B, M, N): the f32 bit patterns the selection kernel computes,
    max((|c|^2 - 2 c.x_j) + |x_j|^2, +0) with |v|^2 = fma(z, z, fma(y, y,
    x x)) and c.x_j = fma(cz, z, fma(cy, y, cx x)), each fma taken exactly in
    f64 and rounded once to f32 (f64 holds the products exactly; the sum
    can round twice where its terms' exponents lie far apart)."""
    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()

    def norm(v):
        x, y, z = v.float().unbind(-1)
        return fma(z, z, fma(y, y, x * x))

    c, p = new_xyz.float(), xyz.float()
    cx, cy, cz = (t[:, :, None] for t in c.unbind(-1))
    px, py, pz = (t[:, None, :] for t in p.unbind(-1))
    cross = fma(cz, pz, fma(cy, py, cx * px))
    d = (norm(c)[:, :, None] - 2.0 * cross) + norm(p)[:, None, :]
    d = torch.where(d > 0, d, d.new_zeros(()))
    return d.contiguous().view(torch.int32).long()


# csrc/sa_group.cu: the candidates a warp holds; the pool's largest k, and a
# list's entries (a list past it lies in the candidates' words)
_CAP, _POOL = 256, 64


def select_smem_of(n: int, rows: bool) -> int:
    """The selection's shared memory (sa_group.cu `select_smem_of`), the
    same at every k: each warp's candidates and list, and with `rows` the
    points as float4 and a distance row a warp before them."""
    return (4 * (4 * n + SEL_WARPS * n) if rows else 0) + 4 * SEL_WARPS * 2 * _CAP \
        + 4 * SEL_WARPS * _POOL


def select_rows_fit(n: int) -> bool:
    """Whether a launch whose largest cloud has n points keeps the clouds and
    the distance rows in shared memory (n <= 4,458); larger ones read the
    points from global memory and recompute the distances each sweep."""
    return select_smem_of(n, True) <= _build.SMEM_LIMIT


def sa_select_smem(n: int) -> int:
    """The selection launch's shared memory for clouds of up to n points
    (`fc_sa_select_smem`)."""
    return select_smem_of(n, select_rows_fit(n))


def sa_select_emulated(levels: list, k: int, sms: int, rows_in_smem=None) -> tuple:
    """The selection kernel (csrc/sa_group.cu `sa_select_kernel`) step for
    step in PyTorch over the launch's grid on a card of `sms` SMs
    (`select_grid`): per (level,
    item, centre) row, the distance bits (`centre_distance_bits`), the
    centre's own entry set to all ones, each lane's two nearest others (lane
    = j mod 32) as the pool, and `knn_select_emulated` for the k - 1 others
    (min(k, N) - 1 when N < k); slot 0 the centre, the rest point 0.
    `rows_in_smem` is the kernel's path (default: as the launch decides from
    its largest cloud, `select_rows_fit`): with False the pool takes a sweep of
    its own over the recomputed distances (none where k - 1 passes the pool's
    64: the radix select alone), and the selection's sweeps (the radix
    select's too) recompute them again.
    -> ([sel_l int64 (B, M_l, k)], the sweeps over each row)."""
    if rows_in_smem is None:
        rows_in_smem = select_rows_fit(max(xyz.shape[1] for _, _, xyz in levels))
    items = levels[0][2].shape[0]
    mcs = [new_xyz.shape[1] for new_xyz, _, _ in levels]
    rows = select_grid(items, mcs, sms).reshape(-1, 3)
    rows = rows[rows[:, 0] >= 0]
    assert len(rows) == items * sum(mcs), "a centre is missed or selected twice"
    sels, sweeps = [], []
    for level, (new_xyz, idx, xyz) in enumerate(levels):
        mine = rows[rows[:, 0] == level]
        assert torch.equal((mine[:, 1] * mcs[level] + mine[:, 2]).sort().values,
                           torch.arange(items * mcs[level])), "a centre is missed"
        n = xyz.shape[1]
        bits = centre_distance_bits(new_xyz, xyz).reshape(-1, n)
        self_idx = idx.reshape(-1).long()
        bits[torch.arange(len(bits)), self_idx] = 0xFFFFFFFF
        kr = min(k, n) - 1
        sel = torch.zeros(len(bits), k, dtype=torch.int64)
        sel[:, 0] = self_idx
        sw = torch.zeros(len(bits), dtype=torch.long)
        if kr > 0:
            got, sw, _ = knn_select_emulated(bits, kr, torch.arange(n) % 32)
            sel[:, 1:kr + 1] = got
            sw = sw + (not rows_in_smem and kr <= _POOL)
        sels.append(sel.reshape(items, mcs[level], k))
        sweeps.append(sw.reshape(items, mcs[level]))
    return sels, sweeps


GA_TILE = 2048


def gather_rows(w: int, k: int) -> int:
    """Rows of a gather group (csrc/sa_group.cu group_rows)."""
    return min(k, 32, max(8, (GA_TILE // w) & ~7))


def sa_gather_emulated(sel: torch.Tensor, new_xyz: torch.Tensor, xyz: torch.Tensor,
                       feats: torch.Tensor, *, base: int = 0) -> torch.Tensor:
    """The gather kernel (csrc/sa_group.cu `sa_gather_kernel`) step for step
    in PyTorch: per unit (a centre's group of `gather_rows` slots) the tile
    in the output's layout, filled through the kernel's lane maps (a lane
    per (slot, coordinate) for the xyz diffs; a lane per 16-byte chunk of a
    feature row, or per element where rows are not whole chunks), and its
    span written as the kernel writes it (elements up to the destination's
    first 16-byte boundary, 16-byte chunks, the tail), the output starting
    `base` bytes past a 16-byte boundary. -> (B, M, k, 3 + C) in feats'
    dtype."""
    b, mc, k = sel.shape
    n, c = xyz.shape[1], feats.shape[-1]
    w, es = 3 + c, feats.element_size()
    ve = 16 // es
    rows_g = gather_rows(w, k)
    groups = -(-k // rows_g)
    out = torch.full((b * mc * k * w,), float("nan"), dtype=feats.dtype)
    written = torch.zeros(b * mc * k * w, dtype=torch.int64)
    sel_f = sel.reshape(b * mc, k).long()
    cen = new_xyz.float().reshape(b * mc, 3)
    item = torch.arange(b * mc) // mc
    vec = c % ve == 0
    for grp in range(groups):
        g0 = grp * rows_g
        rows = min(rows_g, k - g0)
        tile = torch.zeros(b * mc, rows * w, dtype=feats.dtype)
        p = sel_f[:, g0:g0 + rows].clamp_min(0)                      # prow
        e = torch.arange(rows * 3)
        r, q = e // 3, e % 3
        pts = xyz.float()[item[:, None], p[:, r], q[None, :]]
        tile[:, r * w + q] = (pts - cen[:, q]).to(feats.dtype)
        if vec:
            e = torch.arange(rows * (c // ve))
            r, q = e // (c // ve), e % (c // ve)
            for i in range(ve):
                tile[:, r * w + 3 + q * ve + i] = feats[item[:, None], p[:, r], q * ve + i]
        else:
            e = torch.arange(rows * c)
            r, q = e // c, e % c
            tile[:, r * w + 3 + q] = feats[item[:, None], p[:, r], q]
        tile[sel_f[:, 0] < 0] = float("nan")
        count = rows * w
        start = (torch.arange(b * mc) * k + g0) * w                  # dst, in elements
        pad = (base + start * es) % 16
        head = torch.clamp(((16 - pad) % 16) // es, max=count)
        body = (count - head) // ve
        for u in range(b * mc):
            h, bd = int(head[u]), int(body[u])
            spans = [range(0, h), range(h, h + bd * ve), range(h + bd * ve, count)]
            for span in spans:
                idx = torch.tensor(list(span), dtype=torch.int64)
                out[start[u] + idx] = tile[u, idx]
                written[start[u] + idx] += 1
    assert bool((written == 1).all()), "an output element is written twice or never"
    return out.reshape(b, mc, k, w)
