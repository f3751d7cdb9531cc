"""Farthest-point sampling (B8), its plain version and an emulation of its
kernel.

Counterpart of `flowcompare_tpu/ops/fps.py::furthest_point_sampling` (the
plain version) and of the Pallas kernel it takes on the TPU,
`flowcompare_tpu/ops/fps_pallas.py::fps_pallas`. m greedy picks per cloud,
the first being index 0; each pick lowers every point's running minimum of
its f32 squared distance ((dx*dx + dy*dy) + dz*dz, rounded after every
operation) to the picks so far, and the next pick is the first index of the
largest minimum. PAConv's four set-abstraction levels chain it: each level
samples the points the level before picked (`_sa_level` in the JAX
package), so `furthest_point_sampling_levels` runs all of them in one
launch. Index selection only: no gradient, as in the JAX package.
"""

from __future__ import annotations

import torch

from . import _build

# Launch counter of the fps kernel, bumped at its one launch site.
FPS_LAUNCHES = 0

# csrc/fps.cu, one block a cloud: the small kernel's threads, the counts of
# points a thread holds in registers it is built for (the last takes the
# rest in shared memory) and the points a block holds in registers at most;
# the large clouds' kernel's threads and counts (past them a shared tier of
# (x, y, z, min) points, then a global one), and its warps' key and
# coordinate slots in bytes
FPS_THREADS = 128
FPS_PERS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16)
FPS_POINTS = 2048
FPS_BIG_THREADS = 512
FPS_BIG_PERS = (1, 2, 4, 8, 16)


def _big_slots() -> int:
    return 2 * (FPS_BIG_THREADS // 32) * (8 + 16)


def fps_plan(n: int, ms) -> dict:
    """The launch csrc/fps.cu makes for an n-point cloud sampled at the
    levels ms, from the same formulas (`fc_fps_levels_smem`,
    `fc_fps_levels_threads`, `fc_fps_levels_spill`; a card test holds them
    equal): {"kernel": "small" or "big", "threads", "smem" (bytes), "spill"
    (global points a cloud), "levels": [(points a thread in registers, end
    of the shared tier) a level]}. The small kernel where its two level
    clouds (12 bytes a point) and the minima past FPS_POINTS (4) fit
    `_build.SMEM_LIMIT`, else the large clouds' kernel."""
    ns = [n, *ms[:-1]]
    size, spill = [1, 1], 0
    for l, pts in enumerate(ns):
        size[l & 1] = max(size[l & 1], pts)
        spill = max(spill, pts - FPS_POINTS)
    smem = 8 * 2 * (FPS_THREADS // 32) + 4 * (3 * (size[0] + size[1]) + spill)

    def per(pts, threads, pers):
        return next((p for p in pers if p * threads >= pts), pers[-1])

    if smem <= _build.SMEM_LIMIT:
        return {"kernel": "small", "threads": FPS_THREADS, "smem": smem, "spill": 0,
                "levels": [(per(p, FPS_THREADS, FPS_PERS), p) for p in ns]}
    t = FPS_BIG_THREADS
    reg = t * FPS_BIG_PERS[-1]
    tier = (_build.SMEM_LIMIT - _big_slots()) // 16 // t * t
    levels = [(per(p, t, FPS_BIG_PERS), min(p, t * per(p, t, FPS_BIG_PERS) + tier)) for p in ns]
    return {"kernel": "big", "threads": t,
            "smem": _big_slots() + 16 * max(min(max(0, p - reg), tier) for p in ns),
            "spill": max(0, max(p - reg - tier for p in ns)), "levels": levels}


def furthest_point_sampling_plain(xyz: torch.Tensor, m: int) -> torch.Tensor:
    """xyz (B, N, >=3) -> int64 (B, m), in plain PyTorch (a loop of m picks)."""
    x = xyz[..., :3].detach().float()
    b, n, _ = x.shape
    rows = torch.arange(b, device=x.device)
    idx = torch.zeros(b, m, dtype=torch.int64, device=x.device)
    min_d = torch.full((b, n), float("inf"), device=x.device)
    far = torch.zeros(b, dtype=torch.int64, device=x.device)
    for i in range(m):
        idx[:, i] = far
        dx, dy, dz = (x - x[rows, far][:, None, :]).unbind(-1)
        min_d = torch.minimum(min_d, (dx * dx + dy * dy) + dz * dz)
        far = torch.argmax(min_d, -1)          # the first maximum, as jnp.argmax
    return idx


def _gather_xyz(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, 3))


def furthest_point_sampling_levels_plain(xyz: torch.Tensor, ms) -> tuple:
    """xyz (B, N, >=3) -> ([idx_l int64 (B, m_l)], [new_xyz_l f32 (B, m_l,
    3)]), level l + 1 sampling new_xyz_l: `furthest_point_sampling_plain`
    and a gather a level."""
    x = xyz[..., :3].detach().float()
    idxs, outs = [], []
    for m in ms:
        idx = furthest_point_sampling_plain(x, m)
        x = _gather_xyz(x, idx)
        idxs.append(idx)
        outs.append(x)
    return idxs, outs


def furthest_point_sampling_levels(xyz: torch.Tensor, ms) -> tuple:
    """B8 over up to four chained levels: xyz (B, N, >=3) -> ([idx_l int64
    (B, m_l)], [new_xyz_l f32 (B, m_l, 3)]), level l + 1 sampling the m_l
    points level l picked; replaces the Pallas kernel `fps_pallas`
    (fps_pallas.py:99) at every SA level.

    A CPU tensor runs `furthest_point_sampling_levels_plain`; a CUDA tensor
    launches `fps_levels` (csrc/fps.cu) once: one block per cloud through
    all its levels, the points and running minima in registers, a warp's
    argmax in two redux.sync and one block barrier a pick, each level's
    picks kept on chip as the next level's cloud. Index-equal to the plain
    version: the same f32 operations in the same order (no FMA) and the
    same first-index tie-break. Bound on the H100 by the dependent chain of
    picks. Raises where the clouds do not fit shared memory
    (`_build.fps_levels` names the limit)."""
    global FPS_LAUNCHES
    if not xyz.is_cuda:
        return furthest_point_sampling_levels_plain(xyz, ms)
    x = xyz[..., :3].detach().float().contiguous()
    b = x.shape[0]
    idxs = [torch.empty(b, m, dtype=torch.int64, device=x.device) for m in ms]
    outs = [torch.empty(b, m, 3, device=x.device) for m in ms]
    _build.fps_levels(x, idxs, outs)
    FPS_LAUNCHES += 1
    return idxs, outs


def furthest_point_sampling(xyz: torch.Tensor, m: int) -> torch.Tensor:
    """B8 at one level: xyz (B, N, >=3) -> int64 (B, m) farthest-point
    picks; `furthest_point_sampling_levels` with one level (on CUDA one
    launch, on the CPU the plain version)."""
    if not xyz.is_cuda:
        return furthest_point_sampling_plain(xyz, m)
    return furthest_point_sampling_levels(xyz, [m])[0][0]


def _scan_order(n: int, threads: int, per: int, shared_end: int) -> torch.Tensor:
    """(threads, L) the points each thread sweeps, in its order (-1 past its
    last): registers g + T r for r < per, then the shared tier from
    T per + g to shared_end, then the global tier from shared_end + g, both
    in steps of T; the kernel's loops."""
    rows = []
    for g in range(threads):
        js = [g + threads * r for r in range(per) if g + threads * r < n]
        js += list(range(threads * per + g, shared_end, threads))
        js += list(range(shared_end + g, n, threads))
        rows.append(js)
    width = max(1, max(map(len, rows)))
    return torch.tensor([r + [-1] * (width - len(r)) for r in rows], dtype=torch.int64)


def fps_levels_emulated(xyz: torch.Tensor, ms) -> tuple:
    """The kernel's algorithm (csrc/fps.cu) step for step in PyTorch, clouds
    in parallel, for the launch `fps_plan` gives: per level, the points dealt
    to the block's threads in each thread's scan order (`_scan_order`:
    registers, then the large kernel's shared and global tiers), each
    thread's first maximum of its running minima (strict >), each warp's
    winner by __reduce_max_sync over the minima's f32 bits and
    __reduce_min_sync over the indices of the lanes that hold it, the
    winners of all warps as 64-bit keys (bits << 32 | ~index) in the slot
    buffer of the pick's parity and their largest key, the next centre (the
    small kernel's level cloud at the pick, the large kernel's winning
    warp's slot: the coordinates its winning lane kept), and the picks'
    coordinates as the next level's cloud. -> ([idx_l int64 (B, m_l)],
    [new_xyz_l f32 (B, m_l, 3)], the parity of each block-wide pick, in
    order)."""
    x = xyz[..., :3].detach().float()
    b = x.shape[0]
    rows = torch.arange(b)
    plan = fps_plan(x.shape[1], ms)
    nt, big = plan["threads"], plan["kernel"] == "big"
    full, imax = 0xFFFFFFFF, 2 ** 31 - 1
    idxs, outs, parities = [], [], []
    parity = 0
    for m, (per, shared_end) in zip(ms, plan["levels"]):
        n = x.shape[1]
        slots = torch.zeros(2, b, nt // 32, dtype=torch.int64)
        order = _scan_order(n, nt, per, shared_end)                      # (NT, L)
        valid = order >= 0
        jc = order.clamp_min(0)
        md = torch.full((b, n), float("inf"))
        far = torch.zeros(b, dtype=torch.int64)
        centre = x[:, 0]
        idx = torch.zeros(b, m, dtype=torch.int64)
        for i in range(m):
            idx[:, i] = far
            if i == m - 1:
                break
            dx, dy, dz = (x - centre[:, None, :]).unbind(-1)
            md = torch.minimum(md, (dx * dx + dy * dy) + dz * dz)
            v = torch.where(valid, md[:, jc], -1.0)                      # (B, NT, L)
            # each thread's first maximum: the first in scan order whose
            # value is the thread's largest (strict > keeps the first)
            first = torch.argmax(v, -1)
            bv = v.gather(-1, first[..., None])[..., 0]
            bi = torch.where(bv > -1.0, order[torch.arange(nt), first], imax)
            bits = torch.where(bi == imax, 0, bv.view(torch.int32).long() & full)
            lanes = bits.reshape(b, nt // 32, 32)
            lane_i = bi.reshape(b, nt // 32, 32)
            wmax = lanes.max(-1).values                                   # __reduce_max_sync
            wi = torch.where(lanes == wmax[..., None], lane_i, full).min(-1).values
            key = (wmax << 32) | (full - wi)
            slots[parity] = key
            best = slots[parity].max(-1).values
            far = full - (best & full)
            if big:
                # the winning lane's kept coordinates, in the slot of the warp
                # of thread far % NT
                won = wi[rows, (far % nt) // 32]
                centre = x[rows, won.clamp_max(n - 1)]
                centre = torch.where((won == imax)[:, None], 0.0, centre)
            else:
                centre = x[rows, far]
            parities.append(parity)
            parity ^= 1
        idxs.append(idx)
        x = _gather_xyz(x, idx)
        outs.append(x)
    return idxs, outs, parities
