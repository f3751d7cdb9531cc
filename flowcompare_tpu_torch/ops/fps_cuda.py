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

# The kernel's threads a block (csrc/fps.cu FPS_THREADS, one block a cloud).
FPS_THREADS = 128


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


def fps_levels_emulated(xyz: torch.Tensor, ms) -> tuple:
    """The kernel's algorithm (csrc/fps.cu) step for step in PyTorch, clouds
    in parallel: per level, the points dealt to the block's FPS_THREADS
    threads (thread g holds points g, g + FPS_THREADS, ...), each thread's first maximum
    of its running minima (strict >, in index order), each warp's winner by
    __reduce_max_sync over the minima's f32 bits and __reduce_min_sync over
    the indices of the lanes that hold it, the winners of all warps as
    64-bit keys (bits << 32 | ~index) in the slot buffer of the pick's
    parity and their largest key, and the picks' coordinates as the next
    level's cloud. -> ([idx_l int64 (B, m_l)], [new_xyz_l f32 (B, m_l, 3)],
    the parity of each block-wide pick, in order)."""
    x = xyz[..., :3].detach().float()
    b = x.shape[0]
    rows = torch.arange(b)
    full, imax = 0xFFFFFFFF, 2 ** 31 - 1
    idxs, outs, parities = [], [], []
    parity = 0
    for m in ms:
        n = x.shape[1]
        nt = FPS_THREADS
        per = -(-n // nt)
        slots = torch.zeros(2, b, nt // 32, dtype=torch.int64)
        # the points a thread holds, in its scan order: (thread, r) -> g + NT r
        j = torch.arange(nt)[:, None] + nt * torch.arange(per)[None, :]
        valid = j < n
        jc = j.clamp_max(n - 1)
        md = torch.full((b, n), float("inf"))
        far = torch.zeros(b, dtype=torch.int64)
        idx = torch.zeros(b, m, dtype=torch.int64)
        for i in range(m):
            idx[:, i] = far
            if i == m - 1:
                break
            dx, dy, dz = (x - x[rows, far][:, None, :]).unbind(-1)
            md = torch.minimum(md, (dx * dx + dy * dy) + dz * dz)
            v = torch.where(valid, md[:, jc], -1.0)                       # (B, NT, per)
            # each thread's first maximum: the first r whose value is the
            # thread's largest (strict > in scan order keeps the first)
            first = torch.argmax(v, -1)
            bv = v.gather(-1, first[..., None])[..., 0]
            bi = torch.where(valid.any(-1), j[torch.arange(nt), first], imax)
            bits = torch.where(bi == imax, 0, bv.view(torch.int32).long() & full)
            lanes = bits.reshape(b, nt // 32, 32)
            wmax = lanes.max(-1).values                                   # __reduce_max_sync
            wi = torch.where(lanes == wmax[..., None], bi.reshape(b, nt // 32, 32),
                             full).min(-1).values                         # __reduce_min_sync
            key = (wmax << 32) | (full - wi)
            slots[parity] = key
            best = slots[parity].max(-1).values
            far = full - (best & full)
            parities.append(parity)
            parity ^= 1
        idxs.append(idx)
        x = _gather_xyz(x, idx)
        outs.append(x)
    return idxs, outs, parities
