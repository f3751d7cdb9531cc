"""Farthest-point sampling (B8) and its plain version.

Counterpart of `flowcompare_tpu/ops/fps.py::furthest_point_sampling` (the
plain version) and of the Pallas kernel it takes on the TPU,
`flowcompare_tpu/ops/fps_pallas.py::fps_pallas`. m greedy picks per cloud,
the first being index 0; each pick lowers every point's running minimum of
its f32 squared distance ((dx*dx + dy*dy) + dz*dz, rounded after every
operation) to the picks so far, and the next pick is the first index of the
largest minimum. Index selection only: no gradient, as in the JAX package.
"""

from __future__ import annotations

import torch

from . import _build

# Launch counter of the fps kernel, bumped at its one launch site.
FPS_LAUNCHES = 0


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


def furthest_point_sampling(xyz: torch.Tensor, m: int) -> torch.Tensor:
    """B8: xyz (B, N, >=3) -> int64 (B, m) farthest-point picks; replaces the
    Pallas kernel `fps_pallas` (fps_pallas.py:99).

    A CPU tensor runs `furthest_point_sampling_plain`; a CUDA tensor
    launches `fps` (csrc/fps.cu): one block per cloud, the cloud and the
    running minima in shared memory, m sequential sweeps each ending in a
    block argmax of (value, index) pairs. Index-equal to the plain version:
    the same f32 operations in the same order (no FMA) and the same
    first-index tie-break. Bound on the H100 by the m sequential picks,
    each one sweep and two block barriers."""
    global FPS_LAUNCHES
    if not xyz.is_cuda:
        return furthest_point_sampling_plain(xyz, m)
    x = xyz[..., :3].detach().float().contiguous()
    out = torch.empty(x.shape[0], m, dtype=torch.int64, device=x.device)
    _build.fps(x, out)
    FPS_LAUNCHES += 1
    return out
