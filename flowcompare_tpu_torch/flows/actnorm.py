"""ActNorm for point clouds (B, N, D).

Counterpart of `flowcompare_tpu/flows/actnorm.py` (`init_actnorm`,
`actnorm_forward`): a per-feature shift and log-scale, z = (x - shift) *
exp(-log_scale), with a constant per-point log-det.
"""

from __future__ import annotations

import torch


def init_actnorm(num_features: int) -> dict:
    return {"shift": torch.zeros(1, num_features),
            "log_scale": torch.zeros(1, num_features)}


def actnorm_forward(params: dict, x: torch.Tensor):
    z = (x - params["shift"]) * torch.exp(-params["log_scale"])
    ldj = (-params["log_scale"].float()).sum().expand(x.shape[:-1])
    return z, ldj
