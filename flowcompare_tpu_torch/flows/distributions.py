"""Per-point log-densities, summed over the feature axis to (B, N).

Counterpart of `flowcompare_tpu/flows/distributions.py`
(`standard_normal_logprob`, `normal_logprob`). Log-densities are always
accumulated in float32.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def standard_normal_logprob(x: torch.Tensor) -> torch.Tensor:
    """log N(x; 0, I) summed over the last axis -> (B, N)."""
    x = x.float()
    return (-0.5 * LOG_2PI - 0.5 * x * x).sum(-1)


def normal_logprob(x: torch.Tensor, loc, scale) -> torch.Tensor:
    """log N(x; loc, scale^2) summed over the last axis -> (B, N)."""
    x = x.float()
    z = (x - loc) / scale
    return (-0.5 * LOG_2PI - torch.log(scale) - 0.5 * z * z).sum(-1)
