"""BatchNorm with torch semantics (eps 1e-5), eval mode only.

Counterpart of `flowcompare_tpu/core/batchnorm.py`. Channels are last; the
running statistics are explicit state. Train mode (batch statistics, the
custom backward) belongs to the training slice and is not here.
"""

from __future__ import annotations

import torch


def init_batchnorm(num_features: int):
    params = {"scale": torch.ones(num_features), "bias": torch.zeros(num_features)}
    state = {"mean": torch.zeros(num_features), "var": torch.ones(num_features)}
    return params, state


def apply_batchnorm(params: dict, state: dict, x: torch.Tensor, *,
                    eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode normalisation with the running statistics, in float32."""
    y = (x.float() - state["mean"].float()) * torch.rsqrt(state["var"].float() + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)
