"""Affine coupling with the sigmoid scale, the coupling of every shipped preset.

Counterpart of `flowcompare_tpu/flows/coupling.py` (`init_affine_coupling`,
`affine_coupling_forward`): x = [x1, x2], (s, t) = MLP([x1, context]),
y2 = x2 * scale(s) + t with scale(s) = (2 sigmoid(s) - 1)(1 - eps) + 1, and
a per-point log-det sum(log scale) accumulated in float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.mlp import apply_mlp, init_mlp


def init_affine_coupling(gen: torch.Generator, input_dim: int, hidden, *,
                         context_dim: int = 0,
                         split_dim: Optional[int] = None) -> dict:
    split = input_dim // 2 if split_dim is None else split_dim
    out_dim = (input_dim - split) * 2
    return {"nn": init_mlp(gen, split + context_dim, hidden, out_dim)}


def sigmoid_scale(s: torch.Tensor, eps: float) -> torch.Tensor:
    return (2.0 * torch.sigmoid(s) - 1.0) * (1.0 - eps) + 1.0


def affine_coupling_forward(params: dict, x: torch.Tensor, context, *,
                            nonlin: Callable, eps: float = 1e-8,
                            dtype=None):
    split = x.shape[-1] // 2
    x1, x2 = x[..., :split], x[..., split:]
    nn_input = (torch.cat((x1.to(context.dtype), context), -1)
                if context is not None else x1)
    st = apply_mlp(params["nn"], nn_input, nonlin, dtype=dtype).float()
    half = st.shape[-1] // 2
    s = sigmoid_scale(st[..., :half], eps)
    y2 = x2 * s + st[..., half:]
    ldj = torch.log(s.float()).sum(-1)
    return torch.cat([x1, y2], -1), ldj
