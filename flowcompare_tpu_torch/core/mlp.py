"""Residual MLP, the conditioner of every coupling and augmenter.

Counterpart of `flowcompare_tpu/core/mlp.py`: an input layer, hidden layers
with a residual added at every second one (index 1, 3, ...: the activation
from two layers back is re-added before the nonlinearity), and a linear
output layer.

GELU is the exact erf form (torch.nn.GELU's default). The JAX package
evaluates the same function through a fitted logit-space polynomial, at
most 3.2e-6 away; that form exists for the TPU's vector unit only.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from .initializers import apply_linear, torch_linear


def init_mlp(gen: torch.Generator, in_dim: int, hidden: Sequence[int],
             out_dim: int) -> dict:
    return {
        "in": torch_linear(gen, in_dim, hidden[0]),
        "hidden": [torch_linear(gen, hidden[i], hidden[i + 1])
                   for i in range(len(hidden) - 1)],
        "out": torch_linear(gen, hidden[-1], out_dim),
    }


def apply_mlp(params: dict, x: torch.Tensor, nonlin: Callable,
              dtype=None) -> torch.Tensor:
    """dtype: optional compute dtype; params and input are cast to it."""
    if dtype is not None:
        params = cast_tree(params, dtype)
        x = x.to(dtype)
    x = nonlin(apply_linear(params["in"], x))
    residual = x
    for index, layer in enumerate(params["hidden"]):
        if index % 2 == 0:
            residual = x
            x = nonlin(apply_linear(layer, x))
        else:
            x = nonlin(residual + apply_linear(layer, x))
    return apply_linear(params["out"], x)


def cast_tree(tree, dtype):
    """Cast every tensor of a nested dict/list to dtype."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_tree(v, dtype) for v in tree]
    return tree.to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU, evaluated in float32 and returned in x's dtype."""
    return F.gelu(x.float()).to(x.dtype)


NONLINEARITIES: dict[str, Callable] = {
    "GELU": gelu,
    "RELU": F.relu,
    "ELU": F.elu,
    "LeakyReLU0.2": lambda x: F.leaky_relu(x, negative_slope=0.2),
}
