"""Linear-layer initialisation and application.

Counterpart of `flowcompare_tpu/core/initializers.py`. Weights are stored
`(in, out)` as in the JAX package, so a layer is `x @ w + b`. Randomness
comes from an explicit CPU `torch.Generator`; the numbers differ from
`jax.random`, the distribution (torch.nn.Linear's U(-1/sqrt(in), 1/sqrt(in))
for weight and bias) does not.
"""

from __future__ import annotations

import math

import torch


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * bound


def torch_linear(gen: torch.Generator, in_dim: int, out_dim: int, *,
                 bias: bool = True) -> dict:
    """Linear params with torch.nn.Linear's default init, stored (in, out)."""
    bound = 1.0 / math.sqrt(in_dim)
    params = {"w": _uniform(gen, (in_dim, out_dim), bound)}
    if bias:
        params["b"] = _uniform(gen, (out_dim,), bound)
    return params


def apply_linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    """y = x @ w (+ b). Weight layout is (in, out). Mixed operand dtypes
    promote as in JAX (float32 @ bf16 -> float32)."""
    w = params["w"]
    dt = torch.promote_types(x.dtype, w.dtype)
    y = x.to(dt) @ w.to(dt)
    if "b" in params:
        y = y + params["b"]
    return y


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation, whatever the operand dtype.

    The counterpart of `jnp.dot(..., preferred_element_type=jnp.float32)`:
    bf16 operands are widened first, so every product is exact and only the
    sum rounds. On the card the caller disables TF32 for a true f32 sum."""
    return torch.matmul(a.float(), b.float())
