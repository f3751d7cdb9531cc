"""LayerNorm and single-layer cross attention.

Counterpart of `flowcompare_tpu/core/attention.py`: a LayerNorm on the
query stream only, Q from the point latents, K/V from the encoder features,
a dense softmax over the context points and a linear out-projection.

The AttentionMine quirk is kept: heads are never split. `heads` only scales
`inner_dim = heads * dim_head` and the softmax temperature
`inner_dim ** -0.5`; with the shipped heads=1 this is exact.
"""

from __future__ import annotations

import torch

from .initializers import apply_linear, matmul_f32, torch_linear
from .mlp import cast_tree


def init_layer_norm(dim: int) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def apply_layer_norm(params: dict, x: torch.Tensor, *,
                     eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]


def init_cross_attention(gen: torch.Generator, *, out_dim: int, query_dim: int,
                         context_dim: int, heads: int = 1,
                         dim_head: int = 64) -> dict:
    inner_dim = heads * dim_head
    return {
        "norm": init_layer_norm(query_dim),
        "to_q": torch_linear(gen, query_dim, inner_dim, bias=False),
        "to_kv": torch_linear(gen, context_dim, 2 * inner_dim, bias=False),
        "out": torch_linear(gen, inner_dim, out_dim),
    }


def apply_cross_attention(params: dict, x: torch.Tensor, context: torch.Tensor,
                          dtype=None) -> torch.Tensor:
    """x (B, Nq, query_dim), context (B, Nkv, context_dim) -> (B, Nq, out_dim).

    dtype: optional compute dtype for the projections and the two attention
    products; LayerNorm statistics and the softmax stay float32."""
    inner_dim = params["to_q"]["w"].shape[1]
    scale = inner_dim ** -0.5
    xn = apply_layer_norm(params["norm"], x.float())
    if dtype is not None:
        params = cast_tree(params, dtype)
        xn = xn.to(dtype)
        context = context.to(dtype)
    q = apply_linear(params["to_q"], xn)
    kv = apply_linear(params["to_kv"], context)
    k, v = kv[..., :inner_dim], kv[..., inner_dim:]
    sim = matmul_f32(q, k.transpose(-1, -2)) * scale
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    out = matmul_f32(attn, v)
    return apply_linear(params["out"], out.to(x.dtype))
