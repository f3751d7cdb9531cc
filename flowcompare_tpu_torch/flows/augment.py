"""Conditional augmentation and its attention preconditioner.

Counterpart of `flowcompare_tpu/flows/augment.py`
(`augment_conditional_forward`, `augment_attn_forward`): the input is
widened with z2 = mean + scale * eps from a ConditionalNormal whose net sees
[x, context], contributing ldj = -log q(z2).

The noise is an argument: `eps` (B, N, aug_dim) float32 standard normal.
The JAX package draws it from a key inside; the tests hand the same draw
to both packages.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.attention import apply_cross_attention
from ..core.mlp import apply_mlp
from .distributions import normal_logprob


def augment_conditional_forward(params: dict, x: torch.Tensor, context,
                                eps: torch.Tensor, *, nonlin: Callable,
                                use_context: bool = True, dtype=None):
    """Augment with a ConditionalNormal: returns ([x, z2], -log q(z2))."""
    if context is not None and use_context:
        net_ctx = torch.cat((x.to(context.dtype), context), -1)
    else:
        net_ctx = x
    out = apply_mlp(params["net"], net_ctx, nonlin, dtype=dtype)
    half = out.shape[-1] // 2
    mean = out[..., :half].float()
    scale = torch.exp(out[..., half:].float())
    z2 = mean + scale * eps
    logq = normal_logprob(z2, mean, scale)
    return torch.cat([x, z2.to(x.dtype)], -1), -logq


def augment_attn_forward(params: dict, x: torch.Tensor, context,
                         extra_context, eps: torch.Tensor, *,
                         nonlin: Callable, dtype=None):
    """attn(pre_attn_mlp(x), context) -> [extra ++] attention embedding,
    then a conditional Augment whose net context is [x, embedding]."""
    mlp_out = apply_mlp(params["pre_attn_mlp"], x, nonlin, dtype=dtype)
    attention_emb = apply_cross_attention(params["attn"], mlp_out, context,
                                          dtype=dtype)
    if extra_context is not None:
        attention_emb = torch.cat(
            (extra_context.to(attention_emb.dtype), attention_emb), -1)
    return augment_conditional_forward(
        params["augment"], x, attention_emb, eps, nonlin=nonlin,
        use_context=True, dtype=dtype)
