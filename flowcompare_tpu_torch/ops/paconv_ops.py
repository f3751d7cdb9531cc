"""PAConv's score-weighted assembly of the weight bank.

Counterpart of `flowcompare_tpu/ops/paconv_ops.py::paconv_assign_score` in
its default "concat" form:

    out[b,n,k,o] = sum_{m,c} (score[b,n,k,m] * feat[b,n,k,c]) W[c, m, o]

as one product: the scores, cast to the features' dtype, times the
features (rounded to that dtype), against the bank rearranged
(C2, m*O) -> (C2, m, O) -> (m, C2, O) -> (m*C2, O), summed in f32 and cast
back. The JAX package computes this in plain XLA, outside any Pallas kernel,
so it is a torch.matmul here. The "einsum" and "per_m" forms are A/B
variants of the same function and are not ported.
"""

from __future__ import annotations

import torch

from ..core.initializers import matmul_f32


def paconv_assign_score(in_feat: torch.Tensor, weightbank: torch.Tensor,
                        scores: torch.Tensor, m: int) -> torch.Tensor:
    """in_feat (B, N, K, C2), weightbank (C2, m*O), scores (B, N, K, m)
    -> (B, N, K, O) in in_feat's dtype."""
    b, n, k, c2 = in_feat.shape
    bank = weightbank.reshape(c2, m, -1).transpose(0, 1).reshape(m * c2, -1)
    sf = (scores[..., :, None].to(in_feat.dtype) * in_feat[..., None, :]).reshape(b, n, k, m * c2)
    return matmul_f32(sf, bank).to(in_feat.dtype)
