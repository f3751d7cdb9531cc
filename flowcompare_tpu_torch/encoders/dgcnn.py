"""DGCNN per-point conditioning encoder, eval mode.

Counterpart of `flowcompare_tpu/encoders/dgcnn.py` (`init_dgcnn`,
`edge_features`, `apply_dgcnn`'s gather formulation, `_fused_edge_stage`).
Four EdgeConv stages on a dynamic feature-space kNN graph, the 512-wide
skip concat, conv5 and a per-point residual MLP head; channels last.

`apply_dgcnn` is the gather formulation: the (B, N, K, 2C) edge tensor, a
1x1 conv, eval BatchNorm, leaky-0.2 and a max over K. Under the bf16 policy
the model runs the whole encoder as B4 (`ops/dgcnn_cuda.py`) instead;
`fused_edge_stage` is one stage in B4's algebra through B3.
"""

from __future__ import annotations

import torch

from ..core.batchnorm import apply_batchnorm, init_batchnorm
from ..core.initializers import apply_linear, torch_linear
from ..core.mlp import apply_mlp, cast_tree, gelu, init_mlp
from ..ops.edgeconv_cuda import edge_neighbor_max
from ..ops.knn import gather_neighbors, knn_self

_EDGE_DIMS = [(None, 64), (64, 64), (64, 128), (128, 256)]


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def edge_features(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, C) -> (B, N, K, 2C) with channels (neighbour - x, x)."""
    idx = knn_self(x, k)
    neighbors = gather_neighbors(x, idx)
    center = x[:, :, None, :].expand_as(neighbors)
    return torch.cat((neighbors - center, center), -1)


def init_dgcnn(gen: torch.Generator, *, input_dim: int = 6, emb_dim: int,
               out_mlp_dims):
    """Params and BatchNorm state of the per-point DGCNNembedder."""
    params, state = {}, {}
    dims = [(input_dim * 2, 64)] + [(c * 2, o) for (c, o) in _EDGE_DIMS[1:]] + [(512, 512)]
    for i, (cin, cout) in enumerate(dims, start=1):
        bn_params, bn_state = init_batchnorm(cout)
        params[f"conv{i}"] = {"conv": torch_linear(gen, cin, cout, bias=False),
                              "bn": bn_params}
        state[f"bn{i}"] = bn_state
    params["out_mlp"] = init_mlp(gen, 512, out_mlp_dims, emb_dim)
    return params, state


def _conv_bn_leaky(params, state, x):
    return _leaky(apply_batchnorm(params["bn"], state, apply_linear(params["conv"], x)))


def apply_dgcnn(params: dict, state: dict, x: torch.Tensor, *, n_neighbors: int,
                dtype=None) -> torch.Tensor:
    """Gather formulation: x (B, N, input_dim) -> (B, N, emb_dim)."""
    if dtype is not None:
        params = cast_tree(params, dtype)
        x = x.to(dtype)
    h = x
    feats = []
    for i in range(1, 5):
        e = edge_features(h, n_neighbors)
        h = _conv_bn_leaky(params[f"conv{i}"], state[f"bn{i}"], e).amax(2)
        feats.append(h)
    h = _conv_bn_leaky(params["conv5"], state["bn5"], torch.cat(feats, -1))
    return apply_mlp(params["out_mlp"], h, gelu)


def fused_edge_stage(params: dict, state: dict, h: torch.Tensor, n_neighbors: int, *,
                     bn_eps: float = 1e-5) -> torch.Tensor:
    """One eval EdgeConv stage as u_j + c_i through B3: conv([x_j - x_i, x_i]) =
    x_j @ W_diff + x_i @ (W_self - W_diff); the BN slope sign is folded into
    u so one masked max suffices, then the monotone BN affine and leaky-0.2
    apply to the reduced value."""
    w = params["conv"]["w"]
    c_in = h.shape[-1]
    w_diff, w_self = w[:c_in], w[c_in:]
    u = h @ w_diff
    c = h @ (w_self - w_diff)
    inv = torch.rsqrt(state["var"] + bn_eps)
    slope = params["bn"]["scale"] * inv
    sign = torch.where(slope >= 0, 1.0, -1.0).to(u.dtype)
    mx = edge_neighbor_max(h, u * sign, n_neighbors)
    z = (sign * mx).float() + c.float()
    y = (z - state["mean"]) * inv * params["bn"]["scale"] + params["bn"]["bias"]
    return _leaky(y).to(h.dtype)
