"""DGCNN conditioning encoders (per-point and global), eval and train modes.

Counterpart of `flowcompare_tpu/encoders/dgcnn.py` (`init_dgcnn`,
`edge_features`, `_global_pool`, `apply_dgcnn`'s gather formulation,
`_fused_edge_stage`, `_fused_edge_stage_train`).
Four EdgeConv stages on a dynamic feature-space kNN graph, the 512-wide
skip concat, conv5, then either a per-point residual MLP head
(DGCNNembedder) or, with `global_pool`, max ++ mean pooling over the points
and the head on the (B, 1024) vector (DGCNNembedderGlobal); channels last.

`apply_dgcnn` is the gather formulation: the (B, N, K, 2C) edge tensor, a
1x1 conv, eval BatchNorm, leaky-0.2 and a max over K. Under the bf16 policy
the model runs the whole encoder as B4 (`ops/dgcnn_cuda.py`) instead;
`fused_edge_stage` is one stage in B4's algebra through B3.

`apply_dgcnn_train` is train mode (BatchNorm on batch statistics, new
running statistics returned for bn1-bn5). It routes by device as the JAX
package routes by backend: CPU tensors take the gather formulation, CUDA
tensors take `fused_edge_stage_train` through B6 (`edge_knn_reduce`, or its
plain version when asked), unless the caller refuses the kernels for shapes
B6 does not take (`kernels=False`: the gather formulation). The u/c
products, conv5 and the head are torch.matmul, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

import torch

from ..core.batchnorm import (apply_batchnorm, apply_batchnorm_train, init_batchnorm,
                              running_update)
from ..core.initializers import apply_linear, torch_linear
from ..core.mlp import apply_mlp, cast_tree, gelu, init_mlp
from ..ops.edgeconv_cuda import edge_neighbor_max
from ..ops.edgeconv_vjp_cuda import edge_knn_reduce, edge_knn_reduce_plain
from ..ops.knn import gather_neighbors, knn_self

_EDGE_DIMS = [(None, 64), (64, 64), (64, 128), (128, 256)]


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def edge_features(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, C) -> (B, N, K, 2C) with channels (neighbour - x, x)."""
    idx = knn_self(x.detach(), k)   # integer selection: no gradient through it
    neighbors = gather_neighbors(x, idx)
    center = x[:, :, None, :].expand_as(neighbors)
    return torch.cat((neighbors - center, center), -1)


def _global_pool(h: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> (B, 2C): max ++ mean over the points, the mean in f32 and
    cast back to h's dtype. amax, not max(dim): its gradient splits equally
    among tied rows, as JAX's max does (a bf16 trunk after leaky-0.2 has ties)."""
    return torch.cat([h.amax(1), h.float().mean(1).to(h.dtype)], -1)


def global_head(params: dict, trunk: torch.Tensor) -> torch.Tensor:
    """DGCNNembedderGlobal's tail on a post-conv5 trunk (B, N, 512): the pool,
    then the head on the (B, 1024) vector, in the params' dtype."""
    return apply_mlp(params["out_mlp"], _global_pool(trunk), gelu)


def init_dgcnn(gen: torch.Generator, *, input_dim: int = 6, emb_dim: int,
               out_mlp_dims, global_pool: bool = False):
    """Params and BatchNorm state of DGCNNembedder, or of DGCNNembedderGlobal
    with global_pool (its head reads the 1024-wide pooled vector)."""
    params, state = {}, {}
    dims = [(input_dim * 2, 64)] + [(c * 2, o) for (c, o) in _EDGE_DIMS[1:]] + [(512, 512)]
    for i, (cin, cout) in enumerate(dims, start=1):
        bn_params, bn_state = init_batchnorm(cout)
        params[f"conv{i}"] = {"conv": torch_linear(gen, cin, cout, bias=False),
                              "bn": bn_params}
        state[f"bn{i}"] = bn_state
    params["out_mlp"] = init_mlp(gen, 1024 if global_pool else 512, out_mlp_dims, emb_dim)
    return params, state


def _conv_bn_leaky(params, state, x):
    return _leaky(apply_batchnorm(params["bn"], state, apply_linear(params["conv"], x)))


def apply_dgcnn(params: dict, state: dict, x: torch.Tensor, *, n_neighbors: int,
                dtype=None, global_pool: bool = False) -> torch.Tensor:
    """Gather formulation: x (B, N, input_dim) -> (B, N, emb_dim), or
    (B, emb_dim) with global_pool."""
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
    if global_pool:
        return global_head(params, h)
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


def _conv_bn_leaky_train(params, state, x):
    y, new_state = apply_batchnorm_train(params["bn"], state, apply_linear(params["conv"], x))
    return _leaky(y), new_state


def fused_edge_stage_train(params: dict, state: dict, h: torch.Tensor, n_neighbors: int, *,
                           reduce=edge_knn_reduce, momentum: float = 0.1,
                           bn_eps: float = 1e-5):
    """One train-mode EdgeConv stage as u_j + c_i through B6 -> (y, new_state).

    The BatchNorm batch statistics over the (B, N, K, C) edge tensor come
    from the per-row neighbour sums exactly: sum z = sum s1 + k sum c and
    sum z^2 = sum (s2 + 2 c s1 + k c^2); the per-channel affine is monotone,
    so the max over neighbours is the affine of mx or mn by the slope's sign."""
    w = params["conv"]["w"]
    c_in = h.shape[-1]
    w_diff, w_self = w[:c_in], w[c_in:]
    u = h @ w_diff
    c = h @ (w_self - w_diff)
    mx, mn, s1, s2 = reduce(h, u, n_neighbors)
    cf = c.float()
    k = float(n_neighbors)
    n_edges = h.shape[0] * h.shape[1] * k
    mean = (s1.sum((0, 1)) + k * cf.sum((0, 1))) / n_edges
    ez2 = (s2.sum((0, 1)) + 2.0 * (cf * s1).sum((0, 1)) + k * (cf * cf).sum((0, 1))) / n_edges
    var = (ez2 - mean * mean).clamp_min(0.0)
    gamma = params["bn"]["scale"].float()
    beta = params["bn"]["bias"].float()
    zsel = torch.where(gamma >= 0, mx, mn) + cf
    y = (zsel - mean) * torch.rsqrt(var + bn_eps) * gamma + beta
    return _leaky(y).to(h.dtype), running_update(state, mean, var, n_edges, momentum)


def apply_dgcnn_train(params: dict, state: dict, x: torch.Tensor, *, n_neighbors: int,
                      dtype=None, plain: bool = False, kernels: bool = True,
                      global_pool: bool = False):
    """Train mode: x (B, N, input_dim) -> ((B, N, emb_dim) or with
    global_pool (B, emb_dim), new_state). kernels=False takes the gather
    formulation on CUDA tensors too (shapes B6 does not take)."""
    if dtype is not None:
        params = cast_tree(params, dtype)
        x = x.to(dtype)
    reduce = edge_knn_reduce_plain if plain else edge_knn_reduce
    new_state = {}
    h = x
    feats = []
    for i in range(1, 5):
        p, s = params[f"conv{i}"], state[f"bn{i}"]
        if x.is_cuda and kernels:
            h, new_state[f"bn{i}"] = fused_edge_stage_train(p, s, h, n_neighbors, reduce=reduce)
        else:
            e, new_state[f"bn{i}"] = _conv_bn_leaky_train(p, s, edge_features(h, n_neighbors))
            h = e.amax(2)
        feats.append(h)
    h, new_state["bn5"] = _conv_bn_leaky_train(params["conv5"], state["bn5"],
                                               torch.cat(feats, -1))
    if global_pool:
        return global_head(params, h), new_state
    return apply_mlp(params["out_mlp"], h, gelu), new_state
