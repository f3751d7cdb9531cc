"""PAConv PointNet++ (SSG) per-point conditioning encoder, eval and train modes.

Counterpart of `flowcompare_tpu/encoders/paconv.py` (`init_pointnet2_paconv`,
`_apply_scorenet`, `_apply_paconv_layer`, `_apply_shared_mlp`, `_sa_level`,
`apply_pointnet2_paconv`). Four set-abstraction levels (FPS to N // 4
centres, a k = 32 neighbourhood with the centre in slot 0, a chain of PAConv
weight-bank convolutions, a max over the neighbourhood), four
feature-propagation levels (3-NN interpolation, skip concat, shared MLP)
and a residual out-MLP head; channels last, weights stored (in, out) under
the JAX package's tree paths.

Every embed starts with B8 (`ops/fps_cuda.py`) for all four levels in one
call: each level's picks and their coordinates, with no gradient (the
indices are `stop_gradient` in the JAX package; nothing differentiates
with respect to the cloud). Eval (`training=False`) then runs B9
(`ops/sa_group_cuda.py`): its selection for all four levels in one call,
and a gather a level once that level's features exist. On CUDA tensors
these are kernels, on CPU tensors or with `plain=True` their plain
versions. Training runs the plain `knn_indices` and index gathers under
torch autograd; the JAX package's scatter-free gather VJP and one-hot
gathers are TPU workarounds. The dtype policy is the JAX package's: geometry in f32,
features, products and activations at `dtype`, BatchNorm statistics in f32.
"""

from __future__ import annotations

import math

import torch

from ..core.batchnorm import apply_batchnorm, apply_batchnorm_train, init_batchnorm
from ..core.initializers import xavier_normal
from ..core.mlp import apply_mlp, gelu, init_mlp
from ..ops.fps_cuda import furthest_point_sampling_levels, furthest_point_sampling_levels_plain
from ..ops.knn import gather_neighbors, knn_indices, three_nn_interpolate
from ..ops.paconv_ops import paconv_assign_score
from ..ops.sa_group_cuda import sa_gather, sa_gather_plain, sa_select_levels, sa_select_plain


def SA_MLPS(c: int) -> list:
    return [[c, 32, 32, 64], [64, 64, 64, 128], [128, 128, 128, 256], [256, 256, 256, 512]]


def FP_MLPS(c: int) -> list:
    return [[128 + c, 128, 128, 128], [256 + 64, 256, 128], [256 + 128, 256, 256],
            [512 + 256, 256, 256]]


NSAMPLE = 32
SCORENET_HIDDEN = [16]
M_KERNELS = 8


def _batchnorm(params, state, x, training):
    if training:
        return apply_batchnorm_train(params, state, x)
    return apply_batchnorm(params, state, x), state


def _init_scorenet(gen, in_dim: int, m: int):
    """ScoreNet: 1x1 convs with BatchNorm and ReLU, the last with a bias and
    no BatchNorm (its params and state are None), softmax over the m kernels."""
    dims = [in_dim] + SCORENET_HIDDEN + [m]
    layers, states = [], []
    for i in range(len(dims) - 1):
        last = i == len(dims) - 2
        bn_p, bn_s = (None, None) if last else init_batchnorm(dims[i + 1])
        layers.append({"lin": xavier_normal(gen, dims[i], dims[i + 1], bias=last), "bn": bn_p})
        states.append(bn_s)
    return {"layers": layers}, {"layers": states}


def _apply_scorenet(params, state, xyz_feat, *, training):
    """(B, N, K, in_dim) -> (scores (B, N, K, m) softmaxed in f32 and cast
    back, new_state), at the input's dtype."""
    h = xyz_feat
    dt = h.dtype
    new_states = []
    n_layers = len(params["layers"])
    for i, (layer, bn_state) in enumerate(zip(params["layers"], state["layers"])):
        h = h @ layer["lin"]["w"].to(dt)
        if "b" in layer["lin"]:
            h = h + layer["lin"]["b"].to(dt)
        if i < n_layers - 1:
            h, bn_state = _batchnorm(layer["bn"], bn_state, h, training)
            h = torch.relu(h).to(dt)
        new_states.append(bn_state)
    return torch.softmax(h.float(), -1).to(dt), {"layers": new_states}


def _init_paconv_layer(gen, in_dim: int, out_dim: int):
    score_p, score_s = _init_scorenet(gen, 3, M_KERNELS)
    # kaiming-normal on (m, 2 in, out) (torch's fan_in of a 3-D tensor is
    # size(1) * size(2)), laid out (2 in, m out)
    std = math.sqrt(2.0 / (in_dim * 2 * out_dim))
    bank = std * torch.randn((M_KERNELS, in_dim * 2, out_dim), generator=gen)
    bank = bank.transpose(0, 1).reshape(in_dim * 2, M_KERNELS * out_dim).contiguous()
    bn_p, bn_s = init_batchnorm(out_dim)
    return ({"scorenet": score_p, "weightbank": bank, "bn": bn_p},
            {"scorenet": score_s, "bn": bn_s})


def _apply_paconv_layer(params, state, feats, grouped_xyz_diff, *, training):
    """feats (B, N1, K, C) grouped, slot 0 the centre; grouped_xyz_diff
    (B, N1, K, 3) -> ((B, N1, K, O), new_state)."""
    in_feat = torch.cat((feats - feats[:, :, :1, :], feats), -1)
    scores, score_state = _apply_scorenet(params["scorenet"], state["scorenet"],
                                          grouped_xyz_diff.to(feats.dtype), training=training)
    out = paconv_assign_score(in_feat, params["weightbank"].to(in_feat.dtype), scores,
                              M_KERNELS)
    out, bn_state = _batchnorm(params["bn"], state["bn"], out, training)
    return torch.relu(out).to(in_feat.dtype), {"scorenet": score_state, "bn": bn_state}


def _init_shared_mlp(gen, dims):
    layers, states = [], []
    for i in range(len(dims) - 1):
        bn_p, bn_s = init_batchnorm(dims[i + 1])
        layers.append({"lin": xavier_normal(gen, dims[i], dims[i + 1], bias=False), "bn": bn_p})
        states.append(bn_s)
    return {"layers": layers}, {"layers": states}


def _apply_shared_mlp(params, state, h, *, training):
    dt = h.dtype
    new_states = []
    for layer, bn_state in zip(params["layers"], state["layers"]):
        h = h @ layer["lin"]["w"].to(dt)
        if "b" in layer["lin"]:
            h = h + layer["lin"]["b"].to(dt)
        if layer["bn"] is not None:
            h, bn_state = _batchnorm(layer["bn"], bn_state, h, training)
        h = torch.relu(h).to(dt)
        new_states.append(bn_state)
    return h, {"layers": new_states}


def init_pointnet2_paconv(gen: torch.Generator, *, c: int = 3, k: int = 64,
                          out_mlp_dims=(512, 512, 512)):
    """Params and state; c = non-xyz feature channels, k = embedding width."""
    params = {"sa": [], "fp": []}
    state = {"sa": [], "fp": []}
    for spec in SA_MLPS(c):
        dims = [spec[0] + 3] + spec[1:]     # use_xyz: the xyz diff rides in front
        pairs = [_init_paconv_layer(gen, dims[j], dims[j + 1]) for j in range(len(dims) - 1)]
        params["sa"].append([p for p, _ in pairs])
        state["sa"].append([s for _, s in pairs])
    for spec in FP_MLPS(c):
        p, s = _init_shared_mlp(gen, spec)
        params["fp"].append(p)
        state["fp"].append(s)
    params["out_mlp"] = init_mlp(gen, 128, list(out_mlp_dims), k)
    return params, state


def _sa_level(params, state, xyz, feats, idx, new_xyz, sel, *, training, plain):
    """One set-abstraction level of the cloud xyz (B, N, 3) from its FPS
    picks idx (B, N // 4) and their coordinates new_xyz (B, N // 4, 3); sel
    (eval) the level's slot lists from B9's selection -> (features
    (B, N // 4, O), new_states)."""
    if not training:
        h = (sa_gather_plain if plain else sa_gather)(sel, new_xyz, xyz, feats)
        grouped_xyz_diff = h[..., :3]
    else:
        knn = knn_indices(new_xyz.detach(), xyz.detach(), NSAMPLE, self_idx=idx)
        grouped_xyz_diff = (gather_neighbors(xyz, knn) - new_xyz[:, :, None, :]).to(feats.dtype)
        h = torch.cat((grouped_xyz_diff, gather_neighbors(feats, knn)), -1)
    new_states = []
    for lp, ls in zip(params, state):
        h, ns = _apply_paconv_layer(lp, ls, h, grouped_xyz_diff, training=training)
        new_states.append(ns)
    return h.amax(2), new_states


def apply_pointnet2_paconv(params, state, pointcloud: torch.Tensor, *, training: bool = False,
                           dtype=None, plain: bool = False):
    """pointcloud (B, N, 3 + c) -> ((B, N, k), new_state).

    dtype: the compute dtype of the features, products and activations
    (None keeps f32); the geometry (FPS, kNN, 3-NN) stays f32 and BatchNorm
    statistics are f32. In eval the state comes back unchanged."""
    xyz = pointcloud[..., :3].float().contiguous()  # one copy for B8, B9 and the 3-NN
    feats = pointcloud[..., 3:]
    if dtype is not None:
        feats = feats.to(dtype)
    ms = [xyz.shape[1] // 4 ** (i + 1) for i in range(4)]
    fps = furthest_point_sampling_levels_plain if plain else furthest_point_sampling_levels
    idxs, centres = fps(xyz.detach(), ms)
    l_xyz, l_feats = [xyz, *centres], [feats]
    sels = [None] * 4
    if not training:
        levels = list(zip(centres, idxs, l_xyz))
        sels = ([sa_select_plain(*lv, NSAMPLE) for lv in levels] if plain
                else sa_select_levels(levels, NSAMPLE))
    new_state = {"sa": [], "fp": [None] * 4}
    for i in range(4):
        nf, ns = _sa_level(params["sa"][i], state["sa"][i], l_xyz[i], l_feats[i], idxs[i],
                           centres[i], sels[i], training=training, plain=plain)
        l_feats.append(nf)
        new_state["sa"].append(ns)
    for i in range(-1, -5, -1):
        interp = three_nn_interpolate(l_xyz[i - 1], l_xyz[i], l_feats[i]).to(l_feats[i].dtype)
        skip = l_feats[i - 1]
        h = torch.cat([interp, skip], -1) if skip.shape[-1] else interp
        h, new_state["fp"][i] = _apply_shared_mlp(params["fp"][i], state["fp"][i], h,
                                                  training=training)
        l_feats[i - 1] = h
    return apply_mlp(params["out_mlp"], l_feats[0], gelu, dtype=dtype), new_state
