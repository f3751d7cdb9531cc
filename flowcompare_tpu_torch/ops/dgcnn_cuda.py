"""The whole eval DGCNN encoder (B4), its folds and its plain version.

Counterpart of `flowcompare_tpu/ops/dgcnn_pallas.py` (`fold_dgcnn`,
`fused_dgcnn_encoder`). Per EdgeConv stage, with W = [W_diff; W_self] and
the BatchNorm slope sign folded into W_diff:

    u' = h @ (W_diff * sign)   c = h @ (W_self - W_diff)
    mx = max of u' over the exact kNN of h          (B3)
    y  = leaky((sign * mx + c) * a + b)             (eval BatchNorm folded)

then conv5 on the 512-wide concat of the four stage outputs with its
BatchNorm folded and leaky-0.2, then the residual head (512 x 6 -> 64).
With `head=False` (DGCNNembedderGlobal) the encoder stops at the post-conv5
trunk (B, N, 512) bf16; the global pool and the 1024-wide head then run in
torch on the (B, 1024) vector, as the JAX package runs them in XLA
(`encoders/dgcnn.py`). Eval only.
"""

from __future__ import annotations

import torch

from ..core.initializers import matmul_f32
from ..core.mlp import gelu
from . import _build
from .edgeconv_cuda import edge_neighbor_max_plain, launch_knn_edge_max

FUSED_DGCNN_ENCODER_LAUNCHES = 0


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def fold_dgcnn(params: dict, state: dict, *, bn_eps: float = 1e-5) -> dict:
    """Per stage: W_diff with the BN slope sign folded in (bf16), W_self - W_diff
    (bf16), the sign and the eval BatchNorm as y = z * a + b (f32); conv5's
    weight and BN fold; the head layers (bf16 weights, f32 biases)."""
    bf = torch.bfloat16
    folds = {"stages": [], "head": []}
    for i in range(1, 5):
        p, s = params[f"conv{i}"], state[f"bn{i}"]
        w = p["conv"]["w"].float()
        cin = w.shape[0] // 2
        a = p["bn"]["scale"].float() * torch.rsqrt(s["var"].float() + bn_eps)
        sign = torch.where(a >= 0, 1.0, -1.0)
        folds["stages"].append({
            "wd": (w[:cin] * sign[None, :]).to(bf),
            "wdelta": (w[cin:] - w[:cin]).to(bf),
            "sign": sign,
            "a": a,
            "b": p["bn"]["bias"].float() - s["mean"].float() * a,
        })
    p5, s5 = params["conv5"], state["bn5"]
    a5 = p5["bn"]["scale"].float() * torch.rsqrt(s5["var"].float() + bn_eps)
    folds["w5"] = p5["conv"]["w"].to(bf)
    folds["a5"] = a5
    folds["b5"] = p5["bn"]["bias"].float() - s5["mean"].float() * a5
    mlp = params["out_mlp"]
    for lay in [mlp["in"], *mlp["hidden"], mlp["out"]]:
        folds["head"].append((lay["w"].to(bf), lay["b"].float()))
    return folds


def fused_dgcnn_encoder_plain(x: torch.Tensor, params: dict, state: dict, *,
                              k: int, head: bool = True) -> torch.Tensor:
    """Plain version of B4: x (B, N, in) -> (B, N, emb) bf16, or with
    head=False the post-conv5 trunk (B, N, 512) bf16."""
    bf = torch.bfloat16
    folds = fold_dgcnn(params, state)
    h = x.to(bf)
    feats = []
    for st in folds["stages"]:
        c = matmul_f32(h, st["wdelta"])
        u = matmul_f32(h, st["wd"]).to(bf)
        mx = edge_neighbor_max_plain(h, u, k)
        h = _leaky((st["sign"] * mx.float() + c) * st["a"] + st["b"]).to(bf)
        feats.append(h)
    y5 = _leaky(matmul_f32(torch.cat(feats, -1), folds["w5"]) * folds["a5"]
                + folds["b5"]).to(bf)
    if not head:
        return y5
    layers = folds["head"]
    cur = gelu(matmul_f32(y5, layers[0][0]) + layers[0][1]).to(bf)
    residual = cur
    for index in range(1, len(layers) - 1):
        w, b = layers[index]
        if (index - 1) % 2 == 0:
            residual = cur
            cur = gelu(matmul_f32(cur, w) + b).to(bf)
        else:
            cur = gelu(residual.float() + (matmul_f32(cur, w) + b)).to(bf)
    return (matmul_f32(cur, layers[-1][0]) + layers[-1][1]).to(bf)


def fused_dgcnn_encoder(x: torch.Tensor, params: dict, state: dict, *,
                        k: int, head: bool = True) -> torch.Tensor:
    """B4: the whole eval DGCNN; replaces the Pallas kernel
    `fused_dgcnn_encoder` (dgcnn_pallas.py, body `_kernel`).

    x (B, N, in) -> per-point (B, N, emb) bf16, or with head=False the
    post-conv5 trunk (B, N, 512) bf16; `params` already in the compute dtype,
    `state` the BatchNorm running statistics. A CPU tensor runs
    `fused_dgcnn_encoder_plain`; a CUDA tensor runs a fixed chain of the
    port's kernels: per stage gemm_bf16 for c and for u', then knn_edge_max
    (B3) with the BatchNorm-leaky epilogue writing straight into the stage's
    columns of the 512-wide concat; gemm with the folded-BN leaky epilogue
    for conv5; the head as gemm launches with GELU and residual epilogues
    (skipped with head=False).

    What bounds it on the H100: the four kNN stages (B3: the L2 gathers of
    u' and of the candidate rows; the distances run on the tensor cores and
    the radix select sweeps each row 2-5 times); the products are small
    (K <= 512).
    Stage outputs never leave their concat buffer, and the next stage reads
    its input from there, so no concat copy is made."""
    global FUSED_DGCNN_ENCODER_LAUNCHES
    if not x.is_cuda:
        return fused_dgcnn_encoder_plain(x, params, state, k=k, head=head)
    bf = torch.bfloat16
    folds = fold_dgcnn(params, state)
    b, n, in_dim = x.shape
    rows, dev = b * n, x.device
    widths = [st["wd"].shape[1] for st in folds["stages"]]
    feats = torch.empty(rows, sum(widths), dtype=bf, device=dev)
    u = torch.empty(rows, max(widths), dtype=bf, device=dev)
    c = torch.empty(rows, max(widths), dtype=torch.float32, device=dev)
    h = x.to(bf).contiguous().reshape(rows, in_dim)
    ofs = 0
    for st, cout in zip(folds["stages"], widths):
        _build.gemm(h, st["wdelta"].contiguous(), c[:, :cout])
        _build.gemm(h, st["wd"].contiguous(), u[:, :cout])
        out = feats[:, ofs:ofs + cout]
        launch_knn_edge_max(h, u[:, :cout], out, n_items=b, k=k,
                            epilogue=(c[:, :cout], st["sign"].contiguous(),
                                      st["a"].contiguous(), st["b"].contiguous()))
        h = out
        ofs += cout
    w5 = folds["w5"].contiguous()
    y5 = torch.empty(rows, w5.shape[1], dtype=bf, device=dev)
    _build.gemm(feats, w5, y5, affine=(folds["a5"].contiguous(), folds["b5"].contiguous()))
    FUSED_DGCNN_ENCODER_LAUNCHES += 1
    if not head:
        return y5.reshape(b, n, -1)
    layers = [(w.contiguous(), bb.contiguous()) for w, bb in folds["head"]]
    hmax = max(w.shape[1] for w, _ in layers)
    bufs = [torch.empty(rows, hmax, dtype=bf, device=dev) for _ in range(3)]
    emb = torch.empty(rows, layers[-1][0].shape[1], dtype=bf, device=dev)
    _build.mlp_chain(y5, layers, emb, bufs)
    return emb.reshape(b, n, -1)
