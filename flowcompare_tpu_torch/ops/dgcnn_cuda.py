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

`fold_dgcnn` is the spec of the folds and `fused_dgcnn_encoder_plain` folds
on every call. The kernels read `EncoderWeights`, the same folds in their
layout, made once per weights version by `encoder_weights` (a `FoldCache`
keyed on the parameter and BatchNorm-state tensors, their casts to the
compute dtype included; `DGCNN_FOLDS` counts the folds it made).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.initializers import matmul_f32
from ..core.mlp import cast_tree, gelu
from . import _build
from .edgeconv_cuda import edge_neighbor_max_plain, launch_knn_edge_max
from .flow_layer_cuda import _pad_cols, _round8
from .fold_cache import FoldCache, tensor_leaves

FUSED_DGCNN_ENCODER_LAUNCHES = 0
DGCNN_FOLDS = 0          # EncoderWeights made by encoder_weights (one per weights version)
_FOLDS = FoldCache()


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
                              k: int, head: bool = True, cast=None) -> torch.Tensor:
    """Plain version of B4: x (B, N, in) -> (B, N, emb) bf16, or with
    head=False the post-conv5 trunk (B, N, 512) bf16; `cast` the dtype the
    params are cast to first (None: they are in it already)."""
    bf = torch.bfloat16
    folds = fold_dgcnn(params if cast is None else cast_tree(params, cast), state)
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


def dgcnn_tail_plan(conv5: tuple, head: Optional[list]) -> dict:
    """What B4's tail kernel (csrc/fused_layer.cu, kind dgcnn_tail) runs, from
    shapes alone: conv5's (K, N), the head's (K, N) per product or None
    (head=False). It takes widths up to 2,048 (`_build.FUSED_MAXW`; past 512
    the wide kernel, its row tile's activations in device scratch), conv5's
    input up to 1,024 (`_build.FUSED_IN_W`), at most 10 products, each
    reading the width the one before gave, and an output width that is a
    multiple of 8 (16-byte rows); other shapes raise ValueError, and there
    is no other route for them."""
    shapes = [tuple(conv5)] + [tuple(w) for w in (head or [])]
    ok = (len(shapes) <= _build.FUSED_MAX_PRODUCTS and shapes[0][0] <= _build.FUSED_IN_W
          and all(1 <= kk <= _build.FUSED_MAXW and 1 <= nn <= _build.FUSED_MAXW
                  for kk, nn in shapes)
          and all(shapes[i][0] == shapes[i - 1][1] for i in range(1, len(shapes)))
          and shapes[-1][1] % 8 == 0)
    if not ok:
        raise ValueError(f"the DGCNN tail kernel cannot take these shapes: conv5 {shapes[0]}, "
                         f"head {shapes[1:] if head is not None else None}")
    return {"products": len(shapes), "in_cols": shapes[0][0], "out_cols": shapes[-1][1]}


def dgcnn_tail_plain(feats: torch.Tensor, pairs: list, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of `_build.dgcnn_tail`, at the kernel's rounding points:
    y5 = bf16(leaky(f32(feats @ w5) * a5 + b5)), then the head's products
    (GELU after each but the last, a residual every second hidden product,
    bf16 between them), the last one bf16(v + b). `pairs` are the tail's
    (w (K, N), b (N)) at one layer, conv5 first; `scale` is a5 (N0)."""
    bf = torch.bfloat16
    w5, b5 = pairs[0]
    cur = _leaky(matmul_f32(feats, w5) * scale.float() + b5.float()).to(bf)
    if len(pairs) == 1:
        return cur
    w, b = pairs[1]
    cur = gelu(matmul_f32(cur, w) + b.float()).to(bf)
    residual = cur
    for index, (w, b) in enumerate(pairs[2:-1]):
        if index % 2 == 0:
            residual = cur
            cur = gelu(matmul_f32(cur, w) + b.float()).to(bf)
        else:
            cur = gelu(residual.float() + (matmul_f32(cur, w) + b.float())).to(bf)
    w, b = pairs[-1]
    return (matmul_f32(cur, w) + b.float()).to(bf)


class EncoderWeights:
    """`fold_dgcnn`'s folds in the layout B4's kernels read, made once per
    weights version (`encoder_weights`):

    * per EdgeConv stage one weight (K, 2 cout) bf16 = [W_self - W_diff |
      W_diff * sign] for the stage's one product (c in f32, u' in bf16), its
      rows padded to a multiple of 8 with zero rows: the first stage reads
      the cloud cast into 8 bf16 columns, 16-byte rows that TMA can read,
      and the zero rows meet its zero columns; sign, a and b for B3's
      epilogue;
    * the tail's products as `FusedStack`s of one layer: `trunk` holds conv5
      alone (head=False), `embedding` conv5 and the head (None where the
      head does not read conv5's 512 columns: the global encoder's, which
      reads the pooled vector); `scale` is conv5's folded BatchNorm slope."""

    def __init__(self, params: dict, state: dict):
        bf = torch.bfloat16
        folds = fold_dgcnn(params, state)
        self.stages = []
        for st in folds["stages"]:
            cin, cout = st["wd"].shape
            w = torch.zeros(_round8(cin), 2 * cout, dtype=bf, device=st["wd"].device)
            w[:cin] = torch.cat([st["wdelta"], st["wd"]], 1)
            self.stages.append({"w": w, "cin": cin, "cout": cout,
                                "sign": st["sign"].contiguous(), "a": st["a"].contiguous(),
                                "b": st["b"].contiguous()})
        pairs = [(_pad_cols(folds["w5"][None].to(bf)), folds["b5"][None].contiguous())]
        pairs += [(_pad_cols(w[None].to(bf)), b[None].float().contiguous())
                  for w, b in folds["head"]]
        self.scale = folds["a5"][None].contiguous()
        concat = sum(st["cout"] for st in self.stages)
        dgcnn_tail_plan((concat, pairs[0][0].shape[2]), None)
        self.trunk = _build.FusedStack(pairs[:1], 1)
        self.embedding = None
        if pairs[1][0].shape[1] == pairs[0][0].shape[2]:
            dgcnn_tail_plan((concat, pairs[0][0].shape[2]),
                            [tuple(w.shape[1:]) for w, _ in pairs[1:]])
            self.embedding = _build.FusedStack(pairs, len(pairs))

    def tail(self, head: bool) -> "_build.FusedStack":
        if not head:
            return self.trunk
        if self.embedding is None:
            raise ValueError("the head of these params reads the pooled vector, not conv5's "
                             "rows: run B4 with head=False")
        return self.embedding


def encoder_weights(params: dict, state: dict, *, cast=None) -> EncoderWeights:
    """B4's `EncoderWeights` for these params (cast to `cast` first, if
    given) and BatchNorm state, folded once per weights version: a lookup
    keyed on the tensors and their versions, which every in-place change
    (an optimizer step, `load_state`, `load_jax_params`) bumps."""
    def build():
        global DGCNN_FOLDS
        DGCNN_FOLDS += 1
        with torch.no_grad():
            return EncoderWeights(params if cast is None else cast_tree(params, cast), state)

    return _FOLDS.get(tensor_leaves(params) + tensor_leaves(state), cast, build)


def fused_dgcnn_encoder(x: torch.Tensor, params: dict, state: dict, *,
                        k: int, head: bool = True, cast=None) -> torch.Tensor:
    """B4: the whole eval DGCNN; replaces the Pallas kernel
    `fused_dgcnn_encoder` (dgcnn_pallas.py, body `_kernel`).

    x (B, N, in) -> per-point (B, N, emb) bf16, or with head=False the
    post-conv5 trunk (B, N, 512) bf16; `params` in the compute dtype, or cast
    to `cast` here; `state` the BatchNorm running statistics. A CPU tensor
    runs `fused_dgcnn_encoder_plain`; a CUDA tensor runs, on weights folded
    once per weights version (`encoder_weights`), 10 launches: the cloud cast
    into 8 bf16 columns (`_build.pack_rows`), per stage one product (c in
    f32 and u' in bf16 from one wgmma GEMM) and knn_edge_max (B3) with the
    BatchNorm-leaky epilogue writing straight into the stage's columns of
    the 512-wide concat, and the tail (`_build.dgcnn_tail`: conv5 and the
    head on a 64-row tile kept in shared memory, or conv5 alone with
    head=False).

    What bounds it on the H100: the four kNN stages (B3: the L2 gathers of
    u' and of the candidate rows; the distances run on the tensor cores)
    and the tail's eight 512-wide products (about 3.7 MFLOP a point); at a
    small batch the host's launches. Stage outputs never leave their concat
    buffer and the tail reads it once; the head's activations stay on chip."""
    global FUSED_DGCNN_ENCODER_LAUNCHES
    if not x.is_cuda:
        return fused_dgcnn_encoder_plain(x, params, state, k=k, head=head, cast=cast)
    out = _encoder_chain(x, encoder_weights(params, state, cast=cast), k, head)
    FUSED_DGCNN_ENCODER_LAUNCHES += 1
    return out


def _encoder_chain(x: torch.Tensor, w: EncoderWeights, k: int, head: bool) -> torch.Tensor:
    stack = w.tail(head)
    bf = torch.bfloat16
    b, n, _ = x.shape
    rows, dev = b * n, x.device
    widths = [st["cout"] for st in w.stages]
    h = torch.empty(rows, w.stages[0]["w"].shape[0], dtype=bf, device=dev)
    _build.pack_rows(h, x.float())
    feats = torch.empty(rows, sum(widths), dtype=bf, device=dev)
    u = torch.empty(rows, max(widths), dtype=bf, device=dev)
    c = torch.empty(rows, max(widths), dtype=torch.float32, device=dev)
    ofs = 0
    for st in w.stages:
        cout = st["cout"]
        _build.gemm(h, st["w"], c[:, :cout], out2=u[:, :cout], out2_from=cout)
        out = feats[:, ofs:ofs + cout]
        launch_knn_edge_max(h, u[:, :cout], out, n_items=b, k=k,
                            epilogue=(c[:, :cout], st["sign"], st["a"], st["b"]))
        h = out
        ofs += cout
    emb = torch.empty(rows, stack.pairs[-1][0].shape[2], dtype=bf, device=dev)
    _build.dgcnn_tail(feats, stack, w.scale, emb)
    return emb.reshape(b, n, -1)
