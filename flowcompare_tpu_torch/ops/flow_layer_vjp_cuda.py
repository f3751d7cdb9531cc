"""The trainable flow-layer stack: B1 with saves forward, B5 backward.

Counterpart of `flowcompare_tpu/ops/flow_layer_vjp_pallas.py`:

* `fused_flow_layers_trainable` (replaces the custom VJP of the same name)
  is a `torch.autograd.Function` on CUDA tensors: its forward is B1 with
  dense bf16 saves (`flow_layer_cuda.fused_flow_layers(save=True)`), its
  backward `flow_layers_bwd`. On CPU tensors it is autograd through the
  plain bf16 stack (`fused_flow_layers_plain`).
* `flow_layers_bwd` (B5, replaces the Pallas kernel `flow_layers_bwd`, body
  `_bwd_kernel_impl`) walks the layers in reverse from the saves and
  returns dx, dcontext, dextra and an f32 gradient of every folded stack,
  keyed like the JAX package's `_flatten_folded`. The gradient of
  `lu_ldj_f` is sum(dldj) for every layer; dldj passes through unchanged.
* `flow_layers_bwd_plain` is its plain version: per layer, autograd of the
  one-layer bf16 `folded_scan_core` re-linearised at the bf16 save, as the
  JAX kernel calls jax.vjp on `_layer_fwd_math`.
* On CUDA tensors `flow_layers_bwd` runs `_bwd_fused`: per layer the fused
  kernels' record mode (the recompute), their backward kernels
  (csrc/fused_layer_bwd.cu), the attention's launches and the grouped
  weight gradients with their sums (csrc/gemm_tn_grouped.cu); the plain
  versions of those kernels live here (`conditioner_record_plain`,
  `coupling_record_plain`, `coupling_bwd_plain`, `conditioner_bwd_plain`)
  and `flow_layers_bwd_fused_plain` runs the same route with every launch's
  plain version. `_bwd_per_product`, the chain of per-product launches it
  replaced, stays as chip_smoke.py's comparison route.

Gradients reach the raw parameters through `fold_stacks`' einsums by
ordinary autograd, as in the JAX package. Dropped from the JAX module: the
identity-layer padding to a multiple of `_K_SEG` and the segmented sparse
saves (TPU-runtime workarounds), the bf16-residual and unroll flags and the
ablation switches (TPU tuning).
"""

from __future__ import annotations

import types
from typing import Optional

import torch

from ..core.mlp import gelu
from . import _build
from . import flow_layer_cuda as flc

FLOW_LAYERS_BWD_LAUNCHES = 0


# --------------------------------------------------------------- flattening

def stack_names(n_pre: int, n_cpl: int, has_attn: bool = True) -> list:
    """The folded stacks in the JAX package's `_stack_names(n_pre, n_cpl,
    has_attn)` order, plus lu_ldj_f; without attention no pre-MLP, wq_f,
    bq_f or wkv."""
    attn = ([f"pre_w{i}" for i in range(n_pre)] + [f"pre_b{i}" for i in range(n_pre)]
            + ["wq_f", "bq_f", "wkv"]) if has_attn else []
    return (attn + ["cpl_in_xe", "cpl_in_c", "cpl_in_b"]
            + [f"cpl_w{i}" for i in range(n_cpl - 1)] + [f"cpl_b{i}" for i in range(n_cpl - 1)]
            + ["lu_w_f", "lu_b", "lu_ldj_f"])


def flatten_folded(folded: dict) -> dict:
    """fold_stacks() output -> {name: (L, ...) tensor}, shapes as they are."""
    has_attn = folded["pre"] is not None
    out = {}
    for i, (w, b) in enumerate(folded["pre"] or []):
        out[f"pre_w{i}"], out[f"pre_b{i}"] = w, b
    for key in ("wq_f", "bq_f", "wkv", "cpl_in_xe", "cpl_in_c", "cpl_in_b"):
        out[key] = folded.get(key)
    for i, (w, b) in enumerate(folded["cpl_rest"]):
        out[f"cpl_w{i}"], out[f"cpl_b{i}"] = w, b
    for key in ("lu_w_f", "lu_b", "lu_ldj_f"):
        out[key] = folded[key]
    names = stack_names(len(folded["pre"] or []), folded["n_cpl"], has_attn)
    return {name: out[name] for name in names}


def unflatten_folded(flat: dict, n_cpl: int) -> dict:
    n_pre = sum(1 for k in flat if k.startswith("pre_w"))
    has_attn = "wq_f" in flat
    folded = {k: flat.get(k) for k in ("wq_f", "bq_f", "wkv", "cpl_in_xe", "cpl_in_c",
                                       "cpl_in_b", "lu_w_f", "lu_b", "lu_ldj_f")}
    folded["pre"] = ([(flat[f"pre_w{i}"], flat[f"pre_b{i}"]) for i in range(n_pre)]
                     if has_attn else None)
    folded["cpl_rest"] = [(flat[f"cpl_w{i}"], flat[f"cpl_b{i}"]) for i in range(n_cpl - 1)]
    folded["n_cpl"] = n_cpl
    return folded


# ------------------------------------------------------------ plain version

def flow_layers_bwd_plain(saves: torch.Tensor, dz: torch.Tensor, dldj: torch.Tensor,
                          context: torch.Tensor, extra: Optional[torch.Tensor], folded: dict, *,
                          eps_affine: float = 1e-8):
    """Plain version of B5. saves (L, B*N, LAT) bf16, dz (B, N, LAT), dldj
    (B, N). Returns (dx, dctx, dextra, {name: f32 gradient})."""
    b, n, lat = dz.shape
    flat = flatten_folded(folded)
    n_layers = flat["lu_ldj_f"].shape[0]
    grads = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
             for k, v in flat.items()}
    dctx = torch.zeros(context.shape, dtype=torch.float32, device=context.device)
    dextra = (torch.zeros(extra.shape, dtype=torch.float32, device=extra.device)
              if extra is not None else None)
    g = dz.float()
    dldj = dldj.float()
    zeros = torch.zeros(b, n, dtype=torch.float32, device=dz.device)
    for l in reversed(range(n_layers)):
        with torch.enable_grad():
            x = saves[l].float().reshape(b, n, lat).requires_grad_()
            ctx = context.detach().requires_grad_()
            ex = extra.detach().requires_grad_() if extra is not None else None
            ws = {k: v[l:l + 1].detach().requires_grad_() for k, v in flat.items()}
            z, ldj = flc.folded_scan_core(x, zeros, ctx, ex, unflatten_folded(ws, folded["n_cpl"]),
                                          nonlin=gelu, dtype=torch.bfloat16,
                                          eps_affine=eps_affine)
            wrt = [x, ctx] + ([ex] if ex is not None else []) + list(ws.values())
            outs = torch.autograd.grad((z, ldj), wrt, (g, dldj))
        g = outs[0]
        dctx += outs[1]
        if ex is not None:
            dextra += outs[2]
        for k, gw in zip(ws, outs[len(wrt) - len(ws):]):
            grads[k][l] = gw[0]
    return g, dctx, dextra, grads


# --------------------------------------------------------------- CUDA chain

def _mlp_forward_record(a0, pairs, pre, hs, out) -> None:
    """The residual MLP as gemm launches (as `_build.mlp_chain`), keeping each
    hidden layer's f32 pre-activation pre[i] and bf16 output hs[i]."""
    w, b = pairs[0]
    _build.gemm(a0, w, hs[0], bias=b, gelu=True, pre_out=pre[0])
    for i in range(1, len(pairs) - 1):
        w, b = pairs[i]
        res = hs[i - 2] if (i - 1) % 2 == 1 else None   # every second hidden layer
        _build.gemm(hs[i - 1], w, hs[i], bias=b, residual=res, gelu=True, pre_out=pre[i])
    w, b = pairs[-1]
    _build.gemm(hs[-1], w, out, bias=b)


def _mlp_backward(pairs, pre, hs, d_out, d_out_b, dps, dps_b, gw, gb, ws) -> None:
    """Transpose of `_mlp_forward_record` from the output gradient: dp[i], the
    pre-activation gradients (f32 and bf16), and the weight and bias
    gradients of layers 1.. into gw[i] / gb[i]; layer 0's are the caller's."""
    n = len(pairs)
    _build.gemm_tn(hs[n - 2], d_out_b, gw[n - 1], ws["tn"])
    _build.colsum(d_out, gb[n - 1], ws["cs"])
    for i in range(n - 2, -1, -1):
        nxt = d_out_b if i == n - 2 else dps_b[i + 1]
        res = dps[i + 2] if i % 2 == 0 and i + 2 <= n - 2 else None  # the residual's gradient
        _build.gemm(nxt, pairs[i + 1][0], dps[i], trans_b=True, residual=res,
                    gelu_grad=pre[i], out2=dps_b[i])
        if i > 0:
            _build.gemm_tn(hs[i - 1], dps_b[i], gw[i], ws["tn"])
            _build.colsum(dps[i], gb[i], ws["cs"])


def flow_layers_bwd(saves: torch.Tensor, dz: torch.Tensor, dldj: torch.Tensor,
                    context: torch.Tensor, extra: Optional[torch.Tensor], folded: dict, *,
                    eps_affine: float = 1e-8, nonlin: str = "GELU"):
    """B5: the training backward of the folded layer stack; replaces the
    Pallas kernel `flow_layers_bwd` (flow_layer_vjp_pallas.py, body
    `_bwd_kernel_impl`).

    saves (L, B*N, LAT) bf16 from `fused_flow_layers(save=True)`, dz
    (B, N, LAT) and dldj (B, N) the output cotangents, context (B, Nc, 64)
    (or the broadcast embedding (B, N, E) without attention), extra
    (B, N, e) or None. Returns (dx (B, N, LAT) f32, dctx f32, dextra
    f32 or None, {name: (L, ...) f32}). A CPU tensor runs
    `flow_layers_bwd_plain`; a CUDA tensor runs `_bwd_fused`: per layer from
    the last, with no host sync,

    1. the recompute from saves[l]: the conditioner in record mode
       (`_build.conditioner_record`: the pre-MLP's f32 pre-activations and
       bf16 activations, q_in, qn and q, the x1 columns read from the save),
       ctx @ wkv, cross_attention with its row maximum and denominator, and
       the coupling MLP in record mode (`_build.coupling_record`: its
       pre-activations, activations and [s | t]);
    2. `_build.coupling_bwd`: g -> bf16, dy = g @ lu_w_f, the affine's
       transpose, the coupling MLP in reverse and the packed input's
       gradient (dx1, dextra, da), a 64-row tile on chip throughout;
    3. attn_bwd_prep, attention_bwd and dctx += dkv wkv^T;
    4. `_build.conditioner_bwd`: dq through wq_f^T, the LayerNorm's
       transpose and the pre-MLP in reverse into dx1;
    5. every weight gradient in one grouped launch (`_build.gemm_tn_grouped`,
       fixed K splits) and every sum of partials in one more
       (`_build.grad_reduce`: the splits, and the bias gradients' per-tile
       column sums that steps 1-4 wrote).

    That is 11 launches a layer with attention. Without attention (the
    global conditioner: context is the broadcast embedding (B, N, E), read
    row by row) steps 1's conditioner, 3 and 4 drop out: 4 launches a
    layer. The ctx columns of the packed rows are written once, the
    coupling record reads x1 from the save itself, the weight gradient of
    cpl_in_c is ctx^T dp, and dctx is row-wise, the ctx columns of the
    packed input's gradient accumulated in f32 over the layers (as the JAX
    kernel's `ctx_rowwise`); autograd then sums it over the points through
    the broadcast.

    Every product has bf16 operands and f32 sums; every reduction runs in a
    fixed order with no atomics, so the result is deterministic.

    What bounds it on the H100: about three times B1's products (the
    recompute, the input gradients and the weight gradients), about 18
    TFLOP at B=20 and 115 layers, so about 19 ms at the bf16 dense peak.
    The design keeps each layer's activations and gradients on chip within
    the fused kernels, writes only what the weight gradients and the next
    kernel read, reuses its scratch across layers (about 0.6 GB at B=20)
    and reads the saves once per layer."""
    global FLOW_LAYERS_BWD_LAUNCHES
    flc.require_gelu(nonlin)
    if not dz.is_cuda:
        return flow_layers_bwd_plain(saves, dz, dldj, context, extra, folded,
                                     eps_affine=eps_affine)
    out = _bwd_fused(saves, dz, dldj, context, extra, folded, eps_affine)
    FLOW_LAYERS_BWD_LAUNCHES += 1
    return out


def _bwd_per_product(saves, dz, dldj, context, extra, folded, eps_affine):
    """B5 as the per-product chain that preceded the fused kernels: one gemm
    or gemm_tn per product, a colsum per bias, the row passes of
    flow_rows_bwd.cu (35-40 launches a layer). Only chip_smoke.py calls it,
    as the comparison route of its B5 phase."""
    b, n, lat = dz.shape
    rows, dev = b * n, dz.device
    bf, f32 = torch.bfloat16, torch.float32
    split = lat // 2
    half = lat - split
    ed = extra.shape[-1] if extra is not None else 0
    nc, e_dim = context.shape[1], context.shape[2]
    has_attn = folded["pre"] is not None
    d = folded["cpl_in_c"].shape[1]          # the attention width, or E without attention
    # the packed rows [x1 | extra | pad | cond] of B1's chain: cond from column xc
    xe, xc, xin_width = flc.packed_input_layout(split, ed, d)
    n_layers = folded["lu_ldj_f"].shape[0]
    if tuple(saves.shape) != (n_layers, rows, lat) or saves.dtype != bf:
        raise ValueError(f"flow_layers_bwd: saves must be ({n_layers}, {rows}, {lat}) bf16, "
                         f"got {tuple(saves.shape)} {saves.dtype}")
    if not has_attn and (nc != n or e_dim != d):
        raise ValueError(f"flow_layers_bwd: the global conditioner reads the context row by "
                         f"row: expected ({b}, {n}, {d}), got {tuple(context.shape)}")

    cpl = flc._bf16_stack(folded["cpl_rest"])
    w_in = flc._pad_cols(flc.packed_input_weights(folded["cpl_in_xe"].to(bf),
                                                  folded["cpl_in_c"]))
    b_in = folded["cpl_in_b"].float().reshape(n_layers, -1).contiguous()
    lu_w = flc._pad_cols(folded["lu_w_f"].to(bf))
    flat = flatten_folded(folded)
    grads = {k: torch.empty(v.shape, dtype=f32, device=dev) for k, v in flat.items()}

    def f32m(c):
        return torch.empty(rows, c, dtype=f32, device=dev)

    def bfm(c):
        return flc.bf16_rows(rows, c, dev)

    cpl_w = [w_in.shape[-1]] + [w.shape[-1] for w, _ in cpl]
    # recompute scratch: the packed coupling-input rows [x1 | extra | pad | cond];
    # the pad columns are zero and meet w_in's zero rows, and their gradient
    # columns are never formed (cpl_in_xe's gradient reads xin[:, :xe])
    xin = torch.empty(rows, xin_width, dtype=bf, device=dev)
    xin[:, xe:xc].zero_()
    if extra is not None:
        _build.cast_rows(extra.reshape(rows, ed).float().contiguous(), xin[:, split:xe])
    cp, ch = [f32m(c) for c in cpl_w[:-1]], [bfm(c) for c in cpl_w[:-1]]
    st = f32m(cpl_w[-1])
    # backward scratch
    g = dz.reshape(rows, lat).float().contiguous().clone()
    g_next = f32m(lat)
    g_b, dy = bfm(lat), f32m(lat)
    y = bfm(lat)
    dst, dst_b = f32m(2 * half), bfm(2 * half)
    cdp, cdp_b = [f32m(c) for c in cpl_w[:-1]], [bfm(c) for c in cpl_w[:-1]]
    dextra = torch.zeros(rows, ed, dtype=f32, device=dev) if ed else None
    dldj_c = dldj.reshape(rows).float().contiguous()
    tn_shapes = ([(lat, lat, rows), (xe, cpl_w[0], rows), (d, cpl_w[0], rows)]
                 + [(cpl_w[i - 1], cpl_w[i], rows) for i in range(1, len(cpl_w))])
    if has_attn:
        attn = _AttnBwd(folded, context, rows, b, n_layers)
        tn_shapes += attn.tn_shapes(split)
        # dctx of the shared context rows, summed over layers
        dctx = torch.zeros(b * nc, e_dim, dtype=f32, device=dev)
    else:
        # the global conditioner: the same ctx columns for every layer, and a
        # row-wise dctx (B*N, E) summed over layers; autograd sums it over N
        xin[:, xc:xc + d].copy_(context.reshape(rows, d))
        dctx = torch.zeros(rows, d, dtype=f32, device=dev)
    ws = {"tn": torch.empty(max(1, max(_build.gemm_tn_workspace(*sh) for sh in tn_shapes)),
                            dtype=f32, device=dev),
          "cs": torch.empty(_build.colsum_workspace(
              max(rows, b * nc), max(cpl_w + [lat] + (attn.pre_w if has_attn else []))),
              dtype=f32, device=dev)}
    cpl_gw = [None] + [grads[f"cpl_w{i}"] for i in range(len(cpl))]
    cpl_gb = [None] + [grads[f"cpl_b{i}"] for i in range(len(cpl))]

    for l in reversed(range(n_layers)):
        xs = saves[l]
        cpl_l = [(w_in[l], b_in[l])] + flc._at(cpl, l)
        # 1. recompute layer l at its bf16 entry carry
        xin[:, :split].copy_(xs[:, :split])
        if has_attn:
            attn.forward(l, xin, split, xc)
        _mlp_forward_record(xin[:, :xc + d], cpl_l, cp, ch, st)
        # 2. LinearLU and the coupling epilogue
        _build.cast_rows(g, g_b)
        _build.gemm(g_b, lu_w[l], dy)
        _build.coupling_epilogue_bwd(st, xs, dy, dldj_c, dst, dst_b, g_next, y, split=split,
                                     eps_affine=eps_affine)
        _build.gemm_tn(g_b, y, grads["lu_w_f"][l], ws["tn"])
        _build.colsum(g, grads["lu_b"][l].view(-1), ws["cs"])
        # 3. the coupling MLP, its packed input [x1 | extra | cond]
        _mlp_backward(cpl_l, cp, ch, dst, dst_b, cdp, cdp_b,
                      [None] + [gw[l] for gw in cpl_gw[1:]],
                      [None] + [gb[l].view(-1) for gb in cpl_gb[1:]], ws)
        _build.gemm_tn(xin[:, :xe], cdp_b[0], grads["cpl_in_xe"][l], ws["tn"])
        _build.gemm_tn(xin[:, xc:xc + d], cdp_b[0], grads["cpl_in_c"][l], ws["tn"])
        _build.colsum(cdp[0], grads["cpl_in_b"][l].view(-1), ws["cs"])
        _build.gemm(cdp_b[0], w_in[l][:split], g_next[:, :split], trans_b=True, accumulate=True)
        if ed:
            _build.gemm(cdp_b[0], w_in[l][split:xe], dextra, trans_b=True, accumulate=True)
        if has_attn:
            # 4.-5. the attention, the q projection, row_norm and the pre-MLP
            _build.gemm(cdp_b[0], w_in[l][xc:xc + d], attn.da, trans_b=True)
            attn.backward(l, xin, split, xc, dctx, g_next, grads, ws)
        else:
            _build.gemm(cdp_b[0], w_in[l][xc:xc + d], dctx, trans_b=True, accumulate=True)
        g, g_next = g_next, g
    # lu_ldj_f adds a constant to every point's ldj in every layer
    total = torch.empty(1, dtype=f32, device=dev)
    _build.colsum(dldj_c.view(rows, 1), total, ws["cs"])
    grads["lu_ldj_f"].copy_(total.expand(n_layers).reshape(grads["lu_ldj_f"].shape))
    return (g.reshape(b, n, lat), dctx.reshape(b, nc, e_dim),
            dextra.reshape(b, n, ed) if ed else None, grads)


class _AttnBwd:
    """The attention conditioner's part of B5: its recompute (pre-MLP with
    the pre-activations kept, row_norm, q, ctx @ wkv, cross_attention with
    its row maximum and denominator) and its backward (cross_attention_bwd,
    dwkv = ctx^T dkv, dctx += dkv wkv^T, the q projection, row_norm_bwd and
    the pre-MLP in reverse into dx1), with their weights and scratch."""

    def __init__(self, folded: dict, context: torch.Tensor, rows: int, b: int, n_layers: int):
        bf, f32, dev = torch.bfloat16, torch.float32, context.device
        nc, e_dim = context.shape[1], context.shape[2]
        self.items = b
        self.pre = flc._bf16_stack(folded["pre"])
        self.wq = flc._pad_cols(folded["wq_f"].to(bf))
        self.bq = folded["bq_f"].float().reshape(n_layers, -1).contiguous()
        self.wkv = flc._pad_cols(folded["wkv"].to(bf))
        self.wkv_kv = flc.kv_weights(folded["wkv"])
        self.d = d = self.wq.shape[-1]
        self.ctx2 = flc._pad_cols(context.reshape(b * nc, e_dim).to(bf))
        self.pre_w = [w.shape[-1] for w, _ in self.pre]
        self.a_dim = a_dim = self.pre_w[-1]
        self.e_dim, self.ctx_rows = e_dim, b * nc

        def f32m(c):
            return torch.empty(rows, c, dtype=f32, device=dev)

        def bfm(c):
            return flc.bf16_rows(rows, c, dev)

        self.v0, kv_width = flc.kv_layout(d)
        self.kv = flc.bf16_rows(b * nc, kv_width, dev)
        self.pre_p, self.pre_h = [f32m(c) for c in self.pre_w[:-1]], [bfm(c) for c in self.pre_w[:-1]]
        self.q_in, self.qn, self.q = f32m(a_dim), bfm(a_dim), bfm(d)
        self.m_row = torch.empty(rows, dtype=f32, device=dev)
        self.den = torch.empty(rows, dtype=f32, device=dev)
        self.pdp, self.pdp_b = [f32m(c) for c in self.pre_w[:-1]], [bfm(c) for c in self.pre_w[:-1]]
        self.da, self.du, self.ddn = f32m(d), bfm(d), torch.empty(rows, dtype=f32, device=dev)
        self.dq, self.dq_b = f32m(d), bfm(d)
        self.dkv = torch.empty(b * nc, 2 * d, dtype=f32, device=dev)
        self.dkv_b = flc.bf16_rows(b * nc, 2 * d, dev)
        self.dqn, self.dq_in, self.dq_in_b = f32m(a_dim), f32m(a_dim), bfm(a_dim)
        self.rows = rows

    def tn_shapes(self, split: int) -> list:
        return ([(self.e_dim, 2 * self.d, self.ctx_rows), (self.a_dim, self.d, self.rows),
                 (split, self.pre_w[0], self.rows)]
                + [(self.pre_w[i - 1], self.pre_w[i], self.rows)
                   for i in range(1, len(self.pre_w))])

    def forward(self, l: int, xin, split: int, xc: int) -> None:
        d = self.d
        _mlp_forward_record(xin[:, :split], flc._at(self.pre, l), self.pre_p, self.pre_h,
                            self.q_in)
        _build.row_norm(self.q_in, self.qn)
        _build.gemm(self.qn, self.wq[l], self.q, bias=self.bq[l])
        _build.gemm(self.ctx2, self.wkv_kv[l], self.kv)
        _build.cross_attention(self.q, self.kv[:, :d], self.kv[:, self.v0:self.v0 + d],
                               xin[:, xc:xc + d], n_items=self.items, m_out=self.m_row,
                               den_out=self.den)

    def backward(self, l: int, xin, split: int, xc: int, dctx, g_next, grads, ws) -> None:
        """From self.da, the gradient of the attention columns xin[:, xc:xc+d]."""
        d = self.d
        pre_l = flc._at(self.pre, l)
        pre_gw = [grads[f"pre_w{i}"][l] for i in range(len(self.pre))]
        pre_gb = [grads[f"pre_b{i}"][l].view(-1) for i in range(len(self.pre))]
        # 4. the cross attention and the kv projection
        _build.attn_bwd_prep(self.da, xin[:, xc:xc + d], self.den, self.du, self.ddn)
        _build.attention_bwd(self.q, self.kv[:, :d], self.kv[:, self.v0:self.v0 + d], self.du,
                             self.ddn, self.m_row, self.dq, self.dq_b, self.dkv, self.dkv_b,
                             n_items=self.items)
        _build.gemm_tn(self.ctx2, self.dkv_b, grads["wkv"][l], ws["tn"])
        _build.gemm(self.dkv_b, self.wkv[l], dctx, trans_b=True, accumulate=True)
        # 5. the q projection, row_norm and the pre-MLP
        _build.gemm_tn(self.qn, self.dq_b, grads["wq_f"][l], ws["tn"])
        _build.colsum(self.dq, grads["bq_f"][l].view(-1), ws["cs"])
        _build.gemm(self.dq_b, self.wq[l], self.dqn, trans_b=True)
        _build.row_norm_bwd(self.q_in, self.dqn, self.dq_in, self.dq_in_b)
        _mlp_backward(pre_l, self.pre_p, self.pre_h, self.dq_in, self.dq_in_b, self.pdp,
                      self.pdp_b, pre_gw, pre_gb, ws)
        _build.gemm_tn(xin[:, :split], self.pdp_b[0], pre_gw[0], ws["tn"])
        _build.colsum(self.pdp[0], pre_gb[0], ws["cs"])
        _build.gemm(self.pdp_b[0], pre_l[0][0], g_next[:, :split], trans_b=True,
                    accumulate=True)


# ------------------------------------------- the fused per-layer kernels

def _tile_sums(v: torch.Tensor, bands: int = 1) -> torch.Tensor:
    """(R, C) -> (ceil(R / 64) * bands, C): the column sums of each band of
    ceil(64 / bands) rows of each 64-row tile, the partials the fused
    backward kernels write for the bias gradients (one band a tile but in
    the coupling head, where `coupling_head_bands` bands share the rows)."""
    tiles, rows = -(-v.shape[0] // 64), -(-64 // bands)
    pad = v.new_zeros(tiles * 64 - v.shape[0], v.shape[1])
    v = torch.cat([v.float(), pad]).reshape(tiles, 64, -1)
    v = torch.cat([v, v.new_zeros(tiles, bands * rows - 64, v.shape[-1])], 1)
    return v.reshape(tiles * bands, rows, -1).sum(1)


def coupling_head_bands(half: int) -> int:
    """Bands of rows of a tile in the coupling backward's head: 512 threads
    (csrc/fused_layer_bwd.cu's CONSUMERS) over half columns."""
    return 512 // half


def _mlp_record_plain(a: torch.Tensor, pairs: list, record) -> torch.Tensor:
    """The residual MLP on bf16 rows `a` (as `flow_layer_cuda._mlp_plain`),
    each product but the last writing GELU' at its f32 pre-activation and
    its bf16 activation into record.pre[i] / record.h[i]; returns the last
    product's f32 output."""
    bf = torch.bfloat16
    v = flc._lin(a, pairs[0], bf)
    h = gelu(v).to(bf)
    record.pre[0].copy_(_build.gelu_erf_grad(v))
    record.h[0].copy_(h)
    residual = h
    for k in range(len(pairs) - 2):
        if k % 2 == 0:
            residual = h
            v = flc._lin(h, pairs[k + 1], bf)
        else:
            v = residual.float() + flc._lin(h, pairs[k + 1], bf)
        h = gelu(v).to(bf)
        record.pre[k + 1].copy_(_build.gelu_erf_grad(v))
        record.h[k + 1].copy_(h)
    return flc._lin(h, pairs[-1], bf)


def conditioner_record_plain(xin: torch.Tensor, split: int, pairs: list, q: torch.Tensor,
                             record, x1_src: torch.Tensor, ln_rstd: torch.Tensor) -> None:
    """Plain version of `_build.conditioner_record` for one layer: `pairs`
    are the pre-MLP's (w, b) and then (wq_f, bq_f). xin's x1 columns =
    x1_src's; the pre-MLP recorded; for its last output q_in the LayerNorm's
    f32 xhat and qn = bf16(xhat) as the last product's record, 1 / std into
    ln_rstd; q = bf16(qn @ wq_f + bq_f)."""
    xin[:, :split] = x1_src[:, :split]
    q_in = _mlp_record_plain(xin[:, :split], pairs[:-1], record)
    mean = q_in.mean(-1, keepdim=True)
    rstd = torch.rsqrt((q_in * q_in).mean(-1, keepdim=True) - mean * mean + 1e-5)
    xhat = (q_in - mean) * rstd
    qn = xhat.to(torch.bfloat16)
    record.pre[len(pairs) - 2].copy_(xhat)
    record.h[len(pairs) - 2].copy_(qn)
    ln_rstd.copy_(rstd[:, 0])
    q.copy_(flc._lin(qn, pairs[-1], torch.bfloat16))


def coupling_record_plain(xin: torch.Tensor, split: int, pairs: list, record,
                          x1_src: Optional[torch.Tensor] = None) -> None:
    """Plain version of `_build.coupling_record` for one layer: the coupling
    MLP over the packed rows (its last product's [s | t] interleaved)
    recorded, [s | t] (f32) as the last product's pre; with x1_src, xin's
    x1 columns = x1_src's first."""
    if x1_src is not None:
        xin[:, :split] = x1_src[:, :split]
    record.pre[-1].copy_(_mlp_record_plain(xin[:, :pairs[0][0].shape[0]], pairs, record))


def _mlp_bwd_plain(stack, ws: list, dp: torch.Tensor) -> torch.Tensor:
    """The MLP in reverse from the head's f32 dp: per hidden product dp =
    (bf16(dp) @ W^T + the residual's gradient) * the recorded GELU', written
    to d_out (bf16), res_out and the column sums; returns the tail's f32
    product, the MLP input's gradient."""
    bf = torch.bfloat16
    for p in range(1, len(ws) - 1):
        v = dp.to(bf).float() @ ws[p].float()
        if stack.res_in[p] is not None:
            v = stack.res_in[p] + v
        v = v * stack.pre[p]
        if stack.res_out[p] is not None:
            stack.res_out[p].copy_(v)
        stack.d_out[p].copy_(v)
        stack.colsum[p].copy_(_tile_sums(v))
        dp = v
    return dp.to(bf).float() @ ws[-1].float()


def coupling_bwd_plain(stack, l: int, g, g_b, g_colsum, g_next, x, dldj, y, dextra, dcond, *,
                       split: int, xe: int, xc: int, accumulate_cond: bool,
                       eps_affine: float) -> None:
    """Plain version of `_build.coupling_bwd` (stack.pre[0] is the recorded
    [s | t], interleaved)."""
    bf = torch.bfloat16
    ws = stack.layer(l)
    g_b.copy_(g)
    g_colsum.copy_(_tile_sums(g))
    dy = g.to(bf).float() @ ws[0].float()
    st = stack.pre[0]
    s, t = st[:, 0::2], st[:, 1::2]
    sig = 1.0 / (1.0 + torch.exp(-s))
    sc = (2.0 * sig - 1.0) * (1.0 - eps_affine) + 1.0
    x2, dy2 = x[:, split:].float(), dy[:, split:]
    g_next[:, :split] = dy[:, :split]
    g_next[:, split:] = dy2 * sc
    y[:, :split] = x[:, :split]
    y[:, split:] = x2 * sc + t
    ds = (dy2 * x2 + dldj[:, None] / sc) * (1.0 - eps_affine) * 2.0 * sig * (1.0 - sig)
    dp = torch.cat([ds, dy2], 1)
    stack.d_out[0].copy_(dp)
    stack.colsum[0].copy_(_tile_sums(dp, coupling_head_bands(dy2.shape[1])))
    v = _mlp_bwd_plain(stack, ws, dp)
    g_next[:, :split] += v[:, :split]
    if dextra is not None:
        dextra += v[:, split:xe]
    cond = v[:, xc:xc + dcond.shape[1]]
    if accumulate_cond:
        dcond += cond
    else:
        dcond.copy_(cond)


def conditioner_bwd_plain(stack, l: int, dq, dq_colsum, g_next, ln_rstd, *,
                          split: int) -> None:
    """Plain version of `_build.conditioner_bwd` (stack.pre[0] is the
    recorded xhat, ln_rstd the rows' 1 / std): row_norm_bwd's arithmetic on
    dqn = bf16(dq) @ wq_f^T."""
    ws = stack.layer(l)
    dq_colsum.copy_(_tile_sums(dq))
    g = dq.to(torch.bfloat16).float() @ ws[0].float()
    xh = stack.pre[0]
    dp = ln_rstd[:, None] * (g - g.mean(-1, keepdim=True) - xh * (g * xh).mean(-1, keepdim=True))
    stack.d_out[0].copy_(dp)
    stack.colsum[0].copy_(_tile_sums(dp))
    g_next[:, :split] += _mlp_bwd_plain(stack, ws, dp)


def _bwd_stack(head_w, mlp_ws: list, tail_w, head_pre, pre: list, d_out_head, d_out: list,
               scratch, rows: int, head_bands: int = 1) -> tuple:
    """A fused backward launch's products: the head (its weight, recorded
    f32 rows and bf16 dp), the MLP's hidden products in reverse, where
    pre[i] / d_out[i] belong to the i-th hidden activation (i from n - 2
    down to 0), and the tail; the residual gradient of hidden activation i
    (i even, i >= 2) kept in `scratch` for activation i - 2. Returns the
    BwdStack and, per dp from the head down to activation 0, its column sums
    (tiles, N); the head's (tiles x head_bands, N)."""
    n = len(pre) + 1                      # the forward MLP's products
    dev, tiles = head_pre.device, -(-rows // 64)
    sums = [torch.empty(tiles * head_bands, d_out_head.shape[1], dtype=torch.float32, device=dev)]
    ps, r_in, r_out, outs = [head_pre], [None], [None], [d_out_head]
    for i in range(n - 2, -1, -1):
        w = pre[i].shape[1]
        ps.append(pre[i])
        r_in.append(scratch[:, :w] if i % 2 == 0 and i + 2 <= n - 2 else None)
        r_out.append(scratch[:, :w] if i % 2 == 0 and i >= 2 else None)
        outs.append(d_out[i])
        sums.append(torch.empty(tiles, w, dtype=torch.float32, device=dev))
    stack = _build.BwdStack([head_w] + mlp_ws + [tail_w], ps + [None], r_in + [None],
                            r_out + [None], outs + [None], sums + [None])
    return stack, sums


def _plain_ops():
    """`_bwd_fused`'s launches as their plain versions, on any device: the
    fused kernels' plain versions (same rounding points, f32 sums in
    another order) and the gemm, attention and cast launches' plain ones."""
    return types.SimpleNamespace(
        conditioner_record=lambda xin, split, stack, l, *a, **kw: conditioner_record_plain(
            xin, split, stack.layer(l), *a, **kw),
        coupling_record=lambda xin, split, stack, l, *a, **kw: coupling_record_plain(
            xin, split, stack.layer(l), *a, **kw),
        coupling_bwd=coupling_bwd_plain, conditioner_bwd=conditioner_bwd_plain,
        gemm_tn_grouped=_build.gemm_tn_grouped_plain, grad_reduce=_build.grad_reduce_plain,
        gemm=_build.gemm_plain, cross_attention=_build.cross_attention_plain,
        attn_bwd_prep=_build.attn_bwd_prep_plain, attention_bwd=_build.attention_bwd_plain,
        cast_rows=lambda src, dst: dst.copy_(src))


def flow_layers_bwd_fused_plain(saves, dz, dldj, context, extra, folded, *,
                                eps_affine: float = 1e-8):
    """B5's fused route with every launch's plain version (`_plain_ops`):
    the reference of chip_smoke.py's share checks of the fused kernels (the
    rounding points they keep), on CPU or CUDA tensors."""
    return _bwd_fused(saves, dz, dldj, context, extra, folded, eps_affine, ops=_plain_ops())


def _bwd_fused(saves, dz, dldj, context, extra, folded, eps_affine, ops=None):
    """The launches of `flow_layers_bwd` on CUDA tensors (on CPU tensors the
    same orchestration runs the wrappers' plain versions); `ops` replaces
    the `_build` launch functions (`_plain_ops`)."""
    ops = ops or _build
    b, n, lat = dz.shape
    rows, dev = b * n, dz.device
    bf, f32 = torch.bfloat16, torch.float32
    split = lat // 2
    half = lat - split
    ed = extra.shape[-1] if extra is not None else 0
    nc, e_dim = context.shape[1], context.shape[2]
    has_attn = folded["pre"] is not None
    d = folded["cpl_in_c"].shape[1]          # the attention width, or E without attention
    xe, xc, xin_width = flc.packed_input_layout(split, ed, d)
    n_layers, n_cpl = folded["lu_ldj_f"].shape[0], folded["n_cpl"]
    if tuple(saves.shape) != (n_layers, rows, lat) or saves.dtype != bf:
        raise ValueError(f"flow_layers_bwd: saves must be ({n_layers}, {rows}, {lat}) bf16, "
                         f"got {tuple(saves.shape)} {saves.dtype}")
    if not has_attn and (nc != n or e_dim != d):
        raise ValueError(f"flow_layers_bwd: the global conditioner reads the context row by "
                         f"row: expected ({b}, {n}, {d}), got {tuple(context.shape)}")
    flat = flatten_folded(folded)
    grads = {k: torch.empty(v.shape, dtype=f32, device=dev) for k, v in flat.items()}

    def f32m(c):
        return torch.empty(rows, c, dtype=f32, device=dev)

    def bfm(c):
        return flc.bf16_rows(rows, c, dev)

    def transposed(w):
        return flc._pad_cols(w.transpose(1, 2).to(bf))

    # the coupling MLP: forward-oriented for the recompute (last product's
    # [s | t] interleaved), transposed for the backward (plain [s | t])
    packed = flc.packed_input_weights(folded["cpl_in_xe"].to(bf), folded["cpl_in_c"])
    rest = list(folded["cpl_rest"])
    rest[-1] = (flc._interleave_st(rest[-1][0]), flc._interleave_st(rest[-1][1]))
    cpl_pairs = ([(flc._pad_cols(packed), folded["cpl_in_b"].float().reshape(n_layers, -1)
                   .contiguous())] + flc._bf16_stack(rest))
    cpl_fwd = _build.FusedStack(cpl_pairs, n_cpl)
    def frag(c):
        return _build.fragment_rows(rows, c, dev)

    widths = [w.shape[-1] for w, _ in cpl_pairs]
    cpl_pre = [frag(c) for c in widths[:-1]] + [f32m(widths[-1])]
    cpl_h = [bfm(c) for c in widths[:-1]]
    cpl_rec = _build.Record(cpl_pre, cpl_h + [None])
    cdp_b, dst_b = [bfm(c) for c in widths[:-1]], bfm(2 * half)
    # the residual gradient's scratch, shared by the coupling's and the
    # conditioner's backward: as wide as either's widest hidden product
    # (the kernels lay a width's records out by its own passes)
    hidden = widths[:-1] + ([w.shape[-1] for w, _ in folded["pre"]][:-1] if has_attn else [])
    scratch = frag(max(hidden))
    cpl_bwd, cpl_sums = _bwd_stack(
        flc._pad_cols(folded["lu_w_f"].to(bf)),
        [transposed(w) for w, _ in folded["cpl_rest"][::-1]], flc._pad_cols(packed.transpose(1, 2)),
        cpl_pre[-1], cpl_pre[:-1], dst_b, cdp_b, scratch, rows, coupling_head_bands(half))

    # the packed coupling-input rows [x1 | extra | pad | cond]: the pad
    # columns zero, extra cast once, the global conditioner's ctx once
    xin = torch.empty(rows, xin_width, dtype=bf, device=dev)
    xin[:, xe:xc].zero_()
    if extra is not None:
        ops.cast_rows(extra.reshape(rows, ed).float().contiguous(), xin[:, split:xe])
    g = dz.reshape(rows, lat).float().contiguous().clone()
    g_next, g_b, y = f32m(lat), bfm(lat), bfm(lat)
    g_sums = torch.empty(-(-rows // 64), lat, dtype=f32, device=dev)
    dextra = torch.zeros(rows, ed, dtype=f32, device=dev) if ed else None
    dldj_c = dldj.reshape(rows).float().contiguous()
    # weight gradients a^T @ b and bias sums, the partials' layout fixed once
    dps = [cdp_b[i] if i < n_cpl - 1 else dst_b for i in range(n_cpl)]
    tn = [(g_b, y)] + [(cpl_h[i - 1], dps[i]) for i in range(1, n_cpl)] + [
        (xin[:, :xe], cdp_b[0]), (xin[:, xc:xc + d], cdp_b[0])]
    tn_out = (["lu_w_f"] + [f"cpl_w{i}" for i in range(n_cpl - 1)] + ["cpl_in_xe", "cpl_in_c"])
    bias_sums = [(g_sums, "lu_b"), (cpl_sums[0], f"cpl_b{n_cpl - 2}")] + [
        (cpl_sums[n_cpl - 1 - i], f"cpl_b{i - 1}" if i else "cpl_in_b")
        for i in range(n_cpl - 2, -1, -1)]
    if has_attn:
        pre_pairs = flc._bf16_stack(folded["pre"])
        n_pre = len(pre_pairs)
        wq = flc._pad_cols(folded["wq_f"].to(bf))
        cond_fwd = _build.FusedStack(
            pre_pairs + [(wq, folded["bq_f"].float().reshape(n_layers, -1).contiguous())], n_pre)
        pw = [w.shape[-1] for w, _ in pre_pairs]
        pre_pre, pre_h, pdp_b = [frag(c) for c in pw], [bfm(c) for c in pw], [bfm(c) for c in pw]
        cond_rec = _build.Record(pre_pre + [None], pre_h + [None])
        ln_rstd = torch.empty(rows, dtype=f32, device=dev)
        cond_bwd, cond_sums = _bwd_stack(
            transposed(folded["wq_f"]), [transposed(w) for w, _ in folded["pre"][:0:-1]],
            transposed(folded["pre"][0][0]), pre_pre[-1], pre_pre[:-1], pdp_b[-1], pdp_b[:-1],
            scratch, rows)
        wkv = flc._pad_cols(folded["wkv"].to(bf))
        wkv_kv = flc.kv_weights(folded["wkv"])     # ctx @ wkv in kv_layout's columns
        ctx2 = flc._pad_cols(context.reshape(b * nc, e_dim).to(bf))
        v0, kv_width = flc.kv_layout(d)
        q, kv = bfm(d), flc.bf16_rows(b * nc, kv_width, dev)
        m_row, den, ddn = (torch.empty(rows, dtype=f32, device=dev) for _ in range(3))
        da, du, dq, dq_b = f32m(d), bfm(d), f32m(d), bfm(d)
        dkv = torch.empty(b * nc, 2 * d, dtype=f32, device=dev)
        dkv_b = flc.bf16_rows(b * nc, 2 * d, dev)
        dq_sums = torch.empty(-(-rows // 64), d, dtype=f32, device=dev)
        tn += [(ctx2, dkv_b), (pre_h[-1], dq_b)] + [
            (pre_h[i - 1], pdp_b[i]) for i in range(1, n_pre)] + [(xin[:, :split], pdp_b[0])]
        tn_out += ["wkv", "wq_f"] + [f"pre_w{i}" for i in range(1, n_pre)] + ["pre_w0"]
        bias_sums += [(dq_sums, "bq_f"), (cond_sums[0], f"pre_b{n_pre - 1}")] + [
            (cond_sums[n_pre - 1 - i], f"pre_b{i}") for i in range(n_pre - 2, -1, -1)]
        # dctx of the shared context rows, summed over layers
        dctx = torch.zeros(b * nc, e_dim, dtype=f32, device=dev)
    else:
        # the global conditioner: the same ctx columns for every layer, and a
        # row-wise dctx (B*N, E) summed over layers; autograd sums it over N
        xin[:, xc:xc + d].copy_(context.reshape(rows, d))
        dctx = torch.zeros(rows, d, dtype=f32, device=dev)
    group = _build.TnGroup(tn)
    sums = _build.GradSums(
        [(part, grads[name]) for part, name in zip(group.partials, tn_out)]
        + [(part.unsqueeze(1), grads[name]) for part, name in bias_sums])

    for l in reversed(range(n_layers)):
        xs = saves[l]
        # 1. the recompute of layer l at its bf16 entry carry
        if has_attn:
            ops.conditioner_record(xin, split, cond_fwd, l, q, cond_rec, xs, ln_rstd)
            ops.gemm(ctx2, wkv_kv[l], kv)
            ops.cross_attention(q, kv[:, :d], kv[:, v0:v0 + d], xin[:, xc:xc + d], n_items=b,
                                m_out=m_row, den_out=den)
            ops.coupling_record(xin, split, cpl_fwd, l, cpl_rec)
        else:
            ops.coupling_record(xin, split, cpl_fwd, l, cpl_rec, x1_src=xs)
        # 2. the LinearLU, the affine and the coupling MLP in reverse
        ops.coupling_bwd(cpl_bwd, l, g, g_b, g_sums, g_next, xs, dldj_c, y, dextra,
                            da if has_attn else dctx, split=split, xe=xe, xc=xc,
                            accumulate_cond=not has_attn, eps_affine=eps_affine)
        if has_attn:
            # 3.-4. the cross attention, the kv projection, the conditioner
            ops.attn_bwd_prep(da, xin[:, xc:xc + d], den, du, ddn)
            ops.attention_bwd(q, kv[:, :d], kv[:, v0:v0 + d], du, ddn, m_row, dq, dq_b, dkv,
                              dkv_b, n_items=b)
            ops.gemm(dkv_b, wkv[l], dctx, trans_b=True, accumulate=True)
            ops.conditioner_bwd(cond_bwd, l, dq, dq_sums, g_next, ln_rstd, split=split)
        # 5. the weight and bias gradients of layer l
        ops.gemm_tn_grouped(group)
        ops.grad_reduce(sums, l)
        g, g_next = g_next, g
    # lu_ldj_f adds a constant to every point's ldj in every layer
    grads["lu_ldj_f"].copy_(dldj_c.sum().expand(n_layers).reshape(grads["lu_ldj_f"].shape))
    return (g.reshape(b, n, lat), dctx.reshape(b, nc, e_dim),
            dextra.reshape(b, n, ed) if ed else None, grads)


# ----------------------------------------------------------- autograd glue

class _FlowLayersTrainable(torch.autograd.Function):
    """B1 with saves forward, B5 backward; the folded stacks arrive flattened
    so that autograd tracks each of them."""

    @staticmethod
    def forward(ctx, x, ldj, context, extra, n_cpl, eps_affine, names, *arrays):
        folded = unflatten_folded(dict(zip(names, arrays)), n_cpl)
        z, ldj_out, saves = flc.fused_flow_layers(x, ldj, context, extra, folded,
                                                  eps_affine=eps_affine, save=True)
        ctx.save_for_backward(saves, context, extra, *arrays)
        ctx.n_cpl, ctx.eps_affine, ctx.names = n_cpl, eps_affine, names
        return z, ldj_out

    @staticmethod
    def backward(ctx, dz, dldj):
        saves, context, extra, *arrays = ctx.saved_tensors
        b = context.shape[0]
        n, lat = saves.shape[1] // b, saves.shape[2]
        if dz is None:
            dz = torch.zeros(b, n, lat, dtype=torch.float32, device=saves.device)
        if dldj is None:
            dldj = torch.zeros(b, n, dtype=torch.float32, device=saves.device)
        folded = unflatten_folded(dict(zip(ctx.names, arrays)), ctx.n_cpl)
        dx, dctx, dextra, grads = flow_layers_bwd(saves, dz, dldj, context, extra, folded,
                                                  eps_affine=ctx.eps_affine)
        dws = [grads[k].to(a.dtype) for k, a in zip(ctx.names, arrays)]
        return (dx, dldj.float(), dctx.to(context.dtype),
                dextra.to(extra.dtype) if extra is not None else None, None, None, None, *dws)


def fused_flow_layers_trainable(x: torch.Tensor, ldj: torch.Tensor, context: torch.Tensor,
                                extra: Optional[torch.Tensor], folded: dict, *,
                                eps_affine: float = 1e-8, nonlin: str = "GELU"):
    """The differentiable folded layer stack -> (z, ldj); replaces the JAX
    custom VJP `fused_flow_layers_trainable`. A CUDA tensor runs B1 with
    saves and, under backward, B5; a CPU tensor runs `fused_flow_layers_plain`
    under autograd. Like B1 and B5 it computes GELU only."""
    flc.require_gelu(nonlin)
    if not x.is_cuda:
        return flc.fused_flow_layers_plain(x, ldj, context, extra, folded, eps_affine=eps_affine)
    flat = flatten_folded(folded)
    return _FlowLayersTrainable.apply(x, ldj, context, extra, folded["n_cpl"], eps_affine,
                                      tuple(flat), *flat.values())
