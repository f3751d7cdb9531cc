"""The flow layers and the augmenter prologue: folds, plain spec, CUDA wrappers.

Counterpart of `flowcompare_tpu/ops/flow_layer_pallas.py`:

* `build_layer_stacks`, `append_final_block`, `fold_stacks` and
  `fold_augmenter` build the same folded weight stacks (LayerNorm scale and
  1/sqrt(d) into wq, the attention out-projection into the coupling input,
  ActNorm into LinearLU), in float32 on the tensors' device;
* `folded_scan_core` is the plain version of the folded layer stack, a
  Python loop over layers, and the spec of B1;
* `fused_flow_layers` (B1, replaces `fused_flow_layers_t`) and
  `fused_augmenter` (B2, replaces `fused_augmenter`) run the same math as a
  fixed chain of the port's hand-written kernels on a CUDA tensor, and
  their plain versions on a CPU tensor.

What the TPU needed and the port drops: the transposed twin layout and its
padded latent, the ones-column softmax denominator, the clamp-at-80
softmax (the port subtracts the row maximum, as `folded_scan_core` does),
the logit-polynomial GELU (exact erf here) and the trace-time tuning flags.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..core.initializers import matmul_f32
from ..core.mlp import gelu
from . import _build

# Launch counters: one per wrapper, bumped each time it runs its kernel chain.
FUSED_FLOW_LAYERS_LAUNCHES = 0
FUSED_AUGMENTER_LAUNCHES = 0

_LOG_2PI = math.log(2.0 * math.pi)


# ------------------------------------------------------------------- folds

def _mlp_list(p: dict) -> list:
    return ([(p["in"]["w"], p["in"]["b"])]
            + [(h["w"], h["b"]) for h in p["hidden"]]
            + [(p["out"]["w"], p["out"]["b"])])


def build_layer_stacks(layers_prepared: dict) -> dict:
    """The per-layer weight stacks from the prepared layer params (LinearLU
    already folded by `linear_lu_prepare_stack`)."""
    blk = layers_prepared["block"]
    an = layers_prepared["actnorm"]
    attn = blk["attn"]
    return {
        "cpl": _mlp_list(blk["coupling"]["nn"]),
        "an_shift": an["shift"],
        "an_logscale": an["log_scale"],
        "lu_w": layers_prepared["permuter"]["w_folded"],
        "lu_ldj": layers_prepared["permuter"]["ldj"],
        "pre": _mlp_list(blk["pre_attention_mlp"]),
        "ln_scale": attn["norm"]["scale"][:, None, :],
        "ln_bias": attn["norm"]["bias"][:, None, :],
        "wq": attn["to_q"]["w"],
        "wkv": attn["to_kv"]["w"],
        "wout": attn["out"]["w"],
        "bout": attn["out"]["b"][:, None, :],
    }


def append_final_block(stacks: dict, final_block: dict, lat: int) -> dict:
    """The flow's final coupling block as one more layer with an identity
    ActNorm (zeros) and an identity LinearLU (eye, log-det 0)."""
    def cat(stacked, new):
        return torch.cat([stacked, new[None].to(stacked.dtype)], 0)

    attn = final_block["attn"]
    out = dict(stacks)
    out["cpl"] = [(cat(w, nw), cat(b, nb)) for (w, b), (nw, nb)
                  in zip(stacks["cpl"], _mlp_list(final_block["coupling"]["nn"]))]
    out["pre"] = [(cat(w, nw), cat(b, nb)) for (w, b), (nw, nb)
                  in zip(stacks["pre"], _mlp_list(final_block["pre_attention_mlp"]))]
    out["ln_scale"] = cat(stacks["ln_scale"], attn["norm"]["scale"][None])
    out["ln_bias"] = cat(stacks["ln_bias"], attn["norm"]["bias"][None])
    out["wq"] = cat(stacks["wq"], attn["to_q"]["w"])
    out["wkv"] = cat(stacks["wkv"], attn["to_kv"]["w"])
    out["wout"] = cat(stacks["wout"], attn["out"]["w"])
    out["bout"] = cat(stacks["bout"], attn["out"]["b"][None])
    zeros = torch.zeros(1, 1, lat, dtype=stacks["an_shift"].dtype,
                        device=stacks["an_shift"].device)
    out["an_shift"] = torch.cat([stacks["an_shift"], zeros], 0)
    out["an_logscale"] = torch.cat([stacks["an_logscale"], zeros], 0)
    eye = torch.eye(lat, dtype=stacks["lu_w"].dtype, device=stacks["lu_w"].device)
    out["lu_w"] = torch.cat([stacks["lu_w"], eye[None]], 0)
    out["lu_ldj"] = torch.cat([stacks["lu_ldj"], torch.zeros_like(stacks["lu_ldj"][:1])], 0)
    return out


def fold_stacks(stacks: dict, *, split: int, extra_dim: int) -> dict:
    """The algebraic folds, in float32, exact in real arithmetic:

      wq_f  = (ln_scale * wq) / sqrt(d)        bq_f = (ln_bias @ wq) / sqrt(d)
      cpl_in_xe = W_in[:split+extra]           (x1 and extra rows, unchanged)
      cpl_in_c  = wout @ W_in[split+extra:]    (out-projection folded away)
      cpl_in_b  = b_in + bout @ W_in[split+extra:]
      lu_w_f = lu_w * exp(-an_logscale)        lu_b = -(shift * D) @ lu_w^T
      lu_ldj_f = lu_ldj + sum(-an_logscale)
    """
    w_in, b_in = stacks["cpl"][0]
    w_in = w_in.float()
    b_in = b_in.float()
    xe = split + extra_dim
    d = stacks["wq"].shape[-1]
    scale = d ** -0.5
    ln_s = stacks["ln_scale"].float()                  # (L, 1, A)
    ln_b = stacks["ln_bias"].float()
    wq = stacks["wq"].float()                          # (L, A, D)
    wout = stacks["wout"].float()                      # (L, D, H)
    bout = stacks["bout"].float()                      # (L, 1, H)
    dscale = torch.exp(-stacks["an_logscale"].float()[:, 0])   # (L, LAT)
    lu_w = stacks["lu_w"].float()                      # (L, LAT, LAT)
    shift_d = stacks["an_shift"].float()[:, 0] * dscale
    return {
        "pre": stacks["pre"],
        "wkv": stacks["wkv"],
        "cpl_rest": stacks["cpl"][1:],
        "n_cpl": len(stacks["cpl"]),
        "cpl_in_xe": w_in[:, :xe],
        "wq_f": ln_s[:, 0, :, None] * wq * scale,
        "bq_f": torch.einsum("la,lad->ld", ln_b[:, 0], wq)[:, None] * scale,
        "cpl_in_c": torch.einsum("ldh,lhk->ldk", wout, w_in[:, xe:]),
        "cpl_in_b": (b_in + torch.einsum("lh,lhk->lk", bout[:, 0], w_in[:, xe:]))[:, None],
        "lu_w_f": lu_w * dscale[:, None, :],
        "lu_b": -torch.einsum("lj,lij->li", shift_d, lu_w)[:, None],
        "lu_ldj_f": (stacks["lu_ldj"].float()
                     + (-stacks["an_logscale"].float()).sum(dim=(1, 2))),
    }


def fold_augmenter(aug_params: dict, *, input_dim: int, extra_dim: int) -> dict:
    """One-layer folded stacks of the attention-preconditioned augmenter.

    Its conditioner has exactly the flow layers' shape (pre-MLP, LayerNorm,
    cross attention, out-projection into an input matmul whose rows are
    [x | extra | attn]), so `fold_stacks` applies with a leading layer axis
    of 1; the LinearLU/ActNorm folds of its 1x1 dummies are dropped."""
    def stack1(p):
        return [(w[None], b[None]) for w, b in _mlp_list(p)]

    attn = aug_params["attn"]
    dev = attn["to_q"]["w"].device
    z1 = torch.zeros(1, 1, 1, device=dev)
    stacks = {
        "cpl": stack1(aug_params["augment"]["net"]),
        "pre": stack1(aug_params["pre_attn_mlp"]),
        "ln_scale": attn["norm"]["scale"][None, None, :],
        "ln_bias": attn["norm"]["bias"][None, None, :],
        "wq": attn["to_q"]["w"][None],
        "wkv": attn["to_kv"]["w"][None],
        "wout": attn["out"]["w"][None],
        "bout": attn["out"]["b"][None, None, :],
        "an_shift": z1,
        "an_logscale": z1,
        "lu_w": torch.ones(1, 1, 1, device=dev),
        "lu_ldj": torch.zeros(1, device=dev),
    }
    folded = fold_stacks(stacks, split=input_dim, extra_dim=extra_dim)
    for key in ("lu_w_f", "lu_b", "lu_ldj_f"):
        folded.pop(key)
    return folded


# -------------------------------------------------------------- plain spec

def _cast(a: torch.Tensor, dtype) -> torch.Tensor:
    return a if dtype is None else a.to(dtype)


def _lin(h, wb, dtype):
    w, b = wb
    return matmul_f32(h, _cast(w, dtype)) + b.float()


def _res_mlp(h_first, pairs, n_total, nonlin, dtype):
    """Hidden and out layers of the residual MLP, given the first activation;
    a residual is re-added at every second hidden layer. f32 out."""
    h = h_first
    residual = h
    for k in range(n_total - 2):
        if k % 2 == 0:
            residual = h
            h = _cast(nonlin(_lin(h, pairs[k], dtype)), dtype)
        else:
            h = _cast(nonlin(residual.float() + _lin(h, pairs[k], dtype)), dtype)
    return _lin(h, pairs[n_total - 2], dtype)


def _attention_cond(x1c, ctx_c, pre, wq_f, bq_f, wkv, nonlin, dtype):
    """The attention conditioner shared by the flow layers and the augmenter:
    pre-MLP, plain-statistics LayerNorm (scale/bias folded into wq_f), q, one
    head of max-subtracted softmax attention over the context, normalised
    after the PV product. Returns the (B, N, d) embedding in the compute dtype."""
    q_in = _cast(nonlin(_lin(x1c, pre[0], dtype)), dtype)
    q_in = _res_mlp(q_in, pre[1:], len(pre), nonlin, dtype)
    mean = q_in.mean(-1, keepdim=True)
    var = (q_in * q_in).mean(-1, keepdim=True) - mean * mean
    qn = (q_in - mean) * torch.rsqrt(var + 1e-5)
    q = matmul_f32(_cast(qn, dtype), _cast(wq_f, dtype)) + bq_f[0].float()
    kv = matmul_f32(ctx_c, _cast(wkv, dtype))
    d = q.shape[-1]
    k, v = kv[..., :d], kv[..., d:]
    s = matmul_f32(_cast(q, dtype), _cast(k, dtype).transpose(-1, -2))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    a = matmul_f32(_cast(e, dtype), _cast(v, dtype)) / e.sum(-1, keepdim=True)
    return _cast(a, dtype)


def _layer(folded: dict, l: int) -> dict:
    """Layer l of the folded stacks (the augmenter's have no LinearLU keys)."""
    keys = ("wq_f", "bq_f", "wkv", "cpl_in_xe", "cpl_in_c", "cpl_in_b",
            "lu_w_f", "lu_b", "lu_ldj_f")
    return {"pre": [(w[l], b[l]) for w, b in folded["pre"]],
            "cpl_rest": [(w[l], b[l]) for w, b in folded["cpl_rest"]],
            **{k: folded[k][l] for k in keys if k in folded}}


def folded_scan_core(x: torch.Tensor, ldj: torch.Tensor, context: torch.Tensor,
                     extra: Optional[torch.Tensor], folded: dict, *,
                     nonlin: Callable, dtype=None, eps_affine: float = 1e-8):
    """The folded layer stack as a loop over layers: the spec of B1.

    x (B, N, LAT) f32, ldj (B, N) f32, context (B, Nc, E), extra (B, N, e) or
    None. dtype=torch.bfloat16 is the kernels' precision policy (bf16 matmul
    operands with f32 accumulation; LayerNorm and softmax statistics, the x
    carry and ldj in f32); dtype=None is float32 throughout."""
    n_cpl = folded["n_cpl"]
    split = x.shape[-1] // 2
    h, acc = x.float(), ldj.float()
    ctx_c = _cast(context, dtype)
    extra_c = _cast(extra, dtype) if extra is not None else None
    for l in range(folded["lu_ldj_f"].shape[0]):
        st = _layer(folded, l)
        x1, x2 = h[..., :split], h[..., split:]
        x1c = _cast(x1, dtype)
        x1e = torch.cat([x1c, extra_c], -1) if extra_c is not None else x1c
        cond = _attention_cond(x1c, ctx_c, st["pre"], st["wq_f"], st["bq_f"], st["wkv"],
                               nonlin, dtype)
        acc_in = (matmul_f32(x1e, _cast(st["cpl_in_xe"], dtype))
                  + matmul_f32(cond, _cast(st["cpl_in_c"], dtype))
                  + st["cpl_in_b"][0].float())
        stt = _res_mlp(_cast(nonlin(acc_in), dtype), st["cpl_rest"], n_cpl, nonlin, dtype)
        half = stt.shape[-1] // 2
        sc = (2.0 * torch.sigmoid(stt[..., :half]) - 1.0) * (1.0 - eps_affine) + 1.0
        y2 = x2 * sc + stt[..., half:]
        acc = acc + torch.log(sc).sum(-1) + st["lu_ldj_f"]
        y = torch.cat([x1, y2], -1)
        h = matmul_f32(_cast(y, dtype), _cast(st["lu_w_f"], dtype).T) + st["lu_b"][0].float()
    return h, acc


def fused_flow_layers_plain(x, ldj, context, extra, folded, *, eps_affine: float = 1e-8):
    """Plain version of B1: `folded_scan_core` under the bf16 policy."""
    return folded_scan_core(x, ldj, context, extra, folded, nonlin=gelu,
                            dtype=torch.bfloat16, eps_affine=eps_affine)


def fused_augmenter_plain(x: torch.Tensor, eps: torch.Tensor, context: torch.Tensor,
                          extra: Optional[torch.Tensor], folded_aug: dict):
    """Plain version of B2 under the bf16 policy: the folded augmenter,
    z = [x | mean + eps * exp(log_std)], ldj = -log q(z2) per point."""
    bf = torch.bfloat16
    st = _layer(folded_aug, 0)
    xb = x.to(bf)
    x1e = torch.cat([xb, extra.to(bf)], -1) if extra is not None else xb
    cond = _attention_cond(xb, context.to(bf), st["pre"], st["wq_f"], st["bq_f"], st["wkv"],
                           gelu, bf)
    acc = (matmul_f32(x1e, st["cpl_in_xe"].to(bf)) + matmul_f32(cond, st["cpl_in_c"].to(bf))
           + st["cpl_in_b"][0].float())
    out = _res_mlp(gelu(acc).to(bf), st["cpl_rest"], folded_aug["n_cpl"], gelu, bf)
    aug = eps.shape[-1]
    mean, log_std = out[..., :aug], out[..., aug:]
    z2 = mean + eps * torch.exp(log_std)
    ldj = (0.5 * _LOG_2PI + log_std + 0.5 * eps * eps).sum(-1)
    return torch.cat([x.float(), z2], -1), ldj


# ------------------------------------------------------------ CUDA chains

def _bf16_stack(pairs):
    """Stacked (w, b) layers as contiguous bf16 weights (L, in, out) and f32
    biases (L, out), converted once per call rather than once per layer."""
    return [(w.to(torch.bfloat16).contiguous(),
             b.float().reshape(w.shape[0], -1).contiguous()) for w, b in pairs]


def _at(pairs, l: int):
    return [(w[l], b[l]) for w, b in pairs]


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _conditioner(xin: torch.Tensor, split: int, xe: int, ctx2: torch.Tensor,
                 pre: list, wq: torch.Tensor, bq: torch.Tensor, wkv: torch.Tensor,
                 scratch: dict, n_items: int) -> None:
    """Pre-MLP -> row_norm -> q -> kv -> cross attention, written into the
    attention columns xin[:, xe:xe+d] of the packed coupling-input rows."""
    d = wq.shape[1]
    _build.mlp_chain(xin[:, :split], pre, scratch["qf"], scratch["h"])
    _build.row_norm(scratch["qf"], scratch["qn"])
    _build.gemm(scratch["qn"], wq, scratch["q"], bias=bq)
    _build.gemm(ctx2, wkv, scratch["kv"])
    _build.cross_attention(scratch["q"], scratch["kv"][:, :d], scratch["kv"][:, d:],
                           xin[:, xe:xe + d], n_items=n_items)


def _scratch(rows: int, ctx_rows: int, widths: list, a_dim: int, d: int, device) -> dict:
    bf = torch.bfloat16
    hmax = max(widths)
    return {
        "h": [torch.empty(rows, hmax, dtype=bf, device=device) for _ in range(3)],
        "qf": torch.empty(rows, a_dim, dtype=torch.float32, device=device),
        "qn": torch.empty(rows, a_dim, dtype=bf, device=device),
        "q": torch.empty(rows, d, dtype=bf, device=device),
        "kv": torch.empty(ctx_rows, 2 * d, dtype=bf, device=device),
    }


def fused_flow_layers(x: torch.Tensor, ldj: torch.Tensor, context: torch.Tensor,
                      extra: Optional[torch.Tensor], folded: dict, *,
                      eps_affine: float = 1e-8):
    """B1: all folded layers over (x, ldj); replaces the Pallas kernel
    `fused_flow_layers_t` (flow_layer_pallas.py, body `_kernel_t`).

    x (B, N, LAT) f32, ldj (B, N) f32, context (B, Nc, 64), extra (B, N, e) or
    None, `folded` from `fold_stacks`. Returns (z, ldj) in f32. A CPU tensor
    runs `fused_flow_layers_plain`; a CUDA tensor runs, per layer, a fixed
    chain of the port's kernels: cast_rows (x1 -> bf16), four gemm_bf16 for
    the pre-MLP, row_norm, gemm for q and for ctx @ wkv, cross_attention,
    four gemm for the coupling MLP (its input one product over the packed
    [x1 | extra | attn] rows), coupling_epilogue and gemm for the folded
    LinearLU.

    What bounds it on the H100: the tensor-core products (about 2.6 MFLOP
    per point and layer at dulcet-universe widths, 2.3 of it in gemm_bf16
    and the rest in the attention) and, at small batch, the
    launch cadence of 15 launches per layer; the design keeps the x carry
    and ldj in f32 in device memory between layers and every activation in
    bf16, and issues every launch without a host sync so they queue."""
    global FUSED_FLOW_LAYERS_LAUNCHES
    if not x.is_cuda:
        return fused_flow_layers_plain(x, ldj, context, extra, folded, eps_affine=eps_affine)
    b, n, lat = x.shape
    nc, e_dim = context.shape[1], context.shape[2]
    split = lat // 2
    ed = extra.shape[-1] if extra is not None else 0
    xe = split + ed
    d = folded["wq_f"].shape[-1]
    n_layers = folded["lu_ldj_f"].shape[0]
    rows, dev, bf = b * n, x.device, torch.bfloat16

    pre = _bf16_stack(folded["pre"])
    w_in = torch.cat([folded["cpl_in_xe"], folded["cpl_in_c"]], 1).to(bf).contiguous()
    b_in = folded["cpl_in_b"].float().reshape(n_layers, -1).contiguous()
    cpl_rest = _bf16_stack(folded["cpl_rest"])
    wq = folded["wq_f"].to(bf).contiguous()
    bq = folded["bq_f"].float().reshape(n_layers, -1).contiguous()
    wkv = folded["wkv"].to(bf).contiguous()
    lu_wt = folded["lu_w_f"].transpose(1, 2).to(bf).contiguous()
    lu_b = folded["lu_b"].float().reshape(n_layers, -1).contiguous()
    lu_ldj = folded["lu_ldj_f"].float().contiguous()

    widths = [w.shape[-1] for w, _ in pre] + [w.shape[-1] for w, _ in cpl_rest]
    scratch = _scratch(rows, b * nc, widths, pre[-1][0].shape[-1], d, dev)
    # packed coupling-input rows [x1 | extra | attn]; this and y are padded
    # to a multiple of 8 columns so gemm_bf16 reads their tiles 16 bytes at a time
    xin = torch.empty(rows, _round8(xe + d), dtype=bf, device=dev)
    if extra is not None:
        _build.cast_rows(extra.reshape(rows, ed).float().contiguous(), xin[:, split:xe])
    ctx2 = context.reshape(b * nc, e_dim).to(bf).contiguous()
    xc = x.reshape(rows, lat).float().contiguous().clone()
    xn = torch.empty_like(xc)
    ldj_c = ldj.reshape(rows).float().contiguous().clone()
    st = torch.empty(rows, cpl_rest[-1][0].shape[-1], dtype=torch.float32, device=dev)
    y = torch.empty(rows, _round8(lat), dtype=bf, device=dev)[:, :lat]

    for l in range(n_layers):
        _build.cast_rows(xc[:, :split], xin[:, :split])
        _conditioner(xin, split, xe, ctx2, _at(pre, l), wq[l], bq[l], wkv[l], scratch, b)
        _build.mlp_chain(xin[:, :xe + d], [(w_in[l], b_in[l])] + _at(cpl_rest, l), st,
                   scratch["h"])
        _build.coupling_epilogue(st, xc, ldj_c, y, lu_ldj[l:l + 1], split=split,
                                 eps_affine=eps_affine)
        _build.gemm(y, lu_wt[l], xn, bias=lu_b[l])
        xc, xn = xn, xc
    FUSED_FLOW_LAYERS_LAUNCHES += 1
    return xc.reshape(b, n, lat), ldj_c.reshape(b, n)


def fused_augmenter(x: torch.Tensor, eps: torch.Tensor, context: torch.Tensor,
                    extra: Optional[torch.Tensor], folded_aug: dict):
    """B2: the attention-preconditioned augmenter; replaces the Pallas kernel
    `fused_augmenter` (flow_layer_pallas.py, body `_augment_kernel`).

    x (B, N, in) f32, eps (B, N, aug) f32 standard normal, context
    (B, Nc, 64), extra (B, N, e) or None. Returns z (B, N, in + aug) f32 and
    ldj = -log q(z2) (B, N) f32. A CPU tensor runs `fused_augmenter_plain`;
    a CUDA tensor runs the B1 conditioner chain once (pre-MLP gemms,
    row_norm, q, kv, cross_attention), the net's four gemm_bf16 and
    augment_epilogue.

    What bounds it on the H100: the 512-wide net products and the attention
    over Nc context rows, once per point; the first pre-MLP layer has K = 6,
    which the gemm's zero-filled tiles take without padding the input."""
    global FUSED_AUGMENTER_LAUNCHES
    if not x.is_cuda:
        return fused_augmenter_plain(x, eps, context, extra, folded_aug)
    b, n, in_dim = x.shape
    aug = eps.shape[-1]
    nc, e_dim = context.shape[1], context.shape[2]
    ed = extra.shape[-1] if extra is not None else 0
    xe = in_dim + ed
    d = folded_aug["wq_f"].shape[-1]
    rows, dev, bf = b * n, x.device, torch.bfloat16

    pre = _at(_bf16_stack(folded_aug["pre"]), 0)
    net = _at(_bf16_stack(folded_aug["cpl_rest"]), 0)
    w_in = torch.cat([folded_aug["cpl_in_xe"][0], folded_aug["cpl_in_c"][0]], 0
                     ).to(bf).contiguous()
    b_in = folded_aug["cpl_in_b"][0].float().reshape(-1).contiguous()
    widths = [w.shape[-1] for w, _ in pre] + [w.shape[-1] for w, _ in net]
    scratch = _scratch(rows, b * nc, widths, pre[-1][0].shape[-1], d, dev)
    xin = torch.empty(rows, _round8(xe + d), dtype=bf, device=dev)
    x2 = x.reshape(rows, in_dim).float().contiguous()
    _build.cast_rows(x2, xin[:, :in_dim])
    if extra is not None:
        _build.cast_rows(extra.reshape(rows, ed).float().contiguous(), xin[:, in_dim:xe])
    ctx2 = context.reshape(b * nc, e_dim).to(bf).contiguous()
    _conditioner(xin, in_dim, xe, ctx2, pre, folded_aug["wq_f"][0].to(bf).contiguous(),
                 folded_aug["bq_f"][0].float().reshape(-1).contiguous(),
                 folded_aug["wkv"][0].to(bf).contiguous(), scratch, b)
    st = torch.empty(rows, 2 * aug, dtype=torch.float32, device=dev)
    _build.mlp_chain(xin[:, :xe + d], [(w_in, b_in)] + net, st, scratch["h"])
    z = torch.empty(rows, in_dim + aug, dtype=torch.float32, device=dev)
    ldj = torch.empty(rows, dtype=torch.float32, device=dev)
    _build.augment_epilogue(st, x2, eps.reshape(rows, aug).float().contiguous(), z, ldj)
    FUSED_AUGMENTER_LAUNCHES += 1
    return z.reshape(b, n, in_dim + aug), ldj.reshape(b, n)
