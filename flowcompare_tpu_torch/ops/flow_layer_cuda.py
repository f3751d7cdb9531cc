"""The flow layers and the augmenter prologue: folds, plain spec, CUDA wrappers.

Counterpart of `flowcompare_tpu/ops/flow_layer_pallas.py`:

* `build_layer_stacks`, `append_final_block`, `fold_stacks`,
  `fold_stacks_inverse` and `fold_augmenter` build the same folded weight
  stacks (LayerNorm scale and 1/sqrt(d) into wq, the attention
  out-projection into the coupling input, ActNorm into LinearLU, and for
  sampling the inverse of that tail), in float32 on the tensors' device.
  Blocks without attention (the global conditioner of helpful-sponge) give
  JAX's no-attention form: `pre`, `wkv`, `wq_f` and `bq_f` are None and the
  coupling reads the context (the broadcast embedding, row by row) through
  `cpl_in_c`, the ctx rows of its first weight;
* `folded_scan_core` is the plain version of the folded layer stack, a
  Python loop over layers, and the spec of B1; `folded_inverse_scan_core`
  walks the layers in reverse and is the spec of B7;
* `fused_flow_layers` (B1, replaces `fused_flow_layers_t`),
  `fused_flow_layers_inverse` (B7, replaces `fused_flow_layers_inverse_t`)
  and `fused_augmenter` (B2, replaces `fused_augmenter`) run the same math
  as a fixed chain of the port's hand-written kernels on a CUDA tensor, and
  their plain versions on a CPU tensor; B1's and B7's coupling layers run
  as two fused kernels each (`_build.conditioner`, `coupling_layer`,
  `coupling_inverse`, plain versions `conditioner_plain`,
  `coupling_layer_plain`, `coupling_inverse_plain` here), B2 as the
  conditioner, ctx @ wkv, the cross attention and one launch of its net
  and epilogue (`_build.augment_net`, plain version `augment_net_plain`)
  on `AugmenterWeights`, folded once per weights version
  (`augmenter_weights`, `AUGMENTER_FOLDS`).

What the TPU needed and the port drops: the transposed twin layout and its
padded latent, the ones-column softmax denominator, the clamp-at-80
softmax (the port subtracts the row maximum, as `folded_scan_core` does),
the logit-polynomial GELU (exact erf here) and the trace-time tuning flags.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.utils.checkpoint

from ..core.initializers import matmul_f32
from ..core.mlp import gelu
from ..flows.coupling import sigmoid_scale
from . import _build
from .fold_cache import FoldCache, tensor_leaves

# Launch counters: one per wrapper, bumped each time it runs its kernel chain
# (FUSED_FLOW_LAYERS_SAVE_LAUNCHES also counts the runs that wrote saves).
FUSED_FLOW_LAYERS_LAUNCHES = 0
FUSED_FLOW_LAYERS_SAVE_LAUNCHES = 0
FUSED_AUGMENTER_LAUNCHES = 0
FUSED_FLOW_LAYERS_INVERSE_LAUNCHES = 0
AUGMENTER_FOLDS = 0      # AugmenterWeights made (one per weights version)
_AUG_FOLDS = FoldCache()

_LOG_2PI = math.log(2.0 * math.pi)


def require_gelu(nonlin: str) -> None:
    """B1, B2, B5 and B7 (and their plain versions) compute GELU only: asked
    for another nonlinearity they raise, so nothing computes GELU in its
    place (the model routes such configs through `folded_scan_core`)."""
    if nonlin != "GELU":
        raise ValueError(f"the fused flow kernels compute GELU only, not {nonlin!r}; "
                         "take folded_scan_core with that nonlinearity")


# ------------------------------------------------------------------- folds

def _mlp_list(p: dict) -> list:
    return ([(p["in"]["w"], p["in"]["b"])]
            + [(h["w"], h["b"]) for h in p["hidden"]]
            + [(p["out"]["w"], p["out"]["b"])])


def build_layer_stacks(layers_prepared: dict) -> dict:
    """The per-layer weight stacks from the prepared layer params (LinearLU
    already folded by `linear_lu_prepare_stack`); the attention stacks only
    where the blocks have attention."""
    blk = layers_prepared["block"]
    an = layers_prepared["actnorm"]
    stacks = {
        "cpl": _mlp_list(blk["coupling"]["nn"]),
        "an_shift": an["shift"],
        "an_logscale": an["log_scale"],
        "lu_w": layers_prepared["permuter"]["w_folded"],
        "lu_ldj": layers_prepared["permuter"]["ldj"],
    }
    if "attn" not in blk:
        return stacks
    attn = blk["attn"]
    return {
        **stacks,
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

    out = dict(stacks)
    out["cpl"] = [(cat(w, nw), cat(b, nb)) for (w, b), (nw, nb)
                  in zip(stacks["cpl"], _mlp_list(final_block["coupling"]["nn"]))]
    if "attn" in final_block:
        attn = final_block["attn"]
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

    Without attention (no "wq" stack) `pre`, `wkv`, `wq_f` and `bq_f` are
    None, cpl_in_c = W_in[split+extra:] (the context rows) and cpl_in_b = b_in.
    """
    w_in, b_in = stacks["cpl"][0]
    w_in = w_in.float()
    b_in = b_in.float()
    xe = split + extra_dim
    dscale = torch.exp(-stacks["an_logscale"].float()[:, 0])   # (L, LAT)
    lu_w = stacks["lu_w"].float()                      # (L, LAT, LAT)
    shift_d = stacks["an_shift"].float()[:, 0] * dscale
    if "wq" in stacks:
        d = stacks["wq"].shape[-1]
        scale = d ** -0.5
        ln_s = stacks["ln_scale"].float()              # (L, 1, A)
        ln_b = stacks["ln_bias"].float()
        wq = stacks["wq"].float()                      # (L, A, D)
        wout = stacks["wout"].float()                  # (L, D, H)
        bout = stacks["bout"].float()                  # (L, 1, H)
        cond = {
            "pre": stacks["pre"],
            "wkv": stacks["wkv"],
            "wq_f": ln_s[:, 0, :, None] * wq * scale,
            "bq_f": torch.einsum("la,lad->ld", ln_b[:, 0], wq)[:, None] * scale,
            "cpl_in_c": torch.einsum("ldh,lhk->ldk", wout, w_in[:, xe:]),
            "cpl_in_b": (b_in + torch.einsum("lh,lhk->lk", bout[:, 0], w_in[:, xe:]))[:, None],
        }
    else:
        cond = {"pre": None, "wkv": None, "wq_f": None, "bq_f": None,
                "cpl_in_c": w_in[:, xe:], "cpl_in_b": b_in[:, None]}
    return {
        **cond,
        "cpl_rest": stacks["cpl"][1:],
        "n_cpl": len(stacks["cpl"]),
        "cpl_in_xe": w_in[:, :xe],
        "lu_w_f": lu_w * dscale[:, None, :],
        "lu_b": -torch.einsum("lj,lij->li", shift_d, lu_w)[:, None],
        "lu_ldj_f": (stacks["lu_ldj"].float()
                     + (-stacks["an_logscale"].float()).sum(dim=(1, 2))),
    }


def fold_stacks_inverse(stacks: dict, folded: dict) -> dict:
    """`folded` plus the inverse of the folded ActNorm + LinearLU tail, for
    sampling. The forward tail is z = y @ lu_w_f^T + lu_b; its inverse is

      y = z @ Minv^T + an_shift,   Minv = inv(lu_w) * exp(an_logscale)[:, None]

    with the batched inverse in float32 (a library call once per sampling
    call, as `jnp.linalg.inv` is in the JAX package)."""
    inv_w = torch.linalg.inv(stacks["lu_w"].float())
    log_scale = stacks["an_logscale"].float()[:, 0]                   # (L, LAT)
    out = dict(folded)
    out["lu_w_inv_f"] = inv_w * torch.exp(log_scale)[:, :, None]
    out["lu_shift"] = stacks["an_shift"].float()[:, 0][:, None]       # (L, 1, LAT)
    return out


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


def _res_hidden(h_first, pairs, nonlin, dtype):
    """The hidden layers `pairs` of the residual MLP, given the first
    activation; a residual is re-added at every second hidden layer."""
    h = h_first
    residual = h
    for k, wb in enumerate(pairs):
        if k % 2 == 0:
            residual = h
            h = _cast(nonlin(_lin(h, wb, dtype)), dtype)
        else:
            h = _cast(nonlin(residual.float() + _lin(h, wb, dtype)), dtype)
    return h


def _res_mlp(h_first, pairs, n_total, nonlin, dtype):
    """Hidden and out layers of the residual MLP, given the first activation;
    a residual is re-added at every second hidden layer. f32 out."""
    h = _res_hidden(h_first, pairs[:n_total - 2], nonlin, dtype)
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
    """Layer l of the folded stacks (the augmenter's have no LinearLU keys;
    a stack without attention keeps its None conditioner stacks)."""
    keys = ("wq_f", "bq_f", "wkv", "cpl_in_xe", "cpl_in_c", "cpl_in_b",
            "lu_w_f", "lu_b", "lu_ldj_f", "lu_w_inv_f", "lu_shift")
    pre = folded["pre"]
    return {"pre": None if pre is None else [(w[l], b[l]) for w, b in pre],
            "cpl_rest": [(w[l], b[l]) for w, b in folded["cpl_rest"]],
            **{k: (None if folded[k] is None else folded[k][l]) for k in keys if k in folded}}


def folded_scan_core(x: torch.Tensor, ldj: torch.Tensor, context: torch.Tensor,
                     extra: Optional[torch.Tensor], folded: dict, *,
                     nonlin: Callable, dtype=None, eps_affine: float = 1e-8,
                     remat: bool = False):
    """The folded layer stack as a loop over layers: the spec of B1.

    x (B, N, LAT) f32, ldj (B, N) f32, context (B, Nc, E) (without attention
    the broadcast embedding (B, N, E)), extra (B, N, e) or None.
    dtype=torch.bfloat16 is the kernels' precision policy (bf16 matmul
    operands with f32 accumulation; LayerNorm and softmax statistics, the x
    carry and ldj in f32); dtype=None is float32 throughout. remat=True
    recomputes each layer in the backward instead of keeping its
    activations, as the JAX package's scan does (`remat=True`): a layer's
    attention keeps B x N x Nc f32 scores, 470 MB at B=2 over 57,344
    context points."""
    split = x.shape[-1] // 2
    h, acc = x.float(), ldj.float()
    ctx_c = _cast(context, dtype)
    extra_c = _cast(extra, dtype) if extra is not None else None

    def step(st, h):
        x1, x2 = h[..., :split], h[..., split:]
        sc, t = _coupling_scale_shift(st, _cast(x1, dtype), extra_c, ctx_c, folded["n_cpl"],
                                      nonlin, dtype, eps_affine)
        y = torch.cat([x1, x2 * sc + t], -1)
        h = matmul_f32(_cast(y, dtype), _cast(st["lu_w_f"], dtype).T) + st["lu_b"][0].float()
        return h, torch.log(sc).sum(-1)

    for l in range(folded["lu_ldj_f"].shape[0]):
        st = _layer(folded, l)
        if remat:
            h, log_sc = torch.utils.checkpoint.checkpoint(step, st, h, use_reentrant=False)
        else:
            h, log_sc = step(st, h)
        acc = acc + log_sc + st["lu_ldj_f"]
    return h, acc


def _coupling_scale_shift(st: dict, x1c, extra_c, ctx_c, n_cpl: int, nonlin, dtype,
                          eps_affine: float):
    """One folded layer's conditioner and coupling MLP on x1 (in the compute
    dtype): the scale (2 sigmoid(s) - 1)(1 - eps) + 1 and the shift t, f32.
    Without attention the conditioner is the context itself, row by row."""
    x1e = torch.cat([x1c, extra_c], -1) if extra_c is not None else x1c
    if st["pre"] is None:
        cond = ctx_c
    else:
        cond = _attention_cond(x1c, ctx_c, st["pre"], st["wq_f"], st["bq_f"], st["wkv"],
                               nonlin, dtype)
    acc_in = (matmul_f32(x1e, _cast(st["cpl_in_xe"], dtype))
              + matmul_f32(cond, _cast(st["cpl_in_c"], dtype))
              + st["cpl_in_b"][0].float())
    stt = _res_mlp(_cast(nonlin(acc_in), dtype), st["cpl_rest"], n_cpl, nonlin, dtype)
    half = stt.shape[-1] // 2
    return sigmoid_scale(stt[..., :half], eps_affine), stt[..., half:]


def folded_inverse_scan_core(z: torch.Tensor, context: torch.Tensor,
                             extra: Optional[torch.Tensor], folded_inv: dict, *,
                             dtype=None, eps_affine: float = 1e-8) -> torch.Tensor:
    """The folded layer stack walked in reverse (L-1 first, the final block
    with its identity tail): the spec of B7.

    z (B, N, LAT) f32, context (B, Nc, E), extra (B, N, e) or None,
    `folded_inv` from `fold_stacks_inverse`. Per layer: y = z @ Minv^T +
    shift (z cast to the compute dtype for the product, the shift added in
    f32), x1 = y1 in f32 with its compute-dtype cast feeding the conditioner,
    and x2 = (y2 - t) / scale in f32; the carry stays f32 between layers. No
    log-det. dtype=torch.bfloat16 is the kernels' policy, None float32."""
    split = z.shape[-1] // 2
    h = z.float()
    ctx_c = _cast(context, dtype)
    extra_c = _cast(extra, dtype) if extra is not None else None
    for l in reversed(range(folded_inv["lu_w_inv_f"].shape[0])):
        st = _layer(folded_inv, l)
        y = (matmul_f32(_cast(h, dtype), _cast(st["lu_w_inv_f"], dtype).T)
             + st["lu_shift"][0].float())
        x1, y2 = y[..., :split], y[..., split:]
        sc, t = _coupling_scale_shift(st, _cast(x1, dtype), extra_c, ctx_c, folded_inv["n_cpl"],
                                      gelu, dtype, eps_affine)
        h = torch.cat([x1, (y2 - t) / sc], -1)
    return h


def layer_slice(folded: dict, l: int) -> dict:
    """Layer l of the folded stacks as a one-layer folded dict."""
    def sl(v):
        if v is None or isinstance(v, int):
            return v
        if isinstance(v, list):
            return [(w[l:l + 1], b[l:l + 1]) for w, b in v]
        return v[l:l + 1]
    return {k: sl(v) for k, v in folded.items()}


def fused_flow_layers_plain(x, ldj, context, extra, folded, *, eps_affine: float = 1e-8,
                            save: bool = False, nonlin: str = "GELU", remat: bool = False):
    """Plain version of B1: `folded_scan_core` under the bf16 policy (remat:
    each layer recomputed in the backward). With save=True also the (L,
    B*N, LAT) bf16 entry carry of every layer."""
    require_gelu(nonlin)
    if not save:
        return folded_scan_core(x, ldj, context, extra, folded, nonlin=gelu,
                                dtype=torch.bfloat16, eps_affine=eps_affine, remat=remat)
    b, n, lat = x.shape
    saves = []
    for l in range(folded["lu_ldj_f"].shape[0]):
        saves.append(x.reshape(b * n, lat).to(torch.bfloat16))
        x, ldj = folded_scan_core(x, ldj, context, extra, layer_slice(folded, l), nonlin=gelu,
                                  dtype=torch.bfloat16, eps_affine=eps_affine)
    return x, ldj, torch.stack(saves, 0)


def fused_flow_layers_inverse_plain(z: torch.Tensor, context: torch.Tensor,
                                    extra: Optional[torch.Tensor], folded_inv: dict, *,
                                    eps_affine: float = 1e-8,
                                    nonlin: str = "GELU") -> torch.Tensor:
    """Plain version of B7: `folded_inverse_scan_core` under the bf16 policy."""
    require_gelu(nonlin)
    return folded_inverse_scan_core(z, context, extra, folded_inv, dtype=torch.bfloat16,
                                    eps_affine=eps_affine)


def fused_augmenter_plain(x: torch.Tensor, eps: torch.Tensor, context: torch.Tensor,
                          extra: Optional[torch.Tensor], folded_aug, *, nonlin: str = "GELU"):
    """Plain version of B2 under the bf16 policy: the folded augmenter
    (`fold_augmenter`'s dict, or `AugmenterWeights`),
    z = [x | mean + eps * exp(log_std)], ldj = -log q(z2) per point."""
    require_gelu(nonlin)
    bf = torch.bfloat16
    if isinstance(folded_aug, AugmenterWeights):
        folded_aug = folded_aug.folded
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


def _ln_plain(v: torch.Tensor) -> torch.Tensor:
    """Plain-statistics LayerNorm of f32 rows (scale and bias folded away)."""
    mean = v.mean(-1, keepdim=True)
    var = (v * v).mean(-1, keepdim=True) - mean * mean
    return (v - mean) * torch.rsqrt(var + 1e-5)


def _mlp_plain(a: torch.Tensor, pairs: list) -> torch.Tensor:
    """The residual MLP on bf16 rows `a` (GELU after every product but the
    last, a residual every second hidden product), the last product in f32."""
    bf = torch.bfloat16
    h = _cast(gelu(_lin(a, pairs[0], bf)), bf)
    return _res_mlp(h, pairs[1:], len(pairs), gelu, bf)


def conditioner_plain(xin: torch.Tensor, split: int, pairs: list, q: torch.Tensor) -> None:
    """Plain version of `_build.conditioner` for one layer: `pairs` are the
    pre-MLP's (w, b) and then (wq_f, bq_f). q = bf16(bf16(LN(pre-MLP(x1)))
    @ wq_f + bq_f), the rounding points of `_attention_cond`."""
    qn = _ln_plain(_mlp_plain(xin[:, :split], pairs[:-1])).to(torch.bfloat16)
    q.copy_(_lin(qn, pairs[-1], torch.bfloat16))


def _scale_shift_interleaved(xin: torch.Tensor, pairs: list, eps_affine: float):
    """(scale, t) of the coupling MLP over the packed rows, its last product's
    columns interleaved (column 2i is s_i, 2i + 1 is t_i)."""
    st = _mlp_plain(xin[:, :pairs[0][0].shape[0]], pairs)
    return sigmoid_scale(st[:, 0::2], eps_affine), st[:, 1::2]


def coupling_layer_plain(xin: torch.Tensor, split: int, pairs: list, x: torch.Tensor,
                         ldj: torch.Tensor, lu_ldj: torch.Tensor, *,
                         save: Optional[torch.Tensor] = None, eps_affine: float) -> None:
    """Plain version of `_build.coupling_layer` for one layer: `pairs` are the
    coupling MLP (first weight over the packed rows, last with [s | t]
    interleaved) and then (lu_w_f^T, lu_b). In place: ldj = (ldj + sum(log
    scale)) + lu_ldj[0], x = bf16([x1 | x2 * scale + t]) @ lu_w_f^T + lu_b
    (f32), the packed rows' x1 columns = bf16(x1) of the new x, save = bf16(x).
    y's x1 half is the packed rows' bf16 x1 (on the chain, bf16 of x's)."""
    sc, t = _scale_shift_interleaved(xin, pairs[:-1], eps_affine)
    ldj.copy_((ldj + torch.log(sc).sum(-1)) + lu_ldj[0])
    y = torch.cat([xin[:, :split].float(), x[:, split:] * sc + t], -1).to(torch.bfloat16)
    out = _lin(y, pairs[-1], torch.bfloat16)
    x.copy_(out)
    xin[:, :split] = out[:, :split]
    if save is not None:
        save.copy_(out)


def coupling_inverse_plain(xin: torch.Tensor, split: int, pairs: list, y: torch.Tensor, *,
                           x: Optional[torch.Tensor] = None, eps_affine: float) -> None:
    """Plain version of `_build.coupling_inverse` for one layer: `pairs` are
    the coupling MLP (last product interleaved) and, when x is None, the next
    layer's (Minv^T, shift). x2 = (y2 - t) / scale in f32; then y = bf16([y1 |
    x2]) @ Minv^T + shift in place and the packed rows' x1 columns = bf16(y1)
    of the new y, or, with x given, x = [y1 | x2]."""
    n_mlp = len(pairs) - int(x is None)
    sc, t = _scale_shift_interleaved(xin, pairs[:n_mlp], eps_affine)
    x2 = (y[:, split:] - t) / sc
    if x is not None:
        x.copy_(torch.cat([y[:, :split], x2], -1))
        return
    h = torch.cat([xin[:, :split], x2.to(torch.bfloat16)], -1)
    out = _lin(h, pairs[-1], torch.bfloat16)
    y.copy_(out)
    xin[:, :split] = out[:, :split]


# ------------------------------------------------------------ CUDA chains

def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _pad_cols(t: torch.Tensor) -> torch.Tensor:
    """t as a view of a zeroed buffer whose rows are a multiple of 8 elements
    long, so every row starts 16-byte aligned (bf16) and the gemm's TMA
    route can read it; the pad columns lie beyond the view's width and are
    never read."""
    c = t.shape[-1]
    buf = torch.zeros(*t.shape[:-1], _round8(c), dtype=t.dtype, device=t.device)
    buf[..., :c] = t
    return buf[..., :c]


def bf16_rows(rows: int, cols: int, device) -> torch.Tensor:
    """An uninitialised (rows, cols) bf16 matrix whose row stride is a
    multiple of 8, so the gemm's TMA route can read it."""
    return torch.empty(rows, _round8(cols), dtype=torch.bfloat16, device=device)[:, :cols]


def kv_layout(d: int) -> tuple:
    """(v0, width) of the rows ctx @ wkv writes for a head of width d: k in
    columns [0, d), zeros in [d, v0), v in [v0, v0 + d), with v0 = d rounded
    up to a multiple of 8 so that v starts 16-byte aligned and the attention
    kernels' TMA reads it at every d (`kv_weights` places wkv's columns to
    match). At a d that is a multiple of 8 the rows are [k | v]."""
    v0 = _round8(d)
    return v0, v0 + d


def kv_weights(wkv: torch.Tensor) -> torch.Tensor:
    """wkv (..., E, 2 d) as bf16 columns in `kv_layout`: [wk | 0 | wv], its
    rows padded by `_pad_cols`."""
    d = wkv.shape[-1] // 2
    v0, width = kv_layout(d)
    w = wkv.to(torch.bfloat16)
    if v0 != d:
        gap = torch.zeros(*w.shape[:-1], width, dtype=w.dtype, device=w.device)
        gap[..., :d], gap[..., v0:] = w[..., :d], w[..., d:]
        w = gap
    return _pad_cols(w)


def _bf16_stack(pairs):
    """Stacked (w, b) layers as bf16 weights (L, in, out), their rows padded
    by `_pad_cols`, and contiguous f32 biases (L, out), converted once per
    call rather than once per layer."""
    return [(_pad_cols(w.to(torch.bfloat16)),
             b.float().reshape(w.shape[0], -1).contiguous()) for w, b in pairs]


def _at(pairs, l: int):
    return [(w[l], b[l]) for w, b in pairs]


def packed_input_layout(split: int, extra_dim: int, cond_dim: int) -> tuple:
    """(xe, xc, width) of the packed coupling-input rows [x1 | extra | pad |
    cond]: x1 in [0, split), extra in [split, xe), zero pad columns in
    [xe, xc), cond in [xc, xc + cond_dim), where xc = xe rounded up to a
    multiple of 8 so the cond columns start 16-byte aligned (B5 reads them
    as a gemm operand of their own); the row is `width` = xc + cond_dim
    rounded up to a multiple of 8 long."""
    xe = split + extra_dim
    xc = _round8(xe)
    return xe, xc, _round8(xc + cond_dim)


def packed_input_weights(cpl_in_xe: torch.Tensor, cpl_in_c: torch.Tensor) -> torch.Tensor:
    """The coupling's first weight (L, xc + cond_dim, H) for the packed rows:
    the x1 and extra rows, zero rows for the pad columns, then the cond
    rows. The zero rows change no value (a pad column is zero and meets a
    zero weight), so the product over the packed rows equals [x1 | extra |
    cond] @ [cpl_in_xe; cpl_in_c]."""
    n_layers, xe, h = cpl_in_xe.shape
    pad = torch.zeros(n_layers, _round8(xe) - xe, h, dtype=cpl_in_xe.dtype,
                      device=cpl_in_xe.device)
    return torch.cat([cpl_in_xe, pad, cpl_in_c.to(cpl_in_xe.dtype)], 1)


def _fits(shapes: list) -> bool:
    return all(1 <= k <= _build.FUSED_MAXW and 1 <= n <= _build.FUSED_MAXW for k, n in shapes)


FUSED_LIMITS_TEXT = (f"the fused layer kernels take widths <= {_build.FUSED_MAXW}, the "
                     f"LayerNorm's row, the latent and the packed input <= "
                     f"{_build.FUSED_ROW_W}, 3-{_build.FUSED_MAX_PRODUCTS} products")


def fused_route(pre: Optional[list], q: Optional[tuple], cpl: list, tail: tuple, split: int,
                lat: int) -> dict:
    """Which layer parts take the fused kernels of csrc/fused_layer.cu, from
    shapes alone: `pre` the pre-MLP's (K, N) per product (None without
    attention), `q` the query product's, `cpl` the coupling MLP's (the first
    over the packed rows), `tail` the LinearLU's. A part is fused when every
    width is at most FUSED_MAXW (2,048; past FUSED_PASS_W, 512, the wide
    kernels), the products that end in a row-wise epilogue take at most
    FUSED_ROW_W (1,024, two passes: the LayerNorm's row, [s | t] and the
    LinearLU, so the latent), the first product reads at most FUSED_IN_W
    (1,024) packed columns, its products (with the tail) number 3 to 10,
    and, for the coupling, the last product gives [s | t] for the lat -
    split columns of the affine. A part that is refused has no other route:
    `_CouplingChain` raises."""
    n_max, row_w, in_w = _build.FUSED_MAX_PRODUCTS, _build.FUSED_ROW_W, _build.FUSED_IN_W
    cond = (pre is not None and 2 <= len(pre) and len(pre) + 1 <= n_max
            and _fits(pre + [q]) and pre[-1][1] <= row_w and pre[0][0] == split
            and split <= in_w and q[0] == pre[-1][1])
    coupling = (2 <= len(cpl) and len(cpl) + 1 <= n_max and _fits(cpl + [tail])
                and cpl[0][0] <= in_w and lat <= row_w and cpl[-1][1] == 2 * (lat - split)
                and tail == (lat, lat))
    return {"conditioner": bool(cond), "coupling": bool(coupling)}


def _interleave_st(w: torch.Tensor) -> torch.Tensor:
    """[s | t] columns (last axis) reordered as s_0, t_0, s_1, t_1, ..."""
    half = w.shape[-1] // 2
    return torch.stack([w[..., :half], w[..., half:]], -1).reshape(w.shape)


def augment_net_plan(net: list, in_cols: int, aug: int) -> dict:
    """What B2's net kernel (csrc/fused_layer.cu, kind augment_net) runs,
    from shapes alone: `net` the ConditionalNormal net's (K, N) per product,
    the first over the packed rows (`in_cols` = K0), the last giving
    [mean | log_std] (N = 2 aug). The output layer runs as column passes of
    (mean_i, log_std_i) pairs, max(2, ceil(aug / 256)) of them, each of
    ceil(aug / passes) pairs but the last (at most 256 pairs, 512 columns:
    one pass of the kernel); every other width at most 2,048
    (`_build.FUSED_MAXW`), the packed rows at most 1,024 (`FUSED_IN_W`), at
    most 10 products with the passes.
    Returns {"products", "passes": [(first pair, pairs), ...]}; other shapes
    raise ValueError, and there is no other route for them."""
    n_out = max(2, -(-aug // (_build.FUSED_PASS_W // 2)))
    per = -(-aug // n_out)
    passes = [(per * j, min(per, aug - per * j)) for j in range(n_out)]
    ok = (len(net) >= 2 and net[0][0] == in_cols and in_cols <= _build.FUSED_IN_W
          and net[-1][1] == 2 * aug and passes[-1][1] >= 1
          and per <= _build.FUSED_PASS_W // 2
          and len(net) - 1 + n_out <= _build.FUSED_MAX_PRODUCTS
          and all(1 <= k <= _build.FUSED_MAXW for k, _ in net)
          and all(1 <= n <= _build.FUSED_MAXW for _, n in net[:-1])
          and all(net[i][0] == net[i - 1][1] for i in range(1, len(net))))
    if not ok:
        raise ValueError(f"the augmenter's net kernel cannot take these shapes: net {net}, "
                         f"packed rows of {in_cols}, aug {aug}")
    return {"products": len(net) - 1 + n_out, "passes": passes}


def interleave_passes(w: torch.Tensor, passes: list) -> list:
    """The output layer's columns [mean | log_std] (last axis) as the
    kernel's column passes: pairs interleaved (mean_i, log_std_i), pass j
    holding pairs [first, first + pairs) of `augment_net_plan`'s passes."""
    inter = _interleave_st(w)
    return [inter[..., 2 * first:2 * (first + pairs)] for first, pairs in passes]


def augment_net_plain(xin: torch.Tensor, pairs: list, x: torch.Tensor,
                      eps: torch.Tensor, n_out: int = 2) -> tuple:
    """Plain version of `_build.augment_net` at the kernel's rounding points:
    the net over the packed rows' first K0 columns (bf16 between products,
    GELU, a residual every second hidden product), the output layer's column
    passes (`interleave_passes`, the last n_out pairs) in f32, then z = [x |
    mean + eps * exp(log_std)] and ldj = sum(log 2pi / 2 + log_std + eps^2 /
    2). `pairs` are the kernel stack's (w (K, N), b (N)) at one layer."""
    bf = torch.bfloat16
    h = _cast(gelu(_lin(xin[:, :pairs[0][0].shape[0]], pairs[0], bf)), bf)
    h = _res_hidden(h, pairs[1:-n_out], gelu, bf)
    st = torch.cat([_lin(h, wb, bf) for wb in pairs[-n_out:]], 1)
    mean, log_std = st[:, 0::2], st[:, 1::2]
    z2 = mean + eps * torch.exp(log_std)
    ldj = (0.5 * _LOG_2PI + log_std + 0.5 * eps * eps).sum(-1)
    return torch.cat([x.float(), z2], 1), ldj


class _CouplingChain:
    """The per-layer weights of a folded stack in the kernels' layout (bf16
    weights, f32 biases, converted once per call rather than once per layer)
    and the buffers of the conditioner and coupling MLP, shared by B1, B2
    and B7.

    `xin` holds the packed coupling-input rows [x1 | extra | pad | cond]
    (`packed_input_layout`: the cond columns start at xc, a multiple of 8;
    the extra columns filled and the pad columns zeroed once here) and
    `w_in` the coupling's first weight with zero rows at the pad
    (`packed_input_weights`). Every bf16 row buffer and weight copy has
    rows of whole 16 bytes, so every gemm of the chain takes the TMA +
    wgmma route. With attention, cond is the attention embedding that
    `run(l)` writes per layer; without (the global conditioner), cond is the
    context itself, the broadcast embedding (B, N, E), the same for every
    layer, so its columns are written once here and `conditioner(l)` is
    not called.

    The conditioner is one `_build.conditioner` launch (pre-MLP, LayerNorm
    and q on a row tile kept on chip) before the ctx @ wkv product and the
    cross attention. Given the LinearLU `tail` ((L, lat, lat) bf16, (L, lat)
    f32: B1's lu_w_f^T or B7's Minv^T), `cpl_stack` holds the coupling MLP
    (its last product's [s | t] columns interleaved) and the tail for
    `_build.coupling_layer` / `coupling_inverse`. Without a tail (B2's net)
    `run(l)` runs the conditioner and then the coupling MLP one gemm a
    product, writing layer l's [s | t] (f32) into `st`. Shapes that
    `fused_route` refuses raise: there is no per-product route for them."""

    def __init__(self, folded: dict, context: torch.Tensor, extra: Optional[torch.Tensor],
                 rows: int, split: int, tail: Optional[tuple] = None, lat: int = 0):
        b, nc, e_dim = context.shape
        n_layers = folded["cpl_in_c"].shape[0]
        ed = extra.shape[-1] if extra is not None else 0
        dev, bf = context.device, torch.bfloat16
        self.cw = folded["cpl_in_c"].shape[1]          # attention width d, or E
        self.xe, self.xc, width = packed_input_layout(split, ed, self.cw)
        self.split, self.items = split, b
        self.has_attn = folded["pre"] is not None
        self.w_in = _pad_cols(packed_input_weights(folded["cpl_in_xe"].to(bf),
                                                   folded["cpl_in_c"]))
        self.b_in = folded["cpl_in_b"].float().reshape(n_layers, -1).contiguous()
        cpl_shapes = ([tuple(self.w_in.shape[1:])]
                      + [tuple(w.shape[1:]) for w, _ in folded["cpl_rest"]])
        pre_shapes = ([tuple(w.shape[1:]) for w, _ in folded["pre"]] if self.has_attn
                      else None)
        q_shape = tuple(folded["wq_f"].shape[1:]) if self.has_attn else None
        route = fused_route(pre_shapes, q_shape, cpl_shapes, (lat, lat), split, lat)
        if (self.has_attn and not route["conditioner"]) or (tail is not None
                                                            and not route["coupling"]):
            raise ValueError(f"the fused layer kernels cannot take these shapes: pre-MLP "
                             f"{pre_shapes}, q {q_shape}, coupling {cpl_shapes}, split {split}, "
                             f"latent {lat}")
        self.cpl_stack = None
        if tail is not None:
            rest = [(w, b) for w, b in folded["cpl_rest"]]
            rest[-1] = (_interleave_st(rest[-1][0]), _interleave_st(rest[-1][1]))
            self.cpl_stack = _build.FusedStack(
                [(self.w_in, self.b_in)] + _bf16_stack(rest) + [tail], len(cpl_shapes))
        else:
            self.cpl_rest = _bf16_stack(folded["cpl_rest"])
            self.st = torch.empty(rows, self.cpl_rest[-1][0].shape[-1], dtype=torch.float32,
                                  device=dev)
            self.h = [bf16_rows(rows, max(w.shape[-1] for w, _ in self.cpl_rest), dev)
                      for _ in range(3)]
        if self.has_attn:
            self.wkv = kv_weights(folded["wkv"])
            self.ctx2 = _pad_cols(context.reshape(b * nc, e_dim).to(bf))
            self.q = bf16_rows(rows, self.cw, dev)
            self.v0, kv_width = kv_layout(self.cw)
            self.kv = bf16_rows(b * nc, kv_width, dev)
            wq = _pad_cols(folded["wq_f"].to(bf))
            bq = folded["bq_f"].float().reshape(n_layers, -1).contiguous()
            self.cond_stack = _build.FusedStack(_bf16_stack(folded["pre"]) + [(wq, bq)],
                                                len(folded["pre"]))
        elif nc * b != rows or e_dim != self.cw:
            raise ValueError(f"the global conditioner reads the context row by row: expected "
                             f"{rows} rows of {self.cw}, got {tuple(context.shape)}")
        self.xin = torch.empty(rows, width, dtype=bf, device=dev)
        self.xin[:, self.xe:self.xc].zero_()
        if extra is not None:
            _build.cast_rows(extra.reshape(rows, ed).float().contiguous(),
                             self.xin[:, split:self.xe])
        if not self.has_attn:
            self.xin[:, self.xc:self.xc + self.cw].copy_(context.reshape(rows, e_dim))

    def run(self, l: int) -> None:
        if self.has_attn:
            self.conditioner(l)
        _build.mlp_chain(self.xin[:, :self.xc + self.cw],
                         [(self.w_in[l], self.b_in[l])] + _at(self.cpl_rest, l), self.st, self.h)

    def conditioner(self, l: int) -> None:
        """Pre-MLP -> LayerNorm -> q (one fused launch) -> kv -> cross
        attention, written into the attention columns xin[:, xc:xc+d] of the
        packed coupling-input rows."""
        d = self.cw
        _build.conditioner(self.xin, self.split, self.cond_stack, l, self.q)
        _build.gemm(self.ctx2, self.wkv[l], self.kv)
        _build.cross_attention(self.q, self.kv[:, :d], self.kv[:, self.v0:self.v0 + d],
                               self.xin[:, self.xc:self.xc + d], n_items=self.items)


def fused_flow_layers(x: torch.Tensor, ldj: torch.Tensor, context: torch.Tensor,
                      extra: Optional[torch.Tensor], folded: dict, *,
                      eps_affine: float = 1e-8, save: bool = False, nonlin: str = "GELU"):
    """B1: all folded layers over (x, ldj); replaces the Pallas kernel
    `fused_flow_layers_t` (flow_layer_pallas.py, body `_kernel_t`).

    x (B, N, LAT) f32, ldj (B, N) f32, context (B, Nc, 64), extra (B, N, e) or
    None, `folded` from `fold_stacks`. Returns (z, ldj) in f32. A CPU tensor
    runs `fused_flow_layers_plain`; a CUDA tensor runs, per layer, the
    fused kernels of csrc/fused_layer.cu: `_build.conditioner` (pre-MLP, LayerNorm, q), gemm for ctx @
    wkv, cross_attention into the attention columns of the packed [x1 |
    extra | pad | attn] rows, and `_build.coupling_layer` (the coupling MLP,
    the affine, the folded LinearLU into the f32 carry in place, the next
    layer's x1 columns): 4 launches per layer. A stack without attention
    (`has_attn=False` in the JAX package: the global conditioner, context
    the broadcast embedding (B, N, E)) needs only coupling_layer, its ctx
    columns written once per call: 1 launch per layer. Shapes the fused
    kernels refuse (`fused_route`) raise.

    save=True is the training forward (the Pallas `fused_flow_layers` with
    save_every=1): it also returns the entry carry of every layer as
    (L, B*N, LAT) bf16 for B5; coupling_layer writes the next layer's save
    row. The JAX package pads L to a multiple of its segment length with
    identity layers, a TPU-runtime workaround; here L stays as it is.

    What bounds it on the H100: the tensor-core products (about 2.6 MFLOP
    per point and layer at dulcet-universe widths, 2.3 of it in the MLPs
    and the rest in the attention) and, at small batch, the launch cadence;
    the x carry and ldj stay in f32 in device memory between layers, and
    no launch waits on the host."""
    global FUSED_FLOW_LAYERS_LAUNCHES, FUSED_FLOW_LAYERS_SAVE_LAUNCHES
    require_gelu(nonlin)
    if not x.is_cuda:
        return fused_flow_layers_plain(x, ldj, context, extra, folded, eps_affine=eps_affine,
                                       save=save)
    out = _forward_chain(x, ldj, context, extra, folded, eps_affine, save)
    FUSED_FLOW_LAYERS_LAUNCHES += 1
    FUSED_FLOW_LAYERS_SAVE_LAUNCHES += int(save)
    return out


def _forward_chain(x, ldj, context, extra, folded, eps_affine, save):
    b, n, lat = x.shape
    split = lat // 2
    n_layers = folded["lu_ldj_f"].shape[0]
    rows, dev, bf = b * n, x.device, torch.bfloat16
    lu_wt = _pad_cols(folded["lu_w_f"].transpose(1, 2).to(bf))
    lu_b = folded["lu_b"].float().reshape(n_layers, -1).contiguous()
    chain = _CouplingChain(folded, context, extra, rows, split, tail=(lu_wt, lu_b), lat=lat)
    lu_ldj = folded["lu_ldj_f"].float().contiguous()
    xc = x.reshape(rows, lat).float().contiguous().clone()
    ldj_c = ldj.reshape(rows).float().contiguous().clone()
    saves = torch.empty(n_layers, rows, lat, dtype=bf, device=dev) if save else None
    # the entry carry's casts once, then per layer the conditioner, ctx @ wkv
    # and the cross attention (with attention) and one coupling_layer, which
    # writes the next layer's x1 columns and save
    _build.cast_rows(xc[:, :split], chain.xin[:, :split])
    if save:
        _build.cast_rows(xc, saves[0])
    for l in range(n_layers):
        if chain.has_attn:
            chain.conditioner(l)
        _build.coupling_layer(chain.xin, split, chain.cpl_stack, l, xc, ldj_c, lu_ldj[l:l + 1],
                              save=saves[l + 1] if save and l + 1 < n_layers else None,
                              eps_affine=eps_affine)
    if save:
        return xc.reshape(b, n, lat), ldj_c.reshape(b, n), saves
    return xc.reshape(b, n, lat), ldj_c.reshape(b, n)


def fused_flow_layers_inverse(z: torch.Tensor, context: torch.Tensor,
                              extra: Optional[torch.Tensor], folded_inv: dict, *,
                              eps_affine: float = 1e-8, nonlin: str = "GELU") -> torch.Tensor:
    """B7: all folded layers in reverse over z, the sampling direction;
    replaces the Pallas kernel `fused_flow_layers_inverse_t`
    (flow_layer_pallas.py, body `_kernel_inverse_t`) and its row-major twin
    `fused_flow_layers_inverse`.

    z (B, N, LAT) f32, context (B, Nc, 64), extra (B, N, e) or None,
    `folded_inv` from `fold_stacks_inverse`. Returns x (B, N, LAT) f32, no
    log-det. A CPU tensor runs `fused_flow_layers_inverse_plain`; a CUDA
    tensor runs the top layer's LU inverse once (cast_rows, gemm with Minv^T
    and the f32 shift as bias into f32 y, cast_rows of y1 into the packed
    rows), then per layer from L-1 down to 0 B1's conditioner, ctx @ wkv and
    cross attention and `_build.coupling_inverse`, which applies
    x2 = (y2 - t) / scale and, below the top, the next layer's LU inverse on
    its tile, writing that y and its x1 columns (layer 0 writes x): 4
    launches per layer, 1 without attention. Shapes the fused kernels refuse
    (`fused_route`) raise.

    What bounds it on the H100: B1's products per point and layer (the
    inverse tail is one 300 x 300 product, as the forward's LinearLU), so
    the tensor cores at large batch and the launch cadence at B=1; the carry
    stays f32 and no launch waits on the host. The division by scale in
    (1e-8, 2) amplifies what bf16 rounds, so the carry is never rounded
    between layers."""
    global FUSED_FLOW_LAYERS_INVERSE_LAUNCHES
    require_gelu(nonlin)
    if not z.is_cuda:
        return fused_flow_layers_inverse_plain(z, context, extra, folded_inv,
                                               eps_affine=eps_affine)
    out = _inverse_chain(z, context, extra, folded_inv, eps_affine)
    FUSED_FLOW_LAYERS_INVERSE_LAUNCHES += 1
    return out


def _inverse_chain(z, context, extra, folded_inv, eps_affine):
    b, n, lat = z.shape
    split = lat // 2
    n_layers = folded_inv["lu_w_inv_f"].shape[0]
    rows, dev, bf = b * n, z.device, torch.bfloat16
    minv_t = _pad_cols(folded_inv["lu_w_inv_f"].transpose(1, 2).to(bf))
    shift = folded_inv["lu_shift"].float().reshape(n_layers, -1).contiguous()
    chain = _CouplingChain(folded_inv, context, extra, rows, split, tail=(minv_t, shift),
                           lat=lat)
    xc = z.reshape(rows, lat).float().contiguous().clone()
    zb = bf16_rows(rows, lat, dev)
    y = torch.empty(rows, lat, dtype=torch.float32, device=dev)
    # the top layer's LU inverse and x1 cast once, then per layer the
    # conditioner (with attention) and one coupling_inverse, which runs the
    # next layer's LU inverse on its tile (layer 0 writes x)
    top = n_layers - 1
    _build.cast_rows(xc, zb)
    _build.gemm(zb, minv_t[top], y, bias=shift[top])
    _build.cast_rows(y[:, :split], chain.xin[:, :split])
    for l in range(top, -1, -1):
        if chain.has_attn:
            chain.conditioner(l)
        _build.coupling_inverse(chain.xin, split, chain.cpl_stack, l, y,
                                x=xc if l == 0 else None, eps_affine=eps_affine)
    return xc.reshape(b, n, lat)


class AugmenterWeights:
    """B2's weights, made once per weights version (`augmenter_weights`):
    `folded`, the folds as `fold_augmenter` gives them (the plain version's),
    and their kernel layout: the conditioner's `FusedStack` (pre-MLP and q),
    wkv, and the net's `FusedStack` over the packed rows [x | extra | pad |
    attn] (`packed_input_layout`; the first weight with zero rows at the
    pad), its output layer's columns as `augment_net_plan`'s passes of
    interleaved (mean_i, log_std_i) pairs. Shapes the kernels refuse raise."""

    def __init__(self, folded: dict, *, input_dim: int):
        bf = torch.bfloat16
        self.folded = folded
        self.cw = folded["cpl_in_c"].shape[1]
        self.xe, self.xc, self.width = packed_input_layout(
            input_dim, folded["cpl_in_xe"].shape[1] - input_dim, self.cw)
        pre_shapes = [tuple(w.shape[1:]) for w, _ in folded["pre"]]
        q_shape = tuple(folded["wq_f"].shape[1:])
        if not fused_route(pre_shapes, q_shape, [], (0, 0), input_dim, 0)["conditioner"]:
            raise ValueError(f"the fused conditioner cannot take these shapes: pre-MLP "
                             f"{pre_shapes}, q {q_shape}")
        wq = _pad_cols(folded["wq_f"].to(bf))
        bq = folded["bq_f"].float().reshape(1, -1).contiguous()
        self.cond_stack = _build.FusedStack(_bf16_stack(folded["pre"]) + [(wq, bq)],
                                            len(folded["pre"]))
        self.wkv = kv_weights(folded["wkv"])
        w_in = _pad_cols(packed_input_weights(folded["cpl_in_xe"].to(bf), folded["cpl_in_c"]))
        b_in = folded["cpl_in_b"].float().reshape(1, -1).contiguous()
        rest = folded["cpl_rest"]
        w_out, b_out = rest[-1]
        aug = w_out.shape[-1] // 2
        plan = augment_net_plan([tuple(w_in.shape[1:])] + [tuple(w.shape[1:]) for w, _ in rest],
                                self.xc + self.cw, aug)
        passes = list(zip(interleave_passes(w_out, plan["passes"]),
                          interleave_passes(b_out, plan["passes"])))
        self.net_stack = _build.FusedStack(
            [(w_in, b_in)] + _bf16_stack(rest[:-1]) + _bf16_stack(passes), plan["products"],
            n_out=len(passes))


def _fold_once(sources: list, key, make) -> AugmenterWeights:
    """make()'s AugmenterWeights, once per version of the source tensors."""
    def build():
        global AUGMENTER_FOLDS
        AUGMENTER_FOLDS += 1
        with torch.no_grad():
            return make()

    return _AUG_FOLDS.get(sources, key, build)


def augmenter_weights(aug_params: dict, *, input_dim: int, extra_dim: int) -> AugmenterWeights:
    """B2's `AugmenterWeights` for these augmenter params, folded
    (`fold_augmenter`) once per weights version: a lookup keyed on the
    tensors and their versions, which every in-place change (an optimizer
    step, `load_jax_params`) bumps."""
    return _fold_once(tensor_leaves(aug_params), ("params", input_dim, extra_dim),
                      lambda: AugmenterWeights(fold_augmenter(aug_params, input_dim=input_dim,
                                                              extra_dim=extra_dim),
                                               input_dim=input_dim))


def _kernel_weights(folded_aug, input_dim: int) -> AugmenterWeights:
    """`AugmenterWeights` as given, or for a `fold_augmenter` dict its
    kernel layout, made once per version of the dict's tensors."""
    if isinstance(folded_aug, AugmenterWeights):
        return folded_aug
    return _fold_once(tensor_leaves(folded_aug), ("folded", input_dim),
                      lambda: AugmenterWeights(folded_aug, input_dim=input_dim))


def fused_augmenter(x: torch.Tensor, eps: torch.Tensor, context: torch.Tensor,
                    extra: Optional[torch.Tensor], folded_aug, *, nonlin: str = "GELU"):
    """B2: the attention-preconditioned augmenter; replaces the Pallas kernel
    `fused_augmenter` (flow_layer_pallas.py, body `_augment_kernel`).

    x (B, N, in) f32, eps (B, N, aug) f32 standard normal, context
    (B, Nc, E), extra (B, N, e) or None; `folded_aug` is `AugmenterWeights`
    (`augmenter_weights`, the model's) or a `fold_augmenter` dict, whose
    kernel layout is then made once per version of its tensors. Returns z
    (B, N, in + aug) f32 and ldj = -log q(z2) (B, N) f32. A CPU tensor runs
    `fused_augmenter_plain`; a CUDA tensor runs 5 launches: [x | extra |
    pad] cast into the packed rows (`_build.pack_rows`), B1's conditioner
    (`_build.conditioner`, pre-MLP, LayerNorm and q on a row tile kept on
    chip), ctx @ wkv, the cross attention into the packed rows' attention
    columns, and `_build.augment_net`: the net 72 -> 512 -> 512 -> 512 ->
    588 on a 64-row tile kept in shared memory (or, past 512 columns, in
    the wide kernel's scratch), its output layer in two column passes whose
    epilogue forms z2 and ldj on the registers.

    What bounds it on the H100: the net's products (about 1.7 MFLOP a
    point) and the conditioner's, and the attention over Nc context rows,
    once per point; at a small batch the host's launches. Nothing of the
    net ([s | t], its activations) leaves the chip."""
    global FUSED_AUGMENTER_LAUNCHES
    require_gelu(nonlin)
    if not x.is_cuda:
        return fused_augmenter_plain(x, eps, context, extra, folded_aug)
    out = _augmenter_chain(x, eps, context, extra, _kernel_weights(folded_aug, x.shape[-1]))
    FUSED_AUGMENTER_LAUNCHES += 1
    return out


def _augmenter_chain(x, eps, context, extra, w: AugmenterWeights):
    b, n, in_dim = x.shape
    aug = eps.shape[-1]
    rows, dev, bf = b * n, x.device, torch.bfloat16
    d = w.cw
    _, nc, e_dim = context.shape
    # the context as the gemm's A, copied unless its rows already lie apart
    # with 16-byte strides (a broadcast embedding at B=1 reshapes to a view
    # whose rows all share one address)
    ctx2 = context.reshape(b * nc, e_dim)
    if (ctx2.dtype != bf or ctx2.stride(-1) != 1 or ctx2.stride(0) < e_dim
            or not _build.tma_readable(ctx2.data_ptr(), ctx2.stride(0))):
        ctx2 = _pad_cols(ctx2.to(bf))
    xin = torch.empty(rows, w.width, dtype=bf, device=dev)
    q = bf16_rows(rows, d, dev)
    v0, kv_width = kv_layout(d)
    kv = bf16_rows(b * nc, kv_width, dev)
    z = torch.empty(rows, in_dim + aug, dtype=torch.float32, device=dev)
    ldj = torch.empty(rows, dtype=torch.float32, device=dev)
    sources = [x.float()] + ([extra.float()] if extra is not None else [])
    _build.pack_rows(xin[:, :w.xc], *sources)
    _build.conditioner(xin, in_dim, w.cond_stack, 0, q)
    _build.gemm(ctx2, w.wkv[0], kv)
    _build.cross_attention(q, kv[:, :d], kv[:, v0:v0 + d], xin[:, w.xc:w.xc + d], n_items=b)
    _build.augment_net(xin, w.net_stack, x.reshape(rows, in_dim).float(),
                       eps.reshape(rows, aug).float(), z, ldj)
    return z.reshape(b, n, in_dim + aug), ldj.reshape(b, n)
