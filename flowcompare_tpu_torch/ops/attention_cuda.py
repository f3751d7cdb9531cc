"""The fused cross-attention core (B10), its plain version and its gradient.

Counterpart of `flowcompare_tpu/ops/attention_pallas.py`
(`fused_attention_core`, a `jax.custom_vjp` over a Pallas kernel):
softmax(q k^T * scale) @ v for q (B, Nq, D) and k, v (B, Nkv, D), with the
probabilities normalised in f32 before the PV product and the output cast
once to q's dtype.

* `fused_attention_core_plain` is the plain version: the Pallas kernel's
  three steps in torch (f32 scores times the temperature, max-subtracted
  exp divided by its f32 row sum, p @ v in f32).
* `fused_attention_core_split` computes what the CUDA kernel computes, in
  torch: p in f32, split into three bf16 terms p_hi + p_mid + p_lo (about
  24 bits of p), and out = p_hi @ v + p_mid @ v + p_lo @ v with f32 sums.
  The CPU tests hold it against the plain version and the Pallas kernel.
* `fused_attention_core` is a `torch.autograd.Function`. Its forward runs
  the plain version on CPU tensors and launches `csrc/attention_core.cu` on
  CUDA tensors (bf16, 1 <= D <= `_build.ATTENTION_MAX_D` = 1,024, past 512
  on `csrc/attention_core_cluster.cu`'s thread-block clusters; an operand
  TMA cannot read, a base off 16-byte alignment or rows not of whole 16
  bytes, is first copied into rows it can; anything else raises). Its backward is the
  JAX package's `_bwd` as written: s and p recomputed in f32 with plain
  products, then dv, dp, ds, dq and dk, returned in the inputs' dtypes. The
  JAX package computes that backward outside any Pallas kernel, so plain
  products are its faithful counterpart here.

Dropped from the JAX module: the padding of Nq to a multiple of 512 query
rows, a TPU tiling detail (the kernel masks its ragged last block).
"""

from __future__ import annotations

import torch

from . import _build

FUSED_ATTENTION_CORE_LAUNCHES = 0


def fused_attention_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """Plain version of B10: (B, Nq, D), (B, Nkv, D) x 2 -> (B, Nq, D) in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    return torch.matmul(p, v.float()).to(q.dtype)


def fused_attention_core_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """The CUDA kernel's arithmetic in torch: p = e / sum(e) in f32 as in the
    plain version, split into three bf16 terms (p_hi = bf16(p), p_mid =
    bf16(p - p_hi), p_lo = bf16(p - p_hi - p_mid)), each multiplied by v
    (bf16) with f32 sums, the output cast once to q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    vf = v.bfloat16().float()
    out, rest = 0.0, p
    for _ in range(3):
        term = rest.bfloat16().float()
        out = out + torch.matmul(term, vf)
        rest = rest - term
    return out.to(q.dtype)


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """A (rows, D) matrix as the kernel's TMA reads it: t itself where its
    base is 16-byte aligned and its rows whole 16 bytes, else a copy into
    rows padded to 8 elements (v = kv[..., D:] at D no multiple of 8)."""
    if t.stride(-1) == 1 and _build.attention_readable(t):
        return t
    rows, d = t.shape
    return torch.empty(rows, -(-d // 8) * 8, dtype=t.dtype, device=t.device)[:, :d].copy_(t)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """attention_core.cu on CUDA tensors; raises on what the kernel does not take."""
    global FUSED_ATTENTION_CORE_LAUNCHES
    b, nq, d = q.shape
    nkv = k.shape[1]
    if not 1 <= d <= _build.ATTENTION_MAX_D or k.shape[-1] != d or v.shape[-1] != d:
        raise ValueError(f"fused_attention_core: the CUDA kernel takes D in [1, "
                         f"{_build.ATTENTION_MAX_D}], got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"fused_attention_core: the CUDA kernel takes bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape[0] != b or tuple(v.shape) != (b, nkv, d) or nkv == 0:
        raise ValueError(f"fused_attention_core: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    out = torch.empty(b * nq, d, dtype=q.dtype, device=q.device)
    _build.attention_core(_rows16(q.reshape(b * nq, d)), _rows16(k.reshape(b * nkv, d)),
                          _rows16(v.reshape(b * nkv, d)), out, n_items=b, scale=scale)
    FUSED_ATTENTION_CORE_LAUNCHES += 1
    return out.reshape(b, nq, d)


class _FusedAttentionCore(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if not q.is_cuda:
            return fused_attention_core_plain(q, k, v, scale)
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        scale = ctx.scale
        qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1)
        dv = torch.matmul(p.transpose(-1, -2), gf)
        dp = torch.matmul(gf, vf.transpose(-1, -2))
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        dq = torch.matmul(ds, kf) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def fused_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """B10: softmax(q k^T * scale) @ v, differentiable; replaces the Pallas
    kernel `fused_attention_core` (attention_pallas.py, body `_kernel`).

    q (B, Nq, D), k and v (B, Nkv, D) (k and v may be column slices of one
    [k | v] tensor). A CPU tensor runs `fused_attention_core_plain`; a CUDA
    tensor launches attention_core (bf16, 1 <= D <= 1,024), one block per 64
    query rows of an item (and per 128 output columns past D = 128; past D
    = 512 those blocks form a cluster that shares the scores): q k^T
    on wgmma, p in f32 split into three bf16 terms
    whose PV products run on wgmma into one f32 sum, so p keeps about 24
    bits where flash attention's bf16 p keeps 8.

    What bounds it on the H100: the operations of one q k^T and the three
    bf16 PV products at the tensor cores' rate."""
    return _FusedAttentionCore.apply(q, k, v, scale)
