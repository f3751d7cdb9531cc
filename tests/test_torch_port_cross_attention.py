"""Port parity: the cross attention of the B1, B2, B5 and B7 chains.

`_build.cross_attention_plain` and `_build.attention_bwd_plain` are the
specs of the TMA + wgmma kernels (csrc/cross_attention.cu,
csrc/cross_attention_bwd.cu), with the C entry points' exact contract: per
item, s = q k^T in f32, m the exact row maximum, e = exp(s - m), out =
bf16((bf16(e) v) / sum(e)) with m and den = sum(e) written out; the
backward from du = da / den and ddn (`attn_bwd_prep_plain`), dv = bf16(e)^T
du, dS = bf16(e (du v^T + ddn)), dq = dS k, dk = dS^T q, in f32 and bf16.
Here they are held against the JAX package on the same numpy inputs at
ragged shapes (3 items of 70 queries against 90 or 34 keys, so no size is a
multiple of a 64-row tile) and at head widths across the kernels' range
(1 <= D <= 1,024: D = 8, 20, 32, 64, 96, 128, 256 and 512, so every tile
width and widths between them, v = kv[:, D:] off 16-byte alignment at D =
20, and the cluster tier's D = 576 and 1,024):
the forward against max-subtracted softmax
attention in jnp and the package's own `_attn_core` (the B5 kernel's
attention, flow_layer_vjp_pallas.py); the backward against `jax.vjp` of the
f32 function and of `_attn_core`. Tolerances: the operands are bf16 and e
is rounded to bf16 for its products, so outputs agree to 1e-2 relative
(one bf16 rounding) and gradients to a cosine >= 0.9999 with a max error
<= 1e-2 of max |ref|. The wrappers run these plain versions on CPU tensors
without counting a launch; the route rule is a function of pointers and
strides of the operands read alone. tests/test_torch_port_cuda.py holds the
kernels against the plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowcompare_tpu.ops.flow_layer_vjp_pallas import _attn_core
from flowcompare_tpu_torch.ops import _build
from flowcompare_tpu_torch.ops import flow_layer_cuda as flc

torch.set_num_threads(2)
# (items, queries, keys, head width D); the D = 64 cases keep their ids
HEAD_WIDTHS = (8, 20, 32, 64, 96, 128, 256, 512, 576, 1024)
SHAPES = [pytest.param(3, 70, nkv, d, id=f"3-70-{nkv}" + ("" if d == 64 else f"-d{d}"))
          for d in HEAD_WIDTHS for nkv in (90, 34)]


def _inputs(items, nq, nkv, seed, d=64):
    """bf16-exact q (items*nq, d) and kv (items*nkv, 2 d) as numpy f32,
    q scaled by 1/sqrt(d) as the folds do."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(items * nq, d)) / d ** 0.5).astype(np.float32)
    kv = rng.normal(size=(items * nkv, 2 * d)).astype(np.float32)
    rnd = lambda a: torch.from_numpy(a).bfloat16().float().numpy()    # noqa: E731
    return rnd(q), rnd(kv)


def _jax_attention(q, k, v):
    """Max-subtracted softmax attention of one item in f32 (jnp)."""
    s = q @ k.T
    e = jnp.exp(s - jnp.max(s, axis=-1, keepdims=True))
    return (e @ v) / jnp.sum(e, axis=-1, keepdims=True)


def _forward(q, kv, items):
    tq, tkv = torch.from_numpy(q).bfloat16(), torch.from_numpy(kv).bfloat16()
    d = tq.shape[1]
    out = torch.empty(tq.shape, dtype=torch.bfloat16)
    m, den = torch.empty(tq.shape[0]), torch.empty(tq.shape[0])
    _build.cross_attention_plain(tq, tkv[:, :d], tkv[:, d:], out, n_items=items, m_out=m,
                                 den_out=den)
    return tq, tkv, out, m, den


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("items,nq,nkv,d", SHAPES)
def test_cross_attention_plain_matches_jax(items, nq, nkv, d):
    q, kv = _inputs(items, nq, nkv, seed=nkv, d=d)
    _, _, out, m, den = _forward(q, kv, items)
    qj = jnp.asarray(q).reshape(items, nq, d)
    kj, vj = (jnp.asarray(kv[:, c:c + d]).reshape(items, nkv, d) for c in (0, d))
    got = out.float().numpy().reshape(items, nq, d)
    ref = np.asarray(jax.vmap(_jax_attention)(qj, kj, vj))
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-2)
    core = np.asarray(jax.vmap(_attn_core)(qj, kj, vj))     # e rounded to bf16 for P v
    np.testing.assert_allclose(got, core, rtol=1e-2, atol=1e-2)
    s = np.einsum("bnd,bmd->bnm", np.asarray(qj), np.asarray(kj))
    np.testing.assert_allclose(m.numpy(), s.max(-1).ravel(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(den.numpy(), np.exp(s - s.max(-1, keepdims=True)).sum(-1).ravel(),
                               rtol=1e-5)


@pytest.mark.parametrize("items,nq,nkv,d", SHAPES)
@pytest.mark.parametrize("reference", ["f32", "attn_core"])
def test_attention_bwd_plain_matches_jax_vjp(items, nq, nkv, d, reference):
    """attn_bwd_prep_plain + attention_bwd_plain against jax.vjp of the f32
    function, or of the JAX package's bf16 `_attn_core`, for one cotangent."""
    q, kv = _inputs(items, nq, nkv, seed=100 + nkv, d=d)
    da = np.random.default_rng(7).normal(size=(items * nq, d)).astype(np.float32)
    tq, tkv, out, m, den = _forward(q, kv, items)
    du = torch.empty(tq.shape, dtype=torch.bfloat16)
    ddn = torch.empty(tq.shape[0])
    _build.attn_bwd_prep_plain(torch.from_numpy(da), out, den, du, ddn)
    dq, dq_b = torch.empty(tq.shape), torch.empty(tq.shape, dtype=torch.bfloat16)
    dkv, dkv_b = torch.empty(tkv.shape), torch.empty(tkv.shape, dtype=torch.bfloat16)
    _build.attention_bwd_plain(tq, tkv[:, :d], tkv[:, d:], du, ddn, m, dq, dq_b, dkv, dkv_b,
                               n_items=items)
    fn = jax.vmap(_jax_attention if reference == "f32" else _attn_core)
    args = (jnp.asarray(q).reshape(items, nq, d),
            *(jnp.asarray(kv[:, c:c + d]).reshape(items, nkv, d) for c in (0, d)))
    _, vjp = jax.vjp(fn, *args)
    refs = vjp(jnp.asarray(da).reshape(items, nq, d))
    gots = (dq.numpy(), dkv[:, :d].numpy(), dkv[:, d:].numpy())
    for name, got, ref in zip(("dq", "dk", "dv"), gots, refs):
        ref = np.asarray(ref).reshape(got.shape)
        assert _cos(got, ref) >= 0.9999, name
        assert _rel(got, ref) <= 1e-2, name
    assert torch.equal(dq_b, dq.bfloat16()) and torch.equal(dkv_b, dkv.bfloat16())


def test_wrappers_run_the_plain_versions_on_cpu_without_counting():
    q, kv = _inputs(3, 70, 34, seed=3)
    tq, tkv, out, m, den = _forward(q, kv, 3)
    counters = ("CROSS_ATTENTION_WGMMA_LAUNCHES", "CROSS_ATTENTION_WMMA_LAUNCHES",
                "ATTENTION_BWD_WGMMA_LAUNCHES", "ATTENTION_BWD_WMMA_LAUNCHES",
                "CROSS_ATTENTION_CLUSTER_LAUNCHES", "ATTENTION_BWD_CLUSTER_LAUNCHES")
    before = [getattr(_build, c) for c in counters]
    got, gm, gd = torch.empty_like(out), torch.empty_like(m), torch.empty_like(den)
    _build.cross_attention(tq, tkv[:, :64], tkv[:, 64:], got, n_items=3, m_out=gm, den_out=gd)
    assert torch.equal(got, out) and torch.equal(gm, m) and torch.equal(gd, den)
    da = torch.randn(tq.shape, generator=torch.Generator().manual_seed(4))
    du, ddn = torch.empty(tq.shape, dtype=torch.bfloat16), torch.empty(tq.shape[0])
    _build.attn_bwd_prep(da, out, den, du, ddn)
    outs = []
    for fn in (_build.attention_bwd, _build.attention_bwd_plain):
        bufs = (torch.empty(tq.shape), torch.empty(tq.shape, dtype=torch.bfloat16),
                torch.empty(tkv.shape), torch.empty(tkv.shape, dtype=torch.bfloat16))
        fn(tq, tkv[:, :64], tkv[:, 64:], du, ddn, m, *bufs, n_items=3)
        outs.append(bufs)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert [getattr(_build, c) for c in counters] == before


def _view(cols, offset, width=64):
    """A bf16 (100, width) view at column `offset` of a (100, cols) matrix."""
    return torch.empty(100, cols, dtype=torch.bfloat16)[:, offset:offset + width]


@pytest.mark.parametrize("q_view,kv_cols,route", [
    ((64, 0), 128, "wgmma"),     # the chains' q and kv halves
    ((136, 8), 128, "wgmma"),
    ((72, 1), 128, "wmma"),      # q 2 bytes off a 16-byte boundary
    ((64, 0), 130, "wmma"),      # k and v rows of 260 bytes
    ((65, 1), 128, "wmma"),      # q rows of 130 bytes
])
def test_attention_route_is_decided_by_alignment_alone(q_view, kv_cols, route):
    """The route reads the operands' bases and row strides alone: TMA reads
    16-byte-aligned bases and rows of whole 16 bytes. Outputs take no part:
    the kernels write rows that cannot take pairs an element at a time."""
    q = _view(*q_view)
    kv = torch.empty(100, kv_cols, dtype=torch.bfloat16)
    k, v = kv[:, :64], kv[:, 64:128]
    assert _build.attention_route([q, k, v]) == route


@pytest.mark.parametrize("d", HEAD_WIDTHS)
def test_attention_route_at_each_head_width(d):
    """The chains' layout at each head width takes the wgmma route: q in rows
    padded to whole 16 bytes (`bf16_rows`), k and v in rows [k | 0 | v]
    with v at D rounded up to a multiple of 8 (`kv_layout`); v as the
    second half of a (rows, 2 D) matrix takes the WMMA route unless D is a
    multiple of 8 (its base 2 D bytes in)."""
    q = flc.bf16_rows(100, d, "cpu")
    v0, width = flc.kv_layout(d)
    kv = flc.bf16_rows(100, width, "cpu")
    assert _build.attention_route([q, kv[:, :d], kv[:, v0:v0 + d]]) == "wgmma"
    halves = flc.bf16_rows(100, 2 * d, "cpu")
    assert _build.attention_route([q, halves[:, :d], halves[:, d:]]) == (
        "wgmma" if d % 8 == 0 else "wmma")
