"""Port parity, B10: the fused cross-attention core and its entry point.

The port's plain `fused_attention_core` (what a CPU tensor runs) against the
JAX package's `fused_attention_core` with its Pallas kernel in interpret
mode (`pl.pallas_call` swapped, in the attention_pallas module only, for
the same call with interpret=True); the port's autograd backward against
`jax.vjp` of the JAX custom VJP; and `apply_cross_attention(fused=True)`,
which on the CPU takes the plain products in both packages.
tests/test_torch_port_cuda.py holds the CUDA kernel against the plain
version on the card.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from flowcompare_tpu.core import attention as jattn
from flowcompare_tpu.ops import attention_pallas
from flowcompare_tpu_torch.core import attention
from flowcompare_tpu_torch.ops import attention_cuda
from torch_port_fixtures import n, normal, t

torch.set_num_threads(2)

SCALE = 64 ** -0.5


@pytest.fixture
def interpret(monkeypatch):
    """The Pallas kernel of attention_pallas in interpret mode (the CPU)."""
    monkeypatch.setattr(attention_pallas, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec))


def _qkv(seed, d, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = normal(rng, 2, 70, d), normal(rng, 2, 90, d), normal(rng, 2, 90, d)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return [jnp.asarray(a, jd) for a in (q, k, v)], [t(a).to(td) for a in (q, k, v)]


def _within_bf16_ulps(got, ref, ulps=1):
    """|got - ref| <= ulps bf16 ulps of |ref| (2^-7 relative per ulp) + 1e-6."""
    return bool((np.abs(got - ref) <= ulps * 2.0 ** -7 * np.abs(ref) + 1e-6).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 16, 32, 128, 20, 256, 512])
def test_fused_attention_core_plain_matches_pallas_interpret(interpret, d, dtype):
    """Past D = 128 at the model's temperature, D^-0.5 (apply_cross_attention's
    inner_dim^-0.5): 64^-0.5 there would spread the scores sqrt(D / 64)
    times as wide as the tolerance below was set for."""
    (jq, jk, jv), (q, k, v) = _qkv(0, d, dtype)
    scale = SCALE if d <= 128 else d ** -0.5
    ref = n(attention_pallas.fused_attention_core(jq, jk, jv, scale))
    got = attention_cuda.fused_attention_core(q, k, v, scale)
    assert got.dtype == q.dtype and got.shape == (2, 70, d)
    if dtype == "float32":
        # the same three f32 steps: exp and summation order only
        np.testing.assert_allclose(n(got), ref, rtol=1e-5, atol=1e-6)
    else:
        # f32 inside, one bf16 rounding of the output: at most one bf16 ulp
        # where the f32 values straddle a rounding boundary
        assert _within_bf16_ulps(n(got), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_core_backward_matches_jax_vjp(interpret, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(1, 64, dtype)
    g = normal(np.random.default_rng(2), 2, 70, 64)
    out, vjp = jax.vjp(lambda a, b, c: attention_pallas.fused_attention_core(a, b, c, SCALE),
                       jq, jk, jv)
    refs = vjp(jnp.asarray(g, out.dtype))
    ins = [a.detach().requires_grad_() for a in (q, k, v)]
    got_out = attention_cuda.fused_attention_core(*ins, SCALE)
    grads = torch.autograd.grad(got_out, ins, t(g).to(got_out.dtype))
    for got, ref, name in zip(grads, refs, "qkv"):
        assert got.dtype == ins[0].dtype, name
        if dtype == "float32":
            # f32 recompute on both sides: summation order only
            np.testing.assert_allclose(n(got), n(ref), rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            # the same f32 recompute of the bf16 inputs and cotangent, one bf16
            # rounding of each gradient
            assert _within_bf16_ulps(n(got), n(ref)), name


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_apply_cross_attention_fused_matches_jax(dtype):
    """fused=True on the CPU: both packages gate the fused core on the
    accelerator and take the plain products here; the port equals JAX's
    fused=True and its own fused=False."""
    rng = np.random.default_rng(3)
    p = {"norm": {"scale": 1 + 0.1 * normal(rng, 32), "bias": 0.1 * normal(rng, 32)},
         "to_q": {"w": normal(rng, 32, 64) / 6}, "to_kv": {"w": normal(rng, 20, 128) / 4},
         "out": {"w": normal(rng, 64, 48) / 8, "b": 0.1 * normal(rng, 48)}}
    x, ctx = normal(rng, 2, 24, 32), normal(rng, 2, 40, 20)
    jd = None if dtype is None else jnp.bfloat16
    td = None if dtype is None else torch.bfloat16
    ref = jattn.apply_cross_attention(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                                      jnp.asarray(ctx), dtype=jd, fused=True)
    tp = jax.tree_util.tree_map(t, p)
    got = attention.apply_cross_attention(tp, t(x), t(ctx), dtype=td, fused=True)
    tol = 1e-5 if dtype is None else 3e-2   # bf16: rounding of q, k, v and the output
    np.testing.assert_allclose(n(got), n(ref), atol=tol, rtol=tol)
    assert torch.equal(got, attention.apply_cross_attention(tp, t(x), t(ctx), dtype=td))


def test_fused_attention_core_launches_nothing_on_the_cpu():
    """A CPU tensor runs the plain version: no launch is counted."""
    _, (q, k, v) = _qkv(4, 64, "bfloat16")
    before = attention_cuda.FUSED_ATTENTION_CORE_LAUNCHES
    out = attention_cuda.fused_attention_core(q, k, v, SCALE)
    assert attention_cuda.FUSED_ATTENTION_CORE_LAUNCHES == before
    assert torch.equal(out, attention_cuda.fused_attention_core_plain(q, k, v, SCALE))


@pytest.mark.parametrize("nq,nkv", [(70, 90), (64, 1), (100, 1250)])
def test_split_p_matches_plain_and_pallas_interpret(interpret, nq, nkv):
    """The CUDA kernel's arithmetic (`fused_attention_core_split`: p in f32
    split into three bf16 terms, three bf16 PV products with f32 sums) at
    ragged key counts, against the plain version and the Pallas kernel:
    before the output cast it lies within 2^-20 of sum(p |v|) of the f32
    result (the split keeps about 24 bits of p; f32 sums in another order
    stay far inside), where rounding p to bf16 alone, as flash attention
    does, goes past that bound; after the cast at most one bf16 ulp from
    both."""
    rng = np.random.default_rng(nq + nkv)
    q, k, v = (t(normal(rng, 2, m, 64)).bfloat16() for m in (nq, nkv, nkv))
    exact = attention_cuda.fused_attention_core_plain(q.float(), k.float(), v.float(), SCALE)
    split = attention_cuda.fused_attention_core_split(q.float(), k.float(), v.float(), SCALE)
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * SCALE, -1)
    scale_pv = p @ v.float().abs()
    assert bool(((split - exact).abs() <= 2.0 ** -20 * scale_pv + 1e-7).all())
    if nkv > 1:
        bf16_p = p.bfloat16().float() @ v.float()
        assert bool(((bf16_p - exact).abs() > 2.0 ** -20 * scale_pv + 1e-7).any())
    got = n(attention_cuda.fused_attention_core_split(q, k, v, SCALE).float())
    ref = n(attention_pallas.fused_attention_core(
        *(jnp.asarray(n(a.float()), jnp.bfloat16) for a in (q, k, v)), SCALE).astype(jnp.float32))
    plain = n(attention_cuda.fused_attention_core_plain(q, k, v, SCALE).float())
    assert _within_bf16_ulps(got, plain) and _within_bf16_ulps(got, ref)
