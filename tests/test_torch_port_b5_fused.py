"""B5's fused per-layer kernels, their plain versions, on the CPU.

`flow_layers_bwd` on CUDA tensors runs, per layer, the recompute in the
fused kernels' record mode (`_build.conditioner_record`,
`coupling_record`), the fused backward kernels (`coupling_bwd`,
`conditioner_bwd`), the attention's launches and one grouped launch of the
weight gradients with one more for every sum (`gemm_tn_grouped`,
`grad_reduce`). On CPU tensors each of those wrappers runs its plain
version (`flow_layer_vjp_cuda.conditioner_record_plain`, ...,
`_build.gemm_tn_grouped_plain`, `grad_reduce_plain`), which keeps the
kernel's interface and rounding points, so `_bwd_fused` on the CPU runs the
CUDA chain's orchestration with the kernels' arithmetic. Here it is held
against the per-product chain it replaced (`_bwd_per_product`),
`flow_layers_bwd_plain` (autograd of the one-layer bf16 stack) and the JAX
package's `flow_layers_bwd` with its Pallas kernel in interpret mode, on
one tiny model with attention and without, with the extra column and
without; the grouped weight gradients against a^T @ b; the kernels'
accumulator-order layout of their f32 records (`_build.fragment_index`).
The other `_build` launches (gemm, gemm_tn, cast_rows, the attention and
row passes) are emulated in PyTorch (`EmulatedLaunches`).
tests/test_torch_port_cuda.py holds the kernels against these plain
versions on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flowcompare_tpu as fc
from flowcompare_tpu.core.mlp import gelu as jgelu
from flowcompare_tpu.ops import flow_layer_pallas as flp
from flowcompare_tpu.ops import flow_layer_vjp_pallas as fvp
from flowcompare_tpu_torch.ops import _build, flow_layer_vjp_cuda as fvc
from test_torch_port_gemm_layout import EmulatedLaunches
from torch_port_fixtures import n, normal, t

torch.set_num_threads(2)


@pytest.fixture
def emulated(monkeypatch):
    emu = EmulatedLaunches()
    for name in ("gemm", "gemm_tn", "cast_rows", "row_norm", "cross_attention", "colsum",
                 "colsum_workspace", "coupling_epilogue_bwd", "attn_bwd_prep", "attention_bwd",
                 "row_norm_bwd", *EmulatedLaunches.FUSED):
        monkeypatch.setattr(_build, name, getattr(emu, name))
    return emu


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _config(attention: bool, extra: bool, **overrides):
    """tests/test_flow_layer_vjp.py's single-grid-step configuration (L = 4,
    B = 1, N = 16, where the Pallas kernel in interpret mode is exact), with
    attention or the global conditioner, with the extra column or not;
    `overrides` change its keys (the wide layers' file: 1,024-wide MLPs)."""
    cfg = fc.get_config("dulcet-universe")
    cfg.update(dict(
        input_dim=4, latent_dim=8, cif_latent_dim=8, n_flow_layers=4,
        hidden_dims=[16, 16], net_augmenter_dist_hidden_dims=[16, 16],
        pre_attention_mlp_hidden_dims=[8, 8],
        hidden_dims_embedder_out=[16, 16], attn_dim=12, attn_input_dim=8,
        input_embedding_dim=4, cross_dim_head=8,
        input_embedder="idenity" if attention else "DGCNNembedderGlobal",
        extra_z_value_context=extra, sample_size=16, n_samples_context=24, n_neighbors=4))
    cfg.update(overrides)
    return fc.configs.derive(cfg)


def _to_torch_folded(jf):
    def conv(v):
        if isinstance(v, int) or v is None:
            return v
        if isinstance(v, list):
            return [(t(w), t(b)) for w, b in v]
        return t(v)
    return {k: conv(v) for k, v in jf.items()}


def _case(attention: bool, extra: bool, **overrides):
    """The folded stacks (JAX and port), the bf16 saves of a forward walk,
    context, extra and cotangents, all from one seed."""
    cfg = _config(attention, extra, **overrides)
    model = fc.FlowCompareModel(cfg, remat=False)
    params, _ = model.init_params(jax.random.PRNGKey(0))
    prep = model._prepare_layers(params["layers"])
    lat, ed = cfg["latent_dim"], int(extra)
    stacks = flp.append_final_block(flp.build_layer_stacks(model, prep), params["final_block"],
                                    lat)
    jf = flp.fold_stacks(stacks, split=lat // 2, extra_dim=ed)
    n_layers = jf["lu_ldj_f"].shape[0]
    rng = np.random.default_rng(1)
    bsz, npts = 1, 16
    x = normal(rng, bsz, npts, lat)
    e_dim = jf["cpl_in_c"].shape[1] if not attention else jf["wkv"].shape[1]
    ctx = normal(rng, bsz, cfg["n_samples_context"] if attention else npts, e_dim)
    ex = normal(rng, bsz, npts, 1) if extra else None
    dz, dldj = normal(rng, bsz, npts, lat), normal(rng, bsz, npts)
    carries, h = [], jnp.asarray(x)
    acc = jnp.zeros((bsz, npts))
    jex = jnp.asarray(ex) if extra else None
    for l in range(n_layers):
        carries.append(h)
        fl = {k: (v if isinstance(v, int) or v is None else
                  [(w[l:l + 1], b[l:l + 1]) for w, b in v] if isinstance(v, list) else
                  v[l:l + 1]) for k, v in jf.items()}
        h, acc = flp.folded_scan_core(h, acc, jnp.asarray(ctx), jex, fl, nonlin=jgelu,
                                      dtype=jnp.bfloat16, remat=False)
    saves = jnp.stack(carries, 0).astype(jnp.bfloat16)
    arrs = {k: v for k, v in jf.items() if k != "n_cpl"}
    ref = fvp.flow_layers_bwd(saves, jnp.asarray(dz), jnp.asarray(dldj), jnp.asarray(ctx), jex,
                              arrs, jf["n_cpl"], interpret=True)
    tsaves = t(saves).bfloat16().reshape(n_layers, bsz * npts, lat)
    ins = (tsaves, t(dz), t(dldj), t(ctx), t(ex) if extra else None, _to_torch_folded(jf))
    return ins, ref


VARIANTS = [(True, True), (True, False), (False, True), (False, False)]


@pytest.mark.parametrize("attention,extra", VARIANTS)
def test_fused_bwd_matches_plain_and_pallas_interpret(emulated, attention, extra):
    """The fused chain (the record kernels, the coupling and conditioner
    backward, the grouped weight gradients and their sums, as their plain
    versions) against the per-product chain it replaces (the same rounding
    points: within 1e-4 of max |ref|, f32 sums in another order), and
    against the plain B5 and the JAX kernel within the JAX package's own
    kernel-vs-vjp bands: 0.03 of max |ref| for dx, dctx and dextra, 0.05
    for the folded gradients (bf16 roundings of g and dp at other points;
    the plain version's autograd returns bf16 weights' gradients in bf16)."""
    ins, ref = _case(attention, extra)
    chain = fvc._bwd_per_product(*ins, 1e-8)
    emulated.fused.clear()
    got = fvc._bwd_fused(*ins, 1e-8)
    plain = fvc.flow_layers_bwd_plain(*ins)
    layers = ins[0].shape[0]
    assert sorted(emulated.fused) == sorted(
        ["coupling_record", "coupling_bwd", "gemm_tn_grouped", "grad_reduce"] * layers
        + ["conditioner_record", "conditioner_bwd"] * layers * attention)
    assert set(got[3]) == set(plain[3]) == set(ref[3])
    for a, c, b, r in zip(got[:3], chain[:3], plain[:3], ref[:3]):
        assert (a is None) == (c is None) == (b is None) == (r is None)
        if a is not None:
            assert _rel(n(a), n(c)) < 1e-4 and _rel(n(a), n(b)) < 0.03 and _rel(n(a), r) < 0.03
    for k, r in ref[3].items():
        assert _rel(n(got[3][k]), n(chain[3][k])) < 1e-4, k
        assert _rel(n(got[3][k]), n(plain[3][k])) < 0.05, k
        assert _rel(n(got[3][k]).reshape(np.shape(r)), r) < 0.05, k


@pytest.mark.parametrize("attention,extra", VARIANTS[:1] + VARIANTS[3:])
def test_fused_bwd_is_deterministic(emulated, attention, extra):
    """Two calls give the same bits (fixed-order sums, no atomics)."""
    ins, _ = _case(attention, extra)
    a, b = fvc._bwd_fused(*ins, 1e-8), fvc._bwd_fused(*ins, 1e-8)
    for x, y in zip(a[:3], b[:3]):
        assert (x is None and y is None) or torch.equal(x, y)
    assert all(torch.equal(a[3][k], b[3][k]) for k in a[3])


@pytest.mark.parametrize("rows", [100, 2600])
def test_grouped_weight_gradients_match_a_t_b(rows):
    """gemm_tn_grouped's K-split partials summed by grad_reduce (plain
    versions) against a^T @ b in f64, for problems of several shapes and
    depths (K splits of whole 64-row chunks once a problem is 1,024 rows
    deep), and a bias's per-tile column sums against the column sum."""
    g = torch.Generator().manual_seed(rows)

    def bf(r, c):
        return _build_rows(torch.randn(r, c, generator=g))

    probs = [(bf(rows, 30), bf(rows, 20)), (bf(rows, 8), bf(rows, 130)), (bf(rows // 2, 16),
                                                                         bf(rows // 2, 8))]
    group = _build.TnGroup(probs)
    assert group.splits >= 1 and all(p.shape[0] == s for p, s in zip(group.partials,
                                                                      group.per_splits))
    if rows >= 1024:
        assert max(group.per_splits) > 1
    bias_src = torch.randn(rows, 24, generator=g)
    outs = [torch.zeros(2, a.shape[1], b.shape[1]) for a, b in probs] + [torch.zeros(2, 1, 24)]
    sums = _build.GradSums([(p, o) for p, o in zip(group.partials, outs)]
                           + [(fvc._tile_sums(bias_src).unsqueeze(1), outs[-1])])
    _build.gemm_tn_grouped(group)
    _build.grad_reduce(sums, 1)
    for (a, b), o in zip(probs, outs):
        ref = a.double().T @ b.double()
        assert torch.allclose(o[1].double(), ref, rtol=1e-5, atol=1e-4)
        assert not o[0].any()
    assert torch.allclose(outs[-1][1, 0].double(), bias_src.double().sum(0), rtol=1e-5,
                          atol=1e-4)


def _build_rows(x: torch.Tensor) -> torch.Tensor:
    """x in bf16 with rows of whole 16 bytes (TMA-readable)."""
    from flowcompare_tpu_torch.ops.flow_layer_cuda import bf16_rows
    out = bf16_rows(x.shape[0], x.shape[1], x.device)
    out.copy_(x)
    return out


def test_bwd_stack_refuses_what_the_kernels_cannot_read():
    """A BwdStack refuses an f32 record with an odd row stride and a dp
    matrix TMA cannot read; a TnGroup refuses an operand TMA cannot read."""
    w = torch.zeros(2, 16, 16, dtype=torch.bfloat16)
    ok_pre = torch.zeros(64, 16)
    ok_d = _build_rows(torch.zeros(64, 16))
    none = [None, None, None]
    with pytest.raises(ValueError, match="even stride"):
        _build.BwdStack([w, w, w], [torch.zeros(64, 17)[:, :16], ok_pre, None], none, none,
                        [ok_d, ok_d, None], none)
    with pytest.raises(ValueError, match="dp rows"):
        _build.BwdStack([w, w, w], [ok_pre, ok_pre, None], none, none,
                        [torch.zeros(64, 20, dtype=torch.bfloat16)[:, 1:17], ok_d, None], none)
    with pytest.raises(ValueError, match="TMA-readable"):
        _build.TnGroup([(torch.zeros(64, 12, dtype=torch.bfloat16)[:, :10], ok_d)])


@pytest.mark.parametrize("rows,cols", [(130, 512), (64, 256), (100, 300), (1, 64)])
def test_fragment_index_is_a_bijection_in_the_kernels_order(rows, cols):
    """`_build.fragment_index` maps every element of a fragment_rows matrix
    to its own place in the buffer under it, in the order the kernels write
    (a tile of 64 rows a block of 8 cpw float4 a consumer thread, float4 k of
    thread t at (b * 8 cpw + k) * 512 + t; element (b, t, k, q) row 64 b +
    fr + 8 (q >> 1), column (cpw (t // 128) + k // 8) * 64 + 8 (k % 8) + fc +
    (q & 1)), and `fragment_to_rows` reads a buffer back row-major by it."""
    view = _build.fragment_rows(rows, cols, "cpu")
    index = _build.fragment_index(rows, cols, "cpu")
    flat = torch.as_strided(view, (view.untyped_storage().nbytes() // 4,), (1,), 0)
    assert index.unique().numel() == rows * cols and int(index.max()) < flat.numel()
    cpw = -(-(-(-cols // 64)) // 4)
    b, t, k, q = 0, 131, 9 % (8 * cpw), 3
    tt = t % 128
    row, col = (tt // 32) * 16 + (tt % 32) // 4 + 8, (cpw + k // 8) * 64 + 8 * (k % 8) + 2 * (
        tt % 4) + 1
    if row < rows and col < cols:
        assert int(index[row, col]) == ((b * 8 * cpw + k) * 512 + t) * 4 + q
    flat.copy_(torch.arange(flat.numel(), dtype=torch.float32))
    assert torch.equal(_build.fragment_to_rows(view).long(), index)
