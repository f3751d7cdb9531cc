"""The fused layer kernels' plain versions and route rule, on the CPU.

B1 and B7 run each coupling layer as two kernels of csrc/fused_layer.cu
that keep a 64-row tile on chip (`_build.conditioner`, `coupling_layer`,
`coupling_inverse`); their plain versions (`flow_layer_cuda.
conditioner_plain`, `coupling_layer_plain`, `coupling_inverse_plain`) keep
the per-product chain's rounding points. Here, with every other `_build`
launch emulated in PyTorch (`EmulatedLaunches`), the fused parts are held
against the per-product chain's launches at the shipped widths, the chains
against the plain B1 and B7 there, against the JAX package's Pallas kernels
in interpret mode on one tiny layer, and with save=True against the plain
saves; the route rule is a pure function of shapes, and a stack it refuses
raises. tests/test_torch_port_cuda.py holds the kernels against these plain
versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flowcompare_tpu_torch as ft
from flowcompare_tpu.ops import flow_layer_pallas as flp
from flowcompare_tpu_torch.flows.coupling import sigmoid_scale
from flowcompare_tpu_torch.ops import _build, flow_layer_cuda as flc
from test_torch_port_gemm_layout import EmulatedLaunches
from torch_port_fixtures import N_CONTEXT, N_POINTS, model_pair, n, normal, t

torch.set_num_threads(2)

LAUNCHES = ("gemm", "gemm_tn", "cast_rows", "row_norm", "cross_attention", "coupling_epilogue",
            "inverse_coupling_epilogue", "augment_epilogue", "conditioner", "coupling_layer",
            "coupling_inverse")


@pytest.fixture
def emulated(monkeypatch):
    emu = EmulatedLaunches()
    for name in LAUNCHES:
        monkeypatch.setattr(_build, name, getattr(emu, name))
    return emu


def shipped(preset: str, layers: int = 2, points: int = 48):
    """The preset at its full widths, `layers` layers, its LinearLU and
    ActNorm moved off identity; (cfg, model, folded, folded_inv, inputs)."""
    cfg = ft.get_config(preset)
    cfg.update(compute_dtype="bfloat16", n_flow_layers=layers, sample_size=points,
               n_samples_context=40)
    model = ft.FlowCompareModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.state_dict().items():
            if name.rsplit(".", 1)[-1] in ("lower_entries", "upper_entries", "shift", "log_scale"):
                p.add_(0.02 * torch.randn(p.shape, generator=g))
    ed, lat, e = int(cfg["using_extra_context"]), cfg["latent_dim"], cfg["input_embedding_dim"]
    params = model.params()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # a batched CPU inverse of 300 x 300 matrices can stall on 2 threads
    try:
        folded, folded_inv = model._folded(params, ed), model._folded_inverse(params, ed)
    finally:
        torch.set_num_threads(threads)
    ctx = (torch.randn(1, 1, e, generator=g).bfloat16().expand(1, points, e) if model.is_global
           else torch.randn(1, 40, e, generator=g).bfloat16())
    extra = torch.randn(1, points, 1, generator=g) if ed else None
    x = torch.randn(1, points, lat, generator=g)
    return cfg, model, folded, folded_inv, (x, torch.zeros(1, points), ctx, extra)


def _max(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


# --------------------------------------------------------------- route rule

def _shapes(folded, lat, ed):
    split = lat // 2
    xe, xc, _ = flc.packed_input_layout(split, ed, folded["cpl_in_c"].shape[1])
    cpl = [(xc + folded["cpl_in_c"].shape[1], folded["cpl_in_xe"].shape[2])]
    cpl += [tuple(w.shape[1:]) for w, _ in folded["cpl_rest"]]
    pre = None if folded["pre"] is None else [tuple(w.shape[1:]) for w, _ in folded["pre"]]
    q = None if folded["wq_f"] is None else tuple(folded["wq_f"].shape[1:])
    return pre, q, cpl, (lat, lat), split, lat


@pytest.mark.parametrize("preset,cond", [("dulcet-universe", True), ("good-surf", True),
                                         ("summer-terrain", True), ("swept-energy", True),
                                         ("helpful-sponge", False)])
def test_every_preset_takes_the_fused_route(preset, cond):
    cfg, model, folded, _, _ = shipped(preset, points=8)
    shapes = _shapes(folded, cfg["latent_dim"], int(cfg["using_extra_context"]))
    assert flc.fused_route(*shapes) == {"conditioner": cond, "coupling": True}
    pre, q, cpl, tail, split, lat = shapes
    # the shipped widths: a 215/216-wide packed row (276 for the global
    # conditioner) into 512-wide hidden products, [s | t] of 300
    assert cpl[-1] == (512, 300) and max(k for k, _ in cpl) <= 512
    assert len(cpl) == (7 if preset == "helpful-sponge" else 4)
    if cond:
        assert pre == [(150, 256), (256, 256), (256, 256), (256, 256)] and q == (256, 64)


def test_route_refuses_what_the_kernels_cannot_hold():
    pre, q = [(150, 256)] + [(256, 256)] * 3, (256, 64)
    cpl, tail = [(216, 512), (512, 512), (512, 512), (512, 300)], (300, 300)
    assert flc.fused_route(pre, q, cpl, tail, 150, 300) == {"conditioner": True,
                                                            "coupling": True}
    # products up to 2,048 wide take the wide kernels; past it no kernel
    for w in (640, 1024, 2048):
        wide = [(216, w), (w, w), (w, w), (w, 300)]
        assert flc.fused_route(pre, q, wide, tail, 150, 300)["coupling"]
    wide = [(216, 2056), (2056, 2056), (2056, 2056), (2056, 300)]
    assert not flc.fused_route(pre, q, wide, tail, 150, 300)["coupling"]
    # the LinearLU's latent and [s | t] take two passes (<= 1,024)
    big = [(216, 512), (512, 512), (512, 512), (512, 600)]
    assert flc.fused_route(pre, q, big, (600, 600), 300, 600)["coupling"]
    big = [(216, 512), (512, 512), (512, 512), (512, 1026)]
    assert not flc.fused_route(pre, q, big, (1026, 1026), 513, 1026)["coupling"]
    deep = [(216, 512)] + [(512, 512)] * 9 + [(512, 300)]       # 11 products + the tail
    assert not flc.fused_route(pre, q, deep, tail, 150, 300)["coupling"]
    assert not flc.fused_route(pre, q, cpl[:-1] + [(512, 200)], tail, 150, 300)["coupling"]
    assert flc.fused_route([(150, 600)] + [(600, 600)] * 3, (600, 64), cpl, tail, 150,
                           300)["conditioner"]
    assert not flc.fused_route([(150, 1040)] + [(1040, 1040)] * 3, (1040, 64), cpl, tail, 150,
                               300)["conditioner"]
    assert not flc.fused_route(None, None, cpl, tail, 150, 300)["conditioner"]


def test_a_refused_stack_raises(emulated, monkeypatch):
    """B1 and B7 have no per-product route: a stack `fused_route` refuses
    raises instead of running one."""
    cfg, _, folded, folded_inv, (x, ldj, ctx, extra) = shipped("dulcet-universe", points=8)
    for refused in ({"conditioner": False, "coupling": True},
                    {"conditioner": True, "coupling": False}):
        with monkeypatch.context() as m:
            m.setattr(flc, "fused_route", lambda *a, r=refused, **k: r)
            with pytest.raises(ValueError, match="cannot take these shapes"):
                flc._forward_chain(x, ldj, ctx, extra, folded, 1e-8, False)
            with pytest.raises(ValueError, match="cannot take these shapes"):
                flc._inverse_chain(x, ctx, extra, folded_inv, 1e-8)
    assert emulated.fused == []


# -------------------------------------------------- plain versions, by parts

def test_interleaved_st_gives_the_natural_scale_and_shift():
    g = torch.Generator().manual_seed(0)
    w, b = torch.randn(3, 20, 12, generator=g), torch.randn(3, 12, generator=g)
    h = torch.randn(7, 20, generator=g)
    st = h @ w[1] + b[1]
    sti = h @ flc._interleave_st(w)[1] + flc._interleave_st(b)[1]
    torch.testing.assert_close(sti[:, 0::2], st[:, :6])
    torch.testing.assert_close(sti[:, 1::2], st[:, 6:])
    torch.testing.assert_close(sigmoid_scale(sti[:, 0::2], 1e-8), sigmoid_scale(st[:, :6], 1e-8))


@pytest.mark.parametrize("preset", ["dulcet-universe", "summer-terrain", "helpful-sponge"])
def test_fused_parts_match_the_per_product_chain(emulated, monkeypatch, preset):
    """Layer by layer at the shipped widths: the conditioner's q and one
    coupling layer forward, the fused plain versions against the per-product
    chain's launches on the same packed rows (the pre-MLP's gemms, row_norm
    and the q gemm; the coupling MLP's gemms as B2's net runs them, then the
    affine and the LinearLU in f32). The two differ only in accumulation
    order: q within four bf16 roundings of its scale, x within 2e-2 of its
    scale."""
    cfg, model, folded, folded_inv, (x, ldj, ctx, extra) = shipped(preset)
    lat, rows = cfg["latent_dim"], x.shape[1]
    split = lat // 2
    bf = torch.bfloat16
    lu = (flc._pad_cols(folded["lu_w_f"].transpose(1, 2).to(bf)),
          folded["lu_b"].float().reshape(2, -1).contiguous())
    fused = flc._CouplingChain(folded, ctx, extra, rows, split, tail=lu, lat=lat)
    chain = flc._CouplingChain(folded, ctx, extra, rows, split)    # the per-product MLP
    assert fused.cpl_stack is not None and chain.cpl_stack is None
    assert hasattr(fused, "cond_stack") == (not model.is_global)
    x2 = x.reshape(rows, lat)
    for c in (fused, chain):
        c.xin[:, :split] = x2[:, :split]
    if fused.has_attn:
        pre = flc._bf16_stack(folded["pre"])
        wq = flc._pad_cols(folded["wq_f"].to(bf))
        bq = folded["bq_f"].float().reshape(2, -1).contiguous()
        q_f = torch.empty(rows, pre[-1][0].shape[-1])
        q_n = flc.bf16_rows(rows, q_f.shape[1], "cpu")
    for l in range(2):
        if fused.has_attn:
            fused.conditioner(l)
            # the per-product conditioner: gemms, row_norm, the q gemm
            _build.mlp_chain(chain.xin[:, :split], flc._at(pre, l), q_f, chain.h)
            _build.row_norm(q_f, q_n)
            _build.gemm(q_n, wq[l], chain.q, bias=bq[l])
            assert _max(fused.q, chain.q) <= 4 * 2 ** -8 * float(chain.q.float().abs().max())
            chain.xin[:, chain.xc:] = fused.xin[:, fused.xc:]
        # forward: per-product chain then its epilogue and LinearLU, in f32
        xf, lf = x2.clone(), torch.zeros(rows)
        _build.coupling_layer(fused.xin, split, fused.cpl_stack, l, xf, lf,
                              folded["lu_ldj_f"][l:l + 1], eps_affine=1e-8)
        _build.mlp_chain(chain.xin[:, :chain.xc + chain.cw],
                         [(chain.w_in[l], chain.b_in[l])] + flc._at(chain.cpl_rest, l),
                         chain.st, chain.h)
        sc = sigmoid_scale(chain.st[:, :lat - split], 1e-8)
        y = torch.cat([x2[:, :split], x2[:, split:] * sc + chain.st[:, lat - split:]], 1)
        ref = y.to(bf).float() @ lu[0][l].float() + lu[1][l]
        assert _max(xf, ref) <= 2e-2 * max(1.0, float(ref.abs().max()))
        assert _max(lf, torch.log(sc).sum(-1) + folded["lu_ldj_f"][l]) <= 1e-3
        assert torch.equal(fused.xin[:, :split], xf[:, :split].to(bf))
        fused.xin[:, :split] = x2[:, :split]


@pytest.mark.parametrize("preset", ["dulcet-universe", "helpful-sponge"])
def test_fused_chains_match_the_per_product_chains(emulated, preset):
    """B1 (with and without saves) and B7 over two full-width layers: the
    fused route (4 launches a layer with attention, 1 without) against the
    per-product plain chains (`fused_flow_layers_plain` and
    `fused_flow_layers_inverse_plain`, one PyTorch product at a time) on the
    same inputs: z within 5e-2 (a few bf16 ulps of the carry through two
    layers), ldj within 1e-2, the saves within 5e-2, the inverse within
    5e-2."""
    cfg, _, folded, folded_inv, (x, ldj, ctx, extra) = shipped(preset)
    z, l = flc._forward_chain(x, ldj, ctx, extra, folded, 1e-8, False)
    _, _, saves = flc._forward_chain(x, ldj, ctx, extra, folded, 1e-8, True)
    xi = flc._inverse_chain(0.6 * x, ctx, extra, folded_inv, 1e-8)
    assert emulated.fused.count("coupling_layer") == 4
    assert emulated.fused.count("coupling_inverse") == 2
    zr, lr, saves_r = flc.fused_flow_layers_plain(x, ldj, ctx, extra, folded, save=True)
    xr = flc.fused_flow_layers_inverse_plain(0.6 * x, ctx, extra, folded_inv)
    assert _max(z, zr) <= 5e-2 and _max(l, lr) <= 1e-2
    assert _max(saves, saves_r) <= 5e-2 and _max(saves[0], x.reshape(-1, x.shape[-1])) <= 2e-2
    assert _max(xi, xr) <= 5e-2


def test_save_rows_are_the_entry_carries(emulated):
    """save=True on the fused route: saves[l] is the bf16 entry carry of
    layer l, the same as the plain B1's saves, and z and ldj are those of
    the run without saves."""
    cfg, _, folded, _, (x, ldj, ctx, extra) = shipped("swept-energy", layers=3)
    z, l, saves = flc._forward_chain(x, ldj, ctx, extra, folded, 1e-8, True)
    zn, ln = flc._forward_chain(x, ldj, ctx, extra, folded, 1e-8, False)
    zr, lr, saves_r = flc.fused_flow_layers_plain(x, ldj, ctx, extra, folded, save=True)
    assert torch.equal(z, zn) and torch.equal(l, ln)
    assert saves.shape == saves_r.shape == (3, x.shape[1], cfg["latent_dim"])
    assert torch.equal(saves[0], x.reshape(-1, cfg["latent_dim"]).bfloat16())
    assert _max(saves, saves_r) <= 5e-2 and _max(z, zr) <= 5e-2


# ------------------------------------------------- against the JAX package

def _tiny():
    cfg, jm, jparams, _, pm = model_pair("bfloat16")
    lat = cfg["latent_dim"]
    prep = jm._prepare_layers(jparams["layers"])
    stacks = flp.append_final_block(flp.build_layer_stacks(jm, prep),
                                    jparams["final_block"], lat)
    jf = flp.fold_stacks(stacks, split=lat // 2, extra_dim=1)
    jfi = flp.fold_stacks_inverse(stacks, jf)
    return cfg, jf, jfi, pm._folded(pm.params(), 1), pm._folded_inverse(pm.params(), 1)


def test_fused_forward_matches_pallas_interpret_one_layer(emulated):
    """One tiny layer on the fused route (conditioner and coupling_layer
    plain versions) against the Pallas fused_flow_layers_t in interpret
    mode: the bound of test_torch_port_flow's one-layer test (bf16 operands
    on both sides, max-subtract vs clamp softmax, erf vs polynomial GELU)."""
    cfg, jf, _, tf, _ = _tiny()
    rng = np.random.default_rng(11)
    x, ldj = normal(rng, 2, N_POINTS, cfg["latent_dim"]), normal(rng, 2, N_POINTS)
    ctx = normal(rng, 2, N_CONTEXT, cfg["input_embedding_dim"])
    extra = normal(rng, 2, N_POINTS, 1)
    zr, lr = flp.fused_flow_layers_t(jnp.asarray(x), jnp.asarray(ldj), jnp.asarray(ctx),
                                     jnp.asarray(extra), flc.layer_slice(jf, 0), interpret=True)
    z, l = flc._forward_chain(t(x), t(ldj), t(ctx), t(extra), flc.layer_slice(tf, 0), 1e-8,
                              False)
    assert sorted(set(emulated.fused)) == ["conditioner", "coupling_layer"]
    assert float(np.abs(n(z) - n(zr)).max()) < 3e-2
    assert float(np.abs(n(l) - n(lr)).max()) < 2e-3


def test_fused_inverse_matches_pallas_interpret_one_layer(emulated):
    """One tiny layer of B7 on the fused route against the Pallas
    fused_flow_layers_inverse in interpret mode: B1's one-layer bound."""
    cfg, _, jfi, _, tfi = _tiny()
    rng = np.random.default_rng(12)
    z = 0.6 * normal(rng, 2, N_POINTS, cfg["latent_dim"])
    ctx = normal(rng, 2, N_CONTEXT, cfg["input_embedding_dim"])
    extra = normal(rng, 2, N_POINTS, 1)
    ref = flp.fused_flow_layers_inverse(jnp.asarray(z), jnp.asarray(ctx), jnp.asarray(extra),
                                        flc.layer_slice(jfi, 0), interpret=True)
    got = flc._inverse_chain(t(z), t(ctx), t(extra), flc.layer_slice(tfi, 0), 1e-8)
    assert sorted(set(emulated.fused)) == ["conditioner", "coupling_inverse"]
    assert float(np.abs(n(got) - n(ref)).max()) < 3e-2


def test_fused_chains_match_the_plain_versions_on_three_tiny_layers(emulated):
    """All three tiny layers (the chained LU inverse inside coupling_inverse
    twice): the fused route against the plain B1 and B7 (the spec held
    against JAX's bf16 scans by test_torch_port_flow and _sample)."""
    cfg, _, _, tf, tfi = _tiny()
    rng = np.random.default_rng(13)
    x, ldj = t(normal(rng, 2, N_POINTS, cfg["latent_dim"])), t(normal(rng, 2, N_POINTS))
    ctx = t(normal(rng, 2, N_CONTEXT, cfg["input_embedding_dim"]))
    extra = t(normal(rng, 2, N_POINTS, 1))
    z, l = flc._forward_chain(x, ldj, ctx, extra, tf, 1e-8, False)
    zr, lr = flc.fused_flow_layers_plain(x, ldj, ctx, extra, tf)
    assert _max(z, zr) <= 5e-2 and _max(l, lr) <= 1e-2
    xi = flc._inverse_chain(0.6 * x, ctx, extra, tfi, 1e-8)
    assert _max(xi, flc.fused_flow_layers_inverse_plain(0.6 * x, ctx, extra, tfi)) <= 5e-2
    assert emulated.fused.count("coupling_inverse") == 3
