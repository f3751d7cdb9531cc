"""The fused layer kernels past 512 columns (`w1024`), on the CPU.

csrc/fused_layer.cu and fused_layer_bwd.cu take products up to 1,024
columns wide: a product wider than one pass (512 output columns) runs in
passes, its 64-row tile's input in shared memory and its activations in
device scratch (the wide kernels). Their plain versions (`conditioner_plain`,
`coupling_layer_plain`, `coupling_inverse_plain`, `augment_net_plain`,
`dgcnn_tail_plain`, B5's `conditioner_record_plain` ... `conditioner_bwd_plain`)
take any width at the kernels' rounding points. Held here, at tiny sizes (one
or two layers, 64 points, the MLPs 1,024 wide and every other width narrow):
the gates at their edges (1,024 takes the kernels, 1,040 reads plain naming
the limit); the accumulator-order records of a wide product, pass by pass
(`_build.fragment_index`); the plain versions on the fused route against
the JAX package's Pallas kernels in interpret mode on one layer (B1, B7 and
B5's `flow_layers_bwd`); the launch plumbing of B1, B2, B4, B5 and B7 at
1,024 with every `_build` launch emulated in PyTorch; `load_jax_params`
carrying the wide weights; and a tiny `w1024` model's `inner_loop` against
the JAX package's. tests/test_torch_port_cuda.py holds the wide kernels
against these plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flowcompare_tpu_torch as ft
from flowcompare_tpu.configs import derive as jax_derive
from flowcompare_tpu.model import inner_loop as jax_inner_loop
from flowcompare_tpu.ops import flow_layer_pallas as flp
from flowcompare_tpu_torch import routes
from flowcompare_tpu_torch.ops import _build, dgcnn_cuda, flow_layer_cuda as flc
from flowcompare_tpu_torch.ops import flow_layer_vjp_cuda as fvc
from test_torch_port_b4_b2 import _augmenter_inputs, _context, _count, launches  # noqa: F401
from test_torch_port_b5_fused import _case, _rel
from test_torch_port_gemm_layout import EmulatedLaunches
from torch_port_fixtures import N_CONTEXT, N_POINTS, n, normal, port_init_pair, t, tiny_config
from torch_port_widths import W1024

torch.set_num_threads(2)

BF = torch.bfloat16


@pytest.fixture
def emulated(monkeypatch):
    """Every `_build` launch of B1, B5 and B7 as its plain version, counted
    (`EmulatedLaunches`)."""
    emu = EmulatedLaunches()
    for name in ("gemm", "gemm_tn", "cast_rows", "row_norm", "cross_attention", "colsum",
                 "colsum_workspace", "coupling_epilogue_bwd", "attn_bwd_prep", "attention_bwd",
                 "row_norm_bwd", "coupling_epilogue", "inverse_coupling_epilogue",
                 "augment_epilogue", "conditioner", "coupling_layer", "coupling_inverse",
                 *EmulatedLaunches.FUSED):
        monkeypatch.setattr(_build, name, getattr(emu, name))
    return emu


def w1024_config(compute_dtype: str = "bfloat16", layers: int = 2) -> dict:
    cfg = tiny_config(compute_dtype)
    cfg.update(n_flow_layers=layers, **W1024)
    return jax_derive(cfg)


_PAIRS = {}


def w1024_pair(layers: int = 2):
    """The tiny w1024 config (two layers: one stacked and the final block)
    and its models on shared weights, built once a module:
    `port_init_pair` (the port's seeded init as the JAX pytrees, perturbed,
    carried back into the port by `load_jax_params`)."""
    if layers not in _PAIRS:
        _PAIRS[layers] = port_init_pair(w1024_config(layers=layers))
    return _PAIRS[layers]


# ------------------------------------------------------------- the gates

def test_gates_take_1024_and_refuse_past_it():
    """fused_route, augment_net_plan and dgcnn_tail_plan take products up to
    1,024 wide and refuse 1,040; the LayerNorm's row, [s | t] and the latent
    take one pass (512); a stack past 512 is wide (`FusedStack.wide`), and
    the routes of dulcet-universe at 1,024 read "kernels", at 1,040 "plain"
    naming the limits."""
    assert (_build.FUSED_MAXW, _build.FUSED_PASS_W) == (1024, 512)
    pre, q, tail = [(150, 256)] + [(256, 256)] * 3, (256, 64), (300, 300)
    for w, ok in ((512, True), (1024, True), (1040, False)):
        cpl = [(216, w), (w, w), (w, w), (w, 300)]
        assert flc.fused_route(pre, q, cpl, tail, 150, 300)["coupling"] is ok
        wide_pre = [(6, w), (w, w), (w, w), (w, 256)]
        assert flc.fused_route(wide_pre, q, [], (0, 0), 6, 0)["conditioner"] is ok
        net = [(72, w), (w, w), (w, w), (w, 588)]
        head = [(512, w)] + [(w, w)] * 5 + [(w, 64)]
        if ok:
            assert flc.augment_net_plan(net, 72, 294)["products"] == 5
            assert dgcnn_cuda.dgcnn_tail_plan((512, 512), head)["products"] == 8
        else:
            with pytest.raises(ValueError, match="cannot take"):
                flc.augment_net_plan(net, 72, 294)
            with pytest.raises(ValueError, match="cannot take"):
                dgcnn_cuda.dgcnn_tail_plan((512, 512), head)
    # the LayerNorm's row past one pass
    assert not flc.fused_route(pre[:-1] + [(256, 600)], (600, 64), [], (0, 0), 150,
                               0)["conditioner"]
    assert not _build.wide_shapes([(216, 512), (512, 300)])
    assert _build.wide_shapes([(216, 513)]) and _build.wide_shapes([(1024, 8)])
    cfg = ft.get_config("dulcet-universe")
    assert routes.model_routes({**cfg, **W1024}) == {p: "kernels" for p in
                                                     ("stack", "augmenter", "encoder")}
    got = routes.model_routes({**cfg, "hidden_dims": [1040] * 3})
    assert got["stack"] == ("plain: the coupling's products [(216, 1040), (1040, 1040), "
                            "(1040, 1040), (1040, 300), (300, 300)] (the fused layer kernels "
                            "take widths <= 1024, the LayerNorm's row and the latent <= 512, "
                            "3-10 products)")


def test_wide_stacks_and_their_scratch_size():
    """FusedStack and BwdStack flag a stack past 512 columns as wide (the
    wide kernels, device scratch), take 1,024 and refuse 1,040 (BwdStack's
    own check); the plain versions need no scratch."""
    def pair(k, nn):
        return flc._pad_cols(torch.zeros(1, k, nn, dtype=BF)), torch.zeros(1, nn)

    assert not _build.FusedStack([pair(64, 512), pair(512, 300)], 1).wide
    assert _build.FusedStack([pair(64, 1024), pair(1024, 300)], 1).wide
    w = [flc._pad_cols(torch.zeros(1, k, nn, dtype=BF)) for k, nn in
         ((300, 300), (300, 1024), (1024, 216))]
    none = [None, None, None]
    stack = _build.BwdStack(w, none, none, none, none, none)
    assert stack.wide
    with pytest.raises(ValueError, match="not in the layout"):
        _build.BwdStack(w[:1] + [flc._pad_cols(torch.zeros(1, 300, 1040, dtype=BF))] + w[2:],
                        none, none, none, none, none)
    assert _build.fused_scratch(100, False, "cpu") is None


@pytest.mark.parametrize("rows,cols", [(64, 1024), (100, 600), (130, 1000)])
def test_fragment_index_of_wide_products(rows, cols):
    """A product past 512 columns lays its records out pass by pass: pass j
    (chunks 8 j .. 8 j + 7 of 64 columns) at float4 16 j + k of consumer
    thread t, its warpgroups owning ceil(chunks / 4) chunks each; the map is
    a bijection onto the buffer under `fragment_rows`, whose tile block is
    frag_cpw x 64 KB."""
    view = _build.fragment_rows(rows, cols, "cpu")
    index = _build.fragment_index(rows, cols, "cpu")
    flat = torch.as_strided(view, (view.untyped_storage().nbytes() // 4,), (1,), 0)
    nch = -(-cols // 64)
    cpw_all = 2 * (nch // 8) + -(-(nch % 8) // 4)
    assert _build.frag_cpw(cols) == cpw_all and view.untyped_storage().nbytes() == (
        -(-rows // 64) * 64 * 256 * cpw_all * 4)
    assert index.unique().numel() == rows * cols and int(index.max()) < flat.numel()
    # thread 131 (warpgroup 1, lane 3 of warp 0), pass 1, its chunk 0, q = 3
    last = nch - 8
    cpw1 = -(-last // 4)
    t_, k, q = 131, 0, 3
    tt = t_ % 128
    row = (tt // 32) * 16 + (tt % 32) // 4 + 8
    col = (8 + cpw1 * (t_ // 128) + k // 8) * 64 + 8 * (k % 8) + 2 * (tt % 4) + 1
    if col < cols:
        assert int(index[row, col]) == ((0 * 8 * cpw_all + 16 + k) * 512 + t_) * 4 + q
    flat.copy_(torch.arange(flat.numel(), dtype=torch.float32))
    assert torch.equal(_build.fragment_to_rows(view).long(), index)


# --------------------------------------------- against the JAX package

def _tiny_folds():
    cfg, jm, jparams, _, pm = w1024_pair()
    lat = cfg["latent_dim"]
    prep = jm._prepare_layers(jparams["layers"])
    stacks = flp.append_final_block(flp.build_layer_stacks(jm, prep), jparams["final_block"],
                                    lat)
    jf = flp.fold_stacks(stacks, split=lat // 2, extra_dim=1)
    jfi = flp.fold_stacks_inverse(stacks, jf)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # a batched CPU inverse can stall on 2 threads
    try:
        return cfg, jf, jfi, pm._folded(pm.params(), 1), pm._folded_inverse(pm.params(), 1)
    finally:
        torch.set_num_threads(threads)


def test_wide_forward_matches_pallas_interpret_one_layer(emulated):
    """One tiny layer with a 1,024-wide coupling MLP on the fused route (the
    conditioner and coupling_layer plain versions, the coupling stack wide)
    against the Pallas fused_flow_layers_t in interpret mode: z within 3e-2
    and ldj within 2e-3, the bound of the 64-wide test (bf16 operands on
    both sides, max-subtract vs clamp softmax, erf vs polynomial GELU)."""
    cfg, jf, _, tf, _ = _tiny_folds()
    rng = np.random.default_rng(21)
    x, ldj = normal(rng, 1, N_POINTS, cfg["latent_dim"]), normal(rng, 1, N_POINTS)
    ctx = normal(rng, 1, N_CONTEXT, cfg["input_embedding_dim"])
    extra = normal(rng, 1, N_POINTS, 1)
    layer = flc.layer_slice(tf, 0)
    assert max(w.shape[-1] for w, _ in layer["cpl_rest"]) == 1024
    zr, lr = flp.fused_flow_layers_t(jnp.asarray(x), jnp.asarray(ldj), jnp.asarray(ctx),
                                     jnp.asarray(extra), flc.layer_slice(jf, 0), interpret=True)
    z, l = flc._forward_chain(t(x), t(ldj), t(ctx), t(extra), layer, 1e-8, False)
    assert sorted(emulated.fused) == ["conditioner", "coupling_layer"]
    assert float(np.abs(n(z) - n(zr)).max()) < 3e-2
    assert float(np.abs(n(l) - n(lr)).max()) < 2e-3


def test_wide_inverse_matches_pallas_interpret_one_layer(emulated):
    """One tiny layer of B7 at 1,024 on the fused route against the Pallas
    fused_flow_layers_inverse in interpret mode: B1's one-layer bound."""
    cfg, _, jfi, _, tfi = _tiny_folds()
    rng = np.random.default_rng(22)
    z = 0.6 * normal(rng, 1, N_POINTS, cfg["latent_dim"])
    ctx = normal(rng, 1, N_CONTEXT, cfg["input_embedding_dim"])
    extra = normal(rng, 1, N_POINTS, 1)
    ref = flp.fused_flow_layers_inverse(jnp.asarray(z), jnp.asarray(ctx), jnp.asarray(extra),
                                        flc.layer_slice(jfi, 0), interpret=True)
    got = flc._inverse_chain(t(z), t(ctx), t(extra), flc.layer_slice(tfi, 0), 1e-8)
    assert sorted(emulated.fused) == ["conditioner", "coupling_inverse"]
    assert float(np.abs(n(got) - n(ref)).max()) < 3e-2


def test_wide_b5_matches_per_product_and_pallas_interpret(emulated):
    """B5's fused chain (its kernels' plain versions) with a 1,024-wide
    coupling MLP on the single-grid-step configuration of the B5 file (B =
    1, N = 16) at two layers, against the per-product chain it replaced (1e-4 of
    max |ref|: the same rounding points) and the JAX package's
    flow_layers_bwd in interpret mode (0.03 of max |ref| for dx, dctx and
    dextra, 0.05 for the folded gradients: the JAX package's kernel-vs-vjp
    bands); one launch of each fused kind a layer."""
    ins, ref = _case(True, True, hidden_dims=[1024] * 3, n_flow_layers=2)
    assert max(w.shape[-1] for w, _ in ins[5]["cpl_rest"]) == 1024
    chain = fvc._bwd_per_product(*ins, 1e-8)
    emulated.fused.clear()
    got = fvc._bwd_fused(*ins, 1e-8)
    assert sorted(set(emulated.fused)) == sorted(["coupling_record", "coupling_bwd",
                                                  "conditioner_record", "conditioner_bwd",
                                                  "gemm_tn_grouped", "grad_reduce"])
    assert all(emulated.fused.count(k) == ins[0].shape[0] for k in set(emulated.fused))
    for a, c, r in zip(got[:3], chain[:3], ref[:3]):
        assert _rel(n(a), n(c)) < 1e-4 and _rel(n(a), r) < 0.03
    for k, r in ref[3].items():
        assert _rel(n(got[3][k]), n(chain[3][k])) < 1e-4, k
        assert _rel(n(got[3][k]).reshape(np.shape(r)), r) < 0.05, k


# --------------------------------------------------- the launch plumbing

def test_wide_chains_launch_as_the_narrow_ones(emulated):
    """B1 (with saves) and B7 over two tiny w1024 layers through the fused
    route with every launch emulated: one conditioner, one ctx @ wkv and one
    cross attention with one coupling_layer / coupling_inverse a layer (4
    launches), every gemm on the TMA route, no per-product MLP gemm; against
    the plain B1 and B7 (z within 5e-2, ldj within 1e-2, the inverse within
    5e-2)."""
    cfg, _, _, _, pm = w1024_pair()
    rng = np.random.default_rng(23)
    lat = cfg["latent_dim"]
    x, ldj = t(normal(rng, 1, N_POINTS, lat)), torch.zeros(1, N_POINTS)
    ctx = t(normal(rng, 1, N_CONTEXT, cfg["input_embedding_dim"]))
    extra = t(normal(rng, 1, N_POINTS, 1))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        folded, folded_inv = pm._folded(pm.params(), 1), pm._folded_inverse(pm.params(), 1)
    finally:
        torch.set_num_threads(threads)
    layers = folded["lu_ldj_f"].shape[0]
    z, l, saves = flc._forward_chain(x, ldj, ctx, extra, folded, 1e-8, True)
    xi = flc._inverse_chain(0.6 * x, ctx, extra, folded_inv, 1e-8)
    counts = {k: emulated.fused.count(k) for k in ("conditioner", "coupling_layer",
                                                   "coupling_inverse")}
    assert counts == {"conditioner": 2 * layers, "coupling_layer": layers,
                      "coupling_inverse": layers}
    # ctx @ wkv a layer in each direction and B7's top LU inverse: no MLP gemm
    assert emulated.routes == ["wgmma"] * (2 * layers + 1)
    zr, lr, sr = flc.fused_flow_layers_plain(x, ldj, ctx, extra, folded, save=True)
    xr = flc.fused_flow_layers_inverse_plain(0.6 * x, ctx, extra, folded_inv)
    assert float((z - zr).abs().max()) <= 5e-2 and float((l - lr).abs().max()) <= 1e-2
    assert float((saves.float() - sr.float()).abs().max()) <= 5e-2
    assert float((xi - xr).abs().max()) <= 5e-2


def test_wide_b4_b2_chains_launch_as_the_narrow_ones(launches):  # noqa: F811
    """B4 (its head 1,024 wide: the wide tail kernel) and B2 (its
    conditioner's pre-MLP and its net 1,024 wide) on the tiny w1024 with
    every launch emulated: 10 and 5 launches a call, their gemms on the TMA
    route, B4 bit-equal to its plain version and B2 within the B4/B2 file's
    bounds (2e-3 for z, 1e-5 relative for ldj)."""
    cfg, _, _, _, pm = w1024_pair()
    params, state = pm.params()["embedder"], pm.state.tree()["embedder"]
    x = t(normal(np.random.default_rng(24), 2, N_CONTEXT, 6))
    w = dgcnn_cuda.encoder_weights(params, state, cast=BF)
    assert w.tail(True).wide
    before = _count()
    with torch.no_grad():
        got = dgcnn_cuda._encoder_chain(x, w, cfg["n_neighbors"], True)
        ref = dgcnn_cuda.fused_dgcnn_encoder_plain(x, params, state, k=cfg["n_neighbors"],
                                                   head=True, cast=BF)
    assert _count() - before == 10 and torch.equal(got, ref)
    ed, xa, eps, ctx, extra = _augmenter_inputs(cfg, pm, 25)
    aw = flc.augmenter_weights(pm.params()["augmenter"], input_dim=6, extra_dim=ed)
    assert aw.cond_stack.wide and aw.net_stack.wide
    before = _count()
    with torch.no_grad():
        z, ldj = flc._augmenter_chain(t(xa), t(eps), _context(cfg, ctx), t(extra), aw)
        zr, lr = flc.fused_augmenter_plain(t(xa), t(eps), _context(cfg, ctx), t(extra), aw)
    assert _count() - before == 5
    assert set(launches.routes) == {"wgmma"}
    assert float((z - zr).abs().max()) <= 2e-3
    assert float(((ldj - lr).abs() / lr.abs().clamp_min(1.0)).max()) <= 1e-5


# --------------------------------------------------- the model, end to end

def test_load_jax_params_carries_the_wide_weights():
    """The JAX package's 1,024-wide leaves arrive in the port unchanged: the
    coupling MLP's, the augmenter's conditioner and net, the embedder's
    head."""
    _, _, jparams, _, pm = w1024_pair()
    port = pm.params()
    pairs = [
        (jparams["layers"]["block"]["coupling"]["nn"]["hidden"][0]["w"],
         port["layers"]["block"]["coupling"]["nn"]["hidden"][0]["w"]),
        (jparams["augmenter"]["pre_attn_mlp"]["hidden"][1]["w"],
         port["augmenter"]["pre_attn_mlp"]["hidden"][1]["w"]),
        (jparams["augmenter"]["augment"]["net"]["in"]["w"],
         port["augmenter"]["augment"]["net"]["in"]["w"]),
        (jparams["embedder"]["out_mlp"]["hidden"][4]["w"],
         port["embedder"]["out_mlp"]["hidden"][4]["w"]),
    ]
    for j, p in pairs:
        assert 1024 in p.shape
        assert np.array_equal(np.asarray(j, dtype=np.float32), p.detach().float().numpy())


def test_w1024_tiny_model_inner_loop_matches_jax():
    """The tiny w1024 (two layers, bf16, every part "kernels": the kernels'
    plain versions on the CPU) through `inner_loop` against the JAX
    package's on the same weights and noise, within the C1 test's bf16
    tolerance (log-probs rtol 2e-2, atol 1.0; |d nats| < 1e-2)."""
    cfg, jm, jparams, jstate, pm = w1024_pair()
    assert dict(pm.routes) == {p: "kernels" for p in ("stack", "augmenter", "encoder")}
    rng = np.random.default_rng(26)
    batch = (normal(rng, 2, cfg["n_samples_context"], 6), normal(rng, 2, N_POINTS, 6),
             normal(rng, 2, 1))
    key = jax.random.PRNGKey(27)
    _, lpr, natsr, _ = jax_inner_loop(jm, jparams, jstate, batch, rng=key)
    eps = jax.random.normal(key, (2, N_POINTS, cfg["latent_dim"] - cfg["input_dim"]))
    with torch.no_grad():
        _, lp, nats, _ = ft.inner_loop(pm, tuple(map(t, batch)), eps=t(eps))
    assert torch.isfinite(lp).all()
    np.testing.assert_allclose(n(lp), n(lpr), rtol=2e-2, atol=1.0)
    assert abs(float(nats) - float(natsr)) < 1e-2
