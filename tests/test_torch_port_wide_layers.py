"""The fused layer kernels past 512 columns (`w1024`, `w2048`), on the CPU.

csrc/fused_layer.cu and fused_layer_bwd.cu take products up to 2,048
columns wide: a product wider than one pass (512 output columns) runs in
passes, its 64-row tile's input in shared memory (a K past 1,024 in two
halves) and its activations in device scratch (the wide kernels), and the
row-wise epilogues (the LayerNorm's row, [s | t] and the latent) take up to
1,024 columns over two passes. Their plain versions (`conditioner_plain`,
`coupling_layer_plain`, `coupling_inverse_plain`, `augment_net_plain`,
`dgcnn_tail_plain`, B5's `conditioner_record_plain` ... `conditioner_bwd_plain`)
take any width at the kernels' rounding points. Held here, at tiny sizes (one
or two layers, 64 points, the MLPs 1,024 or 2,048 wide, w2048's latent and
LayerNorm row 1,024, every other width narrow): the gates at their edges
(2,048 takes the kernels, 2,049 reads plain naming the limit; a row-wise
width of 1,024 takes them, 1,025 and 1,026 read plain; B2 at 1,018
augmented dims); the accumulator-order records of a wide product, pass by
pass (`_build.fragment_index`); the plain versions on the fused route
against the JAX package's Pallas kernels in interpret mode on one layer
(B1, B7 and B5's `flow_layers_bwd`); the launch plumbing of B1, B2, B4, B5
and B7 at both widths with every `_build` launch emulated in PyTorch;
`load_jax_params` carrying the wide weights; and a tiny `w1024` and
`w2048` model's `inner_loop` against the JAX package's.
tests/test_torch_port_cuda.py holds the wide kernels against these plain
versions on the card.
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
from torch_port_widths import WIDE_CONFIGS

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


# the widths the wide kernels are held at: the MLPs' and (w2048) the latent's
WIDE = ["w1024", "w2048"]
MLP_WIDTH = {"w1024": 1024, "w2048": 2048}


def sum_scale(cfg: dict) -> float:
    """How much larger the bounds of a sum over the latent (ldj, nats) are
    than at the tiny latent of 32 (w1024's): its terms' rounding differences
    add in quadrature, sqrt(latent / 32), 1 at w1024 and 5.7 at w2048's
    1,024."""
    return max(1.0, (cfg["latent_dim"] / 32) ** 0.5)


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at magnitude v (a flip of a bf16 rounding of y moves the
    carry by up to that much)."""
    return float(2.0 ** (np.floor(np.log2(max(v, 2.0 ** -126))) - 7))


def wide_config(name: str, compute_dtype: str = "bfloat16", layers: int = 2) -> dict:
    cfg = tiny_config(compute_dtype)
    cfg.update(n_flow_layers=layers, **WIDE_CONFIGS[name])
    return jax_derive(cfg)


_PAIRS = {}


def lu_noise(cfg: dict) -> float:
    """How far B7's JAX comparison moves the LinearLU off identity: 0.1 at
    the tiny latent of 32, less at a wider one, so that the LU's inverse
    grows as at 32. Its entries grow about as exp(lat x noise^2 / 6) with
    the latent, so w2048's 1,024-wide one at 0.1 mixes 0.6-wide rows into
    rows 9.2 wide (w1024: 0.62); the coupling's s then reach -10 and x2 =
    (y2 - t) / scale 3.3e4, where a bf16 flip of t moves x2 by hundreds."""
    return 0.1 * min(1.0, (32 / cfg["latent_dim"]) ** 0.5)


def wide_pair(name: str, layers: int = 2, noise: float = 0.1):
    """The tiny config of `name` (two layers: one stacked and the final
    block) and its models on shared weights, built once a module:
    `port_init_pair` (the port's seeded init as the JAX pytrees, perturbed,
    the LinearLU's entries by up to `noise`, carried back into the port by
    `load_jax_params`)."""
    if (name, layers, noise) not in _PAIRS:
        _PAIRS[name, layers, noise] = port_init_pair(wide_config(name, layers=layers),
                                                     lu_noise=noise)
    return _PAIRS[name, layers, noise]


# ------------------------------------------------------------- the gates

def test_gates_take_1024_and_refuse_past_it():
    """fused_route, augment_net_plan and dgcnn_tail_plan take products up to
    2,048 wide and refuse 2,049 and 2,056; the LayerNorm's row, [s | t] and
    the latent take up to 1,024 (two passes) and refuse 1,025 and 1,026; B2's
    output layer at 1,018 augmented dims runs as four passes; a stack past
    512 is wide (`FusedStack.wide`), and the routes of dulcet-universe at
    1,024 and w2048 read "kernels", at 2,049 "plain" naming the limits."""
    assert (_build.FUSED_MAXW, _build.FUSED_PASS_W, _build.FUSED_ROW_W,
            _build.FUSED_IN_W) == (2048, 512, 1024, 1024)
    pre, q, tail = [(150, 256)] + [(256, 256)] * 3, (256, 64), (300, 300)
    for w, ok in ((512, True), (1024, True), (2048, True), (2049, False), (2056, False)):
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
    # the row-wise epilogues: the LayerNorm's row, and [s | t] with the latent
    for row, ok in ((512, True), (600, True), (1024, True), (1025, False), (1026, False)):
        assert flc.fused_route(pre[:-1] + [(256, row)], (row, 64), [], (0, 0), 150,
                               0)["conditioner"] is ok
        split = row // 2
        cpl = [(split + 72, 2048), (2048, 2048), (2048, 2 * (row - split))]
        assert flc.fused_route(pre, q, cpl, (row, row), split, row)["coupling"] is ok
    # the packed input of a launch's first product: S holds 1,024 columns
    assert flc.fused_route(pre, q, [(1024, 512), (512, 600)], (600, 600), 300,
                           600)["coupling"]
    assert not flc.fused_route(pre, q, [(1032, 512), (512, 600)], (600, 600), 300,
                               600)["coupling"]
    # B2 at w2048's 1,018 augmented dims: four passes of 255, 255, 255 and 253
    # pairs, 3 + 4 products
    plan = flc.augment_net_plan([(72, 2048), (2048, 2048), (2048, 2048), (2048, 2036)], 72, 1018)
    assert plan == {"products": 7, "passes": [(0, 255), (255, 255), (510, 255), (765, 253)]}
    assert not _build.wide_shapes([(216, 512), (512, 300)])
    assert _build.wide_shapes([(216, 513)]) and _build.wide_shapes([(2048, 8)])
    cfg = ft.get_config("dulcet-universe")
    for wide in WIDE_CONFIGS.values():
        assert routes.model_routes({**cfg, **wide}) == {p: "kernels" for p in
                                                        ("stack", "augmenter", "encoder")}
    got = routes.model_routes({**cfg, "hidden_dims": [2049] * 3})
    assert got["stack"] == ("plain: the coupling's products [(216, 2049), (2049, 2049), "
                            "(2049, 2049), (2049, 300), (300, 300)] (the fused layer kernels "
                            "take widths <= 2048, the LayerNorm's row, the latent and the "
                            "packed input <= 1024, 3-10 products)")


def test_wide_stacks_and_their_scratch_size():
    """FusedStack and BwdStack flag a stack past 512 columns as wide (the
    wide kernels, device scratch), take 2,048 and refuse 2,056 (BwdStack's
    own check); the plain versions need no scratch."""
    def pair(k, nn):
        return flc._pad_cols(torch.zeros(1, k, nn, dtype=BF)), torch.zeros(1, nn)

    assert not _build.FusedStack([pair(64, 512), pair(512, 300)], 1).wide
    assert _build.FusedStack([pair(64, 1024), pair(1024, 300)], 1).wide
    assert _build.FusedStack([pair(64, 2048), pair(2048, 1024)], 1).wide
    w = [flc._pad_cols(torch.zeros(1, k, nn, dtype=BF)) for k, nn in
         ((1024, 1024), (1024, 2048), (2048, 584))]
    none = [None, None, None]
    stack = _build.BwdStack(w, none, none, none, none, none)
    assert stack.wide
    with pytest.raises(ValueError, match="not in the layout"):
        _build.BwdStack(w[:1] + [flc._pad_cols(torch.zeros(1, 1024, 2056, dtype=BF))] + w[2:],
                        none, none, none, none, none)
    assert _build.fused_scratch(100, False, "cpu") is None


@pytest.mark.parametrize("rows,cols", [(64, 1024), (100, 600), (130, 1000), (64, 2048),
                                       (130, 2000), (100, 1030)])
def test_fragment_index_of_wide_products(rows, cols):
    """A product past 512 columns (up to 2,048: four passes; a 1,024-wide
    LayerNorm row two) lays its records out pass by pass: pass j
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
    last = min(8, nch - 8)
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

def _tiny_folds(name: str, noise: float = 0.1):
    cfg, jm, jparams, _, pm = wide_pair(name, noise=noise)
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


@pytest.mark.parametrize("name", WIDE)
def test_wide_forward_matches_pallas_interpret_one_layer(emulated, name):
    """One tiny layer with a 1,024- or 2,048-wide coupling MLP (w2048: the
    latent and the LayerNorm's row 1,024) on the fused route (the
    conditioner and coupling_layer plain versions, the coupling stack wide)
    against the Pallas fused_flow_layers_t in interpret mode: z within 3e-2
    and ldj within 2e-3, the bound of the 64-wide test (bf16 operands on
    both sides, max-subtract vs clamp softmax, erf vs polynomial GELU),
    times `sum_scale` at w2048's 1,024-wide latent (ldj sums 512
    log-scales: 6.0e-3 measured against 1.1e-2)."""
    cfg, jf, _, tf, _ = _tiny_folds(name)
    rng = np.random.default_rng(21)
    x, ldj = normal(rng, 1, N_POINTS, cfg["latent_dim"]), normal(rng, 1, N_POINTS)
    ctx = normal(rng, 1, N_CONTEXT, cfg["input_embedding_dim"])
    extra = normal(rng, 1, N_POINTS, 1)
    layer = flc.layer_slice(tf, 0)
    assert max(w.shape[-1] for w, _ in layer["cpl_rest"]) == MLP_WIDTH[name]
    zr, lr = flp.fused_flow_layers_t(jnp.asarray(x), jnp.asarray(ldj), jnp.asarray(ctx),
                                     jnp.asarray(extra), flc.layer_slice(jf, 0), interpret=True)
    z, l = flc._forward_chain(t(x), t(ldj), t(ctx), t(extra), layer, 1e-8, False)
    assert sorted(emulated.fused) == ["conditioner", "coupling_layer"]
    assert float(np.abs(n(z) - n(zr)).max()) < 3e-2
    assert float(np.abs(n(l) - n(lr)).max()) < 2e-3 * sum_scale(cfg)


@pytest.mark.parametrize("name", WIDE)
def test_wide_inverse_matches_pallas_interpret_one_layer(emulated, name):
    """One tiny layer of B7 at 1,024 and at w2048's widths on the fused
    route against the Pallas fused_flow_layers_inverse in interpret mode:
    B1's one-layer bound, 3e-2, at both widths, on weights whose LinearLU is
    moved off identity by `lu_noise` (0.1 at w1024, 0.018 at w2048)."""
    cfg, _, jfi, _, tfi = _tiny_folds(name, lu_noise(wide_config(name)))
    rng = np.random.default_rng(22)
    z = 0.6 * normal(rng, 1, N_POINTS, cfg["latent_dim"])
    ctx = normal(rng, 1, N_CONTEXT, cfg["input_embedding_dim"])
    extra = normal(rng, 1, N_POINTS, 1)
    ref = flp.fused_flow_layers_inverse(jnp.asarray(z), jnp.asarray(ctx), jnp.asarray(extra),
                                        flc.layer_slice(jfi, 0), interpret=True)
    got = flc._inverse_chain(t(z), t(ctx), t(extra), flc.layer_slice(tfi, 0), 1e-8)
    assert sorted(emulated.fused) == ["conditioner", "coupling_inverse"]
    assert float(np.abs(n(got) - n(ref)).max()) < 3e-2


@pytest.mark.parametrize("name", WIDE)
def test_wide_b5_matches_per_product_and_pallas_interpret(emulated, name):
    """B5's fused chain (its kernels' plain versions) with a 1,024- or
    2,048-wide coupling MLP (w2048: the latent and the LayerNorm's row
    1,024) on the single-grid-step configuration of the B5 file (B = 1, N =
    16) at two layers, against the per-product chain it replaced (1e-4 of
    max |ref|: the same rounding points) and the JAX package's
    flow_layers_bwd in interpret mode (0.03 of max |ref| for dx, dctx and
    dextra, 0.05 for the folded gradients: the JAX package's kernel-vs-vjp
    bands); one launch of each fused kind a layer."""
    width = MLP_WIDTH[name]
    rows = {k: v for k, v in WIDE_CONFIGS[name].items()
            if k in ("latent_dim", "cif_latent_dim", "attn_input_dim")}
    ins, ref = _case(True, True, hidden_dims=[width] * 3, n_flow_layers=2, **rows)
    assert max(w.shape[-1] for w, _ in ins[5]["cpl_rest"]) == width
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

@pytest.mark.parametrize("name", WIDE)
def test_wide_chains_launch_as_the_narrow_ones(emulated, name):
    """B1 (with saves) and B7 over two tiny w1024 / w2048 layers through the fused
    route with every launch emulated: one conditioner, one ctx @ wkv and one
    cross attention with one coupling_layer / coupling_inverse a layer (4
    launches), every gemm on the TMA route, no per-product MLP gemm; against
    the plain B1 and B7 (z within 5e-2 or one bf16 ulp of its scale, a flip
    of y's rounding: 0.0625 at w2048's |z| in [8, 16); ldj within 1e-2
    times `sum_scale`; the inverse within 5e-2 or an ulp of its scale)."""
    cfg, _, _, _, pm = wide_pair(name)
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
    z_tol = max(5e-2, bf16_ulp(float(zr.abs().max())))
    assert float((z - zr).abs().max()) <= z_tol
    assert float((l - lr).abs().max()) <= 1e-2 * sum_scale(cfg)
    assert float((saves.float() - sr.float()).abs().max()) <= z_tol
    assert float((xi - xr).abs().max()) <= max(5e-2, bf16_ulp(float(xr.abs().max())))


@pytest.mark.parametrize("name", WIDE)
def test_wide_b4_b2_chains_launch_as_the_narrow_ones(launches, name):  # noqa: F811
    """B4 (its head 1,024 or 2,048 wide: the wide tail kernel) and B2 (its
    conditioner's pre-MLP and its net as wide; w2048: its LayerNorm row
    1,024 and its output layer in four passes) on the tiny w1024 / w2048
    with every launch emulated: 10 and 5 launches a call, their gemms on the
    TMA route, B4 bit-equal to its plain version and B2 within the B4/B2
    file's bounds (2e-3 for z, 1e-5 relative for ldj)."""
    cfg, _, _, _, pm = wide_pair(name)
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
    assert aw.net_stack.n_out == max(2, -(-(cfg["latent_dim"] - 6) // 256))
    before = _count()
    with torch.no_grad():
        z, ldj = flc._augmenter_chain(t(xa), t(eps), _context(cfg, ctx), t(extra), aw)
        zr, lr = flc.fused_augmenter_plain(t(xa), t(eps), _context(cfg, ctx), t(extra), aw)
    assert _count() - before == 5
    assert set(launches.routes) == {"wgmma"}
    assert float((z - zr).abs().max()) <= 2e-3
    assert float(((ldj - lr).abs() / lr.abs().clamp_min(1.0)).max()) <= 1e-5


# --------------------------------------------------- the model, end to end

@pytest.mark.parametrize("name", WIDE)
def test_load_jax_params_carries_the_wide_weights(name):
    """The JAX package's 1,024- and 2,048-wide leaves arrive in the port
    unchanged: the coupling MLP's, the augmenter's conditioner and net, the
    embedder's head."""
    _, _, jparams, _, pm = wide_pair(name)
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
        assert MLP_WIDTH[name] in p.shape
        assert np.array_equal(np.asarray(j, dtype=np.float32), p.detach().float().numpy())


@pytest.mark.parametrize("name", WIDE)
def test_w1024_tiny_model_inner_loop_matches_jax(name):
    """The tiny w1024 and w2048 (two layers, bf16, every part "kernels": the
    kernels' plain versions on the CPU) through `inner_loop` against the JAX
    package's on the same weights and noise, within the C1 test's bf16
    tolerance (log-probs rtol 2e-2, atol 1.0; |d nats| < 1e-2, times
    `sum_scale` at w2048's 1,024-wide latent: 0.028 measured of 1,043
    nats)."""
    cfg, jm, jparams, jstate, pm = wide_pair(name)
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
    assert abs(float(nats) - float(natsr)) < 1e-2 * sum_scale(cfg)
