"""B4 (the eval DGCNN encoder) and B2 (the augmenter) as their CUDA chains
run them, on the CPU: the fold caches, the padded first EdgeConv stage,
the net's interleaved two-pass output layer, the plan functions, and the
plain versions of the new kernels (`dgcnn_cuda.dgcnn_tail_plain`,
`flow_layer_cuda.augment_net_plain`) against the Pallas kernels in
interpret mode.

The chains (`dgcnn_cuda._encoder_chain`, `flow_layer_cuda._augmenter_chain`)
run here on CPU tensors with the launches that have no CPU route (gemm,
knn_edge_max) replaced by their plain versions, each gemm asserting that
its operands take the TMA route; the wrappers of the new kernels
(`_build.pack_rows`, `dgcnn_tail`, `augment_net`) run their plain versions
on CPU tensors by themselves. tests/test_torch_port_cuda.py holds the CUDA
kernels against these plain versions on the card. Tolerances against JAX
are those of test_torch_port_encoder.py (B4) and test_torch_port_flow.py
(B2).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flowcompare_tpu_torch as ft
from flowcompare_tpu.configs import derive as jax_derive
from flowcompare_tpu.ops import dgcnn_pallas as jdp
from flowcompare_tpu.ops import flow_layer_pallas as flp
from flowcompare_tpu_torch.core.mlp import cast_tree
from flowcompare_tpu_torch.ops import _build, dgcnn_cuda, edgeconv_cuda
from flowcompare_tpu_torch.ops import flow_layer_cuda as flc
from torch_port_fixtures import (K_NEIGHBORS, N_CONTEXT, N_POINTS, model_pair, n, normal, t,
                                 tiny_config, tiny_global_config)

torch.set_num_threads(2)
BF = torch.bfloat16


def tiny_swept_config(compute_dtype: str = "float32") -> dict:
    """A tiny swept-energy: the per-point DGCNN without extra context."""
    cfg = tiny_config(compute_dtype)
    cfg.update(extra_z_value_context=False)
    return jax_derive(cfg)


CONFIGS = {"dulcet": None, "global": tiny_global_config, "swept": tiny_swept_config}


def _pair(name):
    return model_pair(config=CONFIGS[name])


class Launches:
    """gemm and knn_edge_max as their plain versions on CPU tensors, each
    gemm checking that TMA could read its operands; counts every launch of
    the chains by the port's counters."""

    def __init__(self):
        self.routes = []

    def gemm(self, a, w, out, **kw):
        # row-major operands whose rows lie apart, as `_build.gemm` takes them
        for m in (a, w):
            assert m.stride(1) == 1 and (m.shape[0] == 1 or m.stride(0) >= m.shape[1]), m.stride()
        self.routes.append(_build.gemm_route(a.data_ptr(), a.stride(0), w.data_ptr(),
                                             w.stride(0)))
        _build.GEMM_WGMMA_LAUNCHES += 1
        return _build.gemm_plain(a, w, out, **kw)

    @staticmethod
    def knn_edge_max(x, u, out, *, n_items, k, epilogue=None):
        rows = x.shape[0]
        mx = edgeconv_cuda.edge_neighbor_max_plain(x.reshape(n_items, rows // n_items, -1),
                                                   u.reshape(n_items, rows // n_items, -1),
                                                   k).reshape(rows, -1)
        c, sign, a, b = epilogue
        v = (sign * mx.float() + c) * a + b
        out.copy_(torch.where(v >= 0, v, 0.2 * v))

    @staticmethod
    def conditioner(xin, split, stack, l, q):
        _build.FUSED_CONDITIONER_LAUNCHES += 1
        flc.conditioner_plain(xin, split, stack.layer(l), q)

    @staticmethod
    def cross_attention(q, k, v, out, *, n_items):
        _build.CROSS_ATTENTION_WGMMA_LAUNCHES += 1
        _build.cross_attention_plain(q, k, v, out, n_items=n_items)


def _count():
    return (_build.GEMM_WGMMA_LAUNCHES + _build.GEMM_WMMA_LAUNCHES
            + edgeconv_cuda.EDGE_NEIGHBOR_MAX_LAUNCHES + _build.PACK_ROWS_LAUNCHES
            + _build.DGCNN_TAIL_LAUNCHES + _build.AUGMENT_NET_LAUNCHES
            + _build.FUSED_CONDITIONER_LAUNCHES + _build.CROSS_ATTENTION_WGMMA_LAUNCHES)


@pytest.fixture
def launches(monkeypatch):
    emu = Launches()
    for name in ("gemm", "knn_edge_max", "conditioner", "cross_attention"):
        monkeypatch.setattr(_build, name, getattr(emu, name))
    # the CPU routes of the new kernels' wrappers count as their launches
    for wrapper, counter in ((_build.pack_rows, "PACK_ROWS_LAUNCHES"),
                             (_build.dgcnn_tail, "DGCNN_TAIL_LAUNCHES"),
                             (_build.augment_net, "AUGMENT_NET_LAUNCHES")):
        def counted(*args, _fn=wrapper, _counter=counter, **kw):
            setattr(_build, _counter, getattr(_build, _counter) + 1)
            return _fn(*args, **kw)
        monkeypatch.setattr(_build, wrapper.__name__, counted)
    return emu


def _encoder_inputs(pm):
    return pm.params()["embedder"], pm.state.tree()["embedder"]


def _augmenter_inputs(cfg, pm, seed, items=2):
    rng = np.random.default_rng(seed)
    ed = 1 if cfg["extra_z_value_context"] else 0
    x = normal(rng, items, N_POINTS, cfg["input_dim"])
    eps = normal(rng, items, N_POINTS, cfg["latent_dim"] - cfg["input_dim"])
    if cfg["input_embedder"] == "DGCNNembedderGlobal":
        ctx = normal(rng, items, 1, cfg["input_embedding_dim"])
    else:
        ctx = normal(rng, items, N_CONTEXT, cfg["input_embedding_dim"])
    extra = normal(rng, items, N_POINTS, 1) if ed else None
    return ed, x, eps, ctx, extra


def _context(cfg, ctx):
    """The context as the model hands it over: the global embedding
    broadcast over the points (a view), else the per-point context."""
    c = t(ctx).to(BF)
    if cfg["input_embedder"] == "DGCNNembedderGlobal":
        return c.expand(c.shape[0], N_POINTS, c.shape[2])
    return c


# ------------------------------------------------------------- fold caches

@pytest.mark.parametrize("name", ["dulcet", "global"])
def test_encoder_weights_equal_fold_dgcnn(name):
    _, _, _, _, pm = _pair(name)
    params, state = _encoder_inputs(pm)
    w = dgcnn_cuda.encoder_weights(params, state, cast=BF)
    folds = dgcnn_cuda.fold_dgcnn(cast_tree(params, BF), state)
    for got, st in zip(w.stages, folds["stages"]):
        cin, cout = st["wd"].shape
        assert got["w"].shape == (-(-cin // 8) * 8, 2 * cout) and got["w"].is_contiguous()
        assert torch.equal(got["w"][:cin], torch.cat([st["wdelta"], st["wd"]], 1))
        assert not got["w"][cin:].any()
        for key in ("sign", "a", "b"):
            assert torch.equal(got[key], st[key])
    pairs = w.trunk.layer(0)
    assert torch.equal(pairs[0][0], folds["w5"]) and torch.equal(pairs[0][1], folds["b5"])
    assert torch.equal(w.scale[0], folds["a5"])
    if name == "global":
        assert w.embedding is None
        with pytest.raises(ValueError, match="head=False"):
            w.tail(True)
    else:
        for (gw, gb), (fw, fb) in zip(w.embedding.layer(0)[1:], folds["head"]):
            assert torch.equal(gw, fw) and torch.equal(gb, fb.float())


@pytest.mark.parametrize("name", ["dulcet", "swept"])
def test_augmenter_weights_equal_fold_augmenter_and_chain(name, monkeypatch):
    cfg, _, _, _, pm = _pair(name)
    monkeypatch.setattr(_build, "cast_rows", lambda src, dst: dst.copy_(src))
    ed = 1 if cfg["extra_z_value_context"] else 0
    aug = pm.params()["augmenter"]
    w = flc.augmenter_weights(aug, input_dim=6, extra_dim=ed)
    ref = flc.fold_augmenter(aug, input_dim=6, extra_dim=ed)
    for key in ("wq_f", "bq_f", "wkv", "cpl_in_xe", "cpl_in_c", "cpl_in_b"):
        assert torch.equal(w.folded[key], ref[key]), key
    # the kernel layout: as _CouplingChain converts the same folds
    ctx = torch.randn(1, N_CONTEXT, cfg["input_embedding_dim"]).to(BF)
    extra = torch.randn(1, N_POINTS, 1) if ed else None
    chain = flc._CouplingChain(ref, ctx, extra, N_POINTS, 6)
    assert (w.xe, w.xc, w.cw) == (chain.xe, chain.xc, chain.cw)
    assert torch.equal(w.wkv, chain.wkv)
    for (gw, gb), (cw, cb) in zip(w.cond_stack.pairs, chain.cond_stack.pairs):
        assert torch.equal(gw, cw) and torch.equal(gb, cb)
    net = w.net_stack.layer(0)
    assert torch.equal(net[0][0], chain.w_in[0]) and torch.equal(net[0][1], chain.b_in[0])
    for (gw, gb), (cw, cb) in zip(net[1:-2], flc._at(chain.cpl_rest, 0)[:-1]):
        assert torch.equal(gw, cw) and torch.equal(gb, cb)
    # the output layer's two passes are its [mean | log_std] columns interleaved
    last_w, last_b = flc._at(chain.cpl_rest, 0)[-1]
    inter = torch.cat([net[-2][0], net[-1][0]], 1)
    assert torch.equal(inter[:, 0::2], last_w[:, :last_w.shape[1] // 2])
    assert torch.equal(inter[:, 1::2], last_w[:, last_w.shape[1] // 2:])
    inter_b = torch.cat([net[-2][1], net[-1][1]])
    assert torch.equal(inter_b, flc._interleave_st(last_b))


def _versions_bumped(fn, params, state):
    """(encoder folds, augmenter folds) made by one lookup each after fn()."""
    fn()
    d0, a0 = dgcnn_cuda.DGCNN_FOLDS, flc.AUGMENTER_FOLDS
    dgcnn_cuda.encoder_weights(params()["embedder"], state(), cast=BF)
    flc.augmenter_weights(params()["augmenter"], input_dim=6, extra_dim=1)
    return dgcnn_cuda.DGCNN_FOLDS - d0, flc.AUGMENTER_FOLDS - a0


def test_fold_caches_fold_once_per_weights_version():
    cfg, _, jparams, jstate, pm = model_pair()
    params = pm.params
    state = lambda: pm.state.tree()["embedder"]  # noqa: E731
    # the first lookups fold, repeated ones do not
    assert _versions_bumped(lambda: None, params, state) in ((1, 1), (0, 0))
    assert _versions_bumped(lambda: None, params, state) == (0, 0)
    # an in-place change of one parameter of each (an optimizer step)
    def step():
        with torch.no_grad():
            params()["embedder"]["conv3"]["conv"]["w"].mul_(1.0)
            params()["augmenter"]["augment"]["net"]["out"]["b"].add_(0.0)
    assert _versions_bumped(step, params, state) == (1, 1)
    assert _versions_bumped(lambda: None, params, state) == (0, 0)
    # new BatchNorm running statistics reach the encoder's folds only
    assert _versions_bumped(lambda: pm.load_state(pm.state.tree()), params, state) == (1, 0)
    # a fresh load of the JAX weights reaches both
    to_np = lambda tr: jax.tree_util.tree_map(np.asarray, tr)  # noqa: E731
    assert _versions_bumped(lambda: ft.load_jax_params(pm, to_np(jparams), to_np(jstate)),
                            params, state) == (1, 1)
    assert _versions_bumped(lambda: None, params, state) == (0, 0)


def test_fold_caches_follow_the_values():
    """A refold sees the new values: after an in-place change the encoder
    and the augmenter give what their plain versions give on the new weights."""
    cfg, _, _, _, pm = model_pair()
    params, state = _encoder_inputs(pm)
    before = dgcnn_cuda.encoder_weights(params, state, cast=BF).stages[0]["w"].clone()
    with torch.no_grad():
        params["conv1"]["conv"]["w"].mul_(2.0)
    after = dgcnn_cuda.encoder_weights(params, state, cast=BF).stages[0]["w"]
    assert torch.equal(after.float(), 2 * before.float())
    aug = pm.params()["augmenter"]
    w0 = flc.augmenter_weights(aug, input_dim=6, extra_dim=1).folded["cpl_in_b"].clone()
    with torch.no_grad():
        aug["augment"]["net"]["in"]["b"].add_(1.0)
    w1 = flc.augmenter_weights(aug, input_dim=6, extra_dim=1).folded["cpl_in_b"]
    assert torch.equal(w1, flc.fold_augmenter(aug, input_dim=6, extra_dim=1)["cpl_in_b"])
    assert not torch.equal(w0, w1)


# -------------------------------------------------------- shapes and plans

@pytest.mark.parametrize("seed,cout", [(0, 64), (1, 128), (2, 256)])
def test_padded_first_stage_products_bit_equal(seed, cout):
    """The cloud in 8 bf16 columns (2 of them zero) against weights with zero
    rows there: c and u' bit-equal to the 6-wide products."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 300, 6, generator=g)
    w = torch.randn(6, 2 * cout, generator=g).to(BF)
    h8 = torch.empty(600, 8, dtype=BF)
    _build.pack_rows(h8, x)
    assert not h8[:, 6:].any() and torch.equal(h8[:, :6], x.reshape(600, 6).to(BF))
    w8 = torch.zeros(8, 2 * cout, dtype=BF)
    w8[:6] = w

    def split_product(h, wt):
        c, u = torch.empty(600, cout), torch.empty(600, cout, dtype=BF)
        _build.gemm_plain(h, wt, c, out2=u, out2_from=cout)
        return c, u

    c8, u8 = split_product(h8, w8)
    c6, u6 = split_product(h8[:, :6], w)
    assert torch.equal(c8, c6) and torch.equal(u8, u6)
    # the split columns are the spec's c = h @ W_delta (f32), u' = bf16(h @ W_diff')
    full = h8[:, :6].float() @ w.float()
    assert torch.equal(c6, full[:, :cout]) and torch.equal(u6, full[:, cout:].to(BF))


@pytest.mark.parametrize("aug", [294, 26, 7])
def test_interleaved_passes_are_a_permutation_the_epilogue_inverts(aug):
    """The output layer's [mean | log_std] columns interleaved and cut into
    the plan's two passes are a permutation of the columns, and the plain
    epilogue's de-interleave gives [mean | log_std] back exactly."""
    g = torch.Generator().manual_seed(aug)
    w = torch.randn(16, 2 * aug, generator=g)
    plan = flc.augment_net_plan([(8, 16), (16, 2 * aug)], 8, aug)
    (f0, p0), (f1, p1) = plan["passes"]
    assert f0 == 0 and f1 == p0 and p0 + p1 == aug and max(p0, p1) <= 256
    passes = flc.interleave_passes(w, plan["passes"])
    assert [p.shape[1] for p in passes] == [2 * p0, 2 * p1]
    cat = torch.cat(passes, 1)
    assert sorted(cat.T.tolist()) == sorted(w.T.tolist())
    assert torch.equal(torch.cat([cat[:, 0::2], cat[:, 1::2]], 1), w)
    # and through augment_net_plain: z2 and ldj from the permuted passes
    # equal the epilogue on the unpermuted product
    h = torch.randn(5, 16, generator=g).to(BF)
    b = torch.randn(2 * aug, generator=g)
    x, eps = torch.randn(5, 3, generator=g), torch.randn(5, aug, generator=g)
    first = [(torch.eye(16).to(BF), torch.zeros(16))]
    z, ldj = flc.augment_net_plain(h, first + list(zip(passes, flc.interleave_passes(
        b, plan["passes"]))), x, eps)
    hid = flc._cast(flc.gelu(flc._lin(h, first[0], BF)), BF)
    st = flc._lin(hid, (w.to(BF), b), BF)
    mean, log_std = st[:, :aug], st[:, aug:]
    torch.testing.assert_close(z, torch.cat([x, mean + eps * torch.exp(log_std)], 1),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ldj, (0.5 * math.log(2 * math.pi) + log_std
                                     + 0.5 * eps * eps).sum(-1), rtol=1e-6, atol=1e-5)


def _preset_shapes(preset: str) -> dict:
    cfg = ft.get_config(preset)
    ed = 1 if cfg["extra_z_value_context"] else 0
    aug = cfg["latent_dim"] - cfg["input_dim"]
    _, xc, width = flc.packed_input_layout(cfg["input_dim"], ed, 64)
    hidden = cfg["net_augmenter_dist_hidden_dims"]
    net = [(width, hidden[0])] + list(zip(hidden[:-1], hidden[1:])) + [(hidden[-1], 2 * aug)]
    head = cfg["hidden_dims_embedder_out"]
    head_shapes = ([(512, head[0])] + list(zip(head[:-1], head[1:]))
                   + [(head[-1], cfg["input_embedding_dim"])])
    return {"cfg": cfg, "net": net, "width": width, "aug": aug, "head": head_shapes}


@pytest.mark.parametrize("preset", ["dulcet-universe", "good-surf", "helpful-sponge",
                                    "summer-terrain", "swept-energy"])
def test_plans_accept_every_preset(preset):
    s = _preset_shapes(preset)
    plan = flc.augment_net_plan(s["net"], s["width"], s["aug"])
    assert s["width"] == 72 and plan["products"] == 5
    assert plan["passes"] == [(0, 147), (147, 147)]
    if s["cfg"]["input_embedder"] == "DGCNNembedder":
        assert dgcnn_cuda.dgcnn_tail_plan((512, 512), s["head"]) == {
            "products": 8, "in_cols": 512, "out_cols": 64}
    if s["cfg"]["input_embedder"].startswith("DGCNN"):
        assert dgcnn_cuda.dgcnn_tail_plan((512, 512), None)["products"] == 1


@pytest.mark.parametrize("conv5,head", [
    ((512, 2056), None),                      # wider than the wide kernels' 2,048
    ((1040, 512), None),                      # a concat wider than 1,024
    ((512, 512), [(512, 512)] * 9 + [(512, 64)]),   # 11 products
    ((512, 512), [(256, 512), (512, 64)]),    # a product that skips a width
    ((512, 512), [(512, 512), (512, 60)]),    # an output of 60 columns (not 16-byte rows)
])
def test_dgcnn_tail_plan_refuses(conv5, head):
    with pytest.raises(ValueError, match="cannot take"):
        dgcnn_cuda.dgcnn_tail_plan(conv5, head)


@pytest.mark.parametrize("net,in_cols,aug", [
    # five passes of 256 pairs beside six products: 11
    ([(72, 512)] + [(512, 512)] * 5 + [(512, 2560)], 72, 1280),
    ([(72, 2056), (2056, 588)], 72, 294),                # a hidden width of 2,056
    ([(72, 512), (512, 588)], 80, 294),                  # packed rows of another width
    ([(72, 512), (256, 588)], 72, 294),                  # a broken chain
    ([(72, 512), (512, 590)], 72, 294),                  # not [mean | log_std]
    ([(72, 512)] + [(512, 512)] * 8 + [(512, 588)], 72, 294),   # 11 products
])
def test_augment_net_plan_refuses(net, in_cols, aug):
    with pytest.raises(ValueError, match="cannot take"):
        flc.augment_net_plan(net, in_cols, aug)


# ------------------------------------------------- the chains, emulated

@pytest.mark.parametrize("name", ["dulcet", "global", "swept"])
def test_encoder_chain_emulated_matches_plain(launches, name):
    """B4's CUDA chain at the tiny widths with every launch emulated: 10
    launches, every product on the TMA route, bit-equal to the plain
    version (the padded first stage included)."""
    _, _, _, _, pm = _pair(name)
    params, state = _encoder_inputs(pm)
    head = name != "global"
    x = t(normal(np.random.default_rng(5), 2, N_CONTEXT, 6))
    w = dgcnn_cuda.encoder_weights(params, state, cast=BF)
    before = _count()
    with torch.no_grad():
        got = dgcnn_cuda._encoder_chain(x, w, K_NEIGHBORS, head)
        ref = dgcnn_cuda.fused_dgcnn_encoder_plain(x, params, state, k=K_NEIGHBORS, head=head,
                                                   cast=BF)
    assert _count() - before == 10
    assert set(launches.routes) == {"wgmma"} and len(launches.routes) == 4
    assert got.dtype == BF and torch.equal(got, ref)


@pytest.mark.parametrize("name,items", [("dulcet", 2), ("global", 2), ("global", 1),
                                        ("swept", 2)])
def test_augmenter_chain_emulated_matches_plain(launches, name, items):
    """B2's CUDA chain with every launch emulated: 5 launches (the packed
    rows, the conditioner, ctx @ wkv, the attention, the net), the gemm on
    the TMA route with rows that lie apart (the broadcast embedding of one
    item included), equal to the plain version."""
    cfg, _, _, _, pm = _pair(name)
    ed, x, eps, ctx, extra = _augmenter_inputs(cfg, pm, 6, items)
    w = flc.augmenter_weights(pm.params()["augmenter"], input_dim=6, extra_dim=ed)
    before = _count()
    with torch.no_grad():
        z, ldj = flc._augmenter_chain(t(x), t(eps), _context(cfg, ctx),
                                      None if extra is None else t(extra), w)
        zr, lr = flc.fused_augmenter_plain(t(x), t(eps), _context(cfg, ctx),
                                           None if extra is None else t(extra), w)
    assert _count() - before == 5 and launches.routes == ["wgmma"]
    # the net's first product sums [x | extra | pad | attn] over the packed
    # rows in one product, the plain version in two: a bf16 rounding of a
    # hidden activation may flip (chip_smoke's bounds: 0.02 and 1e-4)
    assert float((z - zr).abs().max()) <= 2e-3
    assert float(((ldj - lr).abs() / lr.abs().clamp_min(1.0)).max()) <= 1e-5


def test_new_wrappers_run_their_plain_versions_on_cpu_tensors():
    """A CPU tensor runs the plain version and launches nothing."""
    _, _, _, _, pm = model_pair()
    params, state = _encoder_inputs(pm)
    w = dgcnn_cuda.encoder_weights(params, state, cast=BF)
    counts = (_build.PACK_ROWS_LAUNCHES, _build.DGCNN_TAIL_LAUNCHES,
              _build.AUGMENT_NET_LAUNCHES)
    feats = torch.randn(70, 512).to(BF)
    out = torch.empty(70, 16, dtype=BF)
    _build.dgcnn_tail(feats, w.embedding, w.scale, out)
    assert torch.equal(out, dgcnn_cuda.dgcnn_tail_plain(feats, w.embedding.layer(0), w.scale[0]))
    dst = torch.full((70, 8), 3.0, dtype=BF)
    _build.pack_rows(dst, torch.ones(2, 35, 6), torch.zeros(2, 1, 1).expand(2, 35, 1) + 2)
    assert dst[:, :6].eq(1).all() and dst[:, 6].eq(2).all() and dst[:, 7].eq(0).all()
    aw = flc.augmenter_weights(pm.params()["augmenter"], input_dim=6, extra_dim=1)
    xin = torch.randn(70, aw.width).to(BF)
    x, eps = torch.randn(70, 6), torch.randn(70, 26)
    z, ldj = torch.empty(70, 32), torch.empty(70)
    _build.augment_net(xin, aw.net_stack, x, eps, z, ldj)
    zr, lr = flc.augment_net_plain(xin, aw.net_stack.layer(0), x, eps)
    assert torch.equal(z, zr) and torch.equal(ldj, lr)
    assert counts == (_build.PACK_ROWS_LAUNCHES, _build.DGCNN_TAIL_LAUNCHES,
                      _build.AUGMENT_NET_LAUNCHES)


# ------------------------------------------- the plain kernels against JAX

@pytest.mark.parametrize("name,head", [("dulcet", True), ("global", False), ("swept", True)])
def test_dgcnn_tail_plain_matches_pallas_interpret(launches, name, head):
    """B4 through its chain (the tail as `dgcnn_tail_plain`) against the
    Pallas `fused_dgcnn_encoder` in interpret mode, with head=False on the
    global encoder's trunk."""
    _, _, jparams, jstate, pm = _pair(name)
    x = normal(np.random.default_rng(3), 2, N_CONTEXT, 6)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jparams["embedder"])
    ref = jdp.fused_dgcnn_encoder(jnp.asarray(x), jp, jstate["embedder"], k=K_NEIGHBORS,
                                  head=head, interpret=True)
    params, state = _encoder_inputs(pm)
    with torch.no_grad():
        got = dgcnn_cuda._encoder_chain(t(x), dgcnn_cuda.encoder_weights(params, state, cast=BF),
                                        K_NEIGHBORS, head)
    assert got.shape == ref.shape and got.dtype == BF
    # bf16 outputs of O(1): two bf16 ulps, plus the deg-2 polynomial GELU of
    # the Pallas head (2.5e-5) against exact erf (test_torch_port_encoder.py)
    err = np.abs(n(got) - n(ref))
    assert err.max() < 6e-2 and err.mean() < 4e-3, (err.max(), err.mean())


@pytest.mark.parametrize("name", ["dulcet", "swept"])
def test_augment_net_plain_matches_pallas_interpret(launches, name):
    """B2 through its chain (the net and epilogue as `augment_net_plain`)
    against the Pallas `fused_augmenter` in interpret mode, with extra
    context and without (extra=None)."""
    cfg, _, jparams, _, pm = _pair(name)
    ed, x, eps, ctx, extra = _augmenter_inputs(cfg, pm, 3)
    jfa = flp.fold_augmenter(jparams["augmenter"], input_dim=cfg["input_dim"], extra_dim=ed)
    zr, lr = flp.fused_augmenter(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(ctx),
                                 None if extra is None else jnp.asarray(extra), jfa,
                                 interpret=True)
    w = flc.augmenter_weights(pm.params()["augmenter"], input_dim=cfg["input_dim"],
                              extra_dim=ed)
    with torch.no_grad():
        z, ldj = flc._augmenter_chain(t(x), t(eps), _context(cfg, ctx),
                                      None if extra is None else t(extra), w)
    # the bound of the JAX package's own kernel-vs-XLA augmenter test
    # (test_torch_port_flow.py)
    assert float(np.abs(n(z) - n(zr)).max()) < 1e-2
    assert float(np.abs(n(ldj) - n(lr)).max()) < 1e-2
