"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc: it skips without one (the
kernels have no CPU mode; on the CPU each wrapper runs its plain version,
which tests/test_torch_port_{core,encoder,flow,slice,vjp,sample,paconv,
attention,global}.py hold against the JAX package). The file imports no
JAX, so it runs where JAX is absent:

    python -m pytest -m cuda tests/test_torch_port_cuda.py

Shapes are the CPU tests' tiny dulcet-universe (3 layers, latent 32, N=64,
Nc=80, k=8) with the attention head at its real width 64, its PAConv and
helpful-sponge twins, a sample's 4000 rows of one item where a partial
64-row tile is the point, B10 at the flow's attention shape, and B5's
fused per-layer kernels at the presets' full widths;
chip_smoke.py checks the same kernels at the full model's shapes.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flowcompare_tpu_torch as ft
from flowcompare_tpu_torch.core.mlp import cast_tree
from flowcompare_tpu_torch.ops import _build, dgcnn_cuda, edgeconv_cuda, flow_layer_cuda as flc

torch.set_num_threads(2)
N_POINTS, N_CONTEXT, K = 64, 80, 8


@pytest.fixture
def dev():
    """Decided at test time: skip unless a GPU is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tiny_model(device, n_flow_layers: int = 3, **overrides) -> ft.FlowCompareModel:
    cfg = ft.get_config("dulcet-universe")
    cfg.update(dict(
        n_flow_layers=n_flow_layers, latent_dim=32, cif_latent_dim=32,
        hidden_dims=[64, 64, 64], net_augmenter_dist_hidden_dims=[64, 64, 64],
        pre_attention_mlp_hidden_dims=[32, 32, 32],
        hidden_dims_embedder_out=[64, 64, 64, 64, 64, 64],
        attn_dim=48, attn_input_dim=32, input_embedding_dim=16, cross_dim_head=64,
        sample_size=N_POINTS, n_samples_context=N_CONTEXT, n_neighbors=K,
        compute_dtype="bfloat16"))
    cfg.update(overrides)
    model = ft.FlowCompareModel(cfg, device=device, generator=torch.Generator().manual_seed(0))
    perturb_identity_leaves(model, torch.Generator().manual_seed(1))
    return model


def perturb_identity_leaves(model, gen) -> None:
    """Move LinearLU, ActNorm and BatchNorm off their identity init."""
    with torch.no_grad():
        for name, p in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("lower_entries", "upper_entries", "unconstrained_upper_diag",
                        "shift", "log_scale", "mean"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen).to(p.device))
            elif leaf == "var":
                p.copy_(0.5 + torch.rand(p.shape, generator=gen).to(p.device))
            elif name.endswith("bn.scale"):
                p.copy_((torch.sign(torch.randn(p.shape, generator=gen))
                         * (0.5 + torch.rand(p.shape, generator=gen))).to(p.device))


def rand(gen, *shape, device):
    return torch.randn(shape, generator=gen).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,epi", [(100, 6, 64, "gelu"), (130, 150, 300, "res"),
                                       (64, 215, 512, "f32"), (77, 40, 24, "affine")])
def test_gemm_bf16_matches_plain(dev, m, k, n, epi):
    g = torch.Generator().manual_seed(0)
    a = rand(g, m, k, device=dev).bfloat16()
    w = (rand(g, k, n, device=dev) / k ** 0.5).bfloat16()
    bias, aa, bb = rand(g, n, device=dev), rand(g, n, device=dev), rand(g, n, device=dev)
    res = rand(g, m, n, device=dev).bfloat16()
    ref = a.float() @ w.float()
    out = torch.empty(m, n, device=dev, dtype=torch.float32 if epi == "f32" else torch.bfloat16)
    if epi == "gelu":
        _build.gemm(a, w, out, bias=bias, gelu=True)
        ref = F.gelu(ref + bias)
    elif epi == "res":
        _build.gemm(a, w, out, bias=bias, residual=res, gelu=True)
        ref = F.gelu(res.float() + (ref + bias))
    elif epi == "affine":
        _build.gemm(a, w, out, affine=(aa, bb))
        ref = F.leaky_relu(ref * aa + bb, 0.2)
    else:
        _build.gemm(a, w, out, bias=bias)
        ref = ref + bias
    torch.cuda.synchronize()
    if epi == "f32":   # f32 sums in another order
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    else:              # one bf16 rounding of the output, at most
        torch.testing.assert_close(out.float(), ref.bfloat16().float(), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_cross_attention_matches_plain(dev):
    g = torch.Generator().manual_seed(1)
    q = rand(g, 3 * 70, 64, device=dev).bfloat16()
    kv = rand(g, 3 * 90, 128, device=dev).bfloat16()
    out = torch.empty(3 * 70, 64, device=dev, dtype=torch.bfloat16)
    _build.cross_attention(q, kv[:, :64], kv[:, 64:], out, n_items=3)
    torch.cuda.synchronize()
    s = q.float().view(3, 70, 64) @ kv[:, :64].float().view(3, 90, 64).transpose(1, 2)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    ref = (e.bfloat16().float() @ kv[:, 64:].float().view(3, 90, 64)) / e.sum(-1, keepdim=True)
    torch.testing.assert_close(out.float().view(3, 70, 64), ref.bfloat16().float(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("cq,cout", [(6, 64), (64, 64), (64, 128), (128, 256)])
def test_knn_edge_max_exact_on_integer_inputs(dev, cq, cout):
    """Integer-valued features make every distance exact: bit-equal to plain."""
    g = torch.Generator().manual_seed(2)
    x = torch.randint(-4, 5, (2, N_CONTEXT, cq), generator=g).bfloat16().to(dev)
    u = rand(g, 2, N_CONTEXT, cout, device=dev).bfloat16()
    got = edgeconv_cuda.edge_neighbor_max(x, u, K)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, edgeconv_cuda.edge_neighbor_max_plain(x, u, K),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_knn_edge_max_random_within_mismatch_budget(dev):
    """Random features: near-tied k-th neighbours may flip with the f32 sum
    order; at most 1% of rows may differ."""
    g = torch.Generator().manual_seed(3)
    x = rand(g, 2, N_CONTEXT, 64, device=dev).bfloat16()
    u = rand(g, 2, N_CONTEXT, 128, device=dev).bfloat16()
    got = edgeconv_cuda.edge_neighbor_max(x, u, K)
    ref = edgeconv_cuda.edge_neighbor_max_plain(x, u, K)
    assert float((got != ref).any(-1).float().mean()) <= 0.01


@pytest.mark.cuda
def test_fused_dgcnn_encoder_matches_plain(dev):
    model = tiny_model(dev)
    params = cast_tree(model.params()["embedder"], torch.bfloat16)
    state = model.state.tree()["embedder"]
    x = rand(torch.Generator().manual_seed(4), 2, N_CONTEXT, 6, device=dev)
    got = dgcnn_cuda.fused_dgcnn_encoder(x, params, state, k=K)
    torch.cuda.synchronize()
    err = (got.float() - dgcnn_cuda.fused_dgcnn_encoder_plain(x, params, state, k=K).float()).abs()
    assert float(err.detach().max()) < 6e-2 and float(err.detach().mean()) < 4e-3


@pytest.mark.cuda
def test_fused_flow_layers_matches_plain(dev):
    model = tiny_model(dev)
    folded = model._folded(model.params(), 1)
    g = torch.Generator().manual_seed(5)
    x = rand(g, 2, N_POINTS, 32, device=dev)
    ldj = rand(g, 2, N_POINTS, device=dev)
    ctx = rand(g, 2, N_CONTEXT, 16, device=dev)
    extra = rand(g, 2, N_POINTS, 1, device=dev)
    z, l = flc.fused_flow_layers(x, ldj, ctx, extra, folded)
    torch.cuda.synchronize()
    zr, lr = flc.fused_flow_layers_plain(x, ldj, ctx, extra, folded)
    assert float((z - zr).abs().max()) < 5e-2 and float((l - lr).abs().max()) < 5e-3


@pytest.mark.cuda
def test_fused_augmenter_matches_plain(dev):
    model = tiny_model(dev)
    folded = flc.fold_augmenter(model.params()["augmenter"], input_dim=6, extra_dim=1)
    g = torch.Generator().manual_seed(6)
    x = rand(g, 2, N_POINTS, 6, device=dev)
    eps = rand(g, 2, N_POINTS, 26, device=dev)
    ctx = rand(g, 2, N_CONTEXT, 16, device=dev)
    extra = rand(g, 2, N_POINTS, 1, device=dev)
    z, l = flc.fused_augmenter(x, eps, ctx, extra, folded)
    torch.cuda.synchronize()
    zr, lr = flc.fused_augmenter_plain(x, eps, ctx, extra, folded)
    assert float((z - zr).abs().max()) < 2e-2 and float((l - lr).abs().max()) < 2e-2


@pytest.mark.cuda
def test_kernel_path_matches_plain_path_and_counts_launches(dev):
    model = tiny_model(dev)
    g = np.random.default_rng(7)

    # the 11-tensor eval item: clouds of context (c) or target (t) size
    sizes = "ctecttctctt"

    def item():
        return [np.asarray(g.normal(size=(2, 1) if s == "e" else
                                    (2, N_CONTEXT if s == "c" else N_POINTS, 6)), np.float32)
                for s in sizes]

    data = [item() for _ in range(2)]

    def noise(i, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(100 + i))

    flc.FUSED_FLOW_LAYERS_LAUNCHES = flc.FUSED_AUGMENTER_LAUNCHES = 0
    dgcnn_cuda.FUSED_DGCNN_ENCODER_LAUNCHES = edgeconv_cuda.EDGE_NEIGHBOR_MAX_LAUNCHES = 0
    maps_k, maps_p = [], []
    nats_k, fr_k = ft.evaluate_on_test(model, data, noise=noise, change_maps=maps_k)
    assert flc.FUSED_FLOW_LAYERS_LAUNCHES == 2 and flc.FUSED_AUGMENTER_LAUNCHES == 2
    assert dgcnn_cuda.FUSED_DGCNN_ENCODER_LAUNCHES == 2
    assert edgeconv_cuda.EDGE_NEIGHBOR_MAX_LAUNCHES == 8
    model.plain = True
    nats_p, _ = ft.evaluate_on_test(model, data, noise=noise, change_maps=maps_p)
    assert np.isfinite(nats_k) and abs(nats_k - nats_p) < 1e-2
    assert all(0.0 <= f <= 1.0 for f in fr_k)
    agree = torch.cat([(a > 0) == (b > 0) for a, b in zip(maps_k, maps_p)]).float().mean()
    assert float(agree) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("cq,cout", [(6, 64), (64, 64), (64, 128), (128, 256)])
def test_knn_edge_reduce_matches_plain_on_integer_inputs(dev, cq, cout):
    """Integer-valued x makes the selection exact: mx and mn equal, s1, s2
    and du to f32 sum order (the sums run in another order); x gets zeros."""
    from flowcompare_tpu_torch.ops import edgeconv_vjp_cuda as ev
    g = torch.Generator().manual_seed(8)
    x = torch.randint(-4, 5, (2, N_CONTEXT, cq), generator=g).bfloat16().to(dev)
    u0 = rand(g, 2, N_CONTEXT, cout, device=dev).bfloat16().float()   # bf16 values, f32 du
    cots = [rand(g, 2, N_CONTEXT, cout, device=dev) for _ in range(4)]
    outs, grads = [], []
    for fn in (ev.edge_knn_reduce, ev.edge_knn_reduce_plain):
        u = u0.clone().requires_grad_()
        xr = x.clone().requires_grad_()
        o = fn(xr, u, K)
        sum((a * c).sum() for a, c in zip(o, cots)).backward()
        torch.cuda.synchronize()
        outs.append(o)
        grads.append((u.grad, xr.grad))
    for a, b in zip(outs[0][:2], outs[1][:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(outs[0][2:], outs[1][2:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-4, atol=1e-3)
    assert grads[0][1] is not None and float(grads[0][1].abs().max()) == 0.0


# B3 and B6 at the main path's shapes: a B=20 eval item's or training step's
# 40 context clouds of 1,250 points, k = 40, the four EdgeConv widths
MAIN_CLOUDS, MAIN_N, MAIN_K = 40, 1250, 40
EDGE_WIDTHS = [(6, 64), (64, 64), (64, 128), (128, 256)]


def _b6_both(x, u, cots, k):
    """B6 forward and du through the kernels and through the plain version."""
    from flowcompare_tpu_torch.ops import edgeconv_vjp_cuda as ev
    out = []
    for fn in (ev.edge_knn_reduce, ev.edge_knn_reduce_plain):
        uu = u.detach().clone().requires_grad_()
        o = fn(x, uu, k)
        torch.autograd.backward(o, cots)
        torch.cuda.synchronize()
        out.append([a.detach() for a in o] + [uu.grad])
    return out


def _selected(x, k):
    """The forward kernel's selected indices (ascending) and the plain ones."""
    from flowcompare_tpu_torch.ops import edgeconv_vjp_cuda as ev
    b, n, cq = x.shape
    rows = b * n
    c = 8
    outs = [torch.empty(rows, c, device=x.device) for _ in range(4)]
    slots = [torch.empty(rows, c, dtype=torch.uint8, device=x.device) for _ in range(2)]
    idx = torch.empty(rows, k, dtype=torch.int32, device=x.device)
    u = torch.zeros(rows, c, dtype=torch.bfloat16, device=x.device)
    _build.knn_edge_reduce_fwd(x.reshape(rows, cq), u, *outs, *slots, idx, n_items=b, k=k)
    torch.cuda.synchronize()
    return idx.reshape(b, n, k).long(), ev.knn_indices(x, k).sort(-1).values


@pytest.mark.cuda
@pytest.mark.parametrize("cq,cout", EDGE_WIDTHS)
def test_knn_kernels_exact_at_main_path_shapes(dev, cq, cout):
    """B3 and B6 at 40 x 1,250, k = 40, integer features (exact distances,
    many ties): the selection index-equal to plain, B3 and B6's mx / mn bit
    equal, s1 / s2 / du within 1e-4 (1 + |ref|) (f32 sums in another order)."""
    g = torch.Generator().manual_seed(60 + cq)
    x = torch.randint(-4, 5, (MAIN_CLOUDS, MAIN_N, cq), generator=g).bfloat16().to(dev)
    u = rand(g, MAIN_CLOUDS, MAIN_N, cout, device=dev).bfloat16()
    got_idx, ref_idx = _selected(x, MAIN_K)
    assert torch.equal(got_idx, ref_idx)
    torch.testing.assert_close(edgeconv_cuda.edge_neighbor_max(x, u, MAIN_K),
                               edgeconv_cuda.edge_neighbor_max_plain(x, u, MAIN_K), rtol=0, atol=0)
    cots = [rand(g, MAIN_CLOUDS, MAIN_N, cout, device=dev) for _ in range(4)]
    got, ref = _b6_both(x, u.float(), cots, MAIN_K)
    for a, b in zip(got[:2], ref[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(got[2:], ref[2:]):
        assert float(((a - b).abs() / (1 + b.abs())).max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("cq,cout", EDGE_WIDTHS)
def test_knn_kernels_random_at_main_path_shapes(dev, cq, cout):
    """Random features at 40 x 1,250: near-tied k-th neighbours may flip with
    the f32 sum order (the tensor cores' against cuBLAS's); at most 1% of
    rows may differ, in B3's output and in any of B6's five."""
    g = torch.Generator().manual_seed(70 + cq)
    x = rand(g, MAIN_CLOUDS, MAIN_N, cq, device=dev).bfloat16()
    u = rand(g, MAIN_CLOUDS, MAIN_N, cout, device=dev).bfloat16()
    got = edgeconv_cuda.edge_neighbor_max(x, u, MAIN_K)
    ref = edgeconv_cuda.edge_neighbor_max_plain(x, u, MAIN_K)
    assert float((got != ref).any(-1).float().mean()) <= 0.01
    cots = [rand(g, MAIN_CLOUDS, MAIN_N, cout, device=dev) for _ in range(4)]
    got, ref = _b6_both(x, u.float(), cots, MAIN_K)
    off = torch.zeros(MAIN_CLOUDS, MAIN_N, dtype=torch.bool, device=dev)
    for a, b in zip(got, ref):
        off |= ((a - b).abs() > 1e-4 * (1 + b.abs())).any(-1)
    assert float(off.float().mean()) <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "duplicates", "k64", "k_is_n", "cq6_ragged",
                                  "odd_cq"])
def test_knn_selection_edge_cases(dev, case):
    """A ragged n (1,037: no multiple of the 16-row block or the 8-wide
    tile), an all-duplicate cloud (every distance 0: the first k by index,
    more candidates than a warp holds, so the radix select's four passes),
    k = 64, k = n, cq = 6 on a ragged n and an odd cq (the wrapper pads a
    zero feature): the kernels' selection index-equal to plain, B3 and B6
    bit-equal on the max / min."""
    n, cq, k, cout = {"ragged": (1037, 64, 40, 128), "duplicates": (1250, 64, 40, 64),
                      "k64": (1250, 128, 64, 256), "k_is_n": (48, 6, 48, 64),
                      "cq6_ragged": (1037, 6, 40, 64), "odd_cq": (500, 5, 40, 20)}[case]
    g = torch.Generator().manual_seed(80)
    x = torch.randint(-4, 5, (3, n, cq), generator=g).bfloat16().to(dev)
    if case == "duplicates":
        x = x[:, :1].expand(3, n, cq).contiguous()
    u = rand(g, 3, n, cout, device=dev).bfloat16()
    got_idx, ref_idx = _selected(x, k)
    assert torch.equal(got_idx, ref_idx)
    if case == "duplicates":
        assert torch.equal(got_idx, torch.arange(k, device=dev).expand(3, n, k))
    torch.testing.assert_close(edgeconv_cuda.edge_neighbor_max(x, u, k),
                               edgeconv_cuda.edge_neighbor_max_plain(x, u, k), rtol=0, atol=0)
    cots = [rand(g, 3, n, cout, device=dev) for _ in range(4)]
    got, ref = _b6_both(x, u.float(), cots, k)
    for a, b in zip(got[:2], ref[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(got[2:], ref[2:]):
        assert float(((a - b).abs() / (1 + b.abs())).max()) <= 1e-4


@pytest.mark.cuda
def test_knn_edge_reduce_backward_is_deterministic(dev):
    """B6's du bit-equal over two runs at 40 x 1,250 (no atomics on the
    sums: fixed lists, a fixed order of summation)."""
    from flowcompare_tpu_torch.ops import edgeconv_vjp_cuda as ev
    g = torch.Generator().manual_seed(90)
    x = rand(g, MAIN_CLOUDS, MAIN_N, 64, device=dev).bfloat16()
    u0 = rand(g, MAIN_CLOUDS, MAIN_N, 256, device=dev).bfloat16().float()
    cots = [rand(g, MAIN_CLOUDS, MAIN_N, 256, device=dev) for _ in range(4)]
    grads = []
    for _ in range(2):
        u = u0.clone().requires_grad_()
        torch.autograd.backward(ev.edge_knn_reduce(x, u, MAIN_K), cots)
        torch.cuda.synchronize()
        grads.append(u.grad)
    assert torch.equal(grads[0], grads[1])


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-12))


@pytest.mark.cuda
def test_flow_layers_bwd_matches_plain(dev):
    """B5 against its plain version from the kernel forward's saves; bands
    of the JAX package's kernel-vs-vjp test (max error over max |ref|)."""
    from flowcompare_tpu_torch.ops import flow_layer_vjp_cuda as fv
    model = tiny_model(dev)
    with torch.no_grad():
        folded = model._folded(model.params(), 1)
    g = torch.Generator().manual_seed(9)
    x, ldj = rand(g, 2, N_POINTS, 32, device=dev), rand(g, 2, N_POINTS, device=dev)
    ctx, extra = rand(g, 2, N_CONTEXT, 16, device=dev), rand(g, 2, N_POINTS, 1, device=dev)
    dz, dldj = rand(g, 2, N_POINTS, 32, device=dev), rand(g, 2, N_POINTS, device=dev)
    _, _, saves = flc.fused_flow_layers(x, ldj, ctx, extra, folded, save=True)
    before = fv.FLOW_LAYERS_BWD_LAUNCHES
    got = fv.flow_layers_bwd(saves, dz, dldj, ctx, extra, folded)
    torch.cuda.synchronize()
    assert fv.FLOW_LAYERS_BWD_LAUNCHES == before + 1
    ref = fv.flow_layers_bwd_plain(saves, dz, dldj, ctx, extra, folded)
    for a, b in zip(got[:3], ref[:3]):
        assert _rel(a, b) < 0.03
    for k, r in ref[3].items():
        assert _rel(got[3][k], r) < 0.05, k
    again = fv.flow_layers_bwd(saves, dz, dldj, ctx, extra, folded)   # deterministic
    assert all(torch.equal(a, b) for a, b in zip(got[:3], again[:3]))


@pytest.mark.cuda
def test_train_step_kernels_match_plain(dev):
    """Data init and one train step with the kernels (B6, B1 with saves, B5)
    and with the plain versions, from one state on one batch and noise."""
    from flowcompare_tpu_torch.ops import edgeconv_vjp_cuda as ev, flow_layer_vjp_cuda as fv
    model = tiny_model(dev)
    rng = np.random.default_rng(10)
    batch = tuple(torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=dev)
                  for s in ((2, N_CONTEXT, 6), (2, N_POINTS, 6), (2, 1)))
    eps = rand(torch.Generator().manual_seed(11), 2, N_POINTS, 26, device=dev)
    state = ft.data_init_from_batch(ft.init_train_state(model), batch, eps=eps)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    results = []
    for plain in (False, True):
        model.load_state_dict(snapshot)
        model.plain = plain
        ev.EDGE_KNN_REDUCE_LAUNCHES = fv.FLOW_LAYERS_BWD_LAUNCHES = 0
        flc.FUSED_FLOW_LAYERS_SAVE_LAUNCHES = 0
        st, row = ft.train_step(ft.init_train_state(model), batch, eps=eps)
        counts = (ev.EDGE_KNN_REDUCE_LAUNCHES, flc.FUSED_FLOW_LAYERS_SAVE_LAUNCHES,
                  fv.FLOW_LAYERS_BWD_LAUNCHES)
        grads = torch.cat([p.grad.float().reshape(-1) for p in model.parameters()])
        results.append((row, counts, grads))
    (rk, ck, gk), (rp, cp, gp) = results
    assert ck == (8, 1, 1) and cp == (0, 0, 0)
    assert abs(rk["nats"] - rp["nats"]) <= 0.01 and np.isfinite(rk["loss"])
    assert abs(rk["grad_norm"] - rp["grad_norm"]) <= 0.05 * rp["grad_norm"]
    assert float(torch.nn.functional.cosine_similarity(gk, gp, dim=0)) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,out", [(150, 512, "bf16"), (300, 300, "f32")])
def test_gemm_partial_tile_4000_rows(dev, k, n, out):
    """4000 rows of one item (a sample dump) end in a half-filled 64-row tile."""
    g = torch.Generator().manual_seed(12)
    a = rand(g, 4000, k, device=dev).bfloat16()
    w = (rand(g, k, n, device=dev) / k ** 0.5).bfloat16()
    bias = rand(g, n, device=dev)
    dst = torch.full((4000, n), float("nan"), device=dev,
                     dtype=torch.float32 if out == "f32" else torch.bfloat16)
    _build.gemm(a, w, dst, bias=bias)
    torch.cuda.synchronize()
    ref = a.float() @ w.float() + bias
    if out == "f32":   # f32 sums in another order
        torch.testing.assert_close(dst, ref, rtol=1e-4, atol=1e-4)
    else:              # one bf16 rounding of the output, at most
        torch.testing.assert_close(dst.float(), ref.bfloat16().float(), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_cross_attention_partial_tile_4000_rows(dev):
    """One item of 4000 query rows (62 full 64-row blocks and a half one)
    against the 1250 context rows of the preset."""
    g = torch.Generator().manual_seed(13)
    q = rand(g, 4000, 64, device=dev).bfloat16()
    kv = rand(g, 1250, 128, device=dev).bfloat16()
    out = torch.full((4000, 64), float("nan"), device=dev, dtype=torch.bfloat16)
    _build.cross_attention(q, kv[:, :64], kv[:, 64:], out, n_items=1)
    torch.cuda.synchronize()
    s = q.float() @ kv[:, :64].float().T
    e = torch.exp(s - s.amax(-1, keepdim=True))
    ref = (e.bfloat16().float() @ kv[:, 64:].float()) / e.sum(-1, keepdim=True)
    torch.testing.assert_close(out.float(), ref.bfloat16().float(), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_fused_flow_layers_inverse_matches_plain(dev):
    """B7 on two layers (a stacked layer, then the final block, walked in
    reverse) against its plain version, and undone by B1."""
    model = tiny_model(dev, n_flow_layers=2)
    with torch.no_grad():
        folded_inv = model._folded_inverse(model.params(), 1)
    g = torch.Generator().manual_seed(14)
    z = 0.6 * rand(g, 2, N_POINTS, 32, device=dev)
    ctx = rand(g, 2, N_CONTEXT, 16, device=dev)
    extra = rand(g, 2, N_POINTS, 1, device=dev)
    before = flc.FUSED_FLOW_LAYERS_INVERSE_LAUNCHES
    x = flc.fused_flow_layers_inverse(z, ctx, extra, folded_inv)
    torch.cuda.synchronize()
    assert flc.FUSED_FLOW_LAYERS_INVERSE_LAUNCHES == before + 1
    ref = flc.fused_flow_layers_inverse_plain(z, ctx, extra, folded_inv)
    # bf16 operands, sums in another order: B1's two-layer bound
    assert float((x - ref).abs().max()) < 5e-2
    zr, _ = flc.fused_flow_layers(x, torch.zeros(2, N_POINTS, device=dev), ctx, extra,
                                  folded_inv)
    # each way bf16 rounds the carry's matmul operands (|z| up to about 2.5)
    assert float((zr - z).abs().max()) < 5e-2


@pytest.mark.cuda
def test_sampling_kernel_path_matches_plain_and_train_writes_samples(dev, tmp_path):
    """make_sample through B4 and B7 against the plain path on the same z, at
    4000 points, and train(make_samples=True) writing a finite sample."""
    model = tiny_model(dev)
    rng = np.random.default_rng(15)
    x0 = torch.as_tensor(rng.normal(size=(1, N_CONTEXT, 6)), dtype=torch.float32, device=dev)
    extra = torch.as_tensor(rng.normal(size=(1, 1)), dtype=torch.float32, device=dev)
    z = 0.6 * rand(torch.Generator().manual_seed(16), 1, 4000, 32, device=dev)
    flc.FUSED_FLOW_LAYERS_INVERSE_LAUNCHES = dgcnn_cuda.FUSED_DGCNN_ENCODER_LAUNCHES = 0
    got = ft.make_sample(model, 4000, x0, extra, z=z)
    torch.cuda.synchronize()
    assert flc.FUSED_FLOW_LAYERS_INVERSE_LAUNCHES == 1
    assert dgcnn_cuda.FUSED_DGCNN_ENCODER_LAUNCHES == 1
    model.plain = True
    ref = ft.make_sample(model, 4000, x0, extra, z=z)
    model.plain = False
    assert got.shape == (1, 4000, 6) and torch.isfinite(got).all()
    assert float((got - ref).abs().max()) < 5e-2
    model.config.update(batches_per_sample=1)
    batch = tuple(rng.normal(size=s).astype(np.float32)
                  for s in ((2, N_CONTEXT, 6), (2, N_POINTS, 6), (2, 1)))
    ft.train(model, [batch], save_dir=str(tmp_path), run_name="s", max_steps=1,
             make_samples=True)
    sample = np.load(tmp_path / "sample_s_0.npz")
    assert sample["gen"].shape == (4000, 6) and np.isfinite(sample["gen"]).all()


def tiny_paconv_model(device, preset: str = "good-surf") -> ft.FlowCompareModel:
    """The tiny flow of `tiny_model` under a PAConv preset's encoder (SA/FP
    widths as shipped, a 64-wide head, 256 context points)."""
    cfg = ft.get_config(preset)
    cfg.update(dict(
        n_flow_layers=3, latent_dim=32, cif_latent_dim=32,
        hidden_dims=[64, 64, 64], net_augmenter_dist_hidden_dims=[64, 64, 64],
        pre_attention_mlp_hidden_dims=[32, 32, 32], hidden_dims_embedder_out=[64, 64, 64],
        attn_dim=48, attn_input_dim=32, input_embedding_dim=16, cross_dim_head=64,
        sample_size=N_POINTS, n_samples_context=PACONV_CONTEXT, compute_dtype="bfloat16"))
    model = ft.FlowCompareModel(cfg, device=device, generator=torch.Generator().manual_seed(0))
    perturb_identity_leaves(model, torch.Generator().manual_seed(1))
    return model


PACONV_CONTEXT = 256
# (N, M) of the four set-abstraction levels of the presets' 1250-point context
SA_LEVELS = [(1250, 312), (312, 78), (78, 19), (19, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", SA_LEVELS)
def test_fps_index_equal_to_plain(dev, n, m):
    """B8 at each level's shape: the same f32 operations in the same order
    and the same first-index tie-break, so the same picks."""
    from flowcompare_tpu_torch.ops import fps_cuda
    x = rand(torch.Generator().manual_seed(20), 4, n, 3, device=dev)
    before = fps_cuda.FPS_LAUNCHES
    got = fps_cuda.furthest_point_sampling(x, m)
    torch.cuda.synchronize()
    assert fps_cuda.FPS_LAUNCHES == before + 1 and got.dtype == torch.int64
    torch.testing.assert_close(got, fps_cuda.furthest_point_sampling_plain(x, m), rtol=0, atol=0)
    dup = torch.cat([x[:, : n // 2], x[:, : n - n // 2]], 1)     # duplicated points: ties
    torch.testing.assert_close(fps_cuda.furthest_point_sampling(dup, m),
                               fps_cuda.furthest_point_sampling_plain(dup, m), rtol=0, atol=0)


def fps_clouds(items: int, n: int, seed: int, device) -> dict:
    """Clouds of n points: random, duplicated halves, an integer grid and
    all equal (ties everywhere)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(items, n, 3, generator=g)
    return {"random": x.to(device),
            "duplicated": torch.cat([x[:, : n // 2], x[:, : n - n // 2]], 1).to(device),
            "grid": torch.randint(-3, 4, (items, n, 3), generator=g).float().to(device),
            "equal": torch.ones(items, n, 3, device=device)}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1250, 2600])
@pytest.mark.parametrize("items", [50, 1])
def test_fps_levels_index_equal_to_plain(dev, n, items):
    """B8's four SA levels in one launch on tie-heavy clouds, at the main
    path's 1,250 points and past the registers' 2,048: each level's picks
    and coordinates equal the plain version's chain of levels."""
    from flowcompare_tpu_torch.ops import fps_cuda
    ms = [n // 4 ** (i + 1) for i in range(4)]
    for name, x in fps_clouds(items, n, 29, dev).items():
        idx = [torch.empty(items, m, dtype=torch.int64, device=dev) for m in ms]
        out = [torch.empty(items, m, 3, device=dev) for m in ms]
        _build.fps_levels(x, idx, out)
        torch.cuda.synchronize()
        ref_idx, ref_out = fps_cuda.furthest_point_sampling_levels_plain(x, ms)
        for level in range(4):
            assert torch.equal(idx[level], ref_idx[level]), (name, level)
            assert torch.equal(out[level], ref_out[level]), (name, level)


@pytest.mark.cuda
def test_fps_levels_counts_one_launch_and_takes_large_clouds(dev):
    """The entry point launches once for all levels; a cloud past the
    registers' 2,048 points keeps the rest in shared memory; one past shared
    memory is refused with the limit named."""
    from flowcompare_tpu_torch.ops import fps_cuda
    g = torch.Generator().manual_seed(30)
    x = rand(g, 3, 1250, 6, device=dev)
    before = fps_cuda.FPS_LAUNCHES
    idx, out = fps_cuda.furthest_point_sampling_levels(x, [312, 78, 19, 4])
    assert fps_cuda.FPS_LAUNCHES == before + 1
    ref_idx, ref_out = fps_cuda.furthest_point_sampling_levels_plain(x, [312, 78, 19, 4])
    assert all(torch.equal(a, b) for a, b in zip(idx + out, ref_idx + ref_out))
    big = rand(g, 2, 14000, 3, device=dev)
    torch.testing.assert_close(fps_cuda.furthest_point_sampling(big, 64),
                               fps_cuda.furthest_point_sampling_plain(big, 64), rtol=0, atol=0)
    with pytest.raises(ValueError, match="shared memory"):
        fps_cuda.furthest_point_sampling(rand(g, 1, 20000, 3, device=dev), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sa_select_levels_one_launch_matches_plain(dev, dtype):
    """B9's selection of the four SA levels of 50 clouds in one launch on
    integer coordinates (exact distances, crowded ties), then a gather a
    level: the slot lists equal the plain version's, the groups too."""
    from flowcompare_tpu_torch.ops import fps_cuda, sa_group_cuda as sg
    g = torch.Generator().manual_seed(31)
    x = torch.randint(-8, 9, (50, 1250, 3), generator=g).float().to(dev)
    idxs, outs = fps_cuda.furthest_point_sampling_levels_plain(x, [312, 78, 19, 4])
    levels = list(zip(outs, idxs, [x, *outs]))
    before = (sg.SA_SELECT_LAUNCHES, sg.SA_GATHER_LAUNCHES)
    sels = sg.sa_select_levels(levels, 32)
    groups = []
    for (new_xyz, _, xyz), sel, c in zip(levels, sels, (3, 64, 128, 256)):
        feats = rand(g, 50, xyz.shape[1], c, device=dev).to(dtype)
        groups.append((sg.sa_gather(sel, new_xyz, xyz, feats), new_xyz, xyz, feats))
    torch.cuda.synchronize()
    assert (sg.SA_SELECT_LAUNCHES, sg.SA_GATHER_LAUNCHES) == (before[0] + 1, before[1] + 4)
    for lv, sel, (got, new_xyz, xyz, feats) in zip(levels, sels, groups):
        ref = sg.sa_select_plain(*lv, 32)
        assert sel.dtype == torch.int32 and torch.equal(sel.long(), ref)
        assert torch.equal(got, sg.sa_gather_plain(ref, new_xyz, xyz, feats))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,c", [(32, 3), (32, 64), (32, 256), (12, 5), (16, 7), (40, 8),
                                 (8, 1), (64, 61)])
def test_sa_gather_matches_plain_at_every_alignment(dev, dtype, k, c):
    """The gather's groups, vector and element paths and its head / body /
    tail stores at row widths and k whose spans start off 16-byte
    boundaries, against the plain gather of the same slot lists (point 0
    past N included)."""
    from flowcompare_tpu_torch.ops import sa_group_cuda as sg
    g = torch.Generator().manual_seed(32 + k + c)
    n, mc = 100, 9
    xyz = rand(g, 3, n, 3, device=dev)
    feats = rand(g, 3, n, c, device=dev).to(dtype)
    sel = torch.randint(0, n, (3, mc, k), generator=g).int().to(dev)
    new_xyz = rand(g, 3, mc, 3, device=dev)
    got = sg.sa_gather(sel, new_xyz, xyz, feats)
    torch.cuda.synchronize()
    assert torch.equal(got, sg.sa_gather_plain(sel, new_xyz, xyz, feats))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,m,c", [(1250, 312, 3), (312, 78, 64), (78, 19, 128), (19, 4, 256)])
def test_sa_group_exact_on_integer_coordinates(dev, dtype, n, m, c):
    """B9 at each level's shape (the last has k = 32 > N = 19): integer
    coordinates make every distance exact, so the output equals the plain
    version's slot for slot; slot 0 is the centre with a zero xyz diff."""
    from flowcompare_tpu_torch.ops import fps_cuda, sa_group_cuda
    g = torch.Generator().manual_seed(21)
    xyz = torch.randint(-6, 7, (2, n, 3), generator=g).float().to(dev)
    feats = rand(g, 2, n, c, device=dev).to(dtype)
    idx = fps_cuda.furthest_point_sampling_plain(xyz, m)
    new_xyz = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
    got = sa_group_cuda.sa_group(new_xyz, idx, xyz, feats, 32)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (2, m, 32, 3 + c)
    torch.testing.assert_close(got, sa_group_cuda.sa_group_plain(new_xyz, idx, xyz, feats, 32),
                               rtol=0, atol=0)
    assert float(got[:, :, 0, :3].abs().max()) == 0.0
    torch.testing.assert_close(got[:, :, 0, 3:], torch.gather(
        feats, 1, idx[..., None].expand(-1, -1, c)), rtol=0, atol=0)


@pytest.mark.cuda
def test_sa_group_out_of_range_centre_gives_nan_rows(dev):
    """A centre index outside [0, N) is not checked on the host (that would
    synchronise): the kernel writes that centre's rows as NaN and touches
    nothing out of range; the other rows are unchanged."""
    from flowcompare_tpu_torch.ops import sa_group_cuda
    g = torch.Generator().manual_seed(28)
    xyz = torch.randint(-6, 7, (1, 100, 3), generator=g).float().to(dev)
    feats = rand(g, 1, 100, 5, device=dev).bfloat16()
    idx = torch.tensor([[3, 100, 7, -1]], device=dev)
    centres = torch.gather(xyz, 1, idx.clamp(0, 99)[..., None].expand(-1, -1, 3))
    got = sa_group_cuda.sa_group(centres, idx, xyz, feats, 16)
    torch.cuda.synchronize()
    assert bool(got[:, [1, 3]].isnan().all()) and not bool(got[:, [0, 2]].isnan().any())
    ok = idx[:, [0, 2]]
    torch.testing.assert_close(got[:, [0, 2]], sa_group_cuda.sa_group_plain(
        centres[:, [0, 2]], ok, xyz, feats, 16), rtol=0, atol=0)


@pytest.mark.cuda
def test_paconv_eval_encoder_kernels_match_plain(dev):
    """The eval encoder through B8 (one launch for the four levels) and B9
    (one selection launch, a gather a level) against the plain
    versions: the same picks, and groups that differ only where a rounded
    distance flips a near-tied 32nd neighbour."""
    from flowcompare_tpu_torch.ops import fps_cuda, sa_group_cuda
    model = tiny_paconv_model(dev)
    x = rand(torch.Generator().manual_seed(22), 2, PACONV_CONTEXT, 6, device=dev)
    fps_cuda.FPS_LAUNCHES = sa_group_cuda.SA_SELECT_LAUNCHES = 0
    sa_group_cuda.SA_GATHER_LAUNCHES = 0
    got, _ = model.embed(x)
    torch.cuda.synchronize()
    assert fps_cuda.FPS_LAUNCHES == 1 and sa_group_cuda.SA_SELECT_LAUNCHES == 1
    assert sa_group_cuda.SA_GATHER_LAUNCHES == 4
    model.plain = True
    ref, _ = model.embed(x)
    err = (got.float() - ref.float()).abs()
    assert got.dtype == torch.bfloat16 and got.shape == (2, PACONV_CONTEXT, 16)
    assert float(err.max()) < 6e-2 and float(err.mean()) < 4e-3


@pytest.mark.cuda
def test_paconv_train_step_kernels_match_plain(dev):
    """Data init (the eval encoder: B8, B9) and one good-surf train step
    through the kernels (B8 in the train encoder, B1 with saves, B5) and
    through the plain versions, from one state on one batch and noise."""
    from flowcompare_tpu_torch.ops import flow_layer_vjp_cuda as fv, fps_cuda
    model = tiny_paconv_model(dev)
    rng = np.random.default_rng(23)
    batch = tuple(torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=dev)
                  for s in ((2, PACONV_CONTEXT, 6), (2, N_POINTS, 6), (2, 1)))
    eps = rand(torch.Generator().manual_seed(24), 2, N_POINTS, 26, device=dev)
    ft.data_init_from_batch(ft.init_train_state(model), batch, eps=eps)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    results = []
    for plain in (False, True):
        model.load_state_dict(snapshot)
        model.plain = plain
        fps_cuda.FPS_LAUNCHES = fv.FLOW_LAYERS_BWD_LAUNCHES = 0
        flc.FUSED_FLOW_LAYERS_SAVE_LAUNCHES = 0
        _, row = ft.train_step(ft.init_train_state(model), batch, eps=eps)
        counts = (fps_cuda.FPS_LAUNCHES, flc.FUSED_FLOW_LAYERS_SAVE_LAUNCHES,
                  fv.FLOW_LAYERS_BWD_LAUNCHES)
        grads = torch.cat([p.grad.float().reshape(-1) for p in model.parameters()])
        results.append((row, counts, grads))
    (rk, ck, gk), (rp, cp, gp) = results
    assert ck == (1, 1, 1) and cp == (0, 0, 0)
    assert abs(rk["nats"] - rp["nats"]) <= 0.01 and np.isfinite(rk["loss"])
    assert abs(rk["grad_norm"] - rp["grad_norm"]) <= 0.05 * rp["grad_norm"]
    assert float(torch.nn.functional.cosine_similarity(gk, gp, dim=0)) >= 0.99


@pytest.mark.cuda
def test_summer_terrain_kernel_paths_match_plain(dev):
    """summer-terrain (PAConv, no extra context: B1, B2 and B7 without the
    extra column) through the kernels and the plain versions: the eval's
    nats, a sample of the same z, and one train step."""
    model = tiny_paconv_model(dev, "summer-terrain")
    rng = np.random.default_rng(25)
    sizes = {"c": PACONV_CONTEXT, "t": N_POINTS}
    items = [[np.asarray(rng.normal(size=(2, 1) if s == "e" else (2, sizes[s], 6)), np.float32)
              for s in "ctecttctctt"]]
    batch = tuple(torch.as_tensor(a, device=dev) for a in items[0][:3])
    z = 0.6 * rand(torch.Generator().manual_seed(26), 1, 500, 32, device=dev)
    eps = rand(torch.Generator().manual_seed(27), 2, N_POINTS, 26, device=dev)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}

    def noise(i, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(200 + i))

    out = []
    for plain in (False, True):
        model.load_state_dict(snapshot)
        model.plain = plain
        flc.FUSED_FLOW_LAYERS_LAUNCHES = flc.FUSED_FLOW_LAYERS_INVERSE_LAUNCHES = 0
        nats, _ = ft.evaluate_on_test(model, items, noise=noise)
        sample = ft.make_sample(model, 500, batch[0][:1], None, z=z)
        _, row = ft.train_step(ft.init_train_state(model), batch, eps=eps)
        out.append((nats, sample, row, flc.FUSED_FLOW_LAYERS_LAUNCHES,
                    flc.FUSED_FLOW_LAYERS_INVERSE_LAUNCHES))
    (nk, sk, rk, b1k, b7k), (npl, sp, rp, b1p, b7p) = out
    assert (b1k, b7k) == (2, 1) and (b1p, b7p) == (0, 0)
    assert np.isfinite(nk) and abs(nk - npl) < 1e-2
    assert sk.shape == (1, 500, 6) and float((sk - sp).abs().max()) < 5e-2
    assert abs(rk["nats"] - rp["nats"]) <= 0.01
    assert abs(rk["grad_norm"] - rp["grad_norm"]) <= 0.05 * rp["grad_norm"]


# ------------------------------------------------- B10: the attention core

def _attention_ref(q, k, v, scale):
    """softmax(q k^T * scale) v in f32 with autograd (the JAX _bwd's math)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    return torch.softmax(s, -1) @ v.float()


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nkv", [(70, 90), (1024, 1250), (64, 1), (1000, 1250), (1, 65)])
def test_fused_attention_core_matches_plain(dev, nq, nkv):
    """B10 forward against its plain version, k and v as column slices of one
    [k | v] tensor as apply_cross_attention hands them over: f32 inside and
    p never rounded to bf16, so at most one bf16 ulp of the output apart."""
    from flowcompare_tpu_torch.ops import attention_cuda as ac
    g = torch.Generator().manual_seed(30)
    q = rand(g, 3, nq, 64, device=dev).bfloat16()
    kv = (2 * rand(g, 3, nkv, 128, device=dev)).bfloat16()
    k, v = kv[..., :64], kv[..., 64:]
    before = ac.FUSED_ATTENTION_CORE_LAUNCHES
    got = ac.fused_attention_core(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert ac.FUSED_ATTENTION_CORE_LAUNCHES == before + 1
    ref = ac.fused_attention_core_plain(q, k, v, 0.125).float()
    assert got.dtype == torch.bfloat16 and got.shape == (3, nq, 64)
    # f32 sums in another order (about 1e-6 of the |p v| terms), then one
    # bf16 rounding each: one bf16 ulp (2^-7 relative) apart at most
    assert bool(((got.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-5).all())
    # against the f32 result before the cast: one rounding, half an ulp
    exact = _attention_ref(q, k, v, 0.125)
    assert bool(((got.float() - exact).abs() <= 2.0 ** -8 * exact.abs() + 1e-5).all())


@pytest.mark.cuda
def test_fused_attention_core_keeps_p_at_f32_precision(dev):
    """At (3, 1024) x 1250 keys: the wgmma kernel (p split into three bf16
    terms) puts at most 0.03% of its outputs more than half a bf16 ulp off
    the plain version (chip_smoke.py's B10_SHARE_LIMIT: the earlier kernel's
    f32 FMAs read about 0.016% on the H100, p in two bf16 terms summed in
    one tensor-core accumulator several times that), and a smaller share than p rounded
    to bf16 alone, flash attention's rounding (emulated)."""
    from flowcompare_tpu_torch.ops import attention_cuda as ac
    g = torch.Generator().manual_seed(32)
    q = rand(g, 3, 1024, 64, device=dev).bfloat16()
    kv = (2 * rand(g, 3, 1250, 128, device=dev)).bfloat16()
    k, v = kv[..., :64], kv[..., 64:]
    got = ac.fused_attention_core(q, k, v, 0.125)
    torch.cuda.synchronize()
    ref = ac.fused_attention_core_plain(q, k, v, 0.125)
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * 0.125, -1)
    flash_like = (p.bfloat16().float() @ v.float()).bfloat16()
    shares = [ulp_shares(a, ref)[1] for a in (got, flash_like)]
    assert shares[0] <= 3e-4 and shares[0] < shares[1], shares


@pytest.mark.cuda
def test_fused_attention_core_backward_and_d_raises(dev):
    """B10's autograd backward (the JAX _bwd: an f32 recompute) against
    autograd through the f32 softmax; D != 64 raises on CUDA tensors."""
    from flowcompare_tpu_torch.ops import attention_cuda as ac
    g = torch.Generator().manual_seed(31)
    q, k, v = (rand(g, 2, n, 64, device=dev).bfloat16().requires_grad_() for n in (70, 90, 90))
    cot = rand(g, 2, 70, 64, device=dev).bfloat16()
    got = torch.autograd.grad(ac.fused_attention_core(q, k, v, 0.125), (q, k, v), cot)
    ref = torch.autograd.grad(_attention_ref(q, k, v, 0.125), (q, k, v), cot.float())
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.bfloat16().float(), rtol=1e-2, atol=1e-3)
    for d in (32, 128):
        qd = rand(g, 2, 70, d, device=dev).bfloat16()
        kd = rand(g, 2, 90, d, device=dev).bfloat16()
        with pytest.raises(ValueError, match="D = 64"):
            ac.fused_attention_core(qd, kd, kd, d ** -0.5)


@pytest.mark.cuda
def test_apply_cross_attention_fused_runs_b10(dev):
    """apply_cross_attention(fused=True) on CUDA tensors launches B10 once and
    agrees with fused=False (which rounds p to bf16 for its product), forward
    and backward."""
    from flowcompare_tpu_torch.core import attention
    from flowcompare_tpu_torch.ops import attention_cuda as ac
    g = torch.Generator().manual_seed(32)
    p = attention.init_cross_attention(g, out_dim=48, query_dim=32, context_dim=20)
    p = {k: {kk: vv.to(dev).requires_grad_() for kk, vv in v.items()} for k, v in p.items()}
    x, ctx = rand(g, 2, 100, 32, device=dev), rand(g, 2, 130, 20, device=dev)
    cot = rand(g, 2, 100, 48, device=dev)
    outs = []
    for fused in (True, False):
        before = ac.FUSED_ATTENTION_CORE_LAUNCHES
        out = attention.apply_cross_attention(p, x, ctx, dtype=torch.bfloat16, fused=fused)
        grads = torch.autograd.grad(out, [p["to_q"]["w"], p["to_kv"]["w"]], cot)
        assert ac.FUSED_ATTENTION_CORE_LAUNCHES == before + int(fused)
        outs.append((out.detach().float(), grads))
    (o1, g1), (o2, g2) = outs
    torch.testing.assert_close(o1, o2, rtol=2e-2, atol=2e-2)
    for a, b in zip(g1, g2):
        assert float(F.cosine_similarity(a.reshape(-1), b.reshape(-1), dim=0)) >= 0.999


# ----------------------------------------- helpful-sponge: the global branch

def tiny_global_model(device) -> ft.FlowCompareModel:
    """The tiny flow of `tiny_model` under helpful-sponge: the global DGCNN
    (a 4-layer 64-wide head on the pooled 1024), couplings of 6 hidden layers
    that read a 20-wide embedding row by row, no extra context."""
    cfg = ft.get_config("helpful-sponge")
    cfg.update(dict(
        n_flow_layers=3, latent_dim=32, cif_latent_dim=32, hidden_dims=[64] * 6,
        net_augmenter_dist_hidden_dims=[64, 64, 64], pre_attention_mlp_hidden_dims=[32, 32, 32],
        hidden_dims_embedder_out=[64] * 4, attn_dim=48, attn_input_dim=32,
        input_embedding_dim=20, cross_dim_head=64, sample_size=N_POINTS,
        n_samples_context=N_CONTEXT, n_neighbors=K, compute_dtype="bfloat16"))
    model = ft.FlowCompareModel(cfg, device=device, generator=torch.Generator().manual_seed(0))
    perturb_identity_leaves(model, torch.Generator().manual_seed(1))
    return model


@pytest.mark.cuda
def test_fused_dgcnn_encoder_head_false_matches_plain(dev):
    model = tiny_global_model(dev)
    params = cast_tree(model.params()["embedder"], torch.bfloat16)
    state = model.state.tree()["embedder"]
    x = rand(torch.Generator().manual_seed(33), 2, N_CONTEXT, 6, device=dev)
    before = dgcnn_cuda.FUSED_DGCNN_ENCODER_LAUNCHES
    got = dgcnn_cuda.fused_dgcnn_encoder(x, params, state, k=K, head=False)
    torch.cuda.synchronize()
    assert dgcnn_cuda.FUSED_DGCNN_ENCODER_LAUNCHES == before + 1
    ref = dgcnn_cuda.fused_dgcnn_encoder_plain(x, params, state, k=K, head=False)
    assert got.shape == (2, N_CONTEXT, 512) and got.dtype == torch.bfloat16
    err = (got.float() - ref.float()).abs()
    assert float(err.max()) < 6e-2 and float(err.mean()) < 4e-3


@pytest.mark.cuda
def test_global_flow_kernels_match_plain(dev):
    """B1, B7 and B5 on the has_attn=False stack (the context the broadcast
    embedding, read row by row) against their plain versions."""
    from flowcompare_tpu_torch.ops import flow_layer_vjp_cuda as fv
    model = tiny_global_model(dev)
    with torch.no_grad():
        folded = model._folded(model.params(), 0)
        folded_inv = model._folded_inverse(model.params(), 0)
    assert folded["pre"] is None and folded["n_cpl"] == 7
    g = torch.Generator().manual_seed(34)
    x, ldj = rand(g, 2, N_POINTS, 32, device=dev), rand(g, 2, N_POINTS, device=dev)
    ctx = rand(g, 2, 1, 20, device=dev).bfloat16().expand(2, N_POINTS, 20)
    z, l, saves = flc.fused_flow_layers(x, ldj, ctx, None, folded, save=True)
    torch.cuda.synchronize()
    zr, lr, saves_r = flc.fused_flow_layers_plain(x, ldj, ctx, None, folded, save=True)
    assert float((z - zr).abs().max()) < 5e-2 and float((l - lr).abs().max()) < 5e-3
    assert float((saves.float() - saves_r.float()).abs().max()) < 5e-2
    xi = flc.fused_flow_layers_inverse(0.6 * x, ctx, None, folded_inv)
    torch.cuda.synchronize()
    assert float((xi - flc.fused_flow_layers_inverse_plain(0.6 * x, ctx, None, folded_inv))
                 .abs().max()) < 5e-2
    dz, dldj = rand(g, 2, N_POINTS, 32, device=dev), rand(g, 2, N_POINTS, device=dev)
    got = fv.flow_layers_bwd(saves, dz, dldj, ctx, None, folded)
    torch.cuda.synchronize()
    ref = fv.flow_layers_bwd_plain(saves, dz, dldj, ctx, None, folded)
    assert got[2] is None and got[1].shape == (2, N_POINTS, 20)
    for a, b in zip(got[:2], ref[:2]):
        assert _rel(a, b) < 0.03
    assert set(got[3]) == set(ref[3])
    for k, r in ref[3].items():
        assert _rel(got[3][k], r) < 0.05, k


@pytest.mark.cuda
def test_global_kernel_paths_match_plain(dev):
    """helpful-sponge through the kernels and the plain versions: the eval's
    nats (B4 head=False, B2 over the broadcast context, B1), a sample of the
    same z (B7) and one train step (B6, B1 with saves, B5 with the row-wise
    dctx summed into the embedder through the broadcast)."""
    from flowcompare_tpu_torch.ops import edgeconv_vjp_cuda as ev, flow_layer_vjp_cuda as fv
    model = tiny_global_model(dev)
    rng = np.random.default_rng(35)
    sizes = {"c": N_CONTEXT, "t": N_POINTS}
    items = [[np.asarray(rng.normal(size=(2, 1) if s == "e" else (2, sizes[s], 6)), np.float32)
              for s in "ctecttctctt"]]
    batch = tuple(torch.as_tensor(a, device=dev) for a in items[0][:3])
    z = 0.6 * rand(torch.Generator().manual_seed(36), 1, 500, 32, device=dev)
    eps = rand(torch.Generator().manual_seed(37), 2, N_POINTS, 26, device=dev)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}

    def noise(i, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(300 + i))

    out = []
    for plain in (False, True):
        model.load_state_dict(snapshot)
        model.plain = plain
        flc.FUSED_FLOW_LAYERS_LAUNCHES = flc.FUSED_FLOW_LAYERS_INVERSE_LAUNCHES = 0
        flc.FUSED_AUGMENTER_LAUNCHES = dgcnn_cuda.FUSED_DGCNN_ENCODER_LAUNCHES = 0
        ev.EDGE_KNN_REDUCE_LAUNCHES = fv.FLOW_LAYERS_BWD_LAUNCHES = 0
        nats, _ = ft.evaluate_on_test(model, items, noise=noise)
        sample = ft.make_sample(model, 500, batch[0][:1], None, z=z)
        _, row = ft.train_step(ft.init_train_state(model), batch, eps=eps)
        grads = torch.cat([p.grad.float().reshape(-1) for p in model.embedder.parameters()])
        out.append((nats, sample, row, grads,
                    (flc.FUSED_FLOW_LAYERS_LAUNCHES, flc.FUSED_AUGMENTER_LAUNCHES,
                     dgcnn_cuda.FUSED_DGCNN_ENCODER_LAUNCHES,
                     flc.FUSED_FLOW_LAYERS_INVERSE_LAUNCHES, ev.EDGE_KNN_REDUCE_LAUNCHES,
                     fv.FLOW_LAYERS_BWD_LAUNCHES)))
    model.plain = False
    (nk, sk, rk, gk, ck), (npl, sp, rp, gp, cp) = out
    # B1: the eval and the train step's forward with saves; B4: the eval
    # and the sample's embed
    assert ck == (2, 1, 2, 1, 8, 1) and cp == (0, 0, 0, 0, 0, 0)
    assert np.isfinite(nk) and abs(nk - npl) < 1e-2
    assert sk.shape == (1, 500, 6) and float((sk - sp).abs().max()) < 5e-2
    assert abs(rk["nats"] - rp["nats"]) <= 0.01
    assert abs(rk["grad_norm"] - rp["grad_norm"]) <= 0.05 * rp["grad_norm"]
    assert float(F.cosine_similarity(gk, gp, dim=0)) >= 0.99


# ------------------------------------------------------ the two GEMM routes

def aligned(gen, rows, cols, dtype, device, scale=1.0):
    """A random (rows, cols) matrix with rows of whole 16 bytes (as the
    chains lay out theirs), so the TMA + wgmma route can read it."""
    view = torch.empty(rows, -(-cols // 8) * 8, dtype=dtype, device=device)[:, :cols]
    return view.copy_(scale * torch.randn(rows, cols, generator=gen).to(device))


def assert_gemm_close(got, ref):
    """bf16: at most one bf16 rounding of the output apart (plus f32 sum
    order); f32: 1e-4 of max |ref| (sums in another order)."""
    d, scale = (got.float() - ref.float()).abs(), float(ref.float().abs().max())
    if got.dtype == torch.bfloat16:
        assert float((d - 2.0 ** -7 * ref.float().abs()).max()) <= 1e-5 * scale
    else:
        assert float(d.max()) <= 1e-4 * scale


# epilogue flag combinations the chains pass: name -> (flags, output dtype)
GEMM_EPILOGUES = {
    "bias_gelu": (("bias", "gelu"), torch.bfloat16),
    "residual_bf16": (("bias", "residual", "gelu"), torch.bfloat16),
    "residual_f32": (("residual",), torch.float32),
    "accumulate": (("accumulate",), torch.float32),
    "affine_leaky": (("affine",), torch.bfloat16),
    "pre_out": (("bias", "gelu", "pre_out"), torch.bfloat16),
    "gelu_grad_out2": (("gelu_grad", "out2"), torch.float32),
}


def _gemm_pair(dev, m, k, n, *, trans_b, flags, out_dtype, route, seed=0):
    """Runs one product through `_build.gemm` on `route` and through
    `gemm_plain`; returns the outputs of both (out, pre_out, out2)."""
    g = torch.Generator().manual_seed(seed)
    a = aligned(g, m, k, torch.bfloat16, dev)
    w = aligned(g, *((n, k) if trans_b else (k, n)), torch.bfloat16, dev, scale=k ** -0.5)
    kw = {"trans_b": trans_b, "accumulate": "accumulate" in flags, "gelu": "gelu" in flags}
    if "bias" in flags:
        kw["bias"] = rand(g, n, device=dev)
    if "residual" in flags:
        kw["residual"] = aligned(g, m, n, out_dtype, dev)
    if "affine" in flags:
        kw["affine"] = (rand(g, n, device=dev), rand(g, n, device=dev))
    if "gelu_grad" in flags:
        kw["gelu_grad"] = aligned(g, m, n, torch.float32, dev)
    start = aligned(g, m, n, out_dtype, dev)
    outs = []
    for fn, extra in ((_build.gemm, {"route": route}), (_build.gemm_plain, {})):
        out = start.clone()
        side = {}
        if "pre_out" in flags:
            side["pre_out"] = torch.zeros(m, n, device=dev)
        if "out2" in flags:
            side["out2"] = torch.zeros(m, n, dtype=torch.bfloat16, device=dev)
        fn(a, w, out, **kw, **side, **extra)
        outs.append([out, *side.values()])
    torch.cuda.synchronize()
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "wmma"])
@pytest.mark.parametrize("layout", ["nn", "nt"])
@pytest.mark.parametrize("epi", sorted(GEMM_EPILOGUES))
def test_gemm_epilogues_match_plain_on_both_routes(dev, route, layout, epi):
    """Every epilogue of the chains, A @ B and A @ B^T, on each route, at a
    ragged 300 x 216 x 300 product (M not a multiple of 128, N = 300)."""
    flags, out_dtype = GEMM_EPILOGUES[epi]
    got, ref = _gemm_pair(dev, 300, 216, 300, trans_b=layout == "nt", flags=flags,
                          out_dtype=out_dtype, route=route)
    for x, r in zip(got, ref):
        assert_gemm_close(x, r)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "wmma"])
@pytest.mark.parametrize("m,k,n", [(300, 6, 64), (1000, 150, 300), (777, 216, 512),
                                   (513, 276, 300), (4000, 512, 512), (4000, 300, 300)])
def test_gemm_ragged_shapes_match_plain(dev, route, m, k, n):
    """K = 6, 150, 216, 276; N = 300; M ragged or a sample's 4,000 rows."""
    for out_dtype in (torch.bfloat16, torch.float32):
        got, ref = _gemm_pair(dev, m, k, n, trans_b=False, flags=("bias",), out_dtype=out_dtype,
                              route=route, seed=m + k)
        assert_gemm_close(got[0], ref[0])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "wmma"])
@pytest.mark.parametrize("m,n,k", [(512, 512, 3000), (151, 512, 2000), (300, 300, 1000),
                                   (64, 128, 2500), (6, 64, 100)])
def test_gemm_tn_matches_plain(dev, route, m, n, k):
    """A^T @ B over K rows (the weight gradients), split over K and summed
    in order, on each route."""
    g = torch.Generator().manual_seed(m + n + k)
    a, b = aligned(g, k, m, torch.bfloat16, dev), aligned(g, k, n, torch.bfloat16, dev)
    got = torch.full((m, n), float("nan"), device=dev)
    _build.gemm_tn(a, b, got, route=route)
    torch.cuda.synchronize()
    assert_gemm_close(got, _build.gemm_tn_plain(a, b, torch.empty(m, n, device=dev)))


@pytest.mark.cuda
def test_gemm_small_m_takes_64_row_tiles(dev):
    """A sample's 4,000 rows: 64-row tiles, so the blocks fill the SMs."""
    assert _build.gemm_tile(4000, 512)[0] == 64 and _build.gemm_tile(40960, 512)[0] == 128
    got, ref = _gemm_pair(dev, 4000, 216, 512, trans_b=False, flags=("bias", "gelu"),
                          out_dtype=torch.bfloat16, route="wgmma")
    assert_gemm_close(got[0], ref[0])


@pytest.mark.cuda
def test_gemm_unaligned_view_takes_wmma_route(dev):
    """A view TMA cannot read (a base 2 bytes past 16-byte alignment) takes
    the WMMA route, counted as such, and is still right; forcing the wgmma
    route on it raises."""
    g = torch.Generator().manual_seed(3)
    base = rand(g, 200, 16, device=dev).bfloat16()
    a = base[:, 1:7]
    w = aligned(g, 6, 64, torch.bfloat16, dev)
    bias = rand(g, 64, device=dev)
    before = (_build.GEMM_WGMMA_LAUNCHES, _build.GEMM_WMMA_LAUNCHES)
    out = torch.empty(200, 64, device=dev, dtype=torch.bfloat16)
    _build.gemm(a, w, out, bias=bias, gelu=True)
    torch.cuda.synchronize()
    assert (_build.GEMM_WGMMA_LAUNCHES - before[0], _build.GEMM_WMMA_LAUNCHES - before[1]) == (0, 1)
    assert_gemm_close(out, _build.gemm_plain(a, w, torch.empty_like(out), bias=bias, gelu=True))
    with pytest.raises(ValueError, match="TMA"):
        _build.gemm(a, w, out, bias=bias, route="wgmma")


# ------------------------------------------- cross attention: wgmma and WMMA

ATTENTION_SHAPES = [(items, nq, nkv) for items in (1, 3, 20) for nq in (70, 4000)
                    for nkv in (34, 90, 1250)]


def attention_inputs(dev, items, nq, nkv, seed, big_next=False):
    """q (items*nq, 64) scaled as the folds scale it, kv (items*nkv, 128) bf16
    with k and v its column halves; with big_next every item after the first
    holds large queries and keys, so a tile read across an item boundary
    shows in the first item's maximum and output."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(items * nq, 64, generator=g) / 8
    kv = torch.randn(items * nkv, 128, generator=g)
    if big_next:
        q[nq:] = q[nq:] * 4 + 3
        kv[nkv:] = kv[nkv:] * 4 + 6
    q, kv = q.bfloat16().to(dev), kv.bfloat16().to(dev)
    return q, kv, kv[:, :64], kv[:, 64:]


def attention_forward(fn, q, k, v, items, **kw):
    out = torch.full(q.shape, float("nan"), device=q.device, dtype=torch.bfloat16)
    m = torch.full((q.shape[0],), float("nan"), device=q.device)
    den = torch.full_like(m, float("nan"))
    fn(q, k, v, out, n_items=items, m_out=m, den_out=den, **kw)
    return out, m, den


def assert_attention_forward_close(got, ref):
    """One bf16 rounding of the output (the bounds of
    test_cross_attention_matches_plain); m and den to 1e-4 relative."""
    (out, m, den), (rout, rm, rden) = got, ref
    torch.testing.assert_close(out.float(), rout.float(), rtol=1e-2, atol=1e-2)
    assert float(((m - rm).abs() / rm.abs().clamp_min(1.0)).max()) <= 1e-4
    assert float(((den - rden).abs() / rden).max()) <= 1e-4


def attention_backward(fn, q, k, v, m, den, out, items, seed, **kw):
    g = torch.Generator().manual_seed(seed)
    da = torch.randn(q.shape, generator=g).to(q.device)
    du = torch.empty(q.shape, device=q.device, dtype=torch.bfloat16)
    ddn = torch.empty(q.shape[0], device=q.device)
    _build.attn_bwd_prep(da, out, den, du, ddn)
    nkv = k.shape[0]
    bufs = (torch.full(q.shape, float("nan"), device=q.device),
            torch.full(q.shape, float("nan"), device=q.device, dtype=torch.bfloat16),
            torch.full((nkv, 128), float("nan"), device=q.device),
            torch.full((nkv, 128), float("nan"), device=q.device, dtype=torch.bfloat16))
    fn(q, k, v, du, ddn, m, *bufs, n_items=items, **kw)
    return bufs


def assert_attention_backward_close(got, ref):
    """dq, dk and dv: cosine >= 0.9999 and max error <= 1e-2 of max |ref|;
    each bf16 output the rounding of its f32 twin."""
    (dq, dq_b, dkv, dkv_b), (rq, _, rkv, _) = got, ref
    for a, b in ((dq, rq), (dkv[:, :64], rkv[:, :64]), (dkv[:, 64:], rkv[:, 64:])):
        assert float(F.cosine_similarity(a.reshape(-1).double(), b.reshape(-1).double(),
                                         dim=0)) >= 0.9999
        assert _rel(a, b) <= 1e-2
    assert torch.equal(dq_b, dq.bfloat16()) and torch.equal(dkv_b, dkv.bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("items,nq,nkv", ATTENTION_SHAPES)
def test_cross_attention_wgmma_matches_plain(dev, items, nq, nkv):
    """The wgmma forward with m/den (B5's recompute) and without (B1, B2,
    B7) against the plain version: ragged keys (34, 90, 1250 = 19 tiles and
    34), ragged queries (70, 4000), 1, 3 and 20 items."""
    q, kv, k, v = attention_inputs(dev, items, nq, nkv, seed=items + nq + nkv)
    before = _build.CROSS_ATTENTION_WGMMA_LAUNCHES
    got = attention_forward(_build.cross_attention, q, k, v, items, route="wgmma")
    bare = torch.full_like(got[0], float("nan"))
    _build.cross_attention(q, k, v, bare, n_items=items)
    torch.cuda.synchronize()
    assert _build.CROSS_ATTENTION_WGMMA_LAUNCHES == before + 2
    assert torch.equal(bare, got[0])
    assert_attention_forward_close(got, attention_forward(_build.cross_attention_plain, q, k, v,
                                                          items))


@pytest.mark.cuda
@pytest.mark.parametrize("items,nq,nkv", ATTENTION_SHAPES)
def test_attention_bwd_wgmma_matches_plain(dev, items, nq, nkv):
    """The wgmma backward (dq and [dk | dv] kernels) against the plain
    version from the plain forward's m and den."""
    q, kv, k, v = attention_inputs(dev, items, nq, nkv, seed=7 + items + nq + nkv)
    out, m, den = attention_forward(_build.cross_attention_plain, q, k, v, items)
    before = _build.ATTENTION_BWD_WGMMA_LAUNCHES
    got = attention_backward(_build.attention_bwd, q, k, v, m, den, out, items, 1)
    torch.cuda.synchronize()
    assert _build.ATTENTION_BWD_WGMMA_LAUNCHES == before + 1
    again = attention_backward(_build.attention_bwd, q, k, v, m, den, out, items, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, again))      # no atomics
    assert_attention_backward_close(
        got, attention_backward(_build.attention_bwd_plain, q, k, v, m, den, out, items, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nkv", [(70, 34), (70, 90), (100, 1250)])
@pytest.mark.parametrize("route", ["wgmma", "wmma"])
def test_attention_does_not_read_across_items(dev, nq, nkv, route):
    """Items after the first hold large queries and keys: a key tile or a
    query tile read past an item's last row would change the first item's
    maximum, output and gradients. Both routes."""
    q, kv, k, v = attention_inputs(dev, 3, nq, nkv, seed=nq + nkv, big_next=True)
    ref = attention_forward(_build.cross_attention_plain, q, k, v, 3)
    rb = attention_backward(_build.attention_bwd_plain, q, k, v, ref[1], ref[2], ref[0], 3, 2)
    got = attention_forward(_build.cross_attention, q, k, v, 3, route=route)
    assert_attention_forward_close(got, ref)
    gb = attention_backward(_build.attention_bwd, q, k, v, ref[1], ref[2], ref[0], 3, 2,
                            route=route)
    torch.cuda.synchronize()
    assert_attention_backward_close(gb, rb)


@pytest.mark.cuda
def test_attention_unaligned_view_takes_wmma_route(dev):
    """An aligned call takes the wgmma kernels; a q view TMA cannot read (a
    base 2 bytes past 16-byte alignment) takes the WMMA kernels, counted as
    such, and is still right; forcing the wgmma route on it raises."""
    q0, kv, k, v = attention_inputs(dev, 3, 70, 90, seed=5)
    base = torch.zeros(210, 72, device=dev, dtype=torch.bfloat16)
    base[:, 1:65] = q0
    q = base[:, 1:65]
    ref = attention_forward(_build.cross_attention_plain, q0, k, v, 3)
    rb = attention_backward(_build.attention_bwd_plain, q0, k, v, ref[1], ref[2], ref[0], 3, 3)
    counters = ("CROSS_ATTENTION_WGMMA_LAUNCHES", "CROSS_ATTENTION_WMMA_LAUNCHES",
                "ATTENTION_BWD_WGMMA_LAUNCHES", "ATTENTION_BWD_WMMA_LAUNCHES")
    for view, expect in ((q0, (1, 0, 1, 0)), (q, (0, 1, 0, 1))):
        before = [getattr(_build, c) for c in counters]
        got = attention_forward(_build.cross_attention, view, k, v, 3)
        gb = attention_backward(_build.attention_bwd, view, k, v, ref[1], ref[2], ref[0], 3, 3)
        torch.cuda.synchronize()
        assert tuple(getattr(_build, c) - b for c, b in zip(counters, before)) == expect
        assert_attention_forward_close(got, ref)
        assert_attention_backward_close(gb, rb)
    with pytest.raises(ValueError, match="TMA"):
        attention_forward(_build.cross_attention, q, k, v, 3, route="wgmma")


@pytest.mark.cuda
def test_attention_cpu_tensors_run_the_plain_versions(dev):
    """With the library on the card, CPU tensors still take the plain
    versions and count no launch."""
    q, kv, k, v = attention_inputs("cpu", 3, 70, 90, seed=6)
    counters = (_build.CROSS_ATTENTION_WGMMA_LAUNCHES, _build.CROSS_ATTENTION_WMMA_LAUNCHES,
                _build.ATTENTION_BWD_WGMMA_LAUNCHES, _build.ATTENTION_BWD_WMMA_LAUNCHES)
    got = attention_forward(_build.cross_attention, q, k, v, 3)
    ref = attention_forward(_build.cross_attention_plain, q, k, v, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    gb = attention_backward(_build.attention_bwd, q, k, v, ref[1], ref[2], ref[0], 3, 4)
    rb = attention_backward(_build.attention_bwd_plain, q, k, v, ref[1], ref[2], ref[0], 3, 4)
    assert all(torch.equal(a, b) for a, b in zip(gb, rb))
    assert counters == (_build.CROSS_ATTENTION_WGMMA_LAUNCHES,
                        _build.CROSS_ATTENTION_WMMA_LAUNCHES,
                        _build.ATTENTION_BWD_WGMMA_LAUNCHES, _build.ATTENTION_BWD_WMMA_LAUNCHES)


# ------------------------------------------- the fused layer kernels (B1, B7)

def fused_setup(dev, preset: str, rows: int, seed: int = 40):
    """A preset's two-layer stacks at full width on the card, B1's and B7's
    fused-route chains over `rows` rows (one item), the packed rows filled
    with random x1, extra and cond columns; (chain, inverse chain, split,
    lat, folded)."""
    cfg = ft.get_config(preset)
    cfg.update(compute_dtype="bfloat16", n_flow_layers=2)
    model = ft.FlowCompareModel(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    perturb_identity_leaves(model, torch.Generator().manual_seed(1))
    ed, lat, e = int(cfg["using_extra_context"]), cfg["latent_dim"], cfg["input_embedding_dim"]
    with torch.no_grad():
        folded, folded_inv = model._folded(model.params(), ed), model._folded_inverse(
            model.params(), ed)
    g = torch.Generator().manual_seed(seed)
    ctx = (rand(g, 1, 1, e, device=dev).bfloat16().expand(1, rows, e) if model.is_global
           else rand(g, 1, 1250, e, device=dev).bfloat16())
    extra = rand(g, 1, rows, 1, device=dev) if ed else None
    bf, split = torch.bfloat16, lat // 2
    lu = (flc._pad_cols(folded["lu_w_f"].transpose(1, 2).to(bf)),
          folded["lu_b"].float().reshape(2, -1).contiguous())
    minv = (flc._pad_cols(folded_inv["lu_w_inv_f"].transpose(1, 2).to(bf)),
            folded_inv["lu_shift"].float().reshape(2, -1).contiguous())
    fwd = flc._CouplingChain(folded, ctx, extra, rows, split, tail=lu, lat=lat)
    inv = flc._CouplingChain(folded_inv, ctx, extra, rows, split, tail=minv, lat=lat)
    for chain in (fwd, inv):
        chain.xin[:, :split] = rand(g, rows, split, device=dev)
        if chain.has_attn:
            chain.xin[:, chain.xc:chain.xc + chain.cw] = rand(g, rows, chain.cw, device=dev)
    return fwd, inv, split, lat, folded


FUSED_CASES = [("dulcet-universe", 4000), ("dulcet-universe", 1037), ("swept-energy", 4000),
               ("helpful-sponge", 1000), ("good-surf", 40960)]


def ulp_shares(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """The shares of elements of got more than a quarter and more than half
    a bf16 ulp of ref away from it (an element below 2^-8 of max |ref|
    counted at that size), as chip_smoke.error_stats reads them."""
    a = ref.float().abs()
    _, e = torch.frexp(torch.maximum(a, a.max() * 2 ** -8))
    r = (got.float() - ref.float()).abs() / torch.ldexp(torch.ones_like(a), e - 8)
    return float((r > 0.25).float().mean()), float((r > 0.5).float().mean())


# (quarter, half) share limits, chip_smoke.FUSED_LIMITS' (PERF.md has the
# readings of tools/torch_fused_layer_faults.py they sit between): the carry
# rounded to bf16 puts about half of a carry over a quarter ulp, [s | t] in
# bf16 1.9-12% over half an ulp and a fifth or more of ldj over a quarter,
# the LayerNorm's input in bf16 55% of q; the kernels as built stay at or
# under 1.7%, and 0.8% over half an ulp of a carry
SHARE_LIMITS = {"carry": (0.05, 0.012), "bf16": (0.05, 1.0), "ldj": (0.08, 1.0)}


def assert_ulp_shares(got: torch.Tensor, ref: torch.Tensor, kind: str) -> None:
    shares = ulp_shares(got, ref)
    assert all(s <= lim for s, lim in zip(shares, SHARE_LIMITS[kind])), (kind, shares)


@pytest.mark.cuda
@pytest.mark.parametrize("preset,rows", FUSED_CASES)
def test_fused_layer_kernels_match_plain(dev, preset, rows):
    """conditioner, coupling_layer (with and without saves) and
    coupling_inverse (layer 1 with the chained LU inverse of layer 0, and
    layer 0 writing x) against their plain versions on the same packed rows,
    at the shipped widths (with and without extra, helpful-sponge's seven
    products), 4000 rows and rows that are not a multiple of 64. Same
    rounding points, another accumulation order: q within 2 bf16 roundings,
    the f32 carries within 2e-2 of their scale, ldj within 1e-2 (B1's
    two-layer bound), and every output within SHARE_LIMITS."""
    fwd, inv, split, lat, folded = fused_setup(dev, preset, rows)
    g = torch.Generator().manual_seed(41)
    x = rand(g, rows, lat, device=dev)
    ldj = rand(g, rows, device=dev)
    lu_ldj = folded["lu_ldj_f"].float().contiguous()
    launches = (_build.FUSED_CONDITIONER_LAUNCHES, _build.COUPLING_LAYER_LAUNCHES,
                _build.COUPLING_INVERSE_LAUNCHES)
    for l in range(2):
        if fwd.has_attn:
            q_ref = torch.empty_like(fwd.q)
            flc.conditioner_plain(fwd.xin, split, fwd.cond_stack.layer(l), q_ref)
            _build.conditioner(fwd.xin, split, fwd.cond_stack, l, fwd.q)
            torch.cuda.synchronize()
            assert float((fwd.q.float() - q_ref.float()).abs().max()) <= \
                2 * 2 ** -8 * float(q_ref.float().abs().max())
            assert_ulp_shares(fwd.q, q_ref, "bf16")
        for save in (None, torch.empty(rows, lat, dtype=torch.bfloat16, device=dev)):
            xin_ref = fwd.xin.clone()
            xk, lk, xr, lr = x.clone(), ldj.clone(), x.clone(), ldj.clone()
            save_ref = None if save is None else torch.empty_like(save)
            flc.coupling_layer_plain(xin_ref, split, fwd.cpl_stack.layer(l), xr, lr,
                                     lu_ldj[l:l + 1], save=save_ref, eps_affine=1e-8)
            xin_k = fwd.xin.clone()
            _build.coupling_layer(xin_k, split, fwd.cpl_stack, l, xk, lk, lu_ldj[l:l + 1],
                                  save=save, eps_affine=1e-8)
            torch.cuda.synchronize()
            scale = max(1.0, float(xr.abs().max()))
            assert float((xk - xr).abs().max()) <= 2e-2 * scale
            assert float((lk - lr).abs().max()) <= 1e-2
            assert float((xin_k[:, :split].float() - xin_ref[:, :split].float()).abs().max()) \
                <= 2e-2 * scale
            assert_ulp_shares(xk, xr, "carry")
            assert_ulp_shares(lk, lr, "ldj")
            assert_ulp_shares(xin_k[:, :split], xin_ref[:, :split], "bf16")
            # only the x1 columns are written (compared bit for bit: the
            # trailing pad columns are not initialised)
            assert torch.equal(xin_k[:, split:].view(torch.int16),
                               fwd.xin[:, split:].view(torch.int16))
            if save is not None:
                assert float((save.float() - save_ref.float()).abs().max()) <= 2e-2 * scale
                assert_ulp_shares(save, save_ref, "bf16")
    y = rand(g, rows, lat, device=dev)
    for l, with_x in ((1, False), (0, True)):
        xin_ref, xin_k = inv.xin.clone(), inv.xin.clone()
        yr, yk = y.clone(), y.clone()
        xr = torch.empty(rows, lat, device=dev) if with_x else None
        xk = torch.empty(rows, lat, device=dev) if with_x else None
        pairs = inv.cpl_stack.layer(l)[:inv.cpl_stack.n_mlp]
        if not with_x:
            pairs = pairs + [inv.cpl_stack.layer(l - 1)[-1]]
        flc.coupling_inverse_plain(xin_ref, split, pairs, yr, x=xr, eps_affine=1e-8)
        _build.coupling_inverse(xin_k, split, inv.cpl_stack, l, yk, x=xk, eps_affine=1e-8)
        torch.cuda.synchronize()
        got, ref = (xk, xr) if with_x else (yk, yr)
        assert float((got - ref).abs().max()) <= 2e-2 * max(1.0, float(ref.abs().max()))
        assert float((xin_k[:, :split].float() - xin_ref[:, :split].float()).abs().max()) <= \
            2e-2 * max(1.0, float(ref.abs().max()))
        assert_ulp_shares(got, ref, "carry")
        if not with_x:
            assert_ulp_shares(xin_k[:, :split], xin_ref[:, :split], "bf16")
    counted = (_build.FUSED_CONDITIONER_LAUNCHES - launches[0],
               _build.COUPLING_LAYER_LAUNCHES - launches[1],
               _build.COUPLING_INVERSE_LAUNCHES - launches[2])
    assert counted == (2 * fwd.has_attn, 4, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["dulcet-universe", "helpful-sponge"])
def test_fused_route_chains_match_plain_and_launch_four_per_layer(dev, preset):
    """B1 (with saves) and B7 at full width over 1 x 4000 points through the
    fused route: against their plain versions, and per layer one conditioner,
    one ctx @ wkv gemm and one cross attention with attention (none without)
    beside one coupling_layer / coupling_inverse: no per-product MLP gemm
    (the gemms are ctx @ wkv per layer and B7's top LU inverse)."""
    fwd, _, split, lat, folded = fused_setup(dev, preset, 4000)
    cfg = ft.get_config(preset)
    ed = int(cfg["extra_z_value_context"])
    model = ft.FlowCompareModel({**cfg, "compute_dtype": "bfloat16", "n_flow_layers": 2},
                                device=dev, generator=torch.Generator().manual_seed(0))
    perturb_identity_leaves(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        folded_inv = model._folded_inverse(model.params(), ed)
    g = torch.Generator().manual_seed(42)
    e = cfg["input_embedding_dim"]
    ctx = (rand(g, 1, 1, e, device=dev).bfloat16().expand(1, 4000, e) if model.is_global
           else rand(g, 1, 1250, e, device=dev).bfloat16())
    extra = rand(g, 1, 4000, 1, device=dev) if ed else None
    x, ldj = rand(g, 1, 4000, lat, device=dev), torch.zeros(1, 4000, device=dev)
    counters = ("GEMM_WGMMA_LAUNCHES", "FUSED_CONDITIONER_LAUNCHES", "COUPLING_LAYER_LAUNCHES",
                "COUPLING_INVERSE_LAUNCHES", "CROSS_ATTENTION_WGMMA_LAUNCHES")
    before = [getattr(_build, c) for c in counters]
    with torch.no_grad():
        z, l, saves = flc.fused_flow_layers(x, ldj, ctx, extra, folded, save=True)
        xi = flc.fused_flow_layers_inverse(0.6 * x, ctx, extra, folded_inv)
    torch.cuda.synchronize()
    attn = int(not model.is_global)
    assert [getattr(_build, c) - b for c, b in zip(counters, before)] == \
        [4 * attn + 1, 4 * attn, 2, 2, 4 * attn]
    # two layers at 4,000 rows: one bf16 flip of y moves z by up to an ulp
    # of its magnitude (0.0625 at |z| in [8, 16)), so the bounds scale
    zr, lr, sr = flc.fused_flow_layers_plain(x, ldj, ctx, extra, folded, save=True)
    scale = max(1.0, float(zr.abs().max()))
    # ldj sums 150 log-scales a layer: flips of s move it by up to ~1e-2 over two layers
    assert float((z - zr).abs().max()) <= 1e-2 * scale and float((l - lr).abs().max()) <= 2e-2
    assert float((saves.float() - sr.float()).abs().max()) <= 1e-2 * scale
    xr = flc.fused_flow_layers_inverse_plain(0.6 * x, ctx, extra, folded_inv)
    assert float((xi - xr).abs().max()) <= 1e-2 * max(1.0, float(xr.abs().max()))
    # over two layers (tools/torch_fused_layer_faults.py at this shape): as
    # built at most 1.8% of z, 2.9% of x, 3.4% of ldj and 0.7% of the saves
    # over a quarter ulp; the carry rounded to bf16 14% of z and 46% of x,
    # [s | t] in bf16 29% of ldj
    for got, ref, limit in ((z, zr, 0.06), (xi, xr, 0.06), (l, lr, 0.08), (saves, sr, 0.05)):
        assert ulp_shares(got, ref)[0] <= limit


# ------------------------------------------- B5's fused per-layer kernels

B5_COUNTERS = ("CONDITIONER_RECORD_LAUNCHES", "COUPLING_RECORD_LAUNCHES", "COUPLING_BWD_LAUNCHES",
               "CONDITIONER_BWD_LAUNCHES", "GEMM_TN_GROUPED_LAUNCHES", "GRAD_REDUCE_LAUNCHES",
               "GEMM_WGMMA_LAUNCHES", "GEMM_WMMA_LAUNCHES", "GEMM_TN_WGMMA_LAUNCHES",
               "GEMM_TN_WMMA_LAUNCHES", "CROSS_ATTENTION_WGMMA_LAUNCHES",
               "CROSS_ATTENTION_WMMA_LAUNCHES", "ATTENTION_BWD_WGMMA_LAUNCHES",
               "ATTENTION_BWD_WMMA_LAUNCHES", "ATTN_BWD_PREP_LAUNCHES", "COLSUM_LAUNCHES")


def counted(fn):
    """fn()'s result and the B5 launch counters it moved."""
    before = {c: getattr(_build, c) for c in B5_COUNTERS}
    out = fn()
    torch.cuda.synchronize()
    return out, {c: getattr(_build, c) - before[c] for c in B5_COUNTERS}


@pytest.mark.cuda
@pytest.mark.parametrize("preset,rows", [("dulcet-universe", 1037), ("swept-energy", 4000),
                                         ("helpful-sponge", 1000)])
def test_b5_fused_kernels_match_the_per_product_chain(dev, preset, rows):
    """B5 at a preset's full widths (two layers, one item; with and without
    extra and attention): the fused per-layer kernels against the
    per-product chain they replace and the plain version (the JAX package's
    kernel-vs-vjp bands: 0.03 of max |ref| for dx, dctx and dextra, 0.05 for
    every folded gradient), two calls bit-equal, and per layer 11 launches
    with attention (no per-product MLP gemm: the two gemms are ctx @ wkv and
    dctx += dkv wkv^T) and 4 without, with no gemm_tn and no colsum."""
    from flowcompare_tpu_torch.ops import flow_layer_vjp_cuda as fv
    cfg = ft.get_config(preset)
    cfg.update(compute_dtype="bfloat16", n_flow_layers=2)
    model = ft.FlowCompareModel(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    perturb_identity_leaves(model, torch.Generator().manual_seed(1))
    ed, lat, e = int(cfg["using_extra_context"]), cfg["latent_dim"], cfg["input_embedding_dim"]
    with torch.no_grad():
        folded = model._folded(model.params(), ed)
    g = torch.Generator().manual_seed(43)
    ctx = (rand(g, 1, 1, e, device=dev).bfloat16().expand(1, rows, e) if model.is_global
           else rand(g, 1, 1250, e, device=dev).bfloat16())
    extra = rand(g, 1, rows, 1, device=dev) if ed else None
    x, ldj = rand(g, 1, rows, lat, device=dev), torch.zeros(1, rows, device=dev)
    dz, dldj = rand(g, 1, rows, lat, device=dev), rand(g, 1, rows, device=dev)
    _, _, saves = flc.fused_flow_layers(x, ldj, ctx, extra, folded, save=True)
    args = (saves, dz, dldj, ctx, extra, folded)
    got, counts = counted(lambda: fv.flow_layers_bwd(*args))
    attn = int(not model.is_global)
    per_layer = {c: v / 2 for c, v in counts.items()}
    assert sum(per_layer.values()) == (11 if attn else 4), per_layer
    assert per_layer["GEMM_WGMMA_LAUNCHES"] == 2 * attn and per_layer["COLSUM_LAUNCHES"] == 0
    assert per_layer["GEMM_TN_WGMMA_LAUNCHES"] == per_layer["GEMM_TN_WMMA_LAUNCHES"] == 0
    assert per_layer["GEMM_TN_GROUPED_LAUNCHES"] == per_layer["GRAD_REDUCE_LAUNCHES"] == 1
    again = fv.flow_layers_bwd(*args)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got[:3], again[:3]))
    assert all(torch.equal(got[3][k], again[3][k]) for k in got[3])
    chain = fv._bwd_per_product(*args, 1e-8)
    plain = fv.flow_layers_bwd_plain(*args)
    for ref in (chain, plain):
        for a, b in zip(got[:3], ref[:3]):
            assert (a is None) == (b is None)
            if a is not None:
                assert _rel(a, b) < 0.03
        for k, r in ref[3].items():
            assert _rel(got[3][k], r) < 0.05, k


# ------------------------------------------------- B4's tail and B2's net

def preset_model(dev, preset: str) -> ft.FlowCompareModel:
    """A preset at full width on the card, the flow cut to two layers (B2
    and B4 read none of it)."""
    cfg = ft.get_config(preset)
    cfg.update(compute_dtype="bfloat16", n_flow_layers=2)
    model = ft.FlowCompareModel(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    perturb_identity_leaves(model, torch.Generator().manual_seed(1))
    return model


def b4_b2_launches() -> int:
    """Every launch the B4 and B2 chains make, by the port's counters."""
    return (_build.GEMM_WGMMA_LAUNCHES + _build.GEMM_WMMA_LAUNCHES
            + edgeconv_cuda.EDGE_NEIGHBOR_MAX_LAUNCHES + _build.PACK_ROWS_LAUNCHES
            + _build.DGCNN_TAIL_LAUNCHES + _build.AUGMENT_NET_LAUNCHES
            + _build.FUSED_CONDITIONER_LAUNCHES + _build.CROSS_ATTENTION_WGMMA_LAUNCHES
            + _build.CROSS_ATTENTION_WMMA_LAUNCHES)


TAIL_CASES = [("dulcet-universe", True), ("helpful-sponge", False), ("swept-energy", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("preset,head", TAIL_CASES)
@pytest.mark.parametrize("rows", [1037, 3750])
def test_dgcnn_tail_matches_plain(dev, preset, head, rows):
    """B4's tail (conv5 and the head, or conv5 alone) at the shipped widths
    against `dgcnn_tail_plain` on the same stage concat, at row counts that
    are not a multiple of 64; one launch."""
    model = preset_model(dev, preset)
    w = dgcnn_cuda.encoder_weights(model.params()["embedder"], model.state.tree()["embedder"],
                                   cast=torch.bfloat16)
    stack = w.tail(head)
    feats = rand(torch.Generator().manual_seed(rows), rows, 512, device=dev).bfloat16()
    out = torch.empty(rows, stack.pairs[-1][0].shape[2], dtype=torch.bfloat16, device=dev)
    before = _build.DGCNN_TAIL_LAUNCHES
    _build.dgcnn_tail(feats, stack, w.scale, out)
    torch.cuda.synchronize()
    assert _build.DGCNN_TAIL_LAUNCHES == before + 1
    ref = dgcnn_cuda.dgcnn_tail_plain(feats, stack.layer(0), w.scale[0])
    err = (out.float() - ref.float()).abs()
    # chip_smoke's B4 limits: bf16 roundings that flip between the orders of
    # f32 summation move an element by an ulp
    assert float(err.mean()) <= 1e-3 and float((err > 0.1).float().mean()) <= 1e-3


AUG_CASES = [("dulcet-universe", 1037), ("dulcet-universe", 3750), ("helpful-sponge", 1037),
             ("helpful-sponge", 3750), ("swept-energy", 3750)]


@pytest.mark.cuda
@pytest.mark.parametrize("preset,rows", AUG_CASES)
def test_augment_net_matches_plain(dev, preset, rows):
    """B2's net and epilogue at the shipped widths (72 -> 512 x 3 -> 588 in
    two passes of 147 pairs) against `augment_net_plain` on the same packed
    rows; one launch."""
    model = preset_model(dev, preset)
    ed = int(model.config["using_extra_context"])
    w = flc.augmenter_weights(model.params()["augmenter"], input_dim=6, extra_dim=ed)
    g = torch.Generator().manual_seed(rows + 1)
    xin = rand(g, rows, w.width, device=dev).bfloat16()
    xin[:, w.xe:w.xc] = 0
    x, eps = rand(g, rows, 6, device=dev), rand(g, rows, 294, device=dev)
    z, ldj = torch.empty(rows, 300, device=dev), torch.empty(rows, device=dev)
    before = _build.AUGMENT_NET_LAUNCHES
    _build.augment_net(xin, w.net_stack, x, eps, z, ldj)
    torch.cuda.synchronize()
    assert _build.AUGMENT_NET_LAUNCHES == before + 1
    zr, lr = flc.augment_net_plain(xin, w.net_stack.layer(0), x, eps)
    assert torch.equal(z[:, :6], x)
    assert float((z - zr).abs().max()) <= 0.02
    assert float(((ldj - lr).abs() / lr.abs().clamp_min(1.0)).max()) <= 1e-4


@pytest.mark.cuda
def test_pack_rows_and_split_gemm_match_plain(dev):
    """The packed rows from a cloud and a broadcast extra context, and the
    stage product's split output (c in f32, u' in bf16) on both routes."""
    g = torch.Generator().manual_seed(50)
    x = rand(g, 3, 1037, 6, device=dev)
    extra = rand(g, 3, 1, 1, device=dev).expand(3, 1037, 1)
    dst = torch.full((3111, 8), 7.0, dtype=torch.bfloat16, device=dev)
    _build.pack_rows(dst, x, extra)
    ref = torch.empty_like(dst)
    _build.pack_rows_plain(ref, x, extra)
    assert torch.equal(dst, ref)
    h = dst
    w = (rand(g, 8, 256, device=dev) / 3).bfloat16()
    for route in ("wgmma", "wmma"):
        c = torch.empty(3111, 128, device=dev)
        u = torch.empty(3111, 128, dtype=torch.bfloat16, device=dev)
        _build.gemm(h, w, c, out2=u, out2_from=128, route=route)
        torch.cuda.synchronize()
        cr, ur = torch.empty_like(c), torch.empty_like(u)
        _build.gemm_plain(h, w, cr, out2=ur, out2_from=128)
        assert float((c - cr).abs().max()) <= 1e-5 * float(cr.abs().max()), route
        assert float((u.float() - ur.float()).abs().max()) <= 2 ** -7 * float(ur.float().abs().max())


@pytest.mark.cuda
def test_fused_dgcnn_encoder_full_width_ragged_matches_plain(dev):
    """B4 at dulcet-universe's widths on 3 clouds of 1,250 points (3,750 rows,
    not a multiple of 64) against its plain version: 10 launches a call,
    none on the WMMA route, one fold over repeated calls."""
    model = preset_model(dev, "dulcet-universe")
    params, state = model.params()["embedder"], model.state.tree()["embedder"]
    x = rand(torch.Generator().manual_seed(51), 3, 1250, 6, device=dev)
    folds, wmma = dgcnn_cuda.DGCNN_FOLDS, _build.GEMM_WMMA_LAUNCHES
    with torch.no_grad():
        for _ in range(3):
            before = b4_b2_launches()
            got = dgcnn_cuda.fused_dgcnn_encoder(x, params, state, k=40, cast=torch.bfloat16)
            torch.cuda.synchronize()
            assert b4_b2_launches() - before == 10
        ref = dgcnn_cuda.fused_dgcnn_encoder_plain(x, params, state, k=40, cast=torch.bfloat16)
    assert dgcnn_cuda.DGCNN_FOLDS == folds + 1 and _build.GEMM_WMMA_LAUNCHES == wmma
    d = (got.float() - ref.float()).abs()
    assert float(d.mean()) <= 1e-3 and float((d > 0.1).float().mean()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("preset,items,n", [("dulcet-universe", 1, 1037),
                                            ("dulcet-universe", 3, 1250),
                                            ("helpful-sponge", 1, 1037),
                                            ("helpful-sponge", 3, 1250),
                                            ("swept-energy", 1, 1037)])
def test_fused_augmenter_full_width_ragged_matches_plain(dev, preset, items, n):
    """B2 at the shipped widths (with extra context and without, the
    context per point or the broadcast embedding) at row counts that are
    not a multiple of 64 against its plain version: 5 launches a call, one
    fold over repeated calls."""
    model = preset_model(dev, preset)
    cfg = model.config
    ed = int(cfg["using_extra_context"])
    g = torch.Generator().manual_seed(52)
    x, eps = rand(g, items, n, 6, device=dev), rand(g, items, n, 294, device=dev)
    extra = rand(g, items, 1, 1, device=dev).expand(items, n, 1) if ed else None
    e = cfg["input_embedding_dim"]
    ctx = (rand(g, items, 1, e, device=dev).bfloat16().expand(items, n, e) if model.is_global
           else rand(g, items, 1250, e, device=dev).bfloat16())
    folds = flc.AUGMENTER_FOLDS
    with torch.no_grad():
        for _ in range(3):
            w = flc.augmenter_weights(model.params()["augmenter"], input_dim=6, extra_dim=ed)
            before = b4_b2_launches()
            z, ldj = flc.fused_augmenter(x, eps, ctx, extra, w)
            torch.cuda.synchronize()
            assert b4_b2_launches() - before == 5
        zr, lr = flc.fused_augmenter_plain(x, eps, ctx, extra, w)
    assert flc.AUGMENTER_FOLDS == folds + 1
    assert float((z - zr).abs().max()) <= 0.02
    assert float(((ldj - lr).abs() / lr.abs().clamp_min(1.0)).max()) <= 1e-4


def flow_kernel_launches() -> tuple:
    from flowcompare_tpu_torch.ops import flow_layer_vjp_cuda as fvc
    return (flc.FUSED_FLOW_LAYERS_LAUNCHES, flc.FUSED_AUGMENTER_LAUNCHES,
            flc.FUSED_FLOW_LAYERS_INVERSE_LAUNCHES, fvc.FLOW_LAYERS_BWD_LAUNCHES)


@pytest.mark.cuda
def test_flow_kernel_wrappers_refuse_non_gelu_on_the_card(dev):
    """B1, B2, B5 and B7 compute GELU only: asked for another nonlinearity
    on CUDA tensors they raise and launch nothing."""
    from flowcompare_tpu_torch.ops import flow_layer_vjp_cuda as fvc
    model = tiny_model(dev)
    folded = model._folded(model.params(), 1)
    folded_inv = model._folded_inverse(model.params(), 1)
    g = torch.Generator().manual_seed(60)
    x, ldj = rand(g, 2, N_POINTS, 32, device=dev), rand(g, 2, N_POINTS, device=dev)
    ctx = rand(g, 2, N_CONTEXT, 16, device=dev).bfloat16()
    extra = rand(g, 2, N_POINTS, 1, device=dev)
    xa, eps = rand(g, 2, N_POINTS, 6, device=dev), rand(g, 2, N_POINTS, 26, device=dev)
    w = flc.augmenter_weights(model.params()["augmenter"], input_dim=6, extra_dim=1)
    saves = torch.zeros(3, 2 * N_POINTS, 32, dtype=torch.bfloat16, device=dev)
    before = flow_kernel_launches()
    for nonlin in ("RELU", "ELU", "LeakyReLU0.2"):
        for call in (lambda: flc.fused_flow_layers(x, ldj, ctx, extra, folded, nonlin=nonlin),
                     lambda: fvc.fused_flow_layers_trainable(x, ldj, ctx, extra, folded,
                                                             nonlin=nonlin),
                     lambda: fvc.flow_layers_bwd(saves, x, ldj, ctx, extra, folded,
                                                 nonlin=nonlin),
                     lambda: flc.fused_flow_layers_inverse(x, ctx, extra, folded_inv,
                                                           nonlin=nonlin),
                     lambda: flc.fused_augmenter(xa, eps, ctx, extra, w, nonlin=nonlin)):
            with pytest.raises(ValueError, match="GELU only"):
                call()
    torch.cuda.synchronize()
    assert flow_kernel_launches() == before


@pytest.mark.cuda
def test_relu_bf16_log_prob_is_the_folded_scan_on_the_card(dev):
    """A RELU config on the folded layout under bf16: `log_prob` on the card
    is the unfused augmenter and `folded_scan_core` with RELU, element for
    element, and launches none of B1, B2, B5 and B7, in eval and training."""
    from flowcompare_tpu_torch.flows import augment
    from flowcompare_tpu_torch.flows.distributions import standard_normal_logprob
    model = tiny_model(dev, coupling_block_nonlinearity="RELU")
    g = torch.Generator().manual_seed(61)
    x0 = rand(g, 2, N_CONTEXT, 6, device=dev)
    x = rand(g, 2, N_POINTS, 6, device=dev)
    extra = rand(g, 2, 1, 1, device=dev).expand(2, N_POINTS, 1)
    eps = rand(g, 2, N_POINTS, 26, device=dev)
    before = flow_kernel_launches()
    with torch.no_grad():
        ctx, _ = model.embed(x0)
        got = model.log_prob(x, ctx, extra, eps)
        params = model.params()
        z, ldj = augment.augment_attn_forward(params["augmenter"], x, ctx, extra, eps,
                                              nonlin=F.relu, dtype=torch.bfloat16)
        z, ldj = flc.folded_scan_core(z, ldj.float(), ctx, extra, model._folded(params, 1),
                                      nonlin=F.relu, dtype=torch.bfloat16)
        ref = ldj + standard_normal_logprob(z)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    loss = -model.log_prob(x, ctx, extra, eps, training=True).mean()
    loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and flow_kernel_launches() == before


@pytest.mark.cuda
def test_shared_memory_mirrors_equal_the_library(dev):
    """`routes`' Python mirrors of the kernels' shared-memory formulas give
    the library's own numbers over a grid of shapes: B3/B6's per (n, C),
    B8's per n over the four PAConv levels and one, B9's selection per n
    and its gather per (C, k, element size)."""
    from flowcompare_tpu_torch import routes
    lib = _build.library()
    ns = [1, 7, 31, 32, 33, 80, 256, 640, 1250, 2047, 2048, 2049, 3200, 3213, 4458, 4459,
          8000, 12661, 15000]
    for n in ns:
        for cq in (1, 2, 6, 8, 15, 16, 17, 64, 128, 255, 256, 257):
            assert routes.knn_smem_bytes(n, cq) == lib.fc_knn_edge_max_smem(n, cq), (n, cq)
        ms = [max(1, n // 4 ** (i + 1)) for i in range(4)]
        for levels in (ms, ms[:1]):
            m4 = levels + [1] * (4 - len(levels))
            assert routes.fps_levels_smem(n, levels) == lib.fc_fps_levels_smem(
                n, len(levels), *m4), (n, levels)
        assert routes.sa_select_smem(n) == lib.fc_sa_select_smem(n), n
    for c in (0, 3, 61, 64, 128, 256, 509, 1000, 2045, 4000):
        for k in (1, 8, 32, 64):
            for esize in (2, 4):
                assert routes.sa_gather_smem(c, k, esize) == lib.fc_sa_gather_smem(c, k, esize), \
                    (c, k, esize)


@pytest.mark.cuda
@pytest.mark.parametrize("overrides,refused", [
    ({"cross_dim_head": 32}, {"stack", "augmenter"}),
    ({"hidden_dims": [1024, 1024, 1024]}, {"stack", "augmenter"}),
    ({"n_neighbors": 72}, {"encoder"})])
def test_refused_parts_run_plain_on_the_card(dev, overrides, refused):
    """A config the kernels refuse part by part (ROADMAP queue C1) runs on
    CUDA tensors: `log_prob`, one training step and `sample` equal the
    model with plain=True within 0.01 nats, and the refused parts' kernels
    never launch."""
    from flowcompare_tpu_torch.model import inner_loop
    from flowcompare_tpu_torch.ops import edgeconv_vjp_cuda, flow_layer_vjp_cuda
    model = tiny_model(dev, **overrides)
    assert {p for p, r in model.routes.items() if r != "kernels"} == refused, dict(model.routes)
    counters = {"stack": [(flc, "FUSED_FLOW_LAYERS_LAUNCHES"),
                          (flc, "FUSED_FLOW_LAYERS_INVERSE_LAUNCHES"),
                          (flow_layer_vjp_cuda, "FLOW_LAYERS_BWD_LAUNCHES")],
                "augmenter": [(flc, "FUSED_AUGMENTER_LAUNCHES")],
                "encoder": [(dgcnn_cuda, "FUSED_DGCNN_ENCODER_LAUNCHES"),
                            (edgeconv_vjp_cuda, "EDGE_KNN_REDUCE_LAUNCHES")]}
    watched = [c for part in refused for c in counters[part]]
    before = [getattr(m, a) for m, a in watched]
    g = torch.Generator().manual_seed(71)
    batch = (rand(g, 2, N_CONTEXT, 6, device=dev), rand(g, 2, N_POINTS, 6, device=dev),
             rand(g, 2, 1, device=dev))
    eps = rand(g, 2, N_POINTS, 26, device=dev)
    z = rand(g, 1, 200, 32, device=dev)
    nats, steps, xs = [], [], []
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    for plain in (False, True):
        model.plain = plain
        model.load_state_dict(snapshot)
        with torch.no_grad():
            nats.append(float(inner_loop(model, batch, eps=eps)[2]))
            xs.append(ft.make_sample(model, 200, batch[0][:1], batch[2][:1], z=z))
        steps.append(ft.train_step(ft.init_train_state(model), batch, eps=eps)[1])
    torch.cuda.synchronize()
    assert [getattr(m, a) for m, a in watched] == before
    assert abs(nats[0] - nats[1]) <= 0.01
    assert abs(steps[0]["nats"] - steps[1]["nats"]) <= 0.01
    model.plain = False
    eps_s = rand(g, 1, 200, 26, device=dev)
    with torch.no_grad():
        snats = [float(inner_loop(model, (batch[0][:1], x, batch[2][:1]), eps=eps_s)[2])
                 for x in xs]
    assert all(torch.isfinite(x).all() for x in xs) and abs(snats[0] - snats[1]) <= 0.01


@pytest.mark.cuda
def test_fps_subsample_launches_b8_once(dev):
    """`ops.fps_subsample` on a CUDA tensor is one B8 launch, index-equal to
    its CPU path (the plain version) on a cloud with repeated points."""
    from flowcompare_tpu_torch import ops
    from flowcompare_tpu_torch.ops import fps_cuda
    g = torch.Generator().manual_seed(81)
    cloud = torch.cat([torch.randint(0, 4, (2, 600, 3), generator=g).float(),
                       torch.randn(2, 600, 3, generator=g)], -1)
    before = fps_cuda.FPS_LAUNCHES
    got = ops.fps_subsample(cloud.to(dev), 150)
    torch.cuda.synchronize()
    assert fps_cuda.FPS_LAUNCHES == before + 1
    torch.testing.assert_close(got.cpu(), ops.fps_subsample(cloud, 150), rtol=0, atol=0)
