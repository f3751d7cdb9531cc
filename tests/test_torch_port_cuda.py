"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc: it skips without one (the
kernels have no CPU mode; on the CPU each wrapper runs its plain version,
which tests/test_torch_port_{core,encoder,flow,slice}.py hold against the
JAX package). The file imports no JAX, so it runs where JAX is absent:

    python -m pytest -m cuda tests/test_torch_port_cuda.py

Shapes are the CPU tests' tiny dulcet-universe (3 layers, latent 32, N=64,
Nc=80, k=8) with the attention head at its real width 64; chip_smoke.py
checks the same kernels at the full model's shapes.
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


def tiny_model(device) -> ft.FlowCompareModel:
    cfg = ft.get_config("dulcet-universe")
    cfg.update(dict(
        n_flow_layers=3, latent_dim=32, cif_latent_dim=32,
        hidden_dims=[64, 64, 64], net_augmenter_dist_hidden_dims=[64, 64, 64],
        pre_attention_mlp_hidden_dims=[32, 32, 32],
        hidden_dims_embedder_out=[64, 64, 64, 64, 64, 64],
        attn_dim=48, attn_input_dim=32, input_embedding_dim=16, cross_dim_head=64,
        sample_size=N_POINTS, n_samples_context=N_CONTEXT, n_neighbors=K,
        compute_dtype="bfloat16"))
    model = ft.FlowCompareModel(cfg, generator=torch.Generator().manual_seed(0))
    perturb_identity_leaves(model, torch.Generator().manual_seed(1))
    return model.to(device)


def perturb_identity_leaves(model, gen) -> None:
    """Move LinearLU, ActNorm and BatchNorm off their identity init."""
    with torch.no_grad():
        for name, p in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("lower_entries", "upper_entries", "unconstrained_upper_diag",
                        "shift", "log_scale", "mean"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
            elif leaf == "var":
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))
            elif name.endswith("bn.scale"):
                p.copy_(torch.sign(torch.randn(p.shape, generator=gen))
                        * (0.5 + torch.rand(p.shape, generator=gen)))


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
    assert float(err.max()) < 6e-2 and float(err.mean()) < 4e-3


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
