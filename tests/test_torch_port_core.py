"""Port parity, small modules: presets, core, kNN, flows, weight loading.

Each test feeds the same numpy inputs, made from a seed, to the JAX
function and its counterpart in flowcompare_tpu_torch, on the CPU.
Tolerances: float32 paths agree to summation order (rtol 1e-5); where a
JAX function uses its logit-polynomial GELU (at most 3.2e-6 from the exact
erf GELU the port uses) the bound is 1e-4.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flowcompare_tpu_torch as ft
from flowcompare_tpu.configs import presets as jax_presets
from flowcompare_tpu.core import attention as jattn
from flowcompare_tpu.core import batchnorm as jbn
from flowcompare_tpu.core import mlp as jmlp
from flowcompare_tpu.flows import actnorm as jactnorm
from flowcompare_tpu.flows import augment as jaugment
from flowcompare_tpu.flows import coupling as jcoupling
from flowcompare_tpu.flows import distributions as jdist
from flowcompare_tpu.flows import permuters as jperm
from flowcompare_tpu.ops import knn as jknn
from flowcompare_tpu_torch.configs import presets
from flowcompare_tpu_torch.core import attention, batchnorm, mlp
from flowcompare_tpu_torch.core.initializers import torch_linear
from flowcompare_tpu_torch.flows import actnorm, augment, coupling, distributions, permuters
from flowcompare_tpu_torch.ops import knn
from torch_port_fixtures import model_pair, n, normal, t

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _ttree(tree):
    return jax.tree_util.tree_map(t, tree)


def _mlp_params(rng, dims):
    """numpy MLP params in the JAX layout: {"in", "hidden": [...], "out"}."""
    def lin(i, o):
        return {"w": normal(rng, i, o) / np.sqrt(i), "b": normal(rng, o) * 0.1}
    return {"in": lin(dims[0], dims[1]),
            "hidden": [lin(dims[i], dims[i + 1]) for i in range(1, len(dims) - 2)],
            "out": lin(dims[-2], dims[-1])}


@pytest.mark.parametrize("name", sorted(jax_presets.PRESETS))
def test_presets_equal_jax(name):
    assert presets._BASE == jax_presets._BASE
    assert presets.PRESETS[name] == jax_presets.PRESETS[name]
    assert presets.get_config(name) == jax_presets.get_config(name)


def test_torch_linear_init_distribution():
    p = torch_linear(torch.Generator().manual_seed(0), 64, 32)
    assert p["w"].shape == (64, 32) and p["b"].shape == (32,)
    bound = 1 / 8
    assert float(p["w"].abs().max()) <= bound and float(p["w"].abs().max()) > 0.9 * bound


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_apply_mlp_matches_jax(dtype):
    rng = np.random.default_rng(0)
    p = _mlp_params(rng, [12, 32, 32, 32, 32, 8])
    x = normal(rng, 2, 16, 12)
    jd = None if dtype is None else jnp.bfloat16
    td = None if dtype is None else torch.bfloat16
    ref = jmlp.apply_mlp(_jtree(p), jnp.asarray(x), jmlp.gelu, dtype=jd)
    got = mlp.apply_mlp(_ttree(p), t(x), mlp.gelu, dtype=td)
    # float32: the polynomial GELU's 3.2e-6; bf16: a few bf16 ulps of O(1) values
    tol = 1e-4 if dtype is None else 3e-2
    np.testing.assert_allclose(n(got), n(ref), atol=tol, rtol=tol)


def test_gelu_is_exact_erf_and_within_poly_bound():
    x = np.linspace(-8, 8, 2001, dtype=np.float32)
    got = n(mlp.gelu(t(x)))
    np.testing.assert_allclose(got, n(torch.nn.functional.gelu(t(x))), rtol=0, atol=0)
    np.testing.assert_allclose(got, n(jmlp.gelu(jnp.asarray(x))), atol=4e-6)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_cross_attention_matches_jax(dtype):
    rng = np.random.default_rng(1)
    p = {"norm": {"scale": 1 + 0.1 * normal(rng, 32), "bias": 0.1 * normal(rng, 32)},
         "to_q": {"w": normal(rng, 32, 64) / 6}, "to_kv": {"w": normal(rng, 16, 128) / 4},
         "out": {"w": normal(rng, 64, 48) / 8, "b": 0.1 * normal(rng, 48)}}
    x, ctx = normal(rng, 2, 24, 32), normal(rng, 2, 40, 16)
    jd = None if dtype is None else jnp.bfloat16
    td = None if dtype is None else torch.bfloat16
    ref = jattn.apply_cross_attention(_jtree(p), jnp.asarray(x), jnp.asarray(ctx), dtype=jd)
    got = attention.apply_cross_attention(_ttree(p), t(x), t(ctx), dtype=td)
    tol = 1e-5 if dtype is None else 3e-2   # bf16: rounding of q, k, v and the output
    np.testing.assert_allclose(n(got), n(ref), atol=tol, rtol=tol)
    ln = attention.apply_layer_norm(_ttree(p["norm"]), t(x))
    np.testing.assert_allclose(n(ln), n(jattn.apply_layer_norm(_jtree(p["norm"]),
                                                               jnp.asarray(x))), atol=1e-5)


def test_batchnorm_eval_matches_jax():
    rng = np.random.default_rng(2)
    p = {"scale": normal(rng, 8), "bias": normal(rng, 8)}
    s = {"mean": normal(rng, 8), "var": rng.uniform(0.5, 2, 8).astype(np.float32)}
    x = normal(rng, 3, 5, 8)
    ref, _ = jbn.apply_batchnorm(_jtree(p), _jtree(s), jnp.asarray(x), training=False)
    got = batchnorm.apply_batchnorm(_ttree(p), _ttree(s), t(x))
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-5, atol=1e-6)


def test_knn_matches_jax():
    rng = np.random.default_rng(3)
    x = normal(rng, 2, 80, 6)
    np.testing.assert_allclose(n(knn.pairwise_sqdist(t(x), t(x))),
                               n(jknn.pairwise_sqdist(jnp.asarray(x), jnp.asarray(x))),
                               atol=1e-4)
    idx = knn.knn_self(t(x), 8)
    ref = np.asarray(jknn.knn_self(jnp.asarray(x), 8))
    # same neighbour sets (random data has no exact ties)
    assert (np.sort(idx.numpy(), -1) == np.sort(ref, -1)).all()
    feats = normal(rng, 2, 80, 5)
    np.testing.assert_array_equal(
        n(knn.gather_neighbors(t(feats), idx)),
        n(jknn.gather_neighbors(jnp.asarray(feats), jnp.asarray(idx.numpy(), jnp.int32))))


def test_knn_self_ties_go_to_lower_index():
    x = torch.zeros(1, 6, 2)
    x[0, 3:] = 5.0                            # rows 0-2 coincide, rows 3-5 coincide
    idx = knn.knn_self(x, 4)
    assert idx[0, 0].tolist() == [0, 1, 2, 3]
    assert idx[0, 4].tolist() == [3, 4, 5, 0]


def test_distributions_match_jax():
    rng = np.random.default_rng(4)
    x, loc = normal(rng, 2, 7, 5), normal(rng, 2, 7, 5)
    scale = rng.uniform(0.5, 2, (2, 7, 5)).astype(np.float32)
    np.testing.assert_allclose(n(distributions.standard_normal_logprob(t(x))),
                               n(jdist.standard_normal_logprob(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(
        n(distributions.normal_logprob(t(x), t(loc), t(scale))),
        n(jdist.normal_logprob(jnp.asarray(x), jnp.asarray(loc), jnp.asarray(scale))),
        rtol=1e-5)


def test_actnorm_and_linear_lu_match_jax():
    rng = np.random.default_rng(5)
    d = 12
    an = {"shift": normal(rng, 1, d), "log_scale": 0.1 * normal(rng, 1, d)}
    x = normal(rng, 2, 9, d)
    z, ldj = actnorm.actnorm_forward(_ttree(an), t(x))
    zr, ldjr = jactnorm.actnorm_forward(_jtree(an), jnp.asarray(x))
    np.testing.assert_allclose(n(z), n(zr), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(ldj), n(ldjr), rtol=1e-6)

    init = permuters.init_linear_lu(d, eps=1e-5)
    jinit = jperm.init_linear_lu(d, eps=1e-5)
    for k in init:
        np.testing.assert_allclose(n(init[k]), n(jinit[k]), rtol=1e-6)
    lu = {k: n(v) + rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
          for k, v in init.items()}
    z, ldj = permuters.linear_lu_forward(_ttree(lu), t(x), eps=1e-5)
    zr, ldjr = jperm.linear_lu_forward(_jtree(lu), jnp.asarray(x), eps=1e-5)
    np.testing.assert_allclose(n(z), n(zr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(ldj), n(ldjr), rtol=1e-5)
    stack = {k: np.stack([v, v * 0.5]) for k, v in lu.items()}
    got = permuters.linear_lu_prepare_stack(_ttree(stack), eps=1e-5)
    ref = jperm.linear_lu_prepare_stack(_jtree(stack), eps=1e-5)
    np.testing.assert_allclose(n(got["w_folded"]), n(ref["w_folded"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(got["ldj"]), n(ref["ldj"]), rtol=1e-5)


def test_affine_coupling_matches_jax():
    rng = np.random.default_rng(6)
    p = {"nn": _mlp_params(rng, [8 + 5, 32, 32, 32, 16])}
    x, ctx = normal(rng, 2, 10, 16), normal(rng, 2, 10, 5)
    y, ldj = coupling.affine_coupling_forward(_ttree(p), t(x), t(ctx), nonlin=mlp.gelu)
    yr, ldjr = jcoupling.affine_coupling_forward(_jtree(p), jnp.asarray(x), jnp.asarray(ctx),
                                                 nonlin=jmlp.gelu)
    np.testing.assert_allclose(n(y), n(yr), atol=1e-4)     # polynomial GELU
    np.testing.assert_allclose(n(ldj), n(ldjr), atol=1e-4)


def test_augment_attn_forward_matches_jax():
    """eps is an argument in the port: it gets the draw JAX makes inside."""
    cfg, jm, jparams, _, pm = model_pair()
    rng = np.random.default_rng(7)
    x, ctx, extra = normal(rng, 2, 64, 6), normal(rng, 2, 80, 16), normal(rng, 2, 64, 1)
    key = jax.random.PRNGKey(3)
    zr, ldjr = jaugment.augment_attn_forward(jparams["augmenter"], key, jnp.asarray(x),
                                             jnp.asarray(ctx), jnp.asarray(extra),
                                             nonlin=jmlp.gelu)
    eps = jax.random.normal(key, (2, 64, cfg["latent_dim"] - cfg["input_dim"]))
    z, ldj = augment.augment_attn_forward(pm.params()["augmenter"], t(x), t(ctx), t(extra),
                                          t(eps), nonlin=mlp.gelu)
    np.testing.assert_allclose(n(z), n(zr), atol=2e-4)
    np.testing.assert_allclose(n(ldj), n(ldjr), atol=2e-3, rtol=1e-5)


def test_load_jax_params_is_a_key_map():
    cfg, jm, jparams, jstate, pm = model_pair()
    sd = pm.state_dict()
    assert "layers.block.coupling.nn.in.w" in sd and "state.embedder.bn1.mean" in sd
    assert sd["layers.block.coupling.nn.in.w"].shape == (
        cfg["n_flow_layers"] - 1, cfg["latent_dim"] // 2 + 1 + cfg["attn_dim"], 64)
    np.testing.assert_array_equal(n(sd["augmenter.attn.to_kv.w"]),
                                  n(jparams["augmenter"]["attn"]["to_kv"]["w"]))
    broken = jax.tree_util.tree_map(np.asarray, jparams)
    del broken["final_block"]["attn"]["out"]["b"]
    with pytest.raises(KeyError):
        ft.load_jax_params(pm, broken, jax.tree_util.tree_map(np.asarray, jstate))


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['flowcompare_tpu'] = None\n"
            "import flowcompare_tpu_torch, flowcompare_tpu_torch.model\n"
            "import flowcompare_tpu_torch.ops.flow_layer_cuda, flowcompare_tpu_torch.ops.dgcnn_cuda\n"
            "import flowcompare_tpu_torch.ops.flow_layer_vjp_cuda\n"
            "import flowcompare_tpu_torch.ops.edgeconv_vjp_cuda, flowcompare_tpu_torch.train\n"
            "import flowcompare_tpu_torch.cli, flowcompare_tpu_torch.compat\n"
            "import flowcompare_tpu_torch.viz, flowcompare_tpu_torch.train.profiling\n"
            "import chip_smoke\n"
            "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules "
            "if sys.modules[m] is not None)\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_sources_never_import_jax():
    pkg = os.path.join(REPO, "flowcompare_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "examples", "convergence_demo_torch.py")]
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        src = open(path).read()
        assert "import jax" not in src and "from jax" not in src, path
        assert "flowcompare_tpu." not in src.replace("flowcompare_tpu_torch", ""), path
        assert "import flowcompare_tpu\n" not in src, path


def test_kernel_launchers_reject_cpu_tensors():
    """The launch layer takes CUDA tensors only; it never computes on the CPU."""
    from flowcompare_tpu_torch.ops import _build
    a = torch.zeros(4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        _build.gemm(a, a.T.contiguous(), torch.zeros(4, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        _build.knn_edge_max(a, a, a, n_items=1, k=2)


def test_wrappers_take_plain_path_on_cpu_without_counting():
    from flowcompare_tpu_torch.ops import edgeconv_cuda
    before = edgeconv_cuda.EDGE_NEIGHBOR_MAX_LAUNCHES
    gen = torch.Generator().manual_seed(0)
    x, u = torch.randn(1, 20, 3, generator=gen), torch.randn(1, 20, 5, generator=gen)
    torch.testing.assert_close(edgeconv_cuda.edge_neighbor_max(x, u, 4),
                               edgeconv_cuda.edge_neighbor_max_plain(x, u, 4))
    assert edgeconv_cuda.EDGE_NEIGHBOR_MAX_LAUNCHES == before
