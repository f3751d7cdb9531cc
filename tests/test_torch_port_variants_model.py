"""Port parity, the flow variants no preset uses, through the model: log-probs.

Each case of `VARIANT_CASES` (tests/torch_port_fixtures.py: the overrides
of tests/test_model.py, the exp scale, RELU on the folded layout, the
identity, standard-normal and non-attention augmenters, CIF and config
folded_scan=False, all on the "idenity" (sic) embedder) is a tiny JAX
model whose `init_params` draw is moved off its identity init with seeded
numpy noise (integer leaves kept) and loaded into the port with
`load_jax_params`. inner_loop's per-point log-probs and nats are held to
the JAX package's under both precision policies on the draws JAX makes from
its keys (for CIF the key split of `_layer_keys`, handed over as explicit
noise): float32 to summation order and the JAX package's polynomial GELU
(3.2e-6 from the exact erf), bf16 to bf16 rounding at different points
(tests/test_torch_port_slice.py's tolerances). Also: the refusals against
the JAX model's, the integer leaves through `load_jax_params`, the noise
shapes, and the RELU route with the GELU-only kernels refusing it.
tests/test_torch_port_variants_sample.py holds sampling and eval,
tests/test_torch_port_variants_train.py the data init and training.
"""

import jax
import numpy as np
import pytest
import torch

import flowcompare_tpu_torch as ft
from flowcompare_tpu.model import FlowCompareModel as JaxModel
from flowcompare_tpu.model import inner_loop as jax_inner_loop
from flowcompare_tpu_torch.model import draw_noise
from flowcompare_tpu_torch.ops import flow_layer_cuda as flc
from flowcompare_tpu_torch.ops import flow_layer_vjp_cuda as fvc
from torch_port_fixtures import (VARIANT_CASES, VARIANT_INPUT, jax_draws, n, t, variant_batch,
                                 variant_config, variant_pair)

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(VARIANT_CASES))
def test_inner_loop_matches_jax(case, dtype):
    cfg, jm, jparams, jstate, pm = variant_pair(case, dtype)
    batch = variant_batch(cfg)
    key = jax.random.PRNGKey(11)
    _, lpr, natsr, _ = jax_inner_loop(jm, jparams, jstate, batch, rng=key)
    _, lp, nats, _ = ft.inner_loop(pm, tuple(map(t, batch)),
                                   eps=jax_draws(pm, key, 2, cfg["sample_size"]))
    assert lp.shape == (2, cfg["sample_size"]) and torch.isfinite(lp).all()
    if dtype == "float32":
        np.testing.assert_allclose(n(lp), n(lpr), rtol=1e-4, atol=2e-3)
        assert abs(float(nats) - float(natsr)) < 1e-4
    else:
        np.testing.assert_allclose(n(lp), n(lpr), rtol=2e-2, atol=1.0)
        assert abs(float(nats) - float(natsr)) < 1e-2


def test_load_jax_params_copies_integer_leaves_exactly():
    cfg, _, jparams, _, pm = variant_pair("random_permute", "float32")
    sd = pm.state_dict()
    for leaf in ("permutation", "inv_permutation"):
        got = sd[f"layers.permuter.{leaf}"]
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jparams["layers"]["permuter"][leaf]))
    assert "layers.permuter.permutation" not in dict(pm.named_parameters())
    assert all(p.is_floating_point() for p in pm.parameters())
    bad = jax.tree_util.tree_map(np.asarray, jparams)
    bad["layers"]["permuter"]["permutation"] = bad["layers"]["permuter"]["permutation"] + 0.5
    with pytest.raises(TypeError, match="integer buffer"):
        ft.load_jax_params(ft.FlowCompareModel(cfg, device="cpu"), bad, {"embedder": {}})


# Configurations both packages refuse, with the JAX package's exception.
REFUSALS = {
    "latent_below_input": ({"latent_dim": 3, "cif_latent_dim": 3}, ValueError),
    "cif_below_latent": ({"cif_latent_dim": 6}, ValueError),
    "cif_with_extra_context": ({"cif_latent_dim": 12}, ValueError),
    "cif_with_global": ({"cif_latent_dim": 12, "extra_z_value_context": False,
                         "input_embedder": "DGCNNembedderGlobal"}, ValueError),
    "flow_type": ({"flow_type": "PlanarFlow"}, ValueError),
    "permuter_type": ({"permuter_type": "Shuffle"}, ValueError),
    "augmenter_dist": ({"augmenter_dist": "Uniform"}, ValueError),
    "input_embedder": ({"input_embedder": "PointNet"}, ValueError),
    "nonlinearity": ({"coupling_block_nonlinearity": "Swish"}, KeyError),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_jax(case):
    overrides, exc = REFUSALS[case]
    cfg = variant_config(**overrides)
    with pytest.raises(exc):
        JaxModel(cfg).init_params(jax.random.PRNGKey(0))
    with pytest.raises(exc):
        ft.FlowCompareModel(cfg, device="cpu")


def test_noise_shapes_and_their_draws():
    cif = variant_pair("cif", "float32")[4]
    assert variant_pair("attention_extra", "float32")[4].noise_shapes(3, 5) == (3, 5, 4)
    assert variant_pair("attention_extra", "float32")[4].noise_shapes(
        3, 5, sampling=True) == (3, 5, 8)
    assert variant_pair("identity_augmenter", "float32")[4].noise_shapes(3, 5) == (3, 5, 0)
    assert cif.noise_shapes(3, 5) == {"augment": (3, 5, 4), "cif": (3, 3, 5, 4)}
    assert cif.noise_shapes(1, 7, sampling=True) == {"z": (1, 7, 8), "cif": (3, 1, 7, 4)}
    g = torch.Generator().manual_seed(0)
    draw = draw_noise(cif.noise_shapes(1, 7, sampling=True), generator=g, sample_std=0.6)
    assert draw["z"].shape == (1, 7, 8) and draw["cif"].shape == (3, 1, 7, 4)
    with pytest.raises(ValueError, match="noise of shape"):
        ft.inner_loop(cif, tuple(map(t, variant_batch(cif.config))), eps=torch.zeros(2, 16, 4))


def test_relu_takes_the_folded_scan_and_the_kernels_refuse_it():
    """RELU on the folded layout runs `folded_scan_core` with RELU under bf16
    (the JAX package's semantics off the TPU); B1, B2, B5 and B7's wrappers
    and plain versions raise when asked for it. Its GELU twin takes the
    kernels' route at the kernels' attention head width (64); at the
    fixtures' width 8 the shapes refuse it (`routes`)."""
    pm = variant_pair("relu_folded", "bfloat16")[4]
    assert pm._can_fold_scan() and not pm._kernel_route()
    gelu_d64 = ft.FlowCompareModel(variant_config("bfloat16", cross_dim_head=64), device="cpu")
    assert gelu_d64._kernel_route() and gelu_d64._kernel_route("augmenter")
    assert not variant_pair("attention_extra", "bfloat16")[4]._kernel_route()
    assert not variant_pair("folded_scan_off", "bfloat16")[4]._can_fold_scan()
    folded = pm._folded(pm.params(), 1)
    x, ldj = torch.zeros(1, 4, 8), torch.zeros(1, 4)
    ctx, extra = torch.zeros(1, 6, VARIANT_INPUT), torch.zeros(1, 4, 1)
    calls = [lambda: flc.fused_flow_layers(x, ldj, ctx, extra, folded, nonlin="RELU"),
             lambda: flc.fused_flow_layers_plain(x, ldj, ctx, extra, folded, nonlin="RELU"),
             lambda: fvc.fused_flow_layers_trainable(x, ldj, ctx, extra, folded, nonlin="RELU"),
             lambda: fvc.flow_layers_bwd(None, x, ldj, ctx, extra, folded, nonlin="RELU"),
             lambda: flc.fused_flow_layers_inverse(x, ctx, extra, folded, nonlin="RELU"),
             lambda: flc.fused_flow_layers_inverse_plain(x, ctx, extra, folded, nonlin="RELU"),
             lambda: flc.fused_augmenter(x, x, ctx, extra, None, nonlin="ELU"),
             lambda: flc.fused_augmenter_plain(x, x, ctx, extra, None, nonlin="ELU")]
    for call in calls:
        with pytest.raises(ValueError, match="GELU only"):
            call()
