"""Port parity, the flow layers and the augmenter: folds, B1 and B2.

CPU tests hold the port against the JAX package: the folds, the float32
`folded_scan_core`, B1's plain version against the Pallas
`fused_flow_layers_t` in interpret mode on one layer (interpret mode is
only safe on one layer: the kernel's aliased carries assume sequential
grid steps) and B2's plain version against the Pallas `fused_augmenter` in
interpret mode. tests/test_torch_port_cuda.py holds the CUDA kernels
against these plain versions on the card.
"""

import numpy as np
import torch

import jax.numpy as jnp

from flowcompare_tpu.core.mlp import gelu as jgelu
from flowcompare_tpu.ops import flow_layer_pallas as flp
from flowcompare_tpu_torch.core.mlp import gelu
from flowcompare_tpu_torch.ops import flow_layer_cuda as flc
from torch_port_fixtures import N_CONTEXT, N_POINTS, model_pair, n, normal, t

torch.set_num_threads(2)


def _folded_pair(dtype="float32"):
    cfg, jm, jparams, _, pm = model_pair(dtype)
    lat = cfg["latent_dim"]
    prep = jm._prepare_layers(jparams["layers"])
    stacks = flp.append_final_block(flp.build_layer_stacks(jm, prep),
                                    jparams["final_block"], lat)
    jf = flp.fold_stacks(stacks, split=lat // 2, extra_dim=1)
    return cfg, jparams, jf, pm, pm._folded(pm.params(), 1)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    x = normal(rng, 2, N_POINTS, cfg["latent_dim"])
    ctx = normal(rng, 2, N_CONTEXT, cfg["input_embedding_dim"])
    extra = normal(rng, 2, N_POINTS, 1)
    ldj = normal(rng, 2, N_POINTS)
    return x, ctx, extra, ldj


def _first_layer(folded):
    def sl(v):
        if v is None or isinstance(v, int):
            return v
        if isinstance(v, list):
            return [(w[:1], b[:1]) for w, b in v]
        return v[:1]
    return {k: sl(v) for k, v in folded.items()}


def test_fold_stacks_match_jax():
    cfg, _, jf, _, tf = _folded_pair()
    for key in ("wq_f", "bq_f", "wkv", "cpl_in_xe", "cpl_in_c", "cpl_in_b", "lu_w_f",
                "lu_b", "lu_ldj_f"):
        np.testing.assert_allclose(n(tf[key]), n(jf[key]), rtol=1e-5, atol=1e-6, err_msg=key)
    assert tf["n_cpl"] == jf["n_cpl"]
    assert tf["lu_ldj_f"].shape[0] == cfg["n_flow_layers"]


def test_folded_scan_core_f32_matches_jax():
    cfg, _, jf, _, tf = _folded_pair()
    x, ctx, extra, ldj = _inputs(cfg)
    zr, lr = flp.folded_scan_core(jnp.asarray(x), jnp.asarray(ldj), jnp.asarray(ctx),
                                  jnp.asarray(extra), jf, nonlin=jgelu, remat=False)
    z, l = flc.folded_scan_core(t(x), t(ldj), t(ctx), t(extra), tf, nonlin=gelu)
    # float32 through 3 layers; the JAX polynomial GELU is within 3.2e-6 of erf
    np.testing.assert_allclose(n(z), n(zr), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(n(l), n(lr), atol=2e-4, rtol=1e-5)


def test_fused_flow_layers_plain_matches_pallas_interpret_one_layer():
    cfg, _, jf, _, tf = _folded_pair("bfloat16")
    x, ctx, extra, ldj = _inputs(cfg, seed=1)
    zr, lr = flp.fused_flow_layers_t(jnp.asarray(x), jnp.asarray(ldj), jnp.asarray(ctx),
                                     jnp.asarray(extra), _first_layer(jf), interpret=True)
    z, l = flc.fused_flow_layers(t(x), t(ldj), t(ctx), t(extra), _first_layer(tf))
    # bf16 matmul operands on both sides, different softmax stabiliser
    # (max-subtract vs clamp) and GELU (erf vs deg-2 polynomial, 2.5e-5):
    # the bound of the JAX package's own kernel-vs-scan tests
    assert float(np.abs(n(z) - n(zr)).max()) < 3e-2
    assert float(np.abs(n(l) - n(lr)).max()) < 2e-3


def test_fused_flow_layers_plain_matches_jax_bf16_scan():
    """All three layers: the port's bf16 plain B1 against JAX's bf16 folded scan."""
    cfg, _, jf, _, tf = _folded_pair("bfloat16")
    x, ctx, extra, ldj = _inputs(cfg, seed=2)
    zr, lr = flp.folded_scan_core(jnp.asarray(x), jnp.asarray(ldj), jnp.asarray(ctx),
                                  jnp.asarray(extra), jf, nonlin=jgelu, dtype=jnp.bfloat16,
                                  remat=False)
    z, l = flc.fused_flow_layers(t(x), t(ldj), t(ctx), t(extra), tf)
    # same bf16 policy; bf16 rounding of values near a rounding boundary can
    # flip with the GELU form and propagate through 3 layers
    assert float(np.abs(n(z) - n(zr)).max()) < 5e-2
    assert float(np.abs(n(l) - n(lr)).max()) < 5e-3


def test_fused_augmenter_plain_matches_pallas_interpret():
    cfg, jparams, _, pm, _ = _folded_pair("bfloat16")
    rng = np.random.default_rng(3)
    x = normal(rng, 2, N_POINTS, cfg["input_dim"])
    ctx = normal(rng, 2, N_CONTEXT, cfg["input_embedding_dim"])
    extra = normal(rng, 2, N_POINTS, 1)
    eps = normal(rng, 2, N_POINTS, cfg["latent_dim"] - cfg["input_dim"])
    jfa = flp.fold_augmenter(jparams["augmenter"], input_dim=cfg["input_dim"], extra_dim=1)
    zr, lr = flp.fused_augmenter(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(ctx),
                                 jnp.asarray(extra), jfa, interpret=True)
    tfa = flc.fold_augmenter(pm.params()["augmenter"], input_dim=cfg["input_dim"],
                             extra_dim=1)
    z, l = flc.fused_augmenter(t(x), t(eps), t(ctx), t(extra), tfa)
    # the bound of the JAX package's own kernel-vs-XLA augmenter test
    assert float(np.abs(n(z) - n(zr)).max()) < 1e-2
    assert float(np.abs(n(l) - n(lr)).max()) < 1e-2
