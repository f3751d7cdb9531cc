"""Port parity, the DGCNN encoder: gather formulation, B3 and B4.

CPU tests hold the port against the JAX package: the float32 gather
encoder against `apply_dgcnn`; B3's plain version against the Pallas
`edge_neighbor_max` in interpret mode; B4's plain version against
`fused_dgcnn_encoder` in interpret mode, run the way
tests/test_pallas_kernels.py runs it. tests/test_torch_port_cuda.py holds
the CUDA kernels against these plain versions on the card.
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

from flowcompare_tpu.encoders import dgcnn as jdg
from flowcompare_tpu.ops import edgeconv_pallas as jep
from flowcompare_tpu_torch.core.mlp import cast_tree
from flowcompare_tpu_torch.encoders import dgcnn
from flowcompare_tpu_torch.ops import dgcnn_cuda, edgeconv_cuda
from torch_port_fixtures import K_NEIGHBORS, N_CONTEXT, model_pair, n, normal, t

torch.set_num_threads(2)


def _encoder_params():
    cfg, jm, jparams, jstate, pm = model_pair()
    return jparams["embedder"], jstate["embedder"], pm


def test_gather_encoder_f32_matches_jax():
    jp, js, pm = _encoder_params()
    x = normal(np.random.default_rng(0), 2, N_CONTEXT, 6)
    ref, _ = jdg.apply_dgcnn(jp, js, jnp.asarray(x), n_neighbors=K_NEIGHBORS, training=False)
    got = pm.embed(t(x))
    # float32; the head's GELU is the JAX polynomial (3.2e-6) vs exact erf
    np.testing.assert_allclose(n(got), n(ref), atol=2e-4, rtol=1e-4)


def test_edge_neighbor_max_plain_exact_on_integer_inputs():
    """Integer-valued features: every distance is exact, so the selection
    (ties included, lower index first) must match the Pallas kernel bit for bit."""
    rng = np.random.default_rng(1)
    x = rng.integers(-4, 5, (2, N_CONTEXT, 6)).astype(np.float32)
    u = rng.normal(size=(2, N_CONTEXT, 64)).astype(np.float32)
    ref = jep.edge_neighbor_max(jnp.asarray(x, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16),
                                K_NEIGHBORS, interpret=True)
    got = edgeconv_cuda.edge_neighbor_max(t(x).bfloat16(), t(u).bfloat16(), K_NEIGHBORS)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(got), n(ref))


def test_edge_neighbor_max_plain_random_within_mismatch_budget():
    """Random bf16 features: a different f32 summation order may flip a
    near-tied k-th neighbour. Budget: at most 1% of rows differ."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, N_CONTEXT, 64)).astype(np.float32)
    u = rng.normal(size=(2, N_CONTEXT, 128)).astype(np.float32)
    ref = n(jep.edge_neighbor_max(jnp.asarray(x, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16),
                                  K_NEIGHBORS, interpret=True))
    got = n(edgeconv_cuda.edge_neighbor_max(t(x), t(u), K_NEIGHBORS))
    rows_differ = (got != ref).any(-1).mean()
    assert rows_differ <= 0.01, rows_differ


def test_fused_dgcnn_encoder_plain_matches_jax_interpret():
    jp, js, pm = _encoder_params()
    x = normal(np.random.default_rng(3), 2, N_CONTEXT, 6)
    orig_enm = jep.edge_neighbor_max
    jep.edge_neighbor_max = functools.partial(orig_enm, interpret=True)
    jdg._FORCE_FUSED_EVAL_INTERPRET = True
    try:
        ref, _ = jdg.apply_dgcnn(jp, js, jnp.asarray(x), n_neighbors=K_NEIGHBORS,
                                 training=False, dtype=jnp.bfloat16, fused=True)
    finally:
        jep.edge_neighbor_max = orig_enm
        jdg._FORCE_FUSED_EVAL_INTERPRET = False
    params = cast_tree(pm.params()["embedder"], torch.bfloat16)
    got = dgcnn_cuda.fused_dgcnn_encoder(t(x), params, pm.state.tree()["embedder"],
                                         k=K_NEIGHBORS)
    assert got.dtype == torch.bfloat16 and got.shape == (2, N_CONTEXT, 16)
    # bf16 outputs of O(1): two bf16 ulps, plus the deg-2 polynomial GELU
    # of the Pallas head (2.5e-5) against exact erf
    err = np.abs(n(got) - n(ref))
    assert err.max() < 6e-2 and err.mean() < 4e-3, (err.max(), err.mean())


def test_fused_edge_stage_matches_gather_stage():
    """One stage through B3's algebra (u_j + c_i, sign fold, monotone BN)
    equals the gather stage (edge tensor, conv, BN, leaky, max over K)."""
    jp, js, pm = _encoder_params()
    params = pm.params()["embedder"]
    state = pm.state.tree()["embedder"]
    # integer-valued points: both select on exact distances, so the kNN sets agree
    h = t(np.random.default_rng(4).integers(-4, 5, (2, N_CONTEXT, 6)))
    got = dgcnn.fused_edge_stage(params["conv1"], state["bn1"], h, K_NEIGHBORS)
    e = dgcnn.edge_features(h, K_NEIGHBORS)
    ref = dgcnn._conv_bn_leaky(params["conv1"], state["bn1"], e).amax(2)
    # B3 returns the max of u in bf16 (as the Pallas kernel does): relative
    # 2^-9 rounding of |u| <= ~6, scaled by the BN slope (<= ~2)
    np.testing.assert_allclose(n(got), n(ref), atol=3e-2, rtol=1e-2)
