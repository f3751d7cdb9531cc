"""Port parity, the PAConv presets (good-surf, summer-terrain): B8, B9, the
kNN and interpolation helpers, the weight-bank assembly, the encoder, and
the JAX weights carried across.

CPU tests hold the port against the JAX package on the same inputs (numpy,
from a seed) and weights: B8's plain version index-equal to
`furthest_point_sampling` and to `fps_pallas` in interpret mode; B9's plain
version equal to `sa_group_fused` in interpret mode; the encoder in eval
(f32, bf16) and train mode against `apply_pointnet2_paconv`.
tests/test_torch_port_paconv_model.py holds the tiny presets' `inner_loop`,
`evaluate_on_test` and train step against the JAX model, and
tests/test_torch_port_cuda.py the CUDA kernels against these plain versions
on the card.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flowcompare_tpu_torch as ft
from flowcompare_tpu.encoders import paconv as jpa
from flowcompare_tpu.model import FlowCompareModel as JaxModel
from flowcompare_tpu.ops import fps as jfps
from flowcompare_tpu.ops import knn as jknn
from flowcompare_tpu.ops import paconv_ops as jpo
from flowcompare_tpu.ops.fps_pallas import fps_pallas
from flowcompare_tpu.ops.sa_group_pallas import sa_group_fused
from flowcompare_tpu_torch.compat.jax_params import flatten_tree
from flowcompare_tpu_torch.encoders import paconv
from flowcompare_tpu_torch.ops import fps_cuda, knn, paconv_ops, sa_group_cuda
from torch_port_fixtures import PACONV_CONTEXT, n, normal, paconv_pair, t, tiny_paconv_config

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _pair(preset="good-surf", dtype="float32"):
    return paconv_pair(preset, dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


# ------------------------------------------------------------------ B8

def _fps_cases():
    dup = np.concatenate([np.zeros((1, 4, 3)), np.ones((1, 4, 3)), np.zeros((1, 4, 3))], 1)
    cases = [(np.random.default_rng(b * 131 + nn).normal(size=(b, nn, 3)), m)
             for b, nn, m in ((2, 100, 25), (3, 1250, 312), (1, 7, 7))]
    cases.append((dup, 6))                                                # ties: lowest index
    cases.append((np.random.default_rng(5).normal(size=(2, 64, 6)), 16))  # extra channels ignored
    return [(x.astype(np.float32), m) for x, m in cases]


@pytest.mark.parametrize("case", range(5))
def test_fps_plain_index_equal_to_jax_and_pallas(case):
    x, m = _fps_cases()[case]
    got = fps_cuda.furthest_point_sampling(t(x), m)          # CPU tensor: the plain version
    assert got.dtype == torch.int64 and got.shape == (x.shape[0], m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfps.furthest_point_sampling(
        jnp.asarray(x[..., :3]), m)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(fps_pallas(jnp.asarray(x), m,
                                                                     interpret=True)))


@pytest.mark.parametrize("kind", ["duplicated", "duplicated_grid"])
def test_fps_levels_match_jax_sa_level_chain(kind):
    """The port's one levels call (its plain version on CPU tensors) and the
    JAX package's chain of `_sa_level` give the same picks and centres at
    every level, on a cloud of duplicated points."""
    _, _, jp, js, _ = _pair()
    rng = np.random.default_rng(13)
    half = (normal(rng, 2, PACONV_CONTEXT // 2, 6) if kind == "duplicated" else
            rng.integers(-2, 3, size=(2, PACONV_CONTEXT // 2, 6)).astype(np.float32))
    x = np.concatenate([half, half], 1)
    ms = [PACONV_CONTEXT // 4 ** (i + 1) for i in range(4)]
    idxs, centres = fps_cuda.furthest_point_sampling_levels(t(x), ms)
    xyz, feats = jnp.asarray(x[..., :3]), jnp.asarray(x[..., 3:])
    for level, m in enumerate(ms):
        ref_idx = jfps.furthest_point_sampling(xyz, m)
        xyz, feats, _ = jpa._sa_level(jp["embedder"]["sa"][level], js["embedder"]["sa"][level],
                                      xyz, feats, training=False)
        np.testing.assert_array_equal(idxs[level].numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(centres[level].numpy(), np.asarray(xyz))


# ------------------------------------------------------------------ B9

def _sa_inputs(b, nn, m, c, dtype, seed, duplicate=False):
    rng = np.random.default_rng(seed)
    xyz = normal(rng, b, nn // 2 if duplicate else nn, 3)
    if duplicate:
        xyz = np.concatenate([xyz, xyz], 1)                  # every point twice: tie order
    feats = normal(rng, b, nn, c)
    idx = np.stack([rng.permutation(nn)[:m] for _ in range(b)]).astype(np.int32)
    new_xyz = np.take_along_axis(xyz, idx[..., None].astype(np.int64), 1)
    return new_xyz, idx, xyz, jnp.asarray(feats, dtype)


@pytest.mark.parametrize("name,b,nn,m,c,k,dtype,dup", [
    ("bf16", 2, 200, 48, 5, 16, jnp.bfloat16, False),
    ("f32", 2, 200, 48, 5, 16, jnp.float32, False),
    ("duplicates", 1, 160, 16, 4, 12, jnp.bfloat16, True),
    ("n_not_multiple_of_128", 2, 130, 16, 5, 8, jnp.bfloat16, False),
    ("k_exceeds_n", 2, 12, 8, 5, 16, jnp.float32, False),
])
def test_sa_group_plain_equal_to_pallas(name, b, nn, m, c, k, dtype, dup):
    new_xyz, idx, xyz, feats = _sa_inputs(b, nn, m, c, dtype, seed=nn + k, duplicate=dup)
    ref = sa_group_fused(jnp.asarray(new_xyz), jnp.asarray(idx), jnp.asarray(xyz), feats, k,
                         interpret=True)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = sa_group_cuda.sa_group(t(new_xyz), t(idx).long(), t(xyz), t(feats).to(tdt), k)
    assert got.dtype == tdt and got.shape == (b, m, k, 3 + c)
    np.testing.assert_array_equal(n(got), n(ref))          # the same values, slot for slot
    assert (n(got[:, :, 0, :3]) == 0).all()                # slot 0 is the centre


# ------------------------------------------- kNN, interpolation, assembly

def test_knn_indices_self_idx_matches_jax():
    rng = np.random.default_rng(7)
    pts = normal(rng, 2, 90, 3)
    idx = np.stack([rng.permutation(90)[:20] for _ in range(2)])
    q = np.take_along_axis(pts, idx[..., None], 1)
    for k in (8, 95):                                        # k > N pads with 0
        ref = jknn.knn_indices(jnp.asarray(q), jnp.asarray(pts), k,
                               self_idx=jnp.asarray(idx, jnp.int32), impl="topk")
        got = knn.knn_indices(t(q), t(pts), k, self_idx=torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert (got[..., 0].numpy() == idx).all()


@pytest.mark.parametrize("m", [1, 2, 5])
def test_three_nn_interpolate_matches_jax(m):
    """m < 3 (the coarsest level of a small cloud has m = 1) pads with index
    0 at distance 1e20."""
    rng = np.random.default_rng(8 + m)
    unknown, known, feats = normal(rng, 2, 30, 3), normal(rng, 2, m, 3), normal(rng, 2, m, 7)
    for dt, tdt, tol in ((jnp.float32, torch.float32, 1e-6), (jnp.bfloat16, torch.bfloat16, 0)):
        ref = jknn.three_nn_interpolate(jnp.asarray(unknown), jnp.asarray(known),
                                        jnp.asarray(feats, dt))
        got = knn.three_nn_interpolate(t(unknown), t(known), t(feats).to(tdt))
        assert got.dtype == tdt
        # f32: the sum over 3 in another order; bf16: one rounding of the f32
        # sum, allowed to land one bf16 ulp apart
        np.testing.assert_allclose(n(got), n(ref), rtol=tol or 2 ** -8, atol=tol or 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paconv_assign_score_matches_jax(dtype):
    rng = np.random.default_rng(9)
    feat, bank, scores = normal(rng, 2, 6, 5, 10), normal(rng, 10, 8 * 7), normal(rng, 2, 6, 5, 8)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    ref = jpo.paconv_assign_score(jnp.asarray(feat, jdt), jnp.asarray(bank, jdt),
                                  jnp.asarray(scores), 8)
    got = paconv_ops.paconv_assign_score(t(feat).to(tdt), t(bank).to(tdt), t(scores), 8)
    assert got.dtype == tdt and got.shape == (2, 6, 5, 7)
    # f32 sums of the same products in another order; bf16: one output rounding
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(n(got), n(ref), rtol=tol, atol=tol)


# ------------------------------------------------------------- encoder

_jax_encoder = jax.jit(jpa.apply_pointnet2_paconv, static_argnames=("training", "dtype"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_eval_matches_jax(dtype):
    """Eval: B8 and B9's plain versions at every level (the JAX package on
    the CPU takes its gather path; slot order past slot 0 differs and
    nothing downstream sees it)."""
    _, _, jp, js, pm = _pair()
    x = normal(np.random.default_rng(10), 2, PACONV_CONTEXT, 6)
    jdt, tdt = (None, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    ref, _ = _jax_encoder(jp["embedder"], js["embedder"], jnp.asarray(x), training=False,
                          dtype=jdt)
    got, _ = paconv.apply_pointnet2_paconv(pm.params()["embedder"],
                                           pm.state.tree()["embedder"], t(x), dtype=tdt)
    assert got.shape == (2, PACONV_CONTEXT, 16) and got.dtype == (tdt or torch.float32)
    if dtype == "float32":
        # summation order, and the head's polynomial GELU (3.2e-6) against erf
        np.testing.assert_allclose(n(got), n(ref), rtol=1e-4, atol=2e-5)
    else:
        # the same bf16 policy on both sides; rounding points may differ by an ulp
        assert _rel(n(got), n(ref)) < 2e-2


def test_encoder_train_matches_jax():
    """Train mode in f32: output, the new BatchNorm state of every level and
    the gradients of every encoder parameter."""
    _, _, jp, js, pm = _pair()
    x = normal(np.random.default_rng(11), 2, PACONV_CONTEXT, 6)
    cot = normal(np.random.default_rng(12), 2, PACONV_CONTEXT, 16)

    @jax.jit
    def jloss(p):
        out, new = jpa.apply_pointnet2_paconv(p, js["embedder"], jnp.asarray(x), training=True)
        return jnp.vdot(out, cot), (out, new)

    (_, (ref, ref_state)), gref = jax.value_and_grad(jloss, has_aux=True)(jp["embedder"])
    out, new_state = pm.embed(t(x), training=True)
    (out * t(cot)).sum().backward()
    np.testing.assert_allclose(n(out), n(ref), rtol=1e-4, atol=2e-4)
    flat, flat_ref = flatten_tree(new_state["embedder"]), flatten_tree(ref_state)
    assert set(flat) == set(flat_ref)
    for k, v in flat.items():
        np.testing.assert_allclose(n(v), n(flat_ref[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    flat_g = flatten_tree(gref)
    names = [name for name, _ in pm.embedder.named_parameters()]
    assert set(names) == set(flat_g)
    # The max over 32 slots routes each gradient to one slot, and at this
    # size near-tied slots flip with f32 rounding: a change of the input
    # features in the sixth digit moves single parameters' gradients of the
    # port itself by percents. So the check is on directions: cosine >= 0.99
    # per parameter, and the whole gradient's norm within 2%.
    got_all, ref_all = [], []
    for name, p in pm.embedder.named_parameters():
        a, b = n(p.grad).ravel().astype(np.float64), np.asarray(flat_g[name], np.float64).ravel()
        assert a @ b >= 0.99 * np.linalg.norm(a) * np.linalg.norm(b), name
        got_all.append(a)
        ref_all.append(b)
    ratio = np.linalg.norm(np.concatenate(got_all)) / np.linalg.norm(np.concatenate(ref_all))
    assert abs(ratio - 1.0) < 0.02, ratio


# --------------------------------------------------------- weights, model

def test_load_jax_params_carries_paconv_init():
    """A JAX PAConv init_params (ScoreNet heads hold None for their
    BatchNorm) loads into the port: equal key sets, equal values, and the
    port's trees give the None leaves back."""
    cfg = tiny_paconv_config()
    params, state = JaxModel(cfg, remat=False).init_params(jax.random.PRNGKey(3))
    params, state = (jax.tree_util.tree_map(np.asarray, tr) for tr in (params, state))
    pm = ft.FlowCompareModel(cfg, device="cpu")
    flat = flatten_tree(params)
    flat.update(flatten_tree(state, "state"))
    assert set(flat) == set(pm.state_dict())
    ft.load_jax_params(pm, params, state)
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(n(v), flat[k], err_msg=k)
    layer = pm.params()["embedder"]["sa"][0][0]["scorenet"]["layers"]
    assert layer[-1]["bn"] is None and params["embedder"]["sa"][0][0]["scorenet"]["layers"][-1][
        "bn"] is None
    assert pm.state.tree()["embedder"]["sa"][2][1]["scorenet"]["layers"][-1] is None
    assert jax.tree_util.tree_structure(pm.state.tree()["embedder"]) == \
        jax.tree_util.tree_structure(state["embedder"])
