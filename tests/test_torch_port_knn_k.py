"""Port parity of the kNN kernels past 64 neighbours, on the CPU.

B3 (csrc/knn_edge_max.cu, inside B4), B6 (csrc/knn_edge_reduce.cu) and B9's
selection (csrc/sa_group.cu) share knn_select.cuh. Its pool (each of 32
sources' two nearest) bounds a row's k-th smallest only up to k = 64; past
it every row takes the radix select from the start, on whole rows and in
the chunked walk, its list of k in its warp's candidate words. B6 keeps a
neighbour's first max / min slot in a byte, so the kernels take k <=
min(n, 256); its backward's list entries carry the slot in 8 bits past k =
64. The kernels run only on the card; their PyTorch emulations follow them
step for step. Held here, on numpy clouds from a seed:

- `knn_select_emulated` / `knn_indices_emulated` (whole rows and chunks of
  64 columns) at k = 65, 100, 128 and 256 on spread, integer and
  duplicated points, index-equal to `knn_indices`, every row on the radix
  select;
- B3's max over that selection bit-equal to the JAX package's
  `edge_neighbor_max` in interpret mode at k = 100 and 200;
- B6's forward over it against `edge_knn_reduce` in interpret mode at k =
  100 (the Pallas kernel takes k <= 127) and against
  `edge_knn_reduce_plain` and the JAX package's gather formulation
  (`knn_self`, `gather_neighbors`) at k = 200 and 256;
- B6's backward (`reverse_lists_emulated`, entries i << 8 | slot, and
  `edge_knn_reduce_bwd_emulated`, in groups of items) at k = 256 with rows
  whose first max is slot 255, against autograd of `edge_knn_reduce_plain`;
- B9's selection (`sa_select_emulated`) at k = 100 on PAConv's four levels
  of a 360-point cloud, one of 90 points (fewer than k: slots past 90 hold
  point 0) on the radix select, gathered, against `sa_group_fused` in
  interpret mode;
- the tiny bf16 dulcet-universe at n_neighbors = 100 on 200 context points
  (every route "kernels"): `inner_loop` with B3's selection emulated, whole
  rows and in chunks, and one train step against the JAX package's.

tests/test_torch_port_cuda.py holds the kernels themselves to their plain
versions on the card at k = 65, 128 and 256.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flowcompare_tpu_torch as ft
from flowcompare_tpu.model import inner_loop as jax_inner_loop
from flowcompare_tpu.ops import edgeconv_pallas as jep
from flowcompare_tpu.ops import knn as jknn
from flowcompare_tpu.ops.edgeconv_vjp_pallas import edge_knn_reduce as j_edge_knn_reduce
from flowcompare_tpu.ops.sa_group_pallas import sa_group_fused
from flowcompare_tpu.train import optim as joptim
from flowcompare_tpu.train import trainer as jtrainer
from flowcompare_tpu_torch import routes
from flowcompare_tpu_torch.ops import _build, edgeconv_cuda as ec, edgeconv_vjp_cuda as ev
from flowcompare_tpu_torch.ops import fps_cuda, sa_group_cuda as sg
from test_torch_port_knn_select import cloud
from test_torch_port_train import _check_step
from torch_port_fixtures import N_POINTS, model_pair, n, normal, t, tiny_config

torch.set_num_threads(2)

CHUNK = 64
H100_SMS = 132
KS = [65, 100, 128, 256]


def _points(k: int) -> int:
    """A cloud a little larger than k, 200 to 300 points."""
    return max(200, k + 44)


@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["whole rows", "chunks"])
@pytest.mark.parametrize("kind", ["random", "integer", "duplicates"])
@pytest.mark.parametrize("k", KS)
def test_selection_past_the_pool_matches_knn_indices(k, kind, chunk):
    """Past k = 64 every row takes the radix select (no pool walk, no
    candidates held) and its ascending lists equal `knn_indices`' sorted,
    ties in index order, on whole rows and over chunks."""
    nn = _points(k)
    x = t(cloud(kind, nn, 6 if kind != "random" else 64, seed=k + nn)).bfloat16()
    b = x.shape[0]
    bits = ec.distance_bits(x).reshape(b * nn, nn)
    got, sweeps, most = ec.knn_select_emulated(bits, k, ec.pool_sources(nn, chunk), chunk)
    ref = ec.knn_indices(x, k).sort(-1).values.reshape(b * nn, k)
    assert torch.equal(got, ref)
    assert torch.equal(ec.knn_indices_emulated(x, k, chunk).reshape(b * nn, k), ref)
    assert int(most.max()) == 0 and bool((sweeps >= 2).all()) and bool((sweeps <= 5).all())
    whole, _ = ec.radix_select_emulated(bits, k)
    assert torch.equal(got, whole)


def test_lists_past_the_pool_fit_beside_the_histogram():
    """A list past the pool (up to KNN_MAX_K = 256 entries) lies in the
    upper half of its warp's 2 x 256 candidate words, beside the radix
    select's 256-bin histogram, so no launch's shared memory depends on k:
    the whole-row threshold stays at 3,200 points at 128 features for every
    k, with two blocks an SM on whole rows and in the chunked walk. B6's
    list entries carry the slot in 6 bits up to k = 64, 8 past it."""
    assert 2 * ec.SELECT_CAP - 256 >= _build.KNN_MAX_K == routes.KNN_MAX_K == 256
    assert ec.knn_chunk(3200, 128) is None and ec.knn_chunk(3201, 128) == ec.KNN_CHUNK
    assert 2 * (ec.knn_smem_bytes(3200, 128) + 1024) > 228 * 1024
    assert 2 * (ec.knn_smem_bytes(1250, 128) + 1024) <= 228 * 1024
    assert 2 * (ec.chunked_smem_bytes(128) + 1024) <= 228 * 1024
    assert _build.knn_slot_bits(64) == 6 and _build.knn_slot_bits(65) == 8
    cfg = ft.get_config("dulcet-universe")
    for k in (64, 65, 128, 256):
        for nc in (1250, 3200, 4096):
            assert routes.model_routes({**cfg, "n_neighbors": k,
                                        "n_samples_context": nc})["encoder"] == "kernels"


@pytest.mark.parametrize("k", [100, 200])
def test_b3_past_the_pool_matches_pallas(k):
    """B3's max over the emulated selection (whole rows and chunks) against
    the Pallas `edge_neighbor_max` in interpret mode, bit for bit on integer
    features."""
    nn = 250
    x = cloud("integer", nn, 6, seed=k)
    u = np.random.default_rng(k).normal(size=(2, nn, 24)).astype(np.float32)
    ub = t(u).bfloat16()
    ref = jep.edge_neighbor_max(jnp.asarray(x, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16), k,
                                interpret=True)
    for chunk in (None, CHUNK):
        idx = ec.knn_indices_emulated(t(x).bfloat16(), k, chunk)
        got = torch.stack([ub[b][idx[b]].amax(1) for b in range(2)])
        np.testing.assert_array_equal(n(got), n(ref))


def _b6_forward(x: torch.Tensor, u: torch.Tensor, k: int, chunk=None) -> list:
    """B6's forward as the kernel computes it: the emulated selection
    (ascending), then mx, mn, s1, s2 of u read at bf16 and the first max /
    min slots as bytes."""
    idx = ec.knn_indices_emulated(x, k, chunk)
    ub = u.bfloat16().float()
    sel = torch.stack([ub[b][idx[b]] for b in range(len(x))])          # (B, N, k, C)
    return [sel.amax(2), sel.amin(2), sel.sum(2), (sel * sel).sum(2),
            sel.argmax(2).to(torch.uint8), sel.argmin(2).to(torch.uint8), idx]


def test_b6_forward_at_k100_matches_pallas():
    """At k = 100 (within the Pallas kernel's 127): B6's forward over the
    emulated selection against `edge_knn_reduce` in interpret mode, the max
    and min bit-equal, the sums to 1e-5 relative."""
    k, nn = 100, 230
    x = cloud("integer", nn, 6, seed=5)
    u = np.random.default_rng(6).normal(size=(2, nn, 16)).astype(np.float32)
    refs = j_edge_knn_reduce(jnp.asarray(x, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16), k,
                             interpret=True)
    for chunk in (None, CHUNK):
        got = _b6_forward(t(x).bfloat16(), t(u), k, chunk)
        for g, r in zip(got[:2], refs[:2]):
            np.testing.assert_array_equal(n(g), np.asarray(r))
        for g, r in zip(got[2:4], refs[2:]):
            np.testing.assert_allclose(n(g), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [200, 256])
def test_b6_forward_past_127_matches_plain_and_the_gather_form(k):
    """Past the Pallas kernel's 127: B6's forward over the emulated
    selection against `edge_knn_reduce_plain` and against the JAX package's
    gather formulation (`knn_self`, `gather_neighbors`: lax.top_k's
    selection) on integer features; the max and min bit-equal, the sums to
    1e-5 relative; the slots are bytes past 127."""
    nn = _points(k)
    x = cloud("integer", nn, 6, seed=k + 1)
    u = np.random.default_rng(k).normal(size=(2, nn, 16)).astype(np.float32)
    xb, ub = t(x).bfloat16(), t(u).bfloat16().float()
    got = _b6_forward(xb, ub, k, CHUNK)
    plain = ev.edge_knn_reduce_plain(xb, ub, k)
    jx = jnp.asarray(x, jnp.bfloat16)
    sel = jknn.gather_neighbors(jnp.asarray(n(ub)), jknn.knn_self(jx, k))     # (B, N, k, C)
    gather = [sel.max(2), sel.min(2), sel.sum(2), (sel * sel).sum(2)]
    for ref in (plain, gather):
        for g, r in zip(got[:2], ref[:2]):
            np.testing.assert_array_equal(n(g), np.asarray(r))
        for g, r in zip(got[2:4], ref[2:]):
            np.testing.assert_allclose(n(g), np.asarray(r), rtol=1e-5, atol=1e-5)
    assert got[4].dtype == torch.uint8 and int(got[4].max()) > 127


def test_b6_backward_at_k256_with_slot_255(monkeypatch):
    """B6's backward at k = 256 as the wrapper runs it (three items, the
    group budget shrunk to two items' scratch: two groups): the reverse
    lists carry the slot in 8 bits, the rows whose first max is slot 255
    (the highest index of their list, made the largest u) route dmx there,
    and du equals autograd of `edge_knn_reduce_plain` within 1e-5 (1 +
    |ref|) plus 1e-6 of its terms' magnitudes (`du_scale`: f32 sums of up
    to 300 terms, the largest 9 times a cotangent, in another order)."""
    k, nn, b, c = 256, 300, 3, 8
    rng = np.random.default_rng(7)
    x = t(rng.integers(-3, 4, (b, nn, 6)).astype(np.float32)).bfloat16()
    u = t(rng.normal(size=(b, nn, c)).astype(np.float32)).bfloat16().float()
    u[:, nn - 1, :] = 9.0            # the last point: every row that selects it has its max there
    cots = [t(rng.normal(size=(b, nn, c)).astype(np.float32)) for _ in range(4)]
    fwd = _b6_forward(x, u, k, CHUNK)
    amax, amin, idx = fwd[4:]
    hit = idx[..., -1] == nn - 1
    assert bool(hit.any()) and bool((amax[hit] == 255).all())
    monkeypatch.setattr(_build, "BWD_GROUP_INTS", 2 * _build.knn_bwd_scratch_ints(nn, k))
    assert _build.knn_bwd_groups(b, nn, k) == [(0, 2), (2, 3)]
    off, rev = ev.reverse_lists_emulated(idx[:1])
    assert bool(((rev[0] & 255) < k).all()) and int((rev[0] >> 8).max()) == nn - 1
    got = ev.edge_knn_reduce_bwd_by_groups(u, *cots, amax, amin, idx)
    uu = u.clone().requires_grad_()
    torch.autograd.backward(ev.edge_knn_reduce_plain(x, uu, k), cots)
    scale = ev.du_scale(idx, u, cots)
    assert bool(((got - uu.grad).abs() <= 1e-5 * (1 + uu.grad.abs()) + 1e-6 * scale).all())


def test_sa_select_past_the_pool_matches_pallas():
    """B9's selection at k = 100 over PAConv's four levels of a 360-point
    cloud (N = 360, 90, 22, 5; the 90-point level takes 89 others on the
    radix select and point 0 past them), on both of the kernel's paths,
    equal to `sa_select_plain` and, gathered, to `sa_group_fused` in
    interpret mode."""
    k, nn = 100, 360
    x = t(np.random.default_rng(8).integers(-6, 7, (2, nn, 3)).astype(np.float32))
    ms = [nn // 4 ** (i + 1) for i in range(4)]
    idxs, outs = fps_cuda.furthest_point_sampling_levels_plain(x, ms)
    levels = list(zip(outs, idxs, [x, *outs]))
    assert [lv[2].shape[1] for lv in levels] == [360, 90, 22, 5]
    sels, sweeps = sg.sa_select_emulated(levels, k, H100_SMS)
    again, _ = sg.sa_select_emulated(levels, k, H100_SMS, rows_in_smem=False)
    rng = np.random.default_rng(9)
    for (new_xyz, idx, xyz), sel, same, sw in zip(levels, sels, again, sweeps):
        assert torch.equal(sel, sg.sa_select_plain(new_xyz, idx, xyz, k))
        assert torch.equal(sel, same)
        if xyz.shape[1] > 65:            # k - 1 or n - 1 others past the pool's 64
            assert bool((sw >= 2).all())
        if xyz.shape[1] < k:
            assert bool((sel[..., xyz.shape[1]:] == 0).all())
        feats = jnp.asarray(normal(rng, 2, xyz.shape[1], 8), jnp.bfloat16)
        ref = sa_group_fused(jnp.asarray(n(new_xyz)), jnp.asarray(idx.numpy().astype(np.int32)),
                             jnp.asarray(n(xyz)), feats, k, interpret=True)
        got = sg.sa_gather_emulated(sel, new_xyz, xyz, t(feats))
        np.testing.assert_array_equal(n(got), n(ref))


# ------------------------------------------------------------ the model

K_MODEL, N_CONTEXT_K = 100, 200


@pytest.fixture(scope="module")
def k100_pair():
    cfg = tiny_config("bfloat16")
    cfg.update(n_samples_context=N_CONTEXT_K, n_neighbors=K_MODEL)
    return model_pair(config=lambda dtype: copy.deepcopy(cfg))


def _emulate_selection(monkeypatch, chunk) -> list:
    calls = []

    def emulated(x, k):
        calls.append((x.shape, k))
        return ec.knn_indices_emulated(x, k, chunk)

    monkeypatch.setattr(ec, "knn_indices", emulated)
    monkeypatch.setattr(ev, "knn_indices", emulated)
    return calls


@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["whole rows", "chunks"])
def test_k100_inner_loop_matches_jax(k100_pair, monkeypatch, chunk):
    """The tiny bf16 dulcet-universe at n_neighbors = 100 on 200 context
    points reads "kernels" for every part; with B3's selection emulated
    (the radix select on every row), `inner_loop` against the JAX
    package's (log-probs rtol 2e-2 / atol 1.0, nats within 1e-2)."""
    cfg, jm, jp, js, pm = k100_pair
    assert dict(pm.routes) == {p: "kernels" for p in ("stack", "augmenter", "encoder")}
    assert routes.model_routes({**cfg, "n_neighbors": 257})["encoder"].startswith("plain: ")
    calls = _emulate_selection(monkeypatch, chunk)
    rng = np.random.default_rng(51)
    batch = normal(rng, 2, N_CONTEXT_K, 6), normal(rng, 2, N_POINTS, 6), normal(rng, 2, 1)
    key = jax.random.PRNGKey(51)
    _, lpr, natsr, _ = jax.jit(functools.partial(jax_inner_loop, jm))(
        jp, js, tuple(map(jnp.asarray, batch)), rng=key)
    eps = jax.random.normal(key, (2, N_POINTS, cfg["latent_dim"] - cfg["input_dim"]))
    _, lp, nats, _ = ft.inner_loop(pm, tuple(map(t, batch)), eps=t(eps))
    assert torch.isfinite(lp).all()
    np.testing.assert_allclose(n(lp), n(lpr), rtol=2e-2, atol=1.0)
    assert abs(float(nats) - float(natsr)) < 1e-2
    assert len(calls) == 4 and all(s[1] == N_CONTEXT_K and kk == K_MODEL for s, kk in calls)


def test_k100_train_step_matches_jax(k100_pair):
    """Last in the file (the step moves the module's port model): one train
    step against the JAX package's jitted step: loss, nats, grad norm, lr,
    the updated weights and BatchNorm state. (On CPU tensors the training
    encoder takes the gather formulation, as the JAX package's does off the
    TPU; B6's selection and sums at these k are held above.)"""
    cfg, jm, jparams, jstate, pm = k100_pair
    tx = joptim.make_optimizer(cfg)
    state = jtrainer.TrainState(params=jparams, bn_state=jstate, opt_state=tx.init(jparams),
                                plateau=joptim.plateau_init(cfg["lr"]),
                                step=jnp.asarray(0, jnp.int32), rng=jax.random.PRNGKey(7))
    rng = np.random.default_rng(52)
    jbatch = tuple(jnp.asarray(a) for a in (normal(rng, 2, N_CONTEXT_K, 6),
                                            normal(rng, 2, N_POINTS, 6), normal(rng, 2, 1)))
    _, sub = jax.random.split(state.rng)
    eps = np.asarray(jax.random.normal(sub, (2, N_POINTS, cfg["latent_dim"] - cfg["input_dim"])))
    new_state, metrics = jax.jit(jtrainer._build_step_fn(jm))(state, jbatch)
    _, row = ft.train_step(ft.init_train_state(pm), tuple(map(t, jbatch)), eps=t(eps))
    _check_step(pm, new_state, row, jax.device_get(metrics), "bfloat16")
