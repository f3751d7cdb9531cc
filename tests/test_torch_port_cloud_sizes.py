"""Port parity of the kNN kernels on clouds larger than shared memory holds,
on the CPU.

B3 (csrc/knn_edge_max.cu, inside B4) and B6 (csrc/knn_edge_reduce.cu) keep
16 whole distance rows in shared memory up to 3,200 points at 128
features; past that a block walks each row in chunks of
`edgeconv_cuda.KNN_CHUNK` columns (knn_select.cuh `select_chunked`), in one
pass with a falling threshold, with the radix fallback walking the chunks
again for each digit. B9's selection
(csrc/sa_group.cu) keeps its cloud and distance rows in shared memory up to
4,458 points and past that reads the points from global memory, recomputing
the distances for each sweep. The kernels run only on the card; their
PyTorch emulations take the chunk size as an argument, so a few hundred
points span three to five chunks here. Held, on numpy clouds from a seed:

- `knn_select_emulated` / `radix_select_emulated` / `knn_indices_emulated`
  chunked and on whole rows index-equal to `knn_indices`, with ties straddling chunk
  boundaries, rows crowded enough to force the fallback, k = n - 1;
- B3's max and B6's four sums over that selection equal to the JAX
  package's `edge_neighbor_max` / `edge_knn_reduce` in interpret mode;
- `sa_select_emulated` on the recomputing path against `sa_select_plain`
  and `sa_group_fused` in interpret mode, and past 4,458 points;
- B6's backward on any cloud and batch: its reverse lists (a counting sort
  by j, each list then ordered by i: `reverse_lists_emulated`) walked in
  groups of items (`_build.knn_bwd_groups`, shrunk through `monkeypatch`
  so a batch of five spans three groups), du against the plain gradient
  and the Pallas backward in interpret mode; every group's scratch inside
  int32 at the batches that overflowed it before;
- B8 past 12,662 points (the large clouds' kernel, `fps_cuda.fps_plan`):
  with its threads, register counts and shared memory shrunk through
  `monkeypatch`, a few hundred points span its registers, shared tier and
  global tier, and `fps_levels_emulated` is index-equal to the plain chain,
  to `furthest_point_sampling` and to `fps_pallas` in interpret mode;
- the tiny bf16 dulcet-universe (200 context points: four chunks of 64)
  and good-surf with the emulations in place of the kernels' selection,
  against the JAX package's `inner_loop` (log-probs rtol 2e-2 / atol 1.0,
  nats within 1e-2: the bf16 bounds of tests/test_torch_port_slice.py).

tests/test_torch_port_cuda.py holds the kernels themselves to their plain
versions on the card at 4,096, 8,192 and 16,384 points, B8 at 16,384 and
65,536 and B6's backward at 57,344 points and past one group of items.
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
from flowcompare_tpu.ops import fps as jfps
from flowcompare_tpu.ops.edgeconv_vjp_pallas import edge_knn_reduce as j_edge_knn_reduce
from flowcompare_tpu.ops.fps_pallas import fps_pallas
from flowcompare_tpu.ops.sa_group_pallas import sa_group_fused
from flowcompare_tpu_torch.encoders import paconv
from flowcompare_tpu_torch.ops import _build, edgeconv_cuda as ec, edgeconv_vjp_cuda as ev
from flowcompare_tpu_torch.ops import fps_cuda, sa_group_cuda as sg
from test_torch_port_knn_select import cloud
from torch_port_fixtures import (N_POINTS, PACONV_CONTEXT, model_pair, n, normal, paconv_pair,
                                 t, tiny_config)

torch.set_num_threads(2)

CHUNK = 64           # five chunks of a 300-point cloud
H100_SMS = 132


def clouds(kind: str, nn: int, cq: int, seed: int, chunk: int = CHUNK) -> np.ndarray:
    """(2, nn, cq) features. "straddle": integer points with the 8 before
    each chunk boundary repeated just after it, so equal distances sit on
    both sides of every boundary; "crowded": one point 350 times among
    integer points, in random order (its rows hold 350 ties at 0, past the
    cap); "clustered": one far point 320 times, then a cluster of integer
    points (the cluster's rows see 320 equal distances in the first five
    chunks, past the cap, before their near neighbours lower the
    threshold)."""
    if kind in ("crowded", "clustered"):
        rng = np.random.default_rng(seed)
        pts = rng.integers(-4, 5, (2, nn, cq))
        if kind == "crowded":
            pts[:, :350] = pts[:, :1]
            pts = np.stack([p[rng.permutation(nn)] for p in pts])
        else:
            pts[:, :320] = pts[:, :1] + 40
        return pts.astype(np.float32)
    if kind != "straddle":
        return cloud(kind, nn, cq, seed)
    x = cloud("integer", nn, cq, seed)
    for b in range(chunk, nn - 8, chunk):
        x[:, b:b + 8] = x[:, b - 8:b]
    return x


def _reference(x: torch.Tensor, k: int) -> torch.Tensor:
    b, nn, _ = x.shape
    return ec.knn_indices(x, k).sort(-1).values.reshape(b * nn, k)


CASES = [  # (kind, n, cq, k, chunk)
    ("random", 300, 64, 40, CHUNK), ("integer", 300, 6, 40, CHUNK),
    ("straddle", 300, 6, 40, CHUNK), ("straddle", 300, 16, 64, CHUNK),
    ("narrow", 300, 6, 64, CHUNK), ("duplicates", 300, 6, 40, CHUNK),
    ("equal", 300, 6, 40, CHUNK), ("crowded", 600, 6, 40, CHUNK),
    ("clustered", 400, 6, 40, CHUNK), ("integer", 65, 6, 64, 16), ("straddle", 65, 6, 64, 16),
    ("random", 200, 128, 1, CHUNK),
]


@pytest.mark.parametrize("chunked", [True, False], ids=["chunks", "whole rows"])
@pytest.mark.parametrize("kind,nn,cq,k,chunk", CASES)
def test_chunked_selection_matches_knn_indices(kind, nn, cq, k, chunk, chunked):
    """The chunk walk (and, beside it, the whole-row walk) takes each row's
    exact k nearest, ties in index order whichever chunk holds them (k =
    n - 1 at 65 points in chunks of 16); crowded rows fall back to the
    radix select over the chunks, spread rows never do, and a row is walked
    once without the fallback."""
    x = t(clouds(kind, nn, cq, seed=nn + k + cq)).bfloat16()
    b = x.shape[0]
    assert -(-nn // chunk) >= 3
    chunk = chunk if chunked else None
    got, sweeps, most = ec.knn_select_emulated(ec.distance_bits(x).reshape(b * nn, nn), k,
                                               ec.pool_sources(nn, chunk), chunk)
    assert torch.equal(got, _reference(x, k))
    assert torch.equal(ec.knn_indices_emulated(x, k, chunk).reshape(b * nn, k), got)
    fallback = most > ec.SELECT_CAP
    assert bool((sweeps[~fallback] == 1).all())
    assert bool((sweeps[fallback] >= 3).all())
    if kind == "equal":
        assert bool(fallback.all())
        assert torch.equal(got, torch.arange(k).expand(b * nn, k))
    if kind in ("crowded", "clustered"):     # the far point's rows: 350 / 320 ties at 0
        assert bool(fallback.any()) and int(fallback.sum()) >= 640
        # the chunks fall back where the first chunks' threshold let the
        # candidates past the cap, whole rows only on the ties themselves
        assert bool(fallback.all()) == (kind == "clustered" and chunked)
    if kind == "random":
        assert not bool(fallback.any())


@pytest.mark.parametrize("kind", ["narrow", "straddle", "equal"])
def test_radix_select_over_chunks_matches_whole_rows(kind):
    """The fallback's histograms summed chunk by chunk and its admit pass
    carrying the ties' count across chunks select what the whole-row radix
    select does, in as many passes."""
    x = t(clouds(kind, 300, 6, seed=11)).bfloat16()
    bits = ec.distance_bits(x).reshape(600, 300)
    whole, sw = ec.radix_select_emulated(bits, 40)
    for chunk in (64, 96, 128):
        got, swc = ec.radix_select_emulated(bits, 40, chunk)
        assert torch.equal(got, whole) and torch.equal(swc, sw)
    assert torch.equal(whole, _reference(x, 40))


def test_chunk_walk_holds_few_candidates_on_spread_rows():
    """The walk ends holding the candidates under the whole row's pool
    threshold, so at its fullest it held at least the whole-row walk's
    count; on random features that was at most a few more than k at any
    chunk, never near the cap."""
    x = t(clouds("random", 300, 64, seed=12)).bfloat16()
    bits = ec.distance_bits(x).reshape(600, 300)
    _, _, whole = ec.knn_select_emulated(bits, 40, ec.pool_sources(300))
    _, _, one = ec.knn_select_emulated(bits, 40, ec.pool_sources(300, CHUNK), CHUNK)
    assert bool((one >= whole).all()) and bool((whole >= 40).all())
    assert int(one.max()) <= ec.SELECT_CAP // 2


def test_the_kernels_walk_from_the_shapes():
    """Whole rows up to 3,200 points at 128 features (the parent's kernels
    at the presets' 1,250), chunks of KNN_CHUNK past them, whose shared
    memory leaves two blocks an SM at any n."""
    assert ec.knn_chunk(1250, 8) is None and ec.knn_chunk(3200, 128) is None
    assert ec.knn_chunk(3201, 128) == ec.knn_chunk(16384, 6) == ec.KNN_CHUNK
    assert 2 * ec.knn_smem_bytes(16384, 128) <= 228 * 1024 - 2 * 1024
    assert ec.KNN_CHUNK % 64 == 0
    assert torch.equal(ec.pool_sources(4096, ec.KNN_CHUNK), ec.pool_sources(4096))


@pytest.mark.parametrize("chunk", [CHUNK, 48])
@pytest.mark.parametrize("kind,nn,cq,k", [("straddle", 300, 6, 40), ("narrow", 200, 16, 64),
                                          ("duplicates", 250, 6, 8)])
def test_chunked_b3_and_b6_match_pallas(kind, nn, cq, k, chunk):
    """B3's max and B6's forward over the chunked selection (chunks of 64
    and of 48 columns) against the Pallas kernels in interpret mode: the
    max and min bit-equal, the sums to 1e-5 relative (f32 sums in another
    order)."""
    x = clouds(kind, nn, cq, seed=3 * nn + k)
    u = np.random.default_rng(nn).normal(size=(2, nn, 32)).astype(np.float32)
    idx = ec.knn_indices_emulated(t(x).bfloat16(), k, chunk)
    ub = t(u).bfloat16()
    ref = jep.edge_neighbor_max(jnp.asarray(x, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16), k,
                                interpret=True)
    got = torch.stack([ub[b][idx[b]].amax(1) for b in range(2)])
    np.testing.assert_array_equal(n(got), n(ref))
    refs = j_edge_knn_reduce(jnp.asarray(x, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16), k,
                             interpret=True)
    sel = torch.stack([ub.float()[b][idx[b]] for b in range(2)])
    got = [sel.amax(2), sel.amin(2), sel.sum(2), (sel * sel).sum(2)]
    for g, r in zip(got[:2], refs[:2]):
        np.testing.assert_array_equal(n(g), np.asarray(r))
    for g, r in zip(got[2:], refs[2:]):
        np.testing.assert_allclose(n(g), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_du_scale_bounds_the_plain_gradient():
    """`edgeconv_vjp_cuda.du_scale`, the scale to which the card tests hold
    B6's du on large clouds, bounds the sum of du's terms' magnitudes (it
    counts every selecting row's |dmx| and |dmn|): at least |du|, and equal
    to it with non-negative u, ds1, ds2 and no max / min cotangent."""
    x = t(clouds("straddle", 300, 6, seed=13)).bfloat16()
    rng = np.random.default_rng(14)
    u = t(rng.normal(size=(2, 300, 16)).astype(np.float32)).bfloat16().float()   # as B6 reads it
    cots = [t(rng.normal(size=(2, 300, 16)).astype(np.float32)) for _ in range(4)]
    idx = ec.knn_indices(x, 40)
    for signed in (True, False):
        cs = cots if signed else [0 * cots[0], 0 * cots[1], cots[2].abs(), cots[3].abs()]
        uu = (u if signed else u.abs()).clone().requires_grad_()
        torch.autograd.backward(ev.edge_knn_reduce_plain(x, uu, 40), cs)
        scale = ev.du_scale(idx, uu.detach(), cs)
        du = uu.grad.abs()
        assert bool((du <= scale * (1 + 1e-5) + 1e-6).all())
        if not signed:
            np.testing.assert_allclose(n(du), n(scale), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------- B6's backward, B8

@pytest.mark.parametrize("n_items,nn,k", [(44, 55000, 40), (442, 16384, 40), (20, 57344, 40),
                                          (70000, 50, 40), (1, 1 << 22, 64)])
def test_knn_bwd_groups_keep_the_scratch_in_int32(n_items, nn, k):
    """The batches whose reverse lists passed 2^31 - 1 ints of scratch (44
    items of 55,000 points, 442 of 16,384) and more run in groups of items,
    in order, each within GRID_ITEMS items and 2^31 - 1 ints; an item whose
    scratch alone passes the group's budget is a group of its own."""
    groups = _build.knn_bwd_groups(n_items, nn, k)
    assert groups[0][0] == 0 and groups[-1][1] == n_items
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    per = _build.knn_bwd_scratch_ints(nn, k)
    for lo, hi in groups:
        assert 1 <= hi - lo <= _build.GRID_ITEMS
        assert (hi - lo) * per <= max(_build.BWD_GROUP_INTS, per) < 2 ** 31


def _b6_backward_case(kind: str, nn: int, b: int, c: int, k: int, seed: int):
    x = t(np.concatenate([clouds(kind, nn, 6, seed=seed + i) for i in range(3)])[:b])
    rng = np.random.default_rng(seed + 1)
    u = t(rng.normal(size=(b, nn, c)).astype(np.float32)).bfloat16().float()  # as B6 reads it
    # bf16-exact cotangents: the Pallas backward casts them to bf16 for its MXU sums
    cots = [t(rng.normal(size=(b, nn, c)).astype(np.float32)).bfloat16().float()
            for _ in range(4)]
    return x.bfloat16(), u, cots


@pytest.mark.parametrize("kind,nn,k", [("straddle", 300, 40), ("duplicates", 250, 8),
                                       ("equal", 120, 16)])
def test_b6_backward_in_groups_matches_plain_and_pallas(monkeypatch, kind, nn, k):
    """B6's backward as the wrapper runs it, with the group budget shrunk to
    two items' scratch: five items in three groups, each group's lists
    built by the counting sort (the fill in a random order) and ordered by
    i, du summed as the kernel sums it; against autograd of
    `edge_knn_reduce_plain` and the Pallas backward in interpret mode, to
    1e-5 relative (f32 sums in another order; bf16-exact cotangents, which
    the Pallas kernel reads at bf16)."""
    b, c = 5, 24
    monkeypatch.setattr(_build, "BWD_GROUP_INTS", 2 * _build.knn_bwd_scratch_ints(nn, k) + 1)
    assert _build.knn_bwd_groups(b, nn, k) == [(0, 2), (2, 4), (4, 5)]
    x, u, cots = _b6_backward_case(kind, nn, b, c, k, seed=nn + k)
    uu = u.clone().requires_grad_()
    torch.autograd.backward(ev.edge_knn_reduce_plain(x, uu, k), cots)
    idx = ec.knn_indices(x, k).sort(-1).values
    sel = torch.stack([u[i][idx[i]] for i in range(b)])
    amax, amin = sel.argmax(2).to(torch.uint8), sel.argmin(2).to(torch.uint8)
    got = ev.edge_knn_reduce_bwd_by_groups(u, *cots, amax, amin, idx)
    np.testing.assert_allclose(n(got), n(uu.grad), rtol=1e-5, atol=1e-5)
    _, vjp = jax.vjp(lambda v: j_edge_knn_reduce(jnp.asarray(n(x.float()), jnp.bfloat16), v, k,
                                                 interpret=True), jnp.asarray(n(u)))
    (ref,) = vjp(tuple(jnp.asarray(n(g)) for g in cots))
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fill_seed", [0, 1, 2])
@pytest.mark.parametrize("tile,window", [(128, 8192), (16, 32)], ids=["kernel", "shrunk"])
def test_reverse_lists_do_not_depend_on_the_fill_order(monkeypatch, fill_seed, tile, window):
    """The count's atomics give each entry a place in its list in any order;
    ranking each list gives the same lists, each in increasing i, as the
    sequential construction the kernels replaced: an all-equal cloud (k
    lists of every row) and a duplicated one, with the count's tiles and
    windows as built and shrunk (150 points: ten tiles of 16 rows, five
    windows of 32 j)."""
    monkeypatch.setattr(ev, "REV_TILE", tile)
    monkeypatch.setattr(ev, "REV_WINDOW", window)
    for kind in ("equal", "duplicates"):
        x = t(clouds(kind, 150, 6, seed=5)).bfloat16()
        idx = ec.knn_indices(x, 12).sort(-1).values
        off, rev = ev.reverse_lists_emulated(idx, fill_seed)
        for bi in range(2):
            for j in range(150):
                lst = rev[bi, off[bi, j]:off[bi, j + 1]]
                assert bool((lst[1:] > lst[:-1]).all())
                assert torch.equal(lst >> 6, (idx[bi] == j).any(-1).nonzero()[:, 0])


def test_fps_plan_from_the_shapes():
    """The small kernel and its launch up to 12,662 points over PAConv's levels
    (the presets' 1,250 included); the large clouds' kernel past it, all on
    chip at 16,384 points, a global tier at 65,536."""
    levels = lambda nn: [nn // 4 ** (i + 1) for i in range(4)]  # noqa: E731
    for nn in (1250, 8192, 12662):
        plan = fps_cuda.fps_plan(nn, levels(nn))
        assert plan["kernel"] == "small" and plan["threads"] == 128 and plan["spill"] == 0
        assert plan["smem"] <= _build.SMEM_LIMIT
    for nn, spilled in ((12663, False), (16384, False), (65536, True)):
        plan = fps_cuda.fps_plan(nn, levels(nn))
        assert plan["kernel"] == "big" and plan["threads"] == 512
        assert plan["smem"] <= _build.SMEM_LIMIT and (plan["spill"] > 0) == spilled


def _shrink_fps(monkeypatch):
    """The large clouds' kernel at 64 threads, two points a thread in
    registers and a shared tier of 128 points: 600 points take all three
    tiers."""
    monkeypatch.setattr(fps_cuda, "FPS_BIG_THREADS", 64)
    monkeypatch.setattr(fps_cuda, "FPS_BIG_PERS", (1, 2))
    monkeypatch.setattr(_build, "SMEM_LIMIT", fps_cuda._big_slots() + 16 * 128)


@pytest.mark.parametrize("kind", ["random", "duplicated", "grid", "equal"])
def test_fps_large_cloud_kernel_matches_plain_and_jax(monkeypatch, kind):
    """The large clouds' kernel, shrunk: level 0 of 600 points in registers
    (128), the shared tier (128) and the global one (344), the winning
    warp's kept coordinates as the next centre; every level's picks and
    coordinates equal to the plain chain's, and level by level to the JAX
    package's `furthest_point_sampling` and `fps_pallas` (interpret)."""
    _shrink_fps(monkeypatch)
    nn = 600
    ms = [nn // 4 ** (i + 1) for i in range(4)]
    plan = fps_cuda.fps_plan(nn, ms)
    assert plan["kernel"] == "big" and plan["spill"] == nn - 256
    assert plan["levels"][0] == (2, 256)
    x = _sa_cloud(kind, nn, 53) if kind != "equal" else np.ones((2, nn, 3), np.float32)
    idx, out, parities = fps_cuda.fps_levels_emulated(t(x), ms)
    ref_idx, ref_out = fps_cuda.furthest_point_sampling_levels_plain(t(x), ms)
    for level in range(4):
        assert torch.equal(idx[level], ref_idx[level]), level
        assert torch.equal(out[level], ref_out[level]), level
    assert parities == [i % 2 for i in range(sum(m - 1 for m in ms))]
    cloud = jnp.asarray(x)
    for level, m in enumerate(ms):
        ref = jfps.furthest_point_sampling(cloud, m)
        np.testing.assert_array_equal(idx[level].numpy(), np.asarray(ref))
        np.testing.assert_array_equal(idx[level].numpy(),
                                      np.asarray(fps_pallas(cloud, m, interpret=True)))
        cloud = jnp.take_along_axis(cloud, ref[..., None].astype(jnp.int32), 1)


# ------------------------------------------------------------------ B9

def _sa_chain(x: np.ndarray) -> list:
    xt = t(x)
    ms = [x.shape[1] // 4 ** (i + 1) for i in range(4)]
    idxs, outs = fps_cuda.furthest_point_sampling_levels_plain(xt, ms)
    return list(zip(outs, idxs, [xt, *outs]))


def _sa_cloud(kind: str, nn: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "grid":
        return rng.integers(-3, 4, size=(2, nn, 3)).astype(np.float32)
    if kind == "duplicated":
        half = normal(rng, 2, nn // 2, 3)
        return np.concatenate([half, half[:, : nn - nn // 2]], 1)
    return normal(rng, 2, nn, 3)


@pytest.mark.parametrize("kind", ["random", "duplicated", "grid"])
def test_sa_select_recomputing_matches_plain_and_pallas(kind):
    """B9's selection with the cloud read from global memory (the path of
    clouds past 4,458 points, forced here at 256): the pool takes a sweep
    of its own, the lists equal the plain version's and, gathered, the
    Pallas kernel's in interpret mode."""
    levels = _sa_chain(_sa_cloud(kind, 256, 47))
    sels, sweeps = sg.sa_select_emulated(levels, 32, H100_SMS, rows_in_smem=False)
    rows, _ = sg.sa_select_emulated(levels, 32, H100_SMS, rows_in_smem=True)
    rng = np.random.default_rng(48)
    for (new_xyz, idx, xyz), sel, same, sw in zip(levels, sels, rows, sweeps):
        assert torch.equal(sel, sg.sa_select_plain(new_xyz, idx, xyz, 32))
        assert torch.equal(sel, same)
        if xyz.shape[1] > 1:
            assert bool((sw >= 2).all())
        feats = jnp.asarray(normal(rng, 2, xyz.shape[1], 8), jnp.float32)
        ref = sa_group_fused(jnp.asarray(n(new_xyz)), jnp.asarray(idx.numpy().astype(np.int32)),
                             jnp.asarray(n(xyz)), feats, 32, interpret=True)
        got = sg.sa_gather_emulated(sel, new_xyz, xyz, t(feats))
        np.testing.assert_array_equal(n(got), n(ref))


def test_sa_select_past_shared_memory_matches_plain():
    """At 4,500 points (past the 4,458 whose rows fit) the launch reads the
    cloud from global memory; level 0's lists equal the plain version's on
    integer coordinates (crowded ties)."""
    nn = 4500
    assert not sg.select_rows_fit(nn) and sg.select_rows_fit(4458)
    assert sg.sa_select_smem(nn) < sg.sa_select_smem(4458) // 8
    x = t(np.random.default_rng(49).integers(-6, 7, size=(1, nn, 3)).astype(np.float32))
    m = nn // 4
    idx = torch.randperm(nn, generator=torch.Generator().manual_seed(50))[:m][None]
    level = (x[0, idx[0]][None], idx, x)
    (sel,), (sw,) = sg.sa_select_emulated([level], 32, H100_SMS)
    assert torch.equal(sel, sg.sa_select_plain(*level, 32))
    assert bool((sw >= 2).all())


# ------------------------------------------------------------ the models

N_CONTEXT_LARGE = 200     # four chunks of CHUNK


@pytest.fixture(scope="module")
def dulcet_pair():
    cfg = tiny_config("bfloat16")
    cfg["n_samples_context"] = N_CONTEXT_LARGE
    return model_pair(config=lambda dtype: copy.deepcopy(cfg))


def _check_inner_loop(cfg, jm, jp, js, pm, n_context: int, seed: int):
    rng = np.random.default_rng(seed)
    batch = normal(rng, 2, n_context, 6), normal(rng, 2, N_POINTS, 6), normal(rng, 2, 1)
    key = jax.random.PRNGKey(seed)
    _, lpr, natsr, _ = jax.jit(functools.partial(jax_inner_loop, jm))(
        jp, js, tuple(map(jnp.asarray, batch)), rng=key)
    eps = jax.random.normal(key, (2, N_POINTS, cfg["latent_dim"] - cfg["input_dim"]))
    _, lp, nats, _ = ft.inner_loop(pm, tuple(map(t, batch)), eps=t(eps))
    assert torch.isfinite(lp).all()
    np.testing.assert_allclose(n(lp), n(lpr), rtol=2e-2, atol=1.0)
    assert abs(float(nats) - float(natsr)) < 1e-2


@pytest.mark.parametrize("chunk", [CHUNK, 40])
def test_dulcet_on_the_chunked_selection_matches_jax(dulcet_pair, monkeypatch, chunk):
    """The tiny bf16 dulcet-universe at 200 context points with B3's and
    B6's selection (the plain versions' `knn_indices`) replaced by the
    chunk walk in chunks of 64 and of 40: `inner_loop` against the JAX
    package's."""
    cfg, jm, jp, js, pm = dulcet_pair
    assert dict(pm.routes)["encoder"] == "kernels"
    calls = []

    def chunked(x, k):
        calls.append(x.shape)
        return ec.knn_indices_emulated(x, k, chunk)

    monkeypatch.setattr(ec, "knn_indices", chunked)
    monkeypatch.setattr(ev, "knn_indices", chunked)
    _check_inner_loop(cfg, jm, jp, js, pm, N_CONTEXT_LARGE, 51)
    # the eval encoder's four stages, each over the 200-point clouds
    assert len(calls) == 4 and all(s[1] == N_CONTEXT_LARGE for s in calls)


def _good_surf_on_emulations(monkeypatch):
    """The tiny bf16 good-surf with B8's levels, B9's selection on the path
    that reads the cloud from global memory and B9's gathers replaced by
    their kernels' emulations: `inner_loop` against the JAX package's."""
    calls = {"fps": 0, "select": 0, "gather": 0}

    def fps(xyz, ms):
        calls["fps"] += 1
        idx, out, _ = fps_cuda.fps_levels_emulated(xyz, ms)
        return idx, out

    def select(levels, k):
        calls["select"] += 1
        return sg.sa_select_emulated(levels, k, H100_SMS, rows_in_smem=False)[0]

    def gather(sel, new_xyz, xyz, feats):
        calls["gather"] += 1
        return sg.sa_gather_emulated(sel, new_xyz, xyz, feats)

    monkeypatch.setattr(paconv, "furthest_point_sampling_levels", fps)
    monkeypatch.setattr(paconv, "sa_select_levels", select)
    monkeypatch.setattr(paconv, "sa_gather", gather)
    cfg, jm, jp, js, pm = paconv_pair("good-surf", "bfloat16")
    _check_inner_loop(cfg, jm, jp, js, pm, PACONV_CONTEXT, 52)
    assert calls == {"fps": 1, "select": 1, "gather": 4}


def test_good_surf_on_the_recomputing_selection_matches_jax(monkeypatch):
    """`_good_surf_on_emulations` with B8's small kernel."""
    plan = fps_cuda.fps_plan(PACONV_CONTEXT, [PACONV_CONTEXT // 4 ** (i + 1) for i in range(4)])
    assert plan["kernel"] == "small"
    _good_surf_on_emulations(monkeypatch)


def test_good_surf_on_the_large_cloud_fps_matches_jax(monkeypatch):
    """`_good_surf_on_emulations` with B8's large clouds' kernel, shrunk (32
    threads, one point a thread in registers, a shared tier of 32) so the
    256-point context spans registers, the shared tier and the global one."""
    monkeypatch.setattr(fps_cuda, "FPS_BIG_THREADS", 32)
    monkeypatch.setattr(fps_cuda, "FPS_BIG_PERS", (1,))
    monkeypatch.setattr(_build, "SMEM_LIMIT", fps_cuda._big_slots() + 16 * 32)
    plan = fps_cuda.fps_plan(PACONV_CONTEXT, [PACONV_CONTEXT // 4 ** (i + 1) for i in range(4)])
    assert plan["kernel"] == "big" and plan["spill"] > 0, plan
    _good_surf_on_emulations(monkeypatch)
