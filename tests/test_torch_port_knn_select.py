"""Port parity, the algorithms of B3's and B6's Hopper kernels.

The CUDA kernels of csrc/knn_select.cuh, knn_edge_max.cu and
knn_edge_reduce.cu run only on the card; the port keeps a PyTorch
emulation of each new algorithm beside the plain versions, step for step
(used by nothing on the main path), and these CPU tests hold them:

- the selection (`edgeconv_cuda.knn_select_emulated`: the pool of each
  source's two nearest, its k-th smallest as the threshold, the candidates
  under it ranked by (distance, index)) and its fallback for crowded ties,
  the radix select (`radix_select_emulated`: digit histograms, the bin that
  holds the k-th value, the early stop, the admit pass), against
  `knn_indices` and against the JAX package's `edge_neighbor_max` /
  `edge_knn_reduce` in interpret mode, on tie-heavy inputs made with numpy
  from a seed;
- the backward's reverse lists built by a counting sort and ordered by i
  (`edgeconv_vjp_cuda.reverse_lists_emulated`) against the sequential
  construction an earlier kernel ran, and its order of summation
  (`edge_knn_reduce_bwd_emulated`) against `edge_knn_reduce_plain`'s
  gradient and against the sequential order, 1e-5 relative in f32.

tests/test_torch_port_cuda.py holds the kernels against the plain versions
on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowcompare_tpu.ops import edgeconv_pallas as jep
from flowcompare_tpu.ops.edgeconv_vjp_pallas import edge_knn_reduce as j_edge_knn_reduce
from flowcompare_tpu_torch.ops import edgeconv_cuda as ec, edgeconv_vjp_cuda as ev
from torch_port_fixtures import n as to_np, t

torch.set_num_threads(2)


def cloud(kind: str, n: int, cq: int, seed: int) -> np.ndarray:
    """(2, n, cq) f32 features with many equal distances."""
    rng = np.random.default_rng(seed)
    if kind == "integer":
        return rng.integers(-3, 4, (2, n, cq)).astype(np.float32)
    if kind == "narrow":         # values in {-1, 0, 1}: ties at almost every rank
        return rng.integers(-1, 2, (2, n, cq)).astype(np.float32)
    if kind == "duplicates":     # about n / 3 distinct points, each two to four times
        base = rng.integers(-4, 5, (2, n // 3 + 1, cq))
        pick = np.sort(rng.integers(0, base.shape[1], (2, n)), axis=1)
        out = np.stack([base[b][rng.permutation(pick[b])] for b in range(2)])
        return out.astype(np.float32)
    if kind == "equal":          # one point n times: every distance is 0
        return np.repeat(rng.integers(-4, 5, (2, 1, cq)), n, axis=1).astype(np.float32)
    if kind == "random":
        return rng.normal(size=(2, n, cq)).astype(np.float32)
    raise ValueError(kind)


SELECT_CASES = [  # (kind, n, cq, k)
    ("integer", 96, 6, 8), ("integer", 77, 6, 1), ("integer", 100, 64, 40),
    ("narrow", 80, 6, 40), ("narrow", 70, 16, 64), ("duplicates", 96, 6, 8),
    ("duplicates", 131, 6, 40), ("equal", 90, 6, 40), ("equal", 64, 6, 64),
    ("integer", 40, 6, 40), ("random", 150, 64, 40), ("random", 97, 128, 64),
]


@pytest.mark.parametrize("kind,n,cq,k", SELECT_CASES)
def test_radix_select_matches_knn_indices(kind, n, cq, k):
    """The radix select takes each row's exact k nearest, ties in index
    order, in 2-5 sweeps; the all-equal cloud takes the first k by index."""
    x = t(cloud(kind, n, cq, seed=n + k)).bfloat16()
    b = x.shape[0]
    got, sweeps = ec.radix_select_emulated(ec.distance_bits(x).reshape(b * n, n), k)
    ref = ec.knn_indices(x, k).sort(-1).values.reshape(b * n, k)
    assert torch.equal(got, ref)
    assert int(sweeps.min()) >= 2 and int(sweeps.max()) <= 5
    if kind == "equal":
        assert torch.equal(got, torch.arange(k).expand(b * n, k))
        # one bin in every pass, which stops the search only when it is all k
        assert int(sweeps.min()) == (2 if k == n else 5)


def test_radix_select_stops_early_on_spread_distances():
    """Random features spread the distances: most rows stop after two
    histogram passes (three sweeps), against the 33 of the binary search."""
    x = t(cloud("random", 200, 64, seed=5)).bfloat16()
    _, sweeps = ec.radix_select_emulated(ec.distance_bits(x).reshape(400, 200), 40)
    assert float(sweeps.float().mean()) <= 3.5, sweeps.float().mean()


@pytest.mark.parametrize("kind,n,cq,k", SELECT_CASES + [("equal", 600, 6, 40),
                                                        ("narrow", 700, 6, 64)])
def test_knn_select_matches_knn_indices(kind, n, cq, k):
    """The kernels' selection, the pool's threshold and the candidates'
    ranks, with the radix select where more than 256 candidates crowd the
    threshold: each row's exact k nearest, ties in index order; one sweep a
    row unless it falls back."""
    x = t(cloud(kind, n, cq, seed=n + k)).bfloat16()
    b = x.shape[0]
    got, sweeps, count = ec.knn_select_emulated(ec.distance_bits(x).reshape(b * n, n), k,
                                                ec.pool_sources(n))
    ref = ec.knn_indices(x, k).sort(-1).values.reshape(b * n, k)
    assert torch.equal(got, ref)
    assert bool((count >= k).all())
    fallback = count > ec.SELECT_CAP
    assert bool((sweeps[~fallback] == 1).all()) and bool((sweeps[fallback] >= 3).all())
    if kind == "equal" and n > ec.SELECT_CAP:
        assert bool(fallback.all())


def test_knn_select_takes_few_candidates_on_spread_distances():
    """Random features at the main path's k = 40 of 1,250: the pool's
    threshold leaves a few more than k candidates, never the fallback."""
    x = t(cloud("random", 1250, 64, seed=6))[:1].bfloat16()
    _, sweeps, count = ec.knn_select_emulated(ec.distance_bits(x).reshape(1250, 1250), 40,
                                              ec.pool_sources(1250))
    assert bool((sweeps == 1).all())
    assert 40 <= float(count.float().mean()) <= 100, count.float().mean()


@pytest.mark.parametrize("use_pool", [True, False])
def test_selection_never_takes_entries_with_bit_31(use_pool):
    """select_row_pinned marks the centre with all-ones bits (B9, whose pool
    is each lane's two nearest others, lane = j % 32): the k - 1 nearest
    others are taken, whatever the centre's value, by both selections."""
    x = t(cloud("duplicates", 90, 3, seed=7))[0]
    bits = ec.distance_bits(x[None])[0]                       # (90, 90)
    selfs = torch.arange(90)
    pinned = bits.clone()
    pinned[selfs, selfs] = 0xFFFFFFFF
    if use_pool:
        got, _, _ = ec.knn_select_emulated(pinned, 31, torch.arange(90) % 32)
    else:
        got, _ = ec.radix_select_emulated(pinned, 31)
    d = bits.view(-1).int().view(torch.float32).view(90, 90).clone()
    d[selfs, selfs] = float("inf")
    ref = torch.sort(d, dim=-1, stable=True).indices[:, :31].sort(-1).values
    assert torch.equal(got, ref)
    assert not (got == selfs[:, None]).any()


@pytest.mark.parametrize("kind,n,cq,k", [("integer", 96, 6, 8), ("duplicates", 131, 6, 40),
                                         ("narrow", 80, 16, 64), ("equal", 90, 6, 40)])
def test_knn_select_matches_pallas_edge_neighbor_max(kind, n, cq, k):
    """B3: the max of u over the kernels' selection equals the Pallas
    kernel's in interpret mode, bit for bit (integer features: exact
    distances on both sides)."""
    x = cloud(kind, n, cq, seed=2 * n + k)
    u = np.random.default_rng(n).normal(size=(2, n, 64)).astype(np.float32)
    ref = jep.edge_neighbor_max(jnp.asarray(x, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16), k,
                                interpret=True)
    idx = ec.knn_indices_emulated(t(x).bfloat16(), k)
    ub = t(u).bfloat16()
    got = torch.stack([ub[b][idx[b]].amax(1) for b in range(2)])
    np.testing.assert_array_equal(to_np(got), to_np(ref))


@pytest.mark.parametrize("kind,n,cq,k", [("integer", 96, 6, 8), ("duplicates", 100, 6, 40)])
def test_knn_select_matches_pallas_edge_knn_reduce(kind, n, cq, k):
    """B6's forward over the kernels' selection (slots ascending) against
    the Pallas kernels in interpret mode: mx and mn equal, s1 and s2 to
    1e-5 relative (f32 sums in another order)."""
    x = cloud(kind, n, cq, seed=3 * n + k)
    u = np.random.default_rng(n + 1).normal(size=(2, n, 32)).astype(np.float32)
    refs = j_edge_knn_reduce(jnp.asarray(x, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16), k,
                             interpret=True)
    idx = ec.knn_indices_emulated(t(x).bfloat16(), k)
    ub = t(u).bfloat16().float()
    sel = torch.stack([ub[b][idx[b]] for b in range(2)])      # (2, n, k, C)
    got = [sel.amax(2), sel.amin(2), sel.sum(2), (sel * sel).sum(2)]
    for g, r in zip(got[:2], refs[:2]):
        np.testing.assert_array_equal(to_np(g), np.asarray(r))
    for g, r in zip(got[2:], refs[2:]):
        np.testing.assert_allclose(to_np(g), np.asarray(r), rtol=1e-5, atol=1e-5)


def reverse_lists_sequential(idx: torch.Tensor) -> tuple:
    """The earlier kernel's construction, one item at a time: counts, a scan
    over j, then every row in increasing i appends at its j's cursor."""
    b, n, k = idx.shape
    off = torch.zeros(b, n + 1, dtype=torch.long)
    rev = torch.empty(b, n * k, dtype=torch.long)
    for bi in range(b):
        counts = torch.bincount(idx[bi].reshape(-1), minlength=n)
        off[bi, 1:] = counts.cumsum(0)
        cursor = off[bi, :n].clone().tolist()
        for i, row in enumerate(idx[bi].tolist()):
            for slot, j in enumerate(row):
                rev[bi, cursor[j]] = i << 6 | slot
                cursor[j] += 1
    return off, rev


@pytest.mark.parametrize("n,k,fill_seed", [(150, 8, 64), (200, 40, 64), (64, 64, 64),
                                           (97, 16, 16)])
def test_reverse_lists_tiled_match_sequential(n, k, fill_seed):
    """Counts by j, their scan, a fill in the atomics' order (a random one
    from `fill_seed`) and each list ordered by rank give the same lists,
    each in increasing i, as the one-block construction. (The name is the
    earlier tiled build's, which these lists replaced.)"""
    x = t(cloud("duplicates", n, 6, seed=n + k)).bfloat16()
    idx = ec.knn_indices(x, k).sort(-1).values
    off, rev = ev.reverse_lists_emulated(idx, fill_seed)
    off_s, rev_s = reverse_lists_sequential(idx)
    assert torch.equal(off, off_s) and torch.equal(rev, rev_s)


def _plain_forward_state(x, u, k):
    """The forward's saved state as the kernel writes it: ascending indices
    and the first max / min slot per channel."""
    idx = ec.knn_indices(x, k).sort(-1).values
    ub = u.bfloat16().float()
    sel = torch.stack([ub[b][idx[b]] for b in range(x.shape[0])])
    return idx, sel.argmax(2).to(torch.uint8), sel.argmin(2).to(torch.uint8)


def _sequential_du(u, cots, amax, amin, off, rev):
    """du summed in list order, one entry after another (the earlier kernel)."""
    dmx, dmn, ds1, ds2 = cots
    b, n, c = ds1.shape
    uj = u.bfloat16().float()
    du = torch.zeros(b, n, c)
    for bi in range(b):
        for j in range(n):
            for p in range(int(off[bi, j]), int(off[bi, j + 1])):
                e = int(rev[bi, p])
                i, slot = e >> 6, e & 63
                g = ds1[bi, i] + 2.0 * uj[bi, j] * ds2[bi, i]
                g = g + torch.where(amax[bi, i].long() == slot, dmx[bi, i], 0.0)
                g = g + torch.where(amin[bi, i].long() == slot, dmn[bi, i], 0.0)
                du[bi, j] += g
    return du


@pytest.mark.parametrize("c", [64, 128, 256, 20])
def test_backward_order_matches_plain_gradient(c):
    """The backward's order of summation (groups of list entries, a shuffle
    tree) against autograd of edge_knn_reduce_plain and the sequential
    order, 1e-5 relative in f32; u with few values so max / min ties are
    routed by the first slot."""
    n, k = 60, 12
    rng = np.random.default_rng(c)
    x = t(cloud("integer", n, 6, seed=c)).bfloat16()
    u = t(rng.integers(-2, 3, (2, n, c)).astype(np.float32))
    cots = [t(rng.normal(size=(2, n, c)).astype(np.float32)) for _ in range(4)]
    uu = u.clone().requires_grad_()
    outs = ev.edge_knn_reduce_plain(x, uu, k)
    torch.autograd.backward(outs, cots)
    idx, amax, amin = _plain_forward_state(x, u, k)
    off, rev = ev.reverse_lists_emulated(idx)
    got = ev.edge_knn_reduce_bwd_emulated(u, *cots, amax, amin, off, rev)
    scale = float(uu.grad.abs().max())
    assert float((got - uu.grad).abs().max()) <= 1e-5 * scale
    seq = _sequential_du(u, cots, amax, amin, off, rev)
    assert float((got - seq).abs().max()) <= 1e-5 * scale
