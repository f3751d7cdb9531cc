"""B8 and B9 as redesigned for the H100, held on the CPU through PyTorch
emulations of their kernels.

B8 (`csrc/fps.cu`) runs PAConv's four farthest-point sampling levels in one
launch; `fps_cuda.fps_levels_emulated` repeats its algorithm step for step
(the thread partition, each thread's first maximum, the two-stage redux
argmax, the double-buffered block stage). B9 (`csrc/sa_group.cu`) selects
for the four levels in one launch and gathers a level at a time;
`sa_group_cuda.sa_select_emulated` and `sa_gather_emulated` repeat its
grid, index lists and the gather's slot and column mapping. Each is held
against the plain versions, against the JAX package (`furthest_point_sampling`,
`fps_pallas` and `sa_group_fused` in interpret mode) on tie-heavy clouds,
and the encoder on the emulated kernels against the JAX encoder. The card
tests (tests/test_torch_port_cuda.py) hold the kernels against the plain
versions on the H100.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowcompare_tpu.encoders import paconv as jpa
from flowcompare_tpu.ops import fps as jfps
from flowcompare_tpu.ops.fps_pallas import fps_pallas
from flowcompare_tpu.ops.sa_group_pallas import sa_group_fused
from flowcompare_tpu_torch.encoders import paconv
from flowcompare_tpu_torch.ops import fps_cuda, sa_group_cuda as sg
from torch_port_fixtures import PACONV_CONTEXT, n, normal, paconv_pair, t

torch.set_num_threads(2)

# the H100's SMs: the selection's grid as the card lays it out
H100_SMS = 132

def _cloud(kind: str, b: int, nn: int, seed: int) -> np.ndarray:
    """Clouds with ties: duplicated halves, an integer grid, all equal."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return normal(rng, b, nn, 3)
    if kind == "duplicated":
        half = normal(rng, b, nn // 2, 3)
        return np.concatenate([half, half[:, : nn - nn // 2]], 1)
    if kind == "grid":
        return rng.integers(-3, 4, size=(b, nn, 3)).astype(np.float32)
    return np.ones((b, nn, 3), np.float32)


def _levels(nn: int) -> list:
    return [nn // 4 ** (i + 1) for i in range(4)]


# ------------------------------------------------------------------ B8

# cloud sizes of B8's launch: 5 points a thread, the main path's 10, and
# past the registers' 2,048 points a block (the rest in shared memory)
FPS_SIZES = [600, 1250, 2600]


@pytest.mark.parametrize("nn", FPS_SIZES)
@pytest.mark.parametrize("kind", ["random", "duplicated", "grid", "equal"])
def test_fps_levels_emulated_matches_plain(nn, kind):
    """The kernel's algorithm gives the plain chain's picks and coordinates
    at every level; the block stage's slot buffers alternate pick by pick
    across the levels."""
    x = t(_cloud(kind, 2, nn, 40))
    ms = _levels(nn)
    idx, out, parities = fps_cuda.fps_levels_emulated(x, ms)
    ref_idx, ref_out = fps_cuda.furthest_point_sampling_levels_plain(x, ms)
    for level in range(4):
        assert torch.equal(idx[level], ref_idx[level]), level
        assert torch.equal(out[level], ref_out[level]), level
    assert parities == [i % 2 for i in range(sum(m - 1 for m in ms))]


@pytest.mark.parametrize("kind", ["random", "duplicated", "grid", "equal"])
def test_fps_levels_emulated_matches_jax_level_by_level(kind):
    """Each level's picks equal the JAX package's `furthest_point_sampling`
    and `fps_pallas` (interpret mode) on that level's cloud, index for
    index, on clouds whose distances tie."""
    x = _cloud(kind, 2, 400, 41)
    ms = _levels(400)
    idx, out, _ = fps_cuda.fps_levels_emulated(t(x), ms)
    cloud = jnp.asarray(x)
    for level, m in enumerate(ms):
        ref = jfps.furthest_point_sampling(cloud, m)
        np.testing.assert_array_equal(idx[level].numpy(), np.asarray(ref))
        np.testing.assert_array_equal(idx[level].numpy(),
                                      np.asarray(fps_pallas(cloud, m, interpret=True)))
        cloud = jnp.take_along_axis(cloud, ref[..., None].astype(jnp.int32), 1)
        np.testing.assert_array_equal(out[level].numpy(), np.asarray(cloud))


# ------------------------------------------------------------------ B9

def _sa_chain(x: np.ndarray) -> list:
    """(new_xyz, idx, xyz) of the four levels of cloud x, from the plain B8."""
    xt = t(x)
    idxs, outs = fps_cuda.furthest_point_sampling_levels_plain(xt, _levels(x.shape[1]))
    return list(zip(outs, idxs, [xt, *outs]))


@pytest.mark.parametrize("kind", ["random", "duplicated", "grid", "equal"])
@pytest.mark.parametrize("k", [32, 12])
def test_sa_select_emulated_matches_plain(kind, k):
    """The selection's grid covers every centre of the four levels once, and
    its index lists (slot 0 the centre, the nearest others ascending, point
    0 past N) equal the plain version's, k > N at the small levels."""
    levels = _sa_chain(_cloud(kind, 2, 300, 42))
    sels, sweeps = sg.sa_select_emulated(levels, k, H100_SMS)
    for lv, sel, sw in zip(levels, sels, sweeps):
        assert torch.equal(sel, sg.sa_select_plain(*lv, k))
        assert bool((sw >= 1).all())


@pytest.mark.parametrize("items,rows", [(50, [4, 1, 1, 1]), (1, [1, 1, 1, 1]),
                                        (25, [2, 1, 1, 1])])
def test_select_grid_takes_more_rows_where_a_level_fills_the_card(items, rows):
    """The main path's levels (M = 312, 78, 19, 4): at 50 clouds a warp of
    level 0 selects 4 rows (a block loads its cloud once for 32 centres),
    the small levels one; every (level, item, centre) once, level 0 first."""
    mcs = [312, 78, 19, 4]
    assert [sg.select_rows(items, mc, H100_SMS) for mc in mcs] == rows
    grid = sg.select_grid(items, mcs, H100_SMS).reshape(-1, 3)
    live = grid[grid[:, 0] >= 0]
    key = (live[:, 0] * items + live[:, 1]) * 1000 + live[:, 2]
    want = torch.tensor([(lv * items + i) * 1000 + c for lv, mc in enumerate(mcs)
                         for i in range(items) for c in range(mc)])
    assert torch.equal(key.sort().values, want.sort().values)
    first = grid[:, 0].reshape(-1, sg.SEL_WARPS * max(rows))
    levels = first.max(1).values
    assert bool((levels[1:] >= levels[:-1]).all())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["random", "duplicated", "grid"])
def test_sa_group_emulated_matches_pallas(dtype, kind):
    """The emulated selection and gather at the four levels of a 256-point
    cloud (N = 256, 64, 16, 4; k = 32 > N at the last two) equal
    `sa_group_fused` in interpret mode, slot for slot."""
    x = _cloud(kind, 2, 256, 43)
    levels = _sa_chain(x)
    sels, _ = sg.sa_select_emulated(levels, 32, H100_SMS)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                           torch.float32)
    rng = np.random.default_rng(44)
    for (new_xyz, idx, xyz), sel, c in zip(levels, sels, (3, 8, 16, 24)):
        feats = jnp.asarray(normal(rng, 2, xyz.shape[1], c), jdt)
        ref = sa_group_fused(jnp.asarray(n(new_xyz)), jnp.asarray(idx.numpy().astype(np.int32)),
                             jnp.asarray(n(xyz)), feats, 32, interpret=True)
        got = sg.sa_gather_emulated(sel, new_xyz, xyz, t(feats).to(tdt))
        assert got.dtype == tdt and got.shape == ref.shape
        np.testing.assert_array_equal(n(got), n(ref))
        assert (n(got[:, :, 0, :3]) == 0).all()                # slot 0 is the centre


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,c,base", [(32, 3, 0), (32, 64, 0), (12, 5, 6), (16, 7, 2),
                                      (40, 8, 10), (8, 261, 4)])
def test_sa_gather_emulated_matches_plain_at_every_alignment(dtype, k, c, base):
    """The gather's groups, lane maps and head / body / tail stores write
    every output element once, equal to the plain gather, at row widths, k
    and output offsets whose spans start off 16-byte boundaries."""
    g = torch.Generator().manual_seed(45 + k + c)
    xyz = torch.randn(2, 50, 3, generator=g)
    feats = torch.randn(2, 50, c, generator=g).to(dtype)
    sel = torch.randint(0, 50, (2, 5, k), generator=g)
    new_xyz = torch.randn(2, 5, 3, generator=g)
    got = sg.sa_gather_emulated(sel, new_xyz, xyz, feats, base=base)
    assert torch.equal(got, sg.sa_gather_plain(sel, new_xyz, xyz, feats))


# ------------------------------------------------------------- encoder

@functools.lru_cache(maxsize=None)
def _pair():
    return paconv_pair("good-surf", "float32")


def test_encoder_on_emulated_kernels_matches_jax(monkeypatch):
    """The eval encoder with B8's levels call and B9's selection and gathers
    replaced by the emulations of their kernels equals the JAX encoder as
    the plain path does (tests/test_torch_port_paconv.py), and calls each
    as the card does: B8 and the selection once, a gather a level."""
    calls = {"fps": 0, "select": 0, "gather": 0}

    def fps(xyz, ms):
        calls["fps"] += 1
        idx, out, _ = fps_cuda.fps_levels_emulated(xyz, ms)
        return idx, out

    def select(levels, k):
        calls["select"] += 1
        return sg.sa_select_emulated(levels, k, H100_SMS)[0]

    def gather(sel, new_xyz, xyz, feats):
        calls["gather"] += 1
        return sg.sa_gather_emulated(sel, new_xyz, xyz, feats)

    monkeypatch.setattr(paconv, "furthest_point_sampling_levels", fps)
    monkeypatch.setattr(paconv, "sa_select_levels", select)
    monkeypatch.setattr(paconv, "sa_gather", gather)
    _, _, jp, js, pm = _pair()
    x = normal(np.random.default_rng(46), 2, PACONV_CONTEXT, 6)
    ref, _ = jax.jit(jpa.apply_pointnet2_paconv, static_argnames=("training", "dtype"))(
        jp["embedder"], js["embedder"], jnp.asarray(x), training=False)
    got, _ = paconv.apply_pointnet2_paconv(pm.params()["embedder"],
                                           pm.state.tree()["embedder"], t(x))
    assert calls == {"fps": 1, "select": 1, "gather": 4}
    # summation order, and the head's polynomial GELU (3.2e-6) against erf
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-4, atol=2e-5)
