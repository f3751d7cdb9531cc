"""Port parity, the data layer (flowcompare_tpu_torch/data).

The port's loaders against the JAX package's on the same seeds, all held
to np.array_equal (the same numpy draws in the same order, FPS on native
ops of the same source): SyntheticVoxelDataset batches (train and
include_all, with and without extra, two seeds); packs written by each
package read by the other; batch_iterator's and PackedVoxelDataset's
shuffle orders over three epochs; AmsVoxelLoader over a LAS scene
directory (train, include_all, pickle caches both ways);
ChallengeDataset from a CSV the test writes; `eval_batches`;
PrefetchedDataset. The torch `unit_sphere` / `co_unit_sphere` within 1e-6
of the jnp versions (relative to the largest magnitude). And the port's
evaluate_on_test and train(max_steps=2) on the port's datasets give the
same results as on the JAX package's (device="cpu", tiny widths).
"""

import csv
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flowcompare_tpu_torch as ft
import flowcompare_tpu_torch.data as pdata
from flowcompare_tpu.data import ChallengeDataset as JaxChallengeDataset
from flowcompare_tpu.data import PackedVoxelDataset as JaxPackedVoxelDataset
from flowcompare_tpu.data import PrefetchedDataset as JaxPrefetchedDataset
from flowcompare_tpu.data import SyntheticVoxelDataset as JaxSyntheticVoxelDataset
from flowcompare_tpu.data import batch_iterator as jax_batch_iterator
from flowcompare_tpu.data import pack_dataset as jax_pack_dataset
from flowcompare_tpu.data import transforms as jax_transforms
from test_torch_port_laz import assert_items_equal, check_ams_loader_equal_jax, write_scene_dir
from torch_port_fixtures import N_CONTEXT, N_POINTS, tiny_config

torch.set_num_threads(2)


def _assert_batches_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert (u is None) == (v is None)
            if u is not None:
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("include_all", [False, True])
@pytest.mark.parametrize("with_extra", [True, False])
def test_synthetic_batches_equal_jax(seed, include_all, with_extra):
    kw = dict(n_items=4, batch_size=2, with_extra=with_extra, include_all=include_all,
              mode="test" if include_all else "train", seed=seed)
    port, ref = pdata.SyntheticVoxelDataset(**kw), JaxSyntheticVoxelDataset(**kw)
    batches = list(port)
    _assert_batches_equal(batches, ref)
    assert batches[0][0].shape == (2, 1250, 6) and batches[0][1].shape == (2, 1024, 6)
    assert len(batches[0]) == (11 if include_all else 3)
    assert (batches[0][2] is None) == (not with_extra and not include_all)
    assert [port.is_changed(i) for i in range(4)] == [ref.is_changed(i) for i in range(4)]


def test_eval_batches_stack_get_item_all():
    ds = pdata.SyntheticVoxelDataset(n_items=5, sample_size=N_POINTS,
                                     n_samples_context=N_CONTEXT, seed=2)
    ref = JaxSyntheticVoxelDataset(n_items=5, sample_size=N_POINTS,
                                   n_samples_context=N_CONTEXT, seed=2)
    want = [tuple(np.stack(parts) for parts in zip(*(ref.get_item_all(i) for i in (s, s + 1))))
            for s in (0, 2)]
    _assert_batches_equal(pdata.eval_batches(ds, 2), want)


@pytest.mark.parametrize("fn", ["unit_sphere", "co_unit_sphere"])
def test_torch_normalisations_match_jnp(fn):
    rng = np.random.default_rng(1)
    a = (rng.normal(size=(300, 6)) * [4, 3, 2, 1, 1, 1] + [50, -20, 7, 0, 0, 0]).astype(
        np.float32)
    b = rng.normal(size=(120, 6)).astype(np.float32)
    args = (a,) if fn == "unit_sphere" else (a, b)
    got = getattr(pdata, fn)(*map(torch.from_numpy, args), return_inverse=True)
    ref = getattr(jax_transforms, fn)(*map(jnp.asarray, args), return_inverse=True)
    got_arrays = [*got[:-1], got[-1]["mean"], got[-1]["furthest_distance"]]
    ref_arrays = [*ref[:-1], ref[-1]["mean"], ref[-1]["furthest_distance"]]
    for g, r in zip(got_arrays, ref_arrays, strict=True):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= 1e-6 * np.abs(r).max()


def test_packs_cross_read(tmp_path):
    port_ds = pdata.SyntheticVoxelDataset(n_items=6, batch_size=2, sample_size=32,
                                          n_samples_context=48, seed=3)
    jax_ds = JaxSyntheticVoxelDataset(n_items=6, batch_size=2, sample_size=32,
                                      n_samples_context=48, seed=3)
    info = pdata.pack_dataset(port_ds, str(tmp_path / "port.fcpack"))
    assert info == jax_pack_dataset(jax_ds, str(tmp_path / "jax.fcpack"))
    assert (tmp_path / "port.fcpack").read_bytes() == (tmp_path / "jax.fcpack").read_bytes()
    for with_extra in (True, False):
        kw = dict(batch_size=2, shuffle=True, seed=5, with_extra=with_extra)
        _assert_batches_equal(pdata.PackedVoxelDataset(str(tmp_path / "jax.fcpack"), **kw),
                              JaxPackedVoxelDataset(str(tmp_path / "port.fcpack"), **kw))
    # the pack holds what the live source gives
    _assert_batches_equal(pdata.PackedVoxelDataset(str(tmp_path / "jax.fcpack"), batch_size=2),
                          list(pdata.batch_iterator(
                              [port_ds.get_item(i) for i in range(6)], 2)))


def test_shuffle_orders_over_three_epochs(tmp_path):
    items = [(np.full((2, 3), i, np.float32), np.full((1,), -i, np.float32)) for i in range(11)]
    for epoch in range(3):
        for drop_last in (True, False):
            kw = dict(shuffle=True, seed=4, epoch=epoch, drop_last=drop_last)
            _assert_batches_equal(pdata.batch_iterator(items, 3, **kw),
                                  jax_batch_iterator(items, 3, **kw))
    pdata.write_packed(str(tmp_path / "p.fcpack"), iter(items))
    port = pdata.PackedVoxelDataset(str(tmp_path / "p.fcpack"), 3, shuffle=True, seed=8,
                                    drop_last=False)
    ref = JaxPackedVoxelDataset(str(tmp_path / "p.fcpack"), 3, shuffle=True, seed=8,
                                drop_last=False)
    orders = []
    for _ in range(3):   # each pass is the next epoch's permutation
        got = list(port)
        _assert_batches_equal(got, ref)
        orders.append([int(v) for b in got for v in b[0][:, 0, 0]])
    assert all(sorted(o) == list(range(11)) for o in orders) and orders[0] != orders[1]


@pytest.mark.parametrize("mode", ["train", "test"])
def test_ams_loader_on_las_scenes_equal_jax(tmp_path_factory, tmp_path, mode):
    scene = write_scene_dir(tmp_path_factory.mktemp("ams_las"), ".las")
    check_ams_loader_equal_jax(scene, tmp_path, mode, ".las")


def test_challenge_dataset_equal_jax(tmp_path):
    """A scene of two epochs (files "<scene>_*.las" in one directory per
    year) and a CSV of labelled locations, one with an unknown label that
    both filter out; every voxel column of every item equal."""
    rng = np.random.default_rng(21)
    years = [tmp_path / "2019", tmp_path / "2020"]
    for y, year in enumerate(years):
        year.mkdir()
        pdata.save_las(str(year / f"5_{year.name}.las"),
                       pdata.synthetic._scene_cloud(rng, removed=(y == 1)).astype(np.float64))
    rows = [(5, 0.25, -0.5, "added"), (5, -1.75, 0.125, "unknown"),
            (5, 1.1000000000000001, 0.3, "nochange"), (5, -0.3333333333333333, 0.0, "removed")]
    with open(tmp_path / "labels.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["scene", "x", "y", "classification"])
        w.writerows(rows)
    kw = dict(n_samples=64, n_samples_context=96, voxel_size=0.07, seed=3)
    dirs = [str(p) for p in years]
    port = pdata.ChallengeDataset(str(tmp_path / "labels.csv"), dirs, str(tmp_path / "p"), **kw)
    ref = JaxChallengeDataset(str(tmp_path / "labels.csv"), dirs, str(tmp_path / "j"), **kw)
    assert len(port) == len(ref) == 3
    assert [(k, v[0], list(v[1]), v[2]) for k, v in port.pair_dict.items()] == \
        [(k, v[0], list(v[1]), v[2]) for k, v in ref.pair_dict.items()]
    # the registered-scene cache written by each package, read by the other
    cross = pdata.ChallengeDataset(str(tmp_path / "labels.csv"), dirs, str(tmp_path / "j"),
                                   preload=True, **kw)
    for i in range(len(port)):
        outs = [ds[i] for ds in (port, ref, cross)]
        assert outs[0][1] == outs[1][1] == outs[2][1]
        for out, _ in outs[1:]:
            np.testing.assert_array_equal(outs[0][0]["cloud_0"], out["cloud_0"])
            np.testing.assert_array_equal(outs[0][0]["cloud_1"], out["cloud_1"])
            assert outs[0][0]["voxels"].keys() == out["voxels"].keys()
            for k, column in outs[0][0]["voxels"].items():
                assert_items_equal([column[:6]], [out["voxels"][k][:6]])
                assert column[6] == out["voxels"][k][6]


def test_prefetched_dataset_equal_and_stops(tmp_path):
    ds = pdata.SyntheticVoxelDataset(n_items=6, batch_size=2, sample_size=32,
                                     n_samples_context=48)
    _assert_batches_equal(pdata.PrefetchedDataset(ds), JaxPrefetchedDataset(
        JaxSyntheticVoxelDataset(n_items=6, batch_size=2, sample_size=32, n_samples_context=48)))

    def failing():
        yield 1
        raise KeyError("planted")

    it = pdata.PrefetchIterator(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="planted"):
        next(it)
    # a consumer that stops early: the thread ends instead of blocking on put
    it = pdata.PrefetchIterator(iter(range(1000)), prefetch=1)
    assert next(it) == 0
    thread = it._thread
    del it
    thread.join(timeout=5)
    assert not thread.is_alive()


def _model():
    return ft.FlowCompareModel(tiny_config(), device="cpu",
                               generator=torch.Generator().manual_seed(0))


def _noise(item, shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(100 + item))


def test_evaluate_on_test_same_on_port_and_jax_datasets():
    kw = dict(n_items=4, batch_size=2, sample_size=N_POINTS, n_samples_context=N_CONTEXT,
              include_all=True, mode="test", seed=1)
    model = _model()
    results = []
    for ds in (pdata.SyntheticVoxelDataset(**kw), JaxSyntheticVoxelDataset(**kw)):
        maps = []
        nats, changes = ft.evaluate_on_test(model, ds, noise=_noise, change_maps=maps)
        results.append((nats, changes, torch.cat(maps)))
    (nats_p, ch_p, maps_p), (nats_j, ch_j, maps_j) = results
    assert np.isfinite(nats_p) and nats_p == nats_j and ch_p == ch_j
    assert torch.equal(maps_p, maps_j)


def test_train_same_on_port_and_jax_datasets(tmp_path):
    """train(max_steps=2) through each package's PrefetchedDataset over its
    SyntheticVoxelDataset: the same rows and the same final weights."""
    from flowcompare_tpu_torch.train.metrics import MetricWriter

    kw = dict(n_items=6, batch_size=2, sample_size=N_POINTS, n_samples_context=N_CONTEXT,
              seed=5)
    runs = []
    for name, ds in (("port", pdata.PrefetchedDataset(pdata.SyntheticVoxelDataset(**kw))),
                     ("jax", JaxPrefetchedDataset(JaxSyntheticVoxelDataset(**kw)))):
        rows = []

        class Rows(MetricWriter):
            def log(self, metrics, step=None):
                rows.append({k: v for k, v in metrics.items() if k != "time_batch"})

        model = _model()
        ft.train(model, ds, generator=torch.Generator().manual_seed(3), writer=Rows(),
                 save_dir=str(tmp_path / name), max_steps=2, make_samples=False)
        runs.append((rows, {k: v.clone() for k, v in model.state_dict().items()}))
    (rows_p, sd_p), (rows_j, sd_j) = runs
    assert len(rows_p) == 2 and all(np.isfinite(r["loss"]) for r in rows_p)
    assert rows_p == rows_j
    assert sd_p.keys() == sd_j.keys() and all(torch.equal(sd_p[k], sd_j[k]) for k in sd_p)


def test_prefetch_keeps_order_under_a_slow_consumer():
    """The thread runs ahead by at most `prefetch` batches and never reorders."""
    produced = []
    lock = threading.Lock()

    def source():
        for i in range(20):
            with lock:
                produced.append(i)
            yield i

    got = []
    for i, item in enumerate(pdata.PrefetchIterator(source(), prefetch=2)):
        time.sleep(0.002)
        with lock:
            assert len(produced) <= i + 4
        got.append(item)
    assert got == list(range(20))
