"""The port's import surface and the ops-layer leftovers, against the JAX
package.

Each JAX subpackage's exports (`__all__` of flowcompare_tpu.ops, .eval,
.core, .flows, .encoders, .train) against the port's, with every intended
difference listed beside its reason; `nearest_neighbor_gather` and
`fps_subsample` index-equal to the JAX functions on tie-heavy clouds (the
CPU runs the plain versions: `fps_subsample` launches B8 on CUDA tensors,
which tests/test_torch_port_cuda.py and chip_smoke.py hold to the same
plain version); `WandbWriter` against a stub `wandb` module.
"""

import importlib
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flowcompare_tpu_torch.ops as pops
from flowcompare_tpu.ops import fps as jfps
from flowcompare_tpu.ops import knn as jknn
from flowcompare_tpu_torch.train.metrics import WandbWriter
from torch_port_fixtures import n, t

torch.set_num_threads(2)

# name -> why the port differs: names the JAX package exports that the
# port does not, and the port's own extra exports
INTENDED = {
    "train": {
        "restore_into": "a pytree template fill; the port's Checkpoint.load_into does its job",
        "make_train_step": "a jit factory; the port's train_step is its eager counterpart",
        "make_eval_step": "a jit factory; the port's inner_loop is its eager counterpart",
        "distributed_initialize": "multi-GPU (ROADMAP A12), not ported yet",
        "local_batch_slice": "multi-GPU (ROADMAP A12), not ported yet",
        "make_global_batch": "multi-GPU (ROADMAP A12), not ported yet",
        "make_mesh": "multi-GPU (ROADMAP A12), not ported yet",
        "shard_batch": "multi-GPU (ROADMAP A12), not ported yet",
        "shard_params": "multi-GPU (ROADMAP A12), not ported yet",
        "train_step": "the port's one eager step (JAX builds it inside make_train_step)",
        "clip_by_global_norm": "optax's clip, which the JAX package imports from optax",
    },
}


@pytest.mark.parametrize("sub", ["ops", "eval", "core", "flows", "encoders", "train"])
def test_subpackage_exports_match_the_jax_package(sub):
    jax_names = set(importlib.import_module(f"flowcompare_tpu.{sub}").__all__)
    port = importlib.import_module(f"flowcompare_tpu_torch.{sub}")
    port_names = set(port.__all__)
    assert all(hasattr(port, name) for name in port_names)
    assert jax_names ^ port_names == set(INTENDED.get(sub, {})), (
        sorted(jax_names - port_names), sorted(port_names - jax_names))


def _tie_cloud(seed: int, b: int = 2, nn: int = 96) -> np.ndarray:
    """Points on a coarse integer grid with repeated points: many equal
    distances, so the tie order decides the picks."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 4, size=(b, nn, 3)).astype(np.float32)
    pts[:, nn // 2:] = pts[:, :nn - nn // 2]          # every point twice
    return pts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nearest_neighbor_gather_is_index_equal_to_jax(seed):
    rng = np.random.default_rng(100 + seed)
    pts = _tie_cloud(seed)
    query = rng.integers(0, 4, size=(2, 40, 3)).astype(np.float32)
    feats = np.arange(2 * 96 * 5, dtype=np.float32).reshape(2, 96, 5)  # row ids in the values
    want = jknn.nearest_neighbor_gather(jnp.asarray(query), jnp.asarray(pts), jnp.asarray(feats))
    got = pops.nearest_neighbor_gather(t(query), t(pts), t(feats))
    assert got.shape == (2, 40, 5)
    np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("seed,m", [(0, 17), (1, 48), (2, 96)])
def test_fps_subsample_is_index_equal_to_jax(seed, m):
    pts = _tie_cloud(seed)
    extra = np.arange(2 * 96 * 3, dtype=np.float32).reshape(2, 96, 3)
    cloud = np.concatenate([pts, extra], -1)                       # (2, 96, 6)
    want = jfps.fps_subsample(jnp.asarray(cloud), m)
    got = pops.fps_subsample(t(cloud), m)
    assert got.shape == (2, m, 6)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    np.testing.assert_array_equal(
        pops.furthest_point_sampling(t(pts), m).numpy(),
        np.asarray(jfps.furthest_point_sampling(jnp.asarray(pts), m)))


def test_wandb_writer_logs_through_the_wandb_module(monkeypatch):
    calls = []

    class Run:
        def finish(self):
            calls.append(("finish",))

    stub = types.SimpleNamespace(
        init=lambda **kw: calls.append(("init", kw)) or Run(),
        log=lambda metrics, step=None: calls.append(("log", metrics, step)))
    monkeypatch.setitem(sys.modules, "wandb", stub)
    writer = WandbWriter(project="p", config={"lr": 1e-4})
    writer.log({"loss": 1.5}, step=3)
    writer.close()
    assert calls == [("init", {"project": "p", "config": {"lr": 1e-4}}),
                     ("log", {"loss": 1.5}, 3), ("finish",)]


def test_wandb_writer_imports_wandb_only_when_built(monkeypatch):
    """The module imported without wandb (neither machine installs it);
    building the writer is what asks for it."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError):
        WandbWriter()
