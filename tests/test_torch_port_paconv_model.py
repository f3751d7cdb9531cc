"""Port parity, the PAConv presets' model (good-surf, summer-terrain):
`inner_loop`, `evaluate_on_test` and one train step of the tiny presets
against the JAX model, on shared weights and the noise JAX draws.

The port runs on the CPU here, so B8 and B9 run as their plain versions
(tests/test_torch_port_paconv.py holds those against the Pallas kernels;
tests/test_torch_port_cuda.py holds the kernels against them on the card).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flowcompare_tpu_torch as ft
from flowcompare_tpu.eval.evaluate import evaluate_on_test as jax_evaluate_on_test
from flowcompare_tpu.model import inner_loop as jax_inner_loop
from flowcompare_tpu.train import optim as joptim
from flowcompare_tpu.train import trainer as jtrainer
from flowcompare_tpu_torch.compat.jax_params import flatten_tree
from torch_port_fixtures import N_POINTS, PACONV_CONTEXT, n, normal, paconv_pair, t

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _pair(preset="good-surf", dtype="float32"):
    return paconv_pair(preset, dtype)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (normal(rng, 2, PACONV_CONTEXT, 6), normal(rng, 2, N_POINTS, 6),
            normal(rng, 2, 1))


@pytest.mark.parametrize("preset,dtype", [("good-surf", "float32"), ("summer-terrain", "float32"),
                                          ("good-surf", "bfloat16")])
def test_inner_loop_matches_jax(preset, dtype):
    cfg, jm, jp, js, pm = _pair(preset, dtype)
    batch = _batch(13)
    key = jax.random.PRNGKey(14)
    _, lpr, natsr, _ = jax.jit(functools.partial(jax_inner_loop, jm))(
        jp, js, tuple(map(jnp.asarray, batch)), rng=key)
    eps = jax.random.normal(key, (2, N_POINTS, cfg["latent_dim"] - cfg["input_dim"]))
    _, lp, nats, _ = ft.inner_loop(pm, tuple(map(t, batch)), eps=t(eps))
    assert lp.shape == (2, N_POINTS) and torch.isfinite(lp).all()
    if dtype == "float32":
        # float32 both sides; GELU polynomial (3.2e-6) vs erf through 3 layers
        np.testing.assert_allclose(n(lp), n(lpr), rtol=1e-4, atol=2e-3)
        assert abs(float(nats) - float(natsr)) < 1e-4
    else:
        # JAX's bf16 scan against the port's kernel algebra (B2, B1 plain
        # versions): the tolerances of the DGCNN slice test
        np.testing.assert_allclose(n(lp), n(lpr), rtol=2e-2, atol=1.0)
        assert abs(float(nats) - float(natsr)) < 1e-2


def _eval_items(n_items=2, b=2):
    """The 11-tensor eval items of random clouds (context- or target-sized)."""
    rng = np.random.default_rng(15)
    sizes = {"c": PACONV_CONTEXT, "t": N_POINTS}
    return [[normal(rng, b, 1) if s == "e" else normal(rng, b, sizes[s], 6)
             for s in "ctecttctctt"] for _ in range(n_items)]


@pytest.mark.parametrize("preset", ["good-surf", "summer-terrain"])
def test_evaluate_on_test_matches_jax(preset):
    cfg, jm, jp, js, pm = _pair(preset)
    items = _eval_items()
    nats_r, changes_r = jax_evaluate_on_test(jm, jp, js, items)

    def noise(item, shape):      # the draws JAX's evaluate_on_test makes
        return t(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(0), item), shape))

    maps = []
    nats, changes = ft.evaluate_on_test(pm, items, noise=noise, change_maps=maps)
    assert len(changes) == len(changes_r) == 4 and len(maps) == 2
    assert abs(nats - nats_r) < 1e-4
    np.testing.assert_allclose(changes, changes_r, atol=1.0 / N_POINTS + 1e-9)


def test_train_step_matches_jax():
    """One f32 step of the tiny good-surf against the JAX package's jitted
    step: loss, nats, the pre-clip grad norm, lr, the new BatchNorm state
    and the updated weights."""
    cfg, jm, jp, js, pm = _pair()
    tx = joptim.make_optimizer(cfg)
    state = jtrainer.TrainState(params=jp, bn_state=js, opt_state=tx.init(jp),
                                plateau=joptim.plateau_init(cfg["lr"]),
                                step=jnp.asarray(0, jnp.int32), rng=jax.random.PRNGKey(16))
    batch = _batch(17)
    _, sub = jax.random.split(state.rng)
    eps = jax.random.normal(sub, (2, N_POINTS, cfg["latent_dim"] - cfg["input_dim"]))
    new, metrics = jax.jit(jtrainer._build_step_fn(jm))(state, tuple(map(jnp.asarray, batch)))
    _, row = ft.train_step(ft.init_train_state(pm), tuple(map(t, batch)), eps=t(eps))
    for k in ("loss", "nats"):
        assert abs(row[k] - float(metrics[k])) <= 1e-4 * max(1.0, abs(float(metrics[k]))), k
    # the encoder's gradient is direction-exact and within 2% in norm (see
    # test_encoder_train_matches_jax); the flow's is f32-exact
    assert abs(row["grad_norm"] / float(metrics["grad_norm"]) - 1.0) < 0.02
    assert row["lr"] == float(metrics["lr"])
    sd = pm.state_dict()
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, new.params))
    ref.update(flatten_tree(jax.tree_util.tree_map(np.asarray, new.bn_state), "state"))
    assert set(ref) == set(sd)
    lr = float(metrics["lr"])
    off = []
    for name, ref_v in ref.items():
        d = np.abs(n(sd[name]) - np.asarray(ref_v, np.float32))
        if name.startswith("state."):
            assert d.max() <= 1e-4 * max(1.0, np.abs(ref_v).max()), name
        else:
            # Adam's first step moves each weight by about lr times the sign
            # of its gradient: at most 2 lr apart, and a gradient entry near
            # 0 may take either sign
            assert d.max() <= 2.0 * lr * 1.001, name
            off.append((d > 0.05 * lr).mean())
    assert np.mean(off) <= 0.01, np.mean(off)
