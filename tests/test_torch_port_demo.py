"""The port's convergence demo (examples/convergence_demo_torch.py), on the
CPU.

Its configuration is the JAX demo's: cross_dim_head 32 under bf16, so the
port sends the layer stack and the augmenter to the JAX package's CPU
paths (`folded_scan_core`, the unfused augmenter) and keeps the DGCNN on
B4's plain version. Held here, at the demo's widths with the depth cut to
3 layers and the clouds to 64 / 80 points: `inner_loop` and one training
step against the JAX package's (its jitted `_build_step_fn`) on the same
weights and noise, within the bf16 tolerances of
tests/test_torch_port_slice.py and tests/test_torch_port_train.py. The
script's own run is tests/test_torch_port_demo_script.py; chip_smoke.py
runs it at full length on the card.
"""

import copy
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

import flowcompare_tpu_torch as ft
from flowcompare_tpu.model import inner_loop as jax_inner_loop
from flowcompare_tpu.train import optim as joptim
from flowcompare_tpu.train import trainer as jtrainer
from test_torch_port_train import _check_step
from torch_port_fixtures import N_CONTEXT, N_POINTS, model_pair, n, normal, t

torch.set_num_threads(2)

DEMO = Path(__file__).resolve().parents[1] / "examples" / "convergence_demo_torch.py"


def _demo_module():
    sys.path.insert(0, str(DEMO.parent))
    try:
        import convergence_demo_torch
    finally:
        sys.path.remove(str(DEMO.parent))
    return convergence_demo_torch


def _demo_config(dtype: str = "bfloat16") -> dict:
    cfg = _demo_module().demo_config()
    cfg.update(n_flow_layers=3, sample_size=N_POINTS, n_samples_context=N_CONTEXT,
               compute_dtype=dtype)
    return copy.deepcopy(cfg)


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    return (normal(rng, 2, N_CONTEXT, 6), normal(rng, 2, N_POINTS, 6), normal(rng, 2, 1))


def test_demo_config_takes_the_plain_stack_and_augmenter():
    cfg = _demo_module().demo_config()
    assert cfg["cross_dim_head"] == 32 and cfg["compute_dtype"] == "bfloat16"
    from flowcompare_tpu_torch.routes import model_routes
    got = model_routes(cfg)
    assert got["encoder"] == "kernels"
    assert got["stack"].startswith("plain: ") and got["augmenter"].startswith("plain: ")
    assert model_routes(_demo_module().demo_config(64)) == {
        "stack": "kernels", "augmenter": "kernels", "encoder": "kernels"}


def test_demo_config_inner_loop_and_train_step_match_jax():
    cfg, jm, jparams, jstate, pm = model_pair(config=lambda dtype: _demo_config())
    assert not pm._kernel_route() and not pm._kernel_route("augmenter")
    batch = _batch(3)
    key = jax.random.PRNGKey(11)
    _, lpr, natsr, _ = jax_inner_loop(jm, jparams, jstate, batch, rng=key)
    eps = jax.random.normal(key, (2, N_POINTS, cfg["latent_dim"] - cfg["input_dim"]))
    _, lp, nats, _ = ft.inner_loop(pm, tuple(map(t, batch)), eps=t(eps))
    np.testing.assert_allclose(n(lp), n(lpr), rtol=2e-2, atol=1.0)
    assert abs(float(nats) - float(natsr)) < 1e-2

    tx = joptim.make_optimizer(cfg)
    state = jtrainer.TrainState(params=jparams, bn_state=jstate, opt_state=tx.init(jparams),
                                plateau=joptim.plateau_init(cfg["lr"]),
                                step=jnp.asarray(0, jnp.int32), rng=jax.random.PRNGKey(7))
    jbatch = tuple(jnp.asarray(a) for a in _batch(8))
    _, sub = jax.random.split(state.rng)
    eps = np.asarray(jax.random.normal(sub, (2, N_POINTS, cfg["latent_dim"] - cfg["input_dim"])))
    new_state, metrics = jax.jit(jtrainer._build_step_fn(jm))(state, jbatch)
    _, row = ft.train_step(ft.init_train_state(pm), tuple(map(t, jbatch)), eps=t(eps))
    _check_step(pm, new_state, row, jax.device_get(metrics), "bfloat16")
