"""Port parity at the attention kernels' other head widths, on the CPU.

The cross attention of B1, B2, B5 and B7 takes every head width 1 <= D =
heads x dim_head <= `_build.ATTENTION_MAX_D` (1,024). Held here, for the tiny
bf16 dulcet-universe of tests/torch_port_fixtures.py at D = 20
(cross_dim_head 20: v = kv[:, D:] starts off 16-byte alignment), D = 32
(cross_dim_head 32, the JAX demo's width), D = 128 (cross_heads 2 x
cross_dim_head 64; the reference's heads only widen the one attention
stream), D = 256 (cross_heads 4 x 64, past the kernels' one-block
tiles) and D = 576 (cross_heads 9 x 64, past 512: the cluster tier, and
the conditioner's q product past 512 columns on the wide fused tier):
every part of `model.routes` reads "kernels", and on the same
weights (`load_jax_params`) and noise the port's kernel route (on CPU
tensors the plain versions of B4, B2, B1, B5 and B7) agrees with the JAX
package: `inner_loop` (log-probs rtol 2e-2 / atol 1.0 and nats within
1e-2, the bf16 bounds of tests/test_torch_port_slice.py), one training step
against the JAX package's jitted step (loss, nats and grad norm within 2%,
the updated weights, tests/test_torch_port_train.py's `_check_step`) and
`make_sample` from one z (max error within 3e-2 of the largest coordinate,
tests/test_torch_port_sample.py's bf16 bound). tests/test_torch_port_cuda.py
holds the kernels at these widths to their plain versions on the card.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flowcompare_tpu_torch as ft
from flowcompare_tpu.model import inner_loop as jax_inner_loop
from flowcompare_tpu.model import make_sample as jax_make_sample
from flowcompare_tpu.train import optim as joptim
from flowcompare_tpu.train import trainer as jtrainer
from flowcompare_tpu_torch.ops import _build
from test_torch_port_train import _check_step
from torch_port_fixtures import N_CONTEXT, N_POINTS, model_pair, n, normal, t, tiny_config

torch.set_num_threads(2)

# head width -> the tiny config's attention overrides
WIDTHS = {20: {"cross_dim_head": 20}, 32: {"cross_dim_head": 32},
          128: {"cross_heads": 2, "cross_dim_head": 64}, 256: {"cross_heads": 4, "cross_dim_head": 64},
          576: {"cross_heads": 9, "cross_dim_head": 64}}


def _config(d: int):
    cfg = tiny_config("bfloat16")
    cfg.update(WIDTHS[d])
    return lambda dtype: copy.deepcopy(cfg)


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    return normal(rng, 2, N_CONTEXT, 6), normal(rng, 2, N_POINTS, 6), normal(rng, 2, 1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.fixture(scope="module", params=sorted(WIDTHS), ids=lambda d: f"d{d}")
def pair(request):
    d = request.param
    cfg, jm, jparams, jstate, pm = model_pair(config=_config(d))
    assert cfg["cross_heads"] * cfg["cross_dim_head"] == d
    return d, cfg, jm, jparams, jstate, pm


def test_every_part_takes_the_kernels(pair):
    d, cfg, _, _, _, pm = pair
    assert 1 <= d <= _build.ATTENTION_MAX_D
    assert dict(pm.routes) == {"stack": "kernels", "augmenter": "kernels", "encoder": "kernels"}
    assert pm._kernel_route() and pm._kernel_route("augmenter")


def test_inner_loop_matches_jax(pair):
    _, cfg, jm, jparams, jstate, pm = pair
    batch = _batch(3)
    key = jax.random.PRNGKey(11)
    _, lpr, natsr, _ = jax_inner_loop(jm, jparams, jstate, batch, rng=key)
    eps = jax.random.normal(key, (2, N_POINTS, cfg["latent_dim"] - cfg["input_dim"]))
    _, lp, nats, _ = ft.inner_loop(pm, tuple(map(t, batch)), eps=t(eps))
    assert torch.isfinite(lp).all()
    np.testing.assert_allclose(n(lp), n(lpr), rtol=2e-2, atol=1.0)
    assert abs(float(nats) - float(natsr)) < 1e-2


def test_make_sample_matches_jax(pair):
    _, cfg, jm, jparams, jstate, pm = pair
    rng = np.random.default_rng(7)
    x0, extra = normal(rng, 2, N_CONTEXT, 6), normal(rng, 2, 1)
    key = jax.random.PRNGKey(8)
    ref = jax_make_sample(jm, jparams, jstate, key, N_POINTS, jnp.asarray(x0),
                          jnp.asarray(extra))
    z = 0.6 * jax.random.normal(key, (2, N_POINTS, cfg["latent_dim"]))
    got = ft.make_sample(pm, N_POINTS, t(x0), t(extra), z=t(z))
    assert got.shape == ref.shape == (2, N_POINTS, cfg["input_dim"])
    assert _rel(n(got), n(ref)) < 3e-2


def test_train_step_matches_jax(pair):
    """Last in the file: the step moves the module's shared port model."""
    _, cfg, jm, jparams, jstate, pm = pair
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
