"""The bf16 round trip z -> inverse -> forward -> z' on trained weights.

tests/test_torch_port_sample.py::test_round_trip_bf16_gap_within_the_jax_kernels
holds the port's gap (B7's plain version, then B1's) within the JAX Pallas
kernels' own (interpret mode, layer by layer) on seeded weights. Here the
weights are those of a JAX training run: the JAX trainer's data init and 3
steps on the tiny dulcet-universe of tests/torch_port_fixtures.py under
bf16, saved as the JAX package's msgpack checkpoint and read by the port
through `compat.load_any_checkpoint`; the same bounds hold (the port's mean
gap within 1.25 times the JAX kernels', its largest within twice theirs).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import flowcompare_tpu_torch as ft
from flowcompare_tpu.model import FlowCompareModel as JaxModel
from flowcompare_tpu.ops import flow_layer_pallas as flp
from flowcompare_tpu.train import trainer as jtrainer
from flowcompare_tpu_torch.ops import flow_layer_cuda as flc
from torch_port_fixtures import N_CONTEXT, N_POINTS, n, normal, t, tiny_config

torch.set_num_threads(2)


def _gaps(jfolded_inv, port_folded_inv, cfg, seed: int):
    """(port's |z' - z|, the JAX kernels' |z' - z|) on one z, context, extra."""
    rng = np.random.default_rng(seed)
    z = 0.6 * jax.random.normal(jax.random.PRNGKey(seed), (2, N_POINTS, cfg["latent_dim"]))
    ctx = normal(rng, 2, N_CONTEXT, cfg["input_embedding_dim"])
    extra = normal(rng, 2, N_POINTS, 1)
    zeros = np.zeros((2, N_POINTS), np.float32)
    x = flc.fused_flow_layers_inverse(t(z), t(ctx), t(extra), port_folded_inv)
    z_port, _ = flc.fused_flow_layers(x, t(zeros), t(ctx), t(extra), port_folded_inv)
    h = jnp.asarray(z)
    n_layers = cfg["n_flow_layers"]
    for l in reversed(range(n_layers)):
        h = flp.fused_flow_layers_inverse_t(h, jnp.asarray(ctx), jnp.asarray(extra),
                                            flc.layer_slice(jfolded_inv, l), interpret=True)
    ldj = jnp.asarray(zeros)
    for l in range(n_layers):
        h, ldj = flp.fused_flow_layers_t(h, ldj, jnp.asarray(ctx), jnp.asarray(extra),
                                         flc.layer_slice(jfolded_inv, l), interpret=True)
    return np.abs(n(z_port) - n(z)), np.abs(n(h) - n(z))


def test_round_trip_bf16_gap_within_the_jax_kernels_after_jax_training(tmp_path):
    cfg = tiny_config("bfloat16")
    cfg.update(batch_size=2, batches_per_save=100, make_samples=False)
    jm = JaxModel(cfg, remat=False)
    rng = np.random.default_rng(40)
    data = [(normal(rng, 2, N_CONTEXT, 6), normal(rng, 2, N_POINTS, 6), normal(rng, 2, 1))
            for _ in range(3)]
    state = jtrainer.train(jm, data, key=jax.random.PRNGKey(3), save_dir=str(tmp_path),
                           run_name="rt", max_steps=3, save_final=True)
    _, pm, ckpt = ft.load_any_checkpoint(str(tmp_path / "rt_final.msgpack"), device="cpu")
    assert ckpt.kind == "jax" and ckpt.step == 3 and pm._kernel_route()

    lat = cfg["latent_dim"]
    prep = jm._prepare_layers(state.params["layers"])
    stacks = flp.append_final_block(flp.build_layer_stacks(jm, prep),
                                    state.params["final_block"], lat)
    jf = flp.fold_stacks_inverse(stacks, flp.fold_stacks(stacks, split=lat // 2, extra_dim=1))
    # the checkpoint carried the trained weights: the folds agree
    tf = pm._folded_inverse(pm.params(), 1)
    np.testing.assert_allclose(n(tf["lu_w_inv_f"]), np.asarray(jf["lu_w_inv_f"]),
                               rtol=1e-5, atol=1e-5)
    d_port, d_jax = _gaps(jf, tf, cfg, seed=13)
    assert 0.0 < d_port.mean() <= 1.25 * d_jax.mean(), (d_port.mean(), d_jax.mean())
    assert d_port.max() <= 2.0 * d_jax.max(), (d_port.max(), d_jax.max())
