"""Shared fixtures of the tests/test_torch_port_*.py parity tests.

A tiny dulcet-universe configuration (3 coupling layers, latent 32, hidden
widths <= 64, N=64 target and Nc=80 context points, k=8), one JAX
`init_params` draw perturbed with seeded numpy noise so that LinearLU,
ActNorm, LayerNorm and BatchNorm are not at their identity init, and the
same weights loaded into the port through `load_jax_params`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flowcompare_tpu_torch as ft
from flowcompare_tpu.configs import derive as jax_derive
from flowcompare_tpu.configs import get_config as jax_get_config
from flowcompare_tpu.model import FlowCompareModel as JaxModel

N_POINTS, N_CONTEXT, K_NEIGHBORS = 64, 80, 8


def tiny_config(compute_dtype: str = "float32") -> dict:
    cfg = jax_get_config("dulcet-universe")
    cfg.update(dict(
        n_flow_layers=3, latent_dim=32, cif_latent_dim=32,
        hidden_dims=[64, 64, 64], net_augmenter_dist_hidden_dims=[64, 64, 64],
        pre_attention_mlp_hidden_dims=[32, 32, 32],
        hidden_dims_embedder_out=[64, 64, 64, 64, 64, 64],
        attn_dim=48, attn_input_dim=32, input_embedding_dim=16, cross_dim_head=64,
        sample_size=N_POINTS, n_samples_context=N_CONTEXT, n_neighbors=K_NEIGHBORS))
    if compute_dtype != "float32":
        cfg["compute_dtype"] = compute_dtype
    return jax_derive(cfg)


def _perturb(params: dict, state: dict, rng: np.random.Generator) -> None:
    """Move the identity-initialised leaves off their init, in place."""
    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if isinstance(v, (dict, list)):
                    walk(v, path + (k,))
                else:
                    tree[k] = _noise(path + (k,), v, rng)
        elif isinstance(tree, list):
            for v in tree:
                walk(v, path)

    walk(params)
    for bn in state["embedder"].values():
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)


def _noise(path, v, rng):
    name = path[-1]
    if name in ("lower_entries", "upper_entries"):
        return (v + rng.uniform(-0.1, 0.1, v.shape)).astype(np.float32)
    if name in ("unconstrained_upper_diag", "shift", "log_scale"):
        return (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
    if path[-2:] == ("bn", "scale"):
        return (rng.choice([-1.0, 1.0], v.shape) * rng.uniform(0.5, 1.5, v.shape)
                ).astype(np.float32)
    if name in ("scale", "bias") and "norm" in path or path[-2:] == ("bn", "bias"):
        return (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
    return np.asarray(v, np.float32)


def model_pair(compute_dtype: str = "float32", seed: int = 0):
    """(cfg, jax model, jax params, jax state, port model) on shared weights."""
    cfg = tiny_config(compute_dtype)
    jm = JaxModel(cfg, remat=False)
    params, state = jm.init_params(jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    _perturb(params, state, np.random.default_rng(seed))
    pm = ft.FlowCompareModel(cfg)
    ft.load_jax_params(pm, params, state)
    to_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return cfg, jm, to_jax(params), to_jax(state), pm


def normal(rng: np.random.Generator, *shape) -> np.ndarray:
    return rng.normal(size=shape).astype(np.float32)


def t(a) -> torch.Tensor:
    """numpy or JAX array -> float tensor (bf16 arrays arrive as float32)."""
    return torch.from_numpy(np.array(np.asarray(a, dtype=np.float32)))


def n(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.fixture
def cuda():
    """Skip unless an NVIDIA GPU is present; decided at test time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
