"""Shared fixtures of the tests/test_torch_port_*.py parity tests.

A tiny dulcet-universe configuration (3 coupling layers, latent 32, hidden
widths <= 64, N=64 target and Nc=80 context points, k=8), its PAConv
twins (good-surf, summer-terrain: Nc=256) and its global twin
(helpful-sponge: the global DGCNN and conditioner, 6 coupling hidden layers
as shipped, a 20-wide embedding, not a multiple of 8 like the shipped
124), one JAX `init_params` draw
perturbed with seeded numpy noise so that LinearLU, ActNorm, LayerNorm and
every BatchNorm (nested states included) are not at their identity init,
and the same weights loaded into the port through `load_jax_params`.
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
PACONV_CONTEXT = 256


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


def _perturb(params: dict, state: dict, rng: np.random.Generator, lu_noise: float = 0.1) -> None:
    """Move the identity-initialised leaves off their init, in place: the
    LinearLU's lower and upper entries by up to `lu_noise`."""
    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if isinstance(v, (dict, list)):
                    walk(v, path + (k,))
                elif v is not None:
                    tree[k] = _noise(path + (k,), v, rng, lu_noise)
        elif isinstance(tree, list):
            for v in tree:
                walk(v, path)

    def walk_state(tree):
        """Every BatchNorm state ({"mean", "var"}) of a nested state tree,
        None leaves (PAConv's ScoreNet head) skipped."""
        if isinstance(tree, dict) and set(tree) == {"mean", "var"}:
            tree["mean"] = rng.normal(0, 0.1, tree["mean"].shape).astype(np.float32)
            tree["var"] = rng.uniform(0.5, 1.5, tree["var"].shape).astype(np.float32)
        elif isinstance(tree, dict):
            for v in tree.values():
                walk_state(v)
        elif isinstance(tree, list):
            for v in tree:
                walk_state(v)

    walk(params)
    walk_state(state["embedder"])


def _noise(path, v, rng, lu_noise=0.1):
    name = path[-1]
    if name in ("lower_entries", "upper_entries"):
        return (v + rng.uniform(-lu_noise, lu_noise, v.shape)).astype(np.float32)
    if name in ("unconstrained_upper_diag", "shift", "log_scale"):
        return (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
    if path[-2:] == ("bn", "scale"):
        return (rng.choice([-1.0, 1.0], v.shape) * rng.uniform(0.5, 1.5, v.shape)
                ).astype(np.float32)
    if name in ("scale", "bias") and "norm" in path or path[-2:] == ("bn", "bias"):
        return (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
    return np.asarray(v, np.float32)


def tiny_paconv_config(preset: str = "good-surf", compute_dtype: str = "float32") -> dict:
    """A tiny PAConv preset: the flow of `tiny_config`, the SA/FP widths as
    shipped (fixed constants), a 64-wide out-MLP, and 256 context points,
    the fewest that leave every one of the four SA levels (N // 4 each) a
    centre."""
    cfg = tiny_config(compute_dtype)
    preset_cfg = jax_get_config(preset)
    cfg.update(input_embedder="PAConv",
               extra_z_value_context=preset_cfg["extra_z_value_context"],
               hidden_dims_embedder_out=[64, 64, 64], n_samples_context=PACONV_CONTEXT)
    return jax_derive(cfg)


def tiny_global_config(compute_dtype: str = "float32") -> dict:
    """A tiny helpful-sponge: the flow of `tiny_config` with the preset's
    coupling depth (hidden_dims of 6 layers: an odd count of hidden-to-hidden
    layers for the residual pairing), a 4-layer embedder head, no extra
    context and a global embedding of 20."""
    cfg = tiny_config(compute_dtype)
    cfg.update(input_embedder="DGCNNembedderGlobal", extra_z_value_context=False,
               hidden_dims=[64] * 6, hidden_dims_embedder_out=[64] * 4, input_embedding_dim=20)
    return jax_derive(cfg)


def model_pair(compute_dtype: str = "float32", seed: int = 0, *, config=None):
    """(cfg, jax model, jax params, jax state, port model) on shared weights;
    `config` (a function of the compute dtype) defaults to `tiny_config`."""
    cfg = (config or tiny_config)(compute_dtype)
    jm = JaxModel(cfg, remat=False)
    params, state = jm.init_params(jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    _perturb(params, state, np.random.default_rng(seed))
    pm = ft.FlowCompareModel(cfg, device="cpu")
    ft.load_jax_params(pm, params, state)
    to_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return cfg, jm, to_jax(params), to_jax(state), pm


def _path_key(path) -> str:
    return ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def paconv_pair(preset: str = "good-surf", compute_dtype: str = "float32", seed: int = 0):
    """`port_init_pair` of `tiny_paconv_config(preset)`. (The JAX PAConv init
    runs hundreds of small eager draws on the CPU;
    `test_load_jax_params_carries_paconv_init` carries a real one.)"""
    return port_init_pair(tiny_paconv_config(preset, compute_dtype), seed)


def port_init_pair(cfg: dict, seed: int = 0, lu_noise: float = 0.1):
    """model_pair for `cfg`, with the port's seeded init as the shared
    weights: the JAX pytrees (None leaves included) take their structure
    from `jax.eval_shape(init_params)` and their leaves from the port's
    state_dict, then are perturbed (`_perturb`) and loaded back into the
    port."""
    jm = JaxModel(cfg, remat=False)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(seed))
    pm = ft.FlowCompareModel(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    own = {k: v.numpy().copy() for k, v in pm.state_dict().items()}

    def fill(tree, prefix):
        leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
        return jax.tree_util.tree_unflatten(
            treedef, [own[prefix + _path_key(p)].reshape(s.shape) for p, s in leaves])

    params, state = fill(shapes[0], ""), fill(shapes[1], "state.")
    _perturb(params, state, np.random.default_rng(seed), lu_noise)
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


# ------------------------------------------------ the flow variants' model

VARIANT_POINTS, VARIANT_CONTEXT, VARIANT_INPUT = 16, 24, 4

# One tiny model per variant: the overrides of tests/test_model.py and the
# exp scale, RELU on the folded layout, the identity, standard-normal and
# non-attention augmenters, CIF and config folded_scan=False.
VARIANT_CASES = {
    "attention_extra": {},
    "no_extra": {"extra_z_value_context": False},
    "exponential_coupling": {"flow_type": "ExponentialCoupling"},
    "spline": {"flow_type": "RationalQuadraticSplineCoupling"},
    "random_permute": {"permuter_type": "random_permute"},
    "full_combiner": {"permuter_type": "FullCombiner"},
    "exponential_combiner": {"permuter_type": "ExponentialCombiner"},
    "no_actnorm": {"act_norm": False},
    "exp_scale": {"affine_scale_fn": "exp"},
    "relu_folded": {"coupling_block_nonlinearity": "RELU"},
    "identity_augmenter": {"latent_dim": VARIANT_INPUT, "cif_latent_dim": VARIANT_INPUT},
    "standard_normal_augmenter": {"augmenter_dist": "StandardNormal"},
    "conditional_augmenter": {"use_attn_augment": False},
    "cif": {"cif_latent_dim": 12, "extra_z_value_context": False},
    "folded_scan_off": {"folded_scan": False},
}


def variant_config(compute_dtype: str = "float32", **overrides) -> dict:
    """tests/test_model.py's tiny model: the "idenity" (sic) embedder, input
    4, latent 8, 3 coupling layers, 16-wide MLPs, 16 points on 24."""
    cfg = jax_get_config("dulcet-universe")
    cfg.update(dict(input_dim=VARIANT_INPUT, latent_dim=8, cif_latent_dim=8, n_flow_layers=3,
                    hidden_dims=[16, 16], net_augmenter_dist_hidden_dims=[16, 16],
                    pre_attention_mlp_hidden_dims=[8, 8], hidden_dims_embedder_out=[16, 16],
                    attn_dim=12, attn_input_dim=8, input_embedding_dim=VARIANT_INPUT,
                    cross_dim_head=8, input_embedder="idenity", sample_size=VARIANT_POINTS,
                    n_samples_context=VARIANT_CONTEXT, n_neighbors=4,
                    compute_dtype=compute_dtype))
    cfg.update(overrides)
    return jax_derive(cfg)


def perturbed(tree, rng: np.random.Generator, path=()):
    """A numpy params tree with its leaves moved off their init (`_noise`,
    and the tanh bounds' scale off 1/8), integer leaves kept."""
    if isinstance(tree, dict):
        return {k: perturbed(v, rng, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [perturbed(v, rng, path) for v in tree]
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.integer):
        return a
    out = _noise(path, a, rng)
    if path[-1] == "scale" and "norm" not in path:
        out = out + np.float32(0.2)
    return out


def variant_pair_of(cfg: dict, seed: int = 0):
    """(cfg, jax model, jax params, jax state, port model) on shared weights:
    the JAX init, perturbed, loaded into the port."""
    jm = JaxModel(cfg, remat=False)
    params, state = jm.init_params(jax.random.PRNGKey(seed))
    params = perturbed(jax.tree_util.tree_map(np.asarray, params),
                       np.random.default_rng(seed + 1))
    state = jax.tree_util.tree_map(np.asarray, state)
    pm = ft.FlowCompareModel(cfg, device="cpu")
    ft.load_jax_params(pm, params, state)
    to_jax = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    return cfg, jm, to_jax(params), to_jax(state), pm


_VARIANT_PAIRS: dict = {}


def variant_pair(case: str, dtype: str):
    """`variant_pair_of` the case's config, built once per process."""
    if (case, dtype) not in _VARIANT_PAIRS:
        _VARIANT_PAIRS[case, dtype] = variant_pair_of(
            variant_config(dtype, **VARIANT_CASES[case]))
    return _VARIANT_PAIRS[case, dtype]


def jax_draws(pm, key, b: int, n_pts: int, *, sampling: bool = False, sample_std: float = 0.6):
    """The draws the JAX model makes from `key`, in the port model's
    `noise_shapes` structure: the augmenter's eps (or the latent, times
    sample_std) from the key itself or, for CIF, from keys[0] of
    `_layer_keys`' split into L + 2, layer l's from keys[1 + l] and the
    final block's from keys[L]."""
    shapes = pm.noise_shapes(b, n_pts, sampling=sampling)
    scale = sample_std if sampling else 1.0
    if not pm.is_cif:
        return t(scale * jax.random.normal(key, shapes))
    first, cif = shapes["z" if sampling else "augment"], shapes["cif"]
    keys = jax.random.split(key, pm.n_layers + 2)
    draws = [jax.random.normal(keys[1 + l], cif[1:]) for l in range(pm.n_layers - 1)]
    draws.append(jax.random.normal(keys[pm.n_layers], cif[1:]))
    return {"z" if sampling else "augment": t(scale * jax.random.normal(keys[0], first)),
            "cif": t(jnp.stack(draws))}


def variant_batch(cfg: dict, seed: int = 0, b: int = 2):
    """(extract_0, extract_1, extra) of b clouds, six features each."""
    rng = np.random.default_rng(seed)
    return (normal(rng, b, cfg["n_samples_context"], 6), normal(rng, b, cfg["sample_size"], 6),
            normal(rng, b, 1))


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
