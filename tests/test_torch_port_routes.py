"""Routes from the config's shapes (ROADMAP queue C1), on the CPU.

`routes.model_routes` decides per part whether the kernels take the
config's shapes; a refused part takes the JAX package's path off the TPU.
Held here: every preset reads "kernels" for every part; the three C1
configs (D = 32, a 1,024-wide coupling MLP, k = 80) read "plain: ..." on
the right parts; the shapes the gate reasons about are the folds' own
(`stack_shapes` against `fold_stacks`, the augmenter's against
`AugmenterWeights`, the DGCNN's against `EncoderWeights`); the shared
memory mirrors at the kernels' documented limits; and, for tiny models of
each C1 config under bf16, `inner_loop` equal to the JAX package's on the
same weights and noise (JAX on the CPU runs the folded scan, the unfused
augmenter and the gather encoder for every one of them). The card tests
(tests/test_torch_port_cuda.py) hold the mirrors to the library's numbers
and these configs' CUDA runs to plain.
"""

import copy

import numpy as np
import pytest
import torch

import jax

import flowcompare_tpu_torch as ft
from flowcompare_tpu.configs import derive as jax_derive
from flowcompare_tpu.model import inner_loop as jax_inner_loop
from flowcompare_tpu_torch import routes
from flowcompare_tpu_torch.ops import dgcnn_cuda, flow_layer_cuda as flc
from torch_port_fixtures import N_POINTS, model_pair, n, normal, t, tiny_config

torch.set_num_threads(2)

PRESETS = ["dulcet-universe", "good-surf", "helpful-sponge", "summer-terrain", "swept-energy"]
C1_CASES = {
    "d32": ({"cross_dim_head": 32}, {"stack", "augmenter"}),
    "mlp1024": ({"hidden_dims": [1024, 1024, 1024]}, {"stack", "augmenter"}),
    "k80": ({"n_neighbors": 80}, {"encoder"}),
}


def _refused(config) -> set:
    return {part for part, r in routes.model_routes(config).items() if r != "kernels"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset", PRESETS)
def test_every_preset_takes_the_kernels(preset, dtype):
    cfg = ft.get_config(preset)
    cfg["compute_dtype"] = dtype
    assert routes.model_routes(cfg) == {p: "kernels" for p in ("stack", "augmenter", "encoder")}


@pytest.mark.parametrize("case", sorted(C1_CASES))
def test_c1_configs_refuse_the_right_parts(case):
    overrides, refused = C1_CASES[case]
    cfg = ft.get_config("dulcet-universe")
    cfg.update(compute_dtype="bfloat16", **overrides)
    got = routes.model_routes(cfg)
    assert _refused(cfg) == refused, got
    assert all(got[p].startswith("plain: ") for p in refused)


def test_model_routes_are_read_only_and_the_gates():
    cfg = tiny_config("bfloat16")
    cfg["cross_dim_head"] = 32
    model = ft.FlowCompareModel(cfg, device="cpu")
    assert dict(model.routes) == routes.model_routes(model.config)
    with pytest.raises(TypeError):
        model.routes["stack"] = "kernels"
    assert not model._kernel_route() and not model._kernel_route("augmenter")


def test_gate_limits_at_their_edges():
    """The documented limits: k <= min(n, 64); B9's selection up to 4,458
    points; 16 distance rows of up to 3,200 points at 128 features."""
    cfg = ft.get_config("dulcet-universe")
    assert routes.model_routes({**cfg, "n_neighbors": 64})["encoder"] == "kernels"
    assert routes.model_routes({**cfg, "n_neighbors": 65})["encoder"] != "kernels"
    assert routes.model_routes({**cfg, "n_samples_context": 30})["encoder"] != "kernels"
    assert routes.sa_select_smem(4458) <= routes.SMEM_LIMIT < routes.sa_select_smem(4459)
    assert routes.knn_smem_bytes(3200, 128) <= routes.SMEM_LIMIT < routes.knn_smem_bytes(3201, 128)
    paconv = ft.get_config("good-surf")
    assert routes.model_routes({**paconv, "n_samples_context": 4458})["encoder"] == "kernels"
    assert routes.model_routes({**paconv, "n_samples_context": 4459})["encoder"] != "kernels"


def _case_config(case: str, dtype: str = "bfloat16"):
    cfg = tiny_config(dtype)
    cfg.update(C1_CASES[case][0])
    if case == "k80":
        cfg["n_neighbors"] = 72            # past B3's 64, within the tiny cloud's 80
    if case == "mlp1024":
        cfg["n_flow_layers"] = 2
    return jax_derive(cfg)


@pytest.mark.parametrize("case", sorted(C1_CASES))
def test_gate_shapes_are_the_folds_shapes(case):
    """`stack_shapes` gives the products the folds build, and the
    augmenter's and DGCNN's gates agree with the weight layouts that raise
    on shapes their kernels refuse."""
    cfg = _case_config(case)
    model = ft.FlowCompareModel(cfg, device="cpu")
    params = model.params()
    folded = model._folded(params, cfg["extra_context_dim"])
    s = routes.stack_shapes(cfg)
    w_in = flc.packed_input_weights(folded["cpl_in_xe"], folded["cpl_in_c"])
    assert s["cpl"] == [tuple(w_in.shape[1:])] + [tuple(w.shape[1:])
                                                  for w, _ in folded["cpl_rest"]]
    assert s["pre"] == [tuple(w.shape[1:]) for w, _ in folded["pre"]]
    assert s["q"] == tuple(folded["wq_f"].shape[1:])
    fold = flc.fold_augmenter(params["augmenter"], input_dim=cfg["input_dim"],
                              extra_dim=cfg["extra_context_dim"])
    if model.routes["augmenter"] == "kernels":
        flc.AugmenterWeights(fold, input_dim=cfg["input_dim"])
    elif cfg["cross_dim_head"] == routes.ATTENTION_D:
        with pytest.raises(ValueError):
            flc.AugmenterWeights(fold, input_dim=cfg["input_dim"])
    dgcnn_cuda.EncoderWeights(params["embedder"], model.state.tree()["embedder"])


@pytest.mark.parametrize("case", sorted(C1_CASES))
def test_c1_tiny_model_inner_loop_matches_jax(case):
    """bf16 tiny models of the C1 configs: the port's refused parts on the
    JAX package's CPU paths, its other parts on the kernels' plain versions;
    within the slice test's bf16 tolerance of the JAX package."""
    cfg = _case_config(case)
    cfg_fn = lambda dtype: copy.deepcopy(cfg)  # noqa: E731
    _, jm, jparams, jstate, pm = model_pair(config=cfg_fn)
    assert {p for p, r in pm.routes.items() if r != "kernels"} == C1_CASES[case][1]
    rng = np.random.default_rng(5)
    batch = (normal(rng, 2, cfg["n_samples_context"], 6), normal(rng, 2, N_POINTS, 6),
             normal(rng, 2, 1))
    key = jax.random.PRNGKey(11)
    _, lpr, natsr, _ = jax_inner_loop(jm, jparams, jstate, batch, rng=key)
    eps = jax.random.normal(key, (2, N_POINTS, cfg["latent_dim"] - cfg["input_dim"]))
    _, lp, nats, _ = ft.inner_loop(pm, tuple(map(t, batch)), eps=t(eps))
    assert torch.isfinite(lp).all()
    np.testing.assert_allclose(n(lp), n(lpr), rtol=2e-2, atol=1.0)
    assert abs(float(nats) - float(natsr)) < 1e-2
