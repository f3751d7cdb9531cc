"""Routes from the config's shapes (ROADMAP queue C1), on the CPU.

`routes.model_routes` decides per part whether the kernels take the
config's shapes; a refused part takes the JAX package's path off the TPU.
Held here: every preset reads "kernels" for every part; so do the stack
and the augmenter at each attention head width the kernels take (D = 32,
64, 128), while D = 48 and D = 256 read "plain: ..." naming those widths;
the C1 configs (D = 1,088, D = 1,024, a 2,056-wide coupling MLP, k = 257) read
"plain: ..." on the right parts, while the 1,024- and 2,048-wide MLPs (the
stack's, the augmenter's and the embedder head's, `w1024`, and `w2048` with
its 1,024-wide latent and LayerNorm row) read "kernels"; the fused layer
gates at their edges (K and N 2,048 / 2,049, the row-wise widths 1,024 /
1,025 / 1,026, B2's 1,018 augmented dims); the shapes the gate reasons about are the folds' own
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
from torch_port_widths import W1024, W2048

torch.set_num_threads(2)

PRESETS = ["dulcet-universe", "good-surf", "helpful-sponge", "summer-terrain", "swept-energy"]
C1_CASES = {
    "d1088": ({"cross_heads": 17}, {"stack", "augmenter"}),    # past the attention's 1,024
    "d1024": ({"cross_heads": 16}, {"stack", "augmenter"}),    # past the packed rows' 1,024
    "mlp2056": ({"hidden_dims": [2056, 2056, 2056]}, {"stack", "augmenter"}),
    "k257": ({"n_neighbors": 257}, {"encoder"}),
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


@pytest.mark.parametrize("overrides", [W1024, {"hidden_dims": [1024] * 3}, W2048,
                                       {"hidden_dims": [2048] * 3}],
                         ids=["w1024", "hidden1024", "w2048", "hidden2048"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlps_up_to_1024_take_the_kernels(overrides, dtype):
    """dulcet-universe at twice its MLP widths (`w1024`), at four times them
    with a 1,024-wide latent and LayerNorm row (`w2048`), and with its
    coupling MLPs alone at 1,024 or 2,048, reads "kernels" for every part:
    the fused layer kernels take products up to 2,048 wide and row-wise
    epilogues up to 1,024."""
    cfg = ft.get_config("dulcet-universe")
    cfg.update(compute_dtype=dtype, **overrides)
    assert routes.model_routes(cfg) == {p: "kernels" for p in ("stack", "augmenter", "encoder")}


def test_widths_past_1024_read_plain_naming_the_limit():
    """Past the fused layer kernels' limits (products 2,048 wide, row-wise
    epilogues 1,024) the stack, the augmenter and the embedder's head read
    "plain: ..." naming them: MLPs 2,049 wide, a latent of 1,026, a
    LayerNorm row of 1,026."""
    cfg = ft.get_config("dulcet-universe")
    got = routes.model_routes({**cfg, "hidden_dims": [2049] * 3})
    for part in ("stack", "augmenter"):
        assert got[part].startswith("plain: ") and "widths <= 2048" in got[part], got[part]
    assert got["encoder"] == "kernels"
    head = routes.model_routes({**cfg, "hidden_dims_embedder_out": [2049] * 6})
    assert head["encoder"].startswith("plain: ") and head["stack"] == "kernels"
    net = routes.model_routes({**cfg, "net_augmenter_dist_hidden_dims": [2049] * 3})
    assert net["augmenter"].startswith("plain: ") and net["stack"] == "kernels"
    lat = routes.model_routes({**cfg, "latent_dim": 1026})
    assert lat["stack"].startswith("plain: the coupling's") and "latent" in lat["stack"]
    row = routes.model_routes({**cfg, "attn_input_dim": 1026})
    for part in ("stack", "augmenter"):
        assert "LayerNorm's row" in row[part] and "<= 1024" in row[part], row[part]


@pytest.mark.parametrize("heads,dim_head", [(1, 32), (1, 64), (2, 64), (1, 8), (1, 20), (3, 32),
                                            (4, 64), (8, 64), (1, 1), (1, 96), (1, 512), (9, 64),
                                            (12, 64), (6, 128), (1, 872)])
def test_attention_head_widths_take_the_kernels(heads, dim_head):
    """Every D = heads x dim_head from 1 to 872, within `ATTENTION_MAX_D`
    (1,024) and the coupling's packed input rows (1,024 at dulcet's 152
    columns before the attention's): the stack and the augmenter read
    "kernels" on dulcet-universe under bf16."""
    cfg = ft.get_config("dulcet-universe")
    cfg.update(compute_dtype="bfloat16", cross_heads=heads, cross_dim_head=dim_head)
    assert 1 <= heads * dim_head <= routes.ATTENTION_MAX_D
    assert routes.model_routes(cfg) == {p: "kernels" for p in ("stack", "augmenter", "encoder")}


@pytest.mark.parametrize("heads,dim_head", [(17, 64), (1, 1025), (1, 1032)])
def test_other_head_widths_read_plain_naming_the_set(heads, dim_head):
    """D = 1,088, 1,025 and 1,032, past `ATTENTION_MAX_D`, send the stack and
    the augmenter to the plain route with a reason that names the widths the
    kernels take; the encoder stays on its kernels."""
    cfg = ft.get_config("dulcet-universe")
    cfg.update(compute_dtype="bfloat16", cross_heads=heads, cross_dim_head=dim_head)
    got = routes.model_routes(cfg)
    assert got["encoder"] == "kernels"
    for part in ("stack", "augmenter"):
        assert got[part] == (f"plain: attention head width {heads} x {dim_head} = "
                             f"{heads * dim_head} (the cross-attention kernels take 1 <= D <= "
                             f"1024)")


@pytest.mark.parametrize("heads,dim_head,plain", [(1, 873, {"stack"}), (1, 880, {"stack"}),
                                                  (16, 64, {"stack", "augmenter"})])
def test_head_widths_past_the_packed_rows_read_plain_for_them(heads, dim_head, plain):
    """Within the attention's 1,024 the coupling's packed input rows [x1 |
    extra | pad | cond] (152 + D columns) pass `FUSED_IN_W` (1,024) from D =
    873, so the stack reads plain for them while the augmenter (its net's
    rows 8 + D) stays on its kernels; at D = 1,024 both read plain for their
    packed rows, and neither reason is the attention's."""
    cfg = ft.get_config("dulcet-universe")
    cfg.update(compute_dtype="bfloat16", cross_heads=heads, cross_dim_head=dim_head)
    got = routes.model_routes(cfg)
    assert {p for p, r in got.items() if r != "kernels"} == plain
    assert got["encoder"] == "kernels"
    for part in plain:
        assert "attention head width" not in got[part]
    if "augmenter" in plain:
        assert "packed rows of 1032" in got["augmenter"], got["augmenter"]
    assert f"({152 + heads * dim_head}, 512)" in got["stack"], got["stack"]


def test_model_routes_are_read_only_and_the_gates():
    cfg = tiny_config("bfloat16")
    cfg["cross_heads"] = 17                # D = 17 x 64 = 1,088: no attention kernel
    model = ft.FlowCompareModel(cfg, device="cpu")
    assert dict(model.routes) == routes.model_routes(model.config)
    with pytest.raises(TypeError):
        model.routes["stack"] = "kernels"
    assert not model._kernel_route() and not model._kernel_route("augmenter")


def test_gate_limits_at_their_edges():
    """The documented limits: k <= min(n, 256) (64, 65, 128 and 256 on the
    kernels; 257, and k past the cloud, plain); B3 and B6 on clouds of any
    size (whole distance rows in shared memory up to 3,200 points at 128
    features, a chunk's rows past it; B6's backward with no shared-memory
    limit since its reverse lists left shared memory), the DGCNN presets on
    their kernels at 3,201, 4,096, 16,384, 55,553 and 57,344 points; B9's
    selection on any cloud (its rows in shared memory up to 4,458 points,
    none past it); B8 on any cloud (the large clouds' kernel past 12,662
    points), so the PAConv presets on their kernels at 12,663, 16,384 and
    65,536 points too; the cross attention at head widths up to 1,024 (1 x
    512, 8 x 64 and 12 x 64 on the kernels, 1 x 1,025 plain)."""
    cfg = ft.get_config("dulcet-universe")
    for heads, dim_head in ((1, 512), (8, 64), (12, 64)):
        assert routes.model_routes({**cfg, "cross_heads": heads, "cross_dim_head": dim_head,
                                    "compute_dtype": "bfloat16"})["stack"] == "kernels"
    # the fused layer kernels: products up to 2,048 (K and N), row-wise
    # epilogues (the LayerNorm's row, [s | t] and the latent) up to 1,024,
    # B2's output layer in passes of at most 256 pairs (1,018 augmented dims)
    every = {p: "kernels" for p in ("stack", "augmenter", "encoder")}
    for key, ok, past in (("hidden_dims", 2048, 2049), ("net_augmenter_dist_hidden_dims", 2048,
                                                        2049),
                          ("hidden_dims_embedder_out", 2048, 2056)):
        n_hidden = len(cfg[key])
        assert routes.model_routes({**cfg, key: [ok] * n_hidden}) == every
        assert routes.model_routes({**cfg, key: [past] * n_hidden}) != every
    for key in ("attn_input_dim", "latent_dim"):
        assert routes.model_routes({**cfg, key: 1024}) == every
        for past in (1025, 1026):
            assert routes.model_routes({**cfg, key: past})["stack"].startswith("plain: ")
    assert routes.model_routes({**cfg, "latent_dim": 1024, "input_dim": 6})["augmenter"] == \
        "kernels"
    plan = flc.augment_net_plan([(72, 512), (512, 2036)], 72, 1018)
    assert plan["passes"] == [(0, 255), (255, 255), (510, 255), (765, 253)]
    assert flc.augment_net_plan([(72, 512), (512, 588)], 72, 294)["passes"] == [(0, 147),
                                                                                 (147, 147)]
    wide = routes.model_routes({**cfg, "cross_heads": 1, "cross_dim_head": 1025})
    assert wide["stack"].startswith("plain: ") and "1024" in wide["stack"]
    for k in (64, 65, 128, 256):
        assert routes.model_routes({**cfg, "n_neighbors": k})["encoder"] == "kernels"
    assert routes.model_routes({**cfg, "n_neighbors": 257})["encoder"].startswith("plain: ")
    assert routes.model_routes({**cfg, "n_samples_context": 30})["encoder"] != "kernels"
    assert routes.model_routes({**cfg, "n_neighbors": 128,
                                "n_samples_context": 100})["encoder"].startswith("plain: ")
    whole, chunked = routes.knn_smem_bytes(3200, 128), routes.knn_smem_bytes(3201, 128)
    assert whole <= routes.SMEM_LIMIT and chunked <= routes.SMEM_LIMIT // 2 < whole
    assert routes.knn_smem_bytes(16384, 128) == chunked
    for preset in ("dulcet-universe", "swept-energy", "helpful-sponge"):
        dgcnn = ft.get_config(preset)
        for n in (1250, 3201, 4096, 16384, 55553, 57344):
            assert routes.model_routes({**dgcnn, "n_samples_context": n})["encoder"] == "kernels"
    assert routes.sa_select_smem(4458) <= routes.SMEM_LIMIT
    assert routes.sa_select_smem(4459) == routes.sa_select_smem(100000) < routes.SMEM_LIMIT // 8
    for preset in ("good-surf", "summer-terrain"):
        paconv = ft.get_config(preset)
        for n in (4459, 8192, 12662, 12663, 16384, 65536):
            assert routes.model_routes({**paconv, "n_samples_context": n})["encoder"] == "kernels"


@pytest.mark.parametrize("preset,n", [("dulcet-universe", 55000), ("dulcet-universe", 16384),
                                      ("good-surf", 16384)])
def test_routes_read_no_batch_size(preset, n):
    """`model_routes` is a function of the shapes, not of the batch: the
    same verdicts at any batch_size, including the 44 and 442 items a rank
    whose backward scratch passed 2^31 - 1 ints before B6's lists left
    their per-tile counts (the batch now runs in groups of items,
    `_build.knn_bwd_groups`)."""
    cfg = {**ft.get_config(preset), "n_samples_context": n}
    want = routes.model_routes(cfg)
    assert want["encoder"] == "kernels"
    for b in (1, 2, 20, 44, 442, 10 ** 6):
        assert routes.model_routes({**cfg, "batch_size": b}) == want, b


def _case_config(case: str, dtype: str = "bfloat16"):
    cfg = tiny_config(dtype)
    cfg.update(C1_CASES[case][0])
    if case == "k257":
        cfg["n_samples_context"] = 260     # a cloud that holds k = 257, past B3's 256
    if case == "mlp2056":
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
    elif cfg["cross_heads"] * cfg["cross_dim_head"] <= routes.ATTENTION_MAX_D:
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
