"""Port parity, the sampling slice: the inverse flows, B7 and make_sample.

The port runs on the CPU here (its plain paths) against the JAX package on
the same weights (`load_jax_params`) and the same inputs, made from a seed
with numpy, or the same latent draw, handed over from the JAX key. The
float32 paths agree to summation order and the JAX package's polynomial
GELU (3.2e-6 from the exact erf), amplified through the inverse's division
by the coupling scale; the bf16 paths to bf16 rounding.
B7's plain version is held to the Pallas inverse kernels in interpret mode
on one layer (interpret mode is only safe on one layer: the kernels'
aliased carry assumes sequential grid steps). tests/test_torch_port_cuda.py
holds the CUDA B7 against its plain version on the card.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flowcompare_tpu_torch as ft
from flowcompare_tpu.core.mlp import gelu as jgelu
from flowcompare_tpu.data.synthetic import SyntheticVoxelDataset
from flowcompare_tpu.eval.evaluate import evaluate_on_test as jax_evaluate_on_test
from flowcompare_tpu.flows import actnorm as jactnorm
from flowcompare_tpu.flows import coupling as jcoupling
from flowcompare_tpu.flows import permuters as jperm
from flowcompare_tpu.model import make_sample as jax_make_sample
from flowcompare_tpu.ops import flow_layer_pallas as flp
from flowcompare_tpu.train import trainer as jtrainer
from flowcompare_tpu_torch.core.mlp import gelu
from flowcompare_tpu_torch.flows import actnorm, coupling, distributions, permuters
from flowcompare_tpu_torch.ops import flow_layer_cuda as flc
from torch_port_fixtures import N_CONTEXT, N_POINTS, model_pair, n, normal, t

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _folded_inverse_pair(dtype="float32"):
    """(cfg, jax model, jax params, JAX fold_stacks_inverse, port model, port's)."""
    cfg, jm, jparams, _, pm = model_pair(dtype)
    lat = cfg["latent_dim"]
    prep = jm._prepare_layers(jparams["layers"])
    stacks = flp.append_final_block(flp.build_layer_stacks(jm, prep),
                                    jparams["final_block"], lat)
    jf = flp.fold_stacks_inverse(stacks, flp.fold_stacks(stacks, split=lat // 2, extra_dim=1))
    return cfg, jm, jparams, jf, pm, pm._folded_inverse(pm.params(), 1)


def _sample_inputs(cfg, seed=0, b=2):
    """z as JAX's model.sample draws it (0.6 * normal(key)), context, extra."""
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    z = 0.6 * jax.random.normal(key, (b, N_POINTS, cfg["latent_dim"]))
    ctx = normal(rng, b, N_CONTEXT, cfg["input_embedding_dim"])
    extra = normal(rng, b, N_POINTS, 1)
    return key, z, ctx, extra


def _one_layer(folded):
    return flc.layer_slice(folded, 0)


def test_normal_sample_scale_and_shape():
    g = torch.Generator().manual_seed(0)
    z = distributions.normal_sample((4, 5000), 0.0, 0.6, generator=g)
    assert z.shape == (4, 5000) and z.dtype == torch.float32
    # 20,000 draws: the sample std is within 2% of 0.6
    assert abs(float(z.std()) - 0.6) < 0.012 and abs(float(z.mean())) < 0.012


def test_actnorm_inverse_matches_jax():
    rng = np.random.default_rng(0)
    p = {"shift": normal(rng, 1, 12), "log_scale": normal(rng, 1, 12) * 0.3}
    z = normal(rng, 2, 40, 12)
    got = actnorm.actnorm_inverse({k: t(v) for k, v in p.items()}, t(z))
    ref = jactnorm.actnorm_inverse({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(z))
    # float32 elementwise: one exp and one fma
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-6, atol=1e-6)
    back, _ = actnorm.actnorm_forward({k: t(v) for k, v in p.items()}, got)
    np.testing.assert_allclose(n(back), z, rtol=1e-5, atol=1e-5)


def test_linear_lu_inverse_matches_jax():
    cfg, _, jparams, _, pm = model_pair()
    eps = cfg["linear_lu_eps"]
    jlu = jperm.linear_lu_prepare_inverse_stack(jparams["layers"]["permuter"], eps=eps)
    tlu = permuters.linear_lu_prepare_inverse_stack(pm.params()["layers"]["permuter"], eps=eps)
    for k in ("lower", "upper"):
        np.testing.assert_allclose(n(tlu[k]), n(jlu[k]), rtol=1e-6, atol=1e-7)
    z = normal(np.random.default_rng(1), 2, N_POINTS, cfg["latent_dim"])
    for l in range(cfg["n_flow_layers"] - 1):
        ref = jperm.linear_lu_inverse({k: v[l] for k, v in jlu.items()}, jnp.asarray(z))
        got = permuters.linear_lu_inverse({k: v[l] for k, v in tlu.items()}, t(z))
        # float32 triangular solves of a well-conditioned 32 x 32 system
        np.testing.assert_allclose(n(got), n(ref), rtol=1e-5, atol=1e-5)
        raw = {k: v[l] for k, v in pm.params()["layers"]["permuter"].items()}
        back, _ = permuters.linear_lu_forward(raw, got, eps=eps)
        np.testing.assert_allclose(n(back), z, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_affine_coupling_inverse_matches_jax(dtype):
    cfg, _, jparams, _, pm = model_pair()
    rng = np.random.default_rng(2)
    lat = cfg["latent_dim"]
    y = normal(rng, 2, N_POINTS, lat)
    ctx = normal(rng, 2, N_POINTS, cfg["attn_dim"] + 1)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["block"]["coupling"])
    tp = jax.tree_util.tree_map(lambda a: a[0], pm.params()["layers"]["block"]["coupling"])
    jdt, tdt = (None, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    ref = jcoupling.affine_coupling_inverse(jp, jnp.asarray(y), jnp.asarray(ctx), nonlin=jgelu,
                                            dtype=jdt)
    got = coupling.affine_coupling_inverse(tp, t(y), t(ctx), nonlin=gelu, dtype=tdt)
    if dtype == "float32":
        # the polynomial GELU (3.2e-6) through the MLP, divided by the scale
        np.testing.assert_allclose(n(got), n(ref), rtol=1e-4, atol=1e-4)
        back, _ = coupling.affine_coupling_forward(tp, got, t(ctx), nonlin=gelu)
        np.testing.assert_allclose(n(back), y, rtol=1e-4, atol=1e-4)
    else:
        # bf16 MLP operands: a flipped rounding moves s and t by about 1%
        assert _rel(n(got), n(ref)) < 2e-2


def test_fold_stacks_inverse_matches_jax():
    cfg, _, _, jf, _, tf = _folded_inverse_pair()
    # float32; jnp.linalg.inv and torch.linalg.inv differ in their last bits
    for key in ("lu_w_inv_f", "lu_shift"):
        np.testing.assert_allclose(n(tf[key]), n(jf[key]), rtol=1e-4, atol=1e-6, err_msg=key)
    assert tf["lu_w_inv_f"].shape[0] == cfg["n_flow_layers"]
    # Minv undoes the folded forward tail: (y @ lu_w_f^T + lu_b) @ Minv^T + shift = y
    y = t(normal(np.random.default_rng(3), 5, cfg["latent_dim"]))
    for l in range(cfg["n_flow_layers"]):
        zl = y @ tf["lu_w_f"][l].T + tf["lu_b"][l, 0]
        back = zl @ tf["lu_w_inv_f"][l].T + tf["lu_shift"][l, 0]
        np.testing.assert_allclose(n(back), n(y), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernel", ["row_major", "transposed"])
def test_inverse_plain_matches_pallas_interpret_one_layer(kernel, monkeypatch):
    cfg, _, _, jf, _, tf = _folded_inverse_pair("bfloat16")
    _, z, ctx, extra = _sample_inputs(cfg, seed=4)
    monkeypatch.setattr(flp, "_TRANSPOSED_EVAL", kernel == "transposed")
    ref = flp.fused_flow_layers_inverse(z, jnp.asarray(ctx), jnp.asarray(extra), _one_layer(jf),
                                        interpret=True)
    got = flc.fused_flow_layers_inverse(t(z), t(ctx), t(extra), _one_layer(tf))
    # bf16 operands on both sides, a different softmax stabiliser (max-subtract
    # vs clamp) and GELU (erf vs polynomial): B1's one-layer bound
    assert float(np.abs(n(got) - n(ref)).max()) < 3e-2


@pytest.mark.parametrize("path", ["unfolded", "folded"])
def test_sample_f32_matches_jax(path):
    """The f32 sample: the port's unfolded reverse scan (what compute_dtype
    float32 runs) and its f32 folded inverse (B7's spec at f32), against
    JAX model.sample at f32 (its unfolded scan on the CPU) on the same z."""
    cfg, jm, jparams, _, pm, tf = _folded_inverse_pair()
    key, z, ctx, extra = _sample_inputs(cfg, seed=5)
    ref = jm.sample(jparams, key, 2, N_POINTS, jnp.asarray(ctx), jnp.asarray(extra))
    if path == "unfolded":
        got = pm.sample(t(z), t(ctx), t(extra))
    else:
        got = flc.folded_inverse_scan_core(t(z), t(ctx), t(extra), tf)[..., :cfg["input_dim"]]
    assert got.shape == (2, N_POINTS, cfg["input_dim"])
    # float32 through 3 inverted layers; the solves against the folded inverse
    # and the polynomial GELU, divided by scales down to about 0.5
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-4, atol=2e-4)


def test_sample_bf16_plain_matches_jax_bf16_scan():
    """The port's bf16 plain B7 path through model.sample against JAX's bf16
    unfolded scan (what JAX samples with on the CPU)."""
    cfg, jm, jparams, _, pm, _ = _folded_inverse_pair("bfloat16")
    key, z, ctx, extra = _sample_inputs(cfg, seed=6)
    ref = jm.sample(jparams, key, 2, N_POINTS, jnp.asarray(ctx), jnp.asarray(extra))
    got = pm.sample(t(z), t(ctx), t(extra))
    # same bf16 policy, different rounding points (the folded Minv product
    # against two f32 triangular solves, folded LayerNorm): a few bf16 ulps
    # of values of magnitude ~2, through 3 layers
    assert float(np.abs(n(got) - n(ref)).max()) < 5e-2
    assert _rel(n(got), n(ref)) < 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_sample_matches_jax(dtype):
    cfg, jm, jparams, jstate, pm = model_pair(dtype)
    rng = np.random.default_rng(7)
    x0, extra = normal(rng, 2, N_CONTEXT, 6), normal(rng, 2, 1)
    key = jax.random.PRNGKey(8)
    ref = jax_make_sample(jm, jparams, jstate, key, N_POINTS, jnp.asarray(x0),
                          jnp.asarray(extra))
    z = 0.6 * jax.random.normal(key, (2, N_POINTS, cfg["latent_dim"]))
    got = ft.make_sample(pm, N_POINTS, t(x0), t(extra), z=t(z))
    assert got.shape == ref.shape == (2, N_POINTS, cfg["input_dim"])
    if dtype == "float32":
        # the f32 encoder and sampler: summation order and the polynomial GELU
        np.testing.assert_allclose(n(got), n(ref), rtol=1e-4, atol=3e-4)
    else:
        # JAX's bf16 gather encoder and unfolded scan against the port's B4
        # and B7 plain versions: bf16 rounding at other points
        assert _rel(n(got), n(ref)) < 3e-2


def test_make_sample_draws_from_the_generator():
    cfg, _, _, _, pm = model_pair()
    rng = np.random.default_rng(9)
    x0, extra = t(normal(rng, 1, N_CONTEXT, 6)), t(normal(rng, 1, 1))
    a = ft.make_sample(pm, 50, x0, extra, generator=torch.Generator().manual_seed(3))
    b = ft.make_sample(pm, 50, x0, extra, generator=torch.Generator().manual_seed(3))
    c = ft.make_sample(pm, 50, x0, extra, generator=torch.Generator().manual_seed(4))
    assert a.shape == (1, 50, cfg["input_dim"]) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    z = distributions.normal_sample((1, 50, cfg["latent_dim"]), 0.0, 0.6,
                                    generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, ft.make_sample(pm, 50, x0, extra, z=z))


def test_round_trip_f32():
    """z -> the f32 folded inverse -> the f32 folded forward -> z, and the
    unfolded inverse against the folded one."""
    cfg, _, _, _, pm, tf = _folded_inverse_pair()
    _, z, ctx, extra = _sample_inputs(cfg, seed=10)
    x = flc.folded_inverse_scan_core(t(z), t(ctx), t(extra), tf)
    zr, _ = flc.folded_scan_core(x, torch.zeros(2, N_POINTS), t(ctx), t(extra), tf, nonlin=gelu)
    # float32 through 3 layers each way: the inverse's folded Minv against the
    # forward's folded LinearLU
    np.testing.assert_allclose(n(zr), n(z), rtol=1e-4, atol=1e-4)
    unfolded = pm._sample_unfolded(pm.params(), t(z), t(ctx), t(extra))
    np.testing.assert_allclose(n(unfolded), n(x), rtol=1e-4, atol=1e-4)


def test_round_trip_bf16_gap_within_the_jax_kernels():
    """The bf16 round trip z -> inverse -> forward -> z': the port's plain
    bf16 folded inverse (B7's plain version) then its plain bf16 folded
    forward (B1's), against the JAX package's bf16 Pallas kernels
    `fused_flow_layers_inverse_t` then `fused_flow_layers_t` in interpret
    mode, layer by layer (interpret mode is only safe on one layer), on the
    same weights and the same z. bf16 operands make neither direction the
    exact inverse of the other; the port's mean gap must stay within 1.25
    times the JAX kernels' own, and its largest (one point's rounding
    flips) within twice theirs."""
    cfg, _, _, jf, _, tf = _folded_inverse_pair("bfloat16")
    _, z, ctx, extra = _sample_inputs(cfg, seed=11)
    n_layers, zeros = cfg["n_flow_layers"], np.zeros((2, N_POINTS), np.float32)
    x = flc.fused_flow_layers_inverse(t(z), t(ctx), t(extra), tf)
    z_port, _ = flc.fused_flow_layers(x, t(zeros), t(ctx), t(extra), tf)
    h = jnp.asarray(z)
    for l in reversed(range(n_layers)):
        h = flp.fused_flow_layers_inverse_t(h, jnp.asarray(ctx), jnp.asarray(extra),
                                            flc.layer_slice(jf, l), interpret=True)
    ldj = jnp.asarray(zeros)
    for l in range(n_layers):
        h, ldj = flp.fused_flow_layers_t(h, ldj, jnp.asarray(ctx), jnp.asarray(extra),
                                         flc.layer_slice(jf, l), interpret=True)
    d_port, d_jax = np.abs(n(z_port) - n(z)), np.abs(n(h) - n(z))
    assert 0.0 < d_port.mean() <= 1.25 * d_jax.mean(), (d_port.mean(), d_jax.mean())
    assert d_port.max() <= 2.0 * d_jax.max(), (d_port.max(), d_jax.max())


def _train_batches(k):
    rng = np.random.default_rng(50)
    return [(normal(rng, 2, N_CONTEXT, 6), normal(rng, 2, N_POINTS, 6), normal(rng, 2, 1))
            for _ in range(k)]


def test_train_sample_cadence_matches_jax(tmp_path):
    """Three batches an epoch, five steps, a sample every second batch of an
    epoch: the port writes the files the JAX trainer writes, each a finite
    4000-point sample of the batch's first context cloud."""
    cfg, jm, _, _, pm = model_pair()
    for c in (jm.config, pm.config):
        c.update(batches_per_sample=2, make_samples=True, batches_per_save=100)
    data = _train_batches(3)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jtrainer.train(jm, data, save_dir=str(jdir), run_name="tiny", max_steps=5)
    ft.train(pm, data, generator=torch.Generator().manual_seed(0), save_dir=str(pdir),
             run_name="tiny", max_steps=5)
    names = sorted(os.path.basename(p) for p in glob.glob(str(pdir / "sample_*.npz")))
    ref = sorted(os.path.basename(p) for p in glob.glob(str(jdir / "sample_*.npz")))
    assert names == ref == ["sample_tiny_1.npz", "sample_tiny_4.npz"]
    for name in names:
        got, want = np.load(pdir / name), np.load(jdir / name)
        assert got["gen"].shape == want["gen"].shape == (4000, cfg["input_dim"])
        assert np.isfinite(got["gen"]).all()
        np.testing.assert_array_equal(got["cond"], want["cond"])


def _eval_dataset():
    return SyntheticVoxelDataset(n_items=4, batch_size=2, sample_size=N_POINTS,
                                 n_samples_context=N_CONTEXT, include_all=True,
                                 mode="test", seed=0)


def test_evaluate_generate_samples_file_names(tmp_path):
    """evaluate_on_test(generate_samples=True) writes the JAX package's three
    clouds per item, named by the item's changed fraction and index."""
    cfg, jm, jparams, jstate, pm = model_pair()
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jax_evaluate_on_test(jm, jparams, jstate, _eval_dataset(), generate_samples=True,
                         samples_dir=str(jdir), n_gen_points=100)

    def eps(item, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(0), item)
        return t(jax.random.normal(key, shape))

    ft.evaluate_on_test(pm, _eval_dataset(), noise=eps, generate_samples=True,
                        samples_dir=str(pdir), n_gen_points=100,
                        generator=torch.Generator().manual_seed(0))
    names = sorted(os.listdir(pdir))
    ref = sorted(os.listdir(jdir))
    assert len(names) == len(ref) == 6
    # the changed fraction in the name agrees to one point of N, as the
    # fractions of test_evaluate_on_test_matches_jax do
    for a, b in zip(names, ref):
        (ca, rest_a), (cb, rest_b) = a.split("_", 1), b.split("_", 1)
        assert rest_a == rest_b and abs(float(ca) - float(cb)) <= 1.0 / N_POINTS + 5e-3
    gen = np.load(pdir / [nm for nm in names if "gen_given_0" in nm][0])
    assert gen["points"].shape == (100, 3) and gen["rgb"].shape == (100, 3)
    assert np.isfinite(gen["points"]).all() and (0 <= gen["rgb"]).all() and (gen["rgb"] <= 1).all()
