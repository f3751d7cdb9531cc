"""Port parity, the whole eval slice: inner_loop and evaluate_on_test.

The port and the JAX package run the tiny dulcet-universe model on the
same weights (`load_jax_params`) and the same augmenter noise (the port is
handed the draws JAX makes from its keys), on the CPU. The float32 path
matches the JAX float32 path to the polynomial-vs-erf GELU; the port's bf16
kernel-policy path (the plain versions of B4, B2 and B1) is held to bf16
rounding. tests/test_torch_port_cuda.py runs the kernel path on the card
against the plain path.
"""

import numpy as np
import pytest
import torch

import jax

import flowcompare_tpu_torch as ft
from flowcompare_tpu.data.synthetic import SyntheticVoxelDataset
from flowcompare_tpu.eval.evaluate import evaluate_on_test as jax_evaluate_on_test
from flowcompare_tpu.eval.evaluate import log_prob_to_change as jax_log_prob_to_change
from flowcompare_tpu.model import inner_loop as jax_inner_loop
from torch_port_fixtures import N_CONTEXT, N_POINTS, model_pair, n, normal, t

torch.set_num_threads(2)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return normal(rng, 2, N_CONTEXT, 6), normal(rng, 2, N_POINTS, 6), normal(rng, 2, 1)


def _dataset():
    return SyntheticVoxelDataset(n_items=4, batch_size=2, sample_size=N_POINTS,
                                 n_samples_context=N_CONTEXT, include_all=True,
                                 mode="test", seed=0)


def _jax_noise(cfg):
    """The augmenter draws JAX's evaluate_on_test makes: key fold_in(PRNGKey(0), item)."""
    def noise(item, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(0), item)
        return torch.from_numpy(np.array(jax.random.normal(key, shape)))
    return noise


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inner_loop_matches_jax(dtype):
    cfg, jm, jparams, jstate, pm = model_pair(dtype)
    batch = _batch()
    key = jax.random.PRNGKey(11)
    _, lpr, natsr, _ = jax_inner_loop(jm, jparams, jstate, tuple(map(np.asarray, batch)),
                                      rng=key)
    eps = jax.random.normal(key, (2, N_POINTS, cfg["latent_dim"] - cfg["input_dim"]))
    _, lp, nats = ft.inner_loop(pm, tuple(map(t, batch)), eps=t(eps))
    assert lp.shape == (2, N_POINTS) and torch.isfinite(lp).all()
    if dtype == "float32":
        # float32 both sides; GELU polynomial (3.2e-6) vs erf through 3 layers
        np.testing.assert_allclose(n(lp), n(lpr), rtol=1e-4, atol=2e-3)
        assert abs(float(nats) - float(natsr)) < 1e-4
    else:
        # JAX on the CPU takes its bf16 gather encoder, unfolded augmenter and
        # bf16 scan; the port the kernels' algebra (B4, B2, B1 plain versions).
        # Same bf16 policy, different rounding points: ~1% of a log-prob of
        # magnitude ~50, and the ROADMAP's 0.01 nats budget
        np.testing.assert_allclose(n(lp), n(lpr), rtol=2e-2, atol=1.0)
        assert abs(float(nats) - float(natsr)) < 1e-2


def test_evaluate_on_test_matches_jax():
    cfg, jm, jparams, jstate, pm = model_pair()
    nats_r, changes_r = jax_evaluate_on_test(jm, jparams, jstate, _dataset())
    maps = []
    nats, changes = ft.evaluate_on_test(pm, _dataset(), noise=_jax_noise(cfg),
                                        change_maps=maps)
    assert len(changes) == len(changes_r) == 4 and len(maps) == 2
    assert abs(nats - nats_r) < 1e-4
    np.testing.assert_allclose(changes, changes_r, atol=1.0 / N_POINTS + 1e-9)
    assert all(0.0 <= c <= 1.0 for c in changes)
    for m in maps:
        assert m.shape == (2, N_POINTS) and bool(((m >= 0) & (m <= 1)).all())


@pytest.mark.parametrize("multiple", [5.4, 1.0])
def test_change_map_matches_jax(multiple):
    """Per-point change scores of one eval item, both directions stacked as
    evaluate_on_test stacks them, on JAX's noise draw for that item. The
    untrained model flags nothing at 5.4 sigma, so 1 sigma checks a
    non-empty changed set."""
    cfg, jm, jparams, jstate, pm = model_pair()
    v0l, v1s, extra, _, _, _, _, v0s_self, v0l_self, _, _ = next(iter(_dataset()))
    batch = (np.concatenate([v0l, v0l_self]), np.concatenate([v1s, v0s_self]),
             np.concatenate([extra, extra]))
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    _, lpr, _, _ = jax_inner_loop(jm, jparams, jstate, batch, rng=key)
    ref = np.asarray(jax_log_prob_to_change(lpr[:2], lpr[2:], multiple=multiple))
    eps = _jax_noise(cfg)(0, (4, N_POINTS, cfg["latent_dim"] - cfg["input_dim"]))
    _, lp, _ = ft.inner_loop(pm, tuple(map(t, batch)), eps=eps)
    got = n(ft.log_prob_to_change(lp[:2], lp[2:], multiple=multiple))
    # same changed set; scores are min-max rescaled float32 log-probs
    np.testing.assert_array_equal(got > 0, ref > 0)
    assert multiple > 5 or (ref > 0).mean() > 0.01
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_evaluate_on_test_rejects_ragged_batches():
    cfg, _, _, _, pm = model_pair()
    items = list(_dataset())
    ragged = [items[0], [a[:1] if a is not None else None for a in items[1]]]
    with pytest.raises(ValueError, match="uniform batch"):
        ft.evaluate_on_test(pm, ragged, generator=torch.Generator().manual_seed(0))


def test_log_prob_to_change_semantics():
    lp00 = torch.tensor([[0.0, 1.0, 2.0, 3.0, 4.0]])
    lp10 = torch.tensor([[-100.0, 1.0, 2.0, float("-inf"), 4.0]])
    ch = ft.log_prob_to_change(lp10, lp00, multiple=1.0)
    # threshold mean - std = 2 - 1.58; -100 and the clamped -inf are changed
    assert ch[0, 0] == 1.0 and ch[0, 3] == 1.0
    assert (ch[0, [1, 2, 4]] == 0).all()
