"""Evaluation: test-set nats and per-point change scores.

Counterpart of `flowcompare_tpu/eval/evaluate.py` (`clamp_infs`,
`log_prob_to_change`, `evaluate_on_test` without the mesh, the reverse
direction and the sample dumps). nats is the running mean over items of
-mean(log p(t1 | t0)) * log2(e) / input_dim; a point is changed where
log p(t1 | t0) < mean - 5.4 * std of the self-conditioned baseline
log p(t0 | t0) (unbiased std), scored by a per-voxel min-max rescale.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from ..model import LOG2E, FlowCompareModel, inner_loop


def clamp_infs(x: torch.Tensor) -> torch.Tensor:
    """Replace -inf/+inf by the smallest finite value of the whole tensor."""
    finite = torch.isfinite(x)
    min_finite = torch.where(finite, x, torch.full_like(x, float("inf"))).min()
    return torch.where(finite, x, min_finite)


def log_prob_to_change(log_prob_1_given_0: torch.Tensor,
                       log_prob_0_given_0: torch.Tensor,
                       multiple: float = 5.4) -> torch.Tensor:
    """Per-point change scores in [0, 1], 0 where unchanged."""
    lp10 = clamp_infs(log_prob_1_given_0)
    lp00 = clamp_infs(log_prob_0_given_0)
    base_mean = lp00.mean(-1, keepdim=True)
    base_std = lp00.std(-1, keepdim=True, unbiased=True)
    changed = lp10 < base_mean - multiple * base_std
    max_c = lp10.amax(-1, keepdim=True)
    min_c = lp10.amin(-1, keepdim=True)
    score = 1.0 - (lp10 - min_c) / (max_c - min_c)
    return torch.where(changed, score, torch.zeros_like(score))


@torch.no_grad()
def evaluate_on_test(model: FlowCompareModel, dataset: Iterable, *,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Callable] = None,
                     multiple: float = 5.4,
                     change_maps: Optional[list] = None):
    """Nats and per-voxel changed fractions over eval items.

    `dataset` yields the JAX package's 11-tensor eval items (numpy arrays or
    tensors: v0l, v1s, extra, v1l_self, v1s_self, v_opp_small, v_opp_large,
    v0s_self, v0l_self, v0s_orig, v1s_orig). Each item scores both
    conditioning directions, t1|t0 and t0|t0, stacked on the batch axis.
    The augmenter noise comes from `noise(item_index, shape)` when given,
    else from `generator` (a generator on the model's device). When
    `change_maps` is a list, each item's (B, N) change scores are appended.
    Returns (nats_avg, change_mean_list)."""
    device = next(model.parameters()).device
    c = model.config
    aug_dim = model.latent_dim - model.input_dim
    nats_avg = 0.0
    change_mean_list: list[float] = []
    first_b = None
    for batch_ind, item in enumerate(dataset):
        item = [torch.as_tensor(t, device=device) if t is not None else None for t in item]
        v0l, v1s, extra, _v1l_self, _v1s_self, _vos, _vol, v0s_self, v0l_self = item[:9]
        b = v1s.shape[0]
        # the running mean of per-item means is the reference metric only
        # when every item has the same batch size
        if first_b is None:
            first_b = b
        elif b != first_b:
            raise ValueError(
                f"evaluate_on_test needs uniform batch sizes (running mean of "
                f"per-batch means); got batch {batch_ind} of size {b} after {first_b}")
        extra_s = (torch.cat([extra, extra]) if extra is not None and c["using_extra_context"]
                   else None)
        stacked = (torch.cat([v0l, v0l_self]), torch.cat([v1s, v0s_self]), extra_s)
        shape = (2 * b, v1s.shape[1], aug_dim)
        eps = (noise(batch_ind, shape) if noise is not None
               else torch.randn(shape, generator=generator, device=device))
        _, log_prob, _ = inner_loop(model, stacked, eps=eps.to(device=device,
                                                               dtype=torch.float32))
        lp_1_0, lp_0_0 = log_prob[:b], log_prob[b:2 * b]
        change_1_0 = log_prob_to_change(lp_1_0, lp_0_0, multiple=multiple)
        frac_fwd = (change_1_0 > 0).float().mean(-1)
        nats_item = -lp_1_0.mean() * LOG2E / c["input_dim"]
        if change_maps is not None:
            change_maps.append(change_1_0)
        change_mean_list.extend(frac_fwd.tolist())
        nats_avg = (nats_avg * batch_ind + float(nats_item)) / (batch_ind + 1)
    return nats_avg, change_mean_list
