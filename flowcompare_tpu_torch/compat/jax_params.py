"""Weights and training state carried across from the JAX package (no JAX
counterpart).

`flowcompare_tpu/model.py::FlowCompareModel.init_params` returns a
(params, state) pair of pytrees; the port stores the same leaves under the
same paths joined by '.' (state under `state.`), so loading is a key map
plus a copy. `load_jax_train_state` carries optax's Adam moments and the
plateau state into the port's optimizer and plateau, so a run can resume
from a JAX train state.
"""

from __future__ import annotations

import numpy as np
import torch


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts/lists -> {"a.b.0.c": leaf}. None leaves (PAConv's
    ScoreNet keeps `"bn": None` on its last layer, as a JAX pytree does)
    give no key, as they give no parameter in the model."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        out.update(flatten_tree(value, f"{prefix}.{key}" if prefix else str(key)))
    return out


def load_jax_params(model: torch.nn.Module, params_np, state_np) -> None:
    """Copy a JAX (params, state) pair, as numpy arrays, into the model.

    Raises KeyError when the two key sets differ and ValueError on a shape
    mismatch, so a partial load cannot pass silently."""
    flat = flatten_tree(params_np)
    flat.update(flatten_tree(state_np, "state"))
    own = model.state_dict()
    missing = sorted(set(own) - set(flat))
    unexpected = sorted(set(flat) - set(own))
    if missing or unexpected:
        raise KeyError(f"parameter keys differ: missing {missing[:8]}, "
                       f"unexpected {unexpected[:8]}")
    with torch.no_grad():
        for key, target in own.items():
            value = torch.from_numpy(np.array(flat[key], dtype=np.float32))
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{key}: shape {tuple(value.shape)} != {tuple(target.shape)}")
            target.copy_(value)


def _find_adam(tree):
    """optax's ScaleByAdamState (count, mu, nu) inside a chain's state tuple."""
    if all(hasattr(tree, a) for a in ("mu", "nu", "count")):
        return tree
    for child in tree if isinstance(tree, tuple) else ():
        found = _find_adam(child)
        if found is not None:
            return found
    return None


def load_jax_train_state(trainer_state, opt_state_np, plateau_np) -> None:
    """Carry a JAX train state's optax Adam moments (mu, nu, count) and its
    PlateauState (lr, best, num_bad) into a port `TrainState` whose model
    already holds the matching weights (`load_jax_params`).

    Raises KeyError when the moment trees do not cover the model's
    parameters and ValueError on a shape mismatch."""
    from ..train.optim import PlateauState

    adam = _find_adam(opt_state_np)
    if adam is None:
        raise KeyError("no ScaleByAdamState (mu, nu, count) in the optimizer state")
    mu, nu = flatten_tree(adam.mu), flatten_tree(adam.nu)
    count = float(np.asarray(adam.count))
    opt = trainer_state.optimizer
    for name, p in trainer_state.model.named_parameters():
        if name not in mu or name not in nu:
            raise KeyError(f"{name}: no Adam moments in the JAX state")
        m = torch.from_numpy(np.array(mu[name], dtype=np.float32))
        v = torch.from_numpy(np.array(nu[name], dtype=np.float32))
        if tuple(m.shape) != tuple(p.shape) or tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"{name}: moments {tuple(m.shape)} != {tuple(p.shape)}")
        opt.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                        "exp_avg": m.to(p.device), "exp_avg_sq": v.to(p.device)}
    trainer_state.plateau = PlateauState(lr=float(np.float32(plateau_np.lr)),
                                         best=float(np.float32(plateau_np.best)),
                                         num_bad=int(plateau_np.num_bad))
