"""Weights carried across from the JAX package (no JAX counterpart).

`flowcompare_tpu/model.py::FlowCompareModel.init_params` returns a
(params, state) pair of pytrees; the port stores the same leaves under the
same paths joined by '.' (state under `state.`), so loading is a key map
plus a copy.
"""

from __future__ import annotations

import numpy as np
import torch


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts/lists -> {"a.b.0.c": leaf}."""
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
