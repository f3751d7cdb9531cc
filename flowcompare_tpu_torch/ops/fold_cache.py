"""One fold per weights version: the cache B2 and B4 keep their kernel-layout
weights in.

No JAX counterpart: under `jit` the JAX package folds inside the traced
function, and XLA hoists what does not change. Here a fold is a few dozen
small device ops and host work before the first launch, which at a small
batch takes longer than the kernels it feeds; so it runs once per weights
version. An entry is keyed on its source tensors by identity (weak
references, so an entry whose sources were freed is dropped) and by each
one's `_version`, which every in-place change bumps: an optimizer step,
`FlowCompareModel.load_state` and `compat.jax_params.load_jax_params` all
copy into the tensors in place, so each makes the next lookup fold again.
"""

from __future__ import annotations

import weakref
from typing import Callable

import torch


def tensor_leaves(tree) -> list:
    """The tensors of nested dicts, lists and tuples, in a fixed order; other
    leaves (None, ints) are left out."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for key in tree for t in tensor_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in tensor_leaves(item)]
    return []


class FoldCache:
    """The last `size` folds, each with the identity and versions of the
    tensors it was made from."""

    def __init__(self, size: int = 4):
        self.size = size
        self._entries = []          # (weak refs, versions, key, value)

    def get(self, sources: list, key, build: Callable):
        """build()'s value for these sources as they are now: the cached one
        if every source is the same tensor at the same version under `key`,
        else a new one from build(), which replaces any entry of the same
        sources."""
        versions = [t._version for t in sources]
        live, hit = [], None
        for entry in self._entries:
            refs, old_versions, old_key, value = entry
            objs = [r() for r in refs]
            if any(o is None for o in objs):
                continue
            same = len(objs) == len(sources) and all(o is s for o, s in zip(objs, sources))
            if same and old_key == key:
                if old_versions == versions:
                    hit = value
                else:
                    continue          # a stale fold of these very tensors
            live.append(entry)
        self._entries = live
        if hit is not None:
            return hit
        value = build()
        self._entries = (live + [([weakref.ref(t) for t in sources], versions, key,
                                  value)])[-self.size:]
        return value
