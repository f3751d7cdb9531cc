"""Layers: linear initialisers, the residual MLP and the cross attention
(counterpart of `flowcompare_tpu/core/__init__.py`)."""

from .initializers import apply_linear, orthogonal, torch_linear, xavier_normal
from .mlp import NONLINEARITIES, apply_mlp, gelu, init_mlp
from .attention import (
    apply_cross_attention,
    apply_layer_norm,
    init_cross_attention,
    init_layer_norm,
)

__all__ = [
    "apply_linear", "torch_linear", "xavier_normal", "orthogonal",
    "NONLINEARITIES", "apply_mlp", "gelu", "init_mlp",
    "apply_cross_attention", "apply_layer_norm",
    "init_cross_attention", "init_layer_norm",
]
