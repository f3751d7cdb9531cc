"""PyTorch and CUDA port of flowcompare_tpu for NVIDIA Hopper.

The JAX package `flowcompare_tpu` is the reference; this package imports
neither it nor JAX. The eval path of the DGCNN attention presets
(dulcet-universe) runs here end to end, with hand-written CUDA kernels for
the JAX package's Pallas kernels on that path (ops/*_cuda.py, csrc/).
"""

from .compat.jax_params import load_jax_params
from .configs.presets import PRESETS, derive, get_config
from .eval.evaluate import evaluate_on_test, log_prob_to_change
from .model import FlowCompareModel, inner_loop

__all__ = ["PRESETS", "FlowCompareModel", "derive", "evaluate_on_test", "get_config",
           "inner_loop", "load_jax_params", "log_prob_to_change"]
