"""PyTorch and CUDA port of flowcompare_tpu for NVIDIA Hopper.

The JAX package `flowcompare_tpu` is the reference; this package imports
neither it nor JAX. The eval, training and sampling paths of the DGCNN
attention presets (dulcet-universe, swept-energy) and the PAConv presets
(good-surf, summer-terrain) run here end to end, with hand-written CUDA
kernels for the JAX package's Pallas kernels on those paths (ops/*_cuda.py,
csrc/).
"""

from .compat.jax_params import load_jax_params, load_jax_train_state
from .configs.presets import PRESETS, derive, get_config
from .eval.evaluate import evaluate_on_test, log_prob_to_change
from .model import FlowCompareModel, inner_loop, make_sample
from .train.trainer import data_init_from_batch, init_train_state, train, train_step
from .viz.cloud import save_cloud

__all__ = ["PRESETS", "FlowCompareModel", "data_init_from_batch", "derive", "evaluate_on_test",
           "get_config", "init_train_state", "inner_loop", "load_jax_params",
           "load_jax_train_state", "log_prob_to_change", "make_sample", "save_cloud", "train",
           "train_step"]
