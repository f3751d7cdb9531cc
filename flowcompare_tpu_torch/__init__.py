"""PyTorch and CUDA port of flowcompare_tpu for NVIDIA Hopper.

The JAX package `flowcompare_tpu` is the reference; this package imports
neither it nor JAX. The eval, training and sampling paths of all five
shipped presets run here end to end: the DGCNN attention presets
(dulcet-universe, swept-energy), the PAConv presets (good-surf,
summer-terrain) and the global DGCNN with its global conditioner
(helpful-sponge), with hand-written CUDA kernels for every Pallas kernel of
the JAX package (ops/*_cuda.py, csrc/). The data layer (data/, native/)
feeds them from LAS/LAZ scans, pack files or synthetic scenes, with the
JAX package's items.
"""

from .compat.jax_params import load_jax_params, load_jax_train_state
from .configs.presets import PRESETS, derive, get_config
from .data import (AmsVoxelLoader, ChallengeDataset, PackedVoxelDataset, PrefetchedDataset,
                   SyntheticVoxelDataset, batch_iterator, eval_batches, load_cloud,
                   pack_dataset)
from .eval.evaluate import evaluate_on_test, log_prob_to_change
from .model import FlowCompareModel, inner_loop, make_sample
from .train.trainer import data_init_from_batch, init_train_state, train, train_step
from .viz.cloud import save_cloud

__all__ = ["PRESETS", "AmsVoxelLoader", "ChallengeDataset", "FlowCompareModel",
           "PackedVoxelDataset", "PrefetchedDataset", "SyntheticVoxelDataset", "batch_iterator",
           "data_init_from_batch", "derive", "eval_batches", "evaluate_on_test", "get_config",
           "init_train_state", "inner_loop", "load_cloud", "load_jax_params",
           "load_jax_train_state", "log_prob_to_change", "make_sample", "pack_dataset",
           "save_cloud", "train", "train_step"]
