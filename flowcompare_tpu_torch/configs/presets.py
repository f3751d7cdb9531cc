"""Experiment configurations, as plain dicts.

Counterpart of `flowcompare_tpu/configs/presets.py`: the same `_BASE` key
census, the same five `PRESETS` and the same `derive` / `get_config`, so a
config built here is equal, key for key, to the JAX package's.
`tests/test_torch_port_core.py` asserts that equality.
"""

from __future__ import annotations

import copy

_BASE = {
    "sample_size": 1024,
    "n_flow_layers": 115,
    "flow_type": "AffineCoupling",
    "hidden_dims": [512, 512, 512],
    "hidden_dims_embedder_out": [512, 512, 512, 512, 512, 512],
    "permuter_type": "LinearLU",
    "input_dim": 6,
    "latent_dim": 300,
    "cif_latent_dim": 300,
    "attn_dim": 512,
    "attn_input_dim": 256,
    "input_embedding_dim": 64,
    "cross_heads": 1,
    "cross_dim_head": 64,
    "attn_dropout": 0.0,
    "input_embedder": "DGCNNembedder",
    "n_neighbors": 40,
    "augmenter_dist": "ConditionalNormal",
    "net_augmenter_dist_hidden_dims": [512, 512, 512],
    "pre_attention_mlp_hidden_dims": [256, 256, 256],
    "net_cif_dist_hidden_dims": [64, 64],
    "affine_cif_hidden": [256, 256, 256],
    "use_attn_augment": True,
    "extra_z_value_context": True,
    "act_norm": True,
    "cif_act_norm": True,
    "affine_scale_fn": "sigmoid",
    "linear_lu_eps": 1e-5,
    "eps_expm": 1e-8,
    "coupling_expm_algo": "torch",
    "clamp_dist": 10.0,
    "coupling_block_nonlinearity": "GELU",
    "num_bins_spline": 8,
    # data
    "n_samples_context": 1250,
    "final_voxel_size": [2.0, 2.0, 4.0],
    "context_voxel_size": [2.2, 2.2, 4.2],
    "clearance": 10,
    "subsample": "fps",
    "normalization": "co_unit_sphere",
    "self_pairs_train": False,
    "data_loader": "AmsVoxelLoader",
    "directory_path_train": "data/ams_train",
    "directory_path_test": "data/ams_test",
    # training
    "batch_size": 20,
    "lr": 1e-4,
    "optimizer_type": "Adam",
    "weight_decay": 0.0,
    "n_epochs": 2,
    "grad_clip_val": 1.0,
    "patience": 2000,
    "lr_factor": 0.8,
    "threshold_scheduler": 0.005,
    "min_lr": 1e-10,
    "amp": False,
    "data_parallel": False,
    "num_workers": 4,
    "batches_per_sample": 15,
    "batches_per_save": 500,
    "make_samples": True,
    "time_stats": False,
    "load_checkpoint": False,
    "preload": True,
    "save_model_path": "save/conditional_flow_compare/",
}


def _preset(**overrides) -> dict:
    cfg = copy.deepcopy(_BASE)
    cfg.update(overrides)
    return cfg


PRESETS = {
    # DGCNN attention + extra context: the flagship preset.
    "dulcet-universe": _preset(),
    "good-surf": _preset(
        input_embedder="PAConv", batch_size=25,
        patience=1000, threshold_scheduler=0.01),
    "helpful-sponge": _preset(
        input_embedder="DGCNNembedderGlobal", input_embedding_dim=124,
        hidden_dims=[512] * 6, hidden_dims_embedder_out=[512] * 4,
        extra_z_value_context=False, batch_size=25,
        patience=1000, threshold_scheduler=0.01),
    "summer-terrain": _preset(
        input_embedder="PAConv", extra_z_value_context=False, batch_size=25),
    "swept-energy": _preset(extra_z_value_context=False),
}


def get_config(name: str) -> dict:
    cfg = copy.deepcopy(PRESETS[name])
    return derive(cfg)


def derive(config: dict) -> dict:
    """Add the derived keys (extra-context width, its flag, global pooling)."""
    extra_context_dim = 1 if config.get("extra_z_value_context") else 0
    config["extra_context_dim"] = extra_context_dim
    config["using_extra_context"] = extra_context_dim > 0
    config["global"] = config["input_embedder"] in ("DGCNNembedderGlobal",)
    return config
