"""The convergence demo of examples/convergence_demo.py on the PyTorch port:
train on synthetic scenes, then score change on held-out scenes with known
truth. It imports no JAX.

    python3 examples/convergence_demo_torch.py [--out save/demo_torch/]
        [--device cuda|cpu] [--cross-dim-head 32] [--steps 240]

The JAX demo's configuration (dulcet-universe reduced to 24 layers, latent
64, widths 256, cross_dim_head 32, bf16), data (SyntheticVoxelDataset:
training seed 1 with no change, eval seed 777 with half the scenes
changed), 240 steps at B=8, truth rule and pairwise AUC. Noise comes from
torch generators (training seed 0, eval seed 5), so the loss curve is not
the JAX run's. At cross_dim_head 32 the layer stack and the augmenter take
the plain route on the card (their attention kernels take a head width of
64; `model.routes`) and the DGCNN encoder its kernels; at 64 every part
runs on its kernels.

Writes <out>/result.json with the JAX demo's keys (nats, auc,
changed_mean, unchanged_mean, loss_first8, loss_last8), plus the routes,
the kernels' launches in training and in eval, wall and step times, and
the device: torch's name for it and nvidia-smi's name and power limit.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import flowcompare_tpu_torch as ft  # noqa: E402
from flowcompare_tpu_torch.data import PrefetchedDataset, SyntheticVoxelDataset  # noqa: E402
from flowcompare_tpu_torch.ops import (dgcnn_cuda, edgeconv_cuda, edgeconv_vjp_cuda,  # noqa: E402
                                       flow_layer_cuda, flow_layer_vjp_cuda)
from flowcompare_tpu_torch.train.metrics import JsonlWriter  # noqa: E402

N_TRAIN, N_EVAL, BATCH, EVAL_BATCH = 64, 24, 8, 4
SAMPLE, CONTEXT = 512, 640

COUNTERS = {"B1": (flow_layer_cuda, "FUSED_FLOW_LAYERS_LAUNCHES"),
            "B1 with saves": (flow_layer_cuda, "FUSED_FLOW_LAYERS_SAVE_LAUNCHES"),
            "B2": (flow_layer_cuda, "FUSED_AUGMENTER_LAUNCHES"),
            "B3": (edgeconv_cuda, "EDGE_NEIGHBOR_MAX_LAUNCHES"),
            "B4": (dgcnn_cuda, "FUSED_DGCNN_ENCODER_LAUNCHES"),
            "B5": (flow_layer_vjp_cuda, "FLOW_LAYERS_BWD_LAUNCHES"),
            "B6": (edgeconv_vjp_cuda, "EDGE_KNN_REDUCE_LAUNCHES"),
            "B7": (flow_layer_cuda, "FUSED_FLOW_LAYERS_INVERSE_LAUNCHES")}


def demo_config(cross_dim_head: int = 32) -> dict:
    """examples/convergence_demo.py's configuration."""
    cfg = ft.get_config("dulcet-universe")
    cfg.update(dict(
        n_flow_layers=24, latent_dim=64, cif_latent_dim=64,
        hidden_dims=[256, 256], net_augmenter_dist_hidden_dims=[256, 256],
        pre_attention_mlp_hidden_dims=[128, 128], hidden_dims_embedder_out=[256, 256],
        attn_dim=128, attn_input_dim=64, input_embedding_dim=32, cross_dim_head=cross_dim_head,
        sample_size=SAMPLE, n_samples_context=CONTEXT, n_neighbors=20, batch_size=BATCH,
        n_epochs=30, lr=4e-4, batches_per_save=64, batches_per_sample=10**9,
        make_samples=False, compute_dtype="bfloat16", patience=400))
    return ft.derive(cfg)


def truth(n_items: int) -> np.ndarray:
    """Whether eval item i's object was removed (the dataset's own draw)."""
    return np.array([np.random.default_rng(777 * 100003 + i).uniform() < 0.5
                     for i in range(n_items)])


def pairwise_auc(scores: np.ndarray, changed: np.ndarray) -> float:
    """The share of (changed, unchanged) pairs whose changed item scores higher."""
    pairs = list(itertools.product(scores[changed], scores[~changed]))
    return float(np.mean([a > b for a, b in pairs])) if pairs else float("nan")


def launches() -> dict:
    return {key: getattr(module, attr) for key, (module, attr) in COUNTERS.items()}


def reset_launches() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def nvidia_smi() -> str | None:
    """The card's name and power limit as nvidia-smi gives them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0]


def run(out: Path, device: str, cross_dim_head: int, steps: int) -> dict:
    t_start = time.perf_counter()
    out.mkdir(parents=True, exist_ok=True)
    cfg = demo_config(cross_dim_head)
    model = ft.FlowCompareModel(cfg, device=device, generator=torch.Generator().manual_seed(0))
    print(f"routes: {dict(model.routes)}", flush=True)
    data = PrefetchedDataset(SyntheticVoxelDataset(
        n_items=N_TRAIN, batch_size=BATCH, sample_size=SAMPLE, n_samples_context=CONTEXT,
        with_extra=True, mode="train", seed=1, change_fraction=0.0))
    metrics = out / "metrics.jsonl"
    if metrics.exists():
        metrics.unlink()
    writer = JsonlWriter(str(metrics))
    reset_launches()
    sync(device)
    t0 = time.perf_counter()
    try:
        ft.train(model, data, generator=torch.Generator(device=device).manual_seed(0),
                 writer=writer, save_dir=str(out), run_name="demo", max_steps=steps,
                 save_final=True)
    finally:
        writer.close()
    sync(device)
    train_s = time.perf_counter() - t0
    train_launches = launches()
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    losses = [r["loss"] for r in rows]
    print(f"trained {steps} steps in {train_s:.1f} s: loss first8 {np.mean(losses[:8]):.3f} "
          f"-> last8 {np.mean(losses[-8:]):.3f}", flush=True)

    eval_ds = SyntheticVoxelDataset(
        n_items=N_EVAL, batch_size=EVAL_BATCH, sample_size=SAMPLE, n_samples_context=CONTEXT,
        with_extra=True, mode="test", include_all=True, seed=777, change_fraction=0.5)
    reset_launches()
    t0 = time.perf_counter()
    nats, change_means = ft.evaluate_on_test(
        model, eval_ds, generator=torch.Generator(device=device).manual_seed(5))
    sync(device)
    eval_s = time.perf_counter() - t0
    cm, t = np.asarray(change_means), truth(N_EVAL)
    result = {
        "nats": float(nats), "auc": pairwise_auc(cm, t),
        "changed_mean": float(cm[t].mean()) if t.any() else float("nan"),
        "unchanged_mean": float(cm[~t].mean()) if (~t).any() else float("nan"),
        "loss_first8": float(np.mean(losses[:8])), "loss_last8": float(np.mean(losses[-8:])),
        "routes": dict(model.routes), "cross_dim_head": cross_dim_head, "steps": steps,
        "launches": {"train": train_launches, "eval": launches()},
        # the first step holds the ActNorm data init's warm-up; the rest are steady
        "step_ms": 1e3 * float(np.median([r["time_batch"] for r in rows[1:]] or
                                         [rows[0]["time_batch"]])),
        "train_s": train_s, "eval_s": eval_s, "wall_s": time.perf_counter() - t_start,
        "device": (torch.cuda.get_device_name(0) if torch.device(device).type == "cuda"
                   else "cpu"),
        "nvidia_smi": nvidia_smi(),
    }
    print(f"nats={result['nats']:.3f} changed_frac: changed={result['changed_mean']:.3f} "
          f"unchanged={result['unchanged_mean']:.3f} AUC={result['auc']:.3f}", flush=True)
    (out / "result.json").write_text(json.dumps(result))
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="save/demo_torch/")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--cross-dim-head", type=int, default=32)
    parser.add_argument("--steps", type=int, default=240)
    args = parser.parse_args(argv)
    run(Path(args.out), args.device, args.cross_dim_head, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
