#!/usr/bin/env python3
"""How far the wide configs' bf16 paths land from the same model in f32 on
the card: the floor under chip_smoke.py's |d nats| checks of the kernels
against the plain route.

    python3 tools/torch_wide_floor.py [--runs dulcet-universe w1024 w2048] [--out FILE]
                                      [--train-samples B]

For each run, chip_smoke.py's model (bf16, 115 layers, random weights from
its seed; "w1024" / "w2048" are chip_smoke.WIDE_RUNS) and the inputs of
three of its checks:
  eval    `evaluate_on_test` over the eval main path's two items of B=20
          and noise (`phase_main_path`)
  sample  `make_sample` of 1 x 4000 from `phase_sample_main`'s z, every
          sample scored by the f32 model's `inner_loop` on the same eps
  train   one `train_step` at B=2 after the data init (`phase_train_check`)
each through the kernels, through the plain route (plain=True) and through
the plain route of a float32 model holding the same weights. With
--train-samples B, also `phase_train_main`'s `train(max_steps=4,
make_samples=True)` at batch B, from the same weights, through the
kernels and through the plain route: each path's losses and whether its
two samples are finite (the model after a few steps of random weights can
sample off the float range). Prints and
writes to --out each path's nats and the three distances between them;
the nats are bits per input dimension of a log-probability summed over the
latent's dimensions, so at w2048's 1,024-wide latent a bf16 rounding
difference moves them about as much as 3.5 times as many dimensions do.
Needs one NVIDIA H100 and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import flowcompare_tpu_torch as ft  # noqa: E402
from flowcompare_tpu_torch.model import inner_loop  # noqa: E402
from flowcompare_tpu_torch.ops import _build  # noqa: E402


def f32_twin(model):
    """A float32 model holding `model`'s weights and state, on the plain route."""
    twin = ft.FlowCompareModel({**model.config, "compute_dtype": "float32"},
                               device=model_device(model))
    twin.load_state_dict(model.state_dict())
    twin.plain = True
    return twin


def model_device(model):
    return next(model.parameters()).device


def distances(nats: dict) -> dict:
    k, p, f = nats["kernels"], nats["plain"], nats["f32"]
    return {"kernels_vs_plain": abs(k - p), "kernels_vs_f32": abs(k - f),
            "plain_vs_f32": abs(p - f)}


def run(name: str, dev, train_samples: int = 0) -> dict:
    overrides = chip_smoke.WIDE_RUNS.get(name, {})
    model = chip_smoke.make_model(ft, dev, **overrides)
    cfg = model.config
    out = {}

    # eval: the main path's items and noise
    items = chip_smoke.eval_items(cfg, chip_smoke.TIME_B, 2, chip_smoke.SEED + 3)
    noise = chip_smoke.make_noise(dev)
    nats = {}
    for path in ("kernels", "plain"):
        model.plain = path == "plain"
        nats[path] = float(ft.evaluate_on_test(model, items, noise=noise)[0])
    model.plain = False
    twin = f32_twin(model)
    nats["f32"] = float(ft.evaluate_on_test(twin, items, noise=noise)[0])
    out["eval"] = {"nats": nats, **distances(nats)}

    # sample: one z, each path's sample scored by the f32 model
    rng = np.random.default_rng(chip_smoke.SEED + 20)
    x0 = torch.as_tensor(rng.normal(size=(1, cfg["n_samples_context"], 6)), dtype=torch.float32,
                         device=dev)
    extra = torch.as_tensor(rng.normal(size=(1, 1)), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 21)
    n = chip_smoke.SAMPLE_N
    z = chip_smoke.SAMPLE_STD * torch.randn((1, n, cfg["latent_dim"]), generator=gen, device=dev)
    eps = torch.randn((1, n, cfg["latent_dim"] - cfg["input_dim"]), generator=gen, device=dev)
    nats = {}
    with torch.no_grad():
        for path, m, plain in (("kernels", model, False), ("plain", model, True),
                               ("f32", twin, True)):
            m.plain = plain
            x = ft.make_sample(m, n, x0, extra, z=z)
            nats[path] = float(inner_loop(twin, (x0, x, extra), eps=eps)[2])
    model.plain = False
    out["sample"] = {"nats": nats, **distances(nats)}

    # train: one step at B=2 from the data init's state
    batch = chip_smoke._to_device(chip_smoke.train_batches(cfg, chip_smoke.TRAIN_CHECK_B, 1,
                                                           chip_smoke.SEED + 10)[0], dev)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 11)
    shape = (chip_smoke.TRAIN_CHECK_B, cfg["sample_size"], cfg["latent_dim"] - cfg["input_dim"])
    eps_init = torch.randn(shape, generator=gen, device=dev)
    eps = torch.randn(shape, generator=gen, device=dev)
    del twin
    torch.cuda.empty_cache()
    ft.data_init_from_batch(ft.init_train_state(model), batch, eps=eps_init)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    nats, norms = {}, {}
    for path in ("kernels", "plain"):
        model.load_state_dict(snapshot)
        model.plain = path == "plain"
        row = ft.train_step(ft.init_train_state(model), batch, eps=eps)[1]
        nats[path], norms[path] = row["nats"], row["grad_norm"]
    model.plain = False
    model.load_state_dict(snapshot)
    twin = f32_twin(model)
    row = ft.train_step(ft.init_train_state(twin), batch, eps=eps)[1]
    nats["f32"], norms["f32"] = row["nats"], row["grad_norm"]
    out["train"] = {"nats": nats, "grad_norm": norms, **distances(nats)}
    del twin
    torch.cuda.empty_cache()
    if train_samples:
        out["train_samples"] = {path: train_run(model, snapshot, path == "plain",
                                                train_samples, dev)
                                for path in ("kernels", "plain")}
    del model
    torch.cuda.empty_cache()
    return out


def train_run(model, snapshot: dict, plain: bool, batch: int, dev) -> dict:
    """`phase_train_main`'s train(max_steps=4, make_samples=True) from the
    data init's state on one route: its losses and its samples' finiteness."""
    from flowcompare_tpu_torch.train.metrics import MetricWriter

    rows = []

    class Rows(MetricWriter):
        def log(self, metrics, step=None):
            rows.append(dict(metrics))

    model.load_state_dict(snapshot)
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    model.plain = plain
    save_dir = REPO / "build" / "wide_floor_train"
    for old in save_dir.glob("sample_*.npz"):
        old.unlink()
    bps = model.config["batches_per_sample"]
    model.config["batches_per_sample"] = 2
    data = chip_smoke.train_batches(model.config, batch, 4, chip_smoke.SEED + 12)
    ft.train(model, data, generator=torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 13),
             writer=Rows(), save_dir=str(save_dir), run_name="floor", max_steps=4,
             make_samples=True)
    model.config["batches_per_sample"] = bps
    model.plain = False
    samples = {p.name: np.load(p)["gen"] for p in sorted(save_dir.glob("sample_*.npz"))}
    return {"losses": [r["loss"] for r in rows], "grad_norms": [r["grad_norm"] for r in rows],
            "samples": {name: {"finite_share": float(np.isfinite(g).mean()),
                               "max_abs_finite": float(np.abs(g[np.isfinite(g)]).max())
                               if np.isfinite(g).any() else None}
                        for name, g in samples.items()}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", nargs="+", default=["dulcet-universe", "w1024", "w2048"])
    parser.add_argument("--out", type=Path, default=REPO / "build" / "wide_floor.json")
    parser.add_argument("--train-samples", type=int, default=0, metavar="B",
                        help="also train(max_steps=4, make_samples=True) at batch B on both "
                             "routes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build()
    _build.library()
    chip_smoke.CHAIN_ROUTES = chip_smoke.ChainRoutes()
    results = {}
    for name in args.runs:
        results[name] = run(name, dev, args.train_samples)
        print(name, json.dumps(results[name]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "results": results}, indent=1))
    print("card:", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
