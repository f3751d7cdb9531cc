#!/usr/bin/env python3
"""Where B4 (the eval DGCNN encoder) and B2 (the augmenter) spend their time
on the card, part by part, at the main path's shapes.

    python3 tools/torch_b4_b2_split.py [--tree DIR] [--out FILE]

B4 at 2 clouds of 1,250 points (chip_smoke's check, a `make_sample` context
is 1), 40 (dulcet-universe's B=20 eval item, both directions) and 50
(helpful-sponge's B=25 item, `head=False`); B2 at 8 x 1024 rows, 40,960
(a dulcet item, extra context) and 51,200 (helpful-sponge, extra=None, its
context the broadcast 124-wide embedding). Random weights from seed 0 at
full width, the flow cut to 2 layers (neither kernel reads it).

Each entry call is made the way the model makes it on the main path (its
folds and casts included) and timed three ways:
  wall_ms     CUDA events over 10 calls after a warm-up (host included);
  device_ms   the kernels' durations in a torch.profiler trace, per call;
  parts       that trace's kernels in launch order, grouped by the part of
              the chain they belong to (the stages' products, B3, conv5, the
              head; the conditioner, ctx @ wkv, the attention, the net, the
              epilogue), with "torch ops" for PyTorch's and cuBLAS's kernels
              (the folds, casts and fills the wrapper launches), and their
              count;
and the folds alone (the wrapper's weight preparation, which runs before its
first launch) in wall time. `--tree DIR` imports the port from another
checkout (an earlier commit unpacked with `git archive`), so two versions
are measured in one run on one card. Writes the readings as JSON to --out.
Needs one NVIDIA GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def _fused_kind(name: str, kind: int) -> bool:
    """Whether a kernel name is fused_layer.cu's kernel of this kind (its one-
    pass or wide instance, or an earlier tree's untemplated one)."""
    return re.search(rf"fused_layer_kernel<{kind}[,>]", name) is not None


def _label_b4(names: list) -> list:
    """The part of B4's chain each kernel (in launch order) belongs to."""
    out, stage, after = [], 0, 0
    for name in names:
        if "knn_edge_max" in name:
            out.append("B3")
            stage += 1
        elif _fused_kind(name, 4):
            out.append("tail: conv5 + head (one launch)")
        elif "gemm_bf16" in name:
            if stage < 4:
                out.append(f"stage {stage + 1} products")
            else:
                out.append("conv5" if after == 0 else "head")
                after += 1
        elif "cast_rows" in name or "pack_rows" in name:
            out.append("cloud cast")
        else:
            out.append("torch ops")
    return out


def _label_b2(names: list) -> list:
    """The part of B2's chain each kernel (in launch order) belongs to."""
    out, attended = [], False
    for name in names:
        if _fused_kind(name, 0):
            out.append("conditioner")
        elif _fused_kind(name, 5):
            out.append("net + epilogue (one launch)")
        elif "cross_attention" in name:
            out.append("attention")
            attended = True
        elif "gemm_bf16" in name:
            out.append("net (per product)" if attended else "ctx @ wkv")
        elif "augment_epilogue" in name:
            out.append("epilogue")
        elif "cast_rows" in name or "pack_rows" in name:
            out.append("row casts")
        else:
            out.append("torch ops")
    return out


def measure(chip_smoke, fn, label) -> dict:
    fn()
    torch.cuda.synchronize()
    wall = chip_smoke.time_ms(fn, reps=10)
    kernels, _ = chip_smoke.kernel_trace(fn, "b4_b2_split_trace.json")
    kernels.sort(key=lambda e: e["ts"])
    names = [e["name"] for e in kernels]
    parts = {}
    for part, e in zip(label(names), kernels):
        ms, count = parts.get(part, (0.0, 0))
        parts[part] = (ms + e["dur"] / 1e3, count + 1)
    device = sum(e["dur"] for e in kernels) / 1e3
    return {"wall_ms": wall, "device_ms": device, "launches": len(kernels),
            "port_launches": sum(c for p, (_, c) in parts.items() if p != "torch ops"),
            "parts": {p: {"ms": ms, "launches": c} for p, (ms, c) in parts.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=REPO)
    ap.add_argument("--out", type=Path, default=REPO / "build" / "b4_b2_split.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_b4_b2_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.tree.resolve()))
    import chip_smoke
    import flowcompare_tpu_torch as ft
    from flowcompare_tpu_torch.core.mlp import cast_tree
    from flowcompare_tpu_torch.model import broadcast_embedding
    from flowcompare_tpu_torch.ops import _build, dgcnn_cuda, flow_layer_cuda as flc

    assert Path(ft.__file__).resolve().is_relative_to(args.tree.resolve()), ft.__file__
    _build.library()
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cached = "cast" in inspect.signature(dgcnn_cuda.fused_dgcnn_encoder).parameters
    out = {"tree": str(args.tree), "device": smi, "cached_folds": cached, "B4": {}, "B2": {}}
    g = torch.Generator(device=device).manual_seed(7)
    bf = torch.bfloat16

    for preset, clouds, head in (("dulcet-universe", 2, True), ("dulcet-universe", 40, True),
                                 ("helpful-sponge", 50, False)):
        model = chip_smoke.make_model(ft, device, preset=preset, n_flow_layers=2)
        cfg = model.config
        raw, state = model.params()["embedder"], model.state.tree()["embedder"]
        x = torch.randn((clouds, cfg["n_samples_context"], 6), generator=g, device=device)
        k = cfg["n_neighbors"]
        with torch.no_grad():
            if cached:
                def call():
                    return dgcnn_cuda.fused_dgcnn_encoder(x, raw, state, k=k, head=head, cast=bf)

                def folds():
                    return dgcnn_cuda.encoder_weights(raw, state, cast=bf)
            else:
                def call():
                    return dgcnn_cuda.fused_dgcnn_encoder(x, cast_tree(raw, bf), state, k=k,
                                                          head=head)

                def folds():
                    return dgcnn_cuda.fold_dgcnn(cast_tree(raw, bf), state)
            entry = measure(chip_smoke, call, _label_b4)
            entry["folds_wall_ms"] = chip_smoke.time_ms(folds, reps=10)
            entry["embed_wall_ms"] = chip_smoke.time_ms(lambda: model.embed(x), reps=10)
        key = f"{clouds} clouds x {cfg['n_samples_context']}, head={head}"
        out["B4"][key] = entry
        print(f"B4 {key}: {json.dumps(entry)}", flush=True)

        if preset == "dulcet-universe" and clouds == 2:
            continue
        rows_sets = ((8, 40) if preset == "dulcet-universe" else (50,))
        aug = model.params()["augmenter"]
        ed = 1 if cfg["using_extra_context"] else 0
        for items in rows_sets:
            n = cfg["sample_size"]
            xa = torch.randn((items, n, 6), generator=g, device=device)
            eps = torch.randn((items, n, cfg["latent_dim"] - 6), generator=g, device=device)
            extra = (torch.randn((items, 1, 1), generator=g, device=device).expand(items, n, 1)
                     if ed else None)
            if model.is_global:
                emb = torch.randn((items, cfg["input_embedding_dim"]), generator=g,
                                  device=device).to(bf)
                ctx = broadcast_embedding(emb, n)
            else:
                ctx = torch.randn((items, cfg["n_samples_context"], cfg["input_embedding_dim"]),
                                  generator=g, device=device).to(bf)
            with torch.no_grad():
                if hasattr(flc, "augmenter_weights"):
                    def folds():
                        return flc.augmenter_weights(aug, input_dim=6, extra_dim=ed)

                    def call():
                        return flc.fused_augmenter(xa, eps, ctx, extra, folds())
                else:
                    def folds():
                        folded = flc.fold_augmenter(aug, input_dim=6, extra_dim=ed)
                        return flc._CouplingChain(folded, ctx, extra, items * n, 6)

                    def call():
                        return flc.fused_augmenter(
                            xa, eps, ctx, extra, flc.fold_augmenter(aug, input_dim=6,
                                                                   extra_dim=ed))
                entry = measure(chip_smoke, call, _label_b2)
                entry["folds_wall_ms"] = chip_smoke.time_ms(folds, reps=10)
            key = f"{items * n} rows ({preset}, extra={'(B, N, 1)' if ed else None})"
            out["B2"][key] = entry
            print(f"B2 {key}: {json.dumps(entry)}", flush=True)
        del model
        torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
