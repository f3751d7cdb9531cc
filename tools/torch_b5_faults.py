#!/usr/bin/env python3
"""How far B5 (flowcompare_tpu_torch's flow_layers_bwd, its fused per-layer
kernels in csrc/fused_layer.cu's record mode and csrc/fused_layer_bwd.cu)
lands from its plain version on the card: as built, and with one rounding
fault planted in a copy of the backward kernels' source, so the limits of
chip_smoke.py's B5_LIMITS can sit between the two.

    python3 tools/torch_b5_faults.py [--workdir DIR] [--out FILE] [--only TEXT]

Faults, each built from a copy of csrc/ under --workdir (default: a new
temporary directory), planted in the fused_layer* source that holds the
anchor (the backward kernels' body is csrc/fused_layer_bwd_kernel.cuh):
  dp_bf16     every hidden product's f32 output gradient dp rounded to bf16
              (the per-product chain and the kernels keep it in f32 for the
              residual's gradient and the bias gradients)
  carry_bf16  the f32 carry gradient the coupling backward writes ([dy1 |
              dy2 * scale]) rounded to bf16

Cases: chip_smoke.py's phase_b5_fused shapes (dulcet-universe at 20 x 1024
rows, helpful-sponge at 25 x 1024, two full-width layers, chip_smoke's
weights) and the card tests' (dulcet-universe, swept-energy and
helpful-sponge at one item of 1,037 / 4,000 / 1,000 rows, their weights);
"w2048" (chip_smoke.W2048: 2,048-wide MLPs, a 1,024-wide latent and
LayerNorm row) at both. --only keeps the cases whose name holds TEXT.
Each reading is `chip_smoke.b5_stats` of flow_layers_bwd against the fused
route's plain version (`flow_layers_bwd_fused_plain`, every launch's plain
version: the kernels' own rounding points) from the same saves. Prints one
line a variant and case and writes every number as JSON to --out. Needs one NVIDIA H100 and
nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import chip_smoke  # noqa: E402
import flowcompare_tpu_torch as ft  # noqa: E402
from flowcompare_tpu_torch.ops import _build, flow_layer_cuda as flc  # noqa: E402
from flowcompare_tpu_torch.ops import flow_layer_vjp_cuda as fv  # noqa: E402
from torch_fused_layer_faults import perturb_test, plant, use_sources  # noqa: E402

BF = "__bfloat162float(f2bf({}))"
# (anchor, replacement) pairs in the backward kernels; each anchor occurs once
FAULTS = {
    "dp_bf16": [
        ("? (r[q] + v) * x[q] : 0.f;", f"? {BF.format('(r[q] + v) * x[q]')} : 0.f;"),
    ],
    "carry_bf16": [
        ("if (gr < M) io.g_next[(size_t)gr * io.ld_g + c] = v;",
         f"if (gr < M) io.g_next[(size_t)gr * io.ld_g + c] = {BF.format('v')};"),
        ("io.g_next[(size_t)gr * io.ld_g + split + i] = dt * sc;",
         f"io.g_next[(size_t)gr * io.ld_g + split + i] = {BF.format('dt * sc')};"),
    ],
}

CASES = [("smoke", "dulcet-universe", 20, 1024), ("smoke", "helpful-sponge", 25, 1024),
         ("test", "dulcet-universe", 1, 1037), ("test", "swept-energy", 1, 4000),
         ("test", "helpful-sponge", 1, 1000), ("smoke", "w2048", 20, 1024),
         ("test", "w2048", 1, 1037)]


def case(setup: str, preset: str, items: int, n: int, dev) -> tuple:
    """B5's arguments: two full-width layers, B1's saves at random x."""
    cfg = chip_smoke.smoke_config(ft, preset)
    cfg.update(compute_dtype="bfloat16", n_flow_layers=2, sample_size=n)
    seed = chip_smoke.SEED if setup == "smoke" else 0
    model = ft.FlowCompareModel(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    perturb = chip_smoke.perturb_identity_leaves if setup == "smoke" else perturb_test
    perturb(model, torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        folded = model._folded(model.params(), cfg["extra_context_dim"])
    g = torch.Generator().manual_seed(50 + n)
    ctx, extra, _ = chip_smoke.flow_context(model, g, items, n, dev)
    lat = cfg["latent_dim"]
    x = torch.randn(items, n, lat, generator=g).to(dev)
    with torch.no_grad():
        _, _, saves = flc.fused_flow_layers(x, torch.zeros(items, n, device=dev), ctx, extra,
                                            folded, save=True)
    dz = torch.randn(items, n, lat, generator=g).to(dev)
    dldj = torch.randn(items, n, generator=g).to(dev)
    return saves, dz, dldj, ctx, extra, folded


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", type=Path, default=None,
                        help="where the faults' copies of csrc/ are built (default: a new "
                             "temporary directory, removed at the end)")
    parser.add_argument("--out", type=Path, default=REPO / "build" / "b5_faults.json")
    parser.add_argument("--only", default="", help="run only the cases whose name holds this")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    work = args.workdir or Path(tempfile.mkdtemp(prefix="b5_faults_"))
    src_dir, build_dir = _build.CSRC, _build.BUILD_DIR
    _build.library()
    cases = {f"{s} {p} {b}x{n}": case(s, p, b, n, dev) for s, p, b, n in CASES
             if args.only in f"{s} {p} {b}x{n}"}
    refs = {name: fv.flow_layers_bwd_fused_plain(*c) for name, c in cases.items()}
    results = {}
    try:
        for variant in ["as built", *FAULTS]:
            if variant == "as built":
                use_sources(src_dir, build_dir)
            else:
                csrc = work / variant / "csrc"
                shutil.copytree(src_dir, csrc, dirs_exist_ok=True)
                plant(csrc, FAULTS[variant])
                use_sources(csrc, work / variant / "build")
            for name, c in cases.items():
                with torch.no_grad():
                    got = fv.flow_layers_bwd(*c)
                torch.cuda.synchronize()
                results[f"{variant} | {name}"] = chip_smoke.b5_stats(got, refs[name])
                print(variant, "|", name, json.dumps(
                    {k: {key: v[key] for key in ("share_over_quarter_ulp", "share_over_half_ulp",
                                                 "max_over_max_ref")}
                     for k, v in results[f"{variant} | {name}"].items()}), flush=True)
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._LIB = src_dir, build_dir, None
        if args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "results": results}, indent=1))
    print("card:", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
