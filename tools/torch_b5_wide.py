#!/usr/bin/env python3
"""B5's fused per-layer kernels at 1,024- and 2,048-wide MLPs on the card:
the wide conditioner kinds' device times, and how far the kernels and the
per-product route they replaced each land from B5's plain version.

    python3 tools/torch_b5_wide.py [--out FILE] [--only TEXT]

Runs chip_smoke.py's `phase_b5_fused` (two layers of dulcet-universe at
full width over its 20,480 training rows) at three widths:
  w1024           chip_smoke.W1024: the coupling MLP 1,024 wide (the
                  conditioner's pre-MLP stays 256: its kinds run one-pass)
  pre1024         the conditioner's pre-MLP 1,024 wide (conditioner_record
                  and conditioner_bwd on their wide kernels)
  w1024 pre1024   both
  w2048           chip_smoke.W2048: the coupling MLP 2,048 wide (K in two
                  halves), the latent and the conditioner's LayerNorm row
                  1,024 (the heads over two passes)
--only keeps the widths whose name holds TEXT.
Where chip_smoke.py holds B5 to B5_LIMITS and its kernels to
B5_PROBE_LIMITS (bands read at the presets' widths), this script records
each band's verdict instead of raising, beside the same shares of the
per-product route, so a width where both routes pass a band alike is told
from a kernel that alone does. Every other check of the phase (the JAX
package's bands, two calls bit-equal, the launches) still raises. Prints one
line a width and writes every number as JSON to --out. Needs one NVIDIA
H100 and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import flowcompare_tpu_torch as ft  # noqa: E402
from flowcompare_tpu_torch.ops import _build  # noqa: E402

PRE1024 = {"pre_attention_mlp_hidden_dims": [1024] * 3}
WIDTHS = {"w1024": chip_smoke.W1024, "pre1024": PRE1024,
          "w1024 pre1024": {**chip_smoke.W1024, **PRE1024}, "w2048": chip_smoke.W2048}
SHARES = ("share_over_quarter_ulp", "share_over_half_ulp")


def over_limits(stats: dict) -> dict:
    """The B5_LIMITS entries that `stats` (chip_smoke.b5_stats) exceed."""
    over = {name: {k: (s[k], v) for k, v in chip_smoke.B5_LIMITS[name].items()
                   if not s[k] <= v} for name, s in stats.items()}
    return {k: v for k, v in over.items() if v}


def run(label: str, overrides: dict, dev) -> dict:
    probe_verdict = {}

    def record_probes(what, probes, attention, *limits):
        try:
            check_probes(what, probes, attention)
            probe_verdict["over"] = None
        except AssertionError as err:
            probe_verdict["over"] = str(err)

    check_b5, check_probes = chip_smoke.check_b5, chip_smoke.check_b5_probes
    chip_smoke.check_b5 = lambda what, got, ref, *limits: chip_smoke.b5_stats(got, ref)
    chip_smoke.check_b5_probes = record_probes
    try:
        with torch.no_grad():
            out = chip_smoke.phase_b5_fused(ft, dev, "dulcet-universe", chip_smoke.TIME_B,
                                            overrides=overrides, label=label)
    finally:
        chip_smoke.check_b5, chip_smoke.check_b5_probes = check_b5, check_probes
    torch.cuda.empty_cache()
    shares = {route: {k: {q: s[k][q] for q in SHARES} for k in s}
              for route, s in (("kernels", out["stats"]), ("per_product", out["per_product_stats"]))}
    return {"rows": out["rows"], "shares": shares,
            "over_b5_limits": {"kernels": over_limits(out["stats"]),
                               "per_product": over_limits(out["per_product_stats"])},
            "over_probe_limits": probe_verdict["over"],
            "relative_errors": out["relative_errors"], "worst_weight": out["worst_weight"],
            "device_ms": out["device_ms"], "per_product_device_ms": out["per_product_device_ms"],
            "kernels": {k: {q: v[q] for q in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "max_abs_err", "launches_per_call")}
                        for k, v in out["kernels"].items()}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=REPO / "chiprun_out" / "b5_wide.json")
    parser.add_argument("--only", default="", help="run only the widths whose name holds this")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build()
    _build.library()
    chip_smoke.CHAIN_ROUTES = chip_smoke.ChainRoutes()
    results = {}
    for label, overrides in WIDTHS.items():
        if args.only not in label:
            continue
        results[label] = run(label, overrides, dev)
        print(label, json.dumps(results[label]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "results": results}, indent=1))
    print("card:", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
