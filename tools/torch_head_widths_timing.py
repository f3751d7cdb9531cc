#!/usr/bin/env python3
"""dulcet-universe at head widths D = heads x dim_head (bf16, full width,
115 layers) on the card: the eval main path against the plain path (which
folds the weights once), then a B=20 eval item through evaluate_on_test,
its inner loop on the kernels and on the plain route, and
train(max_steps=4)'s ms a step at B=20, with chip_smoke.py's
`phase_main_path`, `phase_timing` and `phase_train_main`, one model at a
time.

    python3 tools/torch_head_widths_timing.py [--widths 64 256 512] [--out FILE]

D = 64 is dulcet-universe itself; other widths take cross_heads = D / 64
(the reference's heads only widen its one attention stream). Prints each
width's readings as a JSON line and writes them to FILE (default
build/head_widths_timing.json). Needs one NVIDIA H100 and nvcc;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--widths", type=int, nargs="+", default=[64, 256, 512])
    parser.add_argument("--out", type=Path,
                        default=REPO / "build" / "head_widths_timing.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    import flowcompare_tpu_torch as ft
    from flowcompare_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    cs.CHAIN_ROUTES = cs.ChainRoutes()
    device = torch.device("cuda")
    out = {}
    for d in args.widths:
        if d % 64:
            raise ValueError(f"widths are multiples of 64 (cross_heads x 64), got {d}")
        t0 = time.perf_counter()
        model = cs.make_model(ft, device, cross_heads=d // 64)
        assert all(r == "kernels" for r in model.routes.values()), dict(model.routes)
        cs.phase_main_path(ft, model, device)
        timing = cs.phase_timing(ft, model, device)
        train, _ = cs.phase_train_main(ft, model, device)
        out[str(d)] = {"item_ms": 1e3 * timing["item_s"], "inner_loop_ms": timing["inner_loop_ms"],
                       "plain_inner_loop_ms": timing["plain_inner_loop_ms"],
                       "train": {k: v for k, v in train.items() if not isinstance(v, dict)},
                       "wall_s": time.perf_counter() - t0}
        print(json.dumps({str(d): out[str(d)]}), flush=True)
        del model
        torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": torch.cuda.get_device_name(0), "widths": out},
                                   indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
