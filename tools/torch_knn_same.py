#!/usr/bin/env python3
"""Whether two trees' kNN kernels give the same results at the presets'
1,250-point shapes on the card, and their device times: B3 (knn_edge_max)
at 40 clouds, each EdgeConv width; B6 (knn_edge_reduce) forward (its five
outputs and the selected indices) and backward (du) at 40 clouds, each
width; B8's picks and centres of the four PAConv levels at 50 clouds
(fps_levels); B9's selection of those levels and its gathers, on inputs
made from a seed.

    python3 tools/torch_knn_same.py --tree DIR --out FILE
    python3 tools/torch_knn_same.py --compare FILE_A FILE_B

The first form imports the port from DIR (a checkout, e.g. an earlier
commit's `git archive` unpacked into build/), runs the kernels, saves their
outputs with torch.save and prints each kernel's device ms (torch.profiler,
10 calls after a warm-up): B3 and B6's forward and backward summed over the
four widths, B8's four levels, B9's selection for the four levels, and the
backward's split by kernel (the reverse lists' kernels and the sums). The
backward's device ms counts kernels, not the memset of its counts. Run it once a tree, each
in a process of its own, and alternate the trees in one call (parent,
change, change, parent) to compare the times. The second form prints, for
every output, whether the two files hold it bit for bit and the largest
difference, and exits non-zero if any differs. Needs one NVIDIA H100 and
nvcc for the first form; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
CLOUDS, N, K = 40, 1250, 40
EDGE_WIDTHS = [(6, 64), (64, 64), (64, 128), (128, 256)]
SA_CLOUDS, SA_LEVELS, SA_K = 50, [(1250, 312, 3), (312, 78, 64), (78, 19, 128), (19, 4, 256)], 32


def run(tree: Path, out: Path) -> None:
    sys.path.insert(0, str(tree))
    from flowcompare_tpu_torch.ops import _build, fps_cuda, sa_group_cuda as sg
    assert Path(_build.__file__).resolve().is_relative_to(tree.resolve()), _build.__file__
    sys.path.insert(1, str(REPO))
    from chip_smoke import device_ms, traced_kernels

    dev = torch.device("cuda")
    results, ms = {}, {"B3": 0.0, "B6 forward": 0.0, "B6 backward": 0.0}
    for cq, cout in EDGE_WIDTHS:
        g = torch.Generator().manual_seed(cq * 1000 + cout)
        rows = CLOUDS * N
        x = torch.randn(rows, cq, generator=g).bfloat16().to(dev)
        u = torch.randn(rows, cout, generator=g).bfloat16().to(dev)
        out3 = torch.empty_like(u)
        b3 = lambda: _build.knn_edge_max(x, u, out3, n_items=CLOUDS, k=K)  # noqa: E731
        f32 = [torch.empty(rows, cout, device=dev) for _ in range(4)]
        slots = [torch.empty(rows, cout, dtype=torch.uint8, device=dev) for _ in range(2)]
        idx = torch.empty(rows, K, dtype=torch.int32, device=dev)
        fwd = lambda: _build.knn_edge_reduce_fwd(x, u, *f32, *slots, idx,  # noqa: E731
                                                 n_items=CLOUDS, k=K)
        cots = [torch.randn(rows, cout, generator=g).to(dev) for _ in range(4)]
        du = torch.empty(rows, cout, device=dev)
        bwd = lambda: _build.knn_edge_reduce_bwd(u, *cots, *slots, idx, du,  # noqa: E731
                                                 n_items=CLOUDS, k=K)
        b3()
        fwd()
        bwd()
        torch.cuda.synchronize()
        key = f"{CLOUDS}x{N} {cq}->{cout}"
        results[f"B3 {key}"] = out3.cpu()
        for name, t in zip(("mx", "mn", "s1", "s2", "amax", "amin", "idx", "du"),
                           (*f32, *slots, idx, du)):
            results[f"B6 {key} {name}"] = t.cpu()
        ms["B3"] += device_ms(b3)
        ms["B6 forward"] += device_ms(fwd)
        for e in traced_kernels(bwd, 10):
            name = re.search(r"knn_\w+", e["name"])
            key = f"B6 backward: {name.group(0) if name else e['name'][:40]}"
            ms[key] = ms.get(key, 0.0) + e["dur"] / 10 / 1e3
            ms["B6 backward"] += e["dur"] / 10 / 1e3
    g = torch.Generator().manual_seed(9)
    xyz = torch.randn(SA_CLOUDS, N, 3, generator=g).to(dev)
    ms_fps = [m for _, m, _ in SA_LEVELS]
    idx, centres = fps_cuda.furthest_point_sampling_levels(xyz, ms_fps)
    for l, (i, c) in enumerate(zip(idx, centres)):
        results[f"B8 level {l} picks"] = i.cpu()
        results[f"B8 level {l} centres"] = c.cpu()
    ms["B8"] = device_ms(lambda: fps_cuda.furthest_point_sampling_levels(xyz, ms_fps))
    levels = list(zip(centres, idx, [xyz, *centres]))
    sels = sg.sa_select_levels(levels, SA_K)
    for l, ((new_xyz, _, pts), sel, (n, m, c)) in enumerate(zip(levels, sels, SA_LEVELS)):
        feats = torch.randn(SA_CLOUDS, n, c, generator=g).bfloat16().to(dev)
        results[f"B9 level {l} slots"] = sel.cpu()
        results[f"B9 level {l} groups"] = sg.sa_gather(sel, new_xyz, pts, feats).cpu()
    ms["B9 selection"] = device_ms(lambda: sg.sa_select_levels(levels, SA_K))
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"card": torch.cuda.get_device_name(0), "results": results, "device_ms": ms}, out)
    print(json.dumps({"tree": str(tree), "device_ms": ms}))
    print(f"saved {len(results)} outputs of {tree} to {out}")


def compare(a: Path, b: Path) -> int:
    ra, rb = torch.load(a)["results"], torch.load(b)["results"]
    same = True
    for key in ra:
        x, y = ra[key], rb[key]
        equal = torch.equal(x, y)
        same &= equal
        print(f"{key}: bit-equal {equal}, max |d| {float((x.float() - y.float()).abs().max())}")
    print(f"all bit-equal: {same}")
    return 0 if same else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", type=Path)
    parser.add_argument("--out", type=Path)
    parser.add_argument("--compare", type=Path, nargs=2)
    args = parser.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    run(args.tree, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
