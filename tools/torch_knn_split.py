#!/usr/bin/env python3
"""Where B3 (knn_edge_max) and B6 (knn_edge_reduce) spend their time on the
card, at the main path's shapes: 40 clouds of 1,250 points (dulcet-universe's
B=20 eval item, both directions, and its B=20 training step) and 50 (a B=25
item), k = 40, at the four EdgeConv widths.

    python3 tools/torch_knn_split.py [--csrc DIR] [--workdir DIR] [--out FILE]

For each kernel source it times, with CUDA events:
  B3           knn_edge_max at 40 and 50 clouds, summed over the four widths;
  B6 forward   knn_edge_reduce's forward kernel at 40 clouds;
  B6 backward  its backward at 40 clouds, and each kernel the backward
               launches (torch.profiler durations, by kernel name);
the selection's sweeps and candidates a row on these inputs (its PyTorch
emulation), and splits the two forward kernels into distances / selection /
gather by
building copies of csrc/ in which the kernel stops after its distances, or
after its selection (writing one value a row, so the work stays live): the
selection is the second reading less the first, the gather (with the
outputs) the full time less the second.

`--csrc DIR` reads the kernels from another copy of the sources (an earlier
commit's `flowcompare_tpu_torch/csrc`, unpacked with `git archive`), so two
versions can be measured in one run on one card. The stage anchors of both
layouts of knn_select.cuh are known: the binary-search selection of PRs 1-9
and the pool-threshold selection (radix select on ties) that replaced it.
Prints one line a reading and writes them as JSON to --out. Needs one
NVIDIA H100 and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from flowcompare_tpu_torch.ops import _build, edgeconv_cuda  # noqa: E402

K, N = 40, 1250
WIDTHS = chip_smoke.EDGE_WIDTHS

# Early exits planted after a stage: (file, anchor, text put after the anchor).
# Each anchor occurs once in its file.
_OLD_DIST = "knn::distances(x + (size_t)item * n * ldx, ldx, cq, n, row0, s);"
_OLD_SEL = "knn::select_row(reinterpret_cast<const unsigned*>(s.dist + r * n), n, k, list);"
_NEW_DIST = "knn::distances<KS>(x + (size_t)item * n * ldx, ldx, cq, n, row0, s);"
_NEW_SEL = ("knn::select_row(dr, n, k, s.pool[r * knn::POOL + lane],\n"
            "                    s.pool[r * knn::POOL + 32 + lane], scratch, list);")
_KEEP_ROW = "(size_t)item * n + row0 + threadIdx.x"
_KEEP_SEL = "if ((threadIdx.x & 31) == 0) "
LAYOUTS = {
    "pool threshold and radix fallback (PR 10)": {
        "distances": [
            ("knn_edge_max.cu", _NEW_DIST,
             f"if (threadIdx.x < knn::QR && row0 + threadIdx.x < n) out[({_KEEP_ROW}) * ldo] = "
             "f2bf(s.dist[threadIdx.x * s.ldd + row0 + threadIdx.x]); return;"),
            ("knn_edge_reduce.cu", _NEW_DIST,
             f"if (threadIdx.x < knn::QR && row0 + threadIdx.x < n) mx_out[({_KEEP_ROW}) * cout] = "
             "s.dist[threadIdx.x * s.ldd + row0 + threadIdx.x]; return;"),
        ],
        "selection": [
            ("knn_edge_max.cu", _NEW_SEL,
             f"{_KEEP_SEL}out[((size_t)item * n + gr) * ldo] = f2bf((float)list[k - 1]); "
             "__syncwarp(); continue;"),
            ("knn_edge_reduce.cu", _NEW_SEL,
             f"{_KEEP_SEL}mx_out[((size_t)item * n + gr) * cout] = (float)list[k - 1]; "
             "__syncwarp(); continue;"),
        ],
    },
    "binary search (PRs 1-9)": {
        "distances": [
            ("knn_edge_max.cu", _OLD_DIST,
             f"if (threadIdx.x < knn::QR && row0 + threadIdx.x < n) out[({_KEEP_ROW}) * ldo] = "
             "f2bf(s.dist[threadIdx.x * n + row0 + threadIdx.x]); return;"),
            ("knn_edge_reduce.cu", _OLD_DIST,
             f"if (threadIdx.x < knn::QR && row0 + threadIdx.x < n) mx_out[({_KEEP_ROW}) * cout] = "
             "s.dist[threadIdx.x * n + row0 + threadIdx.x]; return;"),
        ],
        "selection": [
            ("knn_edge_max.cu", _OLD_SEL,
             "if (lane == 0) out[((size_t)item * n + gr) * ldo] = f2bf((float)list[k - 1]); "
             "__syncwarp(); continue;"),
            ("knn_edge_reduce.cu", _OLD_SEL,
             "if (lane == 0) mx_out[((size_t)item * n + gr) * cout] = (float)list[k - 1]; "
             "__syncwarp(); continue;"),
        ],
    },
}


def layout_of(csrc: Path) -> str:
    for name, stages in LAYOUTS.items():
        if all((csrc / f).read_text().count(a) == 1 for st in stages.values() for f, a, _ in st):
            return name
    raise SystemExit(f"{csrc}: no known stage anchors (update LAYOUTS)")


def plant(src: Path, dst: Path, edits: list) -> None:
    shutil.copytree(src, dst, dirs_exist_ok=True)
    for fname, anchor, after in edits:
        path = dst / fname
        text = path.read_text()
        assert text.count(anchor) == 1, (fname, anchor)
        path.write_text(text.replace(anchor, anchor + " " + after))


def use_sources(csrc: Path, build_dir: Path) -> None:
    _build.CSRC, _build.BUILD_DIR, _build._LIB = csrc, build_dir, None
    _build.library()


def inputs(clouds: int, seed: int, dev) -> list:
    g = torch.Generator().manual_seed(seed)
    out = []
    for cq, cout in WIDTHS:
        x = torch.randn(clouds * N, cq, generator=g).bfloat16().to(dev)
        u = torch.randn(clouds * N, cout, generator=g).bfloat16().to(dev)
        out.append((x, u))
    return out


def b3_ms(data, clouds: int) -> float:
    total = 0.0
    for x, u in data:
        out = torch.empty_like(u)
        total += chip_smoke.time_ms(
            lambda: edgeconv_cuda.launch_knn_edge_max(x, u, out, n_items=clouds, k=K), reps=5)
    return total


def b6_buffers(data, clouds: int, seed: int, dev) -> list:
    g = torch.Generator().manual_seed(seed)
    bufs = []
    for x, u in data:
        rows, c = u.shape
        f32 = [torch.empty(rows, c, device=dev) for _ in range(4)]
        slots = [torch.empty(rows, c, dtype=torch.uint8, device=dev) for _ in range(2)]
        idx = torch.empty(rows, K, dtype=torch.int32, device=dev)
        cots = [torch.randn(rows, c, generator=g).to(dev) for _ in range(4)]
        du = torch.empty(rows, c, device=dev)
        bufs.append((x, u, f32, slots, idx, cots, du))
    return bufs


def b6_fwd(buf, clouds: int) -> None:
    x, u, f32, slots, idx, _, _ = buf
    _build.knn_edge_reduce_fwd(x, u, *f32, *slots, idx, n_items=clouds, k=K)


def b6_bwd(buf, clouds: int) -> None:
    _, u, _, slots, idx, cots, du = buf
    _build.knn_edge_reduce_bwd(u, *cots, *slots, idx, du, n_items=clouds, k=K)


def measure(bufs40, data50, full: bool) -> dict:
    """B3 at 40 and 50 clouds and B6's forward at 40; with full=True also the
    backward and its kernels (profiler)."""
    out = {"b3_40_ms": b3_ms([(b[0], b[1]) for b in bufs40], 40),
           "b3_50_ms": b3_ms(data50, 50),
           "b6_forward_40_ms": sum(chip_smoke.time_ms(lambda: b6_fwd(b, 40)) for b in bufs40)}
    if full:
        for b in bufs40:
            b6_fwd(b, 40)
        out["b6_backward_40_ms"] = sum(chip_smoke.time_ms(lambda: b6_bwd(b, 40)) for b in bufs40)
        by_name = defaultdict(float)
        for b in bufs40:
            kernels, _ = chip_smoke.kernel_trace(lambda: b6_bwd(b, 40), "knn_split_trace.json")
            for e in kernels:
                m = re.search(r"\w+_kernel", e["name"])
                by_name[m.group(0) if m else e["name"]] += e["dur"] / 1e3
        out["b6_backward_kernels_ms"] = dict(by_name)
    return out


def sweeps(data, clouds: int = 4) -> dict:
    """The selection's work a row on these inputs (its PyTorch emulation,
    the same algorithm, on plain f32 distances of the first `clouds`
    clouds of each width): sweeps over the row (mean, max; the binary
    search made 33), candidates under the pool's threshold (mean, max) and
    the share of rows that fell back to the radix select."""
    out = {}
    for (x, _), (cq, cout) in zip(data, WIDTHS):
        bits = edgeconv_cuda.distance_bits(x[:clouds * N].reshape(clouds, N, cq))
        _, sw, cnt = edgeconv_cuda.knn_select_emulated(bits.reshape(clouds * N, N), K,
                                                       edgeconv_cuda.pool_sources(N))
        out[f"{cq}->{cout}"] = {"sweeps_mean": float(sw.float().mean()),
                                "sweeps_max": int(sw.max()),
                                "candidates_mean": float(cnt.float().mean()),
                                "candidates_max": int(cnt.max()),
                                "fallback_share": float((cnt > edgeconv_cuda.SELECT_CAP)
                                                        .float().mean())}
    return out


def run(src: Path, work: Path, full_build: Path, log=print) -> dict:
    """Every reading of the module docstring for the kernels in `src`; the
    stage copies are built under `work`, the sources as they are in
    `full_build` (the library already there is reused)."""
    dev = torch.device("cuda")
    layout = layout_of(src)
    orig = (_build.CSRC, _build.BUILD_DIR, _build._LIB)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    log(f"knn split: card {card}; sources {src} ({layout})")
    bufs40 = b6_buffers(inputs(40, 1, dev), 40, 2, dev)
    data50 = inputs(50, 3, dev)
    results = {"card": card, "sources": str(src), "layout": layout,
               "selection_per_row": sweeps([(b[0], b[1]) for b in bufs40])}
    log("knn split: the selection a row " + json.dumps(results["selection_per_row"]))
    try:
        use_sources(src, full_build)
        results["full"] = measure(bufs40, data50, full=True)
        log("knn split: full " + json.dumps(results["full"]))
        for stage, edits in LAYOUTS[layout].items():
            plant(src, work / stage / "csrc", edits)
            use_sources(work / stage / "csrc", work / stage / "build")
            results[f"to {stage}"] = measure(bufs40, data50, full=False)
            log(f"knn split: to {stage} " + json.dumps(results[f"to {stage}"]))
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._LIB = orig
    split = {}
    for key in ("b3_40_ms", "b3_50_ms", "b6_forward_40_ms"):
        d, s, f = (results["to distances"][key], results["to selection"][key],
                   results["full"][key])
        split[key] = {"distances": d, "selection": s - d, "gather and outputs": f - s, "total": f}
    results["split"] = split
    log("knn split: " + json.dumps(split))
    return results


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--csrc", type=Path, default=None,
                        help="the kernel sources to measure (default: the repo's)")
    parser.add_argument("--workdir", type=Path, default=None,
                        help="where the stage copies are built (default: a new temporary "
                             "directory, removed at the end)")
    parser.add_argument("--out", type=Path, default=REPO / "chiprun_out" / "knn_split.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    src = (args.csrc or _build.CSRC).resolve()
    work = args.workdir or Path(tempfile.mkdtemp(prefix="knn_split_"))
    full = _build.BUILD_DIR if src == _build.CSRC.resolve() else work / "full" / "build"
    try:
        results = run(src, work, full)
    finally:
        if args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
