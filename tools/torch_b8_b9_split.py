#!/usr/bin/env python3
"""Where B8 (farthest-point sampling) and B9 (PAConv's SA grouping) spend
their time on the card, level by level, at the main path's shapes: the four
set-abstraction levels of good-surf's 1,250-point context, (N, M, C) =
(1250, 312, 3), (312, 78, 64), (78, 19, 128), (19, 4, 256), k = 32, at 50
clouds (a B=25 eval item, both directions) and at 1 (`make_sample`'s
context).

    python3 tools/torch_b8_b9_split.py [--csrc DIR] [--workdir DIR] [--out FILE]
                                       [--embed-only]

Each call is made the way `encoders/paconv.py` makes it on the eval path
and timed two ways:
  wall_ms     CUDA events over 10 calls after a warm-up (host included);
  device_ms   the kernels' durations in a torch.profiler trace, per call;
for B8 each level as its own call (the kernel and the `new_xyz` gather)
and, where the sources have it, the four levels in one call at 128, 256
and 512 threads a block (copies of csrc/ with `FPS_THREADS` planted) with
the latency of one barrier and redux round at each block size; for B9 each
level's grouping, and, where the sources split it, the selection of all
four levels in one call and each level's gather. B9's device time is split
into distances / selection / gather by building copies of csrc/ in which
the kernel stops after its distances, or after its selection (writing one
value a row, so the work stays live): the selection is the second reading
less the first, the gather the rest. Last, one good-surf `embed` (the
PAConv encoder at full width, bf16, random weights from seed 0) at 50
clouds and at 1 is traced: its wall and device ms, B8's and B9's kernels
inside it, and the host time between launches (the span of the trace less
the time some kernel runs); and its host costs: the wall ms of 30 embeds
one at a time (median, least, most), the host ms of B8's and B9's entry
calls inside an embed (as `encoders/paconv.py` makes them, unsynchronised)
and the functions with the most host time over 10 embeds (cProfile).
`--embed-only` measures the embed alone, for runs alternated between two
checkouts in one chip call.

`--csrc DIR` reads the kernels from another checkout's sources
(`<checkout>/flowcompare_tpu_torch/csrc`, an earlier commit unpacked with
`git archive`) and imports that checkout's port, so that its wrappers run
as its main path ran them; two versions are measured in one chip call by
running the tool twice. Both layouts of the sources are known: one fps
launch and one grouping launch a level, or one fps launch for the four
levels, one selection launch for the four levels and one gather a level.
Prints one line a reading and writes them as JSON to --out. Needs one NVIDIA GPU and nvcc;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
K = 32
CLOUD_N = 1250

# Early exits planted after a stage of B9: (file, anchor, text put after the
# anchor). Each anchor occurs once in its file.
_PR4_DIST = "  __syncwarp();\n  int* list = lists + warp * knn::MAX_K;"
_PR4_SEL = ("  const int taken = knn::select_row_pinned(dr, n, k, self, p0, p1,\n"
            "                                           scratch + warp * 2 * knn::CAP, list);")
_PR12_DIST = "  // the distance rows are written"
_PR12_SEL = "  // the selection is made"
LAYOUTS = {
    "one fps and one grouping launch a level": {
        "distances": [("sa_group.cu", _PR4_DIST,
                       "if (lane == 0) orow[0] = from_f32<T>(__uint_as_float(dr[self])); "
                       "return;")],
        "selection": [("sa_group.cu", _PR4_SEL,
                       "if (lane == 0) orow[0] = from_f32<T>((float)(taken > 0 ? "
                       "list[taken - 1] : 0)); return;")],
    },
    "fps and selection of four levels in a launch each, a gather a level": {
        "distances": [("sa_group.cu", _PR12_DIST,
                       "\n    if (lane == 0) sel[0] = (int)dr[0]; continue;")],
        "selection": [("sa_group.cu", _PR12_SEL,
                       "\n    if (lane == 0) sel[0] = taken > 0 ? list[taken - 1] : 0; continue;")],
    },
}


def layout_of(csrc: Path) -> str:
    for name, stages in LAYOUTS.items():
        if all((csrc / f).read_text().count(a) == 1 for st in stages.values() for f, a, _ in st):
            return name
    raise SystemExit(f"{csrc}: no known stage anchors (update LAYOUTS)")


def plant(src: Path, dst: Path, edits: list) -> None:
    """A copy of src with each edit's anchor (once in its file) replaced."""
    shutil.copytree(src, dst, dirs_exist_ok=True)
    for fname, anchor, replacement in edits:
        path = dst / fname
        text = path.read_text()
        assert text.count(anchor) == 1, (fname, anchor)
        path.write_text(text.replace(anchor, replacement))


def use_sources(_build, csrc: Path, build: Path) -> None:
    """Point the port's kernel library at csrc, built into build."""
    _build.CSRC, _build.BUILD_DIR, _build._LIB = csrc, build, None


def levels_of(cs, fc, clouds: int, seed: int, dev) -> list:
    """The four levels' inputs: the cloud, its picks (the plain version's),
    their coordinates and bf16 features."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(clouds, CLOUD_N, 3, generator=g).to(dev)
    out = []
    for n, m, c in cs.SA_LEVELS:
        idx = fc.furthest_point_sampling_plain(x, m)
        centres = torch.gather(x, 1, idx[..., None].expand(-1, -1, 3))
        feats = torch.randn(clouds, n, c, generator=g).to(dev, torch.bfloat16)
        out.append({"n": n, "m": m, "c": c, "xyz": x, "idx": idx, "centres": centres,
                    "feats": feats})
        x = centres
    return out


def reading(cs, fn) -> dict:
    """wall ms (events, 10 calls) and device ms (profiler) of one call, and
    its kernels' device ms by name. The profiler now and then drops a
    kernel: a name's device ms is its mean duration times its launches a
    call (at least one)."""
    fn()
    torch.cuda.synchronize()
    wall = cs.time_ms(fn, reps=10)
    kernels, _ = cs.kernel_trace(lambda: [fn() for _ in range(10)], "b8_b9_split_trace.json")
    by_name = {}
    for e in kernels:
        m = re.search(r"\w+_kernel", e["name"])
        name = m.group(0) if m and "at::" not in e["name"] else "PyTorch's own"
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + e["dur"] / 1e3, count + 1)
    per_call = {k: ms / count * max(1, round(count / 10)) for k, (ms, count) in by_name.items()}
    return {"wall_ms": wall, "device_ms": sum(per_call.values()),
            "launches": len(kernels) / 10, "by_kernel": per_call}


def calls(fc, sg, levels: list, split: bool) -> dict:
    """The entry calls of B8 and B9 on these levels, named."""
    out = {}
    for lv in levels:
        n, m = lv["n"], lv["m"]
        out[f"B8 level {n}->{m}"] = (
            lambda lv=lv: torch.gather(lv["xyz"], 1, fc.furthest_point_sampling(
                lv["xyz"], lv["m"])[..., None].expand(-1, -1, 3)))
        out[f"B9 level {n}->{m}"] = (
            lambda lv=lv: sg.sa_group(lv["centres"], lv["idx"], lv["xyz"], lv["feats"], K))
    if split:
        ms = [lv["m"] for lv in levels]
        out["B8 four levels, one call"] = (
            lambda: fc.furthest_point_sampling_levels(levels[0]["xyz"], ms))
        triples = [(lv["centres"], lv["idx"], lv["xyz"]) for lv in levels]
        out["B9 selection of four levels, one call"] = lambda: sg.sa_select_levels(triples, K)
        sels = sg.sa_select_levels(triples, K)
        for lv, sel in zip(levels, sels):
            out[f"B9 gather {lv['n']}->{lv['m']}"] = (
                lambda lv=lv, sel=sel: sg.sa_gather(sel, lv["centres"], lv["xyz"], lv["feats"]))
    return out


# B8's block sizes, planted into copies of the sources that have the anchor
FPS_ANCHOR = "constexpr int FPS_THREADS = 128;"
FPS_THREADS = (128, 256, 512)


def fps_block_sizes(cs, _build, data: dict, src: Path, work: Path) -> dict:
    """B8's four levels at each block size (wall and device ms) at each
    cloud count, and the latency of one barrier and redux round at each
    (128 from the sources as they are, the others from planted copies)."""
    res = {}
    probe = torch.zeros(1, dtype=torch.int32, device="cuda")
    orig = (_build.CSRC, _build.BUILD_DIR, _build._LIB)
    for t in FPS_THREADS:
        if t == 128:
            _build.CSRC, _build.BUILD_DIR, _build._LIB = orig
        else:
            copy = work / f"fps_threads_{t}"
            plant(src, copy / "csrc",
                  [("fps.cu", FPS_ANCHOR, FPS_ANCHOR.replace("128", str(t)))])
            use_sources(_build, copy / "csrc", copy / "build")
        for clouds, levels in data.items():
            x, ms = levels[0]["xyz"], [lv["m"] for lv in levels]
            idx = [torch.empty(x.shape[0], m, dtype=torch.int64, device=x.device) for m in ms]
            out = [torch.empty(x.shape[0], m, 3, device=x.device) for m in ms]
            r = reading(cs, lambda: _build.fps_levels(x, idx, out))
            res[f"threads {t}, {clouds} clouds"] = {k: r[k] for k in ("wall_ms", "device_ms")}
        res[f"round, threads {t}"] = {"ms": cs.time_ms(
            lambda: _build.fps_round_probe(20000, probe), reps=3) / 20000}
    return res


def host_gaps(cs, model, x) -> dict:
    """One `embed` under the profiler: wall and device ms, B8's and B9's
    kernels, and the span of the trace in which no kernel runs."""
    with torch.no_grad():
        model.embed(x)
        torch.cuda.synchronize()
        wall = cs.time_ms(lambda: model.embed(x), reps=5)
        kernels, traced = cs.kernel_trace(lambda: model.embed(x), "b8_b9_split_embed.json")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = spans[-1][1] - spans[0][0]
    ours = {}
    for e in kernels:
        for key in ("fps", "sa_select", "sa_gather", "sa_group"):
            if re.search(rf"\b{key}\w*_kernel", e["name"]):
                ms, count = ours.get(key, (0.0, 0))
                ours[key] = (ms + e["dur"] / 1e3, count + 1)
    return {"wall_ms": wall, "traced_ms": traced, "device_ms": sum(e["dur"] for e in kernels)
            / 1e3, "launches": len(kernels), "span_ms": span / 1e3,
            "host_gaps_ms": (span - busy) / 1e3, "idle_share": 1 - busy / span,
            "b8_b9_kernels": {k: {"ms": ms, "launches": c} for k, (ms, c) in ours.items()}}


# B8's and B9's entry points as `encoders/paconv.py` imports them (either layout)
ENTRY_CALLS = ("furthest_point_sampling", "furthest_point_sampling_levels", "sa_group",
               "sa_select_levels", "sa_gather")


def host_costs(model, x, reps: int = 30) -> dict:
    """The embed's host side: its wall ms one call at a time (each
    synchronised; median, least, most of reps), the host ms of B8's and B9's
    entry calls inside one embed (each call timed around the encoder's
    reference, unsynchronised; over 10 embeds) and the 25 functions with the
    most host time of their own over 10 embeds (cProfile, ms an embed)."""
    from flowcompare_tpu_torch.encoders import paconv

    with torch.no_grad():
        model.embed(x)
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            model.embed(x)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        spent = {}

        def timed(name, fn):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                ms, count = spent.get(name, (0.0, 0))
                spent[name] = (ms + 1e3 * (time.perf_counter() - t0), count + 1)
                return out
            return call

        names = [nm for nm in ENTRY_CALLS if hasattr(paconv, nm)]
        orig = {nm: getattr(paconv, nm) for nm in names}
        try:
            for nm in names:
                setattr(paconv, nm, timed(nm, orig[nm]))
            for _ in range(10):
                model.embed(x)
            torch.cuda.synchronize()
        finally:
            for nm in names:
                setattr(paconv, nm, orig[nm])
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(10):
            model.embed(x)
        torch.cuda.synchronize()
        prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:25]
    walls.sort()
    return {"wall_ms_median": walls[len(walls) // 2], "wall_ms_least": walls[0],
            "wall_ms_most": walls[-1],
            "entry_calls": {nm: {"host_ms_an_embed": ms / 10, "calls_an_embed": c / 10}
                            for nm, (ms, c) in spent.items()},
            "entry_calls_host_ms_an_embed": sum(ms for ms, _ in spent.values()) / 10,
            "top_own_host_ms_an_embed": [
                {"function": f"{Path(f).name}:{line}({fn})", "calls": nc / 10,
                 "own_ms": tt / 10 * 1e3, "with_callees_ms": ct / 10 * 1e3}
                for (f, line, fn), (_, nc, tt, ct, _) in top]}


def embed_readings(cs, ft, dev, results: dict, log, traced: bool) -> None:
    model = cs.make_model(ft, dev, preset="good-surf", n_flow_layers=2)
    g = torch.Generator().manual_seed(7)
    for clouds in (50, 1):
        x = torch.randn(clouds, CLOUD_N, 6, generator=g).to(dev)
        r = host_gaps(cs, model, x) if traced else {}
        r.update(host_costs(model, x))
        results[f"embed, {clouds} clouds"] = r
        log(f"b8/b9 split: embed, {clouds} clouds " + json.dumps(r))


def run(src: Path, work: Path, embed_only: bool, log=print) -> dict:
    import chip_smoke as cs
    import flowcompare_tpu_torch as ft
    from flowcompare_tpu_torch.ops import _build, fps_cuda as fc, sa_group_cuda as sg

    dev = torch.device("cuda")
    layout = layout_of(src)
    split = hasattr(fc, "furthest_point_sampling_levels")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    log(f"b8/b9 split: card {card}; sources {src} ({layout}); port {Path(ft.__file__).parent}")
    results = {"card": card, "sources": str(src), "layout": layout}
    assert _build.CSRC.resolve() == src, (_build.CSRC, src)
    if embed_only:
        embed_readings(cs, ft, dev, results, log, traced=False)
        return results
    data = {clouds: levels_of(cs, fc, clouds, 40 + clouds, dev) for clouds in (50, 1)}
    orig = (_build.CSRC, _build.BUILD_DIR, _build._LIB)
    try:
        for clouds, levels in data.items():
            for name, fn in calls(fc, sg, levels, split).items():
                r = reading(cs, fn)
                results[f"{name}, {clouds} clouds"] = r
                log(f"b8/b9 split: {name}, {clouds} clouds " + json.dumps(r))
        embed_readings(cs, ft, dev, results, log, traced=True)
        if (src / "fps.cu").read_text().count(FPS_ANCHOR) == 1:
            r = fps_block_sizes(cs, _build, data, src, work)
            results["B8 block sizes"] = r
            log("b8/b9 split: B8 block sizes " + json.dumps(r))
        for stage, edits in LAYOUTS[layout].items():
            plant(src, work / stage / "csrc", [(f, a, a + " " + after) for f, a, after in edits])
            use_sources(_build, work / stage / "csrc", work / stage / "build")
            # a stopped selection leaves its slot lists unwritten: no gather reads them
            staged = "B9 selection" if split else "B9 level"
            for clouds, levels in data.items():
                for name, fn in calls(fc, sg, levels, split).items():
                    if name.startswith(staged):
                        r = reading(cs, fn)
                        results[f"to {stage}: {name}, {clouds} clouds"] = r
                        log(f"b8/b9 split: to {stage}: {name}, {clouds} clouds "
                            + json.dumps(r))
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._LIB = orig
    table = {}
    for key, r in list(results.items()):
        if f"to selection: {key}" in results:
            d = results[f"to distances: {key}"]["device_ms"]
            s = results[f"to selection: {key}"]["device_ms"]
            table[key] = {"distances": d, "selection": s - d, "gather": r["device_ms"] - s,
                          "device": r["device_ms"]}
    results["B9 device split"] = table
    log("b8/b9 split: B9 device split " + json.dumps(table))
    return results


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--csrc", type=Path, default=None,
                        help="the kernel sources to measure, <checkout>/flowcompare_tpu_torch/"
                             "csrc (default: this checkout's); that checkout's port is imported")
    parser.add_argument("--workdir", type=Path, default=None,
                        help="where the stage copies are built (default: a new temporary "
                             "directory, removed at the end)")
    parser.add_argument("--out", type=Path, default=REPO / "build" / "b8_b9_split.json")
    parser.add_argument("--embed-only", action="store_true",
                        help="measure only the embed's wall ms and host costs")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_b8_b9_split: needs a CUDA device", file=sys.stderr)
        return 1
    src = (args.csrc or REPO / "flowcompare_tpu_torch" / "csrc").resolve()
    sys.path[:0] = [str(src.parents[1]), str(REPO)]
    work = args.workdir or Path(tempfile.mkdtemp(prefix="b8_b9_split_"))
    try:
        results = run(src, work, args.embed_only)
    finally:
        if args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
