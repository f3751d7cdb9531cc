#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flowcompare_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. device: the card's name and `nvidia-smi` name and power limit;
2. build: nvcc builds every kernel of the eval path from csrc/ (timed);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the shapes the dulcet-universe eval gives it (B3 at the four
   EdgeConv widths, B4 on a full encoder, B2 at full width, B1 on two
   full-width layers), with the kernel's and the plain version's time;
4. main path: the full-depth, full-width dulcet-universe eval through
   `evaluate_on_test` (random weights from a seed, random clouds from a
   seed, 2 items of B=4, both directions), with launch counters showing that
   B4, B3, B2 and B1 ran, held against the plain path on the same noise:
   |d nats| <= 0.01 and change maps agreeing on >= 99.9% of points;
5. timing: the main path at the preset's batch size (B=20), points/s.

Prints, last, one JSON line of per-kernel results, the nvidia-smi line and
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
EVAL_B, TIME_B = 4, 20            # eval items of 4 for the check, 20 for timing


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def perturb_identity_leaves(model, gen: torch.Generator) -> None:
    """Random, seeded LinearLU, ActNorm and BatchNorm leaves (the model's own
    init leaves them at identity), so every product of the path does work."""
    with torch.no_grad():
        for name, p in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            # small enough that 115 stacked LinearLU factors stay well conditioned
            if leaf in ("lower_entries", "upper_entries"):
                p.add_(1e-3 * torch.randn(p.shape, generator=gen))
            elif leaf in ("unconstrained_upper_diag", "shift", "log_scale"):
                p.add_(0.01 * torch.randn(p.shape, generator=gen))
            elif leaf == "mean":
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
            elif leaf == "var":
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))
            elif name.endswith("bn.scale"):
                p.copy_(torch.sign(torch.randn(p.shape, generator=gen))
                        * (0.5 + torch.rand(p.shape, generator=gen)))


def make_model(ft, device, **overrides):
    cfg = ft.get_config("dulcet-universe")
    cfg.update(compute_dtype="bfloat16", **overrides)
    model = ft.FlowCompareModel(cfg, generator=torch.Generator().manual_seed(SEED))
    perturb_identity_leaves(model, torch.Generator().manual_seed(SEED + 1))
    return model.to(device)


def eval_items(cfg, batch: int, n_items: int, seed: int):
    """The 11-tensor eval items as plain random clouds (context- or target-sized)."""
    rng = np.random.default_rng(seed)
    sizes = {"c": cfg["n_samples_context"], "t": cfg["sample_size"]}
    items = []
    for _ in range(n_items):
        item = []
        for s in "ctecttctctt":
            shape = (batch, 1) if s == "e" else (batch, sizes[s], 6)
            item.append(rng.normal(size=shape).astype(np.float32))
        items.append(item)
    return items


def make_noise(device):
    def noise(item, shape):
        g = torch.Generator(device=device).manual_seed(1000 + item)
        return torch.randn(shape, generator=g, device=device)
    return noise


def kernel_entry(name, source, replaces, err, ms, plain_ms):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_kernels(ft, model, device):
    """Each kernel against its plain version at the main path's shapes."""
    from flowcompare_tpu_torch.core.mlp import cast_tree
    from flowcompare_tpu_torch.ops import dgcnn_cuda, edgeconv_cuda, flow_layer_cuda as flc

    cfg = model.config
    rows = 2 * EVAL_B                          # both directions of an eval item
    nc, n, k = cfg["n_samples_context"], cfg["sample_size"], cfg["n_neighbors"]
    g = torch.Generator().manual_seed(SEED + 2)

    def rand(*shape):
        return torch.randn(shape, generator=g).to(device)

    entries = {}

    # B3 at each EdgeConv width: exact on integer features, a row budget on
    # random ones (a different f32 sum order may flip a near-tied k-th row)
    err3, worst_rows, ms3, plain3 = 0.0, 0.0, 0.0, 0.0
    for cq, cout in [(6, 64), (64, 64), (64, 128), (128, 256)]:
        xi = torch.randint(-4, 5, (rows, nc, cq), generator=g).to(device).bfloat16()
        u = rand(rows, nc, cout).bfloat16()
        got = edgeconv_cuda.edge_neighbor_max(xi, u, k)
        torch.cuda.synchronize()
        ref = edgeconv_cuda.edge_neighbor_max_plain(xi, u, k)
        err3 = max(err3, float((got.float() - ref.float()).abs().max()))
        x = rand(rows, nc, cq).bfloat16()
        rows_differ = float((edgeconv_cuda.edge_neighbor_max(x, u, k)
                             != edgeconv_cuda.edge_neighbor_max_plain(x, u, k)).any(-1)
                            .float().mean())
        worst_rows = max(worst_rows, rows_differ)
        ms = time_ms(lambda: edgeconv_cuda.edge_neighbor_max(x, u, k))
        pms = time_ms(lambda: edgeconv_cuda.edge_neighbor_max_plain(x, u, k), reps=2)
        ms3, plain3 = ms3 + ms, plain3 + pms
        log(f"B3 knn_edge_max {cq}->{cout} x{rows}x{nc} k={k}: integer-input max|err| "
            f"{err3} (tolerance 0), random-input rows differing {rows_differ} "
            f"(budget 0.01); {ms} ms vs plain {pms} ms")
    assert err3 == 0.0, f"B3 not exact on integer inputs: {err3}"
    assert worst_rows <= 0.01, f"B3 rows differing {worst_rows} > 0.01"
    entries["B3"] = kernel_entry(
        "edge_neighbor_max (knn_edge_max)", "flowcompare_tpu_torch/csrc/knn_edge_max.cu",
        "flowcompare_tpu/ops/edgeconv_pallas.py:493", err3, ms3, plain3)

    # B4 on a full encoder, B=2
    params = cast_tree(model.params()["embedder"], torch.bfloat16)
    state = model.state.tree()["embedder"]
    x = rand(2, nc, 6)
    got = dgcnn_cuda.fused_dgcnn_encoder(x, params, state, k=k)
    torch.cuda.synchronize()
    ref = dgcnn_cuda.fused_dgcnn_encoder_plain(x, params, state, k=k)
    d = (got.float() - ref.float()).abs()
    err4, mean4, share4 = float(d.max()), float(d.mean()), float((d > 0.1).float().mean())
    ms = time_ms(lambda: dgcnn_cuda.fused_dgcnn_encoder(x, params, state, k=k))
    pms = time_ms(lambda: dgcnn_cuda.fused_dgcnn_encoder_plain(x, params, state, k=k), reps=2)
    log(f"B4 fused_dgcnn_encoder 2x{nc}x6 -> {tuple(got.shape)}: max|err| {err4}, "
        f"mean|err| {mean4} (tolerance 1e-3), share |err|>0.1 {share4} (budget 1e-3); "
        f"{ms} ms vs plain {pms} ms")
    assert mean4 <= 1e-3 and share4 <= 1e-3, "B4 disagrees with its plain version"
    entries["B4"] = kernel_entry(
        "fused_dgcnn_encoder", "flowcompare_tpu_torch/ops/dgcnn_cuda.py",
        "flowcompare_tpu/ops/dgcnn_pallas.py:336", err4, ms, pms)

    # B2 at full width
    params_all = model.params()
    folded_aug = flc.fold_augmenter(params_all["augmenter"], input_dim=6, extra_dim=1)
    xa, eps = rand(rows, n, 6), rand(rows, n, cfg["latent_dim"] - 6)
    ctx, extra = rand(rows, nc, cfg["input_embedding_dim"]).bfloat16(), rand(rows, n, 1)
    z, l = flc.fused_augmenter(xa, eps, ctx, extra, folded_aug)
    torch.cuda.synchronize()
    zr, lr = flc.fused_augmenter_plain(xa, eps, ctx, extra, folded_aug)
    errz, errl = float((z - zr).abs().max()), float((l - lr).abs().max())
    rel2 = float(((l - lr).abs() / lr.abs().clamp_min(1.0)).max())
    ms = time_ms(lambda: flc.fused_augmenter(xa, eps, ctx, extra, folded_aug))
    pms = time_ms(lambda: flc.fused_augmenter_plain(xa, eps, ctx, extra, folded_aug), reps=2)
    log(f"B2 fused_augmenter {rows}x{n}x6 -> z {tuple(z.shape)}: max|dz| {errz} "
        f"(tolerance 0.02), max|d ldj| {errl}, max relative d ldj {rel2} (tolerance 1e-4); "
        f"{ms} ms vs plain {pms} ms")
    assert errz <= 0.02 and rel2 <= 1e-4, "B2 disagrees with its plain version"
    entries["B2"] = kernel_entry(
        "fused_augmenter", "flowcompare_tpu_torch/ops/flow_layer_cuda.py",
        "flowcompare_tpu/ops/flow_layer_pallas.py:1504", errz, ms, pms)

    # B1 on two full-width layers (one stacked layer and the final block)
    small = make_model(ft, device, n_flow_layers=2)
    folded = small._folded(small.params(), 1)
    xf, ldj = rand(rows, n, cfg["latent_dim"]), torch.zeros(rows, n, device=device)
    z, l = flc.fused_flow_layers(xf, ldj, ctx, extra, folded)
    torch.cuda.synchronize()
    zr, lr = flc.fused_flow_layers_plain(xf, ldj, ctx, extra, folded)
    errz, errl = float((z - zr).abs().max()), float((l - lr).abs().max())
    ms = time_ms(lambda: flc.fused_flow_layers(xf, ldj, ctx, extra, folded))
    pms = time_ms(lambda: flc.fused_flow_layers_plain(xf, ldj, ctx, extra, folded), reps=2)
    log(f"B1 fused_flow_layers 2 layers {rows}x{n}x{cfg['latent_dim']}: max|dz| {errz} "
        f"(tolerance 0.05), max|d ldj| {errl} (tolerance 0.01); {ms} ms vs plain {pms} ms")
    assert errz <= 0.05 and errl <= 0.01, "B1 disagrees with its plain version"
    entries["B1"] = kernel_entry(
        "fused_flow_layers", "flowcompare_tpu_torch/ops/flow_layer_cuda.py",
        "flowcompare_tpu/ops/flow_layer_pallas.py:924", errz, ms, pms)
    del small
    return entries


def phase_main_path(ft, model, device):
    """Full-depth eval through evaluate_on_test; kernel path vs plain path."""
    from flowcompare_tpu_torch.ops import dgcnn_cuda, edgeconv_cuda, flow_layer_cuda as flc

    items = eval_items(model.config, EVAL_B, 2, SEED + 3)
    noise = make_noise(device)
    flc.FUSED_FLOW_LAYERS_LAUNCHES = flc.FUSED_AUGMENTER_LAUNCHES = 0
    dgcnn_cuda.FUSED_DGCNN_ENCODER_LAUNCHES = edgeconv_cuda.EDGE_NEIGHBOR_MAX_LAUNCHES = 0
    maps_k = []
    t0 = time.perf_counter()
    nats_k, fr_k = ft.evaluate_on_test(model, items, noise=noise, change_maps=maps_k)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    launches = {"B1": flc.FUSED_FLOW_LAYERS_LAUNCHES, "B2": flc.FUSED_AUGMENTER_LAUNCHES,
                "B3": edgeconv_cuda.EDGE_NEIGHBOR_MAX_LAUNCHES,
                "B4": dgcnn_cuda.FUSED_DGCNN_ENCODER_LAUNCHES}
    log(f"main path (kernels): nats {nats_k}, changed fractions {fr_k}, {t_k} s, "
        f"launches {launches}")
    model.plain = True
    maps_p = []
    nats_p, fr_p = ft.evaluate_on_test(model, items, noise=noise, change_maps=maps_p)
    model.plain = False
    assert all(v > 0 for v in launches.values()), f"a kernel of the path never ran: {launches}"
    assert np.isfinite(nats_k) and np.isfinite(nats_p), (nats_k, nats_p)
    assert len(fr_k) == 2 * EVAL_B and all(0.0 <= f <= 1.0 for f in fr_k), fr_k
    assert all(m.shape == (EVAL_B, model.config["sample_size"]) for m in maps_k)
    agree = float(torch.cat([(a > 0) == (b > 0) for a, b in zip(maps_k, maps_p)])
                  .float().mean())
    log(f"main path (plain): nats {nats_p}, changed fractions {fr_p}; |d nats| "
        f"{abs(nats_k - nats_p)} (tolerance 0.01), change-map agreement {agree} "
        f"(tolerance >= 0.999)")
    assert abs(nats_k - nats_p) <= 0.01, "nats disagree with the plain path"
    assert agree >= 0.999, "change maps disagree with the plain path"
    return launches


def phase_timing(ft, model, device):
    """Main-path throughput at B=20, and the per-kernel split of one item."""
    from flowcompare_tpu_torch.model import inner_loop

    cfg = model.config
    items = eval_items(cfg, TIME_B, 3, SEED + 4)
    noise = make_noise(device)
    ft.evaluate_on_test(model, items[:1], noise=noise)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ft.evaluate_on_test(model, items[1:], noise=noise)
    torch.cuda.synchronize()
    per_item = (time.perf_counter() - t0) / 2
    n = cfg["sample_size"]
    out = {"item_s": per_item, "points_per_s": 2 * TIME_B * n / per_item,
           "target_points_per_s": TIME_B * n / per_item,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    # the split of one item's two directions over the three stages
    v = [torch.as_tensor(a, device=device) for a in items[1]]
    ctx_in, tgt = torch.cat([v[0], v[8]]), torch.cat([v[1], v[7]])
    extra = torch.cat([v[2], v[2]])[:, None, :].expand(2 * TIME_B, n, 1)
    eps = noise(0, (2 * TIME_B, n, cfg["latent_dim"] - cfg["input_dim"]))
    with torch.no_grad():
        emb = model.embed(ctx_in)
        out["embed_ms"] = time_ms(lambda: model.embed(ctx_in), reps=3)
        out["log_prob_ms"] = time_ms(lambda: model.log_prob(tgt, emb, extra, eps), reps=2)
        out["inner_loop_ms"] = time_ms(
            lambda: inner_loop(model, (ctx_in, tgt, torch.cat([v[2], v[2]])), eps=eps), reps=2)
        model.plain = True
        out["plain_inner_loop_ms"] = time_ms(
            lambda: inner_loop(model, (ctx_in, tgt, torch.cat([v[2], v[2]])), eps=eps), reps=1)
        model.plain = False
    log(f"timing at B={TIME_B} (both directions, {2 * TIME_B * n} points per item): {out}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import flowcompare_tpu_torch as ft
    from flowcompare_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} ({torch.cuda.device_count()} visible); nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            log("  ptxas:", line.strip())

    t0 = time.perf_counter()
    model = make_model(ft, device)
    log(f"model: dulcet-universe bf16, {sum(p.numel() for p in model.parameters())} "
        f"parameters, built in {time.perf_counter() - t0:.1f} s")
    entries = phase_kernels(ft, model, device)
    launches = phase_main_path(ft, model, device)
    timing = phase_timing(ft, model, device)
    for key, entry in entries.items():
        entry["launches"] = launches[key]
    print(json.dumps({"main_path": timing}))
    print(json.dumps({"kernels": [entries[k] for k in ("B1", "B2", "B3", "B4")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
