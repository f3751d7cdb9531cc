#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flowcompare_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. device: the card's name and `nvidia-smi` name and power limit;
2. build: nvcc builds every kernel from csrc/ (timed);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the shapes the dulcet-universe paths give it (B3 at the four
   EdgeConv widths, B4 on a full encoder at 2 clouds and at a B=20 item's
   40, B2 at full width at 8 x 1024 rows and a B=20 item's 40,960, each
   with its wall and device time and launches a call, and the kernels of
   their chains: the DGCNN tail on 50,000 rows, B2's net and epilogue and
   the packed rows on 40,960; B1 on two
   full-width layers, B6 forward and backward at the four widths, B5 on two
   full-width layers, B7 on two full-width layers at a sample's 1 x 4000
   points), with the kernel's and the plain version's time and the least
   time the card could take (bound); B5 also beside the per-product chain it
   replaced (`_bwd_per_product`, the comparison route) and with its shares
   of elements off the fused route's plain version (reported); B3 and B6
   also at the main path's shapes, 40 clouds x 1,250 (a B=20 item) and 50
   (B=25), timed beside plain and bound and held to the same row budget
   (their kernels-line entries are the 40-cloud readings), and their split
   by tools/torch_knn_split.py (distances / selection / gather of each
   forward, the backward's kernels, the radix select's sweeps a row);
4. eval main path: the full-depth, full-width dulcet-universe eval through
   `evaluate_on_test` (random weights from a seed, random clouds from a
   seed, 2 items of B=4, both directions), with launch counters showing that
   B4, B3, B2 and B1 ran, each B4 call in at most 10 launches and each B2
   call in at most 5 (`check_b4_b2`: no per-product gemm in B4's head or
   B2's net) and their weights folded once, held against the plain path on
   the same noise: |d nats| <= 0.01 and change maps agreeing on >= 99.9% of
   points; every later path asserts the same launches a call, and the eval
   timing and make_sample no fold (the weights have not changed);
5. eval timing: the main path at the preset's batch size (B=20), points/s,
   and a torch.profiler trace of one item summed by kernel;
6. sampling main path: a full-depth `make_sample` of 1 x 4000 points (the
   trainer's and the eval dumps' call) through the kernels, with launch
   counters showing that B4 (B3 inside it) and B7 ran, and through the
   plain versions on
   the same z: max and mean |dx|, the nats of both sample sets scored by
   the eval path on the same noise (|d nats| <= 0.01), and the round trip
   z -> B7 -> B1 -> z';
7. sampling timing: ms per `make_sample` at 1 x 4000 and points/s of
   `model.sample` at B=20 x 1024, and a torch.profiler trace of one
   `make_sample` summed by kernel with the idle share;
8. training check: at B=2, full depth and width, the ActNorm data init and
   one `train_step` through the kernels and one through the plain versions
   from the same state, batch and noise: |d nats| <= 0.01, pre-clip grad
   norm within 5%, gradient cosine >= 0.99 per parameter group, and launch
   counters showing that B6, B1 with saves and B5 ran;
9. training main path: `train(..., max_steps=4, make_samples=True)` at
   B=20 with a sample every second batch (data init, one warm-up step,
   three timed steps, two 4000-point samples written), launch counters read
   around it, ms per step, peak memory, finite losses and finite samples;
10. training split and profile at B=20: device time of data init, forward,
   backward (B1 with saves, B5, B6 inside) and optimizer; B5 again on that
   step's arguments (115 layers) in device time beside the per-product
   chain's, with every kernel each launches over the layers; and a
   torch.profiler trace of one step summed by kernel with the idle share.
   The training main path shows, through counters around B5, its fused
   kernels: 11 launches a layer with attention, 4 without, no per-product
   MLP gemm, no gemm_tn and no colsum (`check_b5_launches`);
11. good-surf (PAConv, bf16, full depth and width; the dulcet-universe
   model is freed first): B8 (the four set-abstraction levels in one
   launch) and B9 (one selection launch for the four levels, a gather a
   level) against their plain versions at a B=25 eval's 50 clouds and at
   `make_sample`'s 1 (B8 index-equal on random and duplicated clouds, with
   its dependent-chain floor from `_build.fps_round_probe`; B9 equal on
   integer coordinates in bf16 and f32, at most 1e-3 of rows differing on
   random ones, slot 0 the centre, k = 32 > N = 19 at level 4), each part's
   wall and device ms beside its plain version and bound; the eval main
   path through `evaluate_on_test` (2 items of B=4, B2 and B1 counted)
   against the plain path (|d nats| <= 0.01, change maps >= 99.9%); eval
   timing at the preset's B=25 (points/s, the encoder's ms) and a profile
   of one item; `make_sample` of 1 x 4000 (B7 counted) against the plain
   samples of the same z (|d nats| <= 0.01); the training check at B=2 (the
   bounds of step 8, the PAConv encoder's gradient among the groups) and
   `train(max_steps=4, make_samples=True)` at B=25 (ms/step, peak memory);
   on each path B8, B9's selection and its gather at 1, 1 and 4 launches
   an eval embed and B8 alone in a training embed (`check_paconv_launches`:
   2 / 2 / 8 on the eval run, 1 / 1 / 4 on make_sample, 1 / 0 / 0 on one
   train_step, 7 / 3 / 12 on train);
12. B10 (run first, before any model is built): the fused attention core
   (TMA + wgmma, p in three bf16 terms) against its plain version at the
   flow's attention shapes (q (20, 1024, 64) against 1250 keys) and at
   helpful-sponge's augmenter shape ((25, 1024, 64) against 1024 keys), with
   the kernel's, the plain version's and scaled_dot_product_attention's
   times (flash, on 4-D views), each one's share of outputs more than half
   a bf16 ulp off plain (the kernel's within B10_SHARE_LIMIT and below
   flash's) and the bound; its entry point
   `apply_cross_attention(fused=True)` against fused=False, forward and
   autograd backward, with the launch counters around the fused call;
13. helpful-sponge (the global DGCNN and the global conditioner, bf16, full
   depth and width; the good-surf model is freed first): B4 with head=False
   at 50 clouds, B2 over the broadcast 124-wide embedding at 8 x 1024 and
   a B=25 item's 51,200 rows (extra=None), and B1, B5 and
   B7 on two has_attn=False layers against their plain versions; the eval
   main path at 2 items of B=4 against the plain path (B4, B3, B2 and B1
   counted, B10 not; |d nats| <= 0.01, change maps >= 99.9%); eval timing
   and a profile at the preset's B=25; make_sample of 1 x 4000 against the
   plain samples of the same z (|d nats| <= 0.01); the training check at
   B=2 (the embedder's gradient among the groups) and
   `train(max_steps=4, make_samples=True)` at B=25;
14. GEMM (run second, before any model is built): gemm_bf16 and gemm_tn
   at the main path's shapes (`phase_gemm`): each product of one flow layer
   with the epilogue flags the chains pass, at dulcet-universe's eval rows
   (40,960; kv over 50,000 context rows), helpful-sponge's (51,200) and one
   sample's 4,000, B5's A @ W^T at the training rows (20,480 and 25,600)
   and its weight gradients A^T @ B over them; each on the TMA + wgmma and
   the WMMA route against the plain version (one bf16 rounding for bf16
   outputs, 1e-4 of max |ref| for f32), with both routes' ms in turns, the
   plain version's, torch.matmul's (the library yardstick) and the bound.
   Every main path (eval, make_sample, train) then shows, through counters
   around the B1, B2, B5 and B7 entry points, that no product inside those
   chains took the WMMA route, and that none outside them did either (B4's
   first EdgeConv stage reads the cloud cast into 8 bf16 columns);
15. attention (run third, before any model is built): the chains' cross
   attention, csrc/cross_attention.cu and cross_attention_bwd.cu, on the
   TMA + wgmma route against the plain versions at dulcet's eval launch and
   training shape (20 x 1024 queries x 1250 keys, with m and den),
   helpful-sponge's augmenter (25 x 1024 x 1024), a sample (1 x 4000 x
   1250) and two cross-item cases (items after the first hold large
   queries and keys): the forward within one bf16 rounding (rtol = atol =
   1e-2), m and den within 1e-4; dq, dk, dv with cosine >= 0.9999 and max
   error <= 1e-2 of max |ref|. At the three main shapes, the device time
   (the kernels' durations in a torch.profiler trace) of both routes, of
   the plain version and of flash
   scaled_dot_product_attention on 4-D views (forward, and the backward
   alone: the library yardstick), a call's time through the wrapper (CUDA
   events, the host included) and the bound. Every main path then shows
   0 WMMA attention launches, and the wgmma forward (eval, make_sample,
   train) and backward (train) launched wherever the path has attention;
16. fused layers (run fourth, before any model is built): the two kernels of
   a coupling layer, csrc/fused_layer.cu (`conditioner`, `coupling_layer`
   with and without saves, `coupling_inverse` with the chained LU
   inverse), against their plain versions at dulcet-universe's eval rows
   (40,960), training rows (20,480) and a sample's 4,000, and
   helpful-sponge's 51,200 (seven coupling products), with their device
   times, the plain versions', the per-product route's (the launches a
   layer took before), the bound and launches per layer. Every main path (eval, make_sample, train)
   then shows, through counters around B1 and B7, no per-product MLP gemm
   inside them and 4 launches a layer with attention, 1 without
   (`check_flow_launches`); and the bounds of B1, B2, B3, B4 and B6 at the
   main path's own shapes (one B=20 item) are computed from shapes;
17. B5's fused per-layer kernels (after the fused-layer phase, and first in
   helpful-sponge's phases): conditioner_record, coupling_record
   (csrc/fused_layer.cu's record mode), coupling_bwd, conditioner_bwd
   (csrc/fused_layer_bwd.cu), gemm_tn_grouped and grad_reduce
   (csrc/gemm_tn_grouped.cu), each against its plain version on the same
   inputs inside one B5 call on two full-width layers at the training rows
   (dulcet-universe 20 x 1024, helpful-sponge 25 x 1024) and held to
   B5_PROBE_LIMITS, their device ms per launch and bounds; B5 against flow_layers_bwd_plain (max-error
   bands) and against its fused route's plain version within B5_LIMITS,
   two calls bit-equal, launches a layer (11 / 4), and the per-product
   chain timed beside it;
18. swept-energy (last, the helpful-sponge model freed first): the eval
   main path at full width and depth against the plain path, the one path
   through B4 with its head and B2's extra=None packed rows, with the same
   bounds and launch and fold checks, and eval timing at B=20;
19. data (`phase_data`, after the dulcet-universe phases, on that model;
   summer-terrain's part after swept-energy): the port's data layer
   (flowcompare_tpu_torch/data, native/) with no JAX: (a) the native
   libraries built from native/*.cpp and loaded, the native FPS
   index-equal to its numpy body; (b) a two-epoch street scene written as
   LAS and LAZ scans with a response.json (build/chip_smoke_data/), the two
   decodes equal, AmsVoxelLoader's offline build over it in train mode
   (LAZ) and with include_all (LAS) at the presets' 1,250 / 1,024 points
   and voxel sizes (clearance 2 m), every item's shapes and finite values,
   its eval items through evaluate_on_test; (c) dulcet-universe at full
   width and depth: train(max_steps=2) at B=20 from SyntheticVoxelDataset
   through PrefetchedDataset, then the eval main path on two include_all
   batches of B=20 against the plain path (the bounds of step 4); (d)
   summer-terrain (PAConv, no extra context) at full width and depth, B=25,
   from SyntheticVoxelDataset(with_extra=False, include_all=True) through
   the eval main path against the plain path, B8 / B9 / gather launches
   2 / 2 / 8, then its make_sample of 1 x 4000 (B7, B8, B9 and the gather;
   1 / 1 / 4) and its training check at B=2 (B5, B1 with saves, B8 alone)
   against the plain path with the bounds of steps 6 and 8, the first
   sampling and training through PAConv with B5's and B7's extra=None
   branches; (e) the host ms of one batch of 20 of each source (synthetic
   train and eval, AmsVoxelLoader eval, PackedVoxelDataset) beside the
   card's ms of one item, with the host CPU's model name;
20. flow variants (`phase_variants`, last, the previous model freed
   first): (a) dulcet-universe with RationalQuadraticSplineCoupling and
   ExponentialCombiner at full width and depth (the combiner's w drawn at
   VARIANT_W_SCALE of the reference's init, which overflows float32 at this
   depth): evaluate_on_test from SyntheticVoxelDataset against plain=True
   (|d nats| <= 0.01, change maps >= 99.9%), timed at B=20 beside
   dulcet-universe's item, one make_sample of 1 x 4000 (finite) and
   train(max_steps=2) at B=4 (reduced from the preset's 20; finite
   losses), B4 and B3 launched and none of B1, B2, B5, B7; (b) a sweep of
   VARIANT_SWEEP at full width and 2 layers, one eval item of B=2 each:
   finite nats within 0.01 of plain, the float32 layer stack's round trip
   within 1e-3 max-abs (not CIF, whose slices draw again), B2, B5 and B7
   not launched and B1 exactly on the kernels' route (so not on the RELU
   row);
21. the CLI (`phase_cli`, after swept-energy, before summer-terrain's data
   part and the variants): `flowcompare_tpu_torch.cli.main` in this process
   in build/chip_smoke_cli/: `train --config swept-energy --bf16 --data
   synthetic --steps 3 --save-final` at full width and depth, B=20, then
   `evaluate` (two items of B=20; its printed JSON checked) and `sample`
   (4,000 points) from that checkpoint, each with the counters set to 0
   just before and read just after (B5, B6, B1 with saves; B1-B4; B7, B4,
   B3) and the route, fused-layer, B5 and B4/B2 checks; then the same
   checkpoint through `compat.load_any_checkpoint`: evaluate_on_test(
   compute_reverse=True) on the kernels and on plain=True with the same
   noise (|d nats| <= 0.01, forward and reverse change maps >= 99.9%), the
   eval item's ms and points/s, and swept-energy's sampling and training
   checks at full width (`phase_sample_main`, `phase_train_check`: B7 and
   B5 with extra=None); each subcommand's wall seconds printed beside the
   card's name and power limit;
22. routes from the shapes (`phase_c1`, after the variants): three bf16
   dulcet-universe configs at 2 layers and full width that the kernels
   refuse part by part (D = 32: the stack and the augmenter; a 1,024-wide
   coupling MLP: the stack and the augmenter; k = 80: the encoder), each
   printing `model.routes`; log_prob, one train_step after the data init
   and make_sample of 1 x 4000 at B=2 on CUDA against plain=True (|d nats|
   <= 0.01), the refused parts' kernels never launched and the others'
   launched; every preset model `make_model` builds must read "kernels"
   for every part;
23. the convergence demo (`phase_demo`, last):
   examples/convergence_demo_torch.py in processes of its own into
   build/chip_smoke_demo/ (cross_dim_head 32, the JAX demo's: the stack and
   the augmenter plain, the DGCNN on B4, B3 and B6) and
   build/chip_smoke_demo_d64/ (64: every part on its kernels, 240 steps
   through B5), each held to loss last8 < first8, AUC >= 0.95, its routes
   and its kernels' launches; then the round trip z -> B7 -> B1 -> z' layer
   by layer on the D = 64 run's checkpoint, kernels and plain.

Prints, last, one JSON line of per-kernel results (B1-B10 with B9's
gather as `sa_gather`, gemm_bf16,
gemm_tn, cross_attention, cross_attention_bwd, conditioner,
coupling_layer, coupling_inverse, B5's conditioner_record,
coupling_record, coupling_bwd, conditioner_bwd, gemm_tn_grouped and
grad_reduce, and B4's and B2's dgcnn_tail, augment_net and pack_rows at
their headline shapes;
B1, B2, B4, B5 and B7 carry their helpful-sponge branch's check under
"global", B10 its second shape), the nvidia-smi line and {"ok": true,
"device": {...}}.
Exits non-zero without a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
EVAL_B, TIME_B = 4, 20            # eval items of 4 for the check, 20 for timing
GS_B = 25                         # good-surf's batch (its preset), for timing and training
TRAIN_CHECK_B = 2                 # the training check's batch; timing uses TIME_B
SAMPLE_N = 4000                   # points of one sample, as the trainer and eval dumps take
SAMPLE_STD = 0.6                  # the sampler's latent scale (make_sample's default)
REPO = Path(__file__).resolve().parent
T_START = time.perf_counter()
# H100 SXM dense bf16 tensor-core peak, f32 peak outside the tensor cores and
# HBM3 rate (NVIDIA's data sheet)
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 989e12, 67e12, 3.35e12
EDGE_WIDTHS = [(6, 64), (64, 64), (64, 128), (128, 256)]
# (N, M, C) of PAConv's four set-abstraction levels on the 1250-point context
SA_LEVELS = [(1250, 312, 3), (312, 78, 64), (78, 19, 128), (19, 4, 256)]
SA_K = 32


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
                p.add_(1e-3 * torch.randn(p.shape, generator=gen).to(p.device))
            elif leaf in ("unconstrained_upper_diag", "shift", "log_scale"):
                p.add_(0.01 * torch.randn(p.shape, generator=gen).to(p.device))
            elif leaf == "mean":
                p.add_(0.05 * torch.randn(p.shape, generator=gen).to(p.device))
            elif leaf == "var":
                p.copy_(0.5 + torch.rand(p.shape, generator=gen).to(p.device))
            elif name.endswith("bn.scale"):
                p.copy_((torch.sign(torch.randn(p.shape, generator=gen))
                         * (0.5 + torch.rand(p.shape, generator=gen))).to(p.device))


def make_model(ft, device, preset: str = "dulcet-universe", **overrides):
    """The preset under bf16 with random weights from SEED. A preset at its
    own widths (overrides of the depth at most) must read "kernels" for
    every part of `model.routes`: no preset falls off its kernels."""
    cfg = ft.get_config(preset)
    cfg.update(compute_dtype="bfloat16", **overrides)
    model = ft.FlowCompareModel(cfg, device=device, generator=torch.Generator().manual_seed(SEED))
    perturb_identity_leaves(model, torch.Generator().manual_seed(SEED + 1))
    if set(overrides) <= {"n_flow_layers"}:
        assert all(r == "kernels" for r in model.routes.values()), (preset, dict(model.routes))
    return model


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
    """The forward pass's draws for item i from a generator seeded 1000 + i:
    a tensor of `shape`, or for CIF a dict of them in key order."""
    def noise(item, shape):
        g = torch.Generator(device=device).manual_seed(1000 + item)
        if isinstance(shape, dict):
            return {k: torch.randn(v, generator=g, device=device) for k, v in shape.items()}
        return torch.randn(shape, generator=g, device=device)
    return noise


def nbytes(*trees) -> int:
    """Bytes of every tensor in nested dicts, lists and tuples."""
    total = 0
    for tree in trees:
        if isinstance(tree, dict):
            total += nbytes(*tree.values())
        elif isinstance(tree, (list, tuple)):
            total += nbytes(*tree)
        elif isinstance(tree, torch.Tensor):
            total += tree.numel() * tree.element_size()
    return total


def bound(flops, moved: float, peak: float = PEAK_BF16_FLOPS):
    """The least time the card could take: the larger of the operations over
    the peak of their type (bf16 tensor cores unless given; `flops` may be a
    list of (operations, peak) pairs of several types, whose times add) and
    the bytes (each input read once, each output written once) over the
    memory rate, in ms, and which of the two it is."""
    parts = flops if isinstance(flops, list) else [(flops, peak)]
    ops_ms = sum(f / pk for f, pk in parts) * 1e3
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def kernel_entry(name, source, replaces, err, ms, plain_ms, flops, moved,
                 peak: float = PEAK_BF16_FLOPS, library_ms=None):
    """library_ms: one PyTorch call that computes the same function, where
    there is one (B10's scaled_dot_product_attention), else null."""
    bound_ms, bound_by = bound(flops, moved, peak)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def check_entry(entry: dict, shapes: str) -> dict:
    """A second check of a kernel (another branch or shape): its numbers
    without the kernel's identity."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    return {"shapes": shapes, **{k: entry[k] for k in keys}}


B5_SOURCES = {"conditioner_record": "flowcompare_tpu_torch/csrc/fused_layer.cu",
              "coupling_record": "flowcompare_tpu_torch/csrc/fused_layer.cu",
              "coupling_bwd": "flowcompare_tpu_torch/csrc/fused_layer_bwd.cu",
              "conditioner_bwd": "flowcompare_tpu_torch/csrc/fused_layer_bwd.cu",
              "gemm_tn_grouped": "flowcompare_tpu_torch/csrc/gemm_tn_grouped.cu",
              "grad_reduce": "flowcompare_tpu_torch/csrc/gemm_tn_grouped.cu"}


def b5_kernel_entries(b5: dict) -> dict:
    """The kernels line's entries of B5's per-layer kernels from
    phase_b5_fused's readings (launches filled in from the main path)."""
    out = {}
    for name, k in b5["kernels"].items():
        out[name] = {"name": name, "route": "cuda", "source": B5_SOURCES[name],
                     "replaces": "flowcompare_tpu/ops/flow_layer_vjp_pallas.py:598",
                     "launches": 0, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": None}
    return out


def _mm(rows: int, w: torch.Tensor) -> int:
    """Operations of rows @ w for one layer of a (L, in, out) stack."""
    return 2 * rows * w.shape[-2] * w.shape[-1]


def stack_flops(folded: dict, rows: int, items: int, nc: int, lu: bool = True) -> tuple:
    """(products, attention) operations of a folded stack over `rows` points
    of `items` items with nc context rows each: every weight on its rows,
    ctx @ wkv on the context rows, and q k^T and P v over the context. A
    stack without attention (the global conditioner) has only the coupling
    products and the LinearLU."""
    n_layers = folded["cpl_in_c"].shape[0]
    gemm = (_mm(rows, folded["cpl_in_xe"]) + _mm(rows, folded["cpl_in_c"])
            + sum(_mm(rows, w) for w, _ in folded["cpl_rest"]))
    if lu:
        gemm += _mm(rows, folded["lu_w_f"])
    if folded["pre"] is None:
        return gemm * n_layers, 0
    d = folded["wq_f"].shape[-1]
    gemm += (sum(_mm(rows, w) for w, _ in folded["pre"]) + _mm(rows, folded["wq_f"])
             + _mm(items * nc, folded["wkv"]))
    return gemm * n_layers, 2 * 2 * rows * nc * d * n_layers


def knn_flops(items: int, n: int, cq: int) -> int:
    """The distance products of an exact kNN over n rows of cq features."""
    return items * 2 * n * n * cq


def call_launches(fn, keys) -> int:
    """The launches one call of fn makes, summed over the counters `keys`."""
    before = read_counters()
    fn()
    torch.cuda.synchronize()
    after = read_counters()
    return sum(after[k] - before[k] for k in keys)


B4_COUNTERS = ("gemm wgmma", "gemm wmma", "B3", "pack_rows", "dgcnn_tail")
B2_COUNTERS = ("pack_rows", "conditioner", "gemm wgmma", "gemm wmma", "attention wgmma",
               "attention wmma", "augment_net")


def b4_flops(clouds: int, nc: int, head_ws: list) -> int:
    """B4's operations over `clouds` clouds of nc points: the four kNN
    distance products, the stage products, conv5 and the head (`head_ws`,
    empty with head=False)."""
    pts = clouds * nc
    return (sum(knn_flops(clouds, nc, cin) + 2 * 2 * pts * cin * cout for cin, cout in EDGE_WIDTHS)
            + 2 * pts * 512 * 512 + sum(2 * pts * w.shape[-2] * w.shape[-1] for w in head_ws))


def check_b4(x, params, state, k: int, head: bool, label: str) -> dict:
    """B4 at x's shape against its plain version (mean |err| <= 1e-3, share
    of |err| > 0.1 <= 1e-3): its wall time (CUDA events, host included),
    device time (the kernels' durations), plain time, launches a call and
    bound."""
    from flowcompare_tpu_torch.ops import dgcnn_cuda

    def call():
        return dgcnn_cuda.fused_dgcnn_encoder(x, params, state, k=k, head=head)

    got = call()
    torch.cuda.synchronize()
    ref = dgcnn_cuda.fused_dgcnn_encoder_plain(x, params, state, k=k, head=head)
    d = (got.float() - ref.float()).abs()
    err, mean, share = float(d.max()), float(d.mean()), float((d > 0.1).float().mean())
    per_call = call_launches(call, B4_COUNTERS)
    ms, dms = time_ms(call), device_ms(call)
    pms = time_ms(lambda: dgcnn_cuda.fused_dgcnn_encoder_plain(x, params, state, k=k, head=head),
                  reps=2)
    head_ws = ([l["w"] for l in [params["out_mlp"]["in"], *params["out_mlp"]["hidden"],
                                 params["out_mlp"]["out"]]] if head else [])
    trunk = {key: params[key] for key in ("conv1", "conv2", "conv3", "conv4", "conv5")}
    entry = kernel_entry("fused_dgcnn_encoder", "flowcompare_tpu_torch/ops/dgcnn_cuda.py",
                         "flowcompare_tpu/ops/dgcnn_pallas.py:336", err, ms, pms,
                         b4_flops(x.shape[0], x.shape[1], head_ws),
                         nbytes(x, trunk, head_ws, state, got))
    entry.update(device_ms=dms, launches_per_call=per_call)
    log(f"B4 fused_dgcnn_encoder {label} {tuple(x.shape)} -> {tuple(got.shape)}: max|err| {err}, "
        f"mean|err| {mean} (tolerance 1e-3), share |err|>0.1 {share} (budget 1e-3); {ms} ms "
        f"(device {dms}) vs plain {pms} ms, bound {entry['bound_ms']} ms; {per_call} launches a "
        f"call (at most {B4_LAUNCHES})")
    assert mean <= 1e-3 and share <= 1e-3, f"B4 ({label}) disagrees with its plain version"
    assert per_call <= B4_LAUNCHES, per_call
    return entry


def check_b2(xa, eps, ctx, extra, folded_aug, nc: int, label: str) -> dict:
    """B2 at xa's shape against its plain version (|dz| <= 0.02, relative
    d ldj <= 1e-4): wall and device time, plain time, launches a call and
    bound."""
    from flowcompare_tpu_torch.ops import flow_layer_cuda as flc

    def call():
        return flc.fused_augmenter(xa, eps, ctx, extra, folded_aug)

    z, l = call()
    torch.cuda.synchronize()
    zr, lr = flc.fused_augmenter_plain(xa, eps, ctx, extra, folded_aug)
    errz = float((z - zr).abs().max())
    rel = float(((l - lr).abs() / lr.abs().clamp_min(1.0)).max())
    per_call = call_launches(call, B2_COUNTERS)
    ms, dms = time_ms(call), device_ms(call)
    pms = time_ms(lambda: flc.fused_augmenter_plain(xa, eps, ctx, extra, folded_aug), reps=2)
    items, n = xa.shape[:2]
    ctx_read = ctx[:, :1] if ctx.stride(1) == 0 else ctx
    entry = kernel_entry("fused_augmenter", "flowcompare_tpu_torch/ops/flow_layer_cuda.py",
                         "flowcompare_tpu/ops/flow_layer_pallas.py:1504", errz, ms, pms,
                         sum(stack_flops(folded_aug, items * n, items, nc, lu=False)),
                         nbytes(xa, eps, ctx_read, extra[:, :1] if extra is not None else None,
                                folded_aug, z, l))
    entry.update(device_ms=dms, launches_per_call=per_call)
    log(f"B2 fused_augmenter {label} {tuple(xa.shape)} -> z {tuple(z.shape)}: max|dz| {errz} "
        f"(tolerance 0.02), max relative d ldj {rel} (tolerance 1e-4); {ms} ms (device {dms}) "
        f"vs plain {pms} ms, bound {entry['bound_ms']} ms; {per_call} launches a call (at most "
        f"{B2_LAUNCHES})")
    assert errz <= 0.02 and rel <= 1e-4, f"B2 ({label}) disagrees with its plain version"
    assert per_call <= B2_LAUNCHES, per_call
    return entry


def phase_b4_b2_kernels(model, device, g) -> dict:
    """B4 at 2 and 40 clouds of 1,250 (head) and B2 at 8 x 1024 and 40,960
    rows (extra context) against their plain versions, and the kernels their
    chains added, each against its plain version at the main path's shapes
    (a B=20 item: 40 clouds, 40,960 rows): the DGCNN tail (conv5 and the
    head on 50,000 rows), B2's net and epilogue, and the packed rows."""
    from flowcompare_tpu_torch.core.mlp import cast_tree
    from flowcompare_tpu_torch.ops import _build, dgcnn_cuda, flow_layer_cuda as flc

    cfg = model.config
    nc, n, k, lat = (cfg["n_samples_context"], cfg["sample_size"], cfg["n_neighbors"],
                     cfg["latent_dim"])
    bf, items = torch.bfloat16, 2 * TIME_B

    def rand(*shape):
        return torch.randn(shape, generator=g).to(device)

    out = {}
    # weights of their own (cast here), so that the eval main path's first
    # call still folds the model's
    params = cast_tree(model.params()["embedder"], bf)
    state = model.state.tree()["embedder"]
    b4 = {clouds: check_b4(rand(clouds, nc, 6), params, state, k, True, f"{clouds} clouds")
          for clouds in (2, items)}
    out["B4"] = {**b4[items], "shapes": f"{items} clouds x {nc}",
                 "at_2_clouds": {**check_entry(b4[2], f"2 clouds x {nc}"),
                                 "device_ms": b4[2]["device_ms"]}}
    folded_aug = flc.fold_augmenter(model.params()["augmenter"], input_dim=6, extra_dim=1)
    b2 = {}
    for b in (2 * EVAL_B, items):
        b2[b] = check_b2(rand(b, n, 6), rand(b, n, lat - 6),
                         rand(b, nc, cfg["input_embedding_dim"]).to(bf),
                         rand(b, 1, 1).expand(b, n, 1), folded_aug, nc, f"{b}x{n}")
    out["B2"] = {**b2[items], "shapes": f"{items}x{n}, extra context",
                 f"at_{2 * EVAL_B * n}_rows": {**check_entry(b2[2 * EVAL_B], f"{2 * EVAL_B}x{n}"),
                                               "device_ms": b2[2 * EVAL_B]["device_ms"]}}

    # the tail on 50,000 rows of a stage concat
    w = dgcnn_cuda.encoder_weights(params, state)
    stack, rows = w.tail(True), items * nc
    feats = rand(rows, 512).to(bf)
    emb = torch.empty(rows, stack.pairs[-1][0].shape[2], dtype=bf, device=device)
    tail = lambda: _build.dgcnn_tail(feats, stack, w.scale, emb)  # noqa: E731
    tail()
    torch.cuda.synchronize()
    ref = dgcnn_cuda.dgcnn_tail_plain(feats, stack.layer(0), w.scale[0])
    d = (emb.float() - ref.float()).abs()
    mean, share = float(d.mean()), float((d > 0.1).float().mean())
    out["dgcnn_tail"] = kernel_entry(
        "dgcnn_tail (conv5 and the head)", "flowcompare_tpu_torch/csrc/fused_layer.cu",
        "flowcompare_tpu/ops/dgcnn_pallas.py:336", float(d.max()), device_ms(tail),
        time_ms(lambda: dgcnn_cuda.dgcnn_tail_plain(feats, stack.layer(0), w.scale[0]), reps=2),
        sum(2 * rows * wt.shape[1] * wt.shape[2] for wt, _ in stack.pairs),
        nbytes(feats, [(wt[0, :, :wt.shape[2]], bt) for wt, bt in stack.pairs], w.scale, emb))
    log(f"dgcnn_tail {rows} rows, {len(stack.pairs)} products: max|err| {float(d.max())}, "
        f"mean|err| {mean} (tolerance 1e-3), share |err|>0.1 {share} (budget 1e-3); "
        f"{out['dgcnn_tail']}")
    assert mean <= 1e-3 and share <= 1e-3, "dgcnn_tail disagrees with its plain version"

    # B2's net and epilogue on 40,960 packed rows
    aw = flc._kernel_weights(folded_aug, 6)
    rows = items * n
    xin = rand(rows, aw.width).to(bf)
    xin[:, aw.xe:aw.xc] = 0
    x2, eps2 = rand(rows, 6), rand(rows, lat - 6)
    z, ldj = torch.empty(rows, lat, device=device), torch.empty(rows, device=device)
    net = lambda: _build.augment_net(xin, aw.net_stack, x2, eps2, z, ldj)  # noqa: E731
    net()
    torch.cuda.synchronize()
    zr, lr = flc.augment_net_plain(xin, aw.net_stack.layer(0), x2, eps2)
    errz = float((z - zr).abs().max())
    rel = float(((ldj - lr).abs() / lr.abs().clamp_min(1.0)).max())
    out["augment_net"] = kernel_entry(
        "augment_net (B2's net and epilogue)", "flowcompare_tpu_torch/csrc/fused_layer.cu",
        "flowcompare_tpu/ops/flow_layer_pallas.py:1504", errz, device_ms(net),
        time_ms(lambda: flc.augment_net_plain(xin, aw.net_stack.layer(0), x2, eps2), reps=2),
        sum(2 * rows * wt.shape[1] * wt.shape[2] for wt, _ in aw.net_stack.pairs),
        nbytes(xin[:, :aw.net_stack.in_cols], x2, eps2, z, ldj,
               [(wt[0, :, :wt.shape[2]], bt) for wt, bt in aw.net_stack.pairs]))
    log(f"augment_net {rows} rows: max|dz| {errz} (tolerance 0.02), max relative d ldj {rel} "
        f"(tolerance 1e-4); {out['augment_net']}")
    assert errz <= 0.02 and rel <= 1e-4, "augment_net disagrees with its plain version"

    # the packed rows [x | extra | pad] of a B=20 item
    xs, extra = rand(items, n, 6), rand(items, 1, 1).expand(items, n, 1)
    dst, ref_rows = (torch.empty(rows, 8, dtype=bf, device=device) for _ in range(2))
    pack = lambda: _build.pack_rows(dst, xs, extra)  # noqa: E731
    pack()
    _build.pack_rows_plain(ref_rows, xs, extra)
    torch.cuda.synchronize()
    err = float((dst.float() - ref_rows.float()).abs().max())
    out["pack_rows"] = kernel_entry(
        "pack_rows", "flowcompare_tpu_torch/csrc/flow_rows.cu",
        "flowcompare_tpu/ops/flow_layer_pallas.py:1504", err, device_ms(pack),
        time_ms(lambda: _build.pack_rows_plain(ref_rows, xs, extra), reps=2), 0,
        nbytes(xs, extra[:, :1], dst))
    log(f"pack_rows {rows} rows: max|err| {err} (tolerance 0); {out['pack_rows']}")
    assert err == 0.0, "pack_rows disagrees with its plain version"
    return out


def phase_kernels(ft, model, device):
    """Each kernel against its plain version at the main path's shapes."""
    from flowcompare_tpu_torch.ops import edgeconv_cuda, flow_layer_cuda as flc

    cfg = model.config
    rows = 2 * EVAL_B                          # both directions of an eval item
    nc, n, k = cfg["n_samples_context"], cfg["sample_size"], cfg["n_neighbors"]
    g = torch.Generator().manual_seed(SEED + 2)

    def rand(*shape):
        return torch.randn(shape, generator=g).to(device)

    entries = {}

    # B3 at each EdgeConv width: exact on integer features, a row budget on
    # random ones (a different f32 sum order may flip a near-tied k-th row)
    err3, worst_rows, ms3, plain3, flops3, bytes3 = 0.0, 0.0, 0.0, 0.0, 0, 0
    for cq, cout in EDGE_WIDTHS:
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
        flops3 += knn_flops(rows, nc, cq)
        bytes3 += nbytes(x, u) + rows * nc * cout * 2
        log(f"B3 knn_edge_max {cq}->{cout} x{rows}x{nc} k={k}: integer-input max|err| "
            f"{err3} (tolerance 0), random-input rows differing {rows_differ} "
            f"(budget 0.01); {ms} ms vs plain {pms} ms")
    assert err3 == 0.0, f"B3 not exact on integer inputs: {err3}"
    assert worst_rows <= 0.01, f"B3 rows differing {worst_rows} > 0.01"
    # and at the main path's shapes: a B=20 item's 40 clouds (dulcet) and a
    # B=25 item's 50 (helpful-sponge), held to the same row budget
    main3 = {}
    for clouds in (2 * TIME_B, 2 * GS_B):
        ms, pms, worst, flops, moved = 0.0, 0.0, 0.0, 0, 0
        for cq, cout in EDGE_WIDTHS:
            x, u = rand(clouds, nc, cq).bfloat16(), rand(clouds, nc, cout).bfloat16()
            worst = max(worst, float((edgeconv_cuda.edge_neighbor_max(x, u, k)
                                      != edgeconv_cuda.edge_neighbor_max_plain(x, u, k))
                                     .any(-1).float().mean()))
            ms += time_ms(lambda: edgeconv_cuda.edge_neighbor_max(x, u, k))
            pms += time_ms(lambda: edgeconv_cuda.edge_neighbor_max_plain(x, u, k), reps=2)
            flops += knn_flops(clouds, nc, cq)
            moved += nbytes(x, u) + clouds * nc * cout * 2
        assert worst <= 0.01, f"B3 rows differing {worst} > 0.01 at {clouds} clouds"
        main3[clouds] = kernel_entry(
            "edge_neighbor_max (knn_edge_max)", "flowcompare_tpu_torch/csrc/knn_edge_max.cu",
            "flowcompare_tpu/ops/edgeconv_pallas.py:493", err3, ms, pms, flops, moved)
        log(f"B3 knn_edge_max at {clouds}x{nc}, four widths, k={k}: random-input rows "
            f"differing {worst} (budget 0.01); {ms} ms vs plain {pms} ms, bound "
            f"{main3[clouds]['bound_ms']} ms")
    entries["B3"] = {**main3[2 * TIME_B], "shapes": f"{2 * TIME_B} clouds x {nc}, four widths",
                     f"at_{2 * GS_B}_clouds": check_entry(main3[2 * GS_B],
                                                          f"{2 * GS_B} clouds x {nc}")}
    entries["B3"][f"at_{rows}_clouds"] = check_entry(
        kernel_entry("", "", "", err3, ms3, plain3, flops3, bytes3), f"{rows} clouds x {nc}")

    # B4 on a full encoder at 2 clouds (a make_sample context is 1) and at
    # the main path's 40 (a B=20 item, both directions), B2 at 8 x 1024 rows
    # and the main path's 40,960, and the kernels of their chains
    entries.update(phase_b4_b2_kernels(model, device, g))
    ctx, extra = rand(rows, nc, cfg["input_embedding_dim"]).bfloat16(), rand(rows, n, 1)

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
        "flowcompare_tpu/ops/flow_layer_pallas.py:924", errz, ms, pms,
        sum(stack_flops(folded, rows * n, rows, nc)), nbytes(xf, ldj, ctx, extra, folded, z, l))
    entries["B6"] = phase_b6(device, rows, nc, k, g)
    entries["B5"] = phase_b5(folded, xf, ldj, ctx, extra, rows, n, nc, g, device)
    entries["B7"] = phase_b7(small, g, device)
    del small
    return entries


# The products of one flow layer as the chains launch them: (label, K, N,
# layout, epilogue flags, output dtype). "nn" is a @ w (w stored (K, N)), "nt"
# a @ w^T (w stored (N, K)), "tn" a^T @ b (a stored (M, K) over the rows).
def _gemm_layer_shapes(extra_dim: int, cond: int, attention: bool) -> dict:
    from flowcompare_tpu_torch.ops.flow_layer_cuda import packed_input_layout

    xe, xc, _ = packed_input_layout(150, extra_dim, cond)
    k_in = xc + cond            # the packed rows [x1 | extra | pad | cond]
    f32, bf = torch.float32, torch.bfloat16
    forward = [("coupling in", k_in, 512, "nn", ("bias", "gelu"), bf),
               ("coupling hidden", 512, 512, "nn", ("bias", "gelu"), bf),
               ("coupling hidden + residual", 512, 512, "nn", ("bias", "residual", "gelu"), bf),
               ("coupling out [s | t]", 512, 300, "nn", ("bias",), f32),
               ("LinearLU", 300, 300, "nn", ("bias",), f32)]
    if attention:
        forward += [("pre-MLP in", 150, 256, "nn", ("bias", "gelu"), bf),
                    ("pre-MLP hidden + residual", 256, 256, "nn", ("bias", "residual", "gelu"), bf),
                    ("pre-MLP out", 256, 256, "nn", ("bias",), f32),
                    ("q", 256, 64, "nn", ("bias",), bf)]
    backward = [("dy = g lu_w", 300, 300, "nn", (), f32),
                ("dh = d[s | t] W^T", 300, 512, "nt", ("gelu_grad", "out2"), f32),
                ("dh = g W^T + residual", 512, 512, "nt", ("residual", "gelu_grad", "out2"), f32),
                ("dx1 += dh W_in^T", 512, 150, "nt", ("accumulate",), f32)]
    weights = [("dW coupling hidden", 512, 512, "tn", (), f32),
               ("dW coupling out", 512, 300, "tn", (), f32),
               ("dW LinearLU", 300, 300, "tn", (), f32),
               ("dW coupling in (x1, extra)", xe, 512, "tn", (), f32),
               ("dW coupling in (cond)", cond, 512, "tn", (), f32)]
    if attention:
        weights += [("dW pre-MLP hidden", 256, 256, "tn", (), f32)]
    return {"forward": forward, "backward": backward, "weights": weights}


def _aligned(rows: int, cols: int, dtype, g) -> torch.Tensor:
    """A random (rows, cols) matrix (g a CUDA generator) whose rows start
    16-byte aligned, as the chains lay out theirs."""
    view = torch.empty(rows, -(-cols // 8) * 8, dtype=dtype, device="cuda")[:, :cols]
    view.copy_(torch.randn(rows, cols, generator=g, device="cuda"))
    return view


def gemm_case(label, m, k, n, layout, flags, out_dtype, g) -> dict:
    """One main-path product on both routes and as plain PyTorch: errors
    against the plain version, ms of the wgmma and the WMMA route in turns
    (WMMA, wgmma, wgmma, WMMA), of the plain version and of torch.matmul on
    the same bf16 operands, and the bound."""
    from flowcompare_tpu_torch.ops import _build

    bf = torch.bfloat16
    flops = 2 * m * k * n
    if layout == "tn":
        a, b = _aligned(m, k, bf, g), _aligned(m, n, bf, g)     # a^T @ b over the m rows
        ws = torch.empty(max(1, _build.gemm_tn_workspace(k, n, m)), device="cuda")
        moved = nbytes(a, b) + k * n * 4

        def fresh():
            return torch.empty(k, n, device="cuda"), {}

        def launch(route, out, extra):
            _build.gemm_tn(a, b, out, ws, route=route)

        def plain(out, extra):
            _build.gemm_tn_plain(a, b, out)

        def library():
            return torch.matmul(a.T, b)
    else:
        a = _aligned(m, k, bf, g)
        w = _aligned(*((n, k) if layout == "nt" else (k, n)), bf, g).div_(k ** 0.5)
        kw = {"trans_b": layout == "nt", "accumulate": "accumulate" in flags,
              "gelu": "gelu" in flags}
        if "bias" in flags:
            kw["bias"] = 0.1 * torch.randn(n, generator=g, device="cuda")
        if "residual" in flags:
            kw["residual"] = _aligned(m, n, out_dtype, g)
        if "gelu_grad" in flags:
            kw["gelu_grad"] = _aligned(m, n, torch.float32, g)
        start = _aligned(m, n, out_dtype, g)
        moved = nbytes(a, w, *kw.values(), start)
        moved += nbytes(start) if "accumulate" in flags else 0     # read, then written
        moved += m * n * 2 if "out2" in flags else 0

        def fresh():
            extra = {"out2": torch.empty(m, n, dtype=bf, device="cuda")} if "out2" in flags else {}
            return start.clone(), extra

        def launch(route, out, extra):
            _build.gemm(a, w, out, route=route, **kw, **extra)

        def plain(out, extra):
            _build.gemm_plain(a, w, out, **kw, **extra)

        def library():
            return torch.matmul(a, w.T if layout == "nt" else w)
    ref, ref_extra = fresh()
    plain(ref, ref_extra)
    errs, within = {}, {}
    for route in ("wgmma", "wmma"):
        got, got_extra = fresh()
        launch(route, got, got_extra)
        torch.cuda.synchronize()
        rel, ok = 0.0, True
        for x, r in [(got, ref)] + [(got_extra[key], ref_extra[key]) for key in got_extra]:
            d, scale = (x.float() - r.float()).abs(), float(r.float().abs().max().clamp_min(1e-30))
            rel = max(rel, float(d.max()) / scale)
            if x.dtype == bf:   # one bf16 rounding (2^-7 of the value), plus f32 sum order
                ok &= float((d - 2.0 ** -7 * r.float().abs()).max()) <= 1e-5 * scale
            else:               # f32 sums in another order
                ok &= float(d.max()) <= 1e-4 * scale
        errs[route], within[route] = rel, ok
        if route == "wgmma":
            abs_err = float((got.float() - ref.float()).abs().max())
    out, extra = fresh()
    ms = [time_ms(lambda r=route: launch(r, out, extra), reps=20)
          for route in ("wmma", "wgmma", "wgmma", "wmma")]
    res = {"label": label, "layout": layout, "m": m, "k": k, "n": n, "flags": list(flags),
           "out": str(out_dtype).replace("torch.", ""),
           "max_abs_err": abs_err, "rel_err": errs["wgmma"], "wmma_rel_err": errs["wmma"],
           "within_tolerance": within["wgmma"] and within["wmma"],
           "ms": (ms[1] + ms[2]) / 2, "wmma_ms": (ms[0] + ms[3]) / 2,
           "turns_ms": {"wmma": [ms[0], ms[3]], "wgmma": [ms[1], ms[2]]},
           "plain_ms": time_ms(lambda: plain(out, extra), reps=2),
           "library_ms": time_ms(library, reps=10)}
    res["bound_ms"], res["bound_by"] = bound(flops, moved)
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["speedup_vs_wmma"] = res["wmma_ms"] / res["ms"]
    return res


def phase_gemm() -> tuple:
    """gemm_bf16 and gemm_tn at the main path's shapes: each product of one
    flow layer as the chains launch it (epilogue flags and output dtype
    included) at dulcet-universe's eval rows (B=20: 40,960; kv over the
    50,000 context rows), helpful-sponge's (B=25: 51,200) and one sample's
    4,000, B5's input gradients (A @ W^T) and LinearLU product at the
    training rows (20,480 and 25,600) and its weight gradients (A^T @ B over
    those rows). Each against the plain version on both routes, with the
    ms of both routes, of the plain version and of torch.matmul."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 50)
    cases = []
    # (preset, extra context, cond width, attention, eval rows, training rows)
    presets = (("dulcet-universe", 1, 64, True, 2 * TIME_B * 1024, TIME_B * 1024),
               ("helpful-sponge", 0, 124, False, 2 * GS_B * 1024, GS_B * 1024))
    for preset, extra_dim, cond, attention, eval_rows, train_rows in presets:
        shapes = _gemm_layer_shapes(extra_dim, cond, attention)
        runs = [(eval_rows, sh) for sh in shapes["forward"]]
        if attention:
            runs.append((2 * TIME_B * 1250, ("kv", 64, 128, "nn", (), torch.bfloat16)))
        runs += [(train_rows, sh) for sh in shapes["backward"] + shapes["weights"]]
        if attention:
            runs += [(SAMPLE_N, sh) for sh in shapes["forward"]]
        for rows, (label, k, n, layout, flags, out_dtype) in runs:
            case = gemm_case(label, rows, k, n, layout, flags, out_dtype, g)
            case["preset"] = preset
            cases.append(case)
            log(f"GEMM {preset} {label} {layout} M={rows} K={k} N={n} {'+'.join(flags) or '-'} -> "
                f"{case['out']}: rel err {case['rel_err']} (WMMA route {case['wmma_rel_err']}; "
                f"tolerance one bf16 rounding for bf16, 1e-4 for f32: "
                f"{'within' if case['within_tolerance'] else 'BEYOND'}); {case['ms']} ms, WMMA "
                f"route {case['wmma_ms']} ms ({case['speedup_vs_wmma']:.2f}x), plain "
                f"{case['plain_ms']} ms, torch.matmul {case['library_ms']} ms, bound "
                f"{case['bound_ms']} ms ({case['bound_by']}), {100 * case['bound_share']:.1f}% "
                f"of it")
    assert all(c["within_tolerance"] for c in cases), "a GEMM disagrees with its plain version"
    host = gemm_host_cost(g)
    log(f"GEMM host cost per call at 64 x 64 x 64 (launch-bound; us): {host}")

    def entry(case, name, source, replaces, serves):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "wmma_ms",
                "speedup_vs_wmma", "bound_share")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": 0, **{k: case[k] for k in keys},
                "shape": f"{case['label']} M={case['m']} K={case['k']} N={case['n']} "
                         f"({case['layout']}, {'+'.join(case['flags']) or 'no epilogue'})",
                "serves": serves, "shapes_checked": len(cases)}

    head = next(c for c in cases if c["label"] == "coupling hidden" and c["m"] == 2 * TIME_B * 1024)
    tn = next(c for c in cases if c["label"] == "dW coupling hidden" and c["m"] == TIME_B * 1024)
    entries = {
        "gemm_bf16": entry(head, "gemm_bf16 (gemm_bf16_wgmma_kernel)",
                           "flowcompare_tpu_torch/csrc/gemm_wgmma.cu",
                           "flowcompare_tpu/ops/flow_layer_pallas.py:924",
                           "every product of B1, B2, B7 and B5's A @ W^T; B4's aligned ones"),
        "gemm_tn": entry(tn, "gemm_tn (gemm_tn_wgmma_kernel)",
                         "flowcompare_tpu_torch/csrc/gemm_tn_wgmma.cu",
                         "flowcompare_tpu/ops/flow_layer_vjp_pallas.py:476",
                         "B5's weight gradients"),
    }
    entries["gemm_bf16"]["host_us_per_call"] = host
    return entries, cases


def gemm_host_cost(g, calls: int = 3000) -> dict:
    """Host time per gemm call on each route at a product too small to keep
    the card busy (64 x 64 x 64 with bias and GELU), through the Python
    wrapper and through the C entry point alone, in turns (WMMA, wgmma,
    wgmma, WMMA): what a launch-bound chain (a sample's 1 x 4000) pays per
    product; and the current-stream lookup every launch makes."""
    from flowcompare_tpu_torch.ops import _build

    bf = torch.bfloat16
    a, w = _aligned(64, 64, bf, g), _aligned(64, 64, bf, g)
    out, bias = torch.empty(64, 64, dtype=bf, device="cuda"), torch.randn(64, device="cuda")
    lib, stream = _build.library(), _build._stream()
    base = (a.data_ptr(), 64, w.data_ptr(), 64, out.data_ptr(), 64, 64, 64, 64, bias.data_ptr(),
            None, 0, None, None, None, 0, None, 0, 0, _build.EPI_BIAS | _build.EPI_GELU, 0)
    direct = {"wgmma": lambda: lib.fc_gemm_bf16(*base, *_build.gemm_tile(64, 64), stream),
              "wmma": lambda: lib.fc_gemm_bf16_wmma(*base, stream)}

    def per_call_us(fn):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / calls

    res = {"stream_lookup": [per_call_us(_build._stream)]}
    for route in ("wmma", "wgmma", "wgmma", "wmma"):
        res.setdefault(f"wrapper_{route}", []).append(per_call_us(
            lambda r=route: _build.gemm(a, w, out, bias=bias, gelu=True, route=r)))
        res.setdefault(f"c_entry_{route}", []).append(per_call_us(direct[route]))
    return {k: sum(v) / len(v) for k, v in res.items()}


class ChainRoutes:
    """Counts, by route, the GEMM and cross attention launches made inside
    the B1, B2, B5 and B7 chains: their entry points are wrapped for the
    whole run, so a phase reads how many of their products and attention
    launches took the WMMA route (none should)."""

    ENTRY_POINTS = (("flow_layer_cuda", "fused_flow_layers"), ("flow_layer_cuda", "fused_augmenter"),
                    ("flow_layer_cuda", "fused_flow_layers_inverse"),
                    ("flow_layer_vjp_cuda", "flow_layers_bwd"), ("dgcnn_cuda", "fused_dgcnn_encoder"))
    # B4 and B2: each call's launches by counter (`check_b4_b2`); B4's are
    # kept out of the chains' counts
    PER_CALL = ("fused_dgcnn_encoder", "fused_augmenter")

    # B1 and B7 (the layer stack's two directions) are also counted apart
    # ("flow ..." keys): their gemms, fused launches and cross attention, so
    # a phase can show that no per-product MLP gemm ran inside them; and B5
    # ("b5 ..." keys), so a phase can count its launches a layer
    FLOW = ("fused_flow_layers", "fused_flow_layers_inverse")
    KEYS = ("wgmma", "wmma", "attention wgmma", "attention wmma", "conditioner",
            "coupling_layer", "coupling_inverse", "conditioner_record", "coupling_record",
            "coupling_bwd", "conditioner_bwd", "gemm_tn_grouped", "grad_reduce", "attn_bwd_prep",
            "colsum", "gemm", "gemm_tn", "attention", "knn", "pack_rows", "dgcnn_tail",
            "augment_net")

    def __init__(self):
        from flowcompare_tpu_torch.ops import (_build, dgcnn_cuda, edgeconv_cuda, flow_layer_cuda,
                                               flow_layer_vjp_cuda)
        self._build, self._edgeconv = _build, edgeconv_cuda
        modules = {"flow_layer_cuda": flow_layer_cuda, "flow_layer_vjp_cuda": flow_layer_vjp_cuda,
                   "dgcnn_cuda": dgcnn_cuda}
        self.reset()
        for module_name, attr in self.ENTRY_POINTS:
            module = modules[module_name]
            setattr(module, attr, self._counted(getattr(module, attr), attr))

    def _now(self) -> dict:
        b = self._build
        return {"wgmma": b.GEMM_WGMMA_LAUNCHES + b.GEMM_TN_WGMMA_LAUNCHES,
                "wmma": b.GEMM_WMMA_LAUNCHES + b.GEMM_TN_WMMA_LAUNCHES,
                "attention wgmma": b.CROSS_ATTENTION_WGMMA_LAUNCHES + b.ATTENTION_BWD_WGMMA_LAUNCHES,
                "attention wmma": b.CROSS_ATTENTION_WMMA_LAUNCHES + b.ATTENTION_BWD_WMMA_LAUNCHES,
                "conditioner": b.FUSED_CONDITIONER_LAUNCHES,
                "coupling_layer": b.COUPLING_LAYER_LAUNCHES,
                "coupling_inverse": b.COUPLING_INVERSE_LAUNCHES,
                "conditioner_record": b.CONDITIONER_RECORD_LAUNCHES,
                "coupling_record": b.COUPLING_RECORD_LAUNCHES,
                "coupling_bwd": b.COUPLING_BWD_LAUNCHES,
                "conditioner_bwd": b.CONDITIONER_BWD_LAUNCHES,
                "gemm_tn_grouped": b.GEMM_TN_GROUPED_LAUNCHES,
                "grad_reduce": b.GRAD_REDUCE_LAUNCHES, "attn_bwd_prep": b.ATTN_BWD_PREP_LAUNCHES,
                "colsum": b.COLSUM_LAUNCHES, "gemm": b.GEMM_WGMMA_LAUNCHES + b.GEMM_WMMA_LAUNCHES,
                "gemm_tn": b.GEMM_TN_WGMMA_LAUNCHES + b.GEMM_TN_WMMA_LAUNCHES,
                "attention": (b.CROSS_ATTENTION_WGMMA_LAUNCHES + b.CROSS_ATTENTION_WMMA_LAUNCHES
                              + b.ATTENTION_BWD_WGMMA_LAUNCHES + b.ATTENTION_BWD_WMMA_LAUNCHES),
                "knn": self._edgeconv.EDGE_NEIGHBOR_MAX_LAUNCHES, "pack_rows": b.PACK_ROWS_LAUNCHES,
                "dgcnn_tail": b.DGCNN_TAIL_LAUNCHES, "augment_net": b.AUGMENT_NET_LAUNCHES}

    def _counted(self, fn, attr: str):
        def counted(*args, **kwargs):
            before = self._now()
            try:
                return fn(*args, **kwargs)
            finally:
                after = self._now()
                if attr in self.PER_CALL:
                    self.calls[attr].append({k: after[k] - before[k] for k in after})
                for key, value in ({} if attr == "fused_dgcnn_encoder" else after).items():
                    self.counts[key] += value - before[key]
                    if attr in self.FLOW:
                        self.counts[f"flow {key}"] += value - before[key]
                    if attr == "flow_layers_bwd":
                        self.counts[f"b5 {key}"] += value - before[key]
                self.counts["flow B7 calls"] += int(attr == "fused_flow_layers_inverse")
        return counted

    def reset(self) -> None:
        self.counts = {**{k: 0 for k in self.KEYS}, **{f"flow {k}": 0 for k in self.KEYS},
                       **{f"b5 {k}": 0 for k in self.KEYS}, "flow B7 calls": 0}
        self.calls = {attr: [] for attr in self.PER_CALL}

    def read(self) -> dict:
        return {**self.counts, "calls": {k: list(v) for k, v in self.calls.items()}}


CHAIN_ROUTES = None   # a ChainRoutes, installed by main() once the library is built


def check_flow_launches(chains: dict, what: str, flow_attention: bool) -> dict:
    """Inside B1 and B7 the coupling MLPs ran in the fused kernels: no
    per-product MLP gemm (their only gemms are ctx @ wkv, one a layer with
    attention, and B7's top LU inverse, one a call), and per layer one
    coupling_layer / coupling_inverse with, where the layers have attention,
    one conditioner, one ctx @ wkv and one cross attention: 4 launches a
    layer with attention, 1 without. Returns the counts."""
    f = {k[5:]: v for k, v in chains.items() if k.startswith("flow ")}
    layers = f["coupling_layer"] + f["coupling_inverse"]
    per_product = f["wgmma"] + f["wmma"] - f["conditioner"] - f["B7 calls"]
    per_layer = (f["conditioner"] + (f["wgmma"] - f["B7 calls"]) + f["attention wgmma"]
                 + layers) / max(layers, 1)
    out = {"layers": layers, "per_product_mlp_gemms": per_product, "launches_per_layer": per_layer,
           **{k: f[k] for k in ("conditioner", "coupling_layer", "coupling_inverse", "wgmma",
                                "attention wgmma", "B7 calls")}}
    log(f"fused layers in {what}: {out}")
    assert layers > 0 and per_product == 0, f"a per-product MLP gemm ran inside B1/B7: {out}"
    assert f["conditioner"] == (layers if flow_attention else 0), out
    assert f["attention wgmma"] == f["conditioner"], out
    assert per_layer == (4 if flow_attention else 1), out
    return out


# B5's launches a layer: the recompute (conditioner_record, ctx @ wkv, the
# cross attention, coupling_record), coupling_bwd, attn_bwd_prep,
# attention_bwd, dctx += dkv wkv^T, conditioner_bwd, gemm_tn_grouped and
# grad_reduce with attention; coupling_record, coupling_bwd, gemm_tn_grouped
# and grad_reduce without
B5_CHAIN_KEYS = ("conditioner_record", "coupling_record", "coupling_bwd", "conditioner_bwd",
                 "gemm_tn_grouped", "grad_reduce", "attn_bwd_prep", "colsum", "gemm", "gemm_tn",
                 "attention")


def check_b5_launches(chains: dict, what: str, attention: bool) -> dict:
    """Inside B5 every layer took the fused kernels: 11 launches a layer
    with attention, 4 without (12 and 5 at most), no
    per-product MLP gemm (with attention its only gemms are ctx @ wkv and
    dctx += dkv wkv^T, two a layer), no gemm_tn and no colsum. Returns the
    counts."""
    b = {k[3:]: v for k, v in chains.items() if k.startswith("b5 ")}
    layers = b["coupling_bwd"]
    per_layer = sum(b[k] for k in B5_CHAIN_KEYS) / max(layers, 1)
    out = {"layers": layers, "launches_per_layer": per_layer,
           **{k: b[k] for k in B5_CHAIN_KEYS}}
    log(f"B5 launches in {what}: {out}")
    assert layers > 0 and b["colsum"] == 0 and b["gemm_tn"] == 0, out
    assert b["gemm"] == 2 * layers * attention, f"a per-product MLP gemm ran inside B5: {out}"
    assert per_layer == (11 if attention else 4), out
    return out


# launches a call at most, by the port's counters: B4 the cloud's cast,
# four stage products, four B3 and the tail; B2 the packed rows, the
# conditioner, ctx @ wkv, the attention and the net with its epilogue
B4_LAUNCHES, B2_LAUNCHES = 10, 5


def check_b4_b2(chains: dict, what: str) -> dict:
    """Each B4 and B2 call of a path took its few launches (B4_LAUNCHES,
    B2_LAUNCHES): B4 four gemms (the stage products), none on the WMMA
    route, and one tail (conv5 and the head: no per-product gemm); B2 one
    gemm (ctx @ wkv: no per-product gemm in its net) and one net launch.
    Returns the calls and their launches."""
    out = {}
    b4_keys = ("wgmma", "wmma", "knn", "pack_rows", "dgcnn_tail")
    b2_keys = ("pack_rows", "conditioner", "wgmma", "wmma", "attention", "augment_net")
    for attr, keys, most in (("fused_dgcnn_encoder", b4_keys, B4_LAUNCHES),
                             ("fused_augmenter", b2_keys, B2_LAUNCHES)):
        calls = chains["calls"][attr]
        per_call = [sum(c[k] for k in keys) for c in calls]
        out[attr] = {"calls": len(calls), "launches_per_call": sorted(set(per_call))}
        assert all(n <= most for n in per_call), (attr, what, calls)
        assert all(c["wmma"] == 0 and c["attention wmma"] == 0 for c in calls), (attr, calls)
        if attr == "fused_dgcnn_encoder":
            assert all(c["wgmma"] == 4 and c["dgcnn_tail"] == 1 for c in calls), calls
        else:
            assert all(c["wgmma"] == 1 and c["augment_net"] == 1 for c in calls), calls
    log(f"B4 and B2 launches in {what}: {out} (at most {B4_LAUNCHES} and {B2_LAUNCHES} a call)")
    return out


def check_routes(launches: dict, chains: dict, what: str, attention: tuple = ()) -> None:
    """No GEMM takes the WMMA route, inside the B1, B2, B5 and B7 chains or
    outside them (B4's first EdgeConv stage reads the cloud cast into 8
    bf16 columns, which TMA can read). No cross
    attention launch takes the WMMA route anywhere, and the wgmma counters
    named in `attention` ("attention wgmma", "attention_bwd wgmma": the
    forward and the backward) are launched; a path with no attention
    (`attention` empty: helpful-sponge's global conditioner outside B2)
    launches none."""
    log(f"GEMM routes in {what}: inside the B1/B2/B5/B7 chains {chains}; all launches: gemm "
        f"wgmma {launches['gemm wgmma']}, WMMA {launches['gemm wmma']} (B4 ran "
        f"{launches['B4']} times), gemm_tn wgmma {launches['gemm_tn wgmma']}, WMMA "
        f"{launches['gemm_tn wmma']}; cross attention wgmma {launches['attention wgmma']}, WMMA "
        f"{launches['attention wmma']}, backward wgmma {launches['attention_bwd wgmma']}, WMMA "
        f"{launches['attention_bwd wmma']}")
    assert chains["wmma"] == 0 and chains["wgmma"] > 0, f"a chain took the WMMA route: {chains}"
    assert launches["gemm wmma"] == 0, launches
    assert launches["gemm_tn wmma"] == 0, launches
    assert chains["attention wmma"] == 0, f"a chain's attention took the WMMA route: {chains}"
    assert launches["attention wmma"] == launches["attention_bwd wmma"] == 0, launches
    for key in ("attention wgmma", "attention_bwd wgmma"):
        assert (launches[key] > 0) == (key in attention), (key, attention, launches)
    assert chains["attention wgmma"] == launches["attention wgmma"] + launches[
        "attention_bwd wgmma"], (chains, launches)


# B10's share of outputs more than half a bf16 ulp off its plain version
# (`error_stats`), at most. On an H100 80GB HBM3 at 700 W this phase read
# 0.0162% at (20, 1024) x 1250 keys and 0.0155% at (25, 1024) x 1024 for the
# earlier kernel (the PV product as f32 FMAs), 0.0224% and 0.0203% for the
# wgmma kernel, both at the f32 floor; p in two bf16 terms summed over all
# keys in one tensor-core accumulator put several times as many there, p
# rounded to bf16 alone (flash attention) about 40%.
B10_SHARE_LIMIT = 3e-4


def phase_b10(device) -> tuple:
    """B10, the fused attention core, at the flow's attention shapes (q
    (20, 1024, 64) against k/v (20, 1250, 64)) and helpful-sponge's augmenter
    shape ((25, 1024, 64) against 1024 keys), bf16, k and v the column
    halves of one [k | v] tensor: the wgmma kernel against its plain version
    (p at f32 precision on both sides: at most one bf16 ulp of the output
    apart), its time, the plain version's, flash
    scaled_dot_product_attention's on the same q/k/v and scale (the library
    yardstick, never the port's; it rounds p to bf16), and each one's share
    of outputs more than half a bf16 ulp off the plain version
    (`error_stats`): the kernel's must lie within B10_SHARE_LIMIT and below
    flash's. The bound: one q k^T and two bf16 P V products (p in two bf16
    terms, the least that keeps p past bf16 on the tensor cores) at the bf16
    peak, or the bytes; the bound with the PV product at the f32 rate (the
    earlier kernel's) is logged beside it. Then its entry point,
    apply_cross_attention(fused=True) against fused=False, forward and
    autograd backward, with the launch counters set to 0 just before the
    fused call and read after."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from flowcompare_tpu_torch.core import attention
    from flowcompare_tpu_torch.ops import attention_cuda as ac

    g = torch.Generator().manual_seed(SEED + 40)
    scale = 64 ** -0.5
    entries = []
    for items, nq, nkv in ((TIME_B, 1024, 1250), (GS_B, 1024, 1024)):
        q = torch.randn(items, nq, 64, generator=g).to(device).bfloat16()
        kv = torch.randn(items, nkv, 128, generator=g).to(device).bfloat16()
        k, v = kv[..., :64], kv[..., 64:]
        got = ac.fused_attention_core(q, k, v, scale)
        torch.cuda.synchronize()
        ref = ac.fused_attention_core_plain(q, k, v, scale).float()
        d = (got.float() - ref).abs()
        beyond_ulp = float((d - 2.0 ** -7 * ref.abs()).max())
        q2, k2, v2 = q.reshape(-1, 64), k.reshape(-1, 64), v.reshape(-1, 64)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            flash_out = F.scaled_dot_product_attention(q.unsqueeze(1), k.unsqueeze(1),
                                                       v.unsqueeze(1), scale=scale)
        torch.cuda.synchronize()
        stats = {"kernel": error_stats(got, ref),
                 "flash": error_stats(flash_out.reshape(ref.shape), ref)}
        ms = device_ms(lambda: ac.fused_attention_core(q, k, v, scale))
        pms = time_ms(lambda: ac.fused_attention_core_plain(q, k, v, scale), reps=2)
        flash = sdpa_flash(q2, k2, v2, items, scale)
        lms = flash["ms"]
        kc, vc = k.contiguous(), v.contiguous()
        lms_contiguous = time_ms(lambda: F.scaled_dot_product_attention(q, kc, vc, scale=scale))
        products = 2 * items * nq * nkv * 64
        entry = kernel_entry("fused_attention_core (attention_core)",
                             "flowcompare_tpu_torch/csrc/attention_core.cu",
                             "flowcompare_tpu/ops/attention_pallas.py:69", float(d.max()), ms, pms,
                             3 * products, nbytes(q, k, v, got), library_ms=lms)
        f32_pv_bound = bound([(products, PEAK_BF16_FLOPS), (products, PEAK_F32_FLOPS)],
                             nbytes(q, k, v, got))[0]
        entry.update(library=flash, library_3d_default_ms=lms_contiguous,
                     f32_pv_bound_ms=f32_pv_bound, share_limit=B10_SHARE_LIMIT,
                     share_over_half_ulp={key: st["share_over_half_ulp"]
                                          for key, st in stats.items()},
                     error_stats=stats)
        log(f"B10 fused_attention_core q {tuple(q.shape)} k/v {tuple(k.shape)} bf16: max|err| "
            f"{entry['max_abs_err']}, beyond one bf16 ulp {beyond_ulp} (tolerance 1e-5); shares "
            f"of outputs more than half a bf16 ulp off plain: {entry['share_over_half_ulp']} "
            f"(the kernel's within {B10_SHARE_LIMIT} and below flash's); device {ms} ms, plain "
            f"{pms} ms, scaled_dot_product_attention (flash, 4-D) {flash}, 3-D on contiguous k "
            f"and v with the default backend {lms_contiguous} ms; bound {entry['bound_ms']} ms "
            f"({entry['bound_by']}: q k^T and two bf16 P V at the bf16 peak; with P V at the "
            f"f32 rate {f32_pv_bound} ms)")
        assert beyond_ulp <= 1e-5, "B10 disagrees with its plain version"
        assert stats["kernel"]["share_over_half_ulp"] <= B10_SHARE_LIMIT, \
            "B10 puts more outputs over half a bf16 ulp off plain than B10_SHARE_LIMIT"
        assert stats["kernel"]["share_over_half_ulp"] < stats["flash"]["share_over_half_ulp"], \
            "B10 rounds p no better than flash attention"
        entries.append(entry)
        del q, kv, k, v, kc, vc, got, ref, d, flash_out

    # the entry point at the flow's attention shape
    p = attention.init_cross_attention(g, out_dim=512, query_dim=256, context_dim=64)
    p = {key: {k2: v2.to(device).requires_grad_() for k2, v2 in sub.items()}
         for key, sub in p.items()}
    x = torch.randn(TIME_B, 1024, 256, generator=g).to(device).requires_grad_()
    ctx = torch.randn(TIME_B, 1250, 64, generator=g).to(device).bfloat16()
    cot = torch.randn(TIME_B, 1024, 512, generator=g).to(device)
    wrt = [x, p["to_q"]["w"], p["to_kv"]["w"], p["out"]["w"]]
    results = []
    for fused in (True, False):
        torch.cuda.synchronize()
        reset_counters()
        out = attention.apply_cross_attention(p, x, ctx, dtype=torch.bfloat16, fused=fused)
        grads = torch.autograd.grad(out, wrt, cot)
        torch.cuda.synchronize()
        results.append((out.detach().float(), grads, read_counters()))
    (of, gf, cf), (ou, gu, cu) = results
    rel = float((of - ou).abs().max() / ou.abs().max())
    cos = [float(torch.nn.functional.cosine_similarity(a.reshape(-1).float(),
                                                       b.reshape(-1).float(), dim=0))
           for a, b in zip(gf, gu)]
    log(f"B10 entry point apply_cross_attention(fused=True) x {tuple(x.shape)} ctx "
        f"{tuple(ctx.shape)}: launches {cf['B10']} (fused=False: {cu['B10']}); forward max|d| "
        f"over max|ref| against fused=False {rel} (tolerance 0.02: fused=False rounds p to "
        f"bf16), gradient cosines x, to_q, to_kv, out {cos} (tolerance >= 0.999)")
    assert cf["B10"] == 1 and cu["B10"] == 0, (cf, cu)
    assert rel <= 0.02 and min(cos) >= 0.999, "apply_cross_attention(fused=True) disagrees"
    entries[0]["launches"] = cf["B10"]
    entries[0]["global"] = check_entry(entries[1], "q (25, 1024, 64), k/v (25, 1024, 64): "
                                                   "helpful-sponge's augmenter")
    for key in ("library_ms", "library", "library_3d_default_ms", "share_over_half_ulp"):
        entries[0]["global"][key] = entries[1][key]
    return entries[0], {"entry_point": {"launches": cf["B10"], "forward_rel_err": rel,
                                        "gradient_cosines": cos}}


def kernel_trace(fn, trace: str) -> tuple:
    """The device kernels torch.profiler records over fn() (chrome trace
    events of category "kernel", the trace kept in build/), and the host ms
    fn() took under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    path = REPO / "build" / trace
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "kernel" and "dur" in e], traced_ms


def traced_kernels(fn, reps: int = 10, name: str = "") -> list:
    """The device kernels torch.profiler records over reps calls of fn
    (after a warm-up call) whose names match `name`. The profiler now and
    then returns a trace without them, at times twice in a row: it traces
    again, up to four times."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            fn()

    for attempt in range(4):
        if attempt:
            log(f"  the profiler recorded no device kernels {name}; tracing again "
                f"({attempt + 1} of 4)")
            torch.cuda.synchronize()
        kernels, _ = kernel_trace(calls, "chip_smoke_device_ms_trace.json")
        kernels = [e for e in kernels if re.search(name, e["name"])]
        if kernels:
            return kernels
    raise AssertionError(f"the profiler recorded no device kernels {name}")


def device_ms(fn, reps: int = 10) -> float:
    """Device time per call of fn: the durations of the kernels it launches
    over reps calls (torch.profiler, after a warm-up call), summed, over reps.
    Unlike time_ms it leaves out the gaps where the device waits for the
    host, which decide a short call's wall time."""
    return sum(e["dur"] for e in traced_kernels(fn, reps)) / 1e3 / reps


def sdpa_flash(q, k, v, items: int, scale: float, backward: bool = False) -> dict:
    """scaled_dot_product_attention with the flash backend forced, on 4-D
    views (items, 1, n, 64) of (items*n, 64) q, k and v (the library
    yardstick, never the port's): the device ms of the forward, or with
    `backward` of torch.autograd.grad alone over a retained graph, and the
    call's ms with the host included (CUDA events). k and v are first given
    as the strided column halves of [k | v]; where flash refuses them, as
    contiguous copies, and the result says which."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def four_d(t):
        return t.unflatten(0, (items, t.shape[0] // items)).unsqueeze(1)

    for layout in ("strided", "contiguous copies"):
        kk, vv = (k, v) if layout == "strided" else (k.contiguous(), v.contiguous())
        q4, k4, v4 = four_d(q), four_d(kk), four_d(vv)
        try:
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                if not backward:
                    def call():
                        F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
                else:
                    leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
                    out = F.scaled_dot_product_attention(*leaves, scale=scale)
                    cot = torch.randn_like(out)

                    def call():
                        torch.autograd.grad(out, leaves, cot, retain_graph=True)
                return {"ms": device_ms(call), "call_ms": time_ms(call, reps=20),
                        "backend": "FLASH_ATTENTION", "kv": layout}
        except RuntimeError as err:
            refusal = str(err).splitlines()[0][:200]
            log(f"  flash SDPA refused {layout} k/v: {refusal}")
    return {"ms": None, "call_ms": None, "backend": "FLASH_ATTENTION refused both layouts",
            "kv": None}


# (label, items, queries, keys, m and den written, next items large)
ATTENTION_CASES = (
    ("dulcet-universe eval launch and training shape (B=20), with m and den", TIME_B, 1024, 1250,
     True, False),
    ("helpful-sponge's augmenter (B=25)", GS_B, 1024, 1024, False, False),
    ("a sample (1 x 4000 against 1250 keys)", 1, SAMPLE_N, 1250, False, False),
    ("cross-item: items after the first hold large queries and keys", 3, 70, 90, True, True),
    ("cross-item at the presets' 1250 keys", 3, 70, 1250, True, True),
)


def phase_attention() -> tuple:
    """The cross attention of the B1, B2, B5 and B7 chains (csrc/
    cross_attention.cu, csrc/cross_attention_bwd.cu): the TMA + wgmma
    forward and backward against their plain versions at the main path's
    shapes and at two cross-item cases (a tile read across an item boundary
    would show there), on the route the wrapper picks: the
    forward within one bf16 rounding (rtol = atol = 1e-2), m and den within
    1e-4 relative; dq, dk and dv with cosine >= 0.9999 and max error <= 1e-2
    of max |ref| (from the plain forward's m and den). At the three main
    shapes, the device ms (`device_ms`) of the wgmma route, of the WMMA
    route, of the plain version and of
    scaled_dot_product_attention with the flash backend (forward, and the
    backward alone), a call's ms through the wrapper with the host included,
    and the bound: the necessary products (2 forward, 5 backward) at the
    bf16 peak, or the bytes."""
    from flowcompare_tpu_torch.ops import _build

    g = torch.Generator().manual_seed(SEED + 60)
    cases = []
    for label, items, nq, nkv, with_m, big_next in ATTENTION_CASES:
        q = torch.randn(items * nq, 64, generator=g) / 8
        kv = torch.randn(items * nkv, 128, generator=g)
        if big_next:
            q[nq:] = q[nq:] * 4 + 3
            kv[nkv:] = kv[nkv:] * 4 + 6
        q, kv = q.bfloat16().cuda(), kv.bfloat16().cuda()
        k, v = kv[:, :64], kv[:, 64:]
        rows_q, rows_k = items * nq, items * nkv

        def forward(fn, m_den=True, **kw):
            out = torch.full((rows_q, 64), float("nan"), device="cuda", dtype=torch.bfloat16)
            m = torch.full((rows_q,), float("nan"), device="cuda") if m_den else None
            den = torch.full((rows_q,), float("nan"), device="cuda") if m_den else None
            fn(q, k, v, out, n_items=items, m_out=m, den_out=den, **kw)
            return out, m, den

        ref_out, ref_m, ref_den = forward(_build.cross_attention_plain)
        got_out, got_m, got_den = forward(_build.cross_attention, m_den=with_m)
        if not with_m:
            _, got_m, got_den = forward(_build.cross_attention)
        torch.cuda.synchronize()
        d = (got_out.float() - ref_out.float()).abs()
        fwd_beyond = float((d - (1e-2 + 1e-2 * ref_out.float().abs())).max())
        m_rel = float(((got_m - ref_m).abs() / ref_m.abs().clamp_min(1.0)).max())
        den_rel = float(((got_den - ref_den).abs() / ref_den).max())
        da = torch.randn(rows_q, 64, generator=g).cuda()
        du = torch.empty(rows_q, 64, device="cuda", dtype=torch.bfloat16)
        ddn = torch.empty(rows_q, device="cuda")
        _build.attn_bwd_prep(da, ref_out, ref_den, du, ddn)

        def backward(fn, **kw):
            bufs = (torch.full((rows_q, 64), float("nan"), device="cuda"),
                    torch.full((rows_q, 64), float("nan"), device="cuda", dtype=torch.bfloat16),
                    torch.full((rows_k, 128), float("nan"), device="cuda"),
                    torch.full((rows_k, 128), float("nan"), device="cuda", dtype=torch.bfloat16))
            fn(q, k, v, du, ddn, ref_m, *bufs, n_items=items, **kw)
            return bufs

        rb, gb = backward(_build.attention_bwd_plain), backward(_build.attention_bwd)
        torch.cuda.synchronize()
        grads = {}
        for name, a, b in (("dq", gb[0], rb[0]), ("dk", gb[2][:, :64], rb[2][:, :64]),
                           ("dv", gb[2][:, 64:], rb[2][:, 64:])):
            grads[name] = {"cosine": float(torch.nn.functional.cosine_similarity(
                a.reshape(-1).double(), b.reshape(-1).double(), dim=0)), "rel_err": rel_err(a, b)}
        copies = bool(torch.equal(gb[1], gb[0].bfloat16()) and torch.equal(gb[3], gb[2].bfloat16()))
        case = {"label": label, "items": items, "nq": nq, "nkv": nkv,
                "max_abs_err": float(d.max()), "beyond_tolerance": fwd_beyond, "m_rel": m_rel,
                "den_rel": den_rel, "grads": grads, "bf16_copies_exact": copies,
                "within_tolerance": (fwd_beyond <= 0 and m_rel <= 1e-4 and den_rel <= 1e-4
                                     and copies and all(x["cosine"] >= 0.9999
                                                        and x["rel_err"] <= 1e-2
                                                        for x in grads.values())),
                "bwd_max_abs_err": float((gb[0] - rb[0]).abs().max())}
        if not big_next:
            out = torch.empty(rows_q, 64, device="cuda", dtype=torch.bfloat16)
            m_buf, den_buf = (torch.empty(rows_q, device="cuda") for _ in range(2))
            m_kw = {"m_out": m_buf, "den_out": den_buf} if with_m else {}

            def fwd(route):
                _build.cross_attention(q, k, v, out, n_items=items, route=route, **m_kw)

            def bwd(route):
                _build.attention_bwd(q, k, v, du, ddn, ref_m, *gb, n_items=items, route=route)

            case.update({
                "ms": device_ms(lambda: fwd("wgmma")), "wmma_ms": device_ms(lambda: fwd("wmma")),
                "call_ms": time_ms(lambda: fwd("wgmma"), reps=20),
                "plain_ms": device_ms(lambda: forward(_build.cross_attention_plain), reps=3),
                "library": sdpa_flash(q, k, v, items, 1.0),
                "bwd_ms": device_ms(lambda: bwd("wgmma")),
                "bwd_wmma_ms": device_ms(lambda: bwd("wmma")),
                "bwd_call_ms": time_ms(lambda: bwd("wgmma"), reps=10),
                "bwd_plain_ms": device_ms(lambda: backward(_build.attention_bwd_plain), reps=3),
                "bwd_library": sdpa_flash(q, k, v, items, 1.0, backward=True)})
            products = 2 * items * nq * nkv * 64
            case["bound_ms"], case["bound_by"] = bound(
                2 * products, nbytes(q, k, v, out) + (8 * rows_q if with_m else 0))
            case["bwd_bound_ms"], case["bwd_bound_by"] = bound(
                5 * products, nbytes(q, k, v, du, ddn, ref_m, *gb))
        cases.append(case)
        log(f"attention {label}: {items} x {nq} queries x {nkv} keys: forward max|err| "
            f"{case['max_abs_err']} (beyond rtol = atol = 1e-2: {fwd_beyond}), m rel {m_rel}, den "
            f"rel {den_rel} (tolerance 1e-4); backward {grads} (tolerance cosine >= 0.9999, "
            f"max err <= 1e-2 of max |ref|), bf16 copies exact {copies}; "
            + ("" if big_next else
               f"device ms: forward {case['ms']} (a call through the wrapper "
               f"{case['call_ms']}), WMMA route {case['wmma_ms']}, plain "
               f"{case['plain_ms']}, flash SDPA {case['library']}, bound {case['bound_ms']} "
               f"({case['bound_by']}); backward {case['bwd_ms']} (a call "
               f"{case['bwd_call_ms']}), WMMA route "
               f"{case['bwd_wmma_ms']}, plain {case['bwd_plain_ms']}, flash SDPA backward "
               f"{case['bwd_library']}, bound {case['bwd_bound_ms']} ({case['bwd_bound_by']})"))
        del q, kv, k, v, ref_out, got_out, rb, gb, da, du, ddn
    assert all(c["within_tolerance"] for c in cases), "the cross attention disagrees with plain"
    head = cases[0]

    def entry(name, source, replaces, prefix, err, serves):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": 0, "max_abs_err": err, "ms": head[f"{prefix}ms"],
                "plain_ms": head[f"{prefix}plain_ms"], "bound_ms": head[f"{prefix}bound_ms"],
                "bound_by": head[f"{prefix}bound_by"],
                "library_ms": head[f"{prefix}library"]["ms"],
                "library": head[f"{prefix}library"], "wmma_ms": head[f"{prefix}wmma_ms"],
                "call_ms": head[f"{prefix}call_ms"],
                "speedup_vs_wmma": head[f"{prefix}wmma_ms"] / head[f"{prefix}ms"],
                "shape": f"{head['items']} x {head['nq']} queries x {head['nkv']} keys, d = 64",
                "serves": serves,
                "shapes_checked": [f"{c['items']}x{c['nq']}x{c['nkv']}" for c in cases]}

    entries = {
        "cross_attention": entry("cross_attention (cross_attention_wgmma_kernel)",
                                 "flowcompare_tpu_torch/csrc/cross_attention.cu",
                                 "flowcompare_tpu/ops/flow_layer_pallas.py:800", "",
                                 head["max_abs_err"],
                                 "the attention of B1, B2, B7 and B5's recompute"),
        "cross_attention_bwd": entry(
            "cross_attention_bwd (attn_bwd_wgmma_kernel)",
            "flowcompare_tpu_torch/csrc/cross_attention_bwd.cu",
            "flowcompare_tpu/ops/flow_layer_vjp_pallas.py:206", "bwd_", head["bwd_max_abs_err"],
            "the attention's backward in B5"),
    }
    return entries, cases


def bf16_ulps(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|got - ref| elementwise in bf16 ulps of ref (one ulp: 2^-7 of the
    power of two at or below |ref|); an element below 2^-8 of max |ref| is
    counted at that size, where f32 sums in another order leave more than
    an ulp of itself."""
    a = ref.float().abs()
    _, e = torch.frexp(torch.maximum(a, a.max() * 2 ** -8))
    return (got.float() - ref.float()).abs() / torch.ldexp(torch.ones_like(a), e - 8)


def error_stats(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far got lies from ref: absolute (max, root mean square), the max
    over max |ref| and over max(1, max |ref|), and in bf16 ulps of ref
    (`bf16_ulps`: the largest, the 99.9th percentile, and the share of
    elements more than a quarter, a half and one ulp off)."""
    err = (got.float() - ref.float()).abs()
    top = float(ref.float().abs().max())
    r = bf16_ulps(got, ref).flatten()
    return {"max_abs": float(err.max()), "rms_abs": float(err.pow(2).mean().sqrt()),
            "max_over_max_ref": float(err.max()) / max(top, 1e-30),
            "max_over_scale": float(err.max()) / max(top, 1.0),
            "ulps_max": float(r.max()),
            "ulps_q999": float(r.kthvalue(max(1, int(0.999 * r.numel()))).values),
            **{f"share_over_{name}_ulp": float((r > v).float().mean())
               for name, v in (("quarter", 0.25), ("half", 0.5), ("one", 1.0))}}


# limits of the fused layer checks, by output: an f32 carry (B1's x, B7's y),
# a bf16 output (the save row, the packed rows' x1 columns), q and ldj: the
# largest error against the output's scale, and the shares of elements off
# by more than a quarter or half a bf16 ulp (`error_stats`).
# tools/torch_fused_layer_faults.py reads them on the H100 at these shapes:
# the kernels as built put at most 1.6% of a carry's elements over a quarter
# ulp and 0.8% over half, 1.6% of a bf16 output's, 1.7% of ldj's; the carry
# rounded to bf16 puts 48-50% over a quarter ulp, [s | t] in bf16 1.9-12% of
# B1's x and B7's y over half an ulp and 21-35% of ldj over a quarter, the
# LayerNorm's input in bf16 55% of q. Each limit lies between the two.
FUSED_LIMITS = {"carry": {"max_over_scale": 2e-2, "share_over_quarter_ulp": 0.05,
                          "share_over_half_ulp": 0.012},
                "bf16": {"max_over_scale": 2e-2, "share_over_quarter_ulp": 0.05},
                "q": {"max_over_max_ref": 2 * 2 ** -8, "share_over_quarter_ulp": 0.05},
                "ldj": {"max_abs": 1e-2, "share_over_quarter_ulp": 0.08}}


def check_fused(what: str, got: torch.Tensor, ref: torch.Tensor, kind: str) -> dict:
    """error_stats of a fused layer output against its plain version, held
    to FUSED_LIMITS[kind]."""
    stats = error_stats(got, ref)
    over = {k: (stats[k], v) for k, v in FUSED_LIMITS[kind].items() if not stats[k] <= v}
    assert not over, f"{what}: {over} over the limits ({stats})"
    return stats


FUSED_CASES = (("dulcet-universe", 40960, "dulcet eval item, B=20 x 1024, both directions"),
               ("dulcet-universe", 20480, "dulcet training step, B=20 x 1024"),
               ("dulcet-universe", SAMPLE_N, "a sample, 1 x 4000"),
               ("helpful-sponge", 51200, "helpful-sponge eval item, B=25 x 1024, both "
                                         "directions"))


def _stack_ops(stack, rows: int, products: int) -> int:
    return sum(2 * rows * w.shape[1] * w.shape[2] for w, _ in stack.pairs[:products])


def _fused_bytes(stack, rows: int, cols_in: int, cols_out: int, products: int) -> int:
    """Bytes the layer must move: its rows in and out once, one layer's weights."""
    weights = sum(w.shape[1] * w.shape[2] * 2 + w.shape[2] * 4 for w, _ in stack.pairs[:products])
    return rows * (cols_in + cols_out) + weights


def phase_fused_layers(ft, device) -> dict:
    """The fused layer kernels (csrc/fused_layer.cu) at the main path's
    shapes: dulcet-universe's eval item (40,960 rows), training step (20,480)
    and sample (4,000), and helpful-sponge's eval item (51,200, seven
    coupling products, no conditioner). Each kernel against its plain version
    on the same packed rows, and the per-product route (the gemm, row_norm,
    cast and epilogue launches a layer took before the fusion) against it too,
    within FUSED_LIMITS (`check_fused`); the kernel's device time (kernel
    durations from torch.profiler), the plain version's, the per-product
    route's, the bound, and launches per layer on both routes."""
    from flowcompare_tpu_torch.ops import _build, flow_layer_cuda as flc

    bf = torch.bfloat16
    out, entries = {}, {}
    for preset in ("dulcet-universe", "helpful-sponge"):
        cfg = ft.get_config(preset)
        cfg.update(compute_dtype="bfloat16", n_flow_layers=2)
        model = ft.FlowCompareModel(cfg, device=device,
                                    generator=torch.Generator().manual_seed(SEED))
        perturb_identity_leaves(model, torch.Generator().manual_seed(SEED + 1))
        ed, lat, e = int(cfg["using_extra_context"]), cfg["latent_dim"], cfg["input_embedding_dim"]
        split = lat // 2
        with torch.no_grad():
            folded = model._folded(model.params(), ed)
            folded_inv = model._folded_inverse(model.params(), ed)
        lu = (flc._pad_cols(folded["lu_w_f"].transpose(1, 2).to(bf)),
              folded["lu_b"].float().reshape(2, -1).contiguous())
        minv = (flc._pad_cols(folded_inv["lu_w_inv_f"].transpose(1, 2).to(bf)),
                folded_inv["lu_shift"].float().reshape(2, -1).contiguous())
        lu_ldj = folded["lu_ldj_f"].float().contiguous()
        for case_preset, rows, label in FUSED_CASES:
            if case_preset != preset:
                continue
            g = torch.Generator().manual_seed(SEED + rows)

            def rand(*shape):
                return torch.randn(shape, generator=g).to(device)

            ctx = (rand(1, 1, e).bfloat16().expand(1, rows, e) if model.is_global
                   else rand(1, 1250, e).bfloat16())
            extra = rand(1, rows, 1) if ed else None
            fwd = flc._CouplingChain(folded, ctx, extra, rows, split, tail=lu, lat=lat)
            inv = flc._CouplingChain(folded_inv, ctx, extra, rows, split, tail=minv, lat=lat)
            # the per-product route's coupling MLP (a chain without a tail, as
            # B2's net runs) and conditioner parts, for its time
            pp = flc._CouplingChain(folded, ctx, extra, rows, split)
            for chain in (fwd, inv, pp):
                chain.xin[:, :split] = rand(rows, split)
                if chain.has_attn:
                    chain.xin[:, chain.xc:chain.xc + chain.cw] = rand(rows, chain.cw)
            x, ldj, y = rand(rows, lat), rand(rows), rand(rows, lat)
            save = torch.empty(rows, lat, dtype=bf, device=device)
            yb = flc.bf16_rows(rows, lat, device)      # the per-product route's bf16 y
            case = {"rows": rows, "what": label}
            n_mlp = fwd.cpl_stack.n_mlp

            # coupling_layer (with saves: the training forward's launch)
            xin_r, xr, lr, sr = fwd.xin.clone(), x.clone(), ldj.clone(), torch.empty_like(save)
            flc.coupling_layer_plain(xin_r, split, fwd.cpl_stack.layer(0), xr, lr, lu_ldj[0:1],
                                     save=sr, eps_affine=1e-8)
            xin_k, xk, lk = fwd.xin.clone(), x.clone(), ldj.clone()
            _build.coupling_layer(xin_k, split, fwd.cpl_stack, 0, xk, lk, lu_ldj[0:1], save=save,
                                  eps_affine=1e-8)
            torch.cuda.synchronize()
            err = {"x": check_fused("coupling_layer x", xk, xr, "carry"),
                   "ldj": check_fused("coupling_layer ldj", lk, lr, "ldj"),
                   "save": check_fused("coupling_layer save", save, sr, "bf16"),
                   "x1 columns": check_fused("coupling_layer x1 columns", xin_k[:, :split],
                                             xin_r[:, :split], "bf16")}

            def coupling():
                _build.coupling_layer(fwd.xin, split, fwd.cpl_stack, 0, xw, lw, lu_ldj[0:1],
                                      eps_affine=1e-8)

            def coupling_pp(xs, ls, dst):
                _build.cast_rows(xs[:, :split], pp.xin[:, :split])
                _build.mlp_chain(pp.xin[:, :pp.xc + pp.cw],
                                 [(pp.w_in[0], pp.b_in[0])] + flc._at(pp.cpl_rest, 0), pp.st, pp.h)
                _build.coupling_epilogue(pp.st, xs, ls, yb, lu_ldj[0:1], split=split,
                                         eps_affine=1e-8)
                _build.gemm(yb, lu[0][0], dst, bias=lu[1][0])

            # the per-product route against the plain version on its own
            # packed rows (their x1 columns bf16 of x's, as that route casts)
            xin_p, xr, lr = pp.xin.clone(), x.clone(), ldj.clone()
            xin_p[:, :split] = x[:, :split]
            flc.coupling_layer_plain(xin_p, split, fwd.cpl_stack.layer(0), xr, lr, lu_ldj[0:1],
                                     eps_affine=1e-8)
            xw, lw, xp = x.clone(), ldj.clone(), torch.empty_like(x)
            coupling_pp(xw, lw, xp)
            torch.cuda.synchronize()
            err_pp = {"x": check_fused("per-product coupling x", xp, xr, "carry"),
                      "ldj": check_fused("per-product coupling ldj", lw, lr, "ldj")}
            xw, lw = x.clone(), ldj.clone()
            ops = _stack_ops(fwd.cpl_stack, rows, n_mlp + 1)
            moved = _fused_bytes(fwd.cpl_stack, rows, 2 * fwd.cpl_stack.in_cols + 4 * lat + 4,
                                 4 * lat + 2 * split + 4, n_mlp + 1)
            c = {"errors": err, "per_product_errors": err_pp,
                 "max_abs_err": max(v["max_abs"] for v in err.values()),
                 "device_ms": device_ms(coupling),
                 "plain_ms": time_ms(lambda: flc.coupling_layer_plain(
                     xin_r, split, fwd.cpl_stack.layer(0), xr, lr, lu_ldj[0:1], eps_affine=1e-8),
                     reps=2),
                 "per_product_ms": device_ms(lambda: coupling_pp(xw, lw, xk)),
                 "launches_per_layer": 1,
                 "per_product_launches_per_layer": len(pp.cpl_rest) + 4}
            c["bound_ms"], c["bound_by"] = bound(ops, moved)
            case["coupling_layer"] = c

            # coupling_inverse: layer 1 with the chained LU inverse of layer 0
            pairs = inv.cpl_stack.layer(1)[:n_mlp] + [inv.cpl_stack.layer(0)[-1]]
            xin_r, yr = inv.xin.clone(), y.clone()
            flc.coupling_inverse_plain(xin_r, split, pairs, yr, eps_affine=1e-8)
            xin_k, yk = inv.xin.clone(), y.clone()
            _build.coupling_inverse(xin_k, split, inv.cpl_stack, 1, yk, eps_affine=1e-8)
            torch.cuda.synchronize()
            err = {"y": check_fused("coupling_inverse y", yk, yr, "carry"),
                   "x1 columns": check_fused("coupling_inverse x1 columns", xin_k[:, :split],
                                             xin_r[:, :split], "bf16")}

            # timed in place: y is the next layer's y after each call (the
            # values drift; the work does not depend on them)
            def inverse():
                _build.coupling_inverse(inv.xin, split, inv.cpl_stack, 1, yw, eps_affine=1e-8)

            def inverse_pp(ys, xs, dst):
                _build.cast_rows(ys[:, :split], pp.xin[:, :split])
                _build.mlp_chain(pp.xin[:, :pp.xc + pp.cw],
                                 [(pp.w_in[1], pp.b_in[1])] + flc._at(pp.cpl_rest, 1), pp.st, pp.h)
                _build.inverse_coupling_epilogue(pp.st, ys, xs, split=split, eps_affine=1e-8)
                _build.cast_rows(xs, yb)
                _build.gemm(yb, minv[0][0], dst, bias=minv[1][0])

            xin_p, yr = pp.xin.clone(), y.clone()
            xin_p[:, :split] = y[:, :split]
            flc.coupling_inverse_plain(xin_p, split, pairs, yr, eps_affine=1e-8)
            yw, xw, yp = y.clone(), torch.empty_like(y), torch.empty_like(y)
            inverse_pp(yw, xw, yp)
            torch.cuda.synchronize()
            err_pp = {"y": check_fused("per-product coupling inverse y", yp, yr, "carry")}
            yw = y.clone()
            ci = {"errors": err, "per_product_errors": err_pp,
                  "max_abs_err": max(v["max_abs"] for v in err.values()),
                  "device_ms": device_ms(inverse),
                  "per_product_ms": device_ms(lambda: inverse_pp(yw, xw, yw)),
                  "plain_ms": time_ms(lambda: flc.coupling_inverse_plain(
                      xin_r, split, pairs, yr.copy_(y), eps_affine=1e-8), reps=2),
                  "launches_per_layer": 1,
                  "per_product_launches_per_layer": len(pp.cpl_rest) + 5}
            ci["bound_ms"], ci["bound_by"] = bound(
                ops, _fused_bytes(inv.cpl_stack, rows, 2 * inv.cpl_stack.in_cols + 4 * lat,
                                  4 * lat + 2 * split, n_mlp + 1))
            case["coupling_inverse"] = ci

            if fwd.has_attn:
                q_ref = torch.empty_like(fwd.q)
                flc.conditioner_plain(fwd.xin, split, fwd.cond_stack.layer(0), q_ref)
                _build.conditioner(fwd.xin, split, fwd.cond_stack, 0, fwd.q)
                torch.cuda.synchronize()
                err = {"q": check_fused("conditioner q", fwd.q, q_ref, "q")}

                pre = flc._bf16_stack(folded["pre"])
                wq = flc._pad_cols(folded["wq_f"].to(bf))
                bq = folded["bq_f"].float().reshape(2, -1).contiguous()
                q_f = torch.empty(rows, pre[-1][0].shape[-1], device=device)
                q_n = flc.bf16_rows(rows, q_f.shape[1], device)

                def cond_pp():
                    _build.mlp_chain(pp.xin[:, :split], flc._at(pre, 0), q_f, pp.h)
                    _build.row_norm(q_f, q_n)
                    _build.gemm(q_n, wq[0], pp.q, bias=bq[0])

                # the in-place timing of inverse_pp above leaves its drifted
                # y in pp.xin's x1 columns (more of it when a trace is
                # retried, until it overflows): start the check from x's
                pp.xin[:, :split] = x[:, :split]
                cond_pp()
                flc.conditioner_plain(pp.xin, split, fwd.cond_stack.layer(0), q_ref)
                torch.cuda.synchronize()
                err_pp = {"q": check_fused("per-product conditioner q", pp.q, q_ref, "q")}
                k = len(fwd.cond_stack.pairs)
                cd = {"errors": err, "per_product_errors": err_pp,
                      "max_abs_err": err["q"]["max_abs"],
                      "device_ms": device_ms(lambda: _build.conditioner(
                          fwd.xin, split, fwd.cond_stack, 0, fwd.q)),
                      "plain_ms": time_ms(lambda: flc.conditioner_plain(
                          fwd.xin, split, fwd.cond_stack.layer(0), q_ref), reps=2),
                      "per_product_ms": device_ms(cond_pp), "launches_per_layer": 1,
                      "per_product_launches_per_layer": k + 1}
                cd["bound_ms"], cd["bound_by"] = bound(
                    _stack_ops(fwd.cond_stack, rows, k),
                    _fused_bytes(fwd.cond_stack, rows, 2 * split,
                                 2 * fwd.cond_stack.pairs[-1][0].shape[2], k))
                case["conditioner"] = cd
            log(f"fused layers {preset} {rows} rows ({label}): {case}")
            out[f"{preset} {rows}"] = case
            del fwd, inv, pp
            torch.cuda.empty_cache()
        del model
    dulcet = out["dulcet-universe 40960"]
    for name, key, replaces in (("conditioner", "conditioner", "1018"),
                                ("coupling_layer", "coupling_layer", "1018"),
                                ("coupling_inverse", "coupling_inverse", "1205")):
        c = dulcet[key]
        err = c["max_abs_err"]
        entries[name] = {"name": name, "route": "cuda",
                         "source": "flowcompare_tpu_torch/csrc/fused_layer.cu",
                         "replaces": f"flowcompare_tpu/ops/flow_layer_pallas.py:{replaces}",
                         "launches": 0, "max_abs_err": err, "ms": c["device_ms"],
                         "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                         "bound_by": c["bound_by"], "library_ms": None,
                         "per_product_ms": c.get("per_product_ms")}
    return entries, out


def phase_main_bounds(model) -> dict:
    """The least time of B1, B2, B3, B4 and B6 at the main path's own shapes
    (the kernel phase times them at smaller ones): B1 and B2 over one B=20
    eval item (40,960 rows, every layer, 40 items of 1,250 context rows), B3,
    B4 and B6 over its 40 context clouds of 1,250 points. From shapes only."""
    from flowcompare_tpu_torch.ops import flow_layer_cuda as flc

    cfg = model.config
    items, nc, n, lat = 2 * TIME_B, cfg["n_samples_context"], cfg["sample_size"], cfg["latent_dim"]
    rows, emb = items * n, cfg["input_embedding_dim"]
    params = model.params()
    folded = model._folded(params, 1)
    folded_aug = flc.fold_augmenter(params["augmenter"], input_dim=6, extra_dim=1)
    ctx_bytes = items * nc * emb * 2
    out = {}
    out["B1"] = bound(sum(stack_flops(folded, rows, items, nc)),
                      rows * (2 * lat * 4 + 2 * 4 + 4) + ctx_bytes + nbytes(folded))
    out["B2"] = bound(sum(stack_flops(folded_aug, rows, items, nc, lu=False)),
                      rows * (6 * 4 + (lat - 6) * 4 + 4 + lat * 4 + 4) + ctx_bytes
                      + nbytes(folded_aug))
    pts = items * nc
    out["B3"] = bound(sum(knn_flops(items, nc, cq) for cq, _ in EDGE_WIDTHS),
                      sum(pts * cq * 2 + 2 * pts * cout * 2 for cq, cout in EDGE_WIDTHS))
    enc = params["embedder"]
    out_mlp = [l["w"] for l in [enc["out_mlp"]["in"], *enc["out_mlp"]["hidden"],
                                enc["out_mlp"]["out"]]]
    out["B4"] = bound(sum(knn_flops(items, nc, cin) + 2 * 2 * pts * cin * cout
                          for cin, cout in EDGE_WIDTHS)
                      + 2 * pts * 512 * 512 + sum(_mm(pts, w) for w in out_mlp),
                      pts * 6 * 4 + nbytes(enc, model.state.tree()["embedder"]) + pts * emb * 2)
    out["B6"] = bound(sum(knn_flops(items, nc, cq) for cq, _ in EDGE_WIDTHS),
                      sum(pts * cq * 2 + pts * cout * 2 + 9 * pts * cout * 4
                          for cq, cout in EDGE_WIDTHS))
    out = {k: {"bound_ms": v[0], "bound_by": v[1]} for k, v in out.items()}
    log(f"bounds at the main path's shapes (B1, B2 over a B=20 item of {rows} rows and "
        f"{folded['lu_ldj_f'].shape[0]} layers; B3, B4, B6 over {items} clouds of {nc}): {out}")
    return out


def phase_global_kernels(ft, model, device) -> dict:
    """helpful-sponge's branches of B4, B2, B1, B5 and B7 against their plain
    versions at full width: B4 with head=False on the 50 clouds of a B=25
    eval item (the post-conv5 trunk), B2 over the broadcast 124-wide
    embedding (Nkv = N = 1024, a 7-layer pre-MLP, no extra context) at 8 x
    1024 rows and a B=25 item's 51,200, and B1, B5 and B7 on two full-width
    has_attn=False layers (the final block and a stacked layer)."""
    from flowcompare_tpu_torch.core.mlp import cast_tree
    from flowcompare_tpu_torch.ops import flow_layer_cuda as flc

    cfg = model.config
    rows, n, nc, k = 2 * EVAL_B, cfg["sample_size"], cfg["n_samples_context"], cfg["n_neighbors"]
    g = torch.Generator().manual_seed(SEED + 41)
    checks = {}

    params = cast_tree(model.params()["embedder"], torch.bfloat16)
    state = model.state.tree()["embedder"]
    clouds = 2 * GS_B
    b4 = check_b4(torch.randn(clouds, nc, 6, generator=g).to(device), params, state, k, False,
                  f"head=False, {clouds} clouds")
    checks["B4"] = {**check_entry(b4, f"head=False, {clouds} clouds x {nc}"),
                    "device_ms": b4["device_ms"], "launches_per_call": b4["launches_per_call"]}

    # B2 over the broadcast embedding: 8 x 1024 rows and the main path's
    # 51,200 (a B=25 item, both directions), without extra context
    folded_aug = flc.fold_augmenter(model.params()["augmenter"], input_dim=6, extra_dim=0)
    b2 = {}
    for items in (rows, 2 * GS_B):
        xa = torch.randn(items, n, 6, generator=g).to(device)
        eps = torch.randn(items, n, cfg["latent_dim"] - 6, generator=g).to(device)
        ctx, extra, _ = flow_context(model, g, items, n, device)
        b2[items] = check_b2(xa, eps, ctx, extra, folded_aug, n,
                             f"(helpful-sponge: Nkv = N = {n}, E = {ctx.shape[-1]}, pre-MLP of "
                             f"{len(folded_aug['pre'])}, extra=None) {items}x{n}")
    checks["B2"] = {**check_entry(b2[2 * GS_B], f"{2 * GS_B}x{n}, context {n}x124 broadcast, "
                                                 f"extra=None"),
                    "device_ms": b2[2 * GS_B]["device_ms"],
                    "launches_per_call": b2[2 * GS_B]["launches_per_call"],
                    f"at_{rows * n}_rows": {**check_entry(b2[rows], f"{rows}x{n}"),
                                            "device_ms": b2[rows]["device_ms"]}}
    ctx, extra, _ = flow_context(model, g, rows, n, device)

    small = make_model(ft, device, preset="helpful-sponge", n_flow_layers=2)
    folded = small._folded(small.params(), 0)
    xf, ldj = torch.randn(rows, n, cfg["latent_dim"], generator=g).to(device), \
        torch.zeros(rows, n, device=device)
    z, l = flc.fused_flow_layers(xf, ldj, ctx, extra, folded)
    torch.cuda.synchronize()
    zr, lr = flc.fused_flow_layers_plain(xf, ldj, ctx, extra, folded)
    errz, errl = float((z - zr).abs().max()), float((l - lr).abs().max())
    ms = time_ms(lambda: flc.fused_flow_layers(xf, ldj, ctx, extra, folded))
    pms = time_ms(lambda: flc.fused_flow_layers_plain(xf, ldj, ctx, extra, folded), reps=2)
    log(f"B1 fused_flow_layers has_attn=False 2 layers {rows}x{n}x{cfg['latent_dim']}: max|dz| "
        f"{errz} (tolerance 0.05), max|d ldj| {errl} (tolerance 0.01); {ms} ms vs plain {pms} ms")
    assert errz <= 0.05 and errl <= 0.01, "B1 (global) disagrees with its plain version"
    checks["B1"] = check_entry(kernel_entry(
        "", "", "", errz, ms, pms, sum(stack_flops(folded, rows * n, rows, n)),
        nbytes(xf, ldj, ctx[:, :1], folded, z, l)), f"has_attn=False, 2 layers, {rows}x{n}")
    checks["B5"] = check_entry(phase_b5(folded, xf, ldj, ctx, extra, rows, n, n, g, device),
                               f"has_attn=False, 2 layers, {rows}x{n}")
    checks["B7"] = check_entry(phase_b7(small, g, device),
                               f"has_attn=False, 2 layers, 1x{SAMPLE_N}")
    del small
    return checks


def kernel_mean_ms(fn, name: str, reps: int = 10) -> float:
    """The mean duration of the kernels matching `name` in a torch.profiler
    trace of reps calls of fn: a call's device ms where fn launches one such
    kernel. The profiler now and then drops a kernel from a trace, which a
    sum over the calls (`device_ms`) would count as no time."""
    durs = [e["dur"] for e in traced_kernels(fn, reps, name)]
    return sum(durs) / len(durs) / 1e3


def _paconv_reading(fn, plain_fn, kernel, flops, moved, peak=PEAK_F32_FLOPS) -> dict:
    """A call of a wrapper that launches one `kernel`: its wall ms (CUDA
    events, 10 calls, the host included), device ms (`kernel_mean_ms`), the
    plain version's wall ms and the bound."""
    bound_ms, bound_by = bound(flops, moved, peak)
    return {"wall_ms": time_ms(fn, reps=10), "device_ms": kernel_mean_ms(fn, kernel),
            "plain_ms": time_ms(plain_fn, reps=2), "bound_ms": bound_ms, "bound_by": bound_by}


def phase_paconv_kernels(device, items: int):
    """B8 and B9 at the four set-abstraction levels of the PAConv eval path
    (items = both directions of a good-surf batch) and of `make_sample`'s one
    context cloud, against their plain versions.
    B8: the four levels in one launch, indices and coordinates equal to the
    plain chain of levels on random clouds and on clouds of duplicated
    halves; beside its bound, the dependent-chain floor: the picks (sum of m
    less one a level, 409) times the latency of one barrier and redux round
    (`_build.fps_round_probe`).
    B9: the selection of the four levels in one launch and a gather a level:
    slot lists and outputs equal to the plain versions' on integer-valued
    coordinates (exact distances) in bf16 and f32; on random coordinates at
    most 1e-3 of the (item, centre) rows may differ (a different f32 sum
    order may flip a near-tied 32nd neighbour); slot 0 is always the centre
    with a zero xyz diff; level 4 has k = 32 > N = 19.
    Each part's wall and device ms, the plain version's and the bound."""
    from flowcompare_tpu_torch.ops import _build, fps_cuda, sa_group_cuda as sg

    g = torch.Generator().manual_seed(SEED + 30)
    ms = [m for _, m, _ in SA_LEVELS]
    probe = torch.zeros(1, dtype=torch.int32, device=device)
    rounds = 20000
    round_ms = time_ms(lambda: _build.fps_round_probe(rounds, probe), reps=3) / rounds
    picks = sum(ms) - len(ms)
    b8, b9, gather, worst_rows, err9 = {}, {}, {}, 0.0, 0.0
    for clouds in (items, 1):
        x = torch.randn(clouds, SA_LEVELS[0][0], 3, generator=g).to(device)
        dup = torch.cat([x[:, :SA_LEVELS[0][0] // 2]] * 2, 1)
        for cloud in (x, dup):
            idx, out = fps_cuda.furthest_point_sampling_levels(cloud, ms)
            torch.cuda.synchronize()
            ref_idx, ref_out = fps_cuda.furthest_point_sampling_levels_plain(cloud, ms)
            differ = sum(int((a != b).sum()) + int((c != d).sum())
                         for a, b, c, d in zip(idx, ref_idx, out, ref_out))
            assert differ == 0, f"B8 picks differ from the plain version ({differ} at {clouds})"
        idx, out = fps_cuda.furthest_point_sampling_levels(x, ms)
        # m - 1 sweeps of N points, each 3 sub, 3 mul, 2 add and 1 min in f32
        r = _paconv_reading(lambda: fps_cuda.furthest_point_sampling_levels(x, ms),
                            lambda: fps_cuda.furthest_point_sampling_levels_plain(x, ms),
                            "fps_levels_kernel", clouds * sum((m - 1) * n * 9 for n, m, _ in SA_LEVELS),
                            nbytes(x, idx, out))
        r["chain_floor_ms"] = picks * round_ms
        b8[clouds] = r
        log(f"B8 fps_levels {clouds}x{SA_LEVELS[0][0]} -> {ms} in one launch: indices and "
            f"coordinates equal to plain (random and duplicated clouds); {json.dumps(r)}; "
            f"chain floor {picks} picks x {round_ms} ms a barrier and redux round")

        levels = list(zip(out, idx, [x, *out]))
        xi = torch.randint(-8, 9, (clouds, SA_LEVELS[0][0], 3), generator=g).float().to(device)
        ii, oi = fps_cuda.furthest_point_sampling_levels(xi, ms)
        levels_i = list(zip(oi, ii, [xi, *oi]))
        sels = sg.sa_select_levels(levels_i, SA_K)
        torch.cuda.synchronize()
        ref_sels = [sg.sa_select_plain(*lv, SA_K) for lv in levels_i]
        assert all(torch.equal(a.long(), b) for a, b in zip(sels, ref_sels)), \
            "B9's selection not exact on integer coordinates"
        for dtype in (torch.bfloat16, torch.float32):
            for (new_xyz, _, xyz), sel, (_, _, c) in zip(levels_i, sels, SA_LEVELS):
                feats = torch.randn(clouds, xyz.shape[1], c, generator=g).to(device, dtype)
                got = sg.sa_gather(sel, new_xyz, xyz, feats)
                ref = sg.sa_gather_plain(sel, new_xyz, xyz, feats)
                err9 = max(err9, float((got.float() - ref.float()).abs().max()))
        assert err9 == 0.0, "B9 not exact on integer coordinates"

        sels = sg.sa_select_levels(levels, SA_K)
        ref_sels = [sg.sa_select_plain(*lv, SA_K) for lv in levels]
        feats = [torch.randn(clouds, n, c, generator=g).to(device, torch.bfloat16)
                 for n, _, c in SA_LEVELS]
        for (new_xyz, lidx, xyz), sel, ref_sel, f in zip(levels, sels, ref_sels, feats):
            got = sg.sa_gather(sel, new_xyz, xyz, f)
            ref = sg.sa_gather_plain(ref_sel, new_xyz, xyz, f)
            rows = float((got != ref).flatten(2).any(-1).float().mean())
            worst_rows = max(worst_rows, rows)
            assert float(got[:, :, 0, :3].float().abs().max()) == 0.0, "B9 slot 0 is not the centre"
            assert torch.equal(got[:, :, 0, 3:], torch.gather(
                f, 1, lidx[..., None].expand(-1, -1, f.shape[-1]))), "B9 slot 0 is not the centre"
        # the distance expansion: 3 multiply-adds and 2 adds per (centre, point)
        r = _paconv_reading(lambda: sg.sa_select_levels(levels, SA_K),
                            lambda: [sg.sa_select_plain(*lv, SA_K) for lv in levels],
                            "sa_select_kernel", clouds * sum(m * n * 8 for n, m, _ in SA_LEVELS),
                            nbytes(levels, sels))
        b9[clouds] = r
        log(f"B9 sa_select {clouds} clouds, four levels in one launch: {json.dumps(r)}")
        parts = []
        for (new_xyz, _, xyz), sel, f, (n, m, c) in zip(levels, sels, feats, SA_LEVELS):
            out9 = sg.sa_gather(sel, new_xyz, xyz, f)
            # one f32 subtraction per xyz diff
            parts.append(_paconv_reading(lambda: sg.sa_gather(sel, new_xyz, xyz, f),
                                         lambda: sg.sa_gather_plain(sel, new_xyz, xyz, f),
                                         "sa_gather_kernel", clouds * m * SA_K * 3,
                                         nbytes(sel, new_xyz, xyz, f, out9)))
            log(f"B9 sa_gather {clouds}x{n} -> {m}x{SA_K}x{3 + c}"
                f"{' (k > N)' if SA_K > n else ''}: {json.dumps(parts[-1])}")
        gather[clouds] = {k: sum(p[k] for p in parts) for k in ("wall_ms", "device_ms",
                                                                 "plain_ms", "bound_ms")}
        gather[clouds]["bound_by"] = parts[0]["bound_by"]
        gather[clouds]["levels"] = parts
    log(f"B9: integer-coordinate max|err| bf16 and f32 {err9} (tolerance 0), random-coordinate "
        f"rows differing at most {worst_rows} a level (budget 1e-3), slot 0 the centre")
    assert worst_rows <= 1e-3, f"B9 rows differing {worst_rows} > 1e-3"

    def entry(name, source, err, r, one):
        out = kernel_entry(name, source, "", err, r["wall_ms"], r["plain_ms"], 0, 0)
        out.update(bound_ms=r["bound_ms"], bound_by=r["bound_by"], device_ms=r["device_ms"],
                   one_cloud={k: one[k] for k in ("wall_ms", "device_ms", "plain_ms",
                                                   "bound_ms", "bound_by") if k in one})
        return out

    fps_src, sa_src = ("flowcompare_tpu_torch/csrc/fps.cu", "flowcompare_tpu_torch/csrc/sa_group.cu")
    out = {"B8": entry("furthest_point_sampling_levels (fps_levels)", fps_src, 0.0, b8[items],
                       b8[1]),
           "B9": entry("sa_select (B9's selection)", sa_src, err9, b9[items], b9[1]),
           "sa_gather": entry("sa_gather (B9's gather)", sa_src, err9, gather[items], gather[1])}
    out["B8"]["replaces"] = "flowcompare_tpu/ops/fps_pallas.py:99"
    out["B9"]["replaces"] = out["sa_gather"]["replaces"] = "flowcompare_tpu/ops/sa_group_pallas.py:126"
    out["B8"]["chain_floor_ms"] = b8[items]["chain_floor_ms"]
    out["B8"]["round_ms"] = round_ms
    out["sa_gather"]["levels"] = gather[items]["levels"]
    return out


def flow_context(model, g, items: int, n: int, device):
    """(context, extra, extra width) as the model's flow layers take them: the
    encoder's per-point context (items, Nc, E) and the extra column, or, for
    the global conditioner, one embedding per item broadcast over the n
    points; the extra column only where the config uses it."""
    cfg = model.config
    e = cfg["input_embedding_dim"]
    if model.is_global:
        ctx = torch.randn(items, 1, e, generator=g).to(device).bfloat16().expand(items, n, e)
    else:
        ctx = torch.randn(items, cfg["n_samples_context"], e, generator=g).to(device).bfloat16()
    extra = (torch.randn(items, n, 1, generator=g).to(device) if cfg["using_extra_context"]
             else None)
    return ctx, extra, 0 if extra is None else 1


def phase_b7(small, g, device):
    """B7 on two full-width layers (the final block, then a stacked layer)
    at one sample's 1 x 4000 points against its plain version: max |dx| <=
    0.05, B1's two-layer bound."""
    from flowcompare_tpu_torch.ops import flow_layer_cuda as flc

    cfg = small.config
    z = SAMPLE_STD * torch.randn(1, SAMPLE_N, cfg["latent_dim"], generator=g).to(device)
    ctx, extra, ed = flow_context(small, g, 1, SAMPLE_N, device)
    folded_inv = small._folded_inverse(small.params(), ed)
    x = flc.fused_flow_layers_inverse(z, ctx, extra, folded_inv)
    torch.cuda.synchronize()
    xr = flc.fused_flow_layers_inverse_plain(z, ctx, extra, folded_inv)
    err, mean = float((x - xr).abs().max()), float((x - xr).abs().mean())
    ms = time_ms(lambda: flc.fused_flow_layers_inverse(z, ctx, extra, folded_inv))
    pms = time_ms(lambda: flc.fused_flow_layers_inverse_plain(z, ctx, extra, folded_inv), reps=2)
    log(f"B7 fused_flow_layers_inverse 2 layers 1x{SAMPLE_N}x{cfg['latent_dim']}: max|dx| "
        f"{err} (tolerance 0.05), mean|dx| {mean}; {ms} ms vs plain {pms} ms")
    assert err <= 0.05, "B7 disagrees with its plain version"
    used = {k: v for k, v in folded_inv.items() if k not in ("lu_w_f", "lu_b", "lu_ldj_f")}
    return kernel_entry(
        "fused_flow_layers_inverse", "flowcompare_tpu_torch/ops/flow_layer_cuda.py",
        "flowcompare_tpu/ops/flow_layer_pallas.py:1115", err, ms, pms,
        sum(stack_flops(folded_inv, SAMPLE_N, 1, cfg["n_samples_context"])),
        nbytes(z, ctx, extra, used, x))


def phase_b6(device, items, nc, k, g):
    """B6 forward and backward at the four EdgeConv widths. Integer-valued x
    makes the selection exact: mx and mn must equal the plain version's, s1,
    s2 and du agree to f32 sum order, |err| <= 1e-4 (1 + |ref|). Random x
    gets a row budget (a different f32 sum order may flip a near-tied k-th
    neighbour): at most 1% of rows may differ."""
    from flowcompare_tpu_torch.ops import edgeconv_vjp_cuda as ev

    def rand(*shape):
        return torch.randn(shape, generator=g).to(device)

    def fwd_bwd(fn, x, u, cots):
        with torch.enable_grad():
            u = u.detach().requires_grad_()
            outs = fn(x, u, k)
            torch.autograd.backward(outs, cots)
        return [o.detach() for o in outs] + [u.grad]

    err, worst_sum, worst_rows, ms6, plain6, flops, moved = 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0
    for cq, cout in EDGE_WIDTHS:
        xi = torch.randint(-4, 5, (items, nc, cq), generator=g).to(device).bfloat16()
        u = rand(items, nc, cout).bfloat16().float()     # bf16 values; du in f32
        cots = [rand(items, nc, cout) for _ in range(4)]
        got = fwd_bwd(ev.edge_knn_reduce, xi, u, cots)
        torch.cuda.synchronize()
        ref = fwd_bwd(ev.edge_knn_reduce_plain, xi, u, cots)
        exact = max(float((a - b).abs().max()) for a, b in zip(got[:2], ref[:2]))
        summed = max(float(((a - b).abs() / (1 + b.abs())).max()) for a, b in zip(got[2:], ref[2:]))
        assert exact == 0.0, f"B6 mx/mn not exact on integer inputs ({cq}->{cout}): {exact}"
        assert summed <= 1e-4, f"B6 s1/s2/du off by {summed} ({cq}->{cout})"
        err = max(err, max(float((a - b).abs().max()) for a, b in zip(got, ref)))
        worst_sum = max(worst_sum, summed)
        x = rand(items, nc, cq).bfloat16()
        got, ref = fwd_bwd(ev.edge_knn_reduce, x, u, cots), fwd_bwd(ev.edge_knn_reduce_plain, x, u,
                                                                    cots)
        off = torch.zeros(items, nc, dtype=torch.bool, device=device)
        for a, b in zip(got[:4], ref[:4]):
            off |= ((a - b).abs() > 1e-4 * (1 + b.abs())).any(-1)
        worst_rows = max(worst_rows, float(off.float().mean()))
        ms = time_ms(lambda: fwd_bwd(ev.edge_knn_reduce, x, u, cots))
        pms = time_ms(lambda: fwd_bwd(ev.edge_knn_reduce_plain, x, u, cots), reps=2)
        ms6, plain6 = ms6 + ms, plain6 + pms
        flops += knn_flops(items, nc, cq)
        moved += nbytes(x) + items * nc * cout * 2 + 9 * items * nc * cout * 4
        log(f"B6 knn_edge_reduce fwd+bwd {cq}->{cout} x{items}x{nc} k={k}: integer-input "
            f"mx/mn max|err| {exact} (tolerance 0), s1/s2/du max|err|/(1+|ref|) {summed} "
            f"(tolerance 1e-4), random-input rows differing {float(off.float().mean())} "
            f"(budget 0.01); {ms} ms vs plain {pms} ms")
    assert worst_rows <= 0.01, f"B6 rows differing {worst_rows} > 0.01"
    # and at the main path's shapes: 40 clouds (dulcet's B=20 item, the
    # training bound's shape) and 50 (B=25), held to the same row budget
    main6 = {}
    for clouds in (2 * TIME_B, 2 * GS_B):
        ms, pms, worst, fl, mv = 0.0, 0.0, 0.0, 0, 0
        for cq, cout in EDGE_WIDTHS:
            x = rand(clouds, nc, cq).bfloat16()
            u = rand(clouds, nc, cout).bfloat16().float()
            cots = [rand(clouds, nc, cout) for _ in range(4)]
            got, ref = fwd_bwd(ev.edge_knn_reduce, x, u, cots), fwd_bwd(ev.edge_knn_reduce_plain,
                                                                        x, u, cots)
            off = torch.zeros(clouds, nc, dtype=torch.bool, device=device)
            for a, b in zip(got, ref):
                off |= ((a - b).abs() > 1e-4 * (1 + b.abs())).any(-1)
            worst = max(worst, float(off.float().mean()))
            del got, ref
            ms += time_ms(lambda: fwd_bwd(ev.edge_knn_reduce, x, u, cots))
            pms += time_ms(lambda: fwd_bwd(ev.edge_knn_reduce_plain, x, u, cots), reps=2)
            fl += knn_flops(clouds, nc, cq)
            mv += nbytes(x) + clouds * nc * cout * 2 + 9 * clouds * nc * cout * 4
        assert worst <= 0.01, f"B6 rows differing {worst} > 0.01 at {clouds} clouds"
        main6[clouds] = kernel_entry("edge_knn_reduce (knn_edge_reduce, forward + backward)",
                                     "flowcompare_tpu_torch/csrc/knn_edge_reduce.cu",
                                     "flowcompare_tpu/ops/edgeconv_vjp_pallas.py:274", err, ms,
                                     pms, fl, mv)
        log(f"B6 knn_edge_reduce fwd+bwd at {clouds}x{nc}, four widths, k={k}: random-input "
            f"rows differing {worst} (budget 0.01); {ms} ms vs plain {pms} ms, bound "
            f"{main6[clouds]['bound_ms']} ms")
    return {**main6[2 * TIME_B], "shapes": f"{2 * TIME_B} clouds x {nc}, four widths",
            f"at_{2 * GS_B}_clouds": check_entry(main6[2 * GS_B], f"{2 * GS_B} clouds x {nc}"),
            f"at_{items}_clouds": check_entry(kernel_entry("", "", "", err, ms6, plain6, flops,
                                                           moved), f"{items} clouds x {nc}")}


def phase_knn_split() -> dict:
    """B3's and B6's time split at the main path's shapes, by
    tools/torch_knn_split.py: distances / selection / gather of both forward
    kernels (copies of csrc/ stopped after a stage, built under build/), the
    backward's kernels (torch.profiler) and the radix select's sweeps a row."""
    from flowcompare_tpu_torch.ops import _build

    sys.path.insert(0, str(REPO / "tools"))
    import torch_knn_split

    work = REPO / "build" / "knn_split"
    try:
        return torch_knn_split.run(_build.CSRC.resolve(), work, _build.BUILD_DIR, log=log)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def rel_err(a, b) -> float:
    """Max abs error relative to max |ref|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def phase_b5(folded, x, ldj, ctx, extra, items, n, nc, g, device):
    """B5 on two full-width layers from B1's saves, with random dz and dldj,
    against its plain version: max error over max |ref| <= 0.03 for dx,
    dctx and dextra and <= 0.05 for every folded gradient (the JAX
    package's kernel-vs-vjp bands). B1's saves against the plain saves."""
    from flowcompare_tpu_torch.ops import flow_layer_cuda as flc, flow_layer_vjp_cuda as fv

    lat = x.shape[-1]
    _, _, saves = flc.fused_flow_layers(x, ldj, ctx, extra, folded, save=True)
    _, _, saves_ref = flc.fused_flow_layers_plain(x, ldj, ctx, extra, folded, save=True)
    save_err = float((saves.float() - saves_ref.float()).abs().max())
    assert save_err <= 0.05, f"B1 saves disagree with the plain saves: {save_err}"
    dz = torch.randn(items, n, lat, generator=g).to(device)
    dldj = torch.randn(items, n, generator=g).to(device)
    got = fv.flow_layers_bwd(saves, dz, dldj, ctx, extra, folded)
    torch.cuda.synchronize()
    ref = fv.flow_layers_bwd_plain(saves, dz, dldj, ctx, extra, folded)
    act = {name: rel_err(a, b) for name, a, b in zip(("dx", "dctx", "dextra"), got[:3], ref[:3])
           if b is not None}
    wts = {k: rel_err(got[3][k], r) for k, r in ref[3].items()}
    worst_w = max(wts, key=wts.get)
    ms = time_ms(lambda: fv.flow_layers_bwd(saves, dz, dldj, ctx, extra, folded), reps=3)
    pms = time_ms(lambda: fv.flow_layers_bwd_plain(saves, dz, dldj, ctx, extra, folded), reps=1)
    chain_ms = time_ms(lambda: fv._bwd_per_product(saves, dz, dldj, ctx, extra, folded, 1e-8),
                       reps=3)
    log(f"B5 flow_layers_bwd 2 layers {items}x{n}x{lat}: B1 saves max|err| {save_err} "
        f"(tolerance 0.05); relative errors {act} (tolerance 0.03), worst weight {worst_w} "
        f"{wts[worst_w]} (tolerance 0.05); {ms} ms vs plain {pms} ms, the per-product chain "
        f"{chain_ms} ms")
    assert max(act.values()) <= 0.03 and wts[worst_w] <= 0.05, "B5 disagrees with plain"
    stats = b5_stats(got, fv.flow_layers_bwd_fused_plain(saves, dz, dldj, ctx, extra, folded))
    gemm, attn = stack_flops(folded, items * n, items, nc)
    # the recompute, the input and the weight gradients of every product (3x),
    # and the attention's two forward and four backward products
    flops = 3 * gemm + 3 * attn
    moved = nbytes(saves, dz, dldj, ctx, extra, folded, got[0], got[1], got[2]) + sum(
        v.numel() * 4 for v in got[3].values())
    entry = kernel_entry("flow_layers_bwd", "flowcompare_tpu_torch/ops/flow_layer_vjp_cuda.py",
                         "flowcompare_tpu/ops/flow_layer_vjp_pallas.py:476",
                         float((got[0] - ref[0]).abs().max()), ms, pms, flops, moved)
    entry.update(per_product_ms=chain_ms, share_stats={
        k: {key: v[key] for key in ("share_over_quarter_ulp", "share_over_half_ulp")}
        for k, v in stats.items()})
    return entry


# limits of B5's share checks against the fused route's plain version
# (`flow_layer_vjp_cuda.flow_layers_bwd_fused_plain`: every launch's plain
# version, the kernels' own rounding points; flow_layers_bwd_plain, autograd
# of the bf16 stack, rounds elsewhere and keeps its max-error bounds): the
# shares of elements more than a quarter and half a bf16 ulp off
# (`error_stats`) for dx, dctx, dextra and the worst folded gradient
# ("weights"), at phase_b5_fused's shapes (20 x 1024 and 25 x 1024 rows).
# tools/torch_b5_faults.py reads them on the H100: as built at most 0.66% /
# 0.40% of dx, 58.7% / 37.7% of dctx, 6.4% / 3.3% of dextra and 66.4% / 45.4%
# of a weight (this script's own inputs read up to 69.5% / 51.4% there); the
# f32 dp rounded to bf16 at least 4.8% / 3.4%, 74.7% / 55.8%, 62.1% / 40.5%
# and 76.2% / 58.0%; the f32 carry gradient rounded to bf16 at least 48.6% /
# 2.2% of dx (it moves nothing else). Each limit lies
# between the two (the card tests' one-item shapes read higher as built and
# are held to the max-error bands alone).
B5_LIMITS = {"dx": {"share_over_quarter_ulp": 0.02, "share_over_half_ulp": 0.012},
             "dctx": {"share_over_quarter_ulp": 0.70, "share_over_half_ulp": 0.46},
             "dextra": {"share_over_quarter_ulp": 0.30, "share_over_half_ulp": 0.20},
             "weights": {"share_over_quarter_ulp": 0.73, "share_over_half_ulp": 0.55}}


def b5_stats(got, ref) -> dict:
    """error_stats of B5's outputs against the plain version's: dx, dctx,
    dextra, and per statistic the worst over the folded gradients."""
    stats = {"dx": error_stats(got[0], ref[0]), "dctx": error_stats(got[1], ref[1])}
    if ref[2] is not None:
        stats["dextra"] = error_stats(got[2], ref[2])
    w = [error_stats(got[3][k], r) for k, r in ref[3].items()]
    stats["weights"] = {key: max(s[key] for s in w) for key in w[0]}
    return stats


def check_b5(what: str, got, ref) -> dict:
    """b5_stats held to B5_LIMITS."""
    stats = b5_stats(got, ref)
    over = {name: {k: (s[k], v) for k, v in B5_LIMITS[name].items() if not s[k] <= v}
            for name, s in stats.items()}
    over = {k: v for k, v in over.items() if v}
    assert not over, f"{what}: {over} over the limits ({stats})"
    return stats


# limits of the per-kernel checks of phase_b5_fused (`_b5_probe`: each of
# B5's kernels against its plain version on the same inputs), by kernel:
# every row output of the record and backward kernels (records, [s | t],
# dp, the carry gradient, column sums) within a share of elements more than
# one bf16 ulp off and a largest error against the output's scale
# (`error_stats`); the grouped weight gradients' partials and grad_reduce's
# sums to f32 rounding, in bf16 ulps. This script's inputs read on an
# H100 80GB HBM3 at 700 W: at most 1.82% of a row
# output over one ulp (helpful-sponge's sixth column sums; 0.24% at dulcet)
# and 0.0075 of its scale; partials at most 0.26 ulp, sums 0.0093.
B5_PROBE_LIMITS = {"rows": {"share_over_one_ulp": 0.03, "max_over_scale": 0.02},
                   "gemm_tn_grouped": {"ulps_max": 0.5},
                   "grad_reduce": {"ulps_max": 0.05}}


def check_b5_probes(what: str, probes: dict, attention: bool) -> None:
    """_b5_probe's readings held to B5_PROBE_LIMITS; every kernel of the
    branch checked."""
    want = set(B5_KERNELS) - (set() if attention else {"conditioner_record",
                                                       "conditioner_bwd"})
    assert set(probes) == want, f"{what}: kernels checked {sorted(probes)}, not {sorted(want)}"
    over = {}
    for name, result in probes.items():
        limits = B5_PROBE_LIMITS.get(name, B5_PROBE_LIMITS["rows"])
        for out, st in result["stats"].items():
            bad = {k: (st[k], v) for k, v in limits.items() if not st[k] <= v}
            if bad:
                over[f"{name} {out}"] = bad
    assert not over, f"{what}: {over} over B5_PROBE_LIMITS"


B5_KERNELS = ("conditioner_record", "coupling_record", "coupling_bwd", "conditioner_bwd",
              "gemm_tn_grouped", "grad_reduce")
# the counters of every launch B5 makes per layer (both routes' products,
# attention and row passes that have counters)
B5_LAYER_COUNTERS = (*B5_KERNELS, "gemm wgmma", "gemm wmma", "gemm_tn wgmma", "gemm_tn wmma",
                     "attention wgmma", "attention wmma", "attention_bwd wgmma",
                     "attention_bwd wmma", "attn_bwd_prep", "colsum")


def _b5_probe(fv, _build):
    """Wrappers of B5's six launch functions that, on each one's first call,
    run its plain version on copies of the same inputs and outputs (records
    the kernel keeps in its accumulator's order read back row-major,
    `_build.fragment_to_rows`), then the kernel, and keep the error
    statistics of every output, the largest |error| of the main one, and
    the plain version's ms (CUDA events). Returns (results, undo)."""
    import types

    results, undo = {}, []

    def rows(t):
        return _build.fragment_to_rows(t)

    def events(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def compare(name, pairs, main, plain_ms):
        stats = {k: error_stats(a, b) for k, a, b in pairs}
        results[name] = {"stats": stats, "max_abs_err": stats[main]["max_abs"],
                         "plain_ms": plain_ms}

    def wrap(name, checker):
        orig = getattr(_build, name)
        state = {"done": False}

        def wrapped(*args, **kw):
            if state["done"]:
                return orig(*args, **kw)
            state["done"] = True
            return checker(orig, *args, **kw)
        setattr(_build, name, wrapped)
        undo.append((name, orig))

    def fresh_record(record):
        """Row-major outputs of a record's shapes for a plain call."""
        def new(t, like):
            return None if t is None else like(t)
        return types.SimpleNamespace(
            pre=[new(t, lambda u: torch.empty(u.shape, device=u.device)) for t in record.pre],
            h=[new(t, torch.empty_like) for t in record.h])

    def conditioner_record(orig, xin, split, stack, l, q, record, x1_src, ln_rstd):
        q_p, rstd_p = torch.empty_like(q), torch.empty_like(ln_rstd)
        rec = fresh_record(record)
        xin_p = xin.clone()
        ms = events(lambda: fv.conditioner_record_plain(xin_p, split, stack.layer(l), q_p, rec,
                                                        x1_src, rstd_p))
        orig(xin, split, stack, l, q, record, x1_src, ln_rstd)
        torch.cuda.synchronize()
        pairs = [("q", q, q_p), ("ln_rstd", ln_rstd, rstd_p),
                 ("x1 columns", xin[:, :split], xin_p[:, :split])]
        for i, (a, b) in enumerate(zip(record.pre, rec.pre)):
            if a is not None:
                pairs.append((f"record {i} (f32)", rows(a), b))
        for i, (a, b) in enumerate(zip(record.h, rec.h)):
            if a is not None:
                pairs.append((f"record {i} (bf16)", a, b))
        compare("conditioner_record", pairs, "q", ms)

    def coupling_record(orig, xin, split, stack, l, record, x1_src=None):
        rec = fresh_record(record)
        xin_p = xin.clone()
        ms = events(lambda: fv.coupling_record_plain(xin_p, split, stack.layer(l), rec, x1_src))
        orig(xin, split, stack, l, record, x1_src)
        torch.cuda.synchronize()
        last = len(record.pre) - 1
        pairs = [("[s | t]", record.pre[last], rec.pre[last])]
        for i in range(last):
            pairs.append((f"GELU' {i}", rows(record.pre[i]), rec.pre[i]))
            pairs.append((f"activation {i}", record.h[i], rec.h[i]))
        compare("coupling_record", pairs, "[s | t]", ms)

    def plain_stack(stack, head_frag: bool):
        """stack with its f32 rows row-major and fresh outputs, for a plain call."""
        pre = [None if t is None else (rows(t) if (i > 0 or head_frag) else t)
               for i, t in enumerate(stack.pre)]
        widths = [t.shape[1] for t in stack.res_out + stack.res_in if t is not None]
        scratch = (torch.empty(stack.pre[1].shape[0], max(widths), device=stack.pre[1].device)
                   if widths else None)
        res = lambda t: None if t is None else scratch[:, :t.shape[1]]  # noqa: E731
        return types.SimpleNamespace(
            layer=stack.layer, pre=pre, res_in=[res(t) for t in stack.res_in],
            res_out=[res(t) for t in stack.res_out],
            d_out=[None if t is None else torch.empty_like(t) for t in stack.d_out],
            colsum=[None if t is None else torch.empty_like(t) for t in stack.colsum])

    def stack_pairs(stack, sp):
        pairs = []
        for i, (a, b) in enumerate(zip(stack.d_out, sp.d_out)):
            if a is not None:
                pairs.append((f"dp {i}", a, b))
        for i, (a, b) in enumerate(zip(stack.colsum, sp.colsum)):
            if a is not None:
                pairs.append((f"column sums {i}", a, b))
        return pairs

    def coupling_bwd(orig, stack, l, g, g_b, g_colsum, g_next, x, dldj, y, dextra, dcond, **kw):
        sp = plain_stack(stack, head_frag=False)
        outs = [g_b, g_colsum, g_next, y, dextra, dcond]
        plain = [None if t is None else t.clone() for t in outs]
        ms = events(lambda: fv.coupling_bwd_plain(sp, l, g, plain[0], plain[1], plain[2], x, dldj,
                                                  plain[3], plain[4], plain[5], **kw))
        orig(stack, l, g, g_b, g_colsum, g_next, x, dldj, y, dextra, dcond, **kw)
        torch.cuda.synchronize()
        pairs = [(k, a, b) for k, a, b in zip(("bf16 g", "g column sums", "carry gradient", "y",
                                               "dextra", "cond columns"), outs, plain)
                 if a is not None]
        compare("coupling_bwd", pairs + stack_pairs(stack, sp), "carry gradient", ms)

    def conditioner_bwd(orig, stack, l, dq, dq_colsum, g_next, ln_rstd, **kw):
        sp = plain_stack(stack, head_frag=True)
        cs_p, g_p = dq_colsum.clone(), g_next.clone()
        ms = events(lambda: fv.conditioner_bwd_plain(sp, l, dq, cs_p, g_p, ln_rstd, **kw))
        orig(stack, l, dq, dq_colsum, g_next, ln_rstd, **kw)
        torch.cuda.synchronize()
        compare("conditioner_bwd", [("carry gradient", g_next, g_p), ("dq column sums",
                                     dq_colsum, cs_p)] + stack_pairs(stack, sp),
                "carry gradient", ms)

    def gemm_tn_grouped(orig, group):
        gp = types.SimpleNamespace(problems=group.problems, chunks=group.chunks,
                                   partials=[torch.empty_like(p) for p in group.partials])
        ms = events(lambda: _build.gemm_tn_grouped_plain(gp))
        orig(group)
        torch.cuda.synchronize()
        compare("gemm_tn_grouped", [(f"problem {i}", a, b) for i, (a, b) in
                                    enumerate(zip(group.partials, gp.partials))], "problem 0", ms)

    def grad_reduce(orig, sums, l):
        sp = types.SimpleNamespace(sums=[(part, torch.empty_like(out)) for part, out in sums.sums])
        ms = events(lambda: _build.grad_reduce_plain(sp, l))
        orig(sums, l)
        torch.cuda.synchronize()
        compare("grad_reduce", [(f"sum {i}", a[l], b[l]) for i, ((_, a), (_, b)) in
                                enumerate(zip(sums.sums, sp.sums))], "sum 0", ms)

    for name, checker in (("conditioner_record", conditioner_record),
                          ("coupling_record", coupling_record), ("coupling_bwd", coupling_bwd),
                          ("conditioner_bwd", conditioner_bwd),
                          ("gemm_tn_grouped", gemm_tn_grouped), ("grad_reduce", grad_reduce)):
        wrap(name, checker)
    return results, undo


def _b5_kernel_bounds(fv_args) -> dict:
    """(operations, bytes) of each of B5's kernels for one layer at these
    inputs, from shapes: each product once at the bf16 peak; what must move:
    the rows each reads and writes once (records, gradients, saves) and its
    weights."""
    saves, dz, dldj, ctx, extra, folded = fv_args
    rows, lat = saves.shape[1], saves.shape[2]
    half, split = lat - lat // 2, lat // 2
    cpl = ([folded["cpl_in_xe"].shape[1] + folded["cpl_in_c"].shape[1]]
           + [w.shape[-1] for w, _ in folded["cpl_rest"]])   # K of the first, then N of each
    k_in, widths = cpl[0], [folded["cpl_in_xe"].shape[-1]] + cpl[1:]
    mlp = [(k_in, widths[0])] + [(widths[i - 1], widths[i]) for i in range(1, len(widths))]
    ops = {"coupling_record": sum(2 * rows * k * n for k, n in mlp),
           "coupling_bwd": sum(2 * rows * k * n for k, n in mlp) + 2 * rows * lat * lat}
    hid = sum(widths[:-1])
    by = {"coupling_record": rows * (2 * k_in + 6 * hid + 4 * widths[-1])
          + sum(2 * k * n for k, n in mlp),
          "coupling_bwd": rows * (4 * lat + 2 * lat + 4 * widths[-1] + 2 * lat + 4 * hid
                                  + 2 * widths[-1] + 2 * hid + 4 * lat + 2 * lat + 4 * k_in)
          + sum(2 * k * n for k, n in mlp) + 2 * lat * lat}
    if folded["pre"] is not None:
        pw = [w.shape[-1] for w, _ in folded["pre"]]
        d = folded["wq_f"].shape[-1]
        pre = [(split, pw[0])] + [(pw[i - 1], pw[i]) for i in range(1, len(pw))] + [(pw[-1], d)]
        ops["conditioner_record"] = sum(2 * rows * k * n for k, n in pre)
        ops["conditioner_bwd"] = ops["conditioner_record"]
        ph = sum(pw)
        by["conditioner_record"] = rows * (2 * split + 6 * ph + 2 * d + 4 + 2 * split) + sum(
            2 * k * n for k, n in pre)
        by["conditioner_bwd"] = rows * (4 * d + 4 * ph + 2 * ph + 8 * split + 4) + sum(
            2 * k * n for k, n in pre)
    out = {}
    for name, o in ops.items():
        out[name] = bound(o, by[name])
    return out


def phase_b5_fused(ft, device, preset: str, batch: int) -> dict:
    """B5's fused per-layer kernels at a preset's full width on two layers
    over its training rows (batch x 1024): each kernel against its plain
    version on the same inputs (`_b5_probe`, the last layer's launches),
    their device ms per launch from a torch.profiler trace of one B5 call,
    the bound; B5 against its plain version (the max-error bounds of
    phase_b5 and B5_LIMITS) and two calls bit-equal; the per-product chain
    (`_bwd_per_product`, the comparison route) timed beside it and the
    launches a layer of both from the counters."""
    from flowcompare_tpu_torch.ops import _build, flow_layer_cuda as flc, flow_layer_vjp_cuda as fv

    small = make_model(ft, device, preset=preset, n_flow_layers=2)
    cfg = small.config
    folded = small._folded(small.params(), cfg["extra_context_dim"])
    g = torch.Generator().manual_seed(SEED + 50)
    n, lat = cfg["sample_size"], cfg["latent_dim"]
    ctx, extra, _ = flow_context(small, g, batch, n, device)
    x = torch.randn(batch, n, lat, generator=g).to(device)
    ldj = torch.zeros(batch, n, device=device)
    _, _, saves = flc.fused_flow_layers(x, ldj, ctx, extra, folded, save=True)
    dz = torch.randn(batch, n, lat, generator=g).to(device)
    dldj = torch.randn(batch, n, generator=g).to(device)
    args = (saves, dz, dldj, ctx, extra, folded)
    layers = folded["lu_ldj_f"].shape[0]
    attention = folded["pre"] is not None
    probes, undo = _b5_probe(fv, _build)
    try:
        got = fv.flow_layers_bwd(*args)
        torch.cuda.synchronize()
    finally:
        for name, orig in reversed(undo):
            setattr(_build, name, orig)
    again = fv.flow_layers_bwd(*args)
    torch.cuda.synchronize()
    equal = all(a is None or torch.equal(a, b) for a, b in zip(got[:3], again[:3])) and all(
        torch.equal(got[3][k], again[3][k]) for k in got[3])
    ref = fv.flow_layers_bwd_plain(*args)
    act = {name: rel_err(a, b) for name, a, b in zip(("dx", "dctx", "dextra"), got[:3], ref[:3])
           if b is not None}
    wts = {k: rel_err(got[3][k], r) for k, r in ref[3].items()}
    fused_ref = fv.flow_layers_bwd_fused_plain(*args)
    stats = check_b5(f"B5 {preset}", got, fused_ref)
    chain = fv._bwd_per_product(*args, 1e-8)
    chain_stats = b5_stats(chain, fused_ref)
    reset_counters()
    fv.flow_layers_bwd(*args)
    fused_launches = read_counters()
    reset_counters()
    fv._bwd_per_product(*args, 1e-8)
    chain_launches = read_counters()
    prof = profile_kernels(lambda: fv.flow_layers_bwd(*args), f"B5 {preset}",
                           f"chip_smoke_b5_{preset}_trace.json")
    chain_prof = profile_kernels(lambda: fv._bwd_per_product(*args, 1e-8),
                                 f"B5 per product {preset}",
                                 f"chip_smoke_b5_per_product_{preset}_trace.json")
    # the counted launches a layer, and every kernel a call launches (its
    # per-call casts and folds included) over the layers
    per_layer = {"fused": sum(fused_launches[k] for k in B5_LAYER_COUNTERS) / layers,
                 "fused_all_kernels": prof["launches"] / layers,
                 "per_product_all_kernels": chain_prof["launches"] / layers,
                 "per_product_counted": sum(chain_launches[k] for k in B5_LAYER_COUNTERS)
                 / layers}
    fused_ms = device_ms(lambda: fv.flow_layers_bwd(*args), reps=3)
    chain_ms = device_ms(lambda: fv._bwd_per_product(*args, 1e-8), reps=3)
    pms = time_ms(lambda: fv.flow_layers_bwd_plain(*args), reps=1)
    bounds = _b5_kernel_bounds(args)
    kernels = {}
    for name in B5_KERNELS:
        if name not in probes:
            continue
        group = "conditioner" if name == "conditioner_record" else (
            name + "_kernel" if name in ("gemm_tn_grouped", "grad_reduce") else name)
        k = prof["by_kernel"][group]
        ms = k["ms"] / k["launches"]
        if name in bounds:
            b_ms, b_by = bounds[name]
        else:
            b_ms, b_by = _b5_gradient_bound(name, args, got)
        kernels[name] = {"max_abs_err": probes[name]["max_abs_err"], "ms": ms,
                         "plain_ms": probes[name]["plain_ms"], "bound_ms": b_ms,
                         "bound_by": b_by, "launches_per_call": k["launches"],
                         "stats": probes[name]["stats"]}
    out = {"rows": batch * n, "layers": layers, "relative_errors": act,
           "worst_weight": max(wts.values()), "stats": stats, "per_product_stats": chain_stats,
           "bit_equal": equal, "device_ms": fused_ms, "per_product_device_ms": chain_ms,
           "plain_ms": pms, "launches_per_layer": per_layer,
           "per_product_gemm_tn_launches": chain_launches["gemm_tn wgmma"], "profile": {
               k: v for k, v in prof.items() if k != "by_kernel"}, "kernels": kernels}
    log(f"B5 fused kernels {preset} 2 layers x {batch * n} rows: {json.dumps(out)}")
    assert max(act.values()) <= 0.03 and max(wts.values()) <= 0.05, "B5 disagrees with plain"
    check_b5_probes(f"B5 {preset}", probes, attention)
    assert equal, "two B5 calls differ"
    assert per_layer["fused"] == (11 if attention else 4), per_layer
    assert fused_launches["colsum"] == 0 and fused_launches["gemm_tn wgmma"] == 0
    del small, saves, got, again, ref, chain, fused_ref
    torch.cuda.empty_cache()
    return out


def _b5_gradient_bound(name: str, args, got) -> tuple:
    """The bound of the grouped weight gradients and of their sums at one
    layer of these inputs. gemm_tn_grouped: every weight gradient a^T b's
    2 K M N operations at the bf16 peak, a and b (K rows each: the points,
    or the context rows for wkv) read once and the M x N f32 result written
    once. grad_reduce: about 4 adds an output element at the f32 rate, the
    partials (about 4 an element: the K splits and the 320-400 tile sums of a
    bias are few beside the weights) read once and the outputs written."""
    saves, _, _, ctx, _, folded = args
    rows = saves.shape[1]
    weights = [k for k in got[3] if k.startswith(("cpl_w", "pre_w")) or k in (
        "lu_w_f", "wkv", "wq_f", "cpl_in_xe", "cpl_in_c")]
    ops = moved = 0
    for k in weights:
        m, n = got[3][k].shape[-2], got[3][k].shape[-1]
        depth = ctx.shape[0] * ctx.shape[1] if k == "wkv" else rows
        ops += 2 * depth * m * n
        moved += 2 * depth * (m + n) + 4 * m * n
    if name == "gemm_tn_grouped":
        return bound(ops, moved)
    elems = sum(got[3][k][0].numel() for k in got[3] if k != "lu_ldj_f")
    return bound([(4 * elems, PEAK_F32_FLOPS)], 4 * 5 * elems)


def phase_main_path(ft, model, device, need=("B1", "B2", "B3", "B4"), items=None):
    """Full-depth eval through evaluate_on_test; kernel path vs plain path.
    `need` are the kernels the path must launch; `items` the eval batches
    (default: two of EVAL_B random clouds)."""
    items = items if items is not None else eval_items(model.config, EVAL_B, 2, SEED + 3)
    batch = len(items[0][1])
    noise = make_noise(device)
    maps_k = []
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    nats_k, fr_k = ft.evaluate_on_test(model, items, noise=noise, change_maps=maps_k)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    launches, chains = read_counters(), CHAIN_ROUTES.read()
    log(f"main path {model.config['input_embedder']} (kernels): nats {nats_k}, changed "
        f"fractions {fr_k}, {t_k} s, launches {launches}")
    check_routes(launches, chains, f"the {model.config['input_embedder']} eval main path",
                 attention=("attention wgmma",))
    launches["fused"] = check_flow_launches(chains, "the eval main path",
                                            not model.is_global)
    launches["b4_b2"] = check_b4_b2(chains, "the eval main path")
    # the model's first eval: B2's and B4's weights folded once, for every item
    assert launches["B2 folds"] == 1 and launches["B4 folds"] == int(launches["B4"] > 0), \
        launches
    model.plain = True
    maps_p = []
    nats_p, fr_p = ft.evaluate_on_test(model, items, noise=noise, change_maps=maps_p)
    model.plain = False
    assert all(launches[k] > 0 for k in need), f"a kernel of the path never ran: {launches}"
    assert np.isfinite(nats_k) and np.isfinite(nats_p), (nats_k, nats_p)
    assert len(fr_k) == len(items) * batch and all(0.0 <= f <= 1.0 for f in fr_k), fr_k
    assert all(m.shape == (batch, model.config["sample_size"]) for m in maps_k)
    agree = float(torch.cat([(a > 0) == (b > 0) for a, b in zip(maps_k, maps_p)])
                  .float().mean())
    log(f"main path (plain): nats {nats_p}, changed fractions {fr_p}; |d nats| "
        f"{abs(nats_k - nats_p)} (tolerance 0.01), change-map agreement {agree} "
        f"(tolerance >= 0.999)")
    assert abs(nats_k - nats_p) <= 0.01, "nats disagree with the plain path"
    assert agree >= 0.999, "change maps disagree with the plain path"
    return launches


def phase_timing(ft, model, device, batch: int = TIME_B):
    """Main-path throughput at the preset's batch, and the split of one item."""
    from flowcompare_tpu_torch.model import broadcast_embedding, inner_loop

    cfg = model.config
    from flowcompare_tpu_torch.ops import dgcnn_cuda, flow_layer_cuda as flc

    items = eval_items(cfg, batch, 3, SEED + 4)
    noise = make_noise(device)
    folds = (dgcnn_cuda.DGCNN_FOLDS, flc.AUGMENTER_FOLDS)
    ft.evaluate_on_test(model, items[:1], noise=noise)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ft.evaluate_on_test(model, items[1:], noise=noise)
    torch.cuda.synchronize()
    per_item = (time.perf_counter() - t0) / 2
    n = cfg["sample_size"]
    out = {"item_s": per_item, "points_per_s": 2 * batch * n / per_item,
           "target_points_per_s": batch * n / per_item,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    # the split of one item's two directions over the three stages
    v = [torch.as_tensor(a, device=device) for a in items[1]]
    ctx_in, tgt = torch.cat([v[0], v[8]]), torch.cat([v[1], v[7]])
    extra = (torch.cat([v[2], v[2]])[:, None, :].expand(2 * batch, n, 1)
             if cfg["using_extra_context"] else None)
    eps = noise(0, (2 * batch, n, cfg["latent_dim"] - cfg["input_dim"]))
    with torch.no_grad():
        emb, _ = model.embed(ctx_in)
        if model.is_global:
            emb = broadcast_embedding(emb, n)
        out["embed_ms"] = time_ms(lambda: model.embed(ctx_in), reps=3)
        out["log_prob_ms"] = time_ms(lambda: model.log_prob(tgt, emb, extra, eps), reps=2)
        out["inner_loop_ms"] = time_ms(
            lambda: inner_loop(model, (ctx_in, tgt, torch.cat([v[2], v[2]])), eps=eps), reps=2)
        # the weights were folded on the main path: none of these calls folds
        out["folds"] = (dgcnn_cuda.DGCNN_FOLDS - folds[0], flc.AUGMENTER_FOLDS - folds[1])
        model.plain = True
        out["plain_inner_loop_ms"] = time_ms(
            lambda: inner_loop(model, (ctx_in, tgt, torch.cat([v[2], v[2]])), eps=eps), reps=1)
        model.plain = False
    log(f"timing {cfg['input_embedder']} at B={batch} (both directions, {2 * batch * n} "
        f"points per item; B4 and B2 folds over the timed calls {out['folds']}): {out}")
    assert out["folds"] == (0, 0), out["folds"]
    return out


def phase_sample_main(ft, model, device, need=("B7", "B4", "B3")):
    """The sampling main path: one full-depth make_sample of 1 x 4000 points
    through the kernels, with the launch counters set to 0 just before and
    read after, and through the plain versions on the same z."""
    from flowcompare_tpu_torch.model import broadcast_embedding, inner_loop
    from flowcompare_tpu_torch.ops import flow_layer_cuda as flc

    cfg = model.config
    rng = np.random.default_rng(SEED + 20)
    x0 = torch.as_tensor(rng.normal(size=(1, cfg["n_samples_context"], 6)), dtype=torch.float32,
                         device=device)
    extra = torch.as_tensor(rng.normal(size=(1, 1)), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    z = SAMPLE_STD * torch.randn((1, SAMPLE_N, cfg["latent_dim"]), generator=gen, device=device)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    xk = ft.make_sample(model, SAMPLE_N, x0, extra, z=z)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    launches, chains = read_counters(), CHAIN_ROUTES.read()
    check_routes(launches, chains, f"{cfg['input_embedder']} make_sample",
                 attention=() if model.is_global else ("attention wgmma",))
    launches["fused"] = check_flow_launches(chains, "make_sample", not model.is_global)
    launches["b4_b2"] = check_b4_b2(chains, "make_sample")
    # the weights the eval path folded: no fold here
    assert launches["B4 folds"] == launches["B2 folds"] == 0, launches
    model.plain = True
    xp = ft.make_sample(model, SAMPLE_N, x0, extra, z=z)
    model.plain = False
    d = (xk - xp).abs()
    eps = torch.randn((1, SAMPLE_N, cfg["latent_dim"] - cfg["input_dim"]), generator=gen,
                      device=device)
    with torch.no_grad():
        nats_k = float(inner_loop(model, (x0, xk, extra), eps=eps)[2])
        nats_p = float(inner_loop(model, (x0, xp, extra), eps=eps)[2])
        emb, _ = model.embed(x0)
        if model.is_global:
            emb = broadcast_embedding(emb, SAMPLE_N)
        extra_n, ed = ((extra[:, None, :].expand(1, SAMPLE_N, 1), 1) if cfg["using_extra_context"]
                       else (None, 0))
        params = model.params()
        x_lat = flc.fused_flow_layers_inverse(z, emb, extra_n, model._folded_inverse(params, ed))
        z_back, _ = flc.fused_flow_layers(x_lat, torch.zeros(1, SAMPLE_N, device=device), emb,
                                          extra_n, model._folded(params, ed))
    rt = (z_back - z).abs()
    out = {"kernel_s": t_k, "launches": launches, "max_abs_dx": float(d.max()),
           "mean_abs_dx": float(d.mean()), "max_abs_x": float(xp.abs().max()),
           "nats_kernels": nats_k, "nats_plain": nats_p, "abs_d_nats": abs(nats_k - nats_p),
           "round_trip_max_abs": float(rt.max()), "round_trip_mean_abs": float(rt.mean()),
           "round_trip_rel": float(rt.max() / z.abs().max())}
    log(f"sampling main path {cfg['input_embedder']} make_sample 1x{SAMPLE_N}, full depth: "
        f"{out} (|d nats| tolerance 0.01)")
    assert xk.shape == (1, SAMPLE_N, cfg["input_dim"]) and torch.isfinite(xk).all()
    assert torch.isfinite(xp).all() and np.isfinite([nats_k, nats_p]).all()
    assert all(launches[k] >= 1 for k in need), f"a kernel never ran: {launches}"
    assert abs(nats_k - nats_p) <= 0.01, "sample nats disagree with the plain path"
    return out


def phase_sample_timing(ft, model, device):
    """ms per make_sample at 1 x 4000, and model.sample at B=20 x 1024:
    points/s, B7 alone and the plain path."""
    from flowcompare_tpu_torch.ops import flow_layer_cuda as flc

    cfg = model.config
    g = torch.Generator(device=device).manual_seed(SEED + 22)
    x0 = torch.randn((1, cfg["n_samples_context"], 6), generator=g, device=device)
    extra = torch.randn((1, 1), generator=g, device=device)
    out = {"make_sample_ms": time_ms(lambda: ft.make_sample(model, SAMPLE_N, x0, extra,
                                                            generator=g), reps=3)}
    n = cfg["sample_size"]
    ctx_in = torch.randn((TIME_B, cfg["n_samples_context"], 6), generator=g, device=device)
    extra_n = torch.randn((TIME_B, 1, 1), generator=g, device=device).expand(TIME_B, n, 1)
    z = SAMPLE_STD * torch.randn((TIME_B, n, cfg["latent_dim"]), generator=g, device=device)
    with torch.no_grad():
        emb, _ = model.embed(ctx_in)
        folded_inv = model._folded_inverse(model.params(), 1)
        out["sample_ms"] = time_ms(lambda: model.sample(z, emb, extra_n), reps=3)
        out["b7_ms"] = time_ms(lambda: flc.fused_flow_layers_inverse(z, emb, extra_n, folded_inv),
                               reps=3)
        model.plain = True
        out["plain_sample_ms"] = time_ms(lambda: model.sample(z, emb, extra_n), reps=1)
        model.plain = False
        flops = sum(stack_flops(folded_inv, TIME_B * n, TIME_B, cfg["n_samples_context"]))
    out["points_per_s"] = TIME_B * n / (out["sample_ms"] / 1e3)
    out["b7_bound_ms"], _ = bound(flops, 0)
    log(f"sampling timing (1x{SAMPLE_N} make_sample; B={TIME_B}x{n} model.sample): {out}")
    return out


def train_batches(cfg, batch: int, n_batches: int, seed: int) -> list:
    """Training batches (extract_0, extract_1, extra) as random clouds."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(batch, cfg["n_samples_context"], 6)).astype(np.float32),
             rng.normal(size=(batch, cfg["sample_size"], 6)).astype(np.float32),
             rng.normal(size=(batch, 1)).astype(np.float32)) for _ in range(n_batches)]


def _counters():
    from flowcompare_tpu_torch.ops import (_build, attention_cuda, dgcnn_cuda, edgeconv_cuda,
                                           edgeconv_vjp_cuda, flow_layer_cuda,
                                           flow_layer_vjp_cuda, fps_cuda, sa_group_cuda)
    return [(flow_layer_cuda, "FUSED_FLOW_LAYERS_LAUNCHES", "B1"),
            (flow_layer_cuda, "FUSED_FLOW_LAYERS_SAVE_LAUNCHES", "B1 with saves"),
            (flow_layer_cuda, "FUSED_AUGMENTER_LAUNCHES", "B2"),
            (edgeconv_cuda, "EDGE_NEIGHBOR_MAX_LAUNCHES", "B3"),
            (dgcnn_cuda, "FUSED_DGCNN_ENCODER_LAUNCHES", "B4"),
            (flow_layer_vjp_cuda, "FLOW_LAYERS_BWD_LAUNCHES", "B5"),
            (edgeconv_vjp_cuda, "EDGE_KNN_REDUCE_LAUNCHES", "B6"),
            (flow_layer_cuda, "FUSED_FLOW_LAYERS_INVERSE_LAUNCHES", "B7"),
            (fps_cuda, "FPS_LAUNCHES", "B8"),
            (sa_group_cuda, "SA_SELECT_LAUNCHES", "B9"),
            (sa_group_cuda, "SA_GATHER_LAUNCHES", "sa_gather"),
            (attention_cuda, "FUSED_ATTENTION_CORE_LAUNCHES", "B10"),
            (_build, "GEMM_WGMMA_LAUNCHES", "gemm wgmma"),
            (_build, "GEMM_WMMA_LAUNCHES", "gemm wmma"),
            (_build, "GEMM_TN_WGMMA_LAUNCHES", "gemm_tn wgmma"),
            (_build, "GEMM_TN_WMMA_LAUNCHES", "gemm_tn wmma"),
            (_build, "CROSS_ATTENTION_WGMMA_LAUNCHES", "attention wgmma"),
            (_build, "CROSS_ATTENTION_WMMA_LAUNCHES", "attention wmma"),
            (_build, "ATTENTION_BWD_WGMMA_LAUNCHES", "attention_bwd wgmma"),
            (_build, "ATTENTION_BWD_WMMA_LAUNCHES", "attention_bwd wmma"),
            (_build, "FUSED_CONDITIONER_LAUNCHES", "conditioner"),
            (_build, "COUPLING_LAYER_LAUNCHES", "coupling_layer"),
            (_build, "COUPLING_INVERSE_LAUNCHES", "coupling_inverse"),
            (_build, "CONDITIONER_RECORD_LAUNCHES", "conditioner_record"),
            (_build, "COUPLING_RECORD_LAUNCHES", "coupling_record"),
            (_build, "COUPLING_BWD_LAUNCHES", "coupling_bwd"),
            (_build, "CONDITIONER_BWD_LAUNCHES", "conditioner_bwd"),
            (_build, "GEMM_TN_GROUPED_LAUNCHES", "gemm_tn_grouped"),
            (_build, "GRAD_REDUCE_LAUNCHES", "grad_reduce"),
            (_build, "ATTN_BWD_PREP_LAUNCHES", "attn_bwd_prep"),
            (_build, "COLSUM_LAUNCHES", "colsum"),
            (_build, "PACK_ROWS_LAUNCHES", "pack_rows"),
            (_build, "DGCNN_TAIL_LAUNCHES", "dgcnn_tail"),
            (_build, "AUGMENT_NET_LAUNCHES", "augment_net"),
            (dgcnn_cuda, "DGCNN_FOLDS", "B4 folds"),
            (flow_layer_cuda, "AUGMENTER_FOLDS", "B2 folds")]


def reset_counters() -> None:
    for module, attr, _ in _counters():
        setattr(module, attr, 0)
    if CHAIN_ROUTES is not None:
        CHAIN_ROUTES.reset()


def read_counters() -> dict:
    return {key: getattr(module, attr) for module, attr, key in _counters()}


def _to_device(batch, device):
    return tuple(torch.as_tensor(a, device=device) for a in batch)


def phase_train_check(ft, model, device, need=("B5", "B6", "B1 with saves")):
    """Data init, then one train_step through the kernels and one through the
    plain versions from the same state, batch and noise, at B=2."""
    cfg = model.config
    batch = _to_device(train_batches(cfg, TRAIN_CHECK_B, 1, SEED + 10)[0], device)
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    shape = (TRAIN_CHECK_B, cfg["sample_size"], cfg["latent_dim"] - cfg["input_dim"])
    eps_init = torch.randn(shape, generator=gen, device=device)
    eps = torch.randn(shape, generator=gen, device=device)
    ft.data_init_from_batch(ft.init_train_state(model), batch, eps=eps_init)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    groups = ("embedder", "augmenter", "layers", "final_block")
    results = []
    for plain in (False, True):
        model.load_state_dict(snapshot)
        model.plain = plain
        reset_counters()
        _, row = ft.train_step(ft.init_train_state(model), batch, eps=eps)
        torch.cuda.synchronize()
        grads = {gname: torch.cat([p.grad.float().reshape(-1) for name, p in
                                   model.named_parameters() if name.startswith(gname + ".")])
                 for gname in groups}
        results.append((row, read_counters(), grads))
    model.plain = False
    model.load_state_dict(snapshot)
    (rk, ck, gk), (rp, cp, gp) = results
    cos = {gname: float(torch.nn.functional.cosine_similarity(gk[gname], gp[gname], dim=0))
           for gname in groups}
    log(f"training check {cfg['input_embedder']} B={TRAIN_CHECK_B}: kernels {rk}, plain {rp}; "
        f"|d nats| "
        f"{abs(rk['nats'] - rp['nats'])} (tolerance 0.01), grad_norm ratio "
        f"{rk['grad_norm'] / rp['grad_norm']} (tolerance 5%), gradient cosine {cos} "
        f"(tolerance >= 0.99); launches kernels {ck}, plain {cp}")
    assert all(np.isfinite([rk["loss"], rp["loss"], rk["grad_norm"], rp["grad_norm"]]))
    assert abs(rk["nats"] - rp["nats"]) <= 0.01, "training nats disagree with the plain path"
    assert abs(rk["grad_norm"] - rp["grad_norm"]) <= 0.05 * rp["grad_norm"], "grad norms differ"
    assert min(cos.values()) >= 0.99, f"gradient directions differ: {cos}"
    assert all(ck[k] >= 1 for k in need), ck
    assert all(cp[k] == 0 for k in need), cp
    return {"kernels": rk, "plain": rp, "cosine": cos, "launches": ck}


def phase_train_main(ft, model, device, batch: int = TIME_B,
                     need=("B5", "B6", "B1 with saves", "B3")):
    """The training main path: train() at the preset's batch, four steps (the
    first a warm-up) with a sample after every second batch, with the launch
    counters set to 0 just before and read after."""
    from flowcompare_tpu_torch.train.metrics import MetricWriter

    rows = []

    class Rows(MetricWriter):
        def log(self, metrics, step=None):
            rows.append(dict(metrics))

    data = train_batches(model.config, batch, 4, SEED + 12)
    save_dir = REPO / "build" / "chip_smoke_train"
    for old in save_dir.glob("sample_*.npz"):
        old.unlink()
    bps = model.config["batches_per_sample"]
    model.config["batches_per_sample"] = 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    ft.train(model, data, generator=torch.Generator(device=device).manual_seed(SEED + 13),
             writer=Rows(), save_dir=str(save_dir), run_name="smoke", max_steps=4,
             make_samples=True)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches, chains = read_counters(), CHAIN_ROUTES.read()
    model.config["batches_per_sample"] = bps
    check_routes(launches, chains, f"{model.config['input_embedder']} train(max_steps=4)",
                 attention=() if model.is_global else ("attention wgmma", "attention_bwd wgmma"))
    launches["fused"] = check_flow_launches(chains, "train(max_steps=4)", not model.is_global)
    launches["b5"] = check_b5_launches(chains, "train(max_steps=4)", not model.is_global)
    launches["b4_b2"] = check_b4_b2(chains, "train(max_steps=4)")
    samples = {p.name: np.load(p)["gen"] for p in sorted(save_dir.glob("sample_*.npz"))}
    losses = [r["loss"] for r in rows]
    out = {"ms_per_step": 1e3 * float(np.mean([r["time_batch"] for r in rows[1:]])),
           "step_ms": [1e3 * r["time_batch"] for r in rows], "losses": losses,
           "grad_norms": [r["grad_norm"] for r in rows], "train_s": total,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "launches": launches,
           "samples": {name: {"shape": list(g.shape), "finite": bool(np.isfinite(g).all()),
                              "max_abs": float(np.abs(g).max())} for name, g in samples.items()}}
    log(f"training main path {model.config['input_embedder']} B={batch}, train(max_steps=4, "
        f"make_samples=True, batches_per_sample=2): {out}")
    assert len(rows) == 4 and all(np.isfinite(losses)), losses
    assert all(launches[k] >= 1 for k in need), launches
    assert sorted(samples) == ["sample_smoke_1.npz", "sample_smoke_3.npz"], sorted(samples)
    assert all(g.shape == (SAMPLE_N, 6) and np.isfinite(g).all() for g in samples.values())
    assert launches["B7"] == 2, launches
    return out, data


class _DeviceTimer:
    """Wraps module functions so that each call is bracketed by CUDA events."""

    def __init__(self):
        self.spans, self._undo = {}, []

    def wrap(self, module, attr, key):
        orig = getattr(module, attr)

        def timed(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*args, **kwargs)
            end.record()
            self.spans.setdefault(key, []).append((start, end))
            return out
        setattr(module, attr, timed)
        self._undo.append((module, attr, orig))

    def restore(self):
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)

    def ms(self) -> dict:
        return {key: sum(s.elapsed_time(e) for s, e in spans) for key, spans in self.spans.items()}


def phase_train_split(ft, model, data, device):
    """Device time of one step at the batch of `data` (the training main
    path's) by stage, and the host time of the data init. Then B5 again on
    that step's own arguments (full depth): its device time (the kernels'
    durations, torch.profiler) beside the per-product chain's (the
    comparison route, `_bwd_per_product`), and every kernel both launch, over
    the layers."""
    from flowcompare_tpu_torch.model import inner_loop
    from flowcompare_tpu_torch.ops import _build, flow_layer_cuda as flc, flow_layer_vjp_cuda as fv
    from flowcompare_tpu_torch.train.optim import clip_by_global_norm

    cfg = model.config
    batch = _to_device(data[0], device)
    b = batch[0].shape[0]
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    shape = (b, cfg["sample_size"], cfg["latent_dim"] - cfg["input_dim"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ft.data_init_from_batch(ft.init_train_state(model), batch,
                                    eps=torch.randn(shape, generator=gen, device=device))
    torch.cuda.synchronize()
    data_init_ms = 1e3 * (time.perf_counter() - t0)
    eps = torch.randn(shape, generator=gen, device=device)
    ft.train_step(state, batch, eps=eps)                      # warm-up
    captured, b5_entry = {}, fv.flow_layers_bwd

    def capture(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        return b5_entry(*args, **kw)

    fv.flow_layers_bwd = capture
    timer = _DeviceTimer()
    timer.wrap(flc, "fused_flow_layers", "b1_with_saves_ms")
    timer.wrap(fv, "flow_layers_bwd", "b5_ms")
    timer.wrap(_build, "knn_edge_reduce_fwd", "b6_forward_ms")
    timer.wrap(_build, "knn_edge_reduce_bwd", "b6_backward_ms")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    try:
        torch.cuda.synchronize()
        ev[0].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss, _, _, new_bn = inner_loop(model, batch, eps=eps, training=True)
        ev[1].record()
        loss.backward()
        ev[2].record()
        clip_by_global_norm(list(model.parameters()), cfg["grad_clip_val"])
        state.optimizer.step()
        model.load_state(new_bn)
        ev[3].record()
        torch.cuda.synchronize()
    finally:
        timer.restore()
        fv.flow_layers_bwd = b5_entry
    args, kw = captured.pop("args"), captured.pop("kw")
    layers = args[-1]["lu_ldj_f"].shape[0]
    with torch.no_grad():
        b5 = {"device_ms": device_ms(lambda: fv.flow_layers_bwd(*args, **kw), reps=1),
              "per_product_device_ms": device_ms(
                  lambda: fv._bwd_per_product(*args, kw.get("eps_affine", 1e-8)), reps=1),
              "kernels_per_layer": len(kernel_trace(lambda: fv.flow_layers_bwd(*args, **kw),
                                                    "chip_smoke_b5_step_trace.json")[0]) / layers,
              "per_product_kernels_per_layer": len(kernel_trace(
                  lambda: fv._bwd_per_product(*args, kw.get("eps_affine", 1e-8)),
                  "chip_smoke_b5_step_trace.json")[0]) / layers, "layers": layers}
        del args, kw
        gemm, attn = stack_flops(model._folded(model.params(), cfg["extra_context_dim"]),
                                 b * cfg["sample_size"], b, cfg["n_samples_context"])
    out = {"data_init_ms": data_init_ms, "forward_ms": ev[0].elapsed_time(ev[1]),
           "backward_ms": ev[1].elapsed_time(ev[2]), "optimizer_ms": ev[2].elapsed_time(ev[3]),
           **timer.ms(), "b1_with_saves_bound_ms": bound(gemm + attn, 0)[0],
           "b5_bound_ms": bound(3 * gemm + 3 * attn, 0)[0], "b5": b5}
    log(f"training split {cfg['input_embedder']} B={b} (device ms, data init host ms): {out}")
    return out


def _kernel_group(name: str) -> str:
    """The port's kernels by name; cuBLAS's products (PAConv's f32 weight-bank
    products, the folds) as one group; the rest is PyTorch's own."""
    if re.search(r"xmma|cutlass|sgemm|gemv|gemmSN|splitKreduce", name):
        return "library GEMM (cuBLAS)"
    fused = re.search(r"fused_layer_kernel<(\d)>", name)
    if fused:
        return ("conditioner", "coupling_layer", "coupling_inverse", "coupling_record",
                "dgcnn_tail", "augment_net")[int(fused.group(1))]
    fused_bwd = re.search(r"fused_layer_bwd_kernel<(\d)>", name)
    if fused_bwd:
        return ("coupling_bwd", "conditioner_bwd")[int(fused_bwd.group(1))]
    found = re.search(r"(\w+_kernel)", name)
    return found.group(1) if found and "at::" not in name else "PyTorch's own"


def profile_kernels(fn, label: str, trace: str):
    """torch.profiler over one call of fn (after a warm-up call): device time
    summed by kernel, and the device's idle share of the call's span."""
    fn()                                                      # warm-up
    torch.cuda.synchronize()
    kernels, traced_ms = kernel_trace(fn, trace)
    if not kernels:
        log(f"profile of {label}: the profiler recorded no device kernels")
        return None
    by_name = {}
    for e in kernels:
        ms, count = by_name.get(_kernel_group(e["name"]), (0.0, 0))
        by_name[_kernel_group(e["name"])] = (ms + e["dur"] / 1e3, count + 1)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = spans[-1][1] - spans[0][0]
    total = sum(ms for ms, _ in by_name.values())
    out = {"traced_ms": traced_ms, "kernel_ms": total, "launches": len(kernels),
           "busy_ms": busy / 1e3, "span_ms": span / 1e3, "idle_share": 1 - busy / span,
           "by_kernel": {k: {"ms": ms, "share": ms / total, "launches": c} for k, (ms, c) in
                         sorted(by_name.items(), key=lambda kv: -kv[1][0])}}
    log(f"profile of {label}: {json.dumps(out)}")
    return out


def phase_profile(ft, model, data, device, trace: str = "chip_smoke_train_step_trace.json"):
    """torch.profiler over one train step at the batch of `data`."""
    cfg = model.config
    batch = _to_device(data[1], device)
    b = batch[0].shape[0]
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    eps = torch.randn((b, cfg["sample_size"], cfg["latent_dim"] - cfg["input_dim"]),
                      generator=gen, device=device)
    state = ft.init_train_state(model)
    return profile_kernels(lambda: ft.train_step(state, batch, eps=eps),
                           f"one {cfg['input_embedder']} B={b} train step", trace)


def phase_sample_profile(ft, model, device):
    """torch.profiler over one make_sample of 1 x 4000 points."""
    cfg = model.config
    g = torch.Generator(device=device).manual_seed(SEED + 23)
    x0 = torch.randn((1, cfg["n_samples_context"], 6), generator=g, device=device)
    extra = torch.randn((1, 1), generator=g, device=device)
    return profile_kernels(lambda: ft.make_sample(model, SAMPLE_N, x0, extra, generator=g),
                           f"one make_sample of 1x{SAMPLE_N}", "chip_smoke_sample_trace.json")


def phase_eval_profile(ft, model, device, batch: int, trace: str):
    """torch.profiler over one eval inner_loop at the preset's batch (both
    directions stacked, as evaluate_on_test runs an item)."""
    from flowcompare_tpu_torch.model import inner_loop

    cfg = model.config
    g = torch.Generator(device=device).manual_seed(SEED + 24)
    b, nc, n = 2 * batch, cfg["n_samples_context"], cfg["sample_size"]
    batch_t = (torch.randn((b, nc, 6), generator=g, device=device),
               torch.randn((b, n, 6), generator=g, device=device),
               torch.randn((b, 1), generator=g, device=device))
    eps = torch.randn((b, n, cfg["latent_dim"] - cfg["input_dim"]), generator=g, device=device)
    with torch.no_grad():
        return profile_kernels(lambda: inner_loop(model, batch_t, eps=eps),
                               f"one {cfg['input_embedder']} eval item, B={batch} both directions",
                               trace)


def check_paconv_launches(launches: dict, what: str, eval_embeds: int,
                          train_embeds: int = 0) -> None:
    """PAConv's kernels on a path: B8 once an embed (its four levels in one
    launch), B9's selection once an eval embed (four levels in one launch)
    and its gather once a level of an eval embed; training's embeds group
    with the plain kNN."""
    want = {"B8": eval_embeds + train_embeds, "B9": eval_embeds, "sa_gather": 4 * eval_embeds}
    got = {k: launches[k] for k in want}
    log(f"PAConv launches on {what}: {got} (expected {want})")
    assert got == want, f"PAConv launches on {what}: {got}, expected {want}"


def good_surf_phases(ft, device) -> tuple:
    """The PAConv phases on good-surf at full width and depth: B8 and B9
    against their plain versions, the eval main path, eval timing and a
    profile at the preset's B=25, sampling, the training check at B=2 and
    train(max_steps=4) at B=25, each path's B8 and B9 launches asserted."""
    t0 = time.perf_counter()
    model = make_model(ft, device, preset="good-surf")
    log(f"model: good-surf bf16 (PAConv), {sum(p.numel() for p in model.parameters())} "
        f"parameters, built in {time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        entries = phase_paconv_kernels(device, 2 * GS_B)
    launches = phase_main_path(ft, model, device, need=("B1", "B2", "B8", "B9", "sa_gather"))
    check_paconv_launches(launches, "the eval main path (2 items)", eval_embeds=2)
    timing = phase_timing(ft, model, device, batch=GS_B)
    sample_main = phase_sample_main(ft, model, device, need=("B7", "B8", "B9", "sa_gather"))
    check_paconv_launches(sample_main["launches"], "make_sample", eval_embeds=1)
    g = torch.Generator(device=device).manual_seed(SEED + 25)
    x0 = torch.randn((1, model.config["n_samples_context"], 6), generator=g, device=device)
    extra = torch.randn((1, 1), generator=g, device=device)
    sample_main["make_sample_ms"] = time_ms(
        lambda: ft.make_sample(model, SAMPLE_N, x0, extra, generator=g), reps=3)
    log(f"good-surf make_sample 1x{SAMPLE_N}: {sample_main['make_sample_ms']} ms")
    profile = phase_eval_profile(ft, model, device, GS_B, "chip_smoke_paconv_eval_trace.json")
    need = ("B5", "B1 with saves", "B8")
    check = phase_train_check(ft, model, device, need=need)
    check_paconv_launches(check["launches"], "one train_step", eval_embeds=0, train_embeds=1)
    train_main, _ = phase_train_main(ft, model, device, batch=GS_B, need=need)
    # the data init and two samples embed in eval, the four steps in training
    check_paconv_launches(train_main["launches"], "train(max_steps=4, make_samples=True)",
                          eval_embeds=3, train_embeds=4)
    for key in ("B8", "B9", "sa_gather"):
        entries[key]["launches"] = launches[key]
    return entries, {"eval_main_path": launches, "timing": timing, "eval_profile": profile,
                     "sampling": sample_main, "training": {"check": check, "main_path": train_main}}


def helpful_sponge_phases(ft, device) -> tuple:
    """The global-conditioner phases on helpful-sponge at full width and
    depth (bf16; the previous model freed first): the branches of B4, B2,
    B1, B5 and B7 against their plain versions, the eval main path through
    evaluate_on_test at 2 items of B=4 against the plain path (B4 with
    head=False, B3, B2 and B1 counted; B10 not), eval timing and a profile
    at the preset's B=25, make_sample of 1 x 4000 against plain samples of
    the same z, the training check at B=2 (the embedder's gradient among the
    groups) and train(max_steps=4, make_samples=True) at B=25."""
    with torch.no_grad():
        b5_fused = phase_b5_fused(ft, device, "helpful-sponge", GS_B)
    b5_global = {name: {**check_entry(entry, f"has_attn=False, 2 layers, {b5_fused['rows']} rows"),
                        "launches": 0}
                 for name, entry in b5_kernel_entries(b5_fused).items()}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = make_model(ft, device, preset="helpful-sponge")
    log(f"model: helpful-sponge bf16 (global DGCNN, global conditioner), "
        f"{sum(p.numel() for p in model.parameters())} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        checks = phase_global_kernels(ft, model, device)
    launches = phase_main_path(ft, model, device)
    assert launches["B10"] == 0, launches
    timing = phase_timing(ft, model, device, batch=GS_B)
    profile = phase_eval_profile(ft, model, device, GS_B, "chip_smoke_global_eval_trace.json")
    sample_main = phase_sample_main(ft, model, device)
    g = torch.Generator(device=device).manual_seed(SEED + 26)
    x0 = torch.randn((1, model.config["n_samples_context"], 6), generator=g, device=device)
    sample_main["make_sample_ms"] = time_ms(
        lambda: ft.make_sample(model, SAMPLE_N, x0, None, generator=g), reps=3)
    log(f"helpful-sponge make_sample 1x{SAMPLE_N}: {sample_main['make_sample_ms']} ms")
    check = phase_train_check(ft, model, device)
    train_main, data = phase_train_main(ft, model, device, batch=GS_B)
    split = phase_train_split(ft, model, data, device)
    step_profile = phase_profile(ft, model, data, device, "chip_smoke_global_train_step_trace.json")
    served = {**{k: launches[k] for k in ("B1", "B2", "B4")},
              "B5": train_main["launches"]["B5"], "B7": sample_main["launches"]["B7"]}
    for key, chk in checks.items():
        chk["launches"] = served[key]
    for name, chk in b5_global.items():
        chk["launches"] = train_main["launches"][name]
    return checks, {"eval_main_path": launches, "timing": timing, "eval_profile": profile,
                    "sampling": sample_main, "training": {"check": check, "main_path": train_main,
                                                          "split": split,
                                                          "profile": step_profile},
                    "b5_fused": b5_fused}, b5_global


def swept_energy_phases(ft, device) -> dict:
    """swept-energy at full width and depth (the per-point DGCNN without
    extra context: B4 with the head and B2's extra=None packed rows on one
    path; the previous model freed first): the eval main path through
    evaluate_on_test at 2 items of B=4 against the plain path (|d nats| <=
    0.01, change maps >= 99.9%; B4's and B2's launches a call and one fold
    of their weights) and eval timing at the preset's B=20."""
    t0 = time.perf_counter()
    model = make_model(ft, device, preset="swept-energy")
    log(f"model: swept-energy bf16 (DGCNN, no extra context), "
        f"{sum(p.numel() for p in model.parameters())} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = phase_main_path(ft, model, device)
    assert launches["B10"] == 0, launches
    timing = phase_timing(ft, model, device, batch=model.config["batch_size"])
    return {"eval_main_path": launches, "timing": timing}


# ---------------------------------------------------------------- data layer

DATA_DIR = REPO / "build" / "chip_smoke_data"


def host_cpu() -> str:
    """The host CPU as lscpu names it: its model name, vendor, family and
    model (a virtual machine's lscpu may say "unknown" for the name)."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    except OSError:
        return "unknown CPU (no lscpu)"
    fields = {k.strip(): v.strip() for k, _, v in
              (line.partition(":") for line in out.splitlines())}
    return (f"{fields.get('Model name', 'unknown')} ({fields.get('Vendor ID', '?')} family "
            f"{fields.get('CPU family', '?')} model {fields.get('Model', '?')}, lscpu)")


def street_scan(rng: np.random.Generator, changed: bool) -> np.ndarray:
    """One epoch of a 4 x 2 m street, (N, 6) xyz + rgb in [0, 1]: ground and
    a 3.9 m facade at 250 points/m^2, dense enough that both 2 x 2 x 4 m
    voxels along the facade keep more than 1,250 points after the 0.07 m
    downsample; `changed` adds an 800-point object in front of it."""
    def part(n, xyz, rgb):
        return np.concatenate([xyz, np.clip(rng.normal(rgb, 0.05, (n, 3)), 0, 1)], axis=1)

    n_ground, n_wall = 2000, 3900
    parts = [part(n_ground, np.c_[rng.uniform(-2, 2, n_ground), rng.uniform(-2, 0, n_ground),
                                  rng.normal(0, 0.01, n_ground)], 0.45),
             part(n_wall, np.c_[rng.uniform(-2, 2, n_wall), -1 + rng.normal(0, 0.01, n_wall),
                                rng.uniform(0, 3.9, n_wall)], 0.7)]
    if changed:
        parts.append(part(800, rng.normal([-0.8, -0.7, 0.6], 0.25, (800, 3)), 0.3))
    return np.concatenate(parts)


def write_street_scene(root: Path) -> None:
    """Two epochs of one scan location as LAS and as LAZ files, and the
    recording metadata (response.json) the AMS corpus carries."""
    import flowcompare_tpu_torch.data as fdata

    rng = np.random.default_rng(SEED + 40)
    props = []
    for i, year in enumerate((2019, 2020)):
        cloud = street_scan(rng, changed=(i == 1))
        fdata.save_las(str(root / f"scan{i}.las"), cloud)
        fdata.write_laz(str(root / f"scan{i}.laz"), cloud)
        props.append({"ImageId": f"scan{i}", "X": 0.0, "Y": 0.0, "Height": 2.5,
                      "GroundLevelOffset": 2.5, "RecordingTimeGps": f"{year}-06-01T12:00:00"})
    (root / "response.json").write_text(json.dumps({"RecordingProperties": props}))


def host_batch_ms(make_batch, reps: int = 3) -> list:
    """Host wall ms of make_batch() (a numpy batch), each of reps calls."""
    out = []
    for r in range(reps):
        t0 = time.perf_counter()
        batch = make_batch(r)
        out.append(1e3 * (time.perf_counter() - t0))
        assert all(a is None or np.isfinite(a).all() for a in batch)
    return out


def eval_item_ms(ft, model, items, device) -> float:
    """Card ms of one eval item through evaluate_on_test (warm; mean of the items)."""
    noise = make_noise(device)
    ft.evaluate_on_test(model, items[:1], noise=noise)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ft.evaluate_on_test(model, items, noise=noise)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / len(items)


def check_batch(batch, shapes: list, what: str) -> None:
    got = [None if a is None else tuple(a.shape) for a in batch]
    assert got == shapes, f"{what}: shapes {got}, expected {shapes}"
    assert all(a is None or np.isfinite(a).all() for a in batch), f"{what}: non-finite values"


def phase_data(ft, model, device) -> dict:
    """The port's data layer feeding the dulcet-universe model (full width
    and depth, its weights as the earlier phases left them):
    (a) the native libraries built from native/*.cpp (timed) and loaded, the
    native FPS index-equal to its numpy body on a 2,000-point cloud;
    (b) a two-epoch street scene written as LAS and LAZ scans with a
    response.json, the LAS and LAZ decodes equal, AmsVoxelLoader's offline
    build (registration, voxel pairing; clearance 2 m instead of the
    presets' 10 to keep the registration to seconds) over the LAZ scans in
    train mode and over the LAS scans with include_all, at the presets'
    1,250 context and 1,024 target points and voxel sizes: every item's
    shapes and finite values, and the eval items through evaluate_on_test;
    (c) train(max_steps=2) at B=20 from SyntheticVoxelDataset through
    PrefetchedDataset (B5, B6 and B1 with saves counted), then the eval
    main path on two include_all batches of B=20 from SyntheticVoxelDataset
    against the plain path (|d nats| <= 0.01, change maps >= 99.9%);
    (e) host ms of one batch of 20 of each source (synthetic train,
    synthetic eval, AmsVoxelLoader eval on this scene, PackedVoxelDataset
    over packed synthetic train items) beside the card's ms of one item.
    The native libraries were loaded, and the loaders have no other path."""
    import flowcompare_tpu_torch.data as fdata
    from flowcompare_tpu_torch import native
    from flowcompare_tpu_torch.data import laz
    from flowcompare_tpu_torch.train.metrics import MetricWriter

    t_phase = time.perf_counter()
    cfg = model.config
    nc, n = cfg["n_samples_context"], cfg["sample_size"]
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    DATA_DIR.mkdir(parents=True)
    out = {"host_cpu": host_cpu(), "host_cores": len(os.sched_getaffinity(0))}

    # (a) the native libraries
    t0 = time.perf_counter()
    libs = [native.build_library(src) for src in ("native_ops.cpp", "laz_codec.cpp")]
    out["native_build_s"] = time.perf_counter() - t0
    cloud = np.random.default_rng(SEED + 41).normal(size=(2000, 6)).astype(np.float32)
    t0 = time.perf_counter()
    idx = native.fps_indices(cloud, nc)
    out["fps_native_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ref = native.fps_indices_plain(cloud, nc)
    out["fps_plain_ms"] = 1e3 * (time.perf_counter() - t0)
    assert np.array_equal(idx, ref), "native FPS differs from its numpy body"

    # (b) LAS and LAZ scans through AmsVoxelLoader
    scene = DATA_DIR / "scene"
    scene.mkdir()
    write_street_scene(scene)
    for i in range(2):
        las_cloud = fdata.load_cloud(str(scene / f"scan{i}.las"))
        assert np.array_equal(las_cloud, fdata.load_cloud(str(scene / f"scan{i}.laz"))), i
    kw = dict(clearance=2, n_samples=n, n_samples_context=nc,
              final_voxel_size=cfg["final_voxel_size"],
              context_voxel_size=cfg["context_voxel_size"], voxel_size_final_downsample=0.07,
              min_cloud_points=1500, seed=SEED + 42)
    t0 = time.perf_counter()
    train_loader = fdata.AmsVoxelLoader(str(scene), str(scene), str(DATA_DIR / "ams_train"),
                                        mode="train", cloud_ext=".laz", **kw)
    out["ams_train_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eval_loader = fdata.AmsVoxelLoader(str(scene), str(scene), str(DATA_DIR / "ams_test"),
                                       mode="test", include_all=True, cloud_ext=".las", **kw)
    out["ams_eval_build_s"] = time.perf_counter() - t0
    out["ams_items"] = {"train": len(train_loader), "eval": len(eval_loader)}
    assert len(train_loader) >= 2 and len(eval_loader) >= 1, out["ams_items"]
    for batch in fdata.batch_iterator(train_loader, len(train_loader), shuffle=True):
        check_batch(batch, [(len(train_loader), nc, 6), (len(train_loader), n, 6),
                            (len(train_loader), 1)], "AmsVoxelLoader train items")
    ams_eval = list(fdata.eval_batches(eval_loader, len(eval_loader)))
    b = len(eval_loader)
    check_batch(ams_eval[0], [(b, s, 6) if s else (b, 1) for s in
                              (nc, n, 0, nc, n, n, nc, n, nc, n, n)], "AmsVoxelLoader eval items")
    nats_ams, changed_ams = ft.evaluate_on_test(model, ams_eval, noise=make_noise(device))
    assert np.isfinite(nats_ams) and len(changed_ams) == b, (nats_ams, changed_ams)
    out["ams_eval"] = {"nats": nats_ams, "changed_fractions": changed_ams}
    assert native._lib is not None and Path(native._lib._name) == libs[0]
    assert laz._lib is not None and Path(laz._lib._name) == libs[1]
    log(f"data: native libraries {[p.name for p in libs]} in {out['native_build_s']:.2f} s; "
        f"FPS 2000 -> {nc} native {out['fps_native_ms']:.3f} ms, numpy "
        f"{out['fps_plain_ms']:.1f} ms, index-equal; AmsVoxelLoader on the street scene: "
        f"train (LAZ) {len(train_loader)} items built in {out['ams_train_build_s']:.2f} s, "
        f"include_all (LAS) {b} items in {out['ams_eval_build_s']:.2f} s, shapes and "
        f"values checked; evaluate_on_test on them: nats {nats_ams}, changed {changed_ams}")

    # (c) dulcet-universe trains and evaluates from the port's datasets
    rows = []

    class Rows(MetricWriter):
        def log(self, metrics, step=None):
            rows.append(dict(metrics))

    source = fdata.PrefetchedDataset(fdata.SyntheticVoxelDataset(
        n_items=2 * TIME_B, batch_size=TIME_B, sample_size=n, n_samples_context=nc,
        seed=SEED + 43))
    torch.cuda.synchronize()
    reset_counters()
    ft.train(model, source, generator=torch.Generator(device=device).manual_seed(SEED + 44),
             writer=Rows(), save_dir=str(DATA_DIR / "train"), run_name="data", max_steps=2,
             make_samples=False)
    torch.cuda.synchronize()
    launches, chains = read_counters(), CHAIN_ROUTES.read()
    check_routes(launches, chains, "train(max_steps=2) from SyntheticVoxelDataset",
                 attention=("attention wgmma", "attention_bwd wgmma"))
    check_flow_launches(chains, "train(max_steps=2) from SyntheticVoxelDataset", True)
    check_b5_launches(chains, "train(max_steps=2) from SyntheticVoxelDataset", True)
    check_b4_b2(chains, "train(max_steps=2) from SyntheticVoxelDataset")
    losses = [r["loss"] for r in rows]
    assert len(rows) == 2 and all(np.isfinite(losses)), losses
    assert all(launches[k] >= 1 for k in ("B5", "B6", "B1 with saves", "B3")), launches
    out["train"] = {"losses": losses, "step_ms": [1e3 * r["time_batch"] for r in rows],
                    "launches": {k: launches[k] for k in ("B1", "B1 with saves", "B3", "B4",
                                                          "B5", "B6")}}
    log(f"data: train(max_steps=2) at B={TIME_B} from PrefetchedDataset(SyntheticVoxelDataset):"
        f" {out['train']}")
    eval_src = fdata.SyntheticVoxelDataset(n_items=2 * TIME_B, batch_size=TIME_B, sample_size=n,
                                           n_samples_context=nc, include_all=True, mode="test",
                                           seed=SEED + 45)
    items = list(eval_src)
    out["eval_main_path"] = phase_main_path(ft, model, device, items=items)
    out["card_eval_item_ms"] = eval_item_ms(ft, model, items, device)
    out["card_train_step_ms"] = out["train"]["step_ms"][-1]

    # (e) host ms of a batch of each source beside the card's ms of an item
    reps = 3
    train_src = fdata.SyntheticVoxelDataset(n_items=reps * TIME_B, batch_size=TIME_B,
                                            sample_size=n, n_samples_context=nc, seed=SEED + 46)
    train_batches = iter(train_src)
    eval_batches = iter(fdata.SyntheticVoxelDataset(
        n_items=reps * TIME_B, batch_size=TIME_B, sample_size=n, n_samples_context=nc,
        include_all=True, mode="test", seed=SEED + 47))
    t0 = time.perf_counter()
    fdata.pack_dataset(train_src, str(DATA_DIR / "train.fcpack"))
    out["pack_s"] = time.perf_counter() - t0
    packed = iter(fdata.PackedVoxelDataset(str(DATA_DIR / "train.fcpack"), TIME_B, shuffle=True,
                                           seed=SEED))

    def ams_batch(r):
        picks = [eval_loader.get_item_all((r * TIME_B + i) % len(eval_loader))
                 for i in range(TIME_B)]
        return tuple(np.stack(parts) for parts in zip(*picks))

    host = {"synthetic_train": host_batch_ms(lambda r: next(train_batches), reps),
            "synthetic_eval": host_batch_ms(lambda r: next(eval_batches), reps),
            "ams_eval": host_batch_ms(ams_batch, reps),
            "packed_train": host_batch_ms(lambda r: next(packed), reps)}
    out["host_batch_ms"] = host
    out["phase_s"] = time.perf_counter() - t_phase
    med = {k: float(np.median(v)) for k, v in host.items()}
    log(f"data host ms a batch of {TIME_B} on {out['host_cpu']} ({out['host_cores']} cores), "
        f"{reps} batches each (median): synthetic train {host['synthetic_train']} "
        f"({med['synthetic_train']:.1f}), synthetic eval {host['synthetic_eval']} "
        f"({med['synthetic_eval']:.1f}), AmsVoxelLoader eval {host['ams_eval']} "
        f"({med['ams_eval']:.1f}), PackedVoxelDataset train {host['packed_train']} "
        f"({med['packed_train']:.2f}; packing {reps * TIME_B} items {out['pack_s']:.2f} s); "
        f"card ms an item (dulcet-universe B={TIME_B}): eval {out['card_eval_item_ms']:.2f}, "
        f"train step {out['card_train_step_ms']:.2f}; phase {out['phase_s']:.1f} s")
    return out


def summer_terrain_phase(ft, device) -> dict:
    """(d) of the data phase: summer-terrain (PAConv, no extra context) at
    full width and depth (B=25) evaluated from SyntheticVoxelDataset(
    with_extra=False, include_all=True) through evaluate_on_test, against
    the plain path (|d nats| <= 0.01, change maps >= 99.9%), with B8's,
    B9's and its gather's launches (2 / 2 / 8 for the two items), the host
    ms of one batch beside the card's ms of one item; then its sampling and
    training checks at full width and depth, the first to run PAConv with
    B7's and B5's extra=None branches: make_sample of 1 x 4000 against the
    plain samples of the same z (|d nats| <= 0.01; B7, B8, B9 and the
    gather launched, 1 / 1 / 4 of PAConv's), and one train_step at B=2
    through the kernels against the plain versions (|d nats| <= 0.01, grad
    norm within 5%, cosine >= 0.99; B5, B1 with saves and B8 launched, B8
    alone of PAConv's)."""
    import flowcompare_tpu_torch.data as fdata

    t_phase = time.perf_counter()
    model = make_model(ft, device, preset="summer-terrain")
    cfg = model.config
    log(f"model: summer-terrain bf16 (PAConv, no extra context), "
        f"{sum(p.numel() for p in model.parameters())} parameters, built in "
        f"{time.perf_counter() - t_phase:.1f} s")
    b = cfg["batch_size"]
    source = iter(fdata.SyntheticVoxelDataset(
        n_items=3 * b, batch_size=b, sample_size=cfg["sample_size"],
        n_samples_context=cfg["n_samples_context"], with_extra=False, include_all=True,
        mode="test", seed=SEED + 48))
    t0 = time.perf_counter()
    items = [next(source), next(source)]
    host_ms = 1e3 * (time.perf_counter() - t0) / 2
    launches = phase_main_path(ft, model, device, need=("B1", "B2", "B8", "B9", "sa_gather"),
                               items=items)
    assert launches["B3"] == launches["B4"] == launches["B10"] == 0, launches
    check_paconv_launches(launches, "summer-terrain's eval (2 items)", eval_embeds=2)
    out = {"batch": b, "eval_main_path": launches, "host_eval_batch_ms": host_ms,
           "card_eval_item_ms": eval_item_ms(ft, model, items, device)}
    t0 = time.perf_counter()
    out["sampling"] = phase_sample_main(ft, model, device, need=("B7", "B8", "B9", "sa_gather"))
    check_paconv_launches(out["sampling"]["launches"], "summer-terrain's make_sample",
                          eval_embeds=1)
    out["sampling"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["training"] = phase_train_check(ft, model, device, need=("B5", "B1 with saves", "B8"))
    check_paconv_launches(out["training"]["launches"], "summer-terrain's train_step",
                          eval_embeds=0, train_embeds=1)
    out["training"]["phase_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"summer-terrain B={b}: host ms a synthetic eval batch {host_ms:.1f}, card ms an eval "
        f"item {out['card_eval_item_ms']:.2f}; sampling check {out['sampling']['phase_s']:.1f} "
        f"s, training check {out['training']['phase_s']:.1f} s; phase {out['phase_s']:.1f} s")
    return out

# ------------------------------------------------------------------- the CLI

CLI_STEPS = 3          # train's steps through the CLI (the data init before them)
CLI_EVAL_ITEMS = 40    # evaluate's synthetic items: two of the preset's B=20
CLI_DIR = REPO / "build" / "chip_smoke_cli"


def run_cli(ft, argv: list, what: str) -> tuple:
    """One `flowcompare_tpu_torch.cli.main(argv)` call in this process, with
    the launch counters set to 0 just before it and read just after:
    (wall s, its standard output, launches, chain routes). Its output is
    captured and logged."""
    import contextlib
    import io

    from flowcompare_tpu_torch import cli

    out = io.StringIO()
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) is None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, chains = read_counters(), CHAIN_ROUTES.read()
    text = out.getvalue()
    log(f"cli {what}: `flowcompare-torch {' '.join(argv)}` in {wall:.2f} s; its output "
        f"(last 600 characters): {text[-600:]!r}")
    return wall, text, launches, chains


def phase_cli(ft, device, smi: str) -> dict:
    """The port's front door, swept-energy at full width and depth: the CLI
    (cli.main in this process, in a fresh directory under build/) trains
    CLI_STEPS steps at the preset's B=20 with --bf16 and --save-final; then
    evaluates CLI_EVAL_ITEMS synthetic items and samples 4,000 points from
    that checkpoint, each subcommand's launches read around it (B5, B6, B1
    with saves in training; B1-B4 in the eval; B7, B4, B3 in the sample,
    with the route, fused-layer, B5 and B4/B2 checks of the main paths).
    Then the same checkpoint through `compat.load_any_checkpoint`:
    evaluate_on_test(compute_reverse=True) on the kernels and on plain=True
    with the same noise (|d nats| <= 0.01, forward and reverse change maps
    agreeing on >= 99.9% of points), an eval item's ms and points/s, and
    `phase_sample_main` and `phase_train_check` on that model: swept-energy's
    sampling and training checks at full width (B5 and B7 with extra=None)."""
    import flowcompare_tpu_torch.data as fdata
    from flowcompare_tpu_torch.compat import load_any_checkpoint

    t_phase = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    run, seed = CLI_DIR / "run", str(SEED + 60)
    wall = {}
    wall["train"], _, launches, chains = run_cli(
        ft, ["train", "--config", "swept-energy", "--bf16", "--data", "synthetic", "--n-items",
             "60", "--steps", str(CLI_STEPS), "--save-final", "--save-dir", str(run),
             "--run-name", "cli", "--seed", seed], "train")
    check_routes(launches, chains, "the CLI's train",
                 attention=("attention wgmma", "attention_bwd wgmma"))
    train_launches = {**launches, "fused": check_flow_launches(chains, "the CLI's train", True),
                      "b5": check_b5_launches(chains, "the CLI's train", True),
                      "b4_b2": check_b4_b2(chains, "the CLI's train")}
    assert all(launches[k] >= CLI_STEPS for k in ("B5", "B6", "B1 with saves")), launches
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == CLI_STEPS and all(np.isfinite(r["loss"]) for r in rows), rows
    checkpoint = run / "cli_final.pt"
    assert checkpoint.exists(), sorted(p.name for p in run.iterdir())

    wall["evaluate"], text, launches, chains = run_cli(
        ft, ["evaluate", "--checkpoint", str(checkpoint), "--data", "synthetic", "--n-items",
             str(CLI_EVAL_ITEMS), "--seed", seed], "evaluate")
    printed = json.loads(text.strip().splitlines()[-1])
    assert set(printed) == {"nats", "mean_changed_fraction", "n_voxels"}, printed
    assert printed["n_voxels"] == CLI_EVAL_ITEMS and np.isfinite(printed["nats"]), printed
    assert 0.0 <= printed["mean_changed_fraction"] <= 1.0, printed
    check_routes(launches, chains, "the CLI's evaluate", attention=("attention wgmma",))
    eval_launches = {**launches, "fused": check_flow_launches(chains, "the CLI's evaluate", True),
                     "b4_b2": check_b4_b2(chains, "the CLI's evaluate")}
    assert all(launches[k] == 2 for k in ("B1", "B2", "B4")) and launches["B3"] == 8, launches
    assert launches["B2 folds"] == launches["B4 folds"] == 1, launches

    out_cloud = CLI_DIR / "sample"
    wall["sample"], text, launches, chains = run_cli(
        ft, ["sample", "--checkpoint", str(checkpoint), "--n-points", str(SAMPLE_N), "--out",
             str(out_cloud), "--data", "synthetic", "--n-items", "20", "--seed", seed], "sample")
    check_routes(launches, chains, "the CLI's sample", attention=("attention wgmma",))
    sample_launches = {**launches, "fused": check_flow_launches(chains, "the CLI's sample", True),
                       "b4_b2": check_b4_b2(chains, "the CLI's sample")}
    assert launches["B7"] == launches["B4"] == 1 and launches["B3"] == 4, launches
    written = text.strip().splitlines()[-1].removeprefix("wrote ")
    cloud = np.load(written)["points"] if written.endswith(".npz") else None
    assert cloud is None or (cloud.shape == (SAMPLE_N, 3) and np.isfinite(cloud).all()), written

    # the same checkpoint, loaded by the entry every subcommand uses
    t0 = time.perf_counter()
    cfg, model, ckpt = load_any_checkpoint(str(checkpoint), device)
    wall["load_any_checkpoint"] = time.perf_counter() - t0
    assert ckpt.kind == "port" and ckpt.step == CLI_STEPS and cfg["compute_dtype"] == "bfloat16"
    b = cfg["batch_size"]
    items = list(fdata.SyntheticVoxelDataset(
        n_items=2 * b, batch_size=b, sample_size=cfg["sample_size"],
        n_samples_context=cfg["n_samples_context"], with_extra=False, include_all=True,
        mode="test", seed=SEED + 61))
    noise = make_noise(device)
    maps = {}
    for plain in (False, True):
        model.plain = plain
        fwd, rev = [], []
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        nats, fr_fwd, fr_rev = ft.evaluate_on_test(model, items, noise=noise,
                                                   compute_reverse=True, change_maps=fwd,
                                                   reverse_maps=rev)
        torch.cuda.synchronize()
        maps[plain] = {"nats": nats, "fwd": fwd, "rev": rev, "fractions": (fr_fwd, fr_rev),
                       "s": time.perf_counter() - t0, "launches": read_counters()}
    model.plain = False
    (k, p) = maps[False], maps[True]
    agree = {d: float(torch.cat([(a > 0) == (c > 0) for a, c in zip(k[d], p[d])]).float().mean())
             for d in ("fwd", "rev")}
    reverse = {"nats_kernels": k["nats"], "nats_plain": p["nats"],
               "abs_d_nats": abs(k["nats"] - p["nats"]), "map_agreement": agree,
               "kernel_s": k["s"], "plain_s": p["s"], "launches": k["launches"],
               "changed_fractions": k["fractions"]}
    log(f"cli checkpoint, evaluate_on_test(compute_reverse=True), 2 items of B={b}: {reverse} "
        f"(|d nats| tolerance 0.01, map agreement >= 0.999 both ways)")
    assert all(k["launches"][key] == 2 for key in ("B1", "B2", "B4")), k["launches"]
    assert all(p["launches"][key] == 0 for key in ("B1", "B2", "B3", "B4")), p["launches"]
    assert len(k["fractions"][0]) == len(k["fractions"][1]) == 2 * b
    assert all(m.shape == (b, cfg["sample_size"]) for m in k["fwd"] + k["rev"])
    assert np.isfinite([k["nats"], p["nats"]]).all()
    assert reverse["abs_d_nats"] <= 0.01, "reverse-direction nats disagree with the plain path"
    assert min(agree.values()) >= 0.999, f"change maps disagree with the plain path: {agree}"
    item_ms = eval_item_ms(ft, model, items, device)
    sample = phase_sample_main(ft, model, device)
    check = phase_train_check(ft, model, device)
    del model
    torch.cuda.empty_cache()
    n = cfg["sample_size"]
    out = {"wall_s": wall, "eval_item_ms": item_ms, "points_per_s": 2 * b * n / (item_ms / 1e3),
           "printed": printed, "launches": {"train": train_launches, "evaluate": eval_launches,
                                            "sample": sample_launches},
           "reverse": reverse, "sample_check": sample, "train_check": check,
           "phase_s": time.perf_counter() - t_phase}
    log(f"cli phase timings ({smi}): " + json.dumps(
        {"wall_s": wall, "eval_item_ms": item_ms, "points_per_s": out["points_per_s"],
         "phase_s": out["phase_s"]}))
    return out


# ------------------------------------------------------------- flow variants

# (a): dulcet-universe's config with spline couplings and the
# ExponentialCombiner, at full width and depth
VARIANT = {"flow_type": "RationalQuadraticSplineCoupling", "permuter_type": "ExponentialCombiner"}
VARIANT_TRAIN_B = 4        # train()'s batch in (a); the preset's is 20
# the ExponentialCombiner's w at this share of the reference's N(0, I) init:
# at the reference's init 114 random matrix exponentials of 300 x 300 grow a
# typical vector by about e^151 (numpy, one seed), past float32's e^88, so
# neither package gives finite log-probs or samples from that init; at 0.1
# by about e^2.6 (log-probs near -5e4 a point), at 0.03 by about e^0.24. The
# scalar shifts inside the tanh bounds of the combiner and the exponential
# coupling stay at their init 0: a shift s adds s to every entry of W, an
# eigenvalue of s * width along the ones vector (300 * 0.01 = 3 a layer)
VARIANT_W_SCALE = 0.03
# (b): one row a variant at full width, 2 layers, one eval item of B=2
VARIANT_SWEEP = (
    ("exponential_coupling", "dulcet-universe", {"flow_type": "ExponentialCoupling"}),
    ("exp_scale", "dulcet-universe", {"affine_scale_fn": "exp"}),
    ("no_actnorm", "dulcet-universe", {"act_norm": False}),
    ("random_permute", "dulcet-universe", {"permuter_type": "random_permute"}),
    ("full_combiner", "dulcet-universe", {"permuter_type": "FullCombiner"}),
    ("standard_normal_augmenter", "dulcet-universe", {"augmenter_dist": "StandardNormal"}),
    ("conditional_augmenter", "dulcet-universe", {"use_attn_augment": False}),
    ("cif", "dulcet-universe", {"cif_latent_dim": 332, "extra_z_value_context": False}),
    ("relu_folded", "dulcet-universe", {"coupling_block_nonlinearity": "RELU"}),
    ("paconv_spline", "good-surf", {"flow_type": "RationalQuadraticSplineCoupling"}),
    ("identity_augmenter", "dulcet-universe", {"latent_dim": 6, "cif_latent_dim": 6}),
)
FLOW_KERNELS = ("B1", "B1 with saves", "B2", "B5", "B7")


def make_variant_model(ft, device, preset: str, **overrides):
    """make_model, with the matrix exponentials' weights kept in range
    (VARIANT_W_SCALE)."""
    model = make_model(ft, device, preset=preset, **overrides)
    with torch.no_grad():
        for name, p in model.state_dict().items():
            if name.endswith(("permuter.shift", "coupling.shift")):
                p.zero_()
        if model.permuter_type == "ExponentialCombiner":
            model.layers.permuter.w.mul_(VARIANT_W_SCALE)
    return model


def variant_eval(ft, model, items, device) -> dict:
    """evaluate_on_test with the kernels and with plain=True on the same
    noise: nats, |d nats| <= 0.01, change-map agreement, the kernels'
    launches (counters set to 0 just before the kernels' run) and its ms an
    item."""
    noise = make_noise(device)
    maps_k, maps_p = [], []
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    nats_k, fr_k = ft.evaluate_on_test(model, items, noise=noise, change_maps=maps_k)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / len(items)
    launches = read_counters()
    model.plain = True
    nats_p, _ = ft.evaluate_on_test(model, items, noise=noise, change_maps=maps_p)
    model.plain = False
    agree = float(torch.cat([(a > 0) == (b > 0) for a, b in zip(maps_k, maps_p)]).float().mean())
    out = {"nats": nats_k, "nats_plain": nats_p, "abs_d_nats": abs(nats_k - nats_p),
           "change_agreement": agree, "changed_fractions": fr_k, "first_item_ms": ms,
           "launches": {k: v for k, v in launches.items() if v}}
    assert np.isfinite(nats_k) and np.isfinite(nats_p), out
    assert abs(nats_k - nats_p) <= 0.01, f"nats disagree with the plain path: {out}"
    assert launches["gemm wmma"] == launches["attention wmma"] == 0, launches
    return out


def variant_round_trip(model, device, seed: int) -> float:
    """max |h - inverse(forward(h))| of the float32 unfolded layer stack on a
    B=2 item's 0.6 * N(0, I) latents, on the embedding of random clouds."""
    cfg = model.config
    g = torch.Generator(device=device).manual_seed(seed)
    n = cfg["sample_size"]
    x0 = torch.randn((2, cfg["n_samples_context"], 6), generator=g, device=device)
    h = SAMPLE_STD * torch.randn((2, n, model.latent_dim), generator=g, device=device)
    extra = (torch.randn((2, 1, 1), generator=g, device=device).expand(2, n, 1)
             if cfg["using_extra_context"] else None)
    with torch.no_grad():
        ctx, _ = model.embed(x0)
        ctx = ctx.float()
        params, dtype = model.params(), model.compute_dtype
        model.compute_dtype = None
        try:
            z, _ = model._layers_unfolded(params, h, torch.zeros(2, n, device=device), ctx,
                                          extra, None)
            back = model._sample_unfolded(params, z, ctx, extra)
        finally:
            model.compute_dtype = dtype
    assert torch.isfinite(z).all() and torch.isfinite(back).all()
    return float((back - h).abs().max())


def phase_variants(ft, device, dulcet_item_s: float) -> dict:
    """The flow variants no preset uses, at full width on the card (the
    previous model freed first; each model freed after its part).

    (a) dulcet-universe's config with RationalQuadraticSplineCoupling and
    ExponentialCombiner (bf16, 115 layers, latent 300, hidden 512, k=40):
    evaluate_on_test on SyntheticVoxelDataset (2 items of B=4) against
    plain=True (|d nats| <= 0.01, change maps >= 99.9%), B4 and B3
    launched and none of B1, B2, B5, B7; the eval's ms an item and points/s
    at the preset's B=20 beside dulcet-universe's (`dulcet_item_s`, this
    call); one make_sample of 1 x 4000 (finite, no B7); train(max_steps=2)
    at B=VARIANT_TRAIN_B (reduced from 20: finite losses, B6 launched, B1
    with saves and B5 not).

    (b) a sweep at full width, 2 layers, one eval item of B=2: the variants
    of VARIANT_SWEEP, each held to its plain path within 0.01 nats with
    finite nats, the float32 layer stack's round trip within 1e-3 max-abs
    (CIF excluded: its slices draw again), B2, B5 and B7 launched on no
    row and B1 exactly where the config takes the kernels' route
    (`_kernel_route`: the affine / LinearLU / ActNorm / GELU family under
    bf16, whatever its augmenter), so not on the RELU row."""
    import flowcompare_tpu_torch.data as fdata
    from flowcompare_tpu_torch.train.metrics import MetricWriter

    t_phase = time.perf_counter()
    model = make_variant_model(ft, device, "dulcet-universe", **VARIANT)
    cfg = model.config
    log(f"model: dulcet-universe bf16 with {VARIANT}, {sum(p.numel() for p in model.parameters())}"
        f" parameters, built in {time.perf_counter() - t_phase:.1f} s")

    def synthetic(b, n_items, seed):
        return list(itertools.islice(fdata.SyntheticVoxelDataset(
            n_items=n_items * b, batch_size=b, sample_size=cfg["sample_size"],
            n_samples_context=cfg["n_samples_context"], include_all=True, mode="test",
            seed=seed), n_items))

    full = {"eval": variant_eval(ft, model, synthetic(EVAL_B, 2, SEED + 60), device)}
    launches = full["eval"]["launches"]
    assert launches.get("B4", 0) > 0 and launches.get("B3", 0) > 0, launches
    assert not any(launches.get(k) for k in FLOW_KERNELS), launches
    assert full["eval"]["change_agreement"] >= 0.999, full["eval"]
    items = synthetic(TIME_B, 3, SEED + 61)
    noise = make_noise(device)
    ft.evaluate_on_test(model, items[:1], noise=noise)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ft.evaluate_on_test(model, items[1:], noise=noise)
    torch.cuda.synchronize()
    item_s = (time.perf_counter() - t0) / 2
    full["timing"] = {"batch": TIME_B, "item_ms": 1e3 * item_s,
                      "points_per_s": 2 * TIME_B * cfg["sample_size"] / item_s,
                      "dulcet_universe_item_ms": 1e3 * dulcet_item_s,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"variant (a) eval at B={TIME_B}: {full['timing']}")
    g = torch.Generator(device=device).manual_seed(SEED + 62)
    x0 = torch.randn((1, cfg["n_samples_context"], 6), generator=g, device=device)
    extra = torch.randn((1, 1), generator=g, device=device)
    reset_counters()
    t0 = time.perf_counter()
    x = ft.make_sample(model, SAMPLE_N, x0, extra, generator=g)
    torch.cuda.synchronize()
    launches = read_counters()
    full["sample"] = {"ms": 1e3 * (time.perf_counter() - t0), "shape": list(x.shape),
                      "max_abs": float(x.abs().max()),
                      "launches": {k: v for k, v in launches.items() if v}}
    log(f"variant (a) make_sample 1x{SAMPLE_N}: {full['sample']}")
    assert x.shape == (1, SAMPLE_N, 6) and torch.isfinite(x).all(), full["sample"]
    assert launches["B4"] > 0 and not any(launches[k] for k in FLOW_KERNELS), launches
    rows = []

    class Rows(MetricWriter):
        def log(self, metrics, step=None):
            rows.append(dict(metrics))

    save_dir = REPO / "build" / "chip_smoke_variant"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    ft.train(model, train_batches(cfg, VARIANT_TRAIN_B, 2, SEED + 63),
             generator=torch.Generator(device=device).manual_seed(SEED + 64), writer=Rows(),
             save_dir=str(save_dir), run_name="variant", max_steps=2, make_samples=False)
    torch.cuda.synchronize()
    launches = read_counters()
    full["train"] = {"batch": VARIANT_TRAIN_B,
                     "reduced": f"batch {VARIANT_TRAIN_B} of the preset's {cfg['batch_size']}",
                     "train_s": time.perf_counter() - t0, "losses": [r["loss"] for r in rows],
                     "step_ms": [1e3 * r["time_batch"] for r in rows],
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "launches": {k: v for k, v in launches.items() if v}}
    log(f"variant (a) train(max_steps=2): {full['train']}")
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows), rows
    assert launches["B6"] > 0 and not any(launches[k] for k in FLOW_KERNELS), launches
    del model
    torch.cuda.empty_cache()

    sweep = {}
    for name, preset, overrides in VARIANT_SWEEP:
        t0 = time.perf_counter()
        model = make_variant_model(ft, device, preset, n_flow_layers=2, **overrides)
        row = variant_eval(ft, model, eval_items(model.config, 2, 1, SEED + 65), device)
        launches = row["launches"]
        kernels = model._kernel_route()
        assert bool(launches.get("B1")) == kernels, (name, launches)
        assert not any(launches.get(k) for k in ("B2", "B5", "B7")), (name, launches)
        assert launches.get("B4" if preset == "dulcet-universe" else "B8"), (name, launches)
        if not model.is_cif:
            row["round_trip_max_abs"] = variant_round_trip(model, device, SEED + 66)
            assert row["round_trip_max_abs"] <= 1e-3, (name, row)
        row.update(route="kernels" if kernels else
                   "folded_scan_core" if model._can_fold_scan() else "unfolded",
                   row_s=time.perf_counter() - t0)
        log(f"variant sweep {name} ({preset}, {overrides}): {row}")
        sweep[name] = row
        del model
        torch.cuda.empty_cache()
    out = {"full": full, "sweep": sweep, "phase_s": time.perf_counter() - t_phase}
    log(f"variant phase: {out['phase_s']:.1f} s")
    return out

# ------------------------------------------------- routes from the shapes

# Three small bf16 configs (dulcet-universe at 2 layers, B=2) outside the
# kernels' shape limits, and the parts each must send to the plain route
C1_B = 2
C1_CASES = (
    ("D = 32", {"cross_dim_head": 32}, ("stack", "augmenter")),
    ("1,024-wide coupling MLP", {"hidden_dims": [1024, 1024, 1024]}, ("stack", "augmenter")),
    ("k = 80", {"n_neighbors": 80}, ("encoder",)),
)
# the kernels of each part, by the counters: none may launch where the part
# is refused, each part on its kernels launches on the path that runs it
C1_PART_KERNELS = {"stack": {"eval": ("B1",), "train": ("B5", "B1 with saves"),
                             "sample": ("B7",)},
                   "augmenter": {"eval": ("B2",), "train": (), "sample": ()},
                   "encoder": {"eval": ("B4", "B3"), "train": ("B6",), "sample": ("B4", "B3")}}


def _c1_check_launches(name: str, routes: dict, path: str, launches: dict) -> None:
    for part, kernels in C1_PART_KERNELS.items():
        for k in kernels[path]:
            if routes[part] == "kernels":
                assert launches[k] >= 1, (name, path, part, k, launches)
            else:
                assert launches[k] == 0, (name, path, part, k, launches)


def phase_c1(ft, device) -> dict:
    """Configs outside the kernels' shapes on the card (ROADMAP queue C1):
    D = 32, a 1,024-wide coupling MLP and k = 80, each a bf16
    dulcet-universe at 2 layers and full width, B=2. Each prints its routes
    and must refuse the expected parts; its log_prob (inner_loop eval), one
    train_step after the data init and one make_sample of 1 x 4000 run on
    CUDA tensors, each held to the same model with plain=True on the same
    noise (|d nats| <= 0.01; the samples scored by the eval path), with the
    counters showing the refused parts' kernels never launched and the
    others' launched."""
    from flowcompare_tpu_torch.model import inner_loop

    out = {}
    for name, overrides, refused in C1_CASES:
        t0 = time.perf_counter()
        model = make_model(ft, device, n_flow_layers=2, **overrides)
        cfg, routes = model.config, dict(model.routes)
        log(f"C1 {name}: routes {routes}")
        assert {p for p, r in routes.items() if r != "kernels"} == set(refused), (name, routes)
        rng = np.random.default_rng(SEED + 80)
        batch = tuple(torch.as_tensor(a, device=device) for a in (
            rng.normal(size=(C1_B, cfg["n_samples_context"], 6)).astype(np.float32),
            rng.normal(size=(C1_B, cfg["sample_size"], 6)).astype(np.float32),
            rng.normal(size=(C1_B, 1)).astype(np.float32)))
        gen = torch.Generator(device=device).manual_seed(SEED + 81)
        shape = (C1_B, cfg["sample_size"], cfg["latent_dim"] - cfg["input_dim"])
        eps_init, eps = (torch.randn(shape, generator=gen, device=device) for _ in range(2))
        z = SAMPLE_STD * torch.randn((1, SAMPLE_N, cfg["latent_dim"]), generator=gen,
                                     device=device)
        row = {"routes": routes}
        # eval: inner_loop through the kernels' routes, then plain
        nats = []
        for plain in (False, True):
            model.plain = plain
            reset_counters()
            nats.append(float(inner_loop(model, batch, eps=eps)[2]))
            if not plain:
                _c1_check_launches(name, routes, "eval", read_counters())
        row["eval"] = {"nats": nats, "abs_d_nats": abs(nats[0] - nats[1])}
        # one train_step from the data init's state, kernels then plain
        model.plain = False
        ft.data_init_from_batch(ft.init_train_state(model), batch, eps=eps_init)
        snapshot = {k: v.clone() for k, v in model.state_dict().items()}
        steps = []
        for plain in (False, True):
            model.load_state_dict(snapshot)
            model.plain = plain
            reset_counters()
            _, step = ft.train_step(ft.init_train_state(model), batch, eps=eps)
            if not plain:
                _c1_check_launches(name, routes, "train", read_counters())
            steps.append(step)
        model.load_state_dict(snapshot)
        row["train"] = {"kernels": steps[0], "plain": steps[1],
                        "abs_d_nats": abs(steps[0]["nats"] - steps[1]["nats"]),
                        "grad_norm_ratio": steps[0]["grad_norm"] / steps[1]["grad_norm"]}
        # one make_sample of 1 x 4000 from the same z, both scored by the eval path
        xs = []
        for plain in (False, True):
            model.plain = plain
            reset_counters()
            xs.append(ft.make_sample(model, SAMPLE_N, batch[0][:1], batch[2][:1], z=z))
            if not plain:
                _c1_check_launches(name, routes, "sample", read_counters())
        model.plain = False
        eps_s = torch.randn((1, SAMPLE_N, cfg["latent_dim"] - cfg["input_dim"]), generator=gen,
                            device=device)
        snats = [float(inner_loop(model, (batch[0][:1], x, batch[2][:1]), eps=eps_s)[2])
                 for x in xs]
        row["sample"] = {"nats": snats, "abs_d_nats": abs(snats[0] - snats[1]),
                         "max_abs_dx": float((xs[0] - xs[1]).abs().max())}
        row["phase_s"] = time.perf_counter() - t0
        log(f"C1 {name}: {row} (|d nats| tolerance 0.01)")
        assert all(torch.isfinite(x).all() for x in xs), name
        assert np.isfinite(nats + snats + [steps[0]["loss"], steps[1]["loss"]]).all(), row
        for path in ("eval", "train", "sample"):
            assert row[path]["abs_d_nats"] <= 0.01, (name, path, row[path])
        out[name] = row
        del model
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ the convergence demo

DEMO = REPO / "examples" / "convergence_demo_torch.py"
DEMO_AUC_MIN = 0.95          # and loss last8 < first8 (PERF.md, set before the first run)
# the routes each run must read (the demo's config at its cross_dim_head)
DEMO_RUNS = (("D = 32", 32, REPO / "build" / "chip_smoke_demo", ("stack", "augmenter")),
             ("D = 64", 64, REPO / "build" / "chip_smoke_demo_d64", ()))


def _finite_gap(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(max |a - b| over the points finite in both, the points that are not)."""
    ok = torch.isfinite(a).all(-1) & torch.isfinite(b).all(-1)
    gap = float((a - b)[ok].abs().max()) if ok.any() else float("nan")
    return gap, int((~ok).sum())


def round_trip_by_layer(model, device, seed: int) -> dict:
    """The bf16 round trips through the folded stack on `model`'s weights,
    layer by layer (one-layer folded slices), on the kernels (B7, B1) and
    on their plain versions, conditioned on a synthetic scene's context
    cloud: "z": z ~ 0.6 N(0, I) (1 x SAMPLE_N) -> inverse -> forward, the
    inverse's state h_l (after layers L-1 .. l) against the forward's after
    layers 0 .. l-1 run from the inverse's x; "x": the
    scene's augmented target cloud -> forward -> inverse, the forward's
    state x_l against the inverse's h_l. Each layer's max |gap| over the
    points finite on both sides, and the points that are not."""
    import flowcompare_tpu_torch.data as fdata
    from flowcompare_tpu_torch.ops import flow_layer_cuda as flc

    cfg = model.config
    item = next(iter(fdata.SyntheticVoxelDataset(
        n_items=1, batch_size=1, sample_size=cfg["sample_size"],
        n_samples_context=cfg["n_samples_context"], mode="train", seed=seed)))
    x0, x1, extra = (torch.as_tensor(a, device=device) for a in item)
    g = torch.Generator(device=device).manual_seed(seed)
    z = SAMPLE_STD * torch.randn((1, SAMPLE_N, cfg["latent_dim"]), generator=g, device=device)
    out = {}
    with torch.no_grad():
        emb, _ = model.embed(x0[..., :cfg["input_dim"]])
        params = model.params()
        folded_inv = model._folded_inverse(params, 1)
        eps = torch.randn((1, x1.shape[1], cfg["latent_dim"] - cfg["input_dim"]), generator=g,
                          device=device)
        ex1 = extra[:, None, :].expand(1, x1.shape[1], 1)
        xa, _ = model._augment_fwd(params["augmenter"], eps, x1[..., :cfg["input_dim"]], emb, ex1)
        n_layers = folded_inv["lu_ldj_f"].shape[0]
        for route, inverse, forward in (
                ("kernels", flc.fused_flow_layers_inverse, flc.fused_flow_layers),
                ("plain", flc.fused_flow_layers_inverse_plain, flc.fused_flow_layers_plain)):
            row = {}
            for trip, start in (("z", z), ("x", xa.float())):
                ext = extra[:, None, :].expand(1, start.shape[1], 1)
                zeros = torch.zeros(1, start.shape[1], device=device)
                layer = [flc.layer_slice(folded_inv, l) for l in range(n_layers)]
                if trip == "z":
                    h, inv = start, [None] * n_layers
                    for l in reversed(range(n_layers)):
                        h = inverse(h, emb, ext, layer[l])
                        inv[l] = h
                    x, fwd = h, []
                    for l in range(n_layers):
                        fwd.append(x)
                        x, _ = forward(x, zeros, emb, ext, layer[l])
                    end = x
                else:
                    x, fwd = start, []
                    for l in range(n_layers):
                        fwd.append(x)
                        x, _ = forward(x, zeros, emb, ext, layer[l])
                    h, inv = x, [None] * n_layers
                    for l in reversed(range(n_layers)):
                        h = inverse(h, emb, ext, layer[l])
                        inv[l] = h
                    end = h
                gaps = [_finite_gap(f, i) for f, i in zip(fwd, inv)]
                row[trip] = {"gap_by_layer": [gp for gp, _ in gaps],
                             "nonfinite_points_by_layer": [k for _, k in gaps],
                             "end_gap": _finite_gap(end, start)}
            out[route] = row
    return out


def phase_demo(ft, device) -> dict:
    """examples/convergence_demo_torch.py on the card, twice, each in a
    process of its own: at the JAX demo's cross_dim_head 32 (the layer stack
    and the augmenter on the plain route, the DGCNN on B4, B3 and B6) and at
    64 (every part on its kernels: 240 steps through B1 with saves and B5's
    backward). Each run must learn (loss last8 < first8), score change
    (AUC >= DEMO_AUC_MIN), read the routes it expects and launch the
    kernels of its routes; then the D = 64 run's checkpoint gives the round
    trip's gap layer by layer (`round_trip_by_layer`)."""
    out = {}
    for name, d, where, plain_parts in DEMO_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(DEMO), "--out", str(where),
                               "--cross-dim-head", str(d)], capture_output=True, text=True)
        log(f"demo {name}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s\n"
            f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        assert proc.returncode == 0, f"the demo at {name} failed"
        result = json.loads((where / "result.json").read_text())
        result["process_s"] = time.perf_counter() - t0
        log(f"demo {name}: {result}")
        assert {p for p, r in result["routes"].items() if r != "kernels"} == set(plain_parts), \
            result["routes"]
        train, ev = result["launches"]["train"], result["launches"]["eval"]
        stack = "stack" not in plain_parts
        assert (train["B5"] > 0) == stack and (train["B1 with saves"] > 0) == stack, train
        assert (ev["B1"] > 0) == stack and (ev["B2"] > 0) == ("augmenter" not in plain_parts), ev
        assert train["B6"] > 0 and ev["B4"] > 0 and ev["B3"] > 0, (train, ev)
        assert result["loss_last8"] < result["loss_first8"], "the demo did not learn"
        assert result["auc"] >= DEMO_AUC_MIN, f"the demo's AUC {result['auc']}"
        out[name] = result
    _, model, _ = ft.load_any_checkpoint(str(DEMO_RUNS[1][2] / "demo_final.pt"), device=device)
    out["round_trip_d64"] = round_trip_by_layer(model, device, SEED + 90)
    log(f"round trip z -> B7 -> B1 -> z' on the D = 64 demo's checkpoint, layer by layer: "
        f"{out['round_trip_d64']}")
    del model
    torch.cuda.empty_cache()
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

    global CHAIN_ROUTES
    CHAIN_ROUTES = ChainRoutes()
    b10, b10_entry_point = phase_b10(device)
    torch.cuda.empty_cache()
    gemm_entries, gemm_cases = phase_gemm()
    torch.cuda.empty_cache()
    attention_entries, attention_cases = phase_attention()
    torch.cuda.empty_cache()
    with torch.no_grad():
        fused_entries, fused_cases = phase_fused_layers(ft, device)
        torch.cuda.empty_cache()
        b5_fused = phase_b5_fused(ft, device, "dulcet-universe", TIME_B)
    b5_entries = b5_kernel_entries(b5_fused)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = make_model(ft, device)
    log(f"model: dulcet-universe bf16, {sum(p.numel() for p in model.parameters())} "
        f"parameters, built in {time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        main_bounds = phase_main_bounds(model)
        entries = phase_kernels(ft, model, device)
        knn_split = phase_knn_split()
    launches = phase_main_path(ft, model, device)
    timing = phase_timing(ft, model, device)
    eval_profile = phase_eval_profile(ft, model, device, TIME_B, "chip_smoke_eval_trace.json")
    sample_main = phase_sample_main(ft, model, device)
    sample_timing = phase_sample_timing(ft, model, device)
    sample_profile = phase_sample_profile(ft, model, device)
    check = phase_train_check(ft, model, device)
    train_main, data = phase_train_main(ft, model, device)
    split = phase_train_split(ft, model, data, device)
    profile = phase_profile(ft, model, data, device)
    # each kernel's launches from the main path it serves: eval for B1-B4
    # and the kernels of B4's and B2's chains, training for B5 and B6,
    # sampling for B7, good-surf's eval for B8 and B9
    served = {**{k: launches[k] for k in ("B1", "B2", "B3", "B4", "dgcnn_tail", "augment_net",
                                          "pack_rows")},
              "B5": train_main["launches"]["B5"], "B6": train_main["launches"]["B6"],
              "B7": sample_main["launches"]["B7"]}
    for key, entry in entries.items():
        entry["launches"] = served[key]
    # the GEMMs' launches on the wgmma route: the eval main path's for
    # gemm_bf16, the training main path's for gemm_tn
    gemm_entries["gemm_bf16"]["launches"] = launches["gemm wgmma"]
    # the attention's: the eval main path's forward, the training path's backward
    attention_entries["cross_attention"]["launches"] = launches["attention wgmma"]
    attention_entries["cross_attention_bwd"]["launches"] = train_main["launches"][
        "attention_bwd wgmma"]
    # the fused layers': the eval main path's conditioner and coupling_layer,
    # the sampling main path's coupling_inverse
    fused_entries["conditioner"]["launches"] = launches["conditioner"]
    fused_entries["coupling_layer"]["launches"] = launches["coupling_layer"]
    fused_entries["coupling_inverse"]["launches"] = sample_main["launches"]["coupling_inverse"]
    # B5's kernels': the training main path's; gemm_tn's too (0 since B5's
    # fusion took it off every preset's path; the per-product chain's
    # launches of it, the comparison route's, stand beside them)
    for key, entry in b5_entries.items():
        entry["launches"] = train_main["launches"][key]
    gemm_entries["gemm_tn"]["launches"] = train_main["launches"]["gemm_tn wgmma"]
    gemm_entries["gemm_tn"]["comparison_route_launches"] = b5_fused[
        "per_product_gemm_tn_launches"]
    data = phase_data(ft, model, device)
    del model
    torch.cuda.empty_cache()
    paconv_entries, good_surf = good_surf_phases(ft, device)
    entries.update(paconv_entries)
    torch.cuda.empty_cache()
    global_checks, helpful_sponge, b5_global = helpful_sponge_phases(ft, device)
    for key, chk in global_checks.items():
        entries[key]["global"] = chk
    torch.cuda.empty_cache()
    swept_energy = swept_energy_phases(ft, device)
    torch.cuda.empty_cache()
    cli = phase_cli(ft, device, smi)
    torch.cuda.empty_cache()
    data["summer_terrain"] = summer_terrain_phase(ft, device)
    data["phase_s"] += data["summer_terrain"]["phase_s"]
    log(f"data phase (with summer-terrain's): {data['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    variants = phase_variants(ft, device, timing["item_s"])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    c1 = phase_c1(ft, device)
    log(f"C1 phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    demo = phase_demo(ft, device)
    log(f"demo phase: {time.perf_counter() - t0:.1f} s")
    entries["B10"] = b10
    print(json.dumps({"main_path": timing, "eval_profile": eval_profile,
                      "sampling": {"main_path": sample_main,
                                                        "timing": sample_timing,
                                                        "profile": sample_profile},
                      "training": {"check": check, "main_path": train_main, "split": split,
                                   "profile": profile},
                      "good_surf": good_surf, "helpful_sponge": helpful_sponge,
                      "swept_energy": swept_energy, "cli": cli, "data": data,
                      "variants": variants, "c1": c1, "demo": demo,
                      "b10": b10_entry_point, "gemm": gemm_cases, "attention": attention_cases,
                      "fused_layers": fused_cases, "main_path_bounds": main_bounds,
                      "knn_split": knn_split,
                      "b5_fused": b5_fused,
                      "wall_s": time.perf_counter() - T_START}))
    entries.update(gemm_entries)
    entries.update(attention_entries)
    entries.update(fused_entries)
    for key, chk in b5_global.items():
        b5_entries[key]["global"] = chk
    entries.update(b5_entries)
    print(json.dumps({"kernels": [entries[k] for k in ("B1", "B2", "B3", "B4", "B5", "B6",
                                                       "B7", "B8", "B9", "sa_gather", "B10",
                                                       "gemm_bf16",
                                                       "gemm_tn", "cross_attention",
                                                       "cross_attention_bwd", "conditioner",
                                                       "coupling_layer", "coupling_inverse",
                                                       *B5_KERNELS, "dgcnn_tail", "augment_net",
                                                       "pack_rows")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
