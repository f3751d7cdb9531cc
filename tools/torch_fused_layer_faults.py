#!/usr/bin/env python3
"""How far the fused layer kernels (flowcompare_tpu_torch/csrc/fused_layer.cu)
land from their plain versions on the card: as built, and with one rounding
fault planted in a copy of the kernel's source, so the checks of
chip_smoke.py's fused-layer phase and tests/test_torch_port_cuda.py can sit
between the two.

    python3 tools/torch_fused_layer_faults.py [--workdir DIR] [--out FILE] [--only TEXT]
                                              [--phase RUN] [--nats RUN]

Faults, each built from a copy of csrc/ under --workdir (default: a new
temporary directory), planted in the fused_layer* source that holds the
anchor (the kernel body is csrc/fused_layer_kernel.cuh, shared by the
one-pass and the wide kernels):
  carry_bf16  the f32 carry rounded to bf16 where it is stored (B1's x,
              B7's y and, at layer 0, x): the rounding B7 must never do
  st_bf16     [s | t] rounded to bf16 before the affine (the chain keeps
              them in f32)
  ln_bf16     the LayerNorm's input rounded to bf16 (the chain normalises
              the last pre-MLP product in f32)

Cases: chip_smoke.py's fused-layer shapes with its weights (LinearLU,
ActNorm and BatchNorm moved off identity by 1e-3 to 1e-2) and the card
tests' shapes with theirs (moved by 0.1): each kernel on two full-width
layers, and B1 with saves and B7 through their entry points at 1 x 4000;
"w1024" is dulcet-universe at twice its MLP widths (chip_smoke.W1024, the
wide kernels), "w2048" at four times with a 1,024-wide latent and LayerNorm
row (chip_smoke.W2048: K in two halves, the row-wise epilogues over two
passes). --only keeps the cases whose name holds TEXT (--only none: no
case). --nats RUN (e.g. w2048) also reads, for each variant, chip_smoke.py's
RUN model at full depth: its eval main path's and its training check's
|d nats| (and grad norm ratio) against the plain route, the checks that
`chip_smoke.nats_tolerance` bounds. --phase RUN (e.g.
w2048) first runs chip_smoke.py's fused-layer phase at RUN's shapes alone
with its limits read instead of held: each kind's and the per-product
route's statistics against plain, and both routes' device ms.
Each output's error is `chip_smoke.error_stats` of the kernel's result
against the plain version's, the worst over the layers. Prints one line a
variant and case, and writes every number as JSON to --out. Needs one
NVIDIA H100 and nvcc; imports nothing of JAX.
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

import chip_smoke  # noqa: E402
import flowcompare_tpu_torch as ft  # noqa: E402
from flowcompare_tpu_torch.ops import _build, flow_layer_cuda as flc  # noqa: E402

# (anchor, replacement) pairs in csrc/fused_layer*, planted wherever they stand
BF = "__bfloat162float(f2bf({}))"
FAULTS = {
    "carry_bf16": [
        ("*reinterpret_cast<float2*>(T + row * ldt + col) = make_float2(v0, v1);",
         f"*reinterpret_cast<float2*>(T + row * ldt + col) = make_float2({BF.format('v0')}, "
         f"{BF.format('v1')});"),
        ("dst[(size_t)gr * ldd + col + k] = v[k];",
         f"dst[(size_t)gr * ldd + col + k] = {BF.format('v[k]')};"),
        ("if (!to_y) io.x[(size_t)gr * io.ldx + split + i] = out;",
         f"if (!to_y) io.x[(size_t)gr * io.ldx + split + i] = {BF.format('out')};"),
        ("if (gr < M) io.x[(size_t)gr * io.ldx + c] = io.y[(size_t)gr * io.ldy + c];",
         f"if (gr < M) io.x[(size_t)gr * io.ldx + c] = "
         f"{BF.format('io.y[(size_t)gr * io.ldy + c]')};"),
    ],
    "st_bf16": [
        ("if (i >= half) return;\n",
         f"if (i >= half) return;\n          v0 = {BF.format('v0')};\n"
         f"          v1 = {BF.format('v1')};\n"),
    ],
    "ln_bf16": [
        ("[&](int, int, int h, float v0, float v1) {\n            s1[h] += v0 + v1;",
         f"[&](int, int, int h, float v0, float v1) {{\n            v0 = {BF.format('v0')};\n"
         f"            v1 = {BF.format('v1')};\n            s1[h] += v0 + v1;"),
        ("[&](int row, int col, int h, float v0, float v1) {\n            st_pair(Y, row, col, "
         "col < n ? (v0 - mean[h]) * inv[h] : 0.f,",
         f"[&](int row, int col, int h, float v0, float v1) {{\n            v0 = {BF.format('v0')};"
         f"\n            v1 = {BF.format('v1')};\n            st_pair(Y, row, col, "
         "col < n ? (v0 - mean[h]) * inv[h] : 0.f,"),
        ("[&](int, int, int h, float v0, float v1) {\n            ln_s1[h] += v0 + v1;",
         f"[&](int, int, int h, float v0, float v1) {{\n            v0 = {BF.format('v0')};\n"
         f"            v1 = {BF.format('v1')};\n            ln_s1[h] += v0 + v1;"),
        ("[&](int row, int col, int h, float v0, float v1) {\n              st_pair(Y, row, col, "
         "col < n ? (v0 - mean[h]) * inv[h] : 0.f,",
         f"[&](int row, int col, int h, float v0, float v1) {{\n              v0 = "
         f"{BF.format('v0')};\n              v1 = {BF.format('v1')};\n              "
         "st_pair(Y, row, col, col < n ? (v0 - mean[h]) * inv[h] : 0.f,"),
    ],
}

LAYER_CASES = [("smoke", "dulcet-universe", 40960), ("smoke", "dulcet-universe", 20480),
               ("smoke", "dulcet-universe", chip_smoke.SAMPLE_N),
               ("smoke", "helpful-sponge", 51200), ("test", "dulcet-universe", 4000),
               ("test", "dulcet-universe", 1037), ("test", "swept-energy", 4000),
               ("test", "helpful-sponge", 1000), ("test", "good-surf", 40960),
               ("smoke", "w1024", 40960), ("test", "w1024", 4000), ("smoke", "w2048", 40960),
               ("test", "w2048", 4000)]
CHAIN_CASES = [("smoke", "dulcet-universe"), ("smoke", "helpful-sponge"),
               ("test", "dulcet-universe"), ("test", "helpful-sponge"), ("test", "w1024"),
               ("test", "w2048")]


def perturb_test(model, gen, lu: float = 0.1) -> None:
    """tests/test_torch_port_cuda.py's perturb_identity_leaves."""
    with torch.no_grad():
        for name, p in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("lower_entries", "upper_entries"):
                p.add_(lu * torch.randn(p.shape, generator=gen).to(p.device))
            elif leaf in ("unconstrained_upper_diag", "shift", "log_scale", "mean"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen).to(p.device))
            elif leaf == "var":
                p.copy_(0.5 + torch.rand(p.shape, generator=gen).to(p.device))
            elif name.endswith("bn.scale"):
                p.copy_((torch.sign(torch.randn(p.shape, generator=gen))
                         * (0.5 + torch.rand(p.shape, generator=gen))).to(p.device))


def b7_lu_noise(lat: int) -> float:
    """tests/test_torch_port_cuda.py's b7_lu_noise: the chains' B7 moves the
    LinearLU's entries by 0.1 x sqrt(300 / lat) past a latent of 300."""
    return 0.1 * min(1.0, (300 / lat) ** 0.5)


def make_model(setup: str, preset: str, dev, b7: bool = False):
    """A case's two-layer model; with `b7`, the test setup's LinearLU moved
    by `b7_lu_noise` (the chains' B7)."""
    cfg = chip_smoke.smoke_config(ft, preset)
    cfg.update(compute_dtype="bfloat16", n_flow_layers=2)
    seed = chip_smoke.SEED if setup == "smoke" else 0
    model = ft.FlowCompareModel(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    if setup == "smoke":
        chip_smoke.perturb_identity_leaves(model, torch.Generator().manual_seed(seed + 1))
    else:
        perturb_test(model, torch.Generator().manual_seed(seed + 1),
                     lu=b7_lu_noise(cfg["latent_dim"]) if b7 else 0.1)
    ed = int(cfg["using_extra_context"])
    with torch.no_grad():
        folded, folded_inv = model._folded(model.params(), ed), model._folded_inverse(
            model.params(), ed)
    return cfg, model, folded, folded_inv


def inputs(cfg, model, rows: int, g, dev):
    e, lat = cfg["input_embedding_dim"], cfg["latent_dim"]

    def rand(*shape):
        return torch.randn(shape, generator=g).to(dev)

    ctx = (rand(1, 1, e).bfloat16().expand(1, rows, e) if model.is_global
           else rand(1, 1250, e).bfloat16())
    extra = rand(1, rows, 1) if cfg["using_extra_context"] else None
    return ctx, extra, rand


def layer_case(setup: str, preset: str, rows: int, dev) -> dict:
    """The chains and inputs of one case, made once with the kernels as built."""
    cfg, model, folded, folded_inv = make_model(setup, preset, dev)
    lat, bf = cfg["latent_dim"], torch.bfloat16
    split = lat // 2
    ctx, extra, rand = inputs(cfg, model, rows, torch.Generator().manual_seed(40 + rows), dev)
    lu = (flc._pad_cols(folded["lu_w_f"].transpose(1, 2).to(bf)),
          folded["lu_b"].float().reshape(2, -1).contiguous())
    minv = (flc._pad_cols(folded_inv["lu_w_inv_f"].transpose(1, 2).to(bf)),
            folded_inv["lu_shift"].float().reshape(2, -1).contiguous())
    fwd = flc._CouplingChain(folded, ctx, extra, rows, split, tail=lu, lat=lat)
    inv = flc._CouplingChain(folded_inv, ctx, extra, rows, split, tail=minv, lat=lat)
    for chain in (fwd, inv):
        chain.xin[:, :split] = rand(rows, split)
        if chain.has_attn:
            chain.xin[:, chain.xc:chain.xc + chain.cw] = rand(rows, chain.cw)
    return {"fwd": fwd, "inv": inv, "split": split, "lat": lat, "rows": rows,
            "lu_ldj": folded["lu_ldj_f"].float().contiguous(), "x": rand(rows, lat),
            "ldj": rand(rows), "y": rand(rows, lat)}


def worst(out: dict, key: str, stats: dict) -> None:
    if key not in out:
        out[key] = stats
    else:
        out[key] = {k: max(v, stats[k]) for k, v in out[key].items()}


def run_layers(c: dict) -> dict:
    """Each kernel on both layers against its plain version."""
    fwd, inv, split, lat, rows = c["fwd"], c["inv"], c["split"], c["lat"], c["rows"]
    lu_ldj, out = c["lu_ldj"], {}
    for l in range(2):
        if fwd.has_attn:
            q_ref = torch.empty_like(fwd.q)
            flc.conditioner_plain(fwd.xin, split, fwd.cond_stack.layer(l), q_ref)
            _build.conditioner(fwd.xin, split, fwd.cond_stack, l, fwd.q)
            worst(out, "conditioner q", chip_smoke.error_stats(fwd.q, q_ref))
        xin_r, xr, lr = fwd.xin.clone(), c["x"].clone(), c["ldj"].clone()
        save_r = torch.empty(rows, lat, dtype=torch.bfloat16, device=xr.device)
        flc.coupling_layer_plain(xin_r, split, fwd.cpl_stack.layer(l), xr, lr, lu_ldj[l:l + 1],
                                 save=save_r, eps_affine=1e-8)
        xin_k, xk, lk = fwd.xin.clone(), c["x"].clone(), c["ldj"].clone()
        save_k = torch.empty_like(save_r)
        _build.coupling_layer(xin_k, split, fwd.cpl_stack, l, xk, lk, lu_ldj[l:l + 1],
                              save=save_k, eps_affine=1e-8)
        for key, got, ref in (("x", xk, xr), ("ldj", lk, lr), ("save", save_k, save_r),
                              ("x1 columns", xin_k[:, :split], xin_r[:, :split])):
            worst(out, f"coupling_layer {key}", chip_smoke.error_stats(got, ref))
    for l, with_x in ((1, False), (0, True)):
        xin_r, xin_k = inv.xin.clone(), inv.xin.clone()
        yr, yk = c["y"].clone(), c["y"].clone()
        xr = torch.empty_like(yr) if with_x else None
        xk = torch.empty_like(yr) if with_x else None
        pairs = inv.cpl_stack.layer(l)[:inv.cpl_stack.n_mlp]
        if not with_x:
            pairs = pairs + [inv.cpl_stack.layer(l - 1)[-1]]
        flc.coupling_inverse_plain(xin_r, split, pairs, yr, x=xr, eps_affine=1e-8)
        _build.coupling_inverse(xin_k, split, inv.cpl_stack, l, yk, x=xk, eps_affine=1e-8)
        if with_x:
            worst(out, "coupling_inverse x (layer 0)", chip_smoke.error_stats(xk, xr))
        else:
            worst(out, "coupling_inverse y", chip_smoke.error_stats(yk, yr))
            worst(out, "coupling_inverse x1 columns",
                  chip_smoke.error_stats(xin_k[:, :split], xin_r[:, :split]))
    torch.cuda.synchronize()
    return out


def chain_case(setup: str, preset: str, dev) -> dict:
    cfg, model, folded, _ = make_model(setup, preset, dev)
    _, _, _, folded_inv = make_model(setup, preset, dev, b7=True)
    ctx, extra, rand = inputs(cfg, model, 4000, torch.Generator().manual_seed(42), dev)
    x = rand(1, 4000, cfg["latent_dim"])
    return {"folded": folded, "folded_inv": folded_inv, "ctx": ctx, "extra": extra, "x": x,
            "ldj": torch.zeros(1, 4000, device=dev)}


def run_chain(c: dict) -> dict:
    """B1 with saves and B7 through their entry points, two layers, 1 x 4000."""
    with torch.no_grad():
        z, l, saves = flc.fused_flow_layers(c["x"], c["ldj"], c["ctx"], c["extra"], c["folded"],
                                            save=True)
        xi = flc.fused_flow_layers_inverse(0.6 * c["x"], c["ctx"], c["extra"], c["folded_inv"])
        zr, lr, sr = flc.fused_flow_layers_plain(c["x"], c["ldj"], c["ctx"], c["extra"],
                                                 c["folded"], save=True)
        xr = flc.fused_flow_layers_inverse_plain(0.6 * c["x"], c["ctx"], c["extra"],
                                                 c["folded_inv"])
    torch.cuda.synchronize()
    return {"B1 z": chip_smoke.error_stats(z, zr), "B1 ldj": chip_smoke.error_stats(l, lr),
            "B1 saves": chip_smoke.error_stats(saves, sr), "B7 x": chip_smoke.error_stats(xi, xr)}


def nats_case(run: str, dev) -> dict:
    """chip_smoke.py's `run` model at full depth (chip_smoke.WIDE_RUNS) with
    the inputs of its eval main path (two items of B=20 and its noise) and
    of its training check (B=2 after the data init), and the plain route's
    nats on both, read once: the plain route runs no kernel."""
    model = chip_smoke.make_model(ft, dev, **chip_smoke.WIDE_RUNS[run])
    cfg = model.config
    items = chip_smoke.eval_items(cfg, chip_smoke.TIME_B, 2, chip_smoke.SEED + 3)
    noise = chip_smoke.make_noise(dev)
    batch = chip_smoke._to_device(chip_smoke.train_batches(cfg, chip_smoke.TRAIN_CHECK_B, 1,
                                                           chip_smoke.SEED + 10)[0], dev)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 11)
    shape = (chip_smoke.TRAIN_CHECK_B, cfg["sample_size"], cfg["latent_dim"] - cfg["input_dim"])
    eps_init = torch.randn(shape, generator=gen, device=dev)
    c = {"model": model, "items": items, "noise": noise, "batch": batch,
         "eps": torch.randn(shape, generator=gen, device=dev),
         "weights": {k: v.cpu() for k, v in model.state_dict().items()}}
    ft.data_init_from_batch(ft.init_train_state(model), batch, eps=eps_init)
    c["inited"] = {k: v.clone() for k, v in model.state_dict().items()}
    c["plain"] = run_nats(c, plain=True)
    return c


def run_nats(c: dict, plain: bool = False) -> dict:
    """The eval main path's nats and the training check's step (nats, grad
    norm) through the kernels (or the plain route), from the case's weights."""
    model = c["model"]
    model.plain = plain
    try:
        model.load_state_dict(c["weights"])
        with torch.no_grad():
            nats, _ = ft.evaluate_on_test(model, c["items"], noise=c["noise"])
        model.load_state_dict(c["inited"])
        _, row = ft.train_step(ft.init_train_state(model), c["batch"], eps=c["eps"])
        model.zero_grad(set_to_none=True)
    finally:
        model.plain = False
    out = {"eval nats": float(nats), "train nats": float(row["nats"]),
           "train grad_norm": float(row["grad_norm"])}
    if not plain:
        p = c["plain"]
        out.update({"eval |d nats|": abs(out["eval nats"] - p["eval nats"]),
                    "train |d nats|": abs(out["train nats"] - p["train nats"]),
                    "grad_norm ratio": out["train grad_norm"] / p["train grad_norm"]})
    return out


def phase_readings(run: str, dev) -> dict:
    """chip_smoke.phase_fused_layers at `run`'s cases alone, check_fused
    reading its statistics instead of holding them to a limit."""
    held = chip_smoke.check_fused
    chip_smoke.check_fused = lambda what, got, ref, kind, limits=None: chip_smoke.error_stats(
        got, ref)
    try:
        with torch.no_grad():
            _, out = chip_smoke.phase_fused_layers(ft, dev, presets=(run,))
    finally:
        chip_smoke.check_fused = held
    return {case: {kind: {key: r[key] for key in ("errors", "per_product_errors", "device_ms",
                                                  "per_product_ms", "plain_ms", "bound_ms")}
                   for kind, r in c.items() if isinstance(r, dict) and "errors" in r}
            for case, c in out.items()}


def use_sources(csrc: Path, build_dir: Path) -> None:
    """Build and load the library from `csrc` (a fault's copy, or the repo's)."""
    _build.CSRC, _build.BUILD_DIR, _build._LIB = csrc, build_dir, None
    _build.library()


def plant(csrc: Path, fault: list) -> None:
    """Each (anchor, replacement) of `fault` wherever the anchor stands in
    the fused_layer* sources of `csrc` (an epilogue of the one-pass and
    wide tiers and its copy in the wider tier alike), at least once."""
    for anchor, planted in fault:
        hits = 0
        for path in sorted(csrc.glob("fused_layer*")):
            text = path.read_text()
            hits += text.count(anchor)
            path.write_text(text.replace(anchor, planted))
        assert hits >= 1, anchor


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", type=Path, default=None,
                        help="where the faults' copies of csrc/ are built (default: a new "
                             "temporary directory, removed at the end)")
    parser.add_argument("--out", type=Path, default=REPO / "chiprun_out" / "fused_faults.json")
    parser.add_argument("--only", default="", help="run only the cases whose name holds this")
    parser.add_argument("--phase", default="", help="read chip_smoke's fused-layer phase at "
                                                    "this run's shapes first")
    parser.add_argument("--nats", default="", help="also read this run's eval and training "
                                                   "|d nats| against plain at full depth")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    work = args.workdir or Path(tempfile.mkdtemp(prefix="fused_faults_"))
    src_dir, build_dir = _build.CSRC, _build.BUILD_DIR
    _build.library()
    results = {}
    if args.phase:
        results["phase"] = phase_readings(args.phase, dev)
        print("phase", args.phase, json.dumps(results["phase"]), flush=True)
    layer_cases = {f"{s} {p} {r}": layer_case(s, p, r, dev) for s, p, r in LAYER_CASES
                   if args.only in f"{s} {p} {r}"}
    chain_cases = {f"{s} {p} chains 4000": chain_case(s, p, dev) for s, p in CHAIN_CASES
                   if args.only in f"{s} {p} chains 4000"}
    nats = nats_case(args.nats, dev) if args.nats else None
    if nats is not None:
        results[f"plain | {args.nats} nats"] = nats["plain"]
        print("plain |", args.nats, "nats", json.dumps(nats["plain"]), flush=True)
    try:
        for variant in ["as built", *FAULTS]:
            if variant == "as built":
                use_sources(src_dir, build_dir)
            else:
                csrc = work / variant / "csrc"
                shutil.copytree(src_dir, csrc, dirs_exist_ok=True)
                plant(csrc, FAULTS[variant])
                use_sources(csrc, work / variant / "build")
            for name, c in layer_cases.items():
                results[f"{variant} | {name}"] = run_layers(c)
                print(variant, "|", name, json.dumps(results[f"{variant} | {name}"]), flush=True)
            for name, c in chain_cases.items():
                results[f"{variant} | {name}"] = run_chain(c)
                print(variant, "|", name, json.dumps(results[f"{variant} | {name}"]), flush=True)
            if nats is not None:
                key = f"{variant} | {args.nats} nats"
                results[key] = run_nats(nats)
                print(key, json.dumps(results[key]), flush=True)
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
