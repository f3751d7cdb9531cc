#!/usr/bin/env python3
"""Whether two trees' fused layer kernels give the same results at the
presets' shapes on the card, and their device times: on dulcet-universe's
and helpful-sponge's full widths and w1024's (chip_smoke.W1024: the wide
kernels at 1,024-wide MLPs; two-layer stacks from a seed, bf16) the
conditioner, coupling_layer (with saves) and coupling_inverse (with the
chained LU inverse) at an eval item's rows (40,960 / 51,200), B5 at a
training step's rows (20,480 / 25,600: conditioner_record, coupling_record,
coupling_bwd and conditioner_bwd inside flow_layers_bwd), B4's tail
(dgcnn_tail) at 50,000 rows and B2's net (augment_net) at 40,960, on inputs
made from a seed.

    python3 tools/torch_fused_same.py --tree DIR --out FILE
    python3 tools/torch_fused_same.py --compare FILE_A FILE_B

The first form imports the port from DIR (a checkout, e.g. an earlier
commit's `git archive` unpacked into build/), runs the kernels, saves their
outputs with torch.save and prints each kernel's device ms (torch.profiler,
10 calls after a warm-up; B5's kernels from one trace of 10 calls, per
launch). Run it once a tree, each in a process of its own, and alternate
the trees in one call (parent, change, change, parent) to compare the
times. The second form prints, for every output, whether the two files hold
it bit for bit and the largest difference, and exits non-zero if any
differs. Needs one NVIDIA H100 and nvcc for the first form; imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
CASES = (("dulcet-universe", 40960, 20480), ("helpful-sponge", 51200, 25600),
         ("w1024", 40960, 20480))
TAIL_ROWS, AUG_ROWS = 50000, 40960
KIND = re.compile(r"(fused_layer(?:_bwd)?_kernel)(?:<|ILi)(\d)")


def _model(ft, preset: str, dev):
    from chip_smoke import perturb_identity_leaves, smoke_config
    cfg = smoke_config(ft, preset)
    cfg.update(compute_dtype="bfloat16", n_flow_layers=2)
    model = ft.FlowCompareModel(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    perturb_identity_leaves(model, torch.Generator().manual_seed(1))
    return model


def run(tree: Path, out: Path) -> None:
    sys.path.insert(0, str(tree))
    import flowcompare_tpu_torch as ft
    from flowcompare_tpu_torch.ops import _build, dgcnn_cuda, flow_layer_cuda as flc
    from flowcompare_tpu_torch.ops import flow_layer_vjp_cuda as fv
    assert Path(_build.__file__).resolve().is_relative_to(tree.resolve()), _build.__file__
    sys.path.insert(1, str(REPO))
    from chip_smoke import device_ms, traced_kernels

    dev, bf = torch.device("cuda"), torch.bfloat16
    results, ms = {}, {}
    for preset, rows, train_rows in CASES:
        model = _model(ft, preset, dev)
        cfg = model.config
        ed, lat, e = int(cfg["using_extra_context"]), cfg["latent_dim"], cfg["input_embedding_dim"]
        split = lat // 2
        with torch.no_grad():
            folded = model._folded(model.params(), ed)
            folded_inv = model._folded_inverse(model.params(), ed)
        g = torch.Generator().manual_seed(rows)

        def rand(*shape):
            return torch.randn(shape, generator=g).to(dev)

        lu = (flc._pad_cols(folded["lu_w_f"].transpose(1, 2).to(bf)),
              folded["lu_b"].float().reshape(2, -1).contiguous())
        minv = (flc._pad_cols(folded_inv["lu_w_inv_f"].transpose(1, 2).to(bf)),
                folded_inv["lu_shift"].float().reshape(2, -1).contiguous())
        ctx = (rand(1, 1, e).bfloat16().expand(1, rows, e) if model.is_global
               else rand(1, 1250, e).bfloat16())
        extra = rand(1, rows, 1) if ed else None
        fwd = flc._CouplingChain(folded, ctx, extra, rows, split, tail=lu, lat=lat)
        inv = flc._CouplingChain(folded_inv, ctx, extra, rows, split, tail=minv, lat=lat)
        for chain in (fwd, inv):
            chain.xin[:, :split] = rand(rows, split)
            if chain.has_attn:
                chain.xin[:, chain.xc:chain.xc + chain.cw] = rand(rows, chain.cw)
        x, ldj, y = rand(rows, lat), rand(rows), rand(rows, lat)
        lu_ldj = folded["lu_ldj_f"].float().contiguous()
        key = f"{preset} {rows}"
        if fwd.has_attn:
            _build.conditioner(fwd.xin, split, fwd.cond_stack, 0, fwd.q)
            results[f"{key} conditioner q"] = fwd.q.cpu()
            ms[f"{key} conditioner"] = device_ms(
                lambda: _build.conditioner(fwd.xin, split, fwd.cond_stack, 0, fwd.q))
        xin, xk, lk = fwd.xin.clone(), x.clone(), ldj.clone()
        save = torch.empty(rows, lat, dtype=bf, device=dev)
        _build.coupling_layer(xin, split, fwd.cpl_stack, 0, xk, lk, lu_ldj[0:1], save=save,
                              eps_affine=1e-8)
        for name, t in (("x", xk), ("ldj", lk), ("save", save), ("x1 columns", xin[:, :split])):
            results[f"{key} coupling_layer {name}"] = t.cpu()
        xw, lw = x.clone(), ldj.clone()
        ms[f"{key} coupling_layer"] = device_ms(lambda: _build.coupling_layer(
            fwd.xin, split, fwd.cpl_stack, 0, xw, lw, lu_ldj[0:1], eps_affine=1e-8))
        xin, yk = inv.xin.clone(), y.clone()
        _build.coupling_inverse(xin, split, inv.cpl_stack, 1, yk, eps_affine=1e-8)
        results[f"{key} coupling_inverse y"] = yk.cpu()
        results[f"{key} coupling_inverse x1 columns"] = xin[:, :split].cpu()
        yw = y.clone()
        ms[f"{key} coupling_inverse"] = device_ms(lambda: _build.coupling_inverse(
            inv.xin, split, inv.cpl_stack, 1, yw, eps_affine=1e-8))
        del fwd, inv

        # B5 at the training rows, its kernels from one trace
        items = train_rows // cfg["sample_size"]
        n = cfg["sample_size"]
        tctx = (rand(items, 1, e).bfloat16().expand(items, n, e) if model.is_global
                else rand(items, 1250, e).bfloat16())
        textra = rand(items, n, 1) if ed else None
        tx = rand(items, n, lat)
        _, _, saves = flc.fused_flow_layers(tx, torch.zeros(items, n, device=dev), tctx, textra,
                                            folded, save=True)
        args = (saves, rand(items, n, lat), rand(items, n), tctx, textra, folded)
        got = fv.flow_layers_bwd(*args)
        key = f"{preset} {train_rows}"
        for name, t in zip(("dx", "dctx", "dextra"), got[:3]):
            if t is not None:
                results[f"{key} B5 {name}"] = t.cpu()
        for name, t in got[3].items():
            results[f"{key} B5 {name}"] = t.cpu()
        kinds = {"0": "conditioner_record", "3": "coupling_record"}
        bwd_kinds = {"0": "coupling_bwd", "1": "conditioner_bwd"}
        per = {}
        for ev in traced_kernels(lambda: fv.flow_layers_bwd(*args), 10):
            m = KIND.search(ev["name"])
            if not m:
                continue
            name = (bwd_kinds if "bwd" in m.group(1) else kinds).get(m.group(2), m.group(0))
            total, count = per.get(name, (0.0, 0))
            per[name] = (total + ev["dur"] / 1e3, count + 1)
        for name, (total, count) in per.items():
            ms[f"{key} {name}"] = total / count
        del saves, got
        torch.cuda.empty_cache()

        # B4's tail and B2's net at the preset's widths
        w = dgcnn_cuda.encoder_weights(model.params()["embedder"], model.state.tree()["embedder"],
                                       cast=bf)
        stack = w.tail(not model.is_global)
        feats = rand(TAIL_ROWS, 512).bfloat16()
        tail = torch.empty(TAIL_ROWS, stack.pairs[-1][0].shape[2], dtype=bf, device=dev)
        _build.dgcnn_tail(feats, stack, w.scale, tail)
        results[f"{preset} {TAIL_ROWS} dgcnn_tail"] = tail.cpu()
        ms[f"{preset} {TAIL_ROWS} dgcnn_tail"] = device_ms(
            lambda: _build.dgcnn_tail(feats, stack, w.scale, tail))
        aw = flc.augmenter_weights(model.params()["augmenter"], input_dim=6, extra_dim=ed)
        xin = rand(AUG_ROWS, aw.width).bfloat16()
        xin[:, aw.xe:aw.xc] = 0
        xa, eps = rand(AUG_ROWS, 6), rand(AUG_ROWS, lat - 6)
        z, zl = torch.empty(AUG_ROWS, lat, device=dev), torch.empty(AUG_ROWS, device=dev)
        _build.augment_net(xin, aw.net_stack, xa, eps, z, zl)
        results[f"{preset} {AUG_ROWS} augment_net z"] = z.cpu()
        results[f"{preset} {AUG_ROWS} augment_net ldj"] = zl.cpu()
        ms[f"{preset} {AUG_ROWS} augment_net"] = device_ms(
            lambda: _build.augment_net(xin, aw.net_stack, xa, eps, z, zl))
        del model
        torch.cuda.empty_cache()
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"card": torch.cuda.get_device_name(0), "results": results, "device_ms": ms}, out)
    print(json.dumps({"tree": str(tree), "device_ms": ms}))
    print(f"saved {len(results)} outputs of {tree} to {out}")


def compare(a: Path, b: Path) -> int:
    ra, rb = torch.load(a)["results"], torch.load(b)["results"]
    same = set(ra) == set(rb)
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
