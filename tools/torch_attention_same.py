#!/usr/bin/env python3
"""Whether two trees' attention kernels give the same D = 64 results on the
card: cross_attention (with m and den), its backward and B10's
fused_attention_core at 20 x 1024 queries x 1250 keys and 1 x 4000 x 1250,
on inputs made from a seed.

    python3 tools/torch_attention_same.py --tree DIR --out FILE
    python3 tools/torch_attention_same.py --compare FILE_A FILE_B

The first form imports the port from DIR (a checkout, e.g. an earlier
commit's `git archive` unpacked into build/), runs the kernels and saves
their outputs with torch.save; run it once a tree, each in a process of
its own. The second prints, for every output, whether the two files hold it
bit for bit and the largest difference, and exits non-zero if any differs.
Needs one NVIDIA H100 and nvcc for the first form; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

SHAPES = ((20, 1024, 1250), (1, 4000, 1250))
D = 64


def run(tree: Path, out: Path) -> None:
    sys.path.insert(0, str(tree))
    from flowcompare_tpu_torch.ops import _build, attention_cuda
    assert Path(_build.__file__).resolve().is_relative_to(tree.resolve()), _build.__file__
    results = {}
    for items, nq, nkv in SHAPES:
        g = torch.Generator().manual_seed(items * nq + nkv)
        q = (torch.randn(items * nq, D, generator=g) / D ** 0.5).bfloat16().cuda()
        kv = torch.randn(items * nkv, 2 * D, generator=g).bfloat16().cuda()
        k, v = kv[:, :D], kv[:, D:]
        da = torch.randn(items * nq, D, generator=g).cuda()
        o = torch.empty(items * nq, D, device="cuda", dtype=torch.bfloat16)
        m, den = (torch.empty(items * nq, device="cuda") for _ in range(2))
        _build.cross_attention(q, k, v, o, n_items=items, m_out=m, den_out=den)
        du = torch.empty_like(o)
        ddn = torch.empty(items * nq, device="cuda")
        _build.attn_bwd_prep(da, o, den, du, ddn)
        dq, dkv = torch.empty(items * nq, D, device="cuda"), torch.empty(items * nkv, 2 * D,
                                                                          device="cuda")
        dq_b, dkv_b = dq.bfloat16(), dkv.bfloat16()
        _build.attention_bwd(q, k, v, du, ddn, m, dq, dq_b, dkv, dkv_b, n_items=items)
        core = attention_cuda.fused_attention_core(q.view(items, nq, D), k.view(items, nkv, D),
                                                   v.view(items, nkv, D), D ** -0.5)
        torch.cuda.synchronize()
        key = f"{items}x{nq}x{nkv}"
        results.update({f"{key} {name}": t.cpu() for name, t in (
            ("out", o), ("m", m), ("den", den), ("dq", dq), ("dkv", dkv), ("B10", core))})
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"card": torch.cuda.get_device_name(0), "results": results}, out)
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
