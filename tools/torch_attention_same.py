#!/usr/bin/env python3
"""Whether two trees' attention kernels give the same results at the head
widths D = 32, 64, 128, 256, 384 and 512 on the card (every tile of the
one-block and wide kernels), and their device times:
cross_attention (with m and den), its backward and B10's
fused_attention_core at 20 x 1024 queries x 1250 keys and 1 x 4000 x 1250,
on inputs made from a seed.

    python3 tools/torch_attention_same.py --tree DIR --out FILE
    python3 tools/torch_attention_same.py --compare FILE_A FILE_B

The first form imports the port from DIR (a checkout, e.g. an earlier
commit's `git archive` unpacked into build/), runs the kernels, saves their
outputs with torch.save and prints each kernel's device ms (chip_smoke's
`device_ms`: torch.profiler, 10 calls after a warm-up) by width and shape;
run it once a tree, each in a process of its own, and alternate the trees
in one call (parent, change, change, parent) to compare the times. The
second form prints, for every output, whether the two files hold it bit
for bit and the largest difference, and both files' device ms, and exits
non-zero if any output differs. Needs one NVIDIA H100 and nvcc for the
first form; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
SHAPES = ((20, 1024, 1250), (1, 4000, 1250))
WIDTHS = (32, 64, 128, 256, 384, 512)


def run(tree: Path, out: Path) -> None:
    sys.path.insert(0, str(tree))
    from flowcompare_tpu_torch.ops import _build, attention_cuda
    assert Path(_build.__file__).resolve().is_relative_to(tree.resolve()), _build.__file__
    sys.path.insert(1, str(REPO))
    from chip_smoke import device_ms

    results, ms = {}, {}
    for d in WIDTHS:
        for items, nq, nkv in SHAPES:
            g = torch.Generator().manual_seed(items * nq + nkv + d)
            q = (torch.randn(items * nq, d, generator=g) / d ** 0.5).bfloat16().cuda()
            kv = torch.randn(items * nkv, 2 * d, generator=g).bfloat16().cuda()
            k, v = kv[:, :d], kv[:, d:]
            da = torch.randn(items * nq, d, generator=g).cuda()
            o = torch.empty(items * nq, d, device="cuda", dtype=torch.bfloat16)
            m, den = (torch.empty(items * nq, device="cuda") for _ in range(2))

            def fwd():
                _build.cross_attention(q, k, v, o, n_items=items, m_out=m, den_out=den)

            fwd()
            du = torch.empty_like(o)
            ddn = torch.empty(items * nq, device="cuda")
            _build.attn_bwd_prep(da, o, den, du, ddn)
            dq = torch.empty(items * nq, d, device="cuda")
            dkv = torch.empty(items * nkv, 2 * d, device="cuda")
            dq_b, dkv_b = dq.bfloat16(), dkv.bfloat16()

            def bwd():
                _build.attention_bwd(q, k, v, du, ddn, m, dq, dq_b, dkv, dkv_b, n_items=items)

            q3, k3, v3 = (t.reshape(items, -1, d) for t in (q, k, v))

            def core():
                return attention_cuda.fused_attention_core(q3, k3, v3, d ** -0.5)

            bwd()
            b10 = core()
            torch.cuda.synchronize()
            key = f"d{d} {items}x{nq}x{nkv}"
            results.update({f"{key} {name}": t.cpu() for name, t in (
                ("out", o), ("m", m), ("den", den), ("dq", dq), ("dkv", dkv), ("B10", b10))})
            ms.update({f"{key} forward": device_ms(fwd), f"{key} backward": device_ms(bwd),
                       f"{key} B10": device_ms(core)})
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"card": torch.cuda.get_device_name(0), "results": results, "device_ms": ms}, out)
    print(json.dumps({"tree": str(tree), "device_ms": ms}))
    print(f"saved {len(results)} outputs of {tree} to {out}")


def compare(a: Path, b: Path) -> int:
    fa, fb = torch.load(a), torch.load(b)
    ra, rb = fa["results"], fb["results"]
    same = True
    for key in ra:
        x, y = ra[key], rb[key]
        equal = torch.equal(x, y)
        same &= equal
        print(f"{key}: bit-equal {equal}, max |d| {float((x.float() - y.float()).abs().max())}")
    for key, t in fa["device_ms"].items():
        print(f"{key}: device ms {t} against {fb['device_ms'][key]}")
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
