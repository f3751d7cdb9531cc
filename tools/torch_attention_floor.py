#!/usr/bin/env python3
"""How far the cross attention's m, den and output lie from their contract
evaluated in float64, for the kernels and for the plain version, on the
card test's cross-item inputs (items after the first hold large queries and
keys, scores about 1,150 x sqrt(64 / D); values of standard size) at 3
items of 70 queries against 90 and 1,250 keys, at head widths 64 to 512.

    python3 tools/torch_attention_floor.py [--out FILE]

The contract (`_build.cross_attention_plain`): per item s = q k^T, m its
row maximum, e = exp(s - m), out = bf16((bf16(e) v) / sum(e)), den =
sum(e). The plain version computes s in f32, as does the kernel; the
float64 evaluation from the same bf16 operands is the yardstick. Prints one
JSON line per shape (den's largest relative error, m's largest absolute
error and the output's, for each) and writes them all to FILE (default
build/attention_floor.json). Needs one NVIDIA H100 and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
WIDTHS = (64, 128, 192, 256, 384, 512)


def inputs(d: int, nkv: int, seed: int):
    """q, k and v as the card test's `attention_inputs(big_next=True)` lays
    them out (3 items of 70 queries), in the chains' layout."""
    from flowcompare_tpu_torch.ops.flow_layer_cuda import bf16_rows, kv_layout

    items, nq = 3, 70
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(items * nq, d, generator=g) / d ** 0.5
    kv = torch.randn(items * nkv, 2 * d, generator=g)
    q[nq:] = q[nq:] * 4 + 3 * (64 / d) ** 1.5
    kv[nkv:, :d] = kv[nkv:, :d] * 4 + 6
    v0, width = kv_layout(d)
    laid = torch.zeros(items * nkv, width)
    laid[:, :d], laid[:, v0:] = kv[:, :d], kv[:, d:]
    qq = bf16_rows(items * nq, d, "cuda").copy_(q.bfloat16().cuda())
    kk = bf16_rows(items * nkv, width, "cuda").copy_(laid.bfloat16().cuda())
    return qq, kk[:, :d], kk[:, v0:v0 + d]


def f64(q, k, v, items: int):
    d = q.shape[1]
    qf, kf, vf = (t.double().reshape(items, -1, d) for t in (q, k, v))
    s = qf @ kf.transpose(1, 2)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    den = e.sum(-1, keepdim=True)
    out = ((e.bfloat16().double() @ vf) / den).reshape(-1, d)
    return out.bfloat16().double(), m.reshape(-1), den.reshape(-1)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=REPO / "build" / "attention_floor.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from flowcompare_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    for d in WIDTHS:
        for nkv in (90, 1250):
            q, k, v = inputs(d, nkv, seed=70 + nkv)
            exact = f64(q, k, v, 3)
            row = {}
            for name, fn in (("kernel", _build.cross_attention),
                             ("plain", _build.cross_attention_plain)):
                out = torch.empty(q.shape, device="cuda", dtype=torch.bfloat16)
                m, den = (torch.empty(q.shape[0], device="cuda") for _ in range(2))
                fn(q, k, v, out, n_items=3, m_out=m, den_out=den)
                row[name] = {
                    "den_rel": float(((den.double() - exact[2]).abs() / exact[2]).max()),
                    "m_abs": float((m.double() - exact[1]).abs().max()),
                    "out_abs": float((out.double() - exact[0]).abs().max())}
            key = f"d{d} 3x70x{nkv}"
            results[key] = row
            print(key, json.dumps(row), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": torch.cuda.get_device_name(0), "results": results},
                                   indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
