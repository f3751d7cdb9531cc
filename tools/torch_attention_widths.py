#!/usr/bin/env python3
"""What the D = 32 cross attention forward loses to its zero-filled columns
on the card: the kernel as built (csrc/cross_attention.cu at D = 32 reads
a 64-column box whose columns 32-63 TMA zero-fills, and runs P V as m64n64
products whose 32 zero columns are never stored) against a copy of csrc/
with P V planted as m64n32 products over the box's first 32 columns.

    python3 tools/torch_attention_widths.py [--workdir DIR] [--out FILE]

Both builds run in this process in turns (as built, planted, planted, as
built; `_build.CSRC` swapped, as tools/torch_fused_layer_faults.py does),
each time at 20 x 1024 queries x 1250 keys (a dulcet-universe B=20 eval
launch) at D = 32 and, as the control the plant leaves alone, D = 64: the
output against `cross_attention_plain` (rtol = atol = 1e-2), NaN columns on
either side of the output left NaN, and the device ms of three
`chip_smoke.device_ms` readings. Prints one line a turn and writes every
number as JSON to --out. Needs one NVIDIA H100 and nvcc; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import chip_smoke  # noqa: E402
from flowcompare_tpu_torch.ops import _build  # noqa: E402
from torch_fused_layer_faults import use_sources  # noqa: E402

N32_RS = '''
// D (64 x 32, f32 registers) += A (64 x 16, bf16 in registers) @ B (16 x 32
// from shared memory), as wgmma_m64n64_rs.
template <int TB>
__device__ __forceinline__ void wgmma_m64n32_rs(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %21, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, %22;\\n}\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128('''

# (file, anchor, replacement); each anchor occurs once in its file
PLANT = [
    ("hopper.cuh", "\ntemplate <int TA, int TB>\n__device__ __forceinline__ void wgmma_m64n128(",
     N32_RS),
    ("cross_attention.cu", '''  float acc[W::BOXES][32];
#pragma unroll
  for (int x = 0; x < W::BOXES; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
  float l0 = 0.f, l1 = 0.f;''', '''  constexpr int NACC = D == 32 ? 16 : 32;
  float acc[W::BOXES][NACC];
#pragma unroll
  for (int x = 0; x < W::BOXES; ++x)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[x][i] = 0.f;
  float l0 = 0.f, l1 = 0.f;'''),
    ("cross_attention.cu", '''#pragma unroll
    for (int x = 0; x < W::BOXES; ++x) tile_pb(acc[x], p, ks + TB + x * ATT_BOX_BYTES);''',
     '''    if constexpr (D == 32) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        wgmma_m64n32_rs<1>(acc[0], a, smem_desc(ks + TB + kk * 2048, 8192, 1024));
      }
    } else {
#pragma unroll
      for (int x = 0; x < W::BOXES; ++x) tile_pb(acc[x], p, ks + TB + x * ATT_BOX_BYTES);
    }'''),
]

ITEMS, NQ, NKV = 20, 1024, 1250


def plant(src: Path, dst: Path) -> Path:
    shutil.copytree(src, dst, dirs_exist_ok=True)
    for name, anchor, replacement in PLANT:
        path = dst / name
        text = path.read_text()
        assert text.count(anchor) == 1, (name, anchor[:60])
        path.write_text(text.replace(anchor, replacement))
    return dst


def reading(d: int) -> dict:
    g = torch.Generator().manual_seed(d)
    q = (torch.randn(ITEMS * NQ, d, generator=g) / d ** 0.5).bfloat16().cuda()
    kv = torch.randn(ITEMS * NKV, 2 * d, generator=g).bfloat16().cuda()
    k, v = kv[:, :d], kv[:, d:]
    full = torch.full((ITEMS * NQ, d + 16), float("nan"), device="cuda", dtype=torch.bfloat16)
    out = full[:, 8:8 + d]
    ref = torch.empty(ITEMS * NQ, d, device="cuda", dtype=torch.bfloat16)
    _build.cross_attention(q, k, v, out, n_items=ITEMS)
    _build.cross_attention_plain(q, k, v, ref, n_items=ITEMS)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    return {"max_abs_err": float(diff.max()),
            "within_tolerance": bool((diff <= 1e-2 + 1e-2 * ref.float().abs()).all()),
            "sentinels_intact": bool(full[:, :8].isnan().all() and full[:, 8 + d:].isnan().all()),
            "device_ms": [chip_smoke.device_ms(
                lambda: _build.cross_attention(q, k, v, out, n_items=ITEMS)) for _ in range(3)]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", type=Path, default=None,
                        help="where the planted copy of csrc/ is built (default: a new "
                             "temporary directory)")
    parser.add_argument("--out", type=Path,
                        default=REPO / "build" / "attention_widths.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    work = args.workdir or Path(tempfile.mkdtemp(prefix="attention_widths_"))
    builds = {"as built": (_build.CSRC, _build.BUILD_DIR),
              "m64n32 P V": (plant(_build.CSRC, work / "csrc"), work / "build")}
    turns = []
    for variant in ("as built", "m64n32 P V", "m64n32 P V", "as built"):
        use_sources(*builds[variant])
        turn = {"variant": variant, **{f"d{d}": reading(d) for d in (32, 64)}}
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": torch.cuda.get_device_name(0), "turns": turns},
                                   indent=1))
    assert all(t[f"d{d}"]["within_tolerance"] and t[f"d{d}"]["sentinels_intact"]
               for t in turns for d in (32, 64))
    return 0


if __name__ == "__main__":
    sys.exit(main())
