"""Builds the port's CUDA library and binds its C entry points with ctypes.

No JAX counterpart: the JAX package's Pallas kernels are compiled by XLA.
Here `nvcc` compiles every `csrc/*.cu` for `sm_90a` (one process per
source, all started together) and links them into one shared library with
a plain C interface, at first use, into `build/flowcompare_tpu_torch/`
beside the package (listed in `.gitignore`). The file name carries a hash
of the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. The compiler's register and shared-memory report
(`-Xptxas -v`) is kept beside the library as a `.log`.

The launch functions below check device, dtype, shape and strides, pass
pointers and the current stream, and raise if the C function returns a
CUDA error (every entry point returns `cudaGetLastError()` after its
launch). Kernels launch on PyTorch's current stream and never synchronise.

Every matrix product of the port goes through `gemm` (C = epilogue(A @ B),
or A @ B^T) or `gemm_tn` (C = A^T @ B), each with two routes chosen from
the operands' alignment alone (`gemm_route`): the TMA + wgmma kernels
(`csrc/gemm_wgmma.cu`, `csrc/gemm_tn_wgmma.cu`) when TMA can read both
operands, the WMMA kernels (`csrc/gemm_bf16.cu`) otherwise. The choice is
never made on a failure: a launch error on either route raises. The B1, B2,
B5 and B7 chains pad their bf16 buffers and weight copies to rows of whole
16 bytes (`flow_layer_cuda._pad_cols`, `_CouplingChain`), so all their
products take the wgmma route; B4's first EdgeConv stage, which reads the
6-wide cloud, takes the WMMA route. The four counters below count the
launches of each route.

The chains' cross attention (`cross_attention`, its backward
`attention_bwd`) has the same two routes, chosen the same way
(`attention_route`): the TMA + wgmma kernels of csrc/cross_attention.cu and
csrc/cross_attention_bwd.cu, or their WMMA kernels for operands TMA cannot
read; each route is counted. Past ATTENTION_WIDE_MAX_D (512) columns the
wgmma route runs its cluster tier (csrc/cross_attention_cluster.cu,
cross_attention_bwd_cluster.cu and, for B10, attention_core_cluster.cu:
thread-block clusters that split D), counted among the route's launches
and by counters of its own. These wrappers, and `attn_bwd_prep`, run their
plain versions (`cross_attention_plain`, `attention_bwd_plain`,
`attn_bwd_prep_plain`) when given CPU tensors; every other launch function
takes CUDA tensors only.

B1 and B7 run each coupling layer as two fused kernels of
csrc/fused_layer.cu that keep a 64-row tile in shared memory through every
product of its MLP (`conditioner`, `coupling_layer`, `coupling_inverse`,
over a `FusedStack` of weights); their plain versions are
`flow_layer_cuda.conditioner_plain`, `coupling_layer_plain` and
`coupling_inverse_plain`, which the wrappers run on CPU tensors.

B5 runs each layer as the same kernels in record mode
(`conditioner_record`, `coupling_record`, with a `Record` of rows), the
backward kernels of csrc/fused_layer_bwd.cu (`coupling_bwd`,
`conditioner_bwd`, over a `BwdStack`) and one grouped launch of the weight
gradients with one more for every sum of partials (`gemm_tn_grouped` over
a `TnGroup`, `grad_reduce` over `GradSums`, csrc/gemm_tn_grouped.cu); each
runs its plain version (`flow_layer_vjp_cuda.*_plain`,
`gemm_tn_grouped_plain`, `grad_reduce_plain`) on CPU tensors. B10's
`attention_core` is a TMA + wgmma kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "flowcompare_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

EPI_BIAS, EPI_RESIDUAL, EPI_GELU, EPI_AFFINE_LEAKY, EPI_OUT_F32 = 1, 2, 4, 8, 16
EPI_RES_F32, EPI_ACCUM, EPI_PRE_OUT, EPI_GELU_GRAD, EPI_OUT2_BF16 = 32, 64, 128, 256, 512
EPI_SPLIT = 1024

_V, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "fc_gemm_bf16": [_V, _I, _V, _I, _V, _I, _I, _I, _I, _V, _V, _I, _V, _V, _V, _I, _V, _I,
                     _I, _I, _I, _I, _I, _V],
    "fc_gemm_bf16_wmma": [_V, _I, _V, _I, _V, _I, _I, _I, _I, _V, _V, _I, _V, _V, _V, _I, _V,
                          _I, _I, _I, _I, _V],
    "fc_gemm_tn": [_V, _I, _V, _I, _V, _I, _I, _I, _I, _I, _I, _I, _V, _V],
    "fc_gemm_tn_wmma": [_V, _I, _V, _I, _V, _I, _I, _I, _I, _I, _V, _V],
    "fc_cast_rows": [_V, _I, _V, _I, _I, _I, _V],
    "fc_pack_rows": [_V, _LL, _LL, _I, _V, _LL, _LL, _I, _I, _V, _I, _I, _I, _V],
    "fc_row_norm": [_V, _I, _V, _I, _I, _I, _F, _V],
    "fc_coupling_epilogue": [_V, _I, _V, _I, _V, _V, _I, _I, _I, _I, _F, _V, _V],
    "fc_augment_epilogue": [_V, _I, _V, _I, _I, _V, _I, _I, _V, _I, _V, _I, _V],
    "fc_inverse_coupling_epilogue": [_V, _I, _V, _I, _V, _I, _I, _I, _I, _F, _V],
    "fc_cross_attention": [_V, _I, _V, _V, _I, _V, _I, _V, _V, _I, _I, _I, _I, _V],
    "fc_cross_attention_wmma": [_V, _I, _V, _V, _I, _V, _I, _V, _V, _I, _I, _I, _I, _V],
    "fc_attention_core": [_V, _I, _V, _I, _V, _I, _V, _I, _I, _I, _I, _F, _I, _V],
    "fc_cross_attention_cluster": [_V, _I, _V, _V, _I, _V, _I, _V, _V, _I, _I, _I, _I, _V],
    "fc_attention_core_cluster": [_V, _I, _V, _I, _V, _I, _V, _I, _I, _I, _I, _F, _I, _V],
    "fc_attention_bwd_cluster": [_V, _I, _V, _V, _I, _V, _I, _V, _V, _V, _I, _V, _I, _V, _I,
                                 _V, _I, _I, _I, _I, _I, _V],
    "fc_attention_bwd": [_V, _I, _V, _V, _I, _V, _I, _V, _V, _V, _I, _V, _I, _V, _I, _V, _I,
                         _I, _I, _I, _I, _V],
    "fc_attention_bwd_wmma": [_V, _I, _V, _V, _I, _V, _I, _V, _V, _V, _I, _V, _I, _V, _I, _V,
                              _I, _I, _I, _I, _I, _V],
    "fc_coupling_epilogue_bwd": [_V, _I, _V, _I, _V, _I, _V, _V, _I, _V, _I, _V, _I, _V, _I,
                                 _I, _I, _I, _F, _V],
    "fc_attn_bwd_prep": [_V, _I, _V, _I, _V, _V, _I, _V, _I, _I, _V],
    "fc_row_norm_bwd": [_V, _I, _V, _I, _V, _I, _V, _I, _I, _I, _F, _V],
    "fc_colsum_chunks": [_I],
    "fc_colsum": [_V, _I, _I, _I, _V, _V, _V],
    "fc_knn_edge_max": [_V, _I, _I, _V, _I, _I, _V, _I, _V, _I, _V, _V, _V,
                        _I, _I, _I, _V],
    "fc_knn_edge_max_smem": [_I, _I],
    "fc_knn_edge_reduce_fwd": [_V, _I, _I, _V, _I, _I, _V, _V, _V, _V, _V, _V, _V, _I, _I, _I,
                               _V],
    "fc_knn_edge_reduce_bwd": [_V, _I, _I, _V, _V, _V, _V, _V, _V, _V, _V, _V, _I, _I, _I, _V],
    "fc_knn_edge_reduce_bwd_scratch": [_I, _I],
    "fc_fps_levels": [_V, _I, _I, _I, _I, _I, _I, _I, *[_V] * 8, _V, _V],
    "fc_fps_levels_smem": [_I] * 6,
    "fc_fps_levels_spill": [_I] * 6,
    "fc_fps_levels_threads": [_I] * 6,
    "fc_fps_round_probe": [_I, _V, _V],
    "fc_sa_select": [_I, _I, _I, _V, _V, _V, _V, _V, _V, _V],
    "fc_sa_select_smem": [_I],
    "fc_sa_gather": [_V, _V, _V, _V, _I, _V, _I, _I, _I, _I, _I, _V],
    "fc_sa_gather_smem": [_I, _I, _I],
    "fc_fused_layer": [_I, _I, _I, _V, _V, _V, _V, _V, _V, _I, _I, _V, _I, _I, _I, _I, _I,
                       _V, _I, _V, _I, _V, _V, _V, _I, _V, _I, _F, _V, _V, _V, _V, _V, _I, _V,
                       _V, _V],
    "fc_fused_layer_bwd": [_I, _I, *[_V] * 13, _I, _I, _V, _I, _I, _V, _I, _V, _V, _I, _V, _I,
                           _V, _V, _I, _V, _I, _V, _I, _I, _I, _I, _I, _I, _I, _V, _F, _V, _V],
    "fc_dgcnn_tail": [_I, *[_V] * 7, _V, _I, _I, _V, _I, _V, _V],
    "fc_augment_net": [_I, _I, *[_V] * 6, _V, _I, _I, _I, _V, _I, _V, _I, _I, _V, _I, _V, _V,
                       _V],
    "fc_gemm_tn_grouped": [_I, *[_V] * 10, _V],
    "fc_grad_reduce": [_I, *[_V] * 7, _I, _V],
}

_LIB: Optional[ctypes.CDLL] = None

# Launch counters of the two GEMM routes (plain integers, bumped where each
# kernel launches): TMA + wgmma and WMMA, for gemm and for gemm_tn.
GEMM_WGMMA_LAUNCHES = 0
GEMM_WMMA_LAUNCHES = 0
GEMM_TN_WGMMA_LAUNCHES = 0
GEMM_TN_WMMA_LAUNCHES = 0
# and of the cross attention's two routes, forward and backward
CROSS_ATTENTION_WGMMA_LAUNCHES = 0
CROSS_ATTENTION_WMMA_LAUNCHES = 0
ATTENTION_BWD_WGMMA_LAUNCHES = 0
ATTENTION_BWD_WMMA_LAUNCHES = 0
# and, among the wgmma route's launches, those of its cluster tier (the
# heads past ATTENTION_WIDE_MAX_D, csrc/*_cluster.cu): the forward, the
# backward and B10's attention_core
CROSS_ATTENTION_CLUSTER_LAUNCHES = 0
ATTENTION_BWD_CLUSTER_LAUNCHES = 0
ATTENTION_CORE_CLUSTER_LAUNCHES = 0

# and of the fused layer kernels (csrc/fused_layer.cu): the conditioner, the
# coupling layer forward and its inverse
FUSED_CONDITIONER_LAUNCHES = 0
COUPLING_LAYER_LAUNCHES = 0
COUPLING_INVERSE_LAUNCHES = 0
# and of B5's per-layer kernels: the recompute in the fused kernels' record
# mode, the fused backward kernels (csrc/fused_layer_bwd.cu) and the grouped
# weight gradients and their sums (csrc/gemm_tn_grouped.cu)
CONDITIONER_RECORD_LAUNCHES = 0
COUPLING_RECORD_LAUNCHES = 0
COUPLING_BWD_LAUNCHES = 0
CONDITIONER_BWD_LAUNCHES = 0
GEMM_TN_GROUPED_LAUNCHES = 0
GRAD_REDUCE_LAUNCHES = 0
# and of two row passes the per-product B5 chain also runs: attn_bwd_prep
# (both chains) and colsum (the per-product chain's bias gradients)
ATTN_BWD_PREP_LAUNCHES = 0
COLSUM_LAUNCHES = 0
# and of B4's and B2's own kernels: the row packing of their inputs
# (csrc/flow_rows.cu), B4's tail (conv5 and the head) and B2's net with its
# epilogue (csrc/fused_layer.cu kinds 4 and 5)
PACK_ROWS_LAUNCHES = 0
DGCNN_TAIL_LAUNCHES = 0
AUGMENT_NET_LAUNCHES = 0

NUM_SMS = 132          # the H100 SXM's; tiles and splits aim at about one wave of blocks


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path() -> Path:
    """The library's path for the current sources (it may not exist yet)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libflowcompare_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this exact build exists; returns its path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = BUILD_DIR / f"{so.stem}.{os.getpid()}.objs"
    work.mkdir(exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = work / f"{src.stem}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out[-4000:]}")
    if not failed:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *(str(obj) for _, obj, _ in jobs)],
                              capture_output=True, text=True)
        log.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr[-4000:]}")
    so.with_suffix(".log").write_text("".join(log))
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """Build on first use, load, and declare every entry point's signature."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.fc_error_string.argtypes = [_I]
        lib.fc_error_string.restype = ctypes.c_char_p
        lib.fc_fused_scratch_bytes.argtypes = [_I]
        lib.fc_fused_scratch_bytes.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def _check(name: str, rc: int) -> None:
    if rc != 0:
        msg = library().fc_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def _stream() -> int:
    """The current CUDA stream of the current device, as a pointer. Every
    launch asks, so this is PyTorch's raw lookup (CUDA builds have it):
    `torch.cuda.current_stream()` builds a Stream object each time, 4.4 us a
    launch on the H100's host (chip_smoke.py's GEMM host cost)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def _rows(t: torch.Tensor, name: str, dtype: torch.dtype) -> int:
    """Validate a 2-D CUDA matrix with unit column stride; return its row stride."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1) or (
            t.shape[0] > 1 and t.stride(0) < t.shape[1]):
        raise ValueError(f"{name}: expected a 2-D row-major matrix, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")
    return max(t.stride(0), 1)


def _vec(t: torch.Tensor, name: str, n: int) -> int:
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous() or t.numel() != n:
        raise ValueError(f"{name}: expected a contiguous CUDA float32 vector of {n}")
    return t.data_ptr()


def _f32_like(t: Optional[torch.Tensor], name: str, shape: tuple) -> Optional[int]:
    """Pointer of an optional f32 row-major matrix of `shape`; returns its row stride."""
    if t is None:
        return None
    ld = _rows(t, name, torch.float32)
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    return ld


def tma_readable(ptr: int, ld: int) -> bool:
    """Whether TMA can read a bf16 matrix at address `ptr` with a row stride
    of `ld` elements: a 16-byte-aligned base and rows of whole 16 bytes."""
    return ptr % 16 == 0 and ld % 8 == 0


def gemm_route(a_ptr: int, lda: int, b_ptr: int, ldb: int) -> str:
    """The GEMM route for two bf16 operands, from their alignment alone:
    "wgmma" (TMA + wgmma) when TMA can read both, else "wmma"."""
    return "wgmma" if tma_readable(a_ptr, lda) and tma_readable(b_ptr, ldb) else "wmma"


def gemm_tile(m: int, n: int) -> tuple:
    """(BM, BN) of the wgmma route's output tile for an M x N product. BN:
    64 up to N = 64, else 128 (on the H100, 128 x 128 tiles two to an SM
    beat 128 x 256 ones at every main-path width). BM: 128 (two consumer
    warpgroups), or 64 where 128-row tiles would give fewer blocks than SMs
    (a sample's 4,000 rows)."""
    bn = 64 if n <= 64 else 128
    bm = 128 if -(-m // 128) * -(-n // bn) >= NUM_SMS else 64
    return bm, bn


def gemm(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor, *,
         bias: Optional[torch.Tensor] = None,
         residual: Optional[torch.Tensor] = None,
         affine: Optional[tuple] = None, gelu: bool = False,
         trans_b: bool = False, accumulate: bool = False,
         pre_out: Optional[torch.Tensor] = None,
         gelu_grad: Optional[torch.Tensor] = None,
         out2: Optional[torch.Tensor] = None,
         out2_from: Optional[int] = None,
         route: Optional[str] = None) -> torch.Tensor:
    """out = epilogue(a @ w), or a @ w^T with trans_b (w stored (N, K)).

    a (M, K) bf16, w (K, N) bf16, out (M, N) bf16 or f32. Epilogue order:
    + bias, + residual (bf16 or f32), + out's current value (`accumulate`,
    f32 out only), leaky(v * a + b) for `affine=(a, b)`, the pre-GELU value
    stored into `pre_out` (f32), erf-GELU, times GELU'(`gelu_grad`) (f32
    pre-activations); a bf16 copy of the result into `out2`. With
    `out2_from=s` the output is split instead: out (M, s) takes columns
    [0, s) and out2 (M, N - s, bf16) columns [s, N) (B4's stage product:
    c in f32 and u' in bf16 from one launch).

    Two routes, one contract: when TMA can read both a and w (`gemm_route`:
    a 16-byte-aligned base and a row stride of whole 16 bytes) the TMA +
    wgmma kernel runs with `gemm_tile`'s output tile; otherwise the WMMA
    kernel. `route` forces one ("wgmma" on operands TMA cannot read
    raises); the chains leave it to the alignment. Each route counts its
    launches (GEMM_WGMMA_LAUNCHES, GEMM_WMMA_LAUNCHES). `gemm_plain` is the
    plain version."""
    global GEMM_WGMMA_LAUNCHES, GEMM_WMMA_LAUNCHES
    lda = _rows(a, "gemm.a", torch.bfloat16)
    ldb = _rows(w, "gemm.w", torch.bfloat16)
    ldc = _rows(out, "gemm.out", out.dtype)
    m, k = a.shape
    n = w.shape[0] if trans_b else w.shape[1]
    k_w = w.shape[1] if trans_b else w.shape[0]
    split = 0 if out2_from is None else out2_from
    if out2_from is not None and (out2 is None or not 0 < split < n):
        raise ValueError(f"gemm: out2_from={out2_from} needs out2 and 0 < out2_from < {n}")
    if k_w != k or tuple(out.shape) != (m, split or n):
        raise ValueError(f"gemm: shapes a {tuple(a.shape)} w {tuple(w.shape)} "
                         f"(trans_b={trans_b}) out {tuple(out.shape)}")
    if out.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gemm.out: unsupported dtype {out.dtype}")
    flags = EPI_OUT_F32 if out.dtype == torch.float32 else 0
    bias_p = res_p = aff_a = aff_b = aux_p = out2_p = None
    ldr = ldaux = ld2 = 0
    if bias is not None:
        flags |= EPI_BIAS
        bias_p = _vec(bias, "gemm.bias", n)
    if residual is not None:
        flags |= EPI_RESIDUAL
        if residual.dtype == torch.float32:
            flags |= EPI_RES_F32
        ldr = _rows(residual, "gemm.residual", residual.dtype)
        if residual.dtype not in (torch.float32, torch.bfloat16) or \
                tuple(residual.shape) != (m, n):
            raise ValueError("gemm.residual: expected (M, N) bf16 or f32")
        res_p = residual.data_ptr()
    if accumulate:
        if out.dtype != torch.float32:
            raise ValueError("gemm: accumulate needs an f32 out")
        flags |= EPI_ACCUM
    if affine is not None:
        flags |= EPI_AFFINE_LEAKY
        aff_a = _vec(affine[0], "gemm.affine_a", n)
        aff_b = _vec(affine[1], "gemm.affine_b", n)
    if pre_out is not None and gelu_grad is not None:
        raise ValueError("gemm: pre_out and gelu_grad share one pointer")
    for aux, flag, name in ((pre_out, EPI_PRE_OUT, "gemm.pre_out"),
                            (gelu_grad, EPI_GELU_GRAD, "gemm.gelu_grad")):
        if aux is not None:
            flags |= flag
            ldaux = _f32_like(aux, name, (m, n))
            aux_p = aux.data_ptr()
    if gelu:
        flags |= EPI_GELU
    if out2 is not None:
        flags |= EPI_SPLIT if split else EPI_OUT2_BF16
        ld2 = _rows(out2, "gemm.out2", torch.bfloat16)
        if tuple(out2.shape) != (m, n - split):
            raise ValueError("gemm.out2: shape mismatch")
        out2_p = out2.data_ptr()
    chosen = _choose_route(route, gemm_route(a.data_ptr(), lda, w.data_ptr(), ldb), "gemm")
    args = (a.data_ptr(), lda, w.data_ptr(), ldb, out.data_ptr(), ldc, m, n, k,
            bias_p, res_p, ldr, aff_a, aff_b, aux_p, ldaux, out2_p, ld2, split, flags,
            int(trans_b))
    if chosen == "wgmma":
        rc = library().fc_gemm_bf16(*args, *gemm_tile(m, n), _stream())
        GEMM_WGMMA_LAUNCHES += 1
    else:
        rc = library().fc_gemm_bf16_wmma(*args, _stream())
        GEMM_WMMA_LAUNCHES += 1
    if rc:
        _check(f"gemm_bf16 ({chosen})", rc)
    return out


def _choose_route(route: Optional[str], natural: str, name: str) -> str:
    """`route` where one is forced (the wgmma route only where the operands
    allow it), else the route the operands' alignment gives (`natural`)."""
    if route is None:
        return natural
    if route not in ("wgmma", "wmma"):
        raise ValueError(f"{name}: route must be 'wgmma' or 'wmma', got {route!r}")
    if route == "wgmma" and natural != "wgmma":
        raise ValueError(f"{name}: TMA cannot read these operands (16-byte-aligned base and "
                         f"row stride needed), so the wgmma route cannot take them")
    return route


def gelu_erf_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the erf GELU, as the kernels' EPI_GELU_GRAD computes it."""
    cdf = 0.5 * (1.0 + torch.erf(x * 0.7071067811865476))
    return cdf + x * 0.3989422804014327 * torch.exp(-0.5 * x * x)


def gemm_plain(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor, *,
               bias: Optional[torch.Tensor] = None,
               residual: Optional[torch.Tensor] = None,
               affine: Optional[tuple] = None, gelu: bool = False,
               trans_b: bool = False, accumulate: bool = False,
               pre_out: Optional[torch.Tensor] = None,
               gelu_grad: Optional[torch.Tensor] = None,
               out2: Optional[torch.Tensor] = None,
               out2_from: Optional[int] = None) -> torch.Tensor:
    """The plain version of `gemm` on any device: the f32 product of the
    bf16 operands, then the same epilogue in the same order, written into
    out (rounded to its dtype), pre_out and out2 (with `out2_from`, split
    between out and out2 by columns)."""
    v = a.float() @ (w.float().T if trans_b else w.float())
    if bias is not None:
        v = v + bias.float()
    if residual is not None:
        v = residual.float() + v
    if accumulate:
        v = v + out.float()
    if affine is not None:
        v = v * affine[0] + affine[1]
        v = torch.where(v >= 0, v, 0.2 * v)
    if pre_out is not None:
        pre_out.copy_(v)
    if gelu:
        v = torch.nn.functional.gelu(v)
    if gelu_grad is not None:
        v = v * gelu_erf_grad(gelu_grad.float())
    if out2_from is not None:
        out.copy_(v[:, :out2_from])
        out2.copy_(v[:, out2_from:])
        return out
    out.copy_(v)
    if out2 is not None:
        out2.copy_(v)
    return out


def gemm_tn_plan(m: int, n: int, k: int) -> tuple:
    """(BN, splits, k_chunk) of the wgmma route's A^T @ B: 128 x BN output
    tiles (BN 64 up to N = 64, else 128), and K in chunks of whole 64-row
    stages, as many splits as give about one wave of blocks on the SMs with
    every split at least 512 rows deep."""
    bn = 64 if n <= 64 else 128
    tiles = -(-m // 128) * -(-n // bn)
    splits = max(1, min(NUM_SMS // tiles, k // 512))
    k_chunk = -(-(-(-k // splits)) // 64) * 64
    return bn, -(-k // k_chunk), k_chunk


def _tn_splits_wmma(m: int, n: int, k: int) -> int:
    """K splits of the WMMA route's A^T @ B: about two blocks per SM over
    its 64 x 64 output tiles, each split at least 256 rows deep."""
    tiles = -(-m // 64) * -(-n // 64)
    return max(1, min(-(-264 // tiles), k // 256))


def gemm_tn_workspace(m: int, n: int, k: int) -> int:
    """Floats of workspace `gemm_tn` needs for these sizes on either route."""
    s_wgmma, s_wmma = gemm_tn_plan(m, n, k)[1], _tn_splits_wmma(m, n, k)
    return max(s if s > 1 else 0 for s in (s_wgmma, s_wmma)) * m * n


def gemm_tn(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
            ws: Optional[torch.Tensor] = None, route: Optional[str] = None) -> torch.Tensor:
    """out (M, N) f32 = a^T @ b for a (K, M) and b (K, N) bf16: the weight
    gradients, K split over blocks and summed in a second, ordered pass, so
    the result is deterministic. `ws` is an f32 workspace of at least
    `gemm_tn_workspace` floats. The route is chosen as `gemm`'s (TMA +
    wgmma with `gemm_tn_plan`'s tiles and splits, or WMMA) and counted
    (GEMM_TN_WGMMA_LAUNCHES, GEMM_TN_WMMA_LAUNCHES); `route` forces one.
    `gemm_tn_plain` is the plain version."""
    global GEMM_TN_WGMMA_LAUNCHES, GEMM_TN_WMMA_LAUNCHES
    lda = _rows(a, "gemm_tn.a", torch.bfloat16)
    ldb = _rows(b, "gemm_tn.b", torch.bfloat16)
    ldc = _rows(out, "gemm_tn.out", torch.float32)
    k, m = a.shape
    n = b.shape[1]
    if b.shape[0] != k or tuple(out.shape) != (m, n):
        raise ValueError(f"gemm_tn: shapes a {tuple(a.shape)} b {tuple(b.shape)} "
                         f"out {tuple(out.shape)}")
    chosen = _choose_route(route, gemm_route(a.data_ptr(), lda, b.data_ptr(), ldb), "gemm_tn")
    if chosen == "wgmma":
        bn, splits, k_chunk = gemm_tn_plan(m, n, k)
    else:
        splits = _tn_splits_wmma(m, n, k)
    need = splits * m * n if splits > 1 else 0
    if need and (ws is None or ws.numel() < need):
        ws = torch.empty(need, dtype=torch.float32, device=out.device)
    ws_p = _vec(ws.view(-1)[:need], "gemm_tn.ws", need) if need else None
    args = (a.data_ptr(), lda, b.data_ptr(), ldb, out.data_ptr(), ldc, m, n, k)
    if chosen == "wgmma":
        rc = library().fc_gemm_tn(*args, bn, splits, k_chunk, ws_p, _stream())
        GEMM_TN_WGMMA_LAUNCHES += 1
    else:
        rc = library().fc_gemm_tn_wmma(*args, splits, ws_p, _stream())
        GEMM_TN_WMMA_LAUNCHES += 1
    if rc:
        _check(f"gemm_tn ({chosen})", rc)
    return out


def gemm_tn_plain(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The plain version of `gemm_tn` on any device: out = a^T @ b in f32."""
    return out.copy_(a.float().T @ b.float())


def colsum_workspace(rows: int, cols: int) -> int:
    return library().fc_colsum_chunks(rows) * cols


def colsum(src: torch.Tensor, out: torch.Tensor, ws: Optional[torch.Tensor] = None) -> None:
    """out (C) f32 = column sums of src (R, C) f32, deterministic (row
    chunks, then the chunks in order); counted as COLSUM_LAUNCHES."""
    global COLSUM_LAUNCHES
    ld = _rows(src, "colsum.src", torch.float32)
    r, c = src.shape
    _vec(out, "colsum.out", c)
    need = colsum_workspace(r, c)
    if ws is None or ws.numel() < need:
        ws = torch.empty(need, dtype=torch.float32, device=src.device)
    _check("colsum", library().fc_colsum(src.data_ptr(), ld, r, c, out.data_ptr(),
                                         ws.data_ptr(), _stream()))
    COLSUM_LAUNCHES += 1


def cast_rows(src: torch.Tensor, dst: torch.Tensor) -> None:
    """dst (bf16) = src (f32), both (R, C) with unit column stride."""
    lds = _rows(src, "cast_rows.src", torch.float32)
    ldd = _rows(dst, "cast_rows.dst", torch.bfloat16)
    if src.shape != dst.shape:
        raise ValueError("cast_rows: shape mismatch")
    _check("cast_rows", library().fc_cast_rows(
        src.data_ptr(), lds, dst.data_ptr(), ldd, src.shape[0], src.shape[1], _stream()))


def pack_rows_plain(dst: torch.Tensor, *sources: torch.Tensor) -> None:
    """The plain version of `pack_rows`."""
    rows = dst.shape[0]
    cols = [s.reshape(rows, s.shape[-1]).float() for s in sources]
    used = sum(c.shape[1] for c in cols)
    pad = dst.new_zeros(rows, dst.shape[1] - used, dtype=torch.float32)
    dst.copy_(torch.cat([*cols, pad], 1))


def pack_rows(dst: torch.Tensor, *sources: torch.Tensor) -> None:
    """dst (R, C) bf16 = [s0 | s1 | 0]: one or two f32 sources (items, n,
    c_i) with unit column stride and any item and point strides (a 0 point
    stride broadcasts an item's row over its points), R = items * n, zeros in
    the columns past them. One launch (PACK_ROWS_LAUNCHES); a CPU dst runs
    `pack_rows_plain`."""
    global PACK_ROWS_LAUNCHES
    if not 1 <= len(sources) <= 2:
        raise ValueError("pack_rows: one or two sources")
    rows, cols = dst.shape
    for src in sources:
        if src.dim() != 3 or src.shape[0] * src.shape[1] != rows or src.shape[0] != \
                sources[0].shape[0]:
            raise ValueError(f"pack_rows: source {tuple(src.shape)} for {rows} rows")
    if sum(src.shape[2] for src in sources) > cols:
        raise ValueError("pack_rows: the sources are wider than dst")
    if not dst.is_cuda:
        pack_rows_plain(dst, *sources)
        return
    ldd = _rows(dst, "pack_rows.dst", torch.bfloat16)
    args = []
    for i in range(2):
        if i < len(sources):
            src = sources[i]
            if not src.is_cuda or src.dtype != torch.float32 or (src.shape[2] > 1
                                                                 and src.stride(2) != 1):
                raise ValueError(f"pack_rows: source {i} must be f32 CUDA with unit column "
                                 f"stride, got {src.dtype} strides {src.stride()}")
            args += [src.data_ptr(), src.stride(0), src.stride(1), src.shape[2]]
        else:
            args += [None, 0, 0, 0]
    _check("pack_rows", library().fc_pack_rows(*args, sources[0].shape[1], dst.data_ptr(), ldd,
                                               rows, cols, _stream()))
    PACK_ROWS_LAUNCHES += 1


def row_norm(x: torch.Tensor, out: torch.Tensor, eps: float = 1e-5) -> None:
    """out (bf16) = (x - mean) * rsqrt(E[x^2] - mean^2 + eps), per row of f32 x."""
    ldx = _rows(x, "row_norm.x", torch.float32)
    ldy = _rows(out, "row_norm.out", torch.bfloat16)
    if x.shape != out.shape:
        raise ValueError("row_norm: shape mismatch")
    _check("row_norm", library().fc_row_norm(
        x.data_ptr(), ldx, out.data_ptr(), ldy, x.shape[0], x.shape[1], eps, _stream()))


# the head widths D of the attention kernels: every 1 <= D <=
# ATTENTION_MAX_D. Up to ATTENTION_WIDE_MAX_D each on the smallest tile of
# 32, 64, 128, 256 or 512 columns that holds it (csrc/cross_attention.cu,
# cross_attention_bwd.cu, attention_core.cu and their *_wide.cu twins;
# `att_tile`, one template instance a tile); past it the cluster tier
# (csrc/*_cluster.cu, `ATT_CLUSTER_MAX_D`: a cluster of ceil(D / 128)
# blocks, 128 columns each, sharing the scores through distributed shared
# memory); the WMMA route up to ATTENTION_WMMA_MAX_D
ATTENTION_MAX_D = 1024
ATTENTION_WIDE_MAX_D = 512
ATTENTION_WMMA_MAX_D = 128


def attention_readable(t: torch.Tensor) -> bool:
    """Whether the attention kernels' TMA can read a bf16 operand: a
    16-byte-aligned base and rows of whole 16 bytes. The chains' v is one at
    every head width: they lay kv out as [k | 0 | v] with v at D rounded up
    to a multiple of 8 (`flow_layer_cuda.kv_layout`)."""
    return tma_readable(t.data_ptr(), t.stride(0))


def attention_route(reads: list) -> str:
    """The cross attention's route, from the bf16 operands it reads alone:
    "wgmma" (TMA + wgmma, csrc/cross_attention.cu and cross_attention_bwd.cu)
    when TMA can read every one (`attention_readable`), else "wmma" (the
    WMMA kernels of the same files, head widths up to
    ATTENTION_WMMA_MAX_D). Both routes write any output's rows: in pairs
    where their alignment allows it, else an element at a time."""
    return "wgmma" if all(attention_readable(t) for t in reads) else "wmma"


def _per_item(t: torch.Tensor, n_items: int) -> torch.Tensor:
    return t.float().reshape(n_items, t.shape[0] // n_items, t.shape[1])


def cross_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out: torch.Tensor, *, n_items: int,
                          m_out: Optional[torch.Tensor] = None,
                          den_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of `cross_attention` on any device, with its exact
    contract: per item, s = q k^T in f32, m the row maximum, e = exp(s - m),
    out = (bf16(e) v) / sum(e) rounded to out's dtype, m_out = m and
    den_out = sum(e) (the f32 sum of the unrounded e)."""
    qf, kf, vf = (_per_item(t, n_items) for t in (q, k, v))
    s = qf @ kf.transpose(1, 2)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    den = e.sum(-1, keepdim=True)
    out.copy_(((e.bfloat16().float() @ vf) / den).reshape(out.shape))
    if m_out is not None:
        m_out.copy_(m.reshape(-1))
        den_out.copy_(den.reshape(-1))
    return out


def attention_width(what: str, q: torch.Tensor, *others: torch.Tensor) -> int:
    """The head width D of q, checked against the other (rows, D) operands
    and against the widths the attention kernels take (1 <= D <=
    ATTENTION_MAX_D)."""
    d = q.shape[-1]
    widths = [t.shape[-1] for t in (q, *others)]
    if len(set(widths)) > 1:
        raise ValueError(f"{what}: operands of head widths {widths}")
    if not 1 <= d <= ATTENTION_MAX_D:
        raise ValueError(f"{what}: the kernels take head widths 1 <= D <= {ATTENTION_MAX_D}, "
                         f"got {d}")
    return d


def _attention_chosen(route: Optional[str], natural: str, d: int, what: str) -> str:
    """`_choose_route` for the attention kernels, refusing the WMMA route
    past ATTENTION_WMMA_MAX_D (the wgmma kernels take every width): "wgmma",
    "wmma", or "cluster", the wgmma route's tier past ATTENTION_WIDE_MAX_D.
    `route="cluster"` forces that tier at any width (TMA must read every
    operand), for measurements and tests."""
    if route == "cluster":
        _choose_route("wgmma", natural, what)
        return "cluster"
    chosen = _choose_route(route, natural, what)
    if chosen == "wgmma" and d > ATTENTION_WIDE_MAX_D:
        return "cluster"
    if chosen == "wmma" and d > ATTENTION_WMMA_MAX_D:
        raise ValueError(f"{what}: the WMMA route takes head widths D <= "
                         f"{ATTENTION_WMMA_MAX_D}, got {d}: give every bf16 operand a "
                         f"16-byte-aligned base and rows of whole 16 bytes, for the wgmma "
                         f"route")
    return chosen


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, *, n_items: int,
                    m_out: Optional[torch.Tensor] = None,
                    den_out: Optional[torch.Tensor] = None,
                    route: Optional[str] = None) -> None:
    """Per item: out = softmax(q k^T) v, q (items*nq, D), k/v (items*nkv, D),
    1 <= D <= ATTENTION_MAX_D; with m_out/den_out also each row's f32
    maximum and denominator.

    Two routes, one contract (`cross_attention_plain`): the TMA + wgmma
    kernel when TMA can read q, k and v (`attention_route`; past
    ATTENTION_WIDE_MAX_D its cluster tier), otherwise the WMMA kernel (D <=
    ATTENTION_WMMA_MAX_D; past it the wrapper raises). `route` forces one
    ("wgmma", "wmma" or "cluster", for measurements and tests); each route
    counts its launches (CROSS_ATTENTION_WGMMA_LAUNCHES, of which the
    cluster tier's also CROSS_ATTENTION_CLUSTER_LAUNCHES;
    CROSS_ATTENTION_WMMA_LAUNCHES). A CPU q runs the plain version and
    counts nothing. Only out's D columns are written: it may be a column
    slice of wider rows."""
    global CROSS_ATTENTION_WGMMA_LAUNCHES, CROSS_ATTENTION_WMMA_LAUNCHES
    global CROSS_ATTENTION_CLUSTER_LAUNCHES
    if not q.is_cuda:
        cross_attention_plain(q, k, v, out, n_items=n_items, m_out=m_out, den_out=den_out)
        return
    ldq = _rows(q, "cross_attention.q", torch.bfloat16)
    ldk = _rows(k, "cross_attention.k", torch.bfloat16)
    ldv = _rows(v, "cross_attention.v", torch.bfloat16)
    ldo = _rows(out, "cross_attention.out", torch.bfloat16)
    d = attention_width("cross_attention", q, k, v, out)
    if ldk != ldv or k.shape[0] != v.shape[0]:
        raise ValueError("cross_attention: k and v must share rows and stride")
    if (q.shape[0] % n_items or k.shape[0] % n_items or out.shape[0] != q.shape[0]
            or k.shape[0] == 0 or q.shape[0] == 0):
        raise ValueError("cross_attention: rows not divisible by items, or no rows")
    m_p = den_p = None
    if m_out is not None:
        m_p = _vec(m_out, "cross_attention.m_out", q.shape[0])
        den_p = _vec(den_out, "cross_attention.den_out", q.shape[0])
    nq, nkv = q.shape[0] // n_items, k.shape[0] // n_items
    chosen = _attention_chosen(route, attention_route([q, k, v]), d, "cross_attention")
    args = (q.data_ptr(), ldq, k.data_ptr(), v.data_ptr(), ldk, out.data_ptr(), ldo, m_p, den_p,
            n_items, nq, nkv, d)
    if chosen == "cluster":
        rc = library().fc_cross_attention_cluster(*args, _stream())
        CROSS_ATTENTION_WGMMA_LAUNCHES += 1
        CROSS_ATTENTION_CLUSTER_LAUNCHES += 1
    elif chosen == "wgmma":
        rc = library().fc_cross_attention(*args, _stream())
        CROSS_ATTENTION_WGMMA_LAUNCHES += 1
    else:
        rc = library().fc_cross_attention_wmma(*args, _stream())
        CROSS_ATTENTION_WMMA_LAUNCHES += 1
    if rc:
        _check(f"cross_attention ({chosen})", rc)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, *,
                   n_items: int, scale: float, route: Optional[str] = None) -> None:
    """Per item: out = softmax(q k^T * scale) v with p at f32 precision (B10),
    q (items*nq, D), k and v (items*nkv, D) bf16, 1 <= D <= ATTENTION_MAX_D,
    each with its own row stride. The TMA + wgmma kernel (p split into three
    bf16 terms for the tensor cores; past ATTENTION_WIDE_MAX_D its cluster
    tier, counted as ATTENTION_CORE_CLUSTER_LAUNCHES) takes operands TMA can
    read (`attention_readable`), and raises on others; `route="cluster"`
    forces the cluster tier at any width."""
    global ATTENTION_CORE_CLUSTER_LAUNCHES
    ldq = _rows(q, "attention_core.q", torch.bfloat16)
    ldk = _rows(k, "attention_core.k", torch.bfloat16)
    ldv = _rows(v, "attention_core.v", torch.bfloat16)
    ldo = _rows(out, "attention_core.out", torch.bfloat16)
    d = attention_width("attention_core", q, k, v, out)
    if (k.shape[0] != v.shape[0] or out.shape[0] != q.shape[0] or q.shape[0] % n_items
            or k.shape[0] % n_items or k.shape[0] == 0 or q.shape[0] == 0):
        raise ValueError("attention_core: rows not divisible by items, or no rows")
    if attention_route([q, k, v]) != "wgmma":
        raise ValueError("attention_core: TMA cannot read q, k or v (16-byte-aligned base "
                         "and row stride needed)")
    if route not in (None, "wgmma", "cluster"):
        raise ValueError(f"attention_core: route must be 'wgmma' or 'cluster', got {route!r}")
    cluster = route == "cluster" or d > ATTENTION_WIDE_MAX_D
    fn = library().fc_attention_core_cluster if cluster else library().fc_attention_core
    _check("attention_core" + (" (cluster)" if cluster else ""), fn(
        q.data_ptr(), ldq, k.data_ptr(), ldk, v.data_ptr(), ldv, out.data_ptr(), ldo, n_items,
        q.shape[0] // n_items, k.shape[0] // n_items, float(scale), d, _stream()))
    if cluster:
        ATTENTION_CORE_CLUSTER_LAUNCHES += 1


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, du: torch.Tensor,
                        ddn: torch.Tensor, m: torch.Tensor, dq: torch.Tensor,
                        dq_b: torch.Tensor, dkv: torch.Tensor, dkv_b: torch.Tensor, *,
                        n_items: int) -> None:
    """The plain version of `attention_bwd` on any device, with its exact
    contract: per item, e = exp(q k^T - m) from the forward's row maximum m,
    dv = bf16(e)^T du, dS = bf16(e (du v^T + ddn)), dq = dS k, dk = dS^T q,
    written in f32 (dq, dkv = [dk | dv]) and bf16 (dq_b, dkv_b)."""
    qf, kf, vf, duf = (_per_item(t, n_items) for t in (q, k, v, du))
    e = torch.exp(qf @ kf.transpose(1, 2) - m.reshape(n_items, -1, 1))
    dv = e.bfloat16().float().transpose(1, 2) @ duf
    ds = (e * (duf @ vf.transpose(1, 2) + ddn.reshape(n_items, -1, 1))).bfloat16().float()
    dq.copy_((ds @ kf).reshape(dq.shape))
    dq_b.copy_(dq)
    d = kf.shape[-1]
    dkv.copy_(torch.cat([(ds.transpose(1, 2) @ qf).reshape(-1, d), dv.reshape(-1, d)], 1))
    dkv_b.copy_(dkv)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, du: torch.Tensor,
                  ddn: torch.Tensor, m: torch.Tensor, dq: torch.Tensor, dq_b: torch.Tensor,
                  dkv: torch.Tensor, dkv_b: torch.Tensor, *, n_items: int,
                  route: Optional[str] = None) -> None:
    """The backward of `cross_attention` from du = da / den and ddn (see
    attn_bwd_prep): dq (items*nq, D) and [dk | dv] (items*nkv, 2 D), 1 <= D
    <= ATTENTION_MAX_D, each in f32 and in bf16. Routes as `cross_attention`'s
    (TMA + wgmma when TMA can read q, k, v and du, past ATTENTION_WIDE_MAX_D
    its cluster tier; WMMA otherwise, up to ATTENTION_WMMA_MAX_D); `route`
    forces one; counted as ATTENTION_BWD_WGMMA_LAUNCHES (the cluster tier's
    also as ATTENTION_BWD_CLUSTER_LAUNCHES) / ATTENTION_BWD_WMMA_LAUNCHES.
    A CPU q runs `attention_bwd_plain` and counts nothing."""
    global ATTENTION_BWD_WGMMA_LAUNCHES, ATTENTION_BWD_WMMA_LAUNCHES
    global ATTENTION_BWD_CLUSTER_LAUNCHES
    if not q.is_cuda:
        attention_bwd_plain(q, k, v, du, ddn, m, dq, dq_b, dkv, dkv_b, n_items=n_items)
        return
    ldq = _rows(q, "attention_bwd.q", torch.bfloat16)
    ldk = _rows(k, "attention_bwd.k", torch.bfloat16)
    ldv = _rows(v, "attention_bwd.v", torch.bfloat16)
    lddu = _rows(du, "attention_bwd.du", torch.bfloat16)
    lddq = _rows(dq, "attention_bwd.dq", torch.float32)
    lddqb = _rows(dq_b, "attention_bwd.dq_b", torch.bfloat16)
    lddkv = _rows(dkv, "attention_bwd.dkv", torch.float32)
    lddkvb = _rows(dkv_b, "attention_bwd.dkv_b", torch.bfloat16)
    rq, rk = q.shape[0], k.shape[0]
    d = attention_width("attention_bwd", q, k, v, du)
    if (ldk != ldv or tuple(du.shape) != (rq, d) or tuple(dq.shape) != (rq, d)
            or tuple(dq_b.shape) != (rq, d) or tuple(dkv.shape) != (rk, 2 * d)
            or tuple(dkv_b.shape) != (rk, 2 * d) or rq % n_items or rk % n_items
            or rq == 0 or rk == 0):
        raise ValueError("attention_bwd: shape mismatch")
    nq, nkv = rq // n_items, rk // n_items
    chosen = _attention_chosen(route, attention_route([q, k, v, du]), d, "attention_bwd")
    args = (q.data_ptr(), ldq, k.data_ptr(), v.data_ptr(), ldk, du.data_ptr(), lddu,
            _vec(ddn, "attention_bwd.ddn", rq), _vec(m, "attention_bwd.m", rq),
            dq.data_ptr(), lddq, dq_b.data_ptr(), lddqb, dkv.data_ptr(), lddkv,
            dkv_b.data_ptr(), lddkvb, n_items, nq, nkv, d)
    if chosen == "cluster":
        rc = library().fc_attention_bwd_cluster(*args, _stream())
        ATTENTION_BWD_WGMMA_LAUNCHES += 1
        ATTENTION_BWD_CLUSTER_LAUNCHES += 1
    elif chosen == "wgmma":
        rc = library().fc_attention_bwd(*args, _stream())
        ATTENTION_BWD_WGMMA_LAUNCHES += 1
    else:
        rc = library().fc_attention_bwd_wmma(*args, _stream())
        ATTENTION_BWD_WMMA_LAUNCHES += 1
    if rc:
        _check(f"attention_bwd ({chosen})", rc)


def attn_bwd_prep_plain(da: torch.Tensor, a: torch.Tensor, den: torch.Tensor, du: torch.Tensor,
                        ddn: torch.Tensor) -> None:
    """The plain version of `attn_bwd_prep` on any device."""
    du.copy_(da.float() / den[:, None])
    ddn.copy_(-(da.float() * a.float()).sum(-1) / den)


def attn_bwd_prep(da: torch.Tensor, a: torch.Tensor, den: torch.Tensor, du: torch.Tensor,
                  ddn: torch.Tensor) -> None:
    """du (bf16) = da / den, ddn = -sum(da * a) / den per row
    (ATTN_BWD_PREP_LAUNCHES). A CPU da runs `attn_bwd_prep_plain`."""
    global ATTN_BWD_PREP_LAUNCHES
    if not da.is_cuda:
        attn_bwd_prep_plain(da, a, den, du, ddn)
        return
    ldda = _rows(da, "attn_bwd_prep.da", torch.float32)
    lda = _rows(a, "attn_bwd_prep.a", torch.bfloat16)
    lddu = _rows(du, "attn_bwd_prep.du", torch.bfloat16)
    r, c = da.shape
    if a.shape != da.shape or du.shape != da.shape:
        raise ValueError("attn_bwd_prep: shape mismatch")
    _check("attn_bwd_prep", library().fc_attn_bwd_prep(
        da.data_ptr(), ldda, a.data_ptr(), lda, _vec(den, "attn_bwd_prep.den", r),
        du.data_ptr(), lddu, _vec(ddn, "attn_bwd_prep.ddn", r), r, c, _stream()))
    ATTN_BWD_PREP_LAUNCHES += 1


def row_norm_bwd(x: torch.Tensor, g: torch.Tensor, dx: torch.Tensor, dx_b: torch.Tensor,
                 eps: float = 1e-5) -> None:
    """The transpose of `row_norm` at its f32 input x for the output gradient g."""
    ldx = _rows(x, "row_norm_bwd.x", torch.float32)
    ldg = _rows(g, "row_norm_bwd.g", torch.float32)
    lddx = _rows(dx, "row_norm_bwd.dx", torch.float32)
    lddxb = _rows(dx_b, "row_norm_bwd.dx_b", torch.bfloat16)
    if not x.shape == g.shape == dx.shape == dx_b.shape:
        raise ValueError("row_norm_bwd: shape mismatch")
    _check("row_norm_bwd", library().fc_row_norm_bwd(
        x.data_ptr(), ldx, g.data_ptr(), ldg, dx.data_ptr(), lddx, dx_b.data_ptr(), lddxb,
        x.shape[0], x.shape[1], eps, _stream()))


def coupling_epilogue_bwd(st: torch.Tensor, x: torch.Tensor, dy: torch.Tensor,
                          dldj: torch.Tensor, dst: torch.Tensor, dst_b: torch.Tensor,
                          dx: torch.Tensor, y: torch.Tensor, *, split: int,
                          eps_affine: float) -> None:
    """From dy and dldj: d[s | t] (f32 and bf16), dx = [dy1 | dy2 * scale]
    and y = bf16([x1 | x2 * scale + t]) at the bf16 carry x."""
    ldst = _rows(st, "coupling_epilogue_bwd.st", torch.float32)
    ldx = _rows(x, "coupling_epilogue_bwd.x", torch.bfloat16)
    lddy = _rows(dy, "coupling_epilogue_bwd.dy", torch.float32)
    lddst = _rows(dst, "coupling_epilogue_bwd.dst", torch.float32)
    lddsb = _rows(dst_b, "coupling_epilogue_bwd.dst_b", torch.bfloat16)
    lddx = _rows(dx, "coupling_epilogue_bwd.dx", torch.float32)
    ldy = _rows(y, "coupling_epilogue_bwd.y", torch.bfloat16)
    r, lat = x.shape
    half = lat - split
    if (st.shape != (r, 2 * half) or dst.shape != st.shape or dst_b.shape != st.shape
            or dy.shape != (r, lat) or dx.shape != (r, lat) or y.shape != (r, lat)):
        raise ValueError("coupling_epilogue_bwd: shape mismatch")
    _check("coupling_epilogue_bwd", library().fc_coupling_epilogue_bwd(
        st.data_ptr(), ldst, x.data_ptr(), ldx, dy.data_ptr(), lddy,
        _vec(dldj, "coupling_epilogue_bwd.dldj", r), dst.data_ptr(), lddst, dst_b.data_ptr(),
        lddsb, dx.data_ptr(), lddx, y.data_ptr(), ldy, r, split, half, eps_affine, _stream()))


def coupling_epilogue(st: torch.Tensor, x: torch.Tensor, ldj: torch.Tensor,
                      y: torch.Tensor, lu_ldj: torch.Tensor, *, split: int,
                      eps_affine: float) -> None:
    """y = bf16([x1 | x2 * scale(s) + t]), ldj += sum(log scale) + lu_ldj[0]."""
    ldst = _rows(st, "coupling_epilogue.st", torch.float32)
    ldx = _rows(x, "coupling_epilogue.x", torch.float32)
    ldy = _rows(y, "coupling_epilogue.y", torch.bfloat16)
    r, lat = x.shape
    half = lat - split
    if st.shape != (r, 2 * half) or y.shape != (r, lat) or ldj.numel() != r:
        raise ValueError("coupling_epilogue: shape mismatch")
    _vec(ldj, "coupling_epilogue.ldj", r)
    _check("coupling_epilogue", library().fc_coupling_epilogue(
        st.data_ptr(), ldst, x.data_ptr(), ldx, ldj.data_ptr(), y.data_ptr(), ldy,
        r, split, half, eps_affine, lu_ldj.data_ptr(), _stream()))


def inverse_coupling_epilogue(st: torch.Tensor, y: torch.Tensor, x: torch.Tensor, *,
                              split: int, eps_affine: float) -> None:
    """x = [y1 | (y2 - t) / scale(s)] in f32, from st = [s | t] and y = [y1 | y2] (f32)."""
    ldst = _rows(st, "inverse_coupling_epilogue.st", torch.float32)
    ldy = _rows(y, "inverse_coupling_epilogue.y", torch.float32)
    ldx = _rows(x, "inverse_coupling_epilogue.x", torch.float32)
    r, lat = y.shape
    half = lat - split
    if st.shape != (r, 2 * half) or x.shape != (r, lat):
        raise ValueError("inverse_coupling_epilogue: shape mismatch")
    _check("inverse_coupling_epilogue", library().fc_inverse_coupling_epilogue(
        st.data_ptr(), ldst, y.data_ptr(), ldy, x.data_ptr(), ldx, r, split, half, eps_affine,
        _stream()))


def augment_epilogue(st: torch.Tensor, x: torch.Tensor, eps: torch.Tensor,
                     z: torch.Tensor, ldj: torch.Tensor) -> None:
    """z = [x | mean + eps * exp(log_std)], ldj = sum(0.5 log 2pi + log_std + eps^2 / 2)."""
    ldst = _rows(st, "augment_epilogue.st", torch.float32)
    ldx = _rows(x, "augment_epilogue.x", torch.float32)
    lde = _rows(eps, "augment_epilogue.eps", torch.float32)
    ldz = _rows(z, "augment_epilogue.z", torch.float32)
    r, in_dim = x.shape
    aug = eps.shape[1]
    if st.shape != (r, 2 * aug) or z.shape != (r, in_dim + aug) or eps.shape[0] != r:
        raise ValueError("augment_epilogue: shape mismatch")
    _vec(ldj, "augment_epilogue.ldj", r)
    _check("augment_epilogue", library().fc_augment_epilogue(
        st.data_ptr(), ldst, x.data_ptr(), ldx, in_dim, eps.data_ptr(), lde, aug,
        z.data_ptr(), ldz, ldj.data_ptr(), r, _stream()))


SMEM_LIMIT = 227 * 1024   # dynamic shared memory a block may opt into on the H100
GRID_ITEMS = 65535        # items a launch of B6 takes at most (the grid's y)
# neighbours B3, B6 and B9 take at most: B6 keeps a selection slot in a byte
# (csrc/knn_select.cuh MAX_K); past 64, the pool's, every row takes the radix
# select
KNN_MAX_K = 256


def knn_slot_bits(k: int) -> int:
    """Bits of the slot in B6's backward list entries i << bits | slot
    (csrc/knn_edge_reduce.cu): 6 up to k = 64, 8 past it; an item's points
    must then stay below 2^(31 - bits)."""
    return 6 if k <= 64 else 8


def _knn_pairs(x: torch.Tensor) -> torch.Tensor:
    """x as the kNN kernels read it, in aligned bf16 pairs: a copy with an
    even width (a zero feature, which changes no distance) where x has an
    odd width, an odd row stride or an odd base."""
    if x.shape[1] % 2 or x.stride(0) % 2 or x.data_ptr() % 4:
        x = torch.nn.functional.pad(x, (0, x.shape[1] % 2)).contiguous()
    return x


def knn_edge_max(x: torch.Tensor, u: torch.Tensor, out: torch.Tensor, *,
                 n_items: int, k: int, epilogue: Optional[tuple] = None) -> None:
    """Per item of n rows: out_i = max of u_j over the exact k nearest j of
    x_i, or with epilogue=(c, sign, a, b): leaky((sign * max + c) * a + b)."""
    _rows(x, "knn_edge_max.x", torch.bfloat16)
    x = _knn_pairs(x)
    ldx = _rows(x, "knn_edge_max.x", torch.bfloat16)
    ldu = _rows(u, "knn_edge_max.u", torch.bfloat16)
    ldo = _rows(out, "knn_edge_max.out", torch.bfloat16)
    rows, cq = x.shape
    cout = u.shape[1]
    if rows % n_items or u.shape[0] != rows or out.shape != (rows, cout):
        raise ValueError("knn_edge_max: shape mismatch")
    n = rows // n_items
    if not 1 <= k <= min(n, KNN_MAX_K) or cout > 256:
        raise ValueError(f"knn_edge_max: needs 1 <= k <= min(n, {KNN_MAX_K}) and cout <= 256 "
                         f"(k={k}, n={n}, cout={cout})")
    lib = library()
    if lib.fc_knn_edge_max_smem(n, cq) > SMEM_LIMIT:
        raise ValueError(f"knn_edge_max: n={n}, cq={cq} exceed shared memory")
    c_p = sign_p = a_p = b_p = None
    ldc = 0
    if epilogue is not None:
        c, sign, aff_a, aff_b = epilogue
        ldc = _rows(c, "knn_edge_max.c", torch.float32)
        if c.shape != (rows, cout):
            raise ValueError("knn_edge_max.c: shape mismatch")
        c_p = c.data_ptr()
        sign_p = _vec(sign, "knn_edge_max.sign", cout)
        a_p = _vec(aff_a, "knn_edge_max.a", cout)
        b_p = _vec(aff_b, "knn_edge_max.b", cout)
    _check("knn_edge_max", lib.fc_knn_edge_max(
        x.data_ptr(), ldx, cq, u.data_ptr(), ldu, cout, out.data_ptr(), ldo,
        c_p, ldc, sign_p, a_p, b_p, n_items, n, k, _stream()))


def _contig(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> int:
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected a contiguous CUDA {dtype} tensor of {shape}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def knn_edge_reduce_fwd(x: torch.Tensor, u: torch.Tensor, mx: torch.Tensor, mn: torch.Tensor,
                        s1: torch.Tensor, s2: torch.Tensor, amax: torch.Tensor,
                        amin: torch.Tensor, idx: torch.Tensor, *, n_items: int, k: int) -> None:
    """Per item of n rows, over each row's exact kNN in x: mx, mn, s1, s2 of u
    (f32, (rows, C)), the first max/min slots (uint8, (rows, C)) and the
    selected indices ascending (int32, (rows, k))."""
    _rows(x, "knn_edge_reduce.x", torch.bfloat16)
    x = _knn_pairs(x)
    ldx = _rows(x, "knn_edge_reduce.x", torch.bfloat16)
    ldu = _rows(u, "knn_edge_reduce.u", torch.bfloat16)
    rows, cq = x.shape
    cout = u.shape[1]
    if rows % n_items or u.shape[0] != rows:
        raise ValueError("knn_edge_reduce: shape mismatch")
    n = rows // n_items
    if not 1 <= k <= min(n, KNN_MAX_K) or cout > 256:
        raise ValueError(f"knn_edge_reduce: needs 1 <= k <= min(n, {KNN_MAX_K}) and C <= 256 "
                         f"(k={k}, n={n}, C={cout})")
    lib = library()
    if lib.fc_knn_edge_max_smem(n, cq) > SMEM_LIMIT:
        raise ValueError(f"knn_edge_reduce: n={n}, cq={cq} exceed shared memory")
    for t, nm in ((mx, "mx"), (mn, "mn"), (s1, "s1"), (s2, "s2")):
        _contig(t, f"knn_edge_reduce.{nm}", torch.float32, (rows, cout))
    for t, nm in ((amax, "amax"), (amin, "amin")):
        _contig(t, f"knn_edge_reduce.{nm}", torch.uint8, (rows, cout))
    _contig(idx, "knn_edge_reduce.idx", torch.int32, (rows, k))
    for a in range(0, n_items, GRID_ITEMS):   # a launch's items at most
        b = min(a + GRID_ITEMS, n_items)
        r = slice(a * n, b * n)
        _check("knn_edge_reduce_fwd", lib.fc_knn_edge_reduce_fwd(
            x[r].data_ptr(), ldx, cq, u[r].data_ptr(), ldu, cout,
            *(t[r].data_ptr() for t in (mx, mn, s1, s2, amax, amin, idx)), b - a, n, k,
            _stream()))


# The scratch ints of one group of items in B6's backward (1 GiB): larger
# batches run in groups.
BWD_GROUP_INTS = 1 << 28


def knn_bwd_scratch_ints(n: int, k: int) -> int:
    """Ints of B6's backward scratch an item (`fc_knn_edge_reduce_bwd_scratch`):
    the counts (n), the list offsets (n + 1), the unordered lists and the
    ordered ones (n k each)."""
    return 2 * n + 1 + 2 * n * k


def knn_bwd_groups(n_items: int, n: int, k: int) -> list:
    """B6's backward walks its batch in groups of items: (start, stop) of
    each, at most GRID_ITEMS items and BWD_GROUP_INTS ints of scratch a group
    (one item where an item alone takes more)."""
    per = max(1, min(GRID_ITEMS, BWD_GROUP_INTS // knn_bwd_scratch_ints(n, k)))
    return [(i, min(i + per, n_items)) for i in range(0, n_items, per)]


def knn_edge_reduce_bwd(u: torch.Tensor, dmx: torch.Tensor, dmn: torch.Tensor,
                        ds1: torch.Tensor, ds2: torch.Tensor, amax: torch.Tensor,
                        amin: torch.Tensor, idx: torch.Tensor, du: torch.Tensor, *,
                        n_items: int, k: int) -> None:
    """du (f32, (rows, C)) of `knn_edge_reduce_fwd` from the four cotangents,
    through per-item reverse neighbour lists (a counting sort by j across the
    card, each list ordered by i; no atomics on the sums), a group of items
    (`knn_bwd_groups`) a launch sequence, the scratch allocated here once for
    the largest group."""
    _rows(u, "knn_edge_reduce_bwd.u", torch.bfloat16)
    rows, cout = u.shape
    n = rows // n_items
    shape = (rows, cout)
    for t, nm in ((dmx, "dmx"), (dmn, "dmn"), (ds1, "ds1"), (ds2, "ds2"), (du, "du")):
        _contig(t, f"knn_edge_reduce_bwd.{nm}", torch.float32, shape)
    for t, nm in ((amax, "amax"), (amin, "amin")):
        _contig(t, f"knn_edge_reduce_bwd.{nm}", torch.uint8, shape)
    _contig(idx, "knn_edge_reduce_bwd.idx", torch.int32, (rows, k))
    if rows % n_items or not 1 <= k <= min(n, KNN_MAX_K) or cout > 256:
        raise ValueError(f"knn_edge_reduce_bwd: needs 1 <= k <= min(n, {KNN_MAX_K}) and "
                         f"C <= 256 (k={k}, n={n}, C={cout})")
    lib = library()
    per = lib.fc_knn_edge_reduce_bwd_scratch(n, k)
    if per < 0 or n >= 1 << (31 - knn_slot_bits(k)):
        raise ValueError(f"knn_edge_reduce_bwd: a cloud of n={n} points, k={k} passes the "
                         f"int32 entries of its reverse lists")
    groups = knn_bwd_groups(n_items, n, k)
    scratch = torch.empty(per * max(b - a for a, b in groups), dtype=torch.int32,
                          device=u.device)
    for a, b in groups:
        r = slice(a * n, b * n)
        _check("knn_edge_reduce_bwd", lib.fc_knn_edge_reduce_bwd(
            u[r].data_ptr(), u.stride(0), cout, dmx[r].data_ptr(), dmn[r].data_ptr(),
            ds1[r].data_ptr(), ds2[r].data_ptr(), amax[r].data_ptr(), amin[r].data_ptr(),
            idx[r].data_ptr(), scratch.data_ptr(), du[r].data_ptr(), b - a, n, k, _stream()))


def fps_levels(xyz: torch.Tensor, idx: list, out: list) -> None:
    """Farthest-point sampling of up to four chained levels in one launch:
    idx[l] (B, m_l) int64 the picks of level l among the points of level l's
    cloud (xyz (B, N, 3) f32 at level 0, out[l - 1] after), out[l] (B, m_l,
    3) f32 their coordinates. Clouds past shared memory take the large
    clouds' kernel, whose global tier (`fc_fps_levels_spill` points of 16
    bytes a cloud) is allocated here."""
    if xyz.dim() != 3 or xyz.shape[2] != 3 or not 1 <= len(idx) == len(out) <= 4:
        raise ValueError(f"fps_levels: xyz {tuple(xyz.shape)}, {len(idx)} levels")
    b, n, _ = xyz.shape
    ms = [t.shape[1] if t.dim() == 2 else 0 for t in idx]
    if n < 1 or min(ms) < 1:
        raise ValueError(f"fps_levels: needs n >= 1 and every m >= 1 (n={n}, m={ms})")
    lib = library()
    m4 = ms + [1] * (4 - len(ms))
    spill = lib.fc_fps_levels_spill(n, len(ms), *m4)
    scratch = (torch.empty(b * spill * 4, dtype=torch.float32, device=xyz.device)
               if spill > 0 else None)
    ptrs = [_contig(t, f"fps_levels.idx[{l}]", torch.int64, (b, m)) for l, (t, m) in
            enumerate(zip(idx, ms))]
    ptrs += [None] * (4 - len(ms))
    ptrs += [_contig(t, f"fps_levels.out[{l}]", torch.float32, (b, m, 3)) for l, (t, m) in
             enumerate(zip(out, ms))]
    ptrs += [None] * (4 - len(ms))
    _check("fps_levels", lib.fc_fps_levels(
        _contig(xyz, "fps_levels.xyz", torch.float32, (b, n, 3)), b, n, len(ms), *m4, *ptrs,
        None if scratch is None else scratch.data_ptr(), _stream()))


def fps_round_probe(rounds: int, out: torch.Tensor) -> None:
    """One block of B8's pick reductions without the sweep, `rounds` times in
    a dependent chain (out: one int32, kept live): its time over rounds is
    the latency of one barrier and one redux round."""
    _check("fps_round_probe", library().fc_fps_round_probe(
        rounds, _contig(out, "fps_round_probe.out", torch.int32, (1,)), _stream()))


def sa_select(levels: list, sel: list, *, k: int) -> None:
    """B9's selection for up to four levels in one launch: levels[l] =
    (new_xyz (B, M_l, 3) f32, idx (B, M_l) int64, xyz (B, N_l, 3) f32), sel[l]
    (B, M_l, k) int32 = slot 0 the centre (-1 for an index outside [0, N_l)),
    slots 1.. its nearest other points ascending, point 0 past N_l."""
    if not 1 <= len(levels) == len(sel) <= 4:
        raise ValueError(f"sa_select: {len(levels)} levels, {len(sel)} outputs")
    if not 1 <= k <= KNN_MAX_K:
        raise ValueError(f"sa_select: needs 1 <= k <= {KNN_MAX_K} (k={k})")
    b = levels[0][2].shape[0]
    lib = library()
    arrays = [[] for _ in range(6)]
    for l, ((new_xyz, idx, xyz), out) in enumerate(zip(levels, sel)):
        n, mc = xyz.shape[1], new_xyz.shape[1]
        if n < 1 or mc < 1:
            raise ValueError(f"sa_select: level {l} needs N >= 1 and M >= 1 (N={n}, M={mc})")
        for a, v in zip(arrays, (
                _contig(new_xyz, f"sa_select.new_xyz[{l}]", torch.float32, (b, mc, 3)),
                _contig(idx, f"sa_select.idx[{l}]", torch.int64, (b, mc)),
                _contig(xyz, f"sa_select.xyz[{l}]", torch.float32, (b, n, 3)),
                _contig(out, f"sa_select.sel[{l}]", torch.int32, (b, mc, k)), n, mc)):
            a.append(v)
    if lib.fc_sa_select_smem(max(arrays[4])) > SMEM_LIMIT:  # the launch's, for the largest N
        raise ValueError(f"sa_select: N={max(arrays[4])} exceeds shared memory")
    ptrs = [(ctypes.c_void_p * 4)(*a) for a in arrays[:4]]
    ints = [(ctypes.c_int * 4)(*a) for a in arrays[4:]]
    _check("sa_select", lib.fc_sa_select(len(levels), b, k, *map(ctypes.addressof, ptrs),
                                         *map(ctypes.addressof, ints), _stream()))


def sa_gather(sel: torch.Tensor, new_xyz: torch.Tensor, xyz: torch.Tensor, feats: torch.Tensor,
              out: torch.Tensor) -> None:
    """out (B, M, k, 3 + C) = [x_p - centre | feats_p] for the slots of sel
    (B, M, k) int32 from `sa_select` (NaN rows where slot 0 is -1); feats
    and out bf16 or f32, coordinates f32."""
    b, n, _ = xyz.shape
    mc, k = sel.shape[1], sel.shape[2]
    c = feats.shape[-1]
    if feats.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"sa_gather: features must be bf16 or f32, got {feats.dtype}")
    if not 1 <= k <= KNN_MAX_K or n < 1 or mc < 1:
        raise ValueError(f"sa_gather: needs 1 <= k <= {KNN_MAX_K}, N >= 1, M >= 1 "
                         f"(k={k}, N={n}, M={mc})")
    lib = library()
    if lib.fc_sa_gather_smem(c, k, feats.element_size()) > SMEM_LIMIT:
        raise ValueError(f"sa_gather: rows of 3 + {c} elements exceed shared memory")
    _check("sa_gather", lib.fc_sa_gather(
        _contig(sel, "sa_gather.sel", torch.int32, (b, mc, k)),
        _contig(new_xyz, "sa_gather.new_xyz", torch.float32, (b, mc, 3)),
        _contig(xyz, "sa_gather.xyz", torch.float32, (b, n, 3)),
        _contig(feats, "sa_gather.feats", feats.dtype, (b, n, c)), c,
        _contig(out, "sa_gather.out", feats.dtype, (b, mc, k, 3 + c)), b, n, mc, k,
        int(feats.dtype == torch.bfloat16), _stream()))


def mlp_chain(a: torch.Tensor, pairs: list, out: torch.Tensor, bufs: list) -> None:
    """The residual MLP as gemm launches: GELU after every layer but the
    last, a residual at every second hidden layer, the last layer into
    `out` (its dtype decides bf16 or f32). `bufs` are three (R, >=H) bf16
    scratch matrices. Every launch takes the wgmma route when `a`, the
    weights and `bufs` have rows of whole 16 bytes (the chains pad them so),
    the WMMA route otherwise (B4's 6-wide cloud)."""
    def scratch(width, *live):
        taken = {t.data_ptr() for t in live}
        for buf in bufs:
            if buf.data_ptr() not in taken:
                return buf[:, :width]
        raise AssertionError("no free scratch buffer")

    w0, b0 = pairs[0]
    h = scratch(w0.shape[1])
    gemm(a, w0, h, bias=b0, gelu=True)
    residual = h
    for k, (w, b) in enumerate(pairs[1:-1]):
        dst = scratch(w.shape[1], h, residual)
        if k % 2 == 0:
            residual = h
            gemm(h, w, dst, bias=b, gelu=True)
        else:
            gemm(h, w, dst, bias=b, residual=residual, gelu=True)
        h = dst
    w_last, b_last = pairs[-1]
    gemm(h, w_last, out, bias=b_last)


# ------------------------------------------------ the fused layer kernels

# the widest product (K and N), the widest a pass of output columns (and
# a one-pass kernel's product) and the most products a launch takes: the
# limits fc_fused_layer checks (csrc/fused_layer.cuh's MAXW, PASS_W,
# MAX_PRODUCTS). The products that end in a row's statistics or a row-wise
# epilogue (the LayerNorm's row, [s | t] and the latent, the LinearLU, B5's
# head) take at most FUSED_ROW_W columns (two passes; ROW_W), B2's output
# passes one pass each, and a launch's first product reads at most
# FUSED_IN_W columns of packed rows (S_COLS); a stack with a product past
# FUSED_PASS_W runs the wide kernels, which take device scratch
# (`fused_scratch`).
FUSED_MAXW, FUSED_PASS_W, FUSED_MAX_PRODUCTS = 2048, 512, 10
FUSED_ROW_W = FUSED_IN_W = 1024


def wide_shapes(shapes) -> bool:
    """Whether a stack of (K, N) products needs the wide kernels."""
    return any(k > FUSED_PASS_W or n > FUSED_PASS_W for k, n in shapes)


def fused_scratch(rows: int, wide: bool, device) -> Optional[torch.Tensor]:
    """The wide kernels' scratch for `rows` rows (648 KB a 64-row tile: two
    64 x 2,048 bf16 activations, a row-wise epilogue's stash and the
    backward's column-sum partials, `fc_fused_scratch_bytes`), or None for
    a one-pass stack."""
    if not wide:
        return None
    return torch.empty(library().fc_fused_scratch_bytes(rows), dtype=torch.uint8, device=device)


class FusedStack:
    """A stack of products in the fused kernels' layout: per product a bf16
    weight stack (L, K, N) whose rows TMA can read (`flow_layer_cuda._pad_cols`)
    and an f32 bias (L, N); the first `n_mlp` are the MLP, one more the tail
    (q, the LinearLU or the LU inverse), or, for B2's net, every product is
    the MLP's and the last `n_out` are its output layer's column passes. The
    pointer and shape arrays the C entry point reads are built once here,
    not once per layer."""

    def __init__(self, pairs: list, n_mlp: int, n_out: int = 0):
        if not 1 <= n_mlp <= len(pairs) <= min(n_mlp + 1, FUSED_MAX_PRODUCTS):
            raise ValueError(f"FusedStack: {len(pairs)} products with {n_mlp} in the MLP")
        for w, b in pairs:
            if (w.dim() != 3 or w.dtype != torch.bfloat16 or w.stride(2) != 1
                    or w.stride(0) != w.shape[1] * w.stride(1)
                    or not tma_readable(w.data_ptr(), w.stride(1))
                    or tuple(b.shape) != (w.shape[0], w.shape[2]) or b.dtype != torch.float32
                    or not b.is_contiguous()):
                raise ValueError(f"FusedStack: weight {tuple(w.shape)} {w.dtype} strides "
                                 f"{w.stride()} / bias {tuple(b.shape)} not in the layout")
        self.pairs, self.n_mlp, self.n_out = pairs, n_mlp, n_out
        self.wide = wide_shapes((w.shape[1], w.shape[2]) for w, _ in pairs)
        n = len(pairs)

        def arr(ctype, values):
            return (ctype * n)(*values)

        self._arrays = [arr(ctypes.c_uint64, [w.data_ptr() for w, _ in pairs]),
                        arr(ctypes.c_int, [w.stride(1) for w, _ in pairs]),
                        arr(ctypes.c_int, [w.shape[0] for w, _ in pairs]),
                        arr(ctypes.c_int, [w.shape[1] for w, _ in pairs]),
                        arr(ctypes.c_int, [w.shape[2] for w, _ in pairs]),
                        arr(ctypes.c_uint64, [b.data_ptr() for _, b in pairs])]
        self.args = [ctypes.addressof(a) for a in self._arrays]

    @property
    def in_cols(self) -> int:
        return self.pairs[0][0].shape[1]

    def layer(self, l: int) -> list:
        """Layer l's (w (K, N), b (N)) pairs, for the plain versions."""
        return [(w[l], b[l]) for w, b in self.pairs]


def _frag_passes(cols: int) -> list:
    """(first chunk, chunks a warpgroup, first float4 k) of each pass of
    FUSED_PASS_W output columns (csrc/fused_layer.cuh's pass_span)."""
    nch, per = -(-cols // 64), FUSED_PASS_W // 64
    return [(per * j, -(-min(per, nch - per * j) // 4), 8 * (per // 4) * j)
            for j in range(-(-nch // per))]


def frag_cpw(cols: int) -> int:
    """A tile's block of accumulator-order records in units of 64 KB (the
    chunks a warpgroup owns over all passes; csrc/fused_layer.cuh's frag_cpw)."""
    return sum(cpw for _, cpw, _ in _frag_passes(cols))


def fragment_rows(rows: int, cols: int, device) -> torch.Tensor:
    """An (rows, cols) f32 view for values the fused kernels write and read
    in their accumulator's order (csrc/fused_layer.cuh's frag_ptr: a 64-row
    tile of a product whose output has cols columns is a block of 64 x 256
    cpw floats, cpw its warpgroups' 64-column chunks each over its passes,
    `frag_cpw`); the plain versions use the view row-major. The buffer under
    it has 256 cpw columns and its rows rounded up to 64."""
    buf = torch.empty(-(-rows // 64) * 64, 256 * frag_cpw(cols), dtype=torch.float32,
                      device=device)
    return buf[:rows, :cols]


def fragment_index(rows: int, cols: int, device) -> torch.Tensor:
    """For each element (r, c) of a `fragment_rows` matrix, the index of
    its value in the flat buffer under it as the CUDA kernels lay it out:
    in pass j (`_frag_passes`), float4 k0_j + k of consumer thread t in tile
    b at (b * 8 cpw + k0_j + k) * 512 + t, holding rows fr and fr + 8,
    columns col and col + 1 of warpgroup t // 128's chunk c0 + k // 8 of the
    pass (wgmma's m64nN fragment). For checks that read a kernel's records
    row-major."""
    cpw_all = frag_cpw(cols)
    t = torch.arange(512, device=device)
    tt, wg = t % 128, t // 128
    fr, fc = (tt // 32) * 16 + (tt % 32) // 4, 2 * (tt % 4)
    q = torch.arange(4, device=device)
    tiles = -(-rows // 64)
    b = torch.arange(tiles, device=device)[:, None, None, None]
    index = torch.empty(rows, cols, dtype=torch.long, device=device)
    for first, cpw, k0 in _frag_passes(cols):
        k = torch.arange(8 * cpw, device=device)
        row = fr[:, None, None] + 8 * (q >> 1)[None, None, :]
        col = ((first + wg[:, None, None] * cpw + (k // 8)[None, :, None]) * 64
               + 8 * (k % 8)[None, :, None] + fc[:, None, None] + (q & 1)[None, None, :])
        row, col = torch.broadcast_tensors(row, col)
        flat = (((k0 + k)[None, :, None] * 512 + t[:, None, None]) * 4
                + q[None, None, :]).expand_as(row)
        rows_all = b * 64 + row[None]
        flat_all = b * (8 * cpw_all * 512 * 4) + flat[None]
        keep = (rows_all < rows) & (col[None] < cols)
        index[rows_all[keep], col.expand_as(rows_all)[keep]] = flat_all[keep]
    return index


def fragment_to_rows(view: torch.Tensor) -> torch.Tensor:
    """A `fragment_rows` view's values as a kernel wrote them, row-major."""
    flat = torch.as_strided(view, (view.untyped_storage().nbytes() // 4,), (1,), 0)
    return flat[fragment_index(view.shape[0], view.shape[1], view.device)]


def _ptrs(ctype, values: list):
    """A ctypes array of `values` (the C entry points read per-product
    tables from host memory)."""
    return (ctype * len(values))(*values)


class Record:
    """The rows B5's recompute writes per product of a FusedStack: an f32
    matrix `pre[p]` (the value the epilogue forms: a GELU's pre-activation
    or the LayerNorm's input, a `fragment_rows` view the kernel fills in its
    accumulator's order; [s | t], row-major with an even row stride) and a
    bf16 matrix `h[p]` (its result; rows of whole 16 bytes from a 16-byte
    base, written 16 bytes at a time), each (M, N_p), or None. The pointer
    tables are built once here."""

    def __init__(self, pre: list, h: list):
        for t in pre:
            if t is not None and (t.dtype != torch.float32 or t.dim() != 2 or t.stride(1) != 1
                                  or t.stride(0) % 2 or t.data_ptr() % 8):
                raise ValueError(f"Record.pre: {tuple(t.shape)} {t.dtype} strides {t.stride()}")
        for t in h:
            if t is not None and (t.dtype != torch.bfloat16 or t.dim() != 2 or t.stride(1) != 1
                                  or not tma_readable(t.data_ptr(), t.stride(0))):
                raise ValueError(f"Record.h: {tuple(t.shape)} {t.dtype} strides {t.stride()}")
        self.pre, self.h = pre, h
        self._arrays = [_ptrs(ctypes.c_uint64, [0 if t is None else t.data_ptr() for t in ts])
                        for ts in (pre, h)]
        self._arrays += [_ptrs(ctypes.c_int, [0 if t is None else t.stride(0) for t in ts])
                         for ts in (pre, h)]
        self.args = [ctypes.addressof(self._arrays[i]) for i in (0, 2, 1, 3)]


def _fused_launch(kind: int, stack: FusedStack, n_products: int, layer: int, tail_layer: int,
                  xin: torch.Tensor, split: int, half: int, *, x=None, y=None, ldj=None,
                  lu_ldj=None, save=None, q=None, eps: float = 0.0, record: Record = None,
                  x1_src: Optional[torch.Tensor] = None,
                  ln_rstd: Optional[torch.Tensor] = None) -> None:
    ldxin = _rows(xin, "fused_layer.xin", torch.bfloat16)
    if not tma_readable(xin.data_ptr(), ldxin) or xin.shape[1] < stack.in_cols:
        raise ValueError("fused_layer: TMA cannot read the packed rows, or they are too narrow")
    rows = xin.shape[0]
    lat = split + half

    def mat(t, name, dtype, cols):
        if t is None:
            return None, 0
        ld = _rows(t, f"fused_layer.{name}", dtype)
        if tuple(t.shape) != (rows, cols):
            raise ValueError(f"fused_layer.{name}: shape {tuple(t.shape)} != {(rows, cols)}")
        return t.data_ptr(), ld

    x_p, ldx = mat(x, "x", torch.float32, lat)
    y_p, ldy = mat(y, "y", torch.float32, lat)
    save_p, ldsave = mat(save, "save", torch.bfloat16, lat)
    q_p, ldq = mat(q, "q", torch.bfloat16, stack.pairs[-1][0].shape[2])
    ldj_p = None if ldj is None else _vec(ldj, "fused_layer.ldj", rows)
    lu_p = None if lu_ldj is None else _vec(lu_ldj, "fused_layer.lu_ldj", 1)
    x1_p, ldx1 = None, 0
    if x1_src is not None:
        ldx1 = _rows(x1_src, "fused_layer.x1_src", torch.bfloat16)
        if x1_src.shape[0] != rows or x1_src.shape[1] < split:
            raise ValueError("fused_layer.x1_src: expected the layer's (M, >= split) bf16 save")
        x1_p = x1_src.data_ptr()
    rec = record.args if record is not None else [None] * 4
    scratch = fused_scratch(rows, stack.wide, xin.device)
    rc = library().fc_fused_layer(kind, n_products, stack.n_mlp, *stack.args, layer,
                                  tail_layer, xin.data_ptr(), ldxin, stack.in_cols, split, half,
                                  rows, x_p, ldx, y_p, ldy, ldj_p, lu_p, save_p, ldsave, q_p, ldq,
                                  float(eps), *rec, x1_p, ldx1,
                                  None if ln_rstd is None else _vec(ln_rstd, "fused_layer.ln_rstd",
                                                                    rows),
                                  None if scratch is None else scratch.data_ptr(), _stream())
    if rc:
        _check(f"fused_layer (kind {kind})", rc)


def conditioner(xin: torch.Tensor, split: int, stack: FusedStack, l: int,
                q: torch.Tensor) -> None:
    """q (bf16) = the attention conditioner's query of layer l from the
    packed rows' x1 columns: the pre-MLP, LayerNorm (f32 statistics, scale
    and bias folded into wq_f) and q = qn @ wq_f + bq_f, one launch
    (FUSED_CONDITIONER_LAUNCHES). `stack` holds the pre-MLP and (wq_f, bq_f).
    A CPU xin runs `flow_layer_cuda.conditioner_plain`."""
    global FUSED_CONDITIONER_LAUNCHES
    if not xin.is_cuda:
        from .flow_layer_cuda import conditioner_plain
        conditioner_plain(xin, split, stack.layer(l), q)
        return
    if stack.in_cols != split:
        raise ValueError("conditioner: the pre-MLP's first weight must read the x1 columns")
    _fused_launch(0, stack, len(stack.pairs), l, l, xin, split, 0, q=q)
    FUSED_CONDITIONER_LAUNCHES += 1


def coupling_layer(xin: torch.Tensor, split: int, stack: FusedStack, l: int, x: torch.Tensor,
                   ldj: torch.Tensor, lu_ldj: torch.Tensor, *, save: Optional[torch.Tensor] = None,
                   eps_affine: float) -> None:
    """Layer l of B1 on the packed rows: the coupling MLP ([s | t] with its
    columns interleaved), the affine, and the LinearLU into the f32 carry x
    in place; ldj += sum(log scale) + lu_ldj[0]; the packed rows' x1 columns
    (and `save`, bf16) get the new carry. One launch (COUPLING_LAYER_LAUNCHES).
    A CPU xin runs `flow_layer_cuda.coupling_layer_plain`."""
    global COUPLING_LAYER_LAUNCHES
    half = x.shape[1] - split
    if not xin.is_cuda:
        from .flow_layer_cuda import coupling_layer_plain
        coupling_layer_plain(xin, split, stack.layer(l), x, ldj, lu_ldj, save=save,
                             eps_affine=eps_affine)
        return
    _fused_launch(1, stack, len(stack.pairs), l, l, xin, split, half, x=x, ldj=ldj,
                  lu_ldj=lu_ldj, save=save, eps=eps_affine)
    COUPLING_LAYER_LAUNCHES += 1


def coupling_inverse(xin: torch.Tensor, split: int, stack: FusedStack, l: int, y: torch.Tensor,
                     *, x: Optional[torch.Tensor] = None, eps_affine: float) -> None:
    """Layer l of B7 on the packed rows: the coupling MLP, x2 = (y2 - t) /
    scale, then, with x None, the LU inverse of layer l - 1 (the stack's tail)
    into y in place and its x1 columns into the packed rows; with x given
    (layer 0 of the walk) x = [y1 | x2] instead. One launch
    (COUPLING_INVERSE_LAUNCHES). A CPU xin runs
    `flow_layer_cuda.coupling_inverse_plain`."""
    global COUPLING_INVERSE_LAUNCHES
    half = y.shape[1] - split
    pairs = stack.layer(l)
    if x is None:
        if l < 1:
            raise ValueError("coupling_inverse: layer 0 writes x")
        pairs = pairs[:stack.n_mlp] + [stack.layer(l - 1)[-1]]
    else:
        pairs = pairs[:stack.n_mlp]
    if not xin.is_cuda:
        from .flow_layer_cuda import coupling_inverse_plain
        coupling_inverse_plain(xin, split, pairs, y, x=x, eps_affine=eps_affine)
        return
    n_products = stack.n_mlp + int(x is None)
    _fused_launch(2, stack, n_products, l, l - 1, xin, split, half, x=x, y=y, eps=eps_affine)
    COUPLING_INVERSE_LAUNCHES += 1


def dgcnn_tail(feats: torch.Tensor, stack: FusedStack, scale: torch.Tensor,
               out: torch.Tensor) -> None:
    """B4's tail over the stage concat `feats` (M, K0) bf16: conv5 with its
    folded BatchNorm, leaky(v * scale + b5), then (a stack of more than one
    product) the residual head, GELU after each product but the last; the
    last product's bf16 rows into out (M, N_last). `stack` holds conv5 and
    the head at layer 0 (`dgcnn_cuda.EncoderWeights`), scale (1, N0) f32.
    One launch (DGCNN_TAIL_LAUNCHES). A CPU feats runs
    `dgcnn_cuda.dgcnn_tail_plain`."""
    global DGCNN_TAIL_LAUNCHES
    n0, n_last = stack.pairs[0][0].shape[2], stack.pairs[-1][0].shape[2]
    if feats.shape[1] != stack.in_cols or tuple(out.shape) != (feats.shape[0], n_last):
        raise ValueError(f"dgcnn_tail: feats {tuple(feats.shape)}, out {tuple(out.shape)} for a "
                         f"stack of {stack.in_cols} -> {n_last} columns")
    if not feats.is_cuda:
        from .dgcnn_cuda import dgcnn_tail_plain
        out.copy_(dgcnn_tail_plain(feats, stack.layer(0), scale[0]))
        return
    ldf = _rows(feats, "dgcnn_tail.feats", torch.bfloat16)
    ldo = _rows(out, "dgcnn_tail.out", torch.bfloat16)
    if not tma_readable(feats.data_ptr(), ldf) or not tma_readable(out.data_ptr(), ldo):
        raise ValueError("dgcnn_tail: feats and out need 16-byte rows and bases")
    scratch = fused_scratch(feats.shape[0], stack.wide, feats.device)
    rc = library().fc_dgcnn_tail(len(stack.pairs), *stack.args,
                                 _vec(scale, "dgcnn_tail.scale", n0), feats.data_ptr(), ldf,
                                 feats.shape[0], out.data_ptr(), ldo,
                                 None if scratch is None else scratch.data_ptr(), _stream())
    if rc:
        _check("dgcnn_tail", rc)
    DGCNN_TAIL_LAUNCHES += 1


def augment_net(xin: torch.Tensor, stack: FusedStack, x: torch.Tensor, eps: torch.Tensor,
                z: torch.Tensor, ldj: torch.Tensor) -> None:
    """B2's ConditionalNormal net and its epilogue over the packed rows xin
    (M, >= K0) bf16 [x | extra | pad | attn]: GELU after every product but
    the output layer, a residual every second hidden product; the output
    layer as the stack's last `n_out` products, column passes of (mean_i,
    log_std_i) pairs (`flow_layer_cuda.augment_net_plan`). z (M, in + aug)
    f32 = [x | mean + eps * exp(log_std)], ldj (M) f32 = sum(log 2pi / 2 +
    log_std + eps^2 / 2), from x (M, in) and eps (M, aug) f32. One launch
    (AUGMENT_NET_LAUNCHES). A CPU xin runs `flow_layer_cuda.augment_net_plain`."""
    global AUGMENT_NET_LAUNCHES
    rows, in_dim = x.shape
    aug = eps.shape[1]
    if stack.n_out < 1:
        raise ValueError("augment_net: the stack names no output passes (FusedStack n_out)")
    if (xin.shape[0] != rows or xin.shape[1] < stack.in_cols or eps.shape[0] != rows
            or tuple(z.shape) != (rows, in_dim + aug) or ldj.numel() != rows):
        raise ValueError(f"augment_net: xin {tuple(xin.shape)}, x {tuple(x.shape)}, eps "
                         f"{tuple(eps.shape)}, z {tuple(z.shape)}, ldj {tuple(ldj.shape)}")
    if not xin.is_cuda:
        from .flow_layer_cuda import augment_net_plain
        zr, lr = augment_net_plain(xin, stack.layer(0), x, eps, n_out=stack.n_out)
        z.copy_(zr)
        ldj.copy_(lr.reshape(ldj.shape))
        return
    ldxin = _rows(xin, "augment_net.xin", torch.bfloat16)
    if not tma_readable(xin.data_ptr(), ldxin):
        raise ValueError("augment_net: TMA cannot read the packed rows")
    scratch = fused_scratch(rows, stack.wide, xin.device)
    rc = library().fc_augment_net(
        len(stack.pairs), stack.n_out, *stack.args, xin.data_ptr(), ldxin, rows, in_dim, x.data_ptr(),
        _rows(x, "augment_net.x", torch.float32), eps.data_ptr(),
        _rows(eps, "augment_net.eps", torch.float32), aug, z.data_ptr(),
        _rows(z, "augment_net.z", torch.float32), _vec(ldj, "augment_net.ldj", rows),
        None if scratch is None else scratch.data_ptr(), _stream())
    if rc:
        _check("augment_net", rc)
    AUGMENT_NET_LAUNCHES += 1


# ---------------------------------------------- B5's per-layer kernels

def conditioner_record(xin: torch.Tensor, split: int, stack: FusedStack, l: int,
                       q: torch.Tensor, record: Record, x1_src: torch.Tensor,
                       ln_rstd: torch.Tensor) -> None:
    """B5's recompute of layer l's conditioner: `conditioner` reading the x1
    columns from the layer's bf16 save `x1_src` (and writing them into the
    packed rows), recording per hidden pre-MLP product GELU' at its f32
    pre-activation and its bf16 activation, for the last product the
    LayerNorm's normalised f32 row (xhat) and bf16 output (qn), and each
    row's 1 / std into ln_rstd (M f32). One launch
    (CONDITIONER_RECORD_LAUNCHES). A CPU xin runs
    `flow_layer_vjp_cuda.conditioner_record_plain`."""
    global CONDITIONER_RECORD_LAUNCHES
    if not xin.is_cuda:
        from .flow_layer_vjp_cuda import conditioner_record_plain
        conditioner_record_plain(xin, split, stack.layer(l), q, record, x1_src, ln_rstd)
        return
    if stack.in_cols != split:
        raise ValueError("conditioner_record: the pre-MLP's first weight must read the x1 columns")
    _fused_launch(0, stack, len(stack.pairs), l, l, xin, split, 0, q=q, record=record,
                  x1_src=x1_src, ln_rstd=ln_rstd)
    CONDITIONER_RECORD_LAUNCHES += 1


def coupling_record(xin: torch.Tensor, split: int, stack: FusedStack, l: int, record: Record,
                    x1_src: Optional[torch.Tensor] = None) -> None:
    """B5's recompute of layer l's coupling MLP on the packed rows (the stack
    holds the MLP alone, its last product's [s | t] interleaved): per
    hidden product GELU' at the f32 pre-activation and the bf16 activation,
    and [s | t] (f32, interleaved) as the last product's pre. With `x1_src` the x1 columns come
    from the layer's save (and are written into the packed rows). One launch
    (COUPLING_RECORD_LAUNCHES). A CPU xin runs
    `flow_layer_vjp_cuda.coupling_record_plain`."""
    global COUPLING_RECORD_LAUNCHES
    if not xin.is_cuda:
        from .flow_layer_vjp_cuda import coupling_record_plain
        coupling_record_plain(xin, split, stack.layer(l), record, x1_src)
        return
    if len(stack.pairs) != stack.n_mlp:
        raise ValueError("coupling_record: the stack holds the MLP alone")
    _fused_launch(3, stack, stack.n_mlp, l, l, xin, split, 0, record=record, x1_src=x1_src)
    COUPLING_RECORD_LAUNCHES += 1


class BwdStack:
    """The products of one fused backward launch (csrc/fused_layer_bwd.cu):
    per product a bf16 weight stack (L, K, N) whose rows TMA can read (the
    head's lu_w_f or wq_f^T, then the MLP's W^T in reverse), the f32 values
    its epilogue reads (`pre`: the coupling head's [s | t] row-major, the
    others `fragment_rows` written by the recompute), the f32 residual
    gradient read and written (`res_in`, `res_out`, views of one
    `fragment_rows` scratch), the bf16 dp it writes (`d_out`) and its
    per-tile column sums (`colsum`, (tiles, N) f32); None where a product
    has none (the tail has only its weight). The pointer tables are built
    once here."""

    def __init__(self, weights: list, pre: list, res_in: list, res_out: list, d_out: list,
                 colsum: list):
        n = len(weights)
        if not 3 <= n <= FUSED_MAX_PRODUCTS or not all(
                len(v) == n for v in (pre, res_in, res_out, d_out, colsum)):
            raise ValueError(f"BwdStack: {n} products")
        for w in weights:
            if (w.dim() != 3 or w.dtype != torch.bfloat16 or w.stride(2) != 1
                    or w.stride(0) != w.shape[1] * w.stride(1)
                    or not tma_readable(w.data_ptr(), w.stride(1))
                    or not 1 <= w.shape[1] <= FUSED_MAXW or not 1 <= w.shape[2] <= FUSED_MAXW):
                raise ValueError(f"BwdStack: weight {tuple(w.shape)} {w.dtype} strides "
                                 f"{w.stride()} not in the layout")
        for t in pre + res_in + res_out:
            if t is not None and (t.dtype != torch.float32 or t.stride(0) % 2
                                  or t.data_ptr() % 8):
                raise ValueError("BwdStack: f32 rows need an even stride and an 8-byte base")
        for t in d_out:
            if t is not None and (t.dtype != torch.bfloat16
                                  or not tma_readable(t.data_ptr(), t.stride(0))):
                raise ValueError("BwdStack: dp rows need a 16-byte base and row stride")
        for t in colsum:
            if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()):
                raise ValueError("BwdStack: column sums must be contiguous f32")
        self.weights, self.pre, self.res_in, self.res_out = weights, pre, res_in, res_out
        self.d_out, self.colsum = d_out, colsum
        self.wide = wide_shapes((w.shape[1], w.shape[2]) for w in weights)

        def ptr(t):
            return 0 if t is None else t.data_ptr()

        def ld(t):
            return 0 if t is None else t.stride(0)

        u64, i32 = ctypes.c_uint64, ctypes.c_int
        self._arrays = [
            _ptrs(u64, [ptr(w) for w in weights]), _ptrs(i32, [w.stride(1) for w in weights]),
            _ptrs(i32, [w.shape[0] for w in weights]), _ptrs(i32, [w.shape[1] for w in weights]),
            _ptrs(i32, [w.shape[2] for w in weights]), _ptrs(u64, [ptr(t) for t in pre]),
            _ptrs(i32, [ld(t) for t in pre]), _ptrs(u64, [ptr(t) for t in res_in]),
            _ptrs(u64, [ptr(t) for t in res_out]),
            _ptrs(u64, [ptr(t) for t in d_out]), _ptrs(i32, [ld(t) for t in d_out]),
            _ptrs(u64, [ptr(t) for t in colsum]),
            _ptrs(i32, [0 if t is None else t.shape[1] for t in colsum])]
        self.args = [ctypes.addressof(a) for a in self._arrays]

    def layer(self, l: int) -> list:
        """Layer l's weights (K, N), for the plain versions."""
        return [w[l] for w in self.weights]


def _tiles(rows: int) -> int:
    return -(-rows // 64)


def _bwd_launch(kind: int, stack: BwdStack, l: int, src, src_b, src_colsum, g_next, *, x=None,
                dldj=None, y=None, dextra=None, dcond=None, accumulate_cond=False, split: int,
                half: int = 0, xe: int = 0, xc: int = 0, eps: float = 0.0, ln_rstd=None) -> None:
    rows, cols = src.shape
    ld_src = _rows(src, "fused_layer_bwd.src", torch.float32)
    ld_g = _rows(g_next, "fused_layer_bwd.g_next", torch.float32)
    if g_next.shape[0] != rows or tuple(src_colsum.shape) != (_tiles(rows), cols):
        raise ValueError("fused_layer_bwd: shape mismatch")

    def mat(t, name, dtype):
        return (None, 0) if t is None else (t.data_ptr(), _rows(t, f"fused_layer_bwd.{name}",
                                                                dtype))

    sb_p, ld_sb = mat(src_b, "src_b", torch.bfloat16)
    if src_b is not None and not tma_readable(sb_p, ld_sb):
        raise ValueError("fused_layer_bwd.src_b: rows of whole 16 bytes from a 16-byte base")
    x_p, ld_x = mat(x, "x", torch.bfloat16)
    y_p, ld_y = mat(y, "y", torch.bfloat16)
    e_p, ld_e = mat(dextra, "dextra", torch.float32)
    c_p, ld_c = mat(dcond, "dcond", torch.float32)
    dldj_p = None if dldj is None else _vec(dldj, "fused_layer_bwd.dldj", rows)
    cond = 0 if dcond is None else dcond.shape[1]
    scratch = fused_scratch(rows, stack.wide, src.device)
    rc = library().fc_fused_layer_bwd(
        kind, len(stack.weights), *stack.args, l, rows, src.data_ptr(), ld_src, cols, sb_p,
        ld_sb, _vec(src_colsum, "fused_layer_bwd.src_colsum", src_colsum.numel()),
        g_next.data_ptr(), ld_g, x_p, ld_x, dldj_p, y_p, ld_y, e_p, ld_e, c_p, ld_c,
        int(accumulate_cond), split, half, xe, xc, cond,
        None if ln_rstd is None else _vec(ln_rstd, "fused_layer_bwd.ln_rstd", rows), float(eps),
        None if scratch is None else scratch.data_ptr(), _stream())
    if rc:
        _check(f"fused_layer_bwd (kind {kind})", rc)


def coupling_bwd(stack: BwdStack, l: int, g: torch.Tensor, g_b: torch.Tensor,
                 g_colsum: torch.Tensor, g_next: torch.Tensor, x: torch.Tensor,
                 dldj: torch.Tensor, y: torch.Tensor, dextra: Optional[torch.Tensor],
                 dcond: torch.Tensor, *, split: int, xe: int, xc: int, accumulate_cond: bool,
                 eps_affine: float) -> None:
    """Layer l's coupling backward on 64-row tiles, one launch
    (COUPLING_BWD_LAUNCHES): from the carry gradient g (f32), g_b = bf16(g)
    and its per-tile column sums; dy = g_b @ lu_w_f; the affine's transpose
    at the bf16 save x, writing y and g_next = [dy1 | dy2 * scale]; the
    coupling MLP in reverse (`stack`: its d_out / colsum per product); the
    packed input's gradient: x1's added to g_next, extra's added to dextra,
    the cond columns' written to (or, with accumulate_cond, added to)
    dcond. A CPU g runs `flow_layer_vjp_cuda.coupling_bwd_plain`."""
    global COUPLING_BWD_LAUNCHES
    if not g.is_cuda:
        from .flow_layer_vjp_cuda import coupling_bwd_plain
        coupling_bwd_plain(stack, l, g, g_b, g_colsum, g_next, x, dldj, y, dextra, dcond,
                           split=split, xe=xe, xc=xc, accumulate_cond=accumulate_cond,
                           eps_affine=eps_affine)
        return
    _bwd_launch(0, stack, l, g, g_b, g_colsum, g_next, x=x, dldj=dldj, y=y, dextra=dextra,
                dcond=dcond, accumulate_cond=accumulate_cond, split=split,
                half=g.shape[1] - split, xe=xe, xc=xc, eps=eps_affine)
    COUPLING_BWD_LAUNCHES += 1


def conditioner_bwd(stack: BwdStack, l: int, dq: torch.Tensor, dq_colsum: torch.Tensor,
                    g_next: torch.Tensor, ln_rstd: torch.Tensor, *, split: int) -> None:
    """Layer l's conditioner backward on 64-row tiles, one launch
    (CONDITIONER_BWD_LAUNCHES): from dq (f32) and its per-tile column sums,
    dqn = bf16(dq) @ wq_f^T, the LayerNorm's transpose from the recorded
    normalised row (stack.pre[0]) and 1 / std (ln_rstd), the pre-MLP in
    reverse (`stack`), and x1's gradient added to g_next. A CPU dq runs
    `flow_layer_vjp_cuda.conditioner_bwd_plain`."""
    global CONDITIONER_BWD_LAUNCHES
    if not dq.is_cuda:
        from .flow_layer_vjp_cuda import conditioner_bwd_plain
        conditioner_bwd_plain(stack, l, dq, dq_colsum, g_next, ln_rstd, split=split)
        return
    _bwd_launch(1, stack, l, dq, None, dq_colsum, g_next, split=split, ln_rstd=ln_rstd)
    CONDITIONER_BWD_LAUNCHES += 1


def tn_splits(problems: list) -> int:
    """The K splits of a grouped weight gradient: about two waves of 128 x
    128 blocks on the SMs over every problem's tiles, each split at least
    512 rows deep."""
    tiles = sum(-(-m // 128) * -(-n // 128) for m, n, _ in problems)
    depth = min(k for _, _, k in problems)
    return max(1, min(-(-2 * NUM_SMS // tiles), depth // 512))


class TnGroup:
    """The weight gradients of one layer of B5 as one launch: problems
    (a (K, M), b (K, N)) bf16, TMA-readable, out_i = a_i^T @ b_i, each
    written as `splits` f32 partials into a workspace made here. The tables
    are built once; every layer reuses them."""

    def __init__(self, problems: list):
        if not 1 <= len(problems) <= 16:
            raise ValueError(f"TnGroup: {len(problems)} problems (1 to 16)")
        for a, b in problems:
            for t, name in ((a, "a"), (b, "b")):
                if (t.dtype != torch.bfloat16 or t.dim() != 2 or t.stride(1) != 1
                        or not tma_readable(t.data_ptr(), t.stride(0))):
                    raise ValueError(f"TnGroup.{name}: {tuple(t.shape)} {t.dtype} strides "
                                     f"{t.stride()} not TMA-readable bf16")
            if a.shape[0] != b.shape[0]:
                raise ValueError("TnGroup: a and b must share K")
        self.problems = problems
        shapes = [(a.shape[1], b.shape[1], a.shape[0]) for a, b in problems]
        self.splits = s = tn_splits(shapes)
        per = [min(s, max(1, k // 512)) for _, _, k in shapes]
        self.chunks = chunks = [-(-(-(-k // sp)) // 64) * 64 for (_, _, k), sp in zip(shapes, per)]
        self.per_splits = [-(-k // c) for (_, _, k), c in zip(shapes, chunks)]
        sizes = [sp * -(-(m * n) // 4) * 4 for (m, n, _), sp in zip(shapes, self.per_splits)]
        dev = problems[0][0].device
        self.ws = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        offsets = [sum(sizes[:i]) for i in range(len(sizes))]
        self.partials = [self.ws[o:o + sp * m * n].view(sp, m, n)
                         for o, sp, (m, n, _) in zip(offsets, self.per_splits, shapes)]
        u64, i32 = ctypes.c_uint64, ctypes.c_int
        self._arrays = [
            _ptrs(u64, [a.data_ptr() for a, _ in problems]),
            _ptrs(i32, [a.stride(0) for a, _ in problems]),
            _ptrs(u64, [b.data_ptr() for _, b in problems]),
            _ptrs(i32, [b.stride(0) for _, b in problems]),
            _ptrs(i32, [m for m, _, _ in shapes]), _ptrs(i32, [n for _, n, _ in shapes]),
            _ptrs(i32, [k for _, _, k in shapes]), _ptrs(i32, self.per_splits),
            _ptrs(i32, chunks), _ptrs(u64, [p.data_ptr() for p in self.partials])]
        self.args = [ctypes.addressof(a) for a in self._arrays]


def gemm_tn_grouped(group: TnGroup) -> None:
    """Every problem's K-split partials of a^T @ b, one launch
    (GEMM_TN_GROUPED_LAUNCHES); `grad_reduce` sums them. A CPU operand runs
    `gemm_tn_grouped_plain`."""
    global GEMM_TN_GROUPED_LAUNCHES
    if not group.ws.is_cuda:
        gemm_tn_grouped_plain(group)
        return
    _check("gemm_tn_grouped", library().fc_gemm_tn_grouped(len(group.problems), *group.args,
                                                           _stream()))
    GEMM_TN_GROUPED_LAUNCHES += 1


def gemm_tn_grouped_plain(group: TnGroup) -> None:
    """The plain version of `gemm_tn_grouped`: the same partials, each
    split's rows of a^T @ b in f32."""
    for (a, b), part, chunk in zip(group.problems, group.partials, group.chunks):
        for z in range(part.shape[0]):
            part[z] = a[z * chunk:(z + 1) * chunk].float().T @ b[z * chunk:(z + 1) * chunk].float()


class GradSums:
    """The sums of one layer's gradient partials as one launch: per sum,
    (partials (count, R, C) f32 contiguous, out (L, R, C)-like stack whose
    layer l slice is written). Weight gradients sum their K splits, biases
    their per-tile column sums (R = 1). The tables are built once."""

    def __init__(self, sums: list):
        if not 1 <= len(sums) <= 32:
            raise ValueError(f"GradSums: {len(sums)} sums (1 to 32)")
        for part, out in sums:
            if (part.dtype != torch.float32 or part.dim() != 3 or not part.is_contiguous()
                    or out.dtype != torch.float32 or not out.is_contiguous()
                    or out[0].numel() != part.shape[1] * part.shape[2]):
                raise ValueError(f"GradSums: partials {tuple(part.shape)} out "
                                 f"{tuple(out.shape)}")
        self.sums = sums
        u64, i32 = ctypes.c_uint64, ctypes.c_int
        self._arrays = [
            _ptrs(u64, [p.data_ptr() for p, _ in sums]), _ptrs(i32, [p.shape[0] for p, _ in sums]),
            _ptrs(i32, [p.shape[1] for p, _ in sums]), _ptrs(i32, [p.shape[2] for p, _ in sums]),
            _ptrs(u64, [o.data_ptr() for _, o in sums]), _ptrs(i32, [p.shape[2] for p, _ in sums]),
            _ptrs(ctypes.c_longlong, [o[0].numel() for _, o in sums])]
        self.args = [ctypes.addressof(a) for a in self._arrays]


def grad_reduce(sums: GradSums, l: int) -> None:
    """Layer l of every stack in `sums` = the sum of its partials, in order,
    one launch (GRAD_REDUCE_LAUNCHES). A CPU stack runs `grad_reduce_plain`."""
    global GRAD_REDUCE_LAUNCHES
    if not sums.sums[0][0].is_cuda:
        grad_reduce_plain(sums, l)
        return
    _check("grad_reduce", library().fc_grad_reduce(len(sums.sums), *sums.args, l, _stream()))
    GRAD_REDUCE_LAUNCHES += 1


def grad_reduce_plain(sums: GradSums, l: int) -> None:
    for part, out in sums.sums:
        out[l].copy_(part.sum(0).reshape(out[l].shape))
