"""Builds the port's CUDA library and binds its C entry points with ctypes.

No JAX counterpart: the JAX package's Pallas kernels are compiled by XLA.
Here `nvcc` compiles every `csrc/*.cu` for `sm_90a` into one shared
library with a plain C interface, at first use, into `build/flowcompare_tpu_torch/`
beside the package (listed in `.gitignore`). The file name carries a hash
of the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. The compiler's register and shared-memory report
(`-Xptxas -v`) is kept beside the library as a `.log`.

The launch functions below check device, dtype, shape and strides, pass
pointers and the current stream, and raise if the C function returns a
CUDA error (every entry point returns `cudaGetLastError()` after its
launch). Kernels launch on PyTorch's current stream and never synchronise.
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

EPI_BIAS, EPI_RESIDUAL, EPI_GELU, EPI_AFFINE_LEAKY, EPI_OUT_F32 = 1, 2, 4, 8, 16

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fc_gemm_bf16": [_V, _I, _V, _I, _V, _I, _I, _I, _I, _V, _V, _I, _V, _V, _I, _V],
    "fc_cast_rows": [_V, _I, _V, _I, _I, _I, _V],
    "fc_row_norm": [_V, _I, _V, _I, _I, _I, _F, _V],
    "fc_coupling_epilogue": [_V, _I, _V, _I, _V, _V, _I, _I, _I, _I, _F, _V, _V],
    "fc_augment_epilogue": [_V, _I, _V, _I, _I, _V, _I, _I, _V, _I, _V, _I, _V],
    "fc_cross_attention": [_V, _I, _V, _V, _I, _V, _I, _I, _I, _I, _V],
    "fc_knn_edge_max": [_V, _I, _I, _V, _I, _I, _V, _I, _V, _I, _V, _V, _V,
                        _I, _I, _I, _V],
    "fc_knn_edge_max_smem": [_I, _I],
}

_LIB: Optional[ctypes.CDLL] = None


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
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
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
        _LIB = lib
    return _LIB


def _check(name: str, rc: int) -> None:
    if rc != 0:
        msg = library().fc_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _rows(t: torch.Tensor, name: str, dtype: torch.dtype) -> int:
    """Validate a 2-D CUDA matrix with unit column stride; return its row stride."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"{name}: expected a 2-D row-major matrix, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")
    return max(t.stride(0), 1)


def _vec(t: torch.Tensor, name: str, n: int) -> int:
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous() or t.numel() != n:
        raise ValueError(f"{name}: expected a contiguous CUDA float32 vector of {n}")
    return t.data_ptr()


def gemm(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor, *,
         bias: Optional[torch.Tensor] = None,
         residual: Optional[torch.Tensor] = None,
         affine: Optional[tuple] = None, gelu: bool = False) -> torch.Tensor:
    """out = epilogue(a @ w): a (M, K) bf16, w (K, N) bf16, out (M, N) bf16
    or f32. Epilogue order: + bias, + residual (bf16), leaky(v * a + b) for
    `affine=(a, b)`, erf-GELU."""
    lda = _rows(a, "gemm.a", torch.bfloat16)
    ldb = _rows(w, "gemm.w", torch.bfloat16)
    ldc = _rows(out, "gemm.out", out.dtype)
    m, k = a.shape
    n = w.shape[1]
    if w.shape[0] != k or tuple(out.shape) != (m, n):
        raise ValueError(f"gemm: shapes a {tuple(a.shape)} w {tuple(w.shape)} "
                         f"out {tuple(out.shape)}")
    flags = EPI_OUT_F32 if out.dtype == torch.float32 else 0
    if out.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gemm.out: unsupported dtype {out.dtype}")
    bias_p = res_p = aff_a = aff_b = None
    ldr = 0
    if bias is not None:
        flags |= EPI_BIAS
        bias_p = _vec(bias, "gemm.bias", n)
    if residual is not None:
        flags |= EPI_RESIDUAL
        ldr = _rows(residual, "gemm.residual", torch.bfloat16)
        if tuple(residual.shape) != (m, n):
            raise ValueError("gemm.residual: shape mismatch")
        res_p = residual.data_ptr()
    if affine is not None:
        flags |= EPI_AFFINE_LEAKY
        aff_a = _vec(affine[0], "gemm.affine_a", n)
        aff_b = _vec(affine[1], "gemm.affine_b", n)
    if gelu:
        flags |= EPI_GELU
    _check("gemm_bf16", library().fc_gemm_bf16(
        a.data_ptr(), lda, w.data_ptr(), ldb, out.data_ptr(), ldc, m, n, k,
        bias_p, res_p, ldr, aff_a, aff_b, flags, _stream()))
    return out


def cast_rows(src: torch.Tensor, dst: torch.Tensor) -> None:
    """dst (bf16) = src (f32), both (R, C) with unit column stride."""
    lds = _rows(src, "cast_rows.src", torch.float32)
    ldd = _rows(dst, "cast_rows.dst", torch.bfloat16)
    if src.shape != dst.shape:
        raise ValueError("cast_rows: shape mismatch")
    _check("cast_rows", library().fc_cast_rows(
        src.data_ptr(), lds, dst.data_ptr(), ldd, src.shape[0], src.shape[1], _stream()))


def row_norm(x: torch.Tensor, out: torch.Tensor, eps: float = 1e-5) -> None:
    """out (bf16) = (x - mean) * rsqrt(E[x^2] - mean^2 + eps), per row of f32 x."""
    ldx = _rows(x, "row_norm.x", torch.float32)
    ldy = _rows(out, "row_norm.out", torch.bfloat16)
    if x.shape != out.shape:
        raise ValueError("row_norm: shape mismatch")
    _check("row_norm", library().fc_row_norm(
        x.data_ptr(), ldx, out.data_ptr(), ldy, x.shape[0], x.shape[1], eps, _stream()))


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, *, n_items: int) -> None:
    """Per item: out = softmax(q k^T) v, q (items*nq, 64), k/v (items*nkv, 64)."""
    ldq = _rows(q, "cross_attention.q", torch.bfloat16)
    ldk = _rows(k, "cross_attention.k", torch.bfloat16)
    ldv = _rows(v, "cross_attention.v", torch.bfloat16)
    ldo = _rows(out, "cross_attention.out", torch.bfloat16)
    if q.shape[1] != 64 or k.shape[1] != 64 or v.shape[1] != 64 or out.shape[1] != 64:
        raise ValueError("cross_attention: head dimension must be 64")
    if ldk != ldv or k.shape[0] != v.shape[0]:
        raise ValueError("cross_attention: k and v must share rows and stride")
    if q.shape[0] % n_items or k.shape[0] % n_items or out.shape[0] != q.shape[0]:
        raise ValueError("cross_attention: rows not divisible by items")
    _check("cross_attention", library().fc_cross_attention(
        q.data_ptr(), ldq, k.data_ptr(), v.data_ptr(), ldk, out.data_ptr(), ldo,
        n_items, q.shape[0] // n_items, k.shape[0] // n_items, _stream()))


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


def knn_edge_max(x: torch.Tensor, u: torch.Tensor, out: torch.Tensor, *,
                 n_items: int, k: int, epilogue: Optional[tuple] = None) -> None:
    """Per item of n rows: out_i = max of u_j over the exact k nearest j of
    x_i, or with epilogue=(c, sign, a, b): leaky((sign * max + c) * a + b)."""
    ldx = _rows(x, "knn_edge_max.x", torch.bfloat16)
    ldu = _rows(u, "knn_edge_max.u", torch.bfloat16)
    ldo = _rows(out, "knn_edge_max.out", torch.bfloat16)
    rows, cq = x.shape
    cout = u.shape[1]
    if rows % n_items or u.shape[0] != rows or out.shape != (rows, cout):
        raise ValueError("knn_edge_max: shape mismatch")
    n = rows // n_items
    if not 1 <= k <= min(n, 64) or cout > 256:
        raise ValueError(f"knn_edge_max: needs 1 <= k <= min(n, 64) and cout <= 256 "
                         f"(k={k}, n={n}, cout={cout})")
    lib = library()
    if lib.fc_knn_edge_max_smem(n, cq) > 227 * 1024:
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


def mlp_chain(a: torch.Tensor, pairs: list, out: torch.Tensor, bufs: list) -> None:
    """The residual MLP as gemm launches: GELU after every layer but the
    last, a residual at every second hidden layer, the last layer into
    `out` (its dtype decides bf16 or f32). `bufs` are three (R, >=H) bf16
    scratch matrices."""
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
