"""Native host ops of the port's data layer (ctypes over g++-built libraries).

Counterpart of `flowcompare_tpu/native/__init__.py`, over the port's own
copy of its source (`native_ops.cpp`). `build_library` compiles a C++
source of this directory at first use with
`g++ -O3 -fPIC -shared -std=c++17 -pthread` into
`build/flowcompare_tpu_torch/` beside the package (git-ignored), under a
file name that carries a hash of the source and the flags, as
`ops/_build.py` names the CUDA library. Each build writes a private
temporary file and moves it into place with `os.replace`, so processes
that build at the same moment never load a half-written library. A failed
build raises `NativeBuildError` with g++'s output: there is no silent
numpy fallback. The numpy bodies stay as `voxelize_grid_plain`,
`fps_indices_plain` and `gather_records_plain`, the tests' reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[1] / "build" / "flowcompare_tpu_torch"
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """g++ could not build a native library; the message holds its output."""


def library_path(source: str) -> Path:
    """Where the library of `source` (a file of this directory) is built."""
    src = HERE / source
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def build_library(source: str) -> Path:
    """Compile `source` unless this exact build exists; returns its path."""
    so = library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(HERE / source), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"g++ could not be run to build {source}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed ({proc.returncode}) building {source}:\n"
                               f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """Build on first use, load, and declare every entry point's signature."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library("native_ops.cpp")))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.voxelize_grid.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32,
                                      f32p, f32p, i64p, ctypes.c_int32, i64p]
        lib.count_voxels.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, i64p]
        lib.fps.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, i64p]
        lib.gather_records.argtypes = [f32p, i64p, ctypes.c_int64, ctypes.c_int64, f32p,
                                       ctypes.c_int32]
        for fn in (lib.voxelize_grid, lib.count_voxels, lib.fps, lib.gather_records):
            fn.restype = None
        _lib = lib
    return _lib


def _grid_args(points, start, size, steps):
    return (np.ascontiguousarray(points, np.float32), np.ascontiguousarray(start, np.float32),
            np.ascontiguousarray(size, np.float32), np.ascontiguousarray(steps, np.int64))


def voxelize_grid(points: np.ndarray, start, size, steps) -> np.ndarray:
    """Voxel id of each point on the grid start + size * cell, cells clipped
    to [0, steps), ids in ravel order with the first axis fastest."""
    points, start, size, steps = _grid_args(points, start, size, steps)
    d_grid = len(size)
    if points.ndim != 2 or points.shape[1] < d_grid or len(start) != d_grid \
            or len(steps) != d_grid:
        raise ValueError(f"voxelize_grid: points {points.shape} against a {d_grid}-d grid")
    out = np.empty(points.shape[0], np.int64)
    get_lib().voxelize_grid(points, points.shape[0], points.shape[1], start, size, steps,
                            d_grid, out)
    return out


def voxelize_grid_plain(points: np.ndarray, start, size, steps) -> np.ndarray:
    """numpy version of `voxelize_grid`."""
    points, start, size, steps = _grid_args(points, start, size, steps)
    d_grid = len(size)
    cell = np.clip(np.floor((points[:, :d_grid] - start) / size).astype(np.int64),
                   0, steps - 1)
    strides = np.concatenate([[1], np.cumprod(steps[:-1])])
    return (cell * strides).sum(axis=-1)


def fps_indices(points: np.ndarray, m: int) -> np.ndarray:
    """Deterministic farthest-point sampling of m indices, starting at 0;
    ties go to the lowest index."""
    points = np.ascontiguousarray(points, np.float32)
    n = points.shape[0]
    if points.ndim != 2 or points.shape[1] < 3 or n == 0:
        raise ValueError(f"fps_indices: needs a non-empty (n, >=3) cloud, got {points.shape}")
    out = np.empty(m, np.int64)
    get_lib().fps(points, n, points.shape[1], m, out)
    return out


def fps_indices_plain(points: np.ndarray, m: int) -> np.ndarray:
    """numpy version of `fps_indices`."""
    points = np.ascontiguousarray(points, np.float32)
    n = points.shape[0]
    sel = np.zeros(m, np.int64)
    d = np.full(n, np.inf)
    far = 0
    for i in range(m):
        sel[i] = far
        dd = np.sum((points[:, :3] - points[far, :3]) ** 2, axis=1)
        d = np.minimum(d, dd)
        far = int(np.argmax(d))
    return sel


def gather_records(base: np.ndarray, indices: np.ndarray, record_floats: int,
                   n_threads: int = 4) -> np.ndarray:
    """Rows `indices` of `base` seen as (-1, record_floats) f32 records,
    gathered by n_threads threads into one (len(indices), record_floats) array."""
    indices = np.ascontiguousarray(indices, np.int64)
    if base.dtype != np.float32 or not base.flags.c_contiguous:
        raise ValueError("gather_records: base must be C-contiguous float32")
    n_records = base.size // record_floats
    if len(indices) and (indices.min() < 0 or indices.max() >= n_records):
        raise IndexError(f"gather_records: an index outside [0, {n_records})")
    out = np.empty((len(indices), record_floats), np.float32)
    get_lib().gather_records(base.reshape(-1), indices, len(indices), record_floats, out,
                             n_threads)
    return out


def gather_records_plain(base: np.ndarray, indices: np.ndarray,
                         record_floats: int) -> np.ndarray:
    """numpy version of `gather_records`."""
    return base.reshape(-1, record_floats)[np.asarray(indices, np.int64)].copy()
