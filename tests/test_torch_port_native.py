"""Port parity, the native host ops of the data layer (flowcompare_tpu_torch/native).

The port's own copy of native_ops.cpp against the JAX package's build of
its copy and against the port's numpy bodies (`*_plain`): voxel ids, FPS
indices and gathered records index-equal, on random and on tie-heavy
clouds (duplicated points, integer lattices, points on cell faces). The
build: into build/flowcompare_tpu_torch/ under a hashed name, raising
with g++'s output where the JAX module falls back to numpy, safe when
processes build at the same moment; and the port imports with JAX
blocked.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import flowcompare_tpu_torch.data as pdata
from flowcompare_tpu import native as jax_native
from flowcompare_tpu.data import transforms as jax_transforms
from flowcompare_tpu_torch import native

REPO = Path(__file__).resolve().parents[1]


def _cloud(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.normal(size=(n, 6)).astype(np.float32)
    if kind == "duplicates":       # every point four times: ties in every pick
        base = rng.normal(size=(n // 4, 6)).astype(np.float32)
        return np.repeat(base, 4, axis=0)[rng.permutation(n)]
    if kind == "lattice":          # integer coordinates: many equal distances
        return rng.integers(-3, 4, (n, 6)).astype(np.float32)
    raise ValueError(kind)


CLOUDS = [(kind, n, m) for kind in ("random", "duplicates", "lattice")
          for n, m in ((200, 64), (1500, 1024))]


@pytest.mark.parametrize("kind,n,m", CLOUDS)
def test_fps_indices_equal_jax_and_plain(kind, n, m):
    pts = _cloud(kind, n, seed=n + len(kind))
    got = native.fps_indices(pts, m)
    assert got.dtype == np.int64 and got.shape == (m,) and got[0] == 0
    np.testing.assert_array_equal(got, jax_native.fps_indices(pts, m))
    np.testing.assert_array_equal(got, native.fps_indices_plain(pts, m))


@pytest.mark.parametrize("kind", ["random", "lattice", "faces"])
def test_voxelize_grid_equal_jax_and_plain(kind):
    rng = np.random.default_rng(3)
    size = np.array([2.0, 2.0, 4.0], np.float32)
    if kind == "faces":            # every coordinate on a cell face, some past the grid
        pts = (rng.integers(-6, 7, (3000, 6)) * np.tile(size, 2)).astype(np.float32)
    else:
        pts = _cloud(kind, 3000, seed=4) * 3
    start = pts[:, :3].min(0) + (1.0 if kind == "faces" else 0.0)
    steps = np.floor((pts[:, :3].max(0) - start) / size).astype(np.int64)
    got = native.voxelize_grid(pts, start, size, steps)
    np.testing.assert_array_equal(got, jax_native.voxelize_grid(pts, start, size, steps))
    np.testing.assert_array_equal(got, native.voxelize_grid_plain(pts, start, size, steps))
    assert got.min() >= 0 and got.max() < np.prod(steps)


@pytest.mark.parametrize("n_threads", [1, 4])
def test_gather_records_equal_jax_and_plain(tmp_path, n_threads):
    rng = np.random.default_rng(5)
    base = rng.normal(size=(50 * 37,)).astype(np.float32)
    mapped = np.memmap(tmp_path / "records.bin", np.float32, mode="w+", shape=base.shape)
    mapped[:] = base
    mapped.flush()
    mapped = np.memmap(tmp_path / "records.bin", np.float32, mode="r", shape=base.shape)
    idx = np.concatenate([rng.integers(0, 50, 29), [0, 49, 49]])
    got = native.gather_records(mapped, idx, 37, n_threads)
    np.testing.assert_array_equal(got, jax_native.gather_records(mapped, idx, 37, n_threads))
    np.testing.assert_array_equal(got, native.gather_records_plain(base, idx, 37))
    with pytest.raises(IndexError):
        native.gather_records(mapped, np.array([50]), 37)


@pytest.mark.parametrize("n,m", [(100, 100), (37, 128), (1, 16)])
def test_fps_numpy_oversampling_draws_equal_jax(n, m):
    """With n <= m, fps_numpy oversamples from the caller's generator: the
    same draws in the same order, so the generators end in the same state."""
    pts = _cloud("random", n, seed=n)
    rng_p, rng_j = np.random.default_rng(9), np.random.default_rng(9)
    np.testing.assert_array_equal(pdata.fps_numpy(pts, m, rng_p),
                                  jax_transforms.fps_numpy(pts, m, rng_j))
    assert rng_p.integers(1 << 62) == rng_j.integers(1 << 62)


def test_library_is_built_under_build_dir_with_hashed_name():
    path = native.library_path("native_ops.cpp")
    assert path.parent == REPO / "build" / "flowcompare_tpu_torch"
    assert re.fullmatch(r"libnative_ops_[0-9a-f]{16}\.so", path.name)
    assert native.build_library("native_ops.cpp") == path and path.exists()
    assert native.library_path("laz_codec.cpp").name.startswith("liblaz_codec_")


def _run(script: str, env=None, timeout=120) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(script)], cwd=REPO,
                          capture_output=True, text=True, env=env, timeout=timeout)


def test_failed_build_raises_and_never_falls_back(tmp_path):
    """A g++ that fails (first on PATH) and a fresh build directory: every
    native entry point raises with g++'s output; the LAZ reader keeps its
    conversion advice."""
    fake = tmp_path / "bin"
    fake.mkdir()
    (fake / "g++").write_text("#!/bin/sh\necho 'planted compiler failure' >&2\nexit 1\n")
    (fake / "g++").chmod(0o755)
    env = {**os.environ, "PATH": f"{fake}{os.pathsep}{os.environ['PATH']}"}
    out = _run(f"""
        from pathlib import Path
        import numpy as np
        from flowcompare_tpu_torch import native
        from flowcompare_tpu_torch.data import las_io, laz
        native.BUILD_DIR = Path({str(tmp_path / 'fresh')!r})
        pts = np.zeros((10, 3), np.float32)
        for call in (lambda: native.fps_indices(pts, 4),
                     lambda: native.voxelize_grid(pts, [0, 0, 0], [1, 1, 1], [2, 2, 2]),
                     lambda: native.gather_records(pts.reshape(-1), np.array([0]), 3),
                     lambda: laz.write_laz({str(tmp_path / 'x.laz')!r}, pts)):
            try:
                call()
            except native.NativeBuildError as e:
                assert "planted compiler failure" in str(e), e
            else:
                raise SystemExit("no error")
        try:
            las_io.load_cloud({str(tmp_path / 'y.laz')!r})
        except ImportError as e:
            assert "planted compiler failure" in str(e) and "laszip -i" in str(e), e
        else:
            raise SystemExit("no error")
        assert not any(Path({str(tmp_path / 'fresh')!r}).glob("*.so")), "a library appeared"
        print("raised")
    """, env=env)
    assert out.returncode == 0 and out.stdout.strip() == "raised", out.stderr


def test_concurrent_builds_into_one_directory(tmp_path):
    """Four processes build the same library into one fresh directory at
    once: each loads a whole library (the temporary file moved into place),
    and no temporary file is left."""
    script = f"""
        from pathlib import Path
        import numpy as np
        from flowcompare_tpu_torch import native
        native.BUILD_DIR = Path({str(tmp_path)!r})
        pts = np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32)
        assert (native.fps_indices(pts, 50) == native.fps_indices_plain(pts, 50)).all()
        print("ok")
    """
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(script)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 and o.strip() == "ok" for p, (o, _) in zip(procs, outs)), outs
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 1 and names[0].startswith("libnative_ops_"), names


def test_port_imports_with_jax_blocked():
    out = _run("""
        import sys
        sys.modules["jax"] = None
        import flowcompare_tpu_torch.data
        import flowcompare_tpu_torch
        assert not any(m == "flowcompare_tpu" or m.startswith("flowcompare_tpu.")
                       for m in sys.modules)
        print(flowcompare_tpu_torch.SyntheticVoxelDataset.__module__)
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "flowcompare_tpu_torch.data.synthetic"


def test_port_sources_import_nothing_of_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import flowcompare_tpu\b|"
                         r"from flowcompare_tpu(\.| ))", re.M)
    files = [*sorted((REPO / "flowcompare_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py"]
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}" for f in files
            for m in pattern.finditer(f.read_text())]
    assert len(files) > 40 and not hits, hits
