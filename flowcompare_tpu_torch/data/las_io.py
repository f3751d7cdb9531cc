"""Point-cloud file IO.

Counterpart of `flowcompare_tpu/data/las_io.py` (itself the counterpart of
the original FlowCompare `utils.load_las` / `utils.save_las`): reads a
las/laz file into an (N, 6) float array of xyz + rgb scaled to [0, 1], and
writes one back. laspy is optional and used when present; without it:
  * `.npy`/`.npz` clouds,
  * a dependency-free minimal **LAS 1.2** reader/writer (uncompressed
    `.las`, point formats 0-3) on numpy below, which refuses LAS 1.4, and
  * the native **LASzip `.laz`** codec (`data/laz.py` over
    `native/laz_codec.cpp`) for `.laz`.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from . import laz
from ..native import NativeBuildError

# LAS 1.2 public header block is 227 bytes; we write point format 2
# (xyz int32 + intensity + flags + classification + scan angle + user
# data + point source id + RGB u16) = 26-byte records.
_HEADER_SIZE = 227
_POINT_FMT = {
    0: 20, 1: 28, 2: 26, 3: 34,   # format id -> record length
}
_RGB_OFFSET = {2: 20, 3: 28}       # byte offset of red within the record


def _read_las_numpy(path: str) -> np.ndarray:
    """Minimal LAS 1.1/1.2 reader (uncompressed): xyz + rgb/65536."""
    with open(path, "rb") as f:
        header = f.read(_HEADER_SIZE)
        if header[:4] != b"LASF":
            raise ValueError(f"{path}: not a LAS file (bad magic)")
        ver_major, ver_minor = struct.unpack_from("<BB", header, 24)
        if (ver_major, ver_minor) > (1, 3):
            # LAS 1.4 moved the point count to a 64-bit field at offset 247
            # and may legitimately zero the legacy u32 count this reader
            # uses — decoding would silently return an EMPTY cloud
            raise ValueError(
                f"{path}: LAS {ver_major}.{ver_minor} is not supported by "
                "the built-in reader (legacy point count may be zeroed); "
                "install laspy to read it")
        (offset_to_points,) = struct.unpack_from("<I", header, 96)
        (fmt,) = struct.unpack_from("<B", header, 104)
        fmt &= 0x3F   # high bits flag laz compression in some writers
        (rec_len,) = struct.unpack_from("<H", header, 105)
        (n_points,) = struct.unpack_from("<I", header, 107)
        scale = np.array(struct.unpack_from("<3d", header, 131))
        offset = np.array(struct.unpack_from("<3d", header, 155))
        if fmt not in _POINT_FMT:
            raise ValueError(f"{path}: unsupported LAS point format {fmt}")
        f.seek(offset_to_points)
        raw = f.read(n_points * rec_len)
    rec = np.frombuffer(raw, dtype=np.uint8).reshape(n_points, rec_len)
    xyz_i = rec[:, :12].copy().view("<i4").reshape(n_points, 3)
    xyz = xyz_i.astype(np.float64) * scale + offset
    if fmt in _RGB_OFFSET:
        o = _RGB_OFFSET[fmt]
        rgb_u = rec[:, o:o + 6].copy().view("<u2").reshape(n_points, 3)
        rgb = rgb_u.astype(np.float64) / 65536.0
    else:
        rgb = np.zeros_like(xyz)
    return np.concatenate([xyz, rgb], axis=-1)


def save_las(path: str, points: np.ndarray) -> None:
    """Write (N, >=3) points (cols 3:6 = rgb in [0,1] if present) as an
    uncompressed LAS 1.2 point-format-2 file. Dependency-free."""
    points = np.asarray(points, np.float64)
    xyz = points[:, :3]
    n = len(points)
    rgb01 = (np.clip(points[:, 3:6], 0.0, 1.0) if points.shape[1] >= 6
             else np.zeros_like(xyz))
    offset = xyz.min(axis=0) if n else np.zeros(3)
    # 1e-4 (0.1 mm) covers extents to ~214 km in int32; widen the scale for
    # larger clouds instead of letting astype('<i4') silently wrap.
    scale = np.full(3, 1e-4)
    if n:
        extent = xyz.max(axis=0) - offset
        need = extent / (2 ** 31 - 2)       # minimum representable scale
        scale = np.maximum(scale, 10.0 ** np.ceil(np.log10(
            np.maximum(need, 1e-12))))
    rec_len = _POINT_FMT[2]

    header = bytearray(_HEADER_SIZE)
    header[:4] = b"LASF"
    struct.pack_into("<BB", header, 24, 1, 2)          # version 1.2
    header[26:26 + 13] = b"flowcompare\x00\x00"        # system identifier
    header[58:58 + 15] = b"flowcompare_tpu"            # generating software
    struct.pack_into("<H", header, 94, _HEADER_SIZE)
    struct.pack_into("<I", header, 96, _HEADER_SIZE)   # points follow header
    struct.pack_into("<I", header, 100, 0)             # no VLRs
    struct.pack_into("<B", header, 104, 2)             # point format 2
    struct.pack_into("<H", header, 105, rec_len)
    struct.pack_into("<I", header, 107, n)
    struct.pack_into("<3d", header, 131, *scale)
    struct.pack_into("<3d", header, 155, *offset)
    if n:
        mins, maxs = xyz.min(axis=0), xyz.max(axis=0)
    else:
        mins = maxs = np.zeros(3)
    struct.pack_into("<6d", header, 179, maxs[0], mins[0], maxs[1],
                     mins[1], maxs[2], mins[2])

    rec = np.zeros((n, rec_len), np.uint8)
    xyz_i = np.round((xyz - offset) / scale).astype("<i4")
    rec[:, :12] = xyz_i.view(np.uint8).reshape(n, 12)
    rgb_u = np.round(rgb01 * 65535.0).astype("<u2")
    rec[:, 20:26] = rgb_u.view(np.uint8).reshape(n, 6)
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())


def _load_laz_native(path: str) -> np.ndarray:
    try:
        laz.get_lib()
    except NativeBuildError as e:
        raise ImportError(
            f"{path}: reading compressed .laz needs the native LAZ codec "
            "(g++ to build native/laz_codec.cpp) or laspy+lazrs "
            "(`pip install laspy[lazrs]`); neither is available. Convert the "
            "corpus off-box first: either decompress to .las (`laszip -i "
            "tile.laz -o tile.las`, then point the loader at the .las files "
            "via cloud_ext='.las'), or freeze prepared items into a mmap'd "
            "pack file (`pack_dataset`) on a machine that can read them and "
            f"train here on `PackedVoxelDataset`.\n{e}") from e
    return laz.load_cloud_laz(path)


def load_cloud(path: str) -> np.ndarray:
    """Load a cloud from .las/.laz (laspy when present; built-in numpy
    reader for uncompressed .las) or .npy/.npz -> (N, >=6) f64.

    las path matches the original FlowCompare: xyz + (red, green, blue) / 65536.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext in (".las", ".laz"):
        try:
            import laspy  # optional dependency, gated
        except ImportError:
            if ext == ".laz":
                # native from-scratch LASzip codec (data/laz.py +
                # native/laz_codec.cpp): covers compressor-2 point
                # formats 0-3, i.e. the AMS corpus layout
                return _load_laz_native(path)
            return _read_las_numpy(path)
        try:
            with laspy.open(path) as f:
                las = f.read()
        except Exception:
            # laspy without a LAZ backend raises LaspyException (NOT
            # ImportError) on .laz — fall through to the native codec
            # when it can take over, else re-raise laspy's error
            if ext == ".laz":
                return _load_laz_native(path)
            raise
        xyz = np.stack([np.asarray(las.x), np.asarray(las.y),
                        np.asarray(las.z)], axis=-1)
        try:
            rgb = np.stack([np.asarray(las.red), np.asarray(las.green),
                            np.asarray(las.blue)], axis=-1) / 65536.0
        except AttributeError:
            rgb = np.zeros_like(xyz)
        return np.concatenate([xyz, rgb], axis=-1).astype(np.float64)
    if ext == ".npy":
        return np.load(path).astype(np.float64)
    if ext == ".npz":
        with np.load(path) as z:
            key = "points" if "points" in z else list(z.keys())[0]
            return z[key].astype(np.float64)
    raise ValueError(f"Unsupported cloud format: {path}")


# the original FlowCompare's name
load_las = load_cloud
