"""LAZ (LASzip-compressed LAS) reader/writer on the native codec.

Counterpart of `flowcompare_tpu/data/laz.py` over the port's copy of its
codec (`native/laz_codec.cpp`, ctypes-bound here and built at first use
by `native.build_library`): the arithmetic coder and the v2 item codecs
live in C++; this module handles the LAS container — public header, the
"laszip encoded" VLR (record 22204), the chunk table — and turns records
into numpy arrays. `write_laz` writes the JAX package's bytes exactly.

Supported: LAS 1.0-1.3 containers, point formats 0-3 (POINT10 /
GPSTIME11 / RGB12 items + trailing BYTE extras), compressor 2
("pointwise chunked", the LASzip default) with fixed-size chunks, item
codec version 2 (what laszip/lazrs emit by default). Encode and decode
are exact inverses; conformance with the reference LASzip bitstream is
targeted, not certified, so `read_laz` also guards against a stream that
decodes out of step: every point must fall inside the header's bounding
box (with a slack of two quantization steps), the chunk table's count is
bounded by the file size, and the laszip VLR must hold its item list.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np

from .. import native

_lib: Optional[ctypes.CDLL] = None

# laz_encode's code for a destination buffer too small (native/laz_codec.cpp);
# its other error, a bad item layout, is -1
_ERR_CAPACITY = -2
# LASzip constants
_LASZIP_USER_ID = b"laszip encoded\x00\x00"
_LASZIP_RECORD_ID = 22204
_COMPRESSOR_POINTWISE_CHUNKED = 2
_ITEM_BYTE, _ITEM_POINT10, _ITEM_GPSTIME11, _ITEM_RGB12 = 0, 6, 7, 8
_ITEM_SIZE = {_ITEM_POINT10: 20, _ITEM_GPSTIME11: 8, _ITEM_RGB12: 6}
_DEFAULT_CHUNK = 50000
# standard point record sizes and the items making up formats 0-3
_FMT_ITEMS = {
    0: [_ITEM_POINT10],
    1: [_ITEM_POINT10, _ITEM_GPSTIME11],
    2: [_ITEM_POINT10, _ITEM_RGB12],
    3: [_ITEM_POINT10, _ITEM_GPSTIME11, _ITEM_RGB12],
}
_FMT_SIZE = {0: 20, 1: 28, 2: 26, 3: 34}


def get_lib() -> ctypes.CDLL:
    """Build the codec on first use (raises `native.NativeBuildError` with
    g++'s output when it cannot), load it and declare its signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native.build_library("laz_codec.cpp")))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.laz_decode.argtypes = [u8p, ctypes.c_int64, i64p, i64p,
                                   ctypes.c_int64, u16p, ctypes.c_int32,
                                   ctypes.c_int32, u8p]
        lib.laz_decode.restype = ctypes.c_int64
        lib.laz_encode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u16p,
                                   ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_int64, u8p, ctypes.c_int64, i64p]
        lib.laz_encode.restype = ctypes.c_int64
        lib.laz_decode_chunk_table.argtypes = [u8p, ctypes.c_int64,
                                               ctypes.c_int64, i64p]
        lib.laz_decode_chunk_table.restype = ctypes.c_int64
        lib.laz_encode_chunk_table.argtypes = [i64p, ctypes.c_int64, u8p,
                                               ctypes.c_int64]
        lib.laz_encode_chunk_table.restype = ctypes.c_int64
        _lib = lib
    return _lib


class LazError(ValueError):
    pass


def _parse_header(buf: bytes, path: str):
    if len(buf) < 227:
        raise LazError(f"{path}: {len(buf)} bytes, shorter than a LAS header")
    if buf[:4] != b"LASF":
        raise LazError(f"{path}: not a LAS/LAZ file (bad magic)")
    ver = struct.unpack_from("<BB", buf, 24)
    if ver > (1, 3):
        raise LazError(f"{path}: LAS {ver[0]}.{ver[1]} containers are not "
                       "supported by the built-in LAZ reader")
    (header_size,) = struct.unpack_from("<H", buf, 94)
    (offset_to_points,) = struct.unpack_from("<I", buf, 96)
    (n_vlrs,) = struct.unpack_from("<I", buf, 100)
    (fmt_raw,) = struct.unpack_from("<B", buf, 104)
    (rec_len,) = struct.unpack_from("<H", buf, 105)
    (n_points,) = struct.unpack_from("<I", buf, 107)
    scale = np.array(struct.unpack_from("<3d", buf, 131))
    offset = np.array(struct.unpack_from("<3d", buf, 155))
    bounds = np.array(struct.unpack_from("<6d", buf, 179)).reshape(3, 2)
    return dict(version=ver, header_size=header_size,
                offset_to_points=offset_to_points, n_vlrs=n_vlrs,
                fmt=fmt_raw & 0x3F, compressed=bool(fmt_raw & 0x80),
                rec_len=rec_len, n_points=n_points, scale=scale,
                offset=offset, bbox_max=bounds[:, 0], bbox_min=bounds[:, 1])


def _find_laszip_vlr(buf: bytes, header) -> Optional[bytes]:
    pos = header["header_size"]
    for _ in range(header["n_vlrs"]):
        if pos + 54 > len(buf):
            break
        user_id = buf[pos + 2:pos + 18]
        (record_id,) = struct.unpack_from("<H", buf, pos + 18)
        (length,) = struct.unpack_from("<H", buf, pos + 20)
        payload = buf[pos + 54:pos + 54 + length]
        pos += 54 + length
        if user_id.rstrip(b"\x00") == _LASZIP_USER_ID.rstrip(b"\x00") \
                and record_id == _LASZIP_RECORD_ID:
            return payload
    return None


def _parse_laszip_vlr(payload: bytes, path: str):
    if len(payload) < 34:
        raise LazError(f"{path}: truncated laszip VLR")
    compressor, coder, vmaj, vmin, vrev, options, chunk_size = \
        struct.unpack_from("<HHBBHII", payload, 0)
    num_items = struct.unpack_from("<H", payload, 32)[0]
    if len(payload) < 34 + 6 * num_items:
        raise LazError(f"{path}: laszip VLR of {len(payload)} bytes is too "
                       f"short for its {num_items} items "
                       f"({34 + 6 * num_items} bytes)")
    items = []
    for i in range(num_items):
        t, s, v = struct.unpack_from("<HHH", payload, 34 + 6 * i)
        items.append((t, s, v))
    if compressor != _COMPRESSOR_POINTWISE_CHUNKED:
        raise LazError(
            f"{path}: laszip compressor {compressor} is not supported "
            "(only 2 = pointwise-chunked, the LASzip default)")
    if coder != 0:
        raise LazError(f"{path}: unknown laszip entropy coder {coder}")
    if chunk_size in (0, 0xFFFFFFFF):
        raise LazError(f"{path}: variable-size LAZ chunks are not supported")
    for t, s, v in items:
        if t not in (_ITEM_BYTE, _ITEM_POINT10, _ITEM_GPSTIME11, _ITEM_RGB12):
            raise LazError(f"{path}: unsupported LAZ item type {t} "
                           "(point formats > 5 / LAS 1.4 layered items)")
        # v1 item codecs are DIFFERENT bitstreams (e.g. BYTE v1 is an
        # 8-bit corrector compressor, not per-byte diff models) — decoding
        # them with the v2 scheme would desynchronize the shared
        # arithmetic stream and silently corrupt every later field, so
        # reject loudly
        if v != 2:
            raise LazError(
                f"{path}: LAZ item {t} uses codec version {v}; only "
                "version 2 (the LASzip default) is supported")
    return dict(chunk_size=chunk_size, items=items)


def read_laz(path: str) -> dict:
    """Decode a .laz file into a dict of numpy arrays.

    Returns keys: xyz (N,3) f64, rgb (N,3) u16 (zeros if absent),
    gps_time (N,) f64 (zeros if absent), intensity (N,) u16,
    classification (N,) u8, point_records (N, rec_len) u8 raw.
    """
    lib = get_lib()
    with open(path, "rb") as f:
        buf = f.read()
    header = _parse_header(buf, path)
    payload = _find_laszip_vlr(buf, header)
    if payload is None:
        raise LazError(f"{path}: no laszip VLR — is this an uncompressed "
                       ".las renamed to .laz?")
    vlr = _parse_laszip_vlr(payload, path)
    n = header["n_points"]
    rec_len = header["rec_len"]
    item_types = np.array([t for t, _, _ in vlr["items"]], np.uint16)
    std_size = sum(_ITEM_SIZE.get(t, 0) for t, _, _ in vlr["items"])
    extra = 0
    for t, s, _ in vlr["items"]:
        if t == _ITEM_BYTE:
            extra = s
    if std_size + extra != rec_len:
        raise LazError(f"{path}: item sizes {std_size}+{extra} do not match "
                       f"the header record length {rec_len}")

    records = np.zeros((max(n, 1), rec_len), np.uint8)
    if n:
        data_start = header["offset_to_points"]
        (chunk_table_off,) = struct.unpack_from("<q", buf, data_start)
        chunk_size = vlr["chunk_size"]
        n_chunks = (n + chunk_size - 1) // chunk_size
        if chunk_table_off < 0 or chunk_table_off + 8 > len(buf):
            raise LazError(f"{path}: bad chunk table offset "
                           f"{chunk_table_off} (unfinished laszip write?)")
        version, stored_chunks = struct.unpack_from(
            "<II", buf, chunk_table_off)
        if version != 0:
            raise LazError(f"{path}: unknown chunk table version {version}")
        if stored_chunks < n_chunks:
            raise LazError(f"{path}: chunk table has {stored_chunks} entries,"
                           f" expected >= {n_chunks}")
        # every chunk holds at least its raw first point, so a count past
        # the file's size is corrupt: refuse before allocating for it
        if stored_chunks > len(buf):
            raise LazError(f"{path}: chunk table claims {stored_chunks} "
                           f"chunks in a file of {len(buf)} bytes")
        # zero-copy read-only views are fine: the C side takes const input
        table_payload = np.frombuffer(
            buf, np.uint8, offset=chunk_table_off + 8,
            count=len(buf) - chunk_table_off - 8)
        chunk_bytes = np.zeros(stored_chunks, np.int64)
        rc = lib.laz_decode_chunk_table(
            table_payload, len(table_payload), stored_chunks, chunk_bytes)
        if rc != 0:
            raise LazError(f"{path}: chunk table decode failed ({rc})")
        chunk_starts = data_start + 8 + np.concatenate(
            [[0], np.cumsum(chunk_bytes[:n_chunks - 1])]).astype(np.int64)
        chunk_counts = np.full(n_chunks, chunk_size, np.int64)
        chunk_counts[-1] = n - chunk_size * (n_chunks - 1)
        src = np.frombuffer(buf, np.uint8)
        rc = lib.laz_decode(src, len(src), chunk_starts, chunk_counts,
                            n_chunks, item_types, len(item_types), extra,
                            records)
        if rc != 0:
            raise LazError(f"{path}: point decode failed ({rc})")
    records = records[:n]

    out = {"point_records": records}
    xyz_i = records[:, :12].copy().view("<i4").reshape(n, 3)
    out["xyz"] = xyz_i.astype(np.float64) * header["scale"] + header["offset"]
    _check_bounds(out["xyz"], header, path)
    out["intensity"] = records[:, 12:14].copy().view("<u2").ravel()
    out["classification"] = records[:, 15].copy()
    fmt = header["fmt"]
    gps_off = 20 if fmt in (1, 3) else None
    rgb_off = {2: 20, 3: 28}.get(fmt)
    if gps_off is not None:
        out["gps_time"] = records[:, gps_off:gps_off + 8].copy() \
            .view("<f8").ravel()
    else:
        out["gps_time"] = np.zeros(n, np.float64)
    if rgb_off is not None:
        out["rgb"] = records[:, rgb_off:rgb_off + 6].copy() \
            .view("<u2").reshape(n, 3)
    else:
        out["rgb"] = np.zeros((n, 3), np.uint16)
    out["scale"] = header["scale"]
    out["offset"] = header["offset"]
    out["point_format"] = fmt
    return out


def _check_bounds(xyz: np.ndarray, header: dict, path: str) -> None:
    """A stream decoded out of step yields points far outside the header's
    bounding box: raise instead of returning them. The slack of two
    quantization steps covers the writer's rounding."""
    if not len(xyz):
        return
    slack = 2 * np.abs(header["scale"])
    lo, hi = header["bbox_min"] - slack, header["bbox_max"] + slack
    outside = ~np.all((xyz >= lo) & (xyz <= hi), axis=1)
    if outside.any():
        i = int(np.flatnonzero(outside)[0])
        raise LazError(
            f"{path}: {int(outside.sum())} of {len(xyz)} decoded points lie "
            f"outside the header's bounding box [{header['bbox_min']}, "
            f"{header['bbox_max']}] (the first, point {i}: {xyz[i]}); the "
            "stream is corrupt or not decodable by this codec")


def load_cloud_laz(path: str) -> np.ndarray:
    """(N, 6) xyz + rgb/65536 — the original FlowCompare's load_las contract."""
    d = read_laz(path)
    rgb = d["rgb"].astype(np.float64) / 65536.0
    return np.concatenate([d["xyz"], rgb], axis=-1)


def write_laz(path: str, points: np.ndarray, *,
              gps_time: Optional[np.ndarray] = None,
              chunk_size: int = _DEFAULT_CHUNK,
              scale: float = 1e-4) -> None:
    """Write (N, >=3) points (cols 3:6 = rgb in [0,1] if present) as a
    LAZ-compressed LAS 1.2 file (point format 3 when gps_time is given,
    else format 2), mirroring data/las_io.save_las's conventions.
    """
    lib = get_lib()
    points = np.asarray(points, np.float64)
    n = len(points)
    xyz = points[:, :3] if n else np.zeros((0, 3))
    rgb01 = (np.clip(points[:, 3:6], 0.0, 1.0) if points.shape[1] >= 6 and n
             else np.zeros((n, 3)))
    fmt = 3 if gps_time is not None else 2
    rec_len = _FMT_SIZE[fmt]
    offset = xyz.min(axis=0) if n else np.zeros(3)
    scale_v = np.full(3, scale)
    if n:
        extent = xyz.max(axis=0) - offset
        need = extent / (2 ** 31 - 2)
        scale_v = np.maximum(scale_v, 10.0 ** np.ceil(np.log10(
            np.maximum(need, 1e-12))))

    # raw records
    rec = np.zeros((n, rec_len), np.uint8)
    if n:
        xyz_i = np.round((xyz - offset) / scale_v).astype("<i4")
        rec[:, :12] = xyz_i.view(np.uint8).reshape(n, 12)
        rec[:, 14] = 0x09  # return 1 of 1
        rgb_off = {2: 20, 3: 28}[fmt]
        rgb_u = np.round(rgb01 * 65535.0).astype("<u2")
        rec[:, rgb_off:rgb_off + 6] = rgb_u.view(np.uint8).reshape(n, 6)
        if gps_time is not None:
            g = np.asarray(gps_time, "<f8").reshape(n, 1)
            rec[:, 20:28] = g.view(np.uint8)

    items = [(t, _ITEM_SIZE[t], 2) for t in _FMT_ITEMS[fmt]]
    item_types = np.array([t for t, _, _ in items], np.uint16)

    # compress
    n_chunks = (n + chunk_size - 1) // chunk_size if n else 0
    chunk_bytes = np.zeros(max(n_chunks, 1), np.int64)
    comp = np.zeros(0, np.uint8)
    if n:
        # the arithmetic coder's worst case EXPANDS high-entropy input
        # (a random 32-bit delta costs ~50 coded bits vs 32 raw) — retry
        # with doubled capacity instead of failing on valid data; any
        # other error is permanent
        flat = np.ascontiguousarray(rec.reshape(-1))
        cap = n * rec_len + 4096 + 16 * n_chunks
        for _ in range(3):
            dst = np.zeros(cap, np.uint8)
            total = lib.laz_encode(flat, n, rec_len, item_types,
                                   len(item_types), 0, chunk_size, dst,
                                   cap, chunk_bytes)
            if total != _ERR_CAPACITY:
                break
            cap *= 2
        if total == _ERR_CAPACITY:
            raise LazError(f"laz_encode: the compressed points outgrew "
                           f"{cap // 2} bytes (4x the first capacity)")
        if total < 0:
            raise LazError(f"laz_encode failed ({total}): items {items} "
                           f"against {rec_len}-byte records")
        comp = dst[:total]
    table = np.zeros(16 * max(n_chunks, 1) + 64, np.uint8)
    table_len = lib.laz_encode_chunk_table(
        chunk_bytes, n_chunks, table, len(table)) if n_chunks else 0
    if table_len < 0:
        raise LazError("chunk table encode overflow")

    # laszip VLR payload
    vlr_payload = struct.pack("<HHBBHII", _COMPRESSOR_POINTWISE_CHUNKED, 0,
                              2, 2, 0, 0, chunk_size)
    vlr_payload += struct.pack("<qq", -1, -1)   # no special EVLRs
    vlr_payload += struct.pack("<H", len(items))
    for t, s, v in items:
        vlr_payload += struct.pack("<HHH", t, s, v)
    vlr = struct.pack("<H", 0) + _LASZIP_USER_ID + \
        struct.pack("<HH", _LASZIP_RECORD_ID, len(vlr_payload)) + \
        b"flowcompare_tpu laz codec\x00".ljust(32, b"\x00")[:32] + vlr_payload

    header_size = 227
    offset_to_points = header_size + len(vlr)
    header = bytearray(header_size)
    header[:4] = b"LASF"
    struct.pack_into("<BB", header, 24, 1, 2)
    header[26:26 + 13] = b"flowcompare\x00\x00"
    header[58:58 + 15] = b"flowcompare_tpu"
    struct.pack_into("<H", header, 94, header_size)
    struct.pack_into("<I", header, 96, offset_to_points)
    struct.pack_into("<I", header, 100, 1)                 # one VLR
    struct.pack_into("<B", header, 104, fmt | 0x80)        # laz bit
    struct.pack_into("<H", header, 105, rec_len)
    struct.pack_into("<I", header, 107, n)
    struct.pack_into("<3d", header, 131, *scale_v)
    struct.pack_into("<3d", header, 155, *offset)
    if n:
        mins, maxs = xyz.min(axis=0), xyz.max(axis=0)
    else:
        mins = maxs = np.zeros(3)
    struct.pack_into("<6d", header, 179, maxs[0], mins[0], maxs[1],
                     mins[1], maxs[2], mins[2])

    chunk_table_off = offset_to_points + 8 + int(comp.size)
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(vlr)
        f.write(struct.pack("<q", chunk_table_off))
        f.write(comp.tobytes())
        f.write(struct.pack("<II", 0, n_chunks))
        f.write(table[:table_len].tobytes())
