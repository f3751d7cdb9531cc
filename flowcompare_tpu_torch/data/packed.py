"""Packed on-disk dataset: preprocessed voxel pairs as one mmap'd file.

Counterpart of `flowcompare_tpu/data/packed.py`, with the same file format
byte for byte, so a pack written by either package reads in the other. An
offline tool writes finished items once into a flat binary file, and
training reads them back through a zero-copy mmap and the native
multithreaded batch gatherer (native/native_ops.cpp::gather_records).

File layout: 4-byte magic, 8-byte little-endian data offset, 8-byte header
length, JSON header {n_items, fields: [{name, shape}], record_floats}
padded with spaces, then n_items records of concatenated flattened fields.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import native

MAGIC = b"FCPK"


def write_packed(path: str, items: Iterator[Sequence[np.ndarray]],
                 field_names: Optional[List[str]] = None) -> dict:
    """Stream items (tuples of fixed-shape float arrays) into a pack file."""
    it = iter(items)
    first = next(it)
    field_names = field_names or [f"f{i}" for i in range(len(first))]
    fields = [{"name": n, "shape": list(np.asarray(a).shape)}
              for n, a in zip(field_names, first)]
    record_floats = int(sum(np.prod(f["shape"]) for f in fields))

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n_items = 0
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<q", 0))            # header-length placeholder
        header_pos = f.tell()
        header = {"n_items": 0, "fields": fields,
                  "record_floats": record_floats}
        # reserve room for the final n_items value (unknown while streaming)
        hdr_bytes = json.dumps(header).encode() + b" " * 24
        f.write(struct.pack("<q", len(hdr_bytes)))
        f.write(hdr_bytes)
        data_start = f.tell()

        def write_item(item):
            rec = np.concatenate(
                [np.asarray(a, np.float32).reshape(-1) for a in item])
            assert rec.size == record_floats, "inconsistent item shapes"
            f.write(rec.tobytes())

        write_item(first)
        n_items = 1
        for item in it:
            write_item(item)
            n_items += 1

        # back-patch the final header into the reserved space
        f.seek(4)
        f.write(struct.pack("<q", data_start))
        f.seek(header_pos)
        header["n_items"] = n_items
        hdr2 = json.dumps(header).encode()
        pad = len(hdr_bytes) - len(hdr2)
        if pad < 0:
            raise ValueError(f"header overflow: {n_items} items")
        f.write(struct.pack("<q", len(hdr_bytes)))
        f.write(hdr2 + b" " * pad)
    return {"n_items": n_items, "record_floats": record_floats,
            "fields": fields}


class PackedVoxelDataset:
    """mmap-backed batch source over a pack file.

    Yields tuples in field order (reshaped to (B, *field_shape)); an `extra`
    field of shape (1,) comes back as (B, 1) matching the live-loader
    contract.
    """

    def __init__(self, path: str, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True, n_threads: int = 4,
                 with_extra: bool = True):
        with open(path, "rb") as f:
            assert f.read(4) == MAGIC, "not a pack file"
            struct.unpack("<q", f.read(8))
            (hdr_len,) = struct.unpack("<q", f.read(8))
            self.header = json.loads(f.read(hdr_len).decode())
            data_start = f.tell()
        self.record_floats = self.header["record_floats"]
        self.n_items = self.header["n_items"]
        self.fields = self.header["fields"]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.n_threads = n_threads
        self.with_extra = with_extra
        self._epoch = 0
        raw = np.memmap(path, np.float32, mode="r", offset=data_start,
                        shape=(self.n_items * self.record_floats,))
        self._base = raw

    def __len__(self):
        n = self.n_items // self.batch_size
        return n if self.drop_last else -(-self.n_items // self.batch_size)

    def _split(self, flat: np.ndarray) -> Tuple[np.ndarray, ...]:
        out = []
        off = 0
        b = flat.shape[0]
        for fld in self.fields:
            size = int(np.prod(fld["shape"]))
            out.append(flat[:, off:off + size].reshape([b] + fld["shape"]))
            off += size
        return tuple(out)

    def __iter__(self):
        order = np.arange(self.n_items)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
            self._epoch += 1
        n = len(order) - (len(order) % self.batch_size if self.drop_last else 0)
        for s in range(0, n, self.batch_size):
            idx = order[s:s + self.batch_size]
            flat = native.gather_records(
                self._base, idx, self.record_floats, self.n_threads)
            batch = self._split(flat)
            if not self.with_extra and len(batch) >= 3:
                batch = batch[:2] + (None,) + batch[3:]
            yield batch


def pack_dataset(dataset, path: str, *, indices=None,
                 field_names=("extract_0", "extract_1", "extra")) -> dict:
    """Offline tool: freeze a live item source (AmsVoxelLoader / synthetic
    get_item) into a pack file."""
    indices = range(len(dataset)) if indices is None else indices

    def items():
        for i in indices:
            yield dataset.get_item(i)

    return write_packed(path, items(), list(field_names))
