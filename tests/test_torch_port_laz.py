"""Port parity, LAS/LAZ IO (flowcompare_tpu_torch/data/laz.py, las_io.py).

The port's LASzip codec (its own copy of laz_codec.cpp) writes the JAX
package's bytes on every case of tests/test_laz.py, and each package reads
the other's files to equal arrays; the port's four guards against bad
input (the decoded points inside the header's bounding box, the chunk
count bounded by the file size, laz_encode's layout and capacity errors
told apart, the laszip VLR long enough for its items), each on a file or
call built to trip it; and AmsVoxelLoader over a LAZ scene directory with
train, include_all and pickle-cache items equal to the JAX loader's in
both directions.
"""

import json
import struct

import numpy as np
import pytest

import flowcompare_tpu_torch.data as pdata
from flowcompare_tpu.data import AmsVoxelLoader as JaxAmsVoxelLoader
from flowcompare_tpu.data import las_io as jax_las_io
from flowcompare_tpu.data import laz as jax_laz
from flowcompare_tpu.data.synthetic import _scene_cloud as jax_scene_cloud
from flowcompare_tpu_torch.data import las_io, laz
from flowcompare_tpu_torch.data.synthetic import _scene_cloud


def _cloud(n, seed=0, walk=0.05):
    rng = np.random.default_rng(seed)
    xyz = np.cumsum(rng.normal(0, walk, (n, 3)), axis=0) + [5e4, 4e5, 12.0]
    rgb = rng.integers(0, 65536, (n, 3)) / 65535.0
    return np.concatenate([xyz, rgb], axis=1), rng


def _gps_switches():
    rng = np.random.default_rng(7)
    n = 2000
    a = np.cumsum(rng.exponential(1e-5, n)) + 1e5
    b = np.cumsum(rng.exponential(1e-5, n)) + 9e5
    gps = np.empty(n)
    gps[0::2], gps[1::2] = a[0::2], b[1::2]
    gps[500], gps[501] = -3.5e12, 7.25e11
    return _cloud(n, seed=3)[0], gps, dict(chunk_size=600)


def _gps_multiples():
    seq = [0.0]
    for mult in [1] * 50 + [2, 1, 1, -1, 1, 8, 1, 1, 600, 1, 1, 0, 0, 1] * 10:
        seq.append(seq[-1] + mult * 1e-6)
    gps = np.array(seq)
    return _cloud(len(gps), seed=11)[0], gps, {}


def _full_color():
    rng = np.random.default_rng(5)
    n = 3000
    rgb = rng.integers(0, 65536, (n, 3)).astype(np.uint16)
    gray = rng.random(n) < 0.3
    rgb[gray, 1] = rgb[gray, 0]
    rgb[gray, 2] = rgb[gray, 0]
    hold = rng.random(n) < 0.3
    for i in range(1, n):
        if hold[i]:
            rgb[i] = rgb[i - 1]
    pts = _cloud(n, seed=5)[0]
    pts[:, 3:] = rgb / 65535.0
    return pts, None, {}


def _big_jumps():
    rng = np.random.default_rng(29)
    n = 600
    xyz = np.cumsum(rng.normal(0, 0.02, (n, 3)), axis=0)
    xyz[rng.integers(0, n, 12)] += rng.uniform(-5e4, 5e4, (12, 3))
    xyz = np.cumsum(np.abs(np.diff(xyz, axis=0, prepend=xyz[:1])), axis=0)
    return np.concatenate([xyz, rng.random((n, 3))], axis=1), None, dict(scale=1e-3)


def _with_gps(n, seed, chunk_size, rate=1e-5):
    pts, rng = _cloud(n, seed=seed)
    return pts, np.cumsum(rng.exponential(rate, n)) + 3e5, dict(chunk_size=chunk_size)


CASES = {
    "xyz_rgb_gps": lambda: _with_gps(5000, 0, 1000),
    "format2_no_gps": lambda: (_cloud(700)[0], None, {}),
    **{f"chunks_{n}_{cs}": (lambda n=n, cs=cs: _with_gps(n, n, cs, 1e-6))
       for n, cs in [(1000, 250), (250, 250), (251, 250), (1, 250), (2, 250)]},
    "empty": lambda: (np.zeros((0, 6)), None, {}),
    "constant_gray": lambda: (np.tile([[1.0, 2.0, 3.0, 0.25, 0.25, 0.25]], (400, 1)),
                              np.full(400, 123456.75), {}),
    "gps_switches": _gps_switches,
    "gps_multiples": _gps_multiples,
    "full_color": _full_color,
    "big_jumps": _big_jumps,
    "threaded_chunks": lambda: _with_gps(6000, 47, 500),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_write_laz_bytes_equal_jax_and_cross_read(tmp_path, case):
    pts, gps, kw = CASES[case]()
    p_port, p_jax = tmp_path / "port.laz", tmp_path / "jax.laz"
    laz.write_laz(str(p_port), pts, gps_time=gps, **kw)
    jax_laz.write_laz(str(p_jax), pts, gps_time=gps, **kw)
    assert p_port.read_bytes() == p_jax.read_bytes()
    mine, theirs = laz.read_laz(str(p_jax)), jax_laz.read_laz(str(p_port))
    for key in ("point_records", "xyz", "rgb", "gps_time", "intensity", "classification",
                "scale", "offset"):
        np.testing.assert_array_equal(mine[key], theirs[key], err_msg=key)
    if gps is not None:
        np.testing.assert_array_equal(mine["gps_time"], gps)
    np.testing.assert_array_equal(las_io.load_cloud(str(p_jax)),
                                  jax_las_io.load_cloud(str(p_port)))


@pytest.mark.parametrize("items,extra", [((6,), 0), ((6, 0), 5), ((6, 7, 8), 0)])
def test_raw_record_codec_equal_jax(items, extra):
    """laz_encode / laz_decode on hand-built records (POINT10 field churn,
    BYTE extras): the port's stream equals the JAX codec's and decodes back."""
    rng = np.random.default_rng(13)
    n = 4000
    rec_len = sum({6: 20, 7: 8, 8: 6}.get(t, 0) for t in items) + extra
    rec = rng.integers(0, 256, (n, rec_len)).astype(np.uint8)
    xyz_i = np.cumsum(rng.integers(-500, 500, (n, 3)), axis=0).astype("<i4")
    rec[:, :12] = xyz_i.view(np.uint8).reshape(n, 12)
    flat = np.ascontiguousarray(rec.reshape(-1))
    types = np.array(items, np.uint16)
    outs = []
    for lib in (laz.get_lib(), jax_laz.get_lib()):
        cap = n * rec_len * 2 + 4096
        dst, chunk_bytes = np.zeros(cap, np.uint8), np.zeros(3, np.int64)
        total = lib.laz_encode(flat, n, rec_len, types, len(types), extra, 1500, dst, cap,
                               chunk_bytes)
        assert total > 0
        outs.append((dst[:total].copy(), chunk_bytes.copy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    stream, chunk_bytes = outs[0]
    starts = np.concatenate([[0], np.cumsum(chunk_bytes[:2])]).astype(np.int64)
    back = np.zeros((n, rec_len), np.uint8)
    assert laz.get_lib().laz_decode(stream, len(stream), starts,
                                    np.array([1500, 1500, n - 3000], np.int64), 3, types,
                                    len(types), extra, back) == 0
    np.testing.assert_array_equal(back, rec)


def test_las_writer_bytes_equal_jax_and_cross_read(tmp_path):
    pts, _ = _cloud(500, seed=23)
    las_io.save_las(str(tmp_path / "port.las"), pts)
    jax_las_io.save_las(str(tmp_path / "jax.las"), pts)
    assert (tmp_path / "port.las").read_bytes() == (tmp_path / "jax.las").read_bytes()
    np.testing.assert_array_equal(las_io.load_cloud(str(tmp_path / "jax.las")),
                                  jax_las_io.load_cloud(str(tmp_path / "port.las")))
    las_io.save_las(str(tmp_path / "c.laz.las"), pts)
    laz.write_laz(str(tmp_path / "c.laz"), pts)
    np.testing.assert_array_equal(las_io.load_cloud(str(tmp_path / "c.laz.las")),
                                  las_io.load_cloud(str(tmp_path / "c.laz")))


def test_las_14_gate(tmp_path):
    pts, _ = _cloud(20)
    p = tmp_path / "v14.las"
    las_io.save_las(str(p), pts)
    raw = bytearray(p.read_bytes())
    raw[25] = 4                                     # version 1.4
    p.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="LAS 1.4 is not supported.*install laspy"):
        las_io.load_cloud(str(p))
    q = tmp_path / "v14.laz"
    laz.write_laz(str(q), pts)
    raw = bytearray(q.read_bytes())
    raw[25] = 4
    q.write_bytes(bytes(raw))
    with pytest.raises(laz.LazError, match="LAS 1.4 containers are not supported"):
        laz.read_laz(str(q))


def _laz_file(tmp_path, n=2000, chunk_size=300):
    pts, rng = _cloud(n, seed=41)
    p = tmp_path / "c.laz"
    laz.write_laz(str(p), pts, gps_time=np.cumsum(rng.exponential(1e-5, n)),
                  chunk_size=chunk_size)
    return p, bytearray(p.read_bytes())


def test_points_outside_the_bounding_box_raise(tmp_path):
    p, raw = _laz_file(tmp_path)
    assert laz.read_laz(str(p))["xyz"].shape == (2000, 3)
    max_x, min_x = struct.unpack_from("<2d", raw, 179)
    struct.pack_into("<d", raw, 179, min_x + 0.25 * (max_x - min_x))   # shrink max x
    p.write_bytes(bytes(raw))
    with pytest.raises(laz.LazError, match="outside the header's bounding box"):
        laz.read_laz(str(p))


def test_corrupt_streams_raise_or_decode_inside_the_box(tmp_path):
    """Flipped bytes in the compressed points: a LazError (now mostly from
    the bounding box), or points all inside the box; never a crash."""
    p, raw = _laz_file(tmp_path)
    header_end = 227 + 54 + 52
    raised = 0
    for seed in range(8):
        rng = np.random.default_rng(seed)
        buf = bytearray(raw)
        for off in rng.integers(header_end + 8, len(raw) - 40, 40):
            buf[off] ^= int(rng.integers(1, 256))
        p.write_bytes(bytes(buf))
        try:
            d = laz.read_laz(str(p))
        except laz.LazError:
            raised += 1
        else:
            assert d["xyz"].shape == (2000, 3)
    assert raised >= 4


def test_chunk_count_bounded_by_file_size(tmp_path):
    """A chunk table claiming 2^32 - 1 chunks is refused before anything is
    allocated for it (the JAX reader would ask numpy for 32 GiB)."""
    p, raw = _laz_file(tmp_path)
    data_start = struct.unpack_from("<I", raw, 96)[0]
    (table_off,) = struct.unpack_from("<q", raw, data_start)
    struct.pack_into("<I", raw, table_off + 4, 0xFFFFFFFF)
    p.write_bytes(bytes(raw))
    with pytest.raises(laz.LazError, match="claims 4294967295 chunks"):
        laz.read_laz(str(p))


def test_short_laszip_vlr_raises_lazerror(tmp_path):
    p, raw = _laz_file(tmp_path)
    vlr_payload = 227 + 54
    struct.pack_into("<H", raw, vlr_payload + 32, 200)    # 200 items in a 3-item payload
    p.write_bytes(bytes(raw))
    with pytest.raises(laz.LazError, match="too short for its 200 items"):
        laz.read_laz(str(p))
    p.write_bytes(bytes(raw[:150]))
    with pytest.raises(laz.LazError, match="shorter than a LAS header"):
        laz.read_laz(str(p))


def test_laz_encode_error_codes(tmp_path, monkeypatch):
    lib = laz.get_lib()
    rec = np.zeros(26 * 100, np.uint8)
    types = np.array([6, 8], np.uint16)
    chunk_bytes = np.zeros(1, np.int64)
    dst = np.zeros(10_000, np.uint8)
    assert lib.laz_encode(rec, 100, 27, types, 2, 0, 50000, dst, 10_000, chunk_bytes) == -1
    assert lib.laz_encode(rec, 100, 26, types, 2, 0, 50000, dst, 10, chunk_bytes) == -2
    assert lib.laz_encode(rec, 100, 26, types, 2, 0, 50000, dst, 10_000, chunk_bytes) > 0

    class Fake:
        """The codec with laz_encode replaced: only the capacity code retries."""
        def __init__(self, rc):
            self.rc, self.calls = rc, 0

        def laz_encode(self, *args):
            self.calls += 1
            return self.rc

        def __getattr__(self, name):
            return getattr(lib, name)

    pts, _ = _cloud(50)
    for rc, calls, match in ((-1, 1, "items"), (-2, 3, "outgrew")):
        fake = Fake(rc)
        monkeypatch.setattr(laz, "_lib", fake)
        with pytest.raises(laz.LazError, match=match):
            laz.write_laz(str(tmp_path / "x.laz"), pts)
        assert fake.calls == calls


def write_scene_dir(root, ext: str):
    """A two-epoch AMS recording directory (response.json as the AMS corpus
    has it) of `ext` scans, written by the port's writers."""
    rng = np.random.default_rng(11)
    props = []
    for i, (cx, cy, year) in enumerate([(0.0, 0.0, 2019), (1.0, 0.5, 2020)]):
        cloud = _scene_cloud(rng, removed=(year == 2020)).astype(np.float64)
        cloud[:, 0] += cx
        cloud[:, 1] += cy
        write = pdata.write_laz if ext == ".laz" else pdata.save_las
        write(str(root / f"scan{i}{ext}"), cloud)
        props.append({"ImageId": f"scan{i}", "X": cx, "Y": cy, "Height": 2.5,
                      "GroundLevelOffset": 2.5, "RecordingTimeGps": f"{year}-06-01T12:00:00"})
    (root / "response.json").write_text(json.dumps({"RecordingProperties": props}))
    return root


def assert_items_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def check_ams_loader_equal_jax(scene_dir, out, mode: str, ext: str) -> None:
    """The offline build (decode, registration, voxel pairing) and the items
    from the same seed; then each package's pickle caches loaded by the
    other (preload=True) give the same items."""
    d = str(scene_dir)
    kw = dict(clearance=6, n_samples=64, n_samples_context=96,
              final_voxel_size=(2.0, 2.0, 4.0), context_voxel_size=(2.2, 2.2, 4.2), mode=mode,
              include_all=(mode == "test"), self_pairs_train=True, cloud_ext=ext,
              min_cloud_points=500, seed=4)

    def items(loader):
        get = loader.get_item_all if mode == "test" else loader.__getitem__
        return [get(i) for i in range(len(loader))]

    port = pdata.AmsVoxelLoader(d, d, str(out / "port"), **kw)
    ref = JaxAmsVoxelLoader(d, d, str(out / "jax"), **kw)
    assert [c["combination"] for c in port.all_valid_combs] == \
        [c["combination"] for c in ref.all_valid_combs]
    for key, entry in ref.save_dict.items():
        assert port.save_dict[key]["ground_height"] == entry["ground_height"]
        for u, v in zip(port.save_dict[key]["clouds"], entry["clouds"], strict=True):
            np.testing.assert_array_equal(u, v)
    assert_items_equal(items(port), items(ref))
    # each side's caches in the other package, each loader from a fresh generator
    cross = items(pdata.AmsVoxelLoader(d, d, str(out / "jax"), preload=True, **kw))
    assert_items_equal(cross, items(JaxAmsVoxelLoader(d, d, str(out / "port"), preload=True,
                                                      **kw)))
    assert_items_equal(cross, items(pdata.AmsVoxelLoader(d, d, str(out / "port"), preload=True,
                                                         **kw)))


def test_scene_cloud_equal_jax():
    a = _scene_cloud(np.random.default_rng(2), removed=False, color_shift=0.1)
    b = jax_scene_cloud(np.random.default_rng(2), removed=False, color_shift=0.1)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_ams_loader_on_laz_scenes_equal_jax(tmp_path_factory, tmp_path, mode):
    scene = write_scene_dir(tmp_path_factory.mktemp("ams_laz"), ".laz")
    assert sorted(p.name for p in scene.iterdir()) == ["response.json", "scan0.laz",
                                                       "scan1.laz"]
    check_ams_loader_equal_jax(scene, tmp_path, mode, ".laz")
