"""The port's native ``.hic`` block decoder (``io/native/hic_decode.cpp``,
built with g++ at first use and linked against libz.so.1) against its
plain twin, the Python decoder (``HicFile._decode_blocks_plain``): equal
``(x, y, v)`` arrays, in the same order, on files from
``tests/hic_writer.py`` (versions 6-9, row-list and dense blocks, int16
and float32 counts, intra and inter), including a block whose records
outgrow the first output capacity (the rc -4 retry). A corrupt block
raises ``IOError``, as the JAX package's decoder does. The same source
compiled without zlib.h (its inflate entry points declared by hand)
decodes the same. Skips only where no g++ is found (the decoder is
built from source); zlib.h is not needed."""

import ctypes
import subprocess

import numpy as np
import pytest

from mustache_tpu_torch.io import native
from mustache_tpu_torch.io.hic import HicFile, read_hic_file
from mustache_tpu_torch.kernels import build
from hic_writer import write_hic
from synthetic import synthetic_hic, synthetic_inter
import torch_port_cases  # noqa: F401  (one torch thread per worker)

RES = 5000


@pytest.fixture(scope="module")
def gxx():
    try:
        return build.gxx()
    except RuntimeError as exc:
        pytest.skip(f"no host C++ compiler to build the decoder: {exc}")


def _blocks(hic, c1, c2):
    zoom = hic._matrix_zoom(hic.chrom_by_name(c1).index,
                            hic.chrom_by_name(c2).index, "BP", RES)
    return zoom.blocks


def _assert_equal(got, want):
    assert len(got[0]) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def maps():
    x, y, v, _ = synthetic_hic(600, 80, seed=113, n_loops=5)
    xi, yi, vi, _ = synthetic_inter(300, 200, seed=9, n_loops=3)
    return (x, y, np.round(v) + 1), (xi, yi, vi)


@pytest.mark.parametrize("version,kw", [
    (6, {}), (7, {}), (8, {}), (8, {"use_short_counts": True}), (9, {}),
    (9, {"use_short_counts": True}), (9, {"dense_blocks": True}),
])
def test_native_matches_plain(gxx, maps, tmp_path, version, kw):
    (x, y, v), (xi, yi, vi) = maps
    path = str(tmp_path / f"v{version}.hic")
    write_hic(path, [("c1", 600 * RES), ("c2", 300 * RES)], RES,
              {"c1": (x, y, v), ("c1", "c2"): (xi[xi < 300], yi[xi < 300],
                                               vi[xi < 300])},
              version=version, **kw)
    hic = HicFile(path)
    try:
        for c1, c2 in (("c1", "c1"), ("c1", "c2")):
            blocks = _blocks(hic, c1, c2)
            n0 = native.DECODES
            got = hic._decode_blocks(blocks)
            assert native.DECODES == n0 + 1
            _assert_equal(got, hic._decode_blocks_plain(blocks))
    finally:
        hic.close()


def test_capacity_retry(gxx, tmp_path, monkeypatch):
    """A dense v9 block of 160,000 equal counts compresses to a few kB: the
    first capacity (2x the compressed bytes, at least 65,536 records) is
    short, the decoder reports the count (rc -4) and the retry fits."""
    xx, yy = np.meshgrid(np.arange(400), np.arange(400), indexing="ij")
    x, y = xx.ravel().astype(np.int64), yy.ravel().astype(np.int64)
    v = np.ones(len(x))
    path = str(tmp_path / "dense.hic")
    write_hic(path, [("c1", 500 * RES), ("c2", 500 * RES)], RES,
              {("c1", "c2"): (x, y, v)}, version=9, dense_blocks=True)
    lib = native.hic_library()
    real = lib.mtpu_decode_hic_blocks
    rcs = []

    def spy(*args):
        rcs.append(real(*args))
        return rcs[-1]

    monkeypatch.setattr(lib, "mtpu_decode_hic_blocks", spy)
    hic = HicFile(path)
    try:
        blocks = _blocks(hic, "c1", "c2")
        assert sum(b.size for b in blocks) * 2 < len(v)
        got = hic._decode_blocks(blocks)
        assert rcs == [-4, 0]
        _assert_equal(got, hic._decode_blocks_plain(blocks))
        assert len(got[0]) == len(v)
    finally:
        hic.close()
    # the reader's entry point goes through it: the whole rectangle
    rx, ry, rv = read_hic_file(path, "NONE", False, 2_000_000, "c1", "c2",
                               RES)
    assert len(rv) == len(v) and rcs[-2:] == [-4, 0]


def test_corrupt_block_raises(gxx, maps, tmp_path):
    (x, y, v), _ = maps
    path = str(tmp_path / "ok.hic")
    write_hic(path, [("c1", 600 * RES)], RES, {"c1": (x, y, v)})
    hic = HicFile(path)
    entry = _blocks(hic, "c1", "c1")[0]
    hic.close()
    blob = bytearray(open(path, "rb").read())
    for i in range(entry.position + 4, entry.position + entry.size):
        blob[i] ^= 0xFF
    bad = tmp_path / "corrupt.hic"
    bad.write_bytes(bytes(blob))
    with pytest.raises(IOError):
        native.decode_hic_blocks(str(bad), [entry.position], [entry.size], 8)
    with pytest.raises(IOError):
        HicFile(str(bad)).fetch_chromosome("c1", RES)
    with pytest.raises(IOError):
        native.decode_hic_blocks(str(tmp_path / "missing.hic"), [0], [10], 8)


def test_declared_zlib_build(gxx, maps, tmp_path):
    """The source built with ``-DMTPU_DECLARE_ZLIB`` (the path taken where
    zlib.h is missing) reports it and decodes what the default build
    decodes."""
    out = str(tmp_path / "libdeclared.so")
    cmd = [gxx, *build.GXX_FLAGS, "-DMTPU_DECLARE_ZLIB", "-o", out,
           str(native.HIC_SRC), *build.GXX_LIBS,
           *build.SOURCE_LIBS["hic_decode.cpp"]]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lib = ctypes.CDLL(out)
    native.bind_hic(lib)
    assert lib.mtpu_hic_zlib_declared() == 1

    (x, y, v), _ = maps
    path = str(tmp_path / "v8.hic")
    write_hic(path, [("c1", 600 * RES)], RES, {"c1": (x, y, v)})
    hic = HicFile(path)
    blocks = _blocks(hic, "c1", "c1")
    hic.close()
    pos = np.array([b.position for b in blocks], np.int64)
    sz = np.array([b.size for b in blocks], np.int32)
    cap = 1 << 20
    xs, ys, vs = (np.empty(cap, np.int64), np.empty(cap, np.int64),
                  np.empty(cap, np.float64))
    count = ctypes.c_int64(0)
    assert lib.mtpu_decode_hic_blocks(path.encode(), pos, sz, len(sz), 8, xs,
                                      ys, vs, cap, ctypes.byref(count)) == 0
    n = count.value
    _assert_equal((xs[:n], ys[:n], vs[:n]),
                  native.decode_hic_blocks(path, pos, sz, 8))
