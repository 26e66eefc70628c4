"""The port's own HDF5 reader (``mustache_tpu_torch/io/h5.py``) and the
``.cool`` reader on it (``io/cool.py``), against h5py and the JAX
package's reader, on files h5py writes here:

* every schema variant of ``tests/test_cool_fuzz.py::build_cool_variant``
  (int32/uint32 ids, int32 offsets, float counts, chunks of 64, with gzip,
  extra bins columns, an empty chromosome, an empty file);
* cooler's own layout: gzip 6 with shuffle on every column, chunked (a
  chunk B-tree of two levels), ``bins/chrom`` as an enum, variable-length
  string attributes, an inter rectangle, NaN weights; and an ``.mcool``
  of two resolutions;
* files of ``tools/write_cool.py`` (the h5py-free writer), which h5py
  reads back equal to the inputs, and of ``benchmark/harness/coolfile.py``
  (the 4DN layout);
* the native chunk decoder (``io/native/h5_chunks.cpp``) over every
  number type of either byte order, shuffle, deflate and both, chunks
  whose filter mask skips a filter, rows no chunk holds, and corrupt and
  short chunks.

Each file reads equal to h5py dataset by dataset and attribute by
attribute, every chunked read byte for byte equal to the plain Python
loop (``H5File._read_chunked_plain``), and ``read_cooler`` / ``read_mcooler`` equal to the JAX
reader's triplets (intra and inter, balanced and not). Unsupported
features raise a ``ValueError`` naming them. A subprocess with h5py
blocked gives the CLI's TSV of this process."""

import ctypes
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

import torch_port_cases as C
from mustache_tpu.io import cool as jcool
from mustache_tpu_torch.io import cool as tcool
from mustache_tpu_torch.io import h5, native
from mustache_tpu_torch.kernels import build
from synthetic import synthetic_hic

h5py = pytest.importorskip("h5py")
from test_cool_fuzz import (  # noqa: E402
    D_PX, N_BINS, _pixels, build_cool_variant,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import write_cool  # noqa: E402
from benchmark.harness import coolfile  # noqa: E402

RES = 5000


def _native_equals_plain(g, name, lo, hi, out_dtype=None):
    """``g.read`` (for a chunked dataset of fixed-size elements, the
    native decoder) byte for byte equal to the plain Python loop."""
    got = g.read(name, lo, hi, out_dtype)
    ds = g._dataset(name)
    if ds.layout["class"] == "chunked" and ds.dtype.kind == "num":
        want = np.empty(hi - lo, got.dtype)
        if hi > lo:
            g._read_chunked_plain(name, ds, lo, hi, want)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), \
            (name, lo, hi, out_dtype)
    return got


def _same_as_h5py(path):
    """Every group's members and attributes and every dataset of ``path``
    equal between h5py and the port's reader; whole and sliced reads."""
    with h5py.File(path, "r") as f, h5.H5File(path) as g:
        def visit(name, obj):
            got_attrs = g.attrs(name)
            assert set(got_attrs) == set(obj.attrs), name
            for k, v in obj.attrs.items():
                assert np.array_equal(np.asarray(got_attrs[k]),
                                      np.asarray(v)), (name, k)
            if isinstance(obj, h5py.Group):
                assert g.keys(name) == sorted(obj), name
                return
            want = np.asarray(obj[()])
            nan = want.dtype.kind == "f"
            got = g.read(name)
            # the stored type in native byte order
            assert got.dtype == want.dtype.newbyteorder("="), name
            assert np.array_equal(got, want, equal_nan=nan), name
            if want.ndim == 0:
                return
            n = len(want)
            for lo, hi in ((0, n), (n // 3, n // 2), (max(n - 7, 0), n)):
                assert np.array_equal(_native_equals_plain(g, name, lo, hi),
                                      want[lo:hi], equal_nan=nan), name
                if want.dtype.kind in "iuf":
                    got = _native_equals_plain(g, name, lo, hi, np.float64)
                    assert np.array_equal(got,
                                          want[lo:hi].astype(np.float64),
                                          equal_nan=nan), name

        assert g.keys() == sorted(f)
        visit("", f)
        f.visititems(visit)


def _triplets_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _same_as_jax(path, pairs, res=None, balances=(False, True)):
    for bal in balances:
        for c1, c2 in pairs:
            if res is None:
                got = tcool.read_cooler(path, 300_000, c1, c2, bal)
                want = jcool.read_cooler(path, 300_000, c1, c2, bal)
                assert got[3] == want[3]
                _triplets_equal(got[:3], want[:3])
            else:
                _triplets_equal(
                    tcool.read_mcooler(path, 300_000, c1, c2, res, bal),
                    jcool.read_mcooler(path, 300_000, c1, c2, res, bal))
    assert tcool.cool_chrom_list(path, res) == jcool.cool_chrom_list(path,
                                                                     res)


@pytest.mark.parametrize("variant", [
    dict(id_dtype=np.int32), dict(id_dtype=np.uint32),
    dict(offset_dtype=np.int32), dict(count_dtype=np.float64),
    dict(count_dtype=np.float32), dict(chunks=64),
    dict(chunks=64, compression="gzip"),
    dict(extra_bins_cols=("KR", "VC")), "empty chromosome", "empty file",
    dict(chunks=64, compression="gzip", id_dtype=np.int32),
    dict(chunks=64, compression="gzip", count_dtype=np.float64),
    dict(chunks=64, count_dtype=np.float32, id_dtype=np.uint32),
])
def test_fuzz_variants_read_like_h5py_and_jax(tmp_path, variant):
    x, y, v = _pixels(N_BINS, D_PX, seed=41)
    path = str(tmp_path / "v.cool")
    chroms, pixels, kw = [("chr1", N_BINS * RES)], {"chr1": (x, y, v)}, {}
    if variant == "empty chromosome":
        chroms = [("chr1", N_BINS * RES), ("chr2", 200 * RES),
                  ("chr3", N_BINS * RES)]
        pixels = {"chr1": (x, y, v), "chr3": (x, y, v)}
    elif variant == "empty file":
        pixels = {}
    else:
        kw = variant
    build_cool_variant(path, chroms, RES, pixels, **kw)
    _same_as_h5py(path)
    _same_as_jax(path, [(c, c) for c, _ in chroms])


PAIRS = [("chr1", "chr1"), ("chr2", "chr2"), ("chr1", "chr2"),
         ("chr2", "chr1")]


def test_cooler_layout_and_mcool(tmp_path):
    path = str(tmp_path / "c.cool")
    npix = C.write_cooler_layout(path)
    with h5.H5File(path) as g:
        ds = g._dataset("pixels/count")
        # shuffle, then deflate
        assert ds.filters[0][0] == 2 and ds.filters[1][0] == 1
        root = g._btree_node(ds.layout["addr"], 1, rank=1)
        assert root["level"] >= 1                       # a two-level tree
        assert len(g._chunk_index(ds)) == -(-npix // 100) > 64
        assert g.attrs("")["generated-by"] == "cooler-0.9.3"
    _same_as_h5py(path)
    _same_as_jax(path, PAIRS, balances=(False, True, "weight"))
    mcool = str(tmp_path / "c.mcool")
    for res, n1 in ((RES, 900), (2 * RES, 450)):
        C.write_cooler_layout(mcool, f"resolutions/{res}", n1=n1, n2=250,
                              res=res)
    with h5py.File(mcool, "a") as f:
        f.attrs["format"] = "HDF5::MCOOL"
    _same_as_h5py(mcool)
    _same_as_jax(mcool, PAIRS[:3], res=RES)
    with pytest.raises(ValueError, match="explicit resolution"):
        tcool.CoolFile(mcool)
    with pytest.raises(ValueError, match=r"available: \['10000', '5000'\]"):
        tcool.CoolFile(mcool, resolution=1000)


def test_slices_inflate_only_their_chunks(tmp_path):
    path = str(tmp_path / "c.cool")
    C.write_cooler_layout(path)
    with h5.H5File(path) as g, h5py.File(path, "r") as f:
        got = g.read("pixels/bin2_id", 1050, 1150, np.int64)
        assert np.array_equal(got, f["pixels/bin2_id"][1050:1150])
        # rows 1000-1199: two chunks, both taken by the native decoder
        assert g.counters["chunks_inflated"] == 2
        assert g.counters["chunks_native"] == 2


FILTERS = {"shuffle": dict(shuffle=True), "deflate": dict(compression="gzip"),
           "both": dict(shuffle=True, compression="gzip")}
N, CN = 1000, 64


@pytest.mark.parametrize("filters", sorted(FILTERS))
@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("kind", ["i4", "i8", "f4", "f8"])
def test_native_chunks_read_like_plain_and_h5py(tmp_path, kind, order,
                                                 filters):
    """Every number type of either byte order under each filter set: the
    native decoder equals the plain loop byte for byte and h5py by value,
    whole, in slices that start and end inside chunks, one row; as stored,
    widened to int64 and float64, and cast to float32 (which the native
    call leaves to numpy); a column written in part reads its other rows
    as the fill value."""
    rng = np.random.default_rng(zlib.crc32(f"{kind}{order}{filters}".encode()))
    dt = np.dtype(order + kind)
    data = (rng.integers(-2**30, 2**30, N) if kind[0] == "i"
            else rng.standard_normal(N) * 1e3).astype(dt)
    path = str(tmp_path / "m.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("d", data=data, chunks=(CN,), **FILTERS[filters])
        part = f.create_dataset("part", shape=(N,), chunks=(CN,), dtype=dt,
                                fillvalue=5, **FILTERS[filters])
        part[100:300] = data[100:300]
        part[700:710] = data[700:710]
    with h5py.File(path, "r") as f:
        want = {name: f[name][()] for name in ("d", "part")}
    with h5.H5File(path) as g:
        n_chunks = len(g._chunk_index(g._dataset("d")))
        g.read("d")
        inflated = n_chunks if "gzip" in str(FILTERS[filters]) else 0
        assert g.counters["chunks_native"] == n_chunks == -(-N // CN)
        assert g.counters["chunks_inflated"] == inflated
        assert len(g._chunk_index(g._dataset("part"))) < n_chunks
        for name, ref in want.items():
            for lo, hi in ((0, N), (10, 50), (30, 650), (500, 501),
                           (N - 1, N), (290, 720), (400, 400)):
                for out in (None, np.int64, np.float64, np.float32):
                    got = _native_equals_plain(g, name, lo, hi, out)
                    exp = ref[lo:hi] if out is None else \
                        ref[lo:hi].astype(out)
                    assert got.dtype == exp.dtype.newbyteorder("=")
                    assert np.array_equal(got, exp), (name, lo, hi, out)


def _shuffled(raw: bytes, es: int) -> bytes:
    return np.frombuffer(raw, np.uint8).reshape(-1, es).T.tobytes()


def test_chunk_filter_masks_are_honoured(tmp_path):
    """Chunks stored with both filters, without the shuffle, without the
    deflate and without either (their filter masks): each decoded as its
    mask says, as libhdf5 decodes them."""
    data = np.random.default_rng(5).integers(0, 2**40, 4 * CN).astype("<i8")
    path = str(tmp_path / "mask.h5")
    with h5py.File(path, "w") as f:
        d = f.create_dataset("d", shape=(4 * CN,), dtype="<i8", chunks=(CN,),
                             shuffle=True, compression="gzip")
        for c in range(4):
            raw = data[c * CN:(c + 1) * CN].tobytes()
            stored = [zlib.compress(_shuffled(raw, 8)), zlib.compress(raw),
                      _shuffled(raw, 8), raw][c]
            d.id.write_direct_chunk((c * CN,), stored, filter_mask=c)
    with h5py.File(path, "r") as f:
        assert np.array_equal(f["d"][()], data)
    with h5.H5File(path) as g:
        ds = g._dataset("d")
        assert [fid for fid, _, _ in ds.filters] == [2, 1]  # shuffle, deflate
        assert [m for _, _, m, _ in g._chunk_index(ds)] == [0, 1, 2, 3]
        assert np.array_equal(g.read("d"), data)
        assert g.counters["chunks_native"] == 4
        assert g.counters["chunks_inflated"] == 2
        for lo, hi in ((0, 4 * CN), (CN - 3, 3 * CN + 3), (2 * CN + 1,
                                                          2 * CN + 2)):
            assert np.array_equal(
                _native_equals_plain(g, "d", lo, hi, np.float64),
                data[lo:hi].astype(np.float64))


def test_corrupt_and_short_chunks_raise(tmp_path):
    """A chunk zlib refuses and a chunk that inflates short raise the
    plain loop's ``ValueError``s, naming the chunk's first row (the first
    bad chunk in row order, whichever thread met it)."""
    data = np.arange(4 * CN, dtype="<i8")
    path = str(tmp_path / "bad.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("corrupt", data=data, chunks=(CN,),
                         compression="gzip")
        d = f.create_dataset("short", shape=(4 * CN,), dtype="<i8",
                             chunks=(CN,), compression="gzip")
        for c in range(4):
            raw = data[c * CN:(c + 1) * CN].tobytes()
            d.id.write_direct_chunk((c * CN,), zlib.compress(
                raw[:-24] if c == 1 else raw))
    with h5.H5File(path) as g:
        spans = [g._chunk_index(g._dataset("corrupt"))[c][1:4:2]
                 for c in (2, 3)]
    blob = bytearray(open(path, "rb").read())
    for size, addr in spans:
        for i in range(addr + 2, addr + size):
            blob[i] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with h5.H5File(path) as g:
        for name, lo, hi, msg in (
                ("corrupt", 130, 140, "chunk at row 128 does not inflate"),
                ("corrupt", 0, 4 * CN, "chunk at row 128 does not inflate"),
                ("short", 64, 70, "chunk at row 64 holds 488 bytes, "
                                  "expected 512"),
                ("short", 0, 4 * CN, "chunk at row 64 holds 488 bytes")):
            ds = g._dataset(name)
            with pytest.raises(ValueError, match=msg):
                g.read(name, lo, hi)
            with pytest.raises(ValueError, match=msg):
                g._read_chunked_plain(name, ds, lo, hi,
                                      np.empty(hi - lo, np.int64))
        for _ in range(20):
            with pytest.raises(ValueError, match="row 128 does not inflate"):
                g.read("corrupt", 100, 4 * CN)
        with pytest.raises(ValueError, match="row 192 does not inflate"):
            g.read("corrupt", 200, 4 * CN)
        assert np.array_equal(g.read("corrupt", 0, 2 * CN), data[:2 * CN])
        assert np.array_equal(g.read("short", 2 * CN, 4 * CN),
                              data[2 * CN:])


def test_native_decode_on_more_threads_than_cores_and_callers(tmp_path):
    """The decoder on 1 to 64 threads, and six readers of their own files
    on Python threads at once (as the CLI's prefetch thread reads beside
    the main thread), give the plain loop's bytes."""
    import threading

    path = str(tmp_path / "c.cool")
    C.write_cooler_layout(path)
    cols = ("bin1_id", "bin2_id", "count")
    with h5.H5File(path) as g:
        n = g._dataset("pixels/count").shape[0]
        want = [_native_equals_plain(g, "pixels/" + c, 0, n, np.float64)
                for c in cols]
        ds = g._dataset("pixels/count")
        first, size, mask, addr = g._chunk_table(ds)
        fids = [fid for fid, _, _ in ds.filters]
        fes = [ds.dtype.size if fid == 2 else 0 for fid in fids]
        for n_threads in (1, 3, 64):
            out = np.empty(n - 5, np.float64)
            rc, stats = native.decode_h5_chunks(
                g._fh.fileno(), addr, size, mask, first, ds.layout["dims"][0],
                fids, fes, ds.dtype.dtype, out, 5, n, n_threads=n_threads)
            assert rc == 0 and stats[0] == len(first)
            assert out.tobytes() == want[2][5:].tobytes()
    got, errors = [], []

    def reader():
        try:
            with h5.H5File(path) as f:
                for _ in range(5):
                    got.append([f.read("pixels/" + c, 0, n, np.float64)
                                for c in cols])
        except Exception as exc:      # reported by the assertion below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == 30
    for cols_read in got:
        assert all(a.tobytes() == b.tobytes()
                   for a, b in zip(cols_read, want))


def test_coolfile_mcool_reads_like_plain_and_h5py(tmp_path):
    """A 4DN-layout ``.mcool`` (``benchmark/harness/coolfile.py``: every
    column chunked, shuffled and deflated): equal to h5py and to the plain
    loop, and every chunk of a fetch through the native decoder."""
    x1, y1, v1, _ = synthetic_hic(400, 60, seed=81, n_loops=5)
    x2, y2, v2, _ = synthetic_hic(300, 60, seed=82, n_loops=5)
    chroms = [("chr1", 400 * RES), ("chr2", 300 * RES - 7)]
    w = np.linspace(0.5, 1.5, 700)
    w[::31] = np.nan
    path = str(tmp_path / "f.mcool")
    coolfile.write_mcool(path, RES, chroms,
                         {"chr1": (x1, y1, np.round(v1).astype(np.int32)),
                          "chr2": (x2, y2, np.round(v2).astype(np.int32))},
                         w, "hg38", workers=2)
    _same_as_h5py(path)
    counters = {}
    got = tcool.read_mcooler(path, 300_000, "chr2", "chr2", RES, True,
                             counters)
    want = jcool.read_mcooler(path, 300_000, "chr2", "chr2", RES, True)
    _triplets_equal(got, want)
    assert counters["chunks_native"] == counters["chunks_inflated"] > 3
    assert counters["unshuffle_s"] > 0 and counters["inflate_s"] > 0


def test_declared_zlib_build_decodes_the_same(tmp_path, monkeypatch):
    """The chunk decoder built with ``-DMTPU_DECLARE_ZLIB`` (where zlib.h
    is missing) reports it and reads what the default build reads."""
    out = str(tmp_path / "libh5declared.so")
    cmd = [build.gxx(), *build.GXX_FLAGS, "-DMTPU_DECLARE_ZLIB", "-o", out,
           str(native.H5_SRC), *build.GXX_LIBS,
           *build.SOURCE_LIBS["h5_chunks.cpp"]]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert native.h5_library().mtpu_h5_zlib_declared() == 0
    lib = ctypes.CDLL(out)
    native.bind_h5(lib)
    assert lib.mtpu_h5_zlib_declared() == 1
    path = str(tmp_path / "c.cool")
    C.write_cooler_layout(path)
    with h5.H5File(path) as g:
        want = [g.read("pixels/" + c) for c in ("bin1_id", "count")]
    monkeypatch.setattr(native, "h5_library", lambda: lib)
    with h5.H5File(path) as g:
        for c, w in zip(("bin1_id", "count"), want):
            assert g.read("pixels/" + c).tobytes() == w.tobytes()
        assert g.counters["chunks_native"] == g.counters["chunks_inflated"]


def test_unsupported_features_raise_by_name(tmp_path):
    cases = {
        "fletcher32": lambda f: f.create_dataset(
            "d", data=np.arange(100), chunks=(10,), fletcher32=True),
        "chunk index": lambda f: f.create_dataset(
            "d", data=np.arange(100), chunks=(10,)),
        "dense attribute storage": lambda f: [
            f.attrs.__setitem__(f"a{i}", i) for i in range(20)],
        "soft link": lambda f: f.__setitem__("s", h5py.SoftLink("/x")),
        "compound": lambda f: f.create_dataset(
            "d", data=np.zeros(3, [("a", "i4"), ("b", "f8")])),
    }
    for feature, make in cases.items():
        path = str(tmp_path / f"{feature.replace(' ', '_')}.h5")
        latest = feature in ("chunk index", "dense attribute storage")
        with h5py.File(path, "w", libver="latest" if latest else None) as f:
            make(f)
        with h5.H5File(path) as g, pytest.raises(ValueError, match=feature):
            g.attrs("")
            for name in g.keys():
                g.read(name)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        open(tmp_path / "x.cool", "wb").write(b"\0" * 600)
        h5.H5File(str(tmp_path / "x.cool"))


def test_write_cool_files_read_back(tmp_path):
    x1, y1, v1, _ = synthetic_hic(400, 60, seed=71, n_loops=5)
    x2, y2, v2, _ = synthetic_hic(300, 60, seed=72, n_loops=5)
    chroms = [("chr1", 400 * RES), ("chr2", 300 * RES), ("chrM", 16_000)]
    pixels = {"chr1": (x1, y1, v1), "chr2": (x2, y2, v2),
              ("chr1", "chr2"): (x1[:500] % 400, y1[:500] % 300, v1[:500])}
    w = np.linspace(0.5, 1.5, 704)
    w[::29] = np.nan
    path, mcool = str(tmp_path / "w.cool"), str(tmp_path / "w.mcool")
    write_cool.write_cool(path, chroms, RES, pixels, w, np.float64)
    write_cool.write_mcool(mcool, {RES: (chroms, pixels, w),
                                   2 * RES: (chroms[:1], {"chr1": (
                                       x1 // 2, y1 // 2, v1)}, None)})
    with h5py.File(path, "r") as f:
        assert f.attrs["bin-size"] == RES
        assert list(f["chroms/name"][:]) == [b"chr1", b"chr2", b"chrM"]
        assert np.array_equal(f["bins/weight"][:], w, equal_nan=True)
        b1 = f["pixels/bin1_id"][:]
        assert np.all(np.diff(b1) >= 0) and len(b1) == len(v1) + len(v2) + 500
        assert f["pixels/count"].dtype == np.float64
        assert sorted(f["pixels/count"][:]) == sorted(
            np.concatenate([v1, v2, v1[:500]]))
    with h5py.File(mcool, "r") as f:
        assert sorted(f["resolutions"]) == ["10000", "5000"]
        assert f["resolutions/10000"].attrs["bin-size"] == 2 * RES
    _same_as_h5py(path)
    _same_as_h5py(mcool)
    _same_as_jax(path, PAIRS)
    _same_as_jax(mcool, PAIRS, res=RES)


SCRIPT = r"""
import sys
sys.modules["h5py"] = None            # any import of h5py now fails
sys.path[:0] = [ROOT, ROOT + "/tests"]
from mustache_tpu_torch import cli
rc = cli.main(["-f", COOL, "-ch", "chr1", "-r", "5kb", "-d", "300kb", "-o",
               OUT, "-pt", "0.1", "-st", "0.8", "--engine-platform", "cpu"])
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in ("jax", "jaxlib", "mustache_tpu", "h5py"))
print("RC", rc, "BAD_MODULES", bad)
"""


def test_cli_on_cool_without_h5py(tmp_path):
    """The CLI on a ``.cool`` in a fresh interpreter where h5py cannot be
    imported: the TSV of this process's run, and no h5py or JAX loaded."""
    from mustache_tpu_torch import cli

    x, y, v, _ = synthetic_hic(400, 60, seed=3, n_loops=6)
    cool = str(tmp_path / "m.cool")
    build_cool_variant(cool, [("chr1", 400 * RES)], RES,
                       {"chr1": (x, y, np.round(v))})
    here, there = str(tmp_path / "here.tsv"), str(tmp_path / "there.tsv")
    assert cli.main(["-f", cool, "-ch", "chr1", "-r", "5kb", "-d", "300kb",
                     "-o", here, "-pt", "0.1", "-st", "0.8",
                     "--engine-platform", "cpu"]) == 0
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(C.SUBPROCESS_ENV)
    script = (SCRIPT.replace("ROOT", repr(ROOT)).replace("COOL", repr(cool))
              .replace("OUT", repr(there)))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RC 0 BAD_MODULES []" in res.stdout, res.stdout
    rows = open(here).read()
    assert rows.count("\n") > 3 and open(there).read() == rows


def test_committed_card_fixtures():
    """The files ``chip_smoke.py`` phase 11 reads on the card (no h5py
    there): equal to h5py here, and the port's triplets match the
    committed digests of the JAX reader's (``tools/make_torch_golden.py
    --slice cool_card``)."""
    import chip_smoke

    for path in C.COOL_CARD.values():
        _same_as_h5py(path)
        assert os.path.getsize(path) < 150_000
    want = C.load_golden(chip_smoke.COOL_EXPECTED)
    got = chip_smoke.cool_digests(tcool, C.COOL_CARD["cool"],
                                  C.COOL_CARD["mcool"])
    assert got == {k: v for k, v in want.items() if not k.startswith("_")}


def test_compact_and_big_endian_datasets(tmp_path):
    """A compact layout (the data inside the object header), big-endian
    integers and floats, a scalar, and a chunked column with unwritten
    chunks (their rows read as the fill value)."""
    path = str(tmp_path / "misc.h5")
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I32LE,
                             h5py.h5s.create_simple((5,)), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(5, dtype=np.int32))
        f.create_dataset("be_i8", data=np.arange(9, dtype=">i8"))
        f.create_dataset("be_f4", data=np.linspace(0, 1, 7).astype(">f4"))
        f.create_dataset("scalar", data=2.5)
        part = f.create_dataset("sparse", shape=(100,), chunks=(10,),
                                dtype=np.int16, fillvalue=7)
        part[20:30] = 3
    with h5.H5File(path) as g:
        assert g._dataset("compact").layout["class"] == "compact"
        assert float(g.read("scalar")) == 2.5
    _same_as_h5py(path)
