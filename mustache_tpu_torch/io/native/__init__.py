"""ctypes bindings for the native host band fill, host normalize,
``.hic`` block decoder, HDF5 chunk decoder and cooler pixel sift, and the
band fill's numpy twins.

Torch port of ``mustache_tpu/io/native/__init__.py`` (bindings at :50-70,
:189-218, :221-247 and :250-424). ``band_fill.cpp``, ``normalize.cpp``
and ``hic_decode.cpp`` (copies of the JAX package's functions but for
the compact fills' row-range walk and census, ``band_fill.cpp``'s header;
the decoder links zlib), ``h5_chunks.cpp`` (the port's own: the
chunked reads of ``io/h5.py``, which links zlib too) and
``cool_select.cpp`` (the port's own: a cooler fetch's band or rectangle
kept, bins shifted, weights applied and non-positive values dropped in
one threaded pass, ``io/cool.py``) are compiled with
g++ at first use into the port's build cache (``kernels/build.py``, keyed
by a hash of the source); a failed build raises, and nothing here falls
back to numpy or Python's ``zlib`` (``available`` only says whether a
compiler is found). Argument dtypes and contiguity are checked in Python
before any pointer is passed; a wrong one raises ``TypeError``.

The ``*_plain`` functions are the numpy twins the JAX package keeps
beside its native calls (``mustache_tpu/pipeline.py:67-76,109-112,
136-147,159-165``). The tests hold the native functions to them; the
pipeline calls only :func:`fill_band_plain`, for the float64 band the
native fill (float32 only) does not write. The chunk decoder's twin is
``H5File._read_chunked_plain``, the sift's ``io/cool.py::_select_plain``
(the numpy passes it replaced).

``FILLS`` counts the native fill calls, ``FILLS4`` the nibble-packed u4
bands and slabs filled (a walk refused for the COO's order not counted),
``DECODES`` the native ``.hic`` decoder calls, ``H5_DECODES`` the native
HDF5 chunk decoder calls and ``COOL_SELECTS`` the native sifts (plain
integers; the last two under a lock, as the CLI reads a cooler file on
two threads), so a run can show that its band went up through the native
fill (a u4 band straight into its packed slabs), its ``.hic`` blocks
through the native decoder and its cooler columns through the chunk
decoder and the sift.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "band_fill.cpp"
NORM_SRC = Path(__file__).resolve().parent / "normalize.cpp"
HIC_SRC = Path(__file__).resolve().parent / "hic_decode.cpp"
H5_SRC = Path(__file__).resolve().parent / "h5_chunks.cpp"
COOL_SRC = Path(__file__).resolve().parent / "cool_select.cpp"
N_THREADS = 8
FILLS = 0
FILLS4 = 0
DECODES = 0
H5_DECODES = 0
_H5_DECODES_LOCK = threading.Lock()   # the CLI decodes on two threads
COOL_SELECTS = 0
_COOL_SELECTS_LOCK = threading.Lock()

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_P, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


def bind(lib) -> None:
    """ctypes signatures of the band entry points (as the JAX bindings;
    the compact fills take a ``scan`` flag, and the one-shot one a
    census buffer and a handle to hold its exceptions in, beside)."""
    sigs = {
        "mtpu_fill_band": [_P, _P, _i32, _P, _i32, _i64, _F32, _i64, _i64,
                           _i32],
        "mtpu_classify_values": [_F64, _i64, _i32, _I64],
        "mtpu_fill_band_compact": [_P, _P, _i32, _F64, _i64, _P, _i32, _i64,
                                   _i64, _I32, _I32, _F32, _i64, _i32, _i32,
                                   _P, _P],
        "mtpu_fill_band_compact_range": [_P, _P, _i32, _F64, _i64, _P, _i32,
                                         _i64, _i64, _i64, _I32, _I32, _F32,
                                         _i64, _i32, _i32],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    lib.mtpu_take_exceptions.restype = None
    lib.mtpu_take_exceptions.argtypes = [_P, _P, _P, _P]


def library():
    """The band-fill library, built at first use (raises on failure)."""
    from mustache_tpu_torch.kernels import build

    return build.load("band_fill", bind, src=SRC)


def bind_normalize(lib) -> None:
    """ctypes signature of ``mtpu_normalize_coo`` (as the JAX binding)."""
    lib.mtpu_normalize_coo.restype = ctypes.c_int
    lib.mtpu_normalize_coo.argtypes = [
        _I64, _I64, _F64, _i64, _i64, _i32, _i32, _F64, _P, _i64,
        ctypes.POINTER(ctypes.c_int64), _i32]


def normalize_library():
    """The host normalize library, built at first use (raises on
    failure)."""
    from mustache_tpu_torch.kernels import build

    return build.load("normalize", bind_normalize, src=NORM_SRC)


def bind_hic(lib) -> None:
    """ctypes signatures of the ``.hic`` decoder (as the JAX binding)."""
    lib.mtpu_decode_hic_blocks.restype = ctypes.c_int
    lib.mtpu_decode_hic_blocks.argtypes = [
        ctypes.c_char_p, _I64, _I32, _i32, _i32, _I64, _I64, _F64, _i64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.mtpu_hic_zlib_declared.restype = ctypes.c_int
    lib.mtpu_hic_zlib_declared.argtypes = []


def hic_library():
    """The ``.hic`` block decoder library, built at first use (raises on
    failure)."""
    from mustache_tpu_torch.kernels import build

    return build.load("hic_decode", bind_hic, src=HIC_SRC)


def hic_zlib_declared() -> bool:
    """True when the decoder was compiled without zlib.h, its inflate entry
    points declared by hand against libz.so.1."""
    return bool(hic_library().mtpu_hic_zlib_declared())


def decode_hic_blocks(path: str, positions, sizes, version: int):
    """Decode the ``.hic`` blocks at ``positions`` (int64 file offsets) of
    ``sizes`` (int32 compressed bytes) in one native pass: ``(x, y, v)``
    as int64, int64, float64, in block and record order. Retries once
    per shortfall with the capacity the decoder reports (rc -4); raises
    ``IOError`` on an I/O, inflate or parse error."""
    global DECODES
    lib = hic_library()
    positions = np.ascontiguousarray(positions, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int32)
    if positions.shape != sizes.shape or positions.ndim != 1:
        raise ValueError(f"positions {positions.shape} and sizes "
                         f"{sizes.shape} must be equal 1-D shapes")
    DECODES += 1
    capacity = max(int(sizes.sum()) * 2, 1 << 16)
    for _ in range(4):
        x = np.empty(capacity, np.int64)
        y = np.empty(capacity, np.int64)
        v = np.empty(capacity, np.float64)
        count = ctypes.c_int64(0)
        rc = lib.mtpu_decode_hic_blocks(
            str(path).encode(), positions, sizes, len(sizes), int(version),
            x, y, v, capacity, ctypes.byref(count))
        if rc == 0:
            n = count.value
            return x[:n], y[:n], v[:n]
        if rc == -4:
            capacity = int(count.value * 1.2) + 1024
            continue
        raise IOError(f"native .hic decode failed (rc={rc}) for {path}")
    raise IOError(f"native .hic decode: capacity retry exhausted for {path}")


def bind_h5(lib) -> None:
    """ctypes signatures of the HDF5 chunk decoder."""
    lib.mtpu_h5_decode_chunks.restype = ctypes.c_int
    lib.mtpu_h5_decode_chunks.argtypes = [
        _i32, _I64, _I64, _I64, _I64, _i64, _i64, _I32, _I32, _i32, _i32,
        _i32, _i32, _P, _i32, _i32, _i64, _i64, _i32, _I64]
    lib.mtpu_h5_zlib_declared.restype = ctypes.c_int
    lib.mtpu_h5_zlib_declared.argtypes = []


def h5_library():
    """The HDF5 chunk decoder library, built at first use (raises on
    failure)."""
    from mustache_tpu_torch.kernels import build

    return build.load("h5_chunks", bind_h5, src=H5_SRC)


# the chunk decoder's return codes (``h5_chunks.cpp``)
H5_READ, H5_INFLATE, H5_SIZE = 1, 2, 3
# its element type codes: 0 copies the stored bytes (any fixed size)
_H5_CODES = {np.dtype(c): i for i, c in enumerate(
    ("i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f4", "f8"), start=1)}
_H5_WIDE = (np.dtype(np.int64), np.dtype(np.float64))


def h5_writes(stored, out) -> bool:
    """Whether :func:`decode_h5_chunks` writes elements of the file type
    ``stored`` (a numpy dtype of either byte order) as ``out``: as stored
    in native order, or a number widened to int64 or float64 (a float
    only to float64)."""
    stored, out = np.dtype(stored).newbyteorder("="), np.dtype(out)
    if out == stored:
        return True
    return (out in _H5_WIDE and stored in _H5_CODES
            and not (stored.kind == "f" and out.kind == "i"))


def decode_h5_chunks(fd: int, addr, size, mask, first, chunk_rows: int,
                     filters, filter_es, stored, out, lo: int, hi: int,
                     n_threads=N_THREADS):
    """Decode the chunks at file offsets ``addr`` (``size`` stored bytes,
    filter ``mask``, ``first`` row, ``chunk_rows`` rows each) of a 1-D
    dataset of file type ``stored`` whose filter pipeline is ``filters``
    (1 deflate, 2 shuffle by ``filter_es`` bytes, in file order), reading
    from the open file ``fd``, into ``out`` (rows ``[lo, hi)``; a type
    :func:`h5_writes` takes), on up to ``n_threads`` threads, no more than
    there are chunks. Rows no chunk holds are left as they were.

    Returns ``(rc, stats)``: rc 0, or :data:`H5_READ`, :data:`H5_INFLATE`
    or :data:`H5_SIZE` for the first chunk (in row order) that failed;
    ``stats`` the chunks and bytes inflated, the nanoseconds in zlib and
    in the unshuffle (each summed over the threads: CPU time, not wall
    time), the failing chunk's index into the arrays and a detail (zlib's
    code, or the decoded length)."""
    global H5_DECODES
    stored = np.dtype(stored)
    if not (isinstance(out, np.ndarray) and out.ndim == 1
            and out.flags.c_contiguous and len(out) == hi - lo
            and h5_writes(stored, out.dtype)):
        raise TypeError(f"out must be a C-contiguous 1-D array of {hi - lo} "
                        f"elements that {stored} can be written as")
    arrays = [np.ascontiguousarray(a, np.int64)
              for a in (addr, size, mask, first)]
    if len({a.shape for a in arrays}) != 1 or arrays[0].ndim != 1:
        raise ValueError("addr, size, mask and first must be equal 1-D "
                         "shapes")
    fids = np.ascontiguousarray(filters, np.int32)
    fes = np.ascontiguousarray(filter_es, np.int32)
    native_type = stored.newbyteorder("=")
    src = _H5_CODES.get(native_type, 0)
    dst = 0 if out.dtype == native_type else _H5_CODES[out.dtype]
    stats = np.zeros(8, np.int64)
    with _H5_DECODES_LOCK:
        H5_DECODES += 1
    rc = h5_library().mtpu_h5_decode_chunks(
        int(fd), *arrays, len(arrays[0]), int(chunk_rows), fids, fes,
        len(fids), stored.itemsize, src, int(not stored.isnative),
        _ptr(out), dst, out.dtype.itemsize, int(lo), int(hi), int(n_threads),
        stats)
    if rc not in (0, H5_READ, H5_INFLATE, H5_SIZE):
        raise RuntimeError(f"native HDF5 chunk decode failed (rc={rc})")
    return rc, stats


def bind_cool(lib) -> None:
    """ctypes signatures of the cooler pixel sift's two passes."""
    head = [_I64, _I64, _F64, _i64, _I64, _P, _i64, _P, _i64, _i32]
    lib.mtpu_cool_count.restype = ctypes.c_int
    lib.mtpu_cool_count.argtypes = head + [_I64]
    lib.mtpu_cool_write.restype = ctypes.c_int
    lib.mtpu_cool_write.argtypes = head + [_I64, _I64, _I64, _F64]


def cool_library():
    """The cooler pixel sift library, built at first use (raises on
    failure)."""
    from mustache_tpu_torch.kernels import build

    return build.load("cool_select", bind_cool, src=COOL_SRC)


COOL_OUTSIDE = -1   # the sift's code for a bin outside its weights


def cool_select(b1, b2, v, bounds, wx=None, wy=None, n_threads=N_THREADS):
    """A cooler fetch's pixel rows sifted in one native pass over the
    decoded columns ``b1``, ``b2`` (int64) and ``v`` (float64): the rows
    with ``c_lo <= b2 < c_hi`` and ``|b2 - b1| <= kmax`` kept, their bins
    shifted to ``(b1 - xlo, b2 - ylo)``, their values balanced as
    ``(v * wx[x]) * wy[y]`` where the weight vectors ``wx`` and ``wy`` are
    given, and only finite positive values kept; ``bounds`` is ``(c_lo,
    c_hi, kmax, xlo, ylo)``. Returns ``(x, y, v)`` in input order, or None
    where a kept row's shifted bin lies outside its weight vector. The
    columns are read in place where they are C-contiguous int64 and
    float64 (else copied once), and split over up to ``n_threads``
    threads, each counting, then writing, its range's kept rows into its
    slice of the outputs."""
    global COOL_SELECTS
    cols = (np.ascontiguousarray(b1, np.int64),
            np.ascontiguousarray(b2, np.int64), _f64(v))
    n = len(cols[2])
    if any(a.shape != (n,) for a in cols):
        raise ValueError(f"columns of shapes {[a.shape for a in cols]}: "
                         f"three 1-D columns of one length needed")
    if (wx is None) != (wy is None):
        raise ValueError("give both weight vectors or neither")
    w = [None, 0, None, 0]
    if wx is not None:
        wx, wy = _f64(wx), _f64(wy)
        if wx.ndim != 1 or wy.ndim != 1:
            raise ValueError("weight vectors must be 1-D")
        w = [_ptr(wx), len(wx), _ptr(wy), len(wy)]
    bounds = np.array(bounds, np.int64)
    if bounds.shape != (5,):
        raise ValueError("bounds are (c_lo, c_hi, kmax, xlo, ylo)")
    lib, ranges = cool_library(), max(1, min(int(n_threads), n))
    with _COOL_SELECTS_LOCK:
        COOL_SELECTS += 1
    counts = np.zeros(ranges, np.int64)
    rc = lib.mtpu_cool_count(*cols, n, bounds, *w, ranges, counts)
    if rc == 0:
        offsets = np.zeros(ranges, np.int64)
        np.cumsum(counts[:-1], out=offsets[1:])
        k = int(counts.sum())
        out = (np.empty(k, np.int64), np.empty(k, np.int64),
               np.empty(k, np.float64))
        rc = lib.mtpu_cool_write(*cols, n, bounds, *w, ranges, offsets, *out)
    if rc == COOL_OUTSIDE:
        return None
    if rc != 0:
        raise RuntimeError(f"native cool_select failed (rc={rc})")
    return out


def available() -> bool:
    """Whether the native host normalize can be built here: a host C++
    compiler is found (``kernels/build.py::gxx``), as the JAX package's
    ``available()`` says whether its prebuilt library loads. Without one,
    ``normalize.normalize_sparse`` runs its numpy fast path, as the JAX
    package's does; with one, a failed build raises."""
    from mustache_tpu_torch.kernels import build

    try:
        build.gxx()
    except RuntimeError:
        return False
    return True


def normalize_coo(x, y, v, n_bins, Dv, F, band_out=None,
                  n_threads=N_THREADS):
    """One-call local-regime normalize (``normalize.normalize_sparse``'s
    fast path): mutates ``v`` (float64, C-contiguous) in place, optionally
    fills a zeroed f32 band ``band_out[x, y-x] = z``, and returns
    ``(weights, n_skipped)``; ``n_skipped`` counts entries with ``y-x >=
    Dv``, which are left untouched (and not written to the band)."""
    if v.dtype != np.float64 or not v.flags.c_contiguous:
        raise TypeError(f"v must be C-contiguous float64, got {v.dtype}")
    weights = np.empty(int(Dv), np.float64)
    if band_out is None:
        bptr, ldb = None, 0
    else:
        _out(band_out, (np.float32,))
        bptr, ldb = _ptr(band_out), band_out.shape[1]
    skipped = ctypes.c_int64(0)
    rc = normalize_library().mtpu_normalize_coo(
        np.ascontiguousarray(x, np.int64), np.ascontiguousarray(y, np.int64),
        v, len(v), int(n_bins), int(Dv), int(F), weights, bptr, ldb,
        ctypes.byref(skipped), int(n_threads))
    if rc != 0:
        raise RuntimeError(f"native normalize_coo failed (rc={rc})")
    return weights, skipped.value


def _xy(x, y):
    """x, y as one C-contiguous int32/int64 dtype (no copy when they are)."""
    x, y = np.asarray(x), np.asarray(y)
    if x.dtype != y.dtype or x.dtype not in (np.int32, np.int64):
        x, y = x.astype(np.int64), y.astype(np.int64)
    return np.ascontiguousarray(x), np.ascontiguousarray(y)


def _f64(v) -> np.ndarray:
    return np.ascontiguousarray(v, dtype=np.float64)


def _out(band, dtypes) -> None:
    if band.dtype not in dtypes or not band.flags.c_contiguous \
            or band.ndim != 2:
        raise TypeError(f"band must be a C-contiguous 2-D array of "
                        f"{[np.dtype(d).name for d in dtypes]}, got "
                        f"{band.dtype} {band.shape}")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _count_fill() -> None:
    global FILLS
    FILLS += 1


def _check(rc: int, name: str) -> int:
    if rc < 0:
        raise RuntimeError(f"native {name} failed (rc={rc})")
    return rc


def fill_band(x, y, v, band_out, n_threads=N_THREADS) -> None:
    """Scatter-fill the f32 ``band_out[x, y-x] = v`` (entries outside the
    band or row range skipped) in one threaded native pass; duplicate
    (x, y) pairs resolve last-write-wins as in input order."""
    x, y = _xy(x, y)
    v = np.ascontiguousarray(v)
    if v.dtype not in (np.float32, np.float64):
        v = v.astype(np.float64)
    _out(band_out, (np.float32,))
    _count_fill()
    _check(library().mtpu_fill_band(
        _ptr(x), _ptr(y), int(x.dtype == np.int64), _ptr(v),
        int(v.dtype == np.float64), len(v), band_out, band_out.shape[0],
        band_out.shape[1], int(n_threads)), "fill_band")


def classify_values(v, n_threads=N_THREADS) -> tuple[int, int, int]:
    """Exception census for the compact band, in one pass: ``(misfit_u8,
    misfit_u16, misfit_u4)`` counts of values that are not non-negative
    integers below 256 / 65536 / 16."""
    v = _f64(v)
    out = np.zeros(3, np.int64)
    _check(library().mtpu_classify_values(v, len(v), int(n_threads), out),
           "classify_values")
    return int(out[0]), int(out[1]), int(out[2])


def _exc_buffers(cap: int):
    cap = max(int(cap), 1)
    return (np.empty(cap, np.int32), np.empty(cap, np.int32),
            np.empty(cap, np.float32), cap)


UNSORTED = -2    # the compact fills' code for a COO not sorted by row


def _walkable(x, y) -> bool:
    """Whether the compact fills' row-range walk reads ``x`` and ``y`` as
    given: both int32 or both int64. Others are copied to int64 by
    :func:`_xy` and filled by the full scan."""
    dx, dy = np.asarray(x).dtype, np.asarray(y).dtype
    return dx == dy and dx in (np.int32, np.int64)


def fill_band_compact(x, y, v, band_out, exc_cap, n_threads=N_THREADS,
                      scan=False, packed4=False):
    """Narrow-band fill with an exception list: integer-fitting values land
    in ``band_out`` (uint8 or uint16), misfits come back as ``(rows, cols,
    f32 values)``, trimmed to their count (order across threads is not
    fixed). Requires unique (x, y) pairs. Raises when more than
    ``exc_cap`` misfits turn up.

    ``packed4``: ``band_out`` is the nibble-packed uint8 ``[rows, Dl //
    2]`` band (even diagonal in the low nibble), which need not come
    zeroed; values that are not integers below 16 are the misfits.

    Each thread walks only its own rows' entries, found by binary search
    on ``x``, so the COO has to be sorted by row: where it is not, or
    where ``x`` and ``y`` are not both int32 or both int64, None comes
    back and ``band_out`` is as it was, or zeroed where the disorder
    showed only during the walk. ``scan=True`` fills any COO, each thread
    reading every entry."""
    _out(band_out, (np.uint8,) if packed4 else (np.uint8, np.uint16))
    if not (scan or _walkable(x, y)):
        return None
    return _trimmed("fill_band_compact", *_compact(
        "mtpu_fill_band_compact", x, y, v, band_out, (band_out.shape[0],),
        exc_cap, n_threads, scan, packed4, None, None), packed4)


def fill_band_compact_range(x, y, v, slab, g0, g1, exc_cap,
                            n_threads=N_THREADS, scan=False, packed4=False):
    """Row-windowed compact fill for the streamed upload: fill only global
    rows [g0, g1) into ``slab`` (whose row 0 is global row g0). Exception
    rows come back as global indices. None, ``scan`` and ``packed4`` as in
    :func:`fill_band_compact`; the walk also reads the other rows' ``x``
    once, for their order."""
    _out(slab, (np.uint8,) if packed4 else (np.uint8, np.uint16))
    if not 0 <= g0 <= g1 or g1 - g0 != slab.shape[0]:
        raise ValueError(f"rows [{g0}, {g1}) do not match a slab of "
                         f"{slab.shape[0]} rows")
    if not (scan or _walkable(x, y)):
        return None
    return _trimmed("fill_band_compact_range", *_compact(
        "mtpu_fill_band_compact_range", x, y, v, slab, (int(g0), int(g1)),
        exc_cap, n_threads, scan, packed4), packed4)


def fill_band_u8_census(x, y, v, band_out, n_threads=N_THREADS):
    """:func:`fill_band_compact` into a uint8 ``band_out`` and the u8 and
    u16 counts of :func:`classify_values`' census of every value, in one
    pass over a COO sorted by row: ``(exceptions, (misfit_u8,
    misfit_u16))``, with every exception (no capacity: the pass holds
    them, and they are copied out at their count). None, as from
    :func:`fill_band_compact`, where the COO is not sorted by row, or
    ``x`` and ``y`` are not both int32 or both int64."""
    _out(band_out, (np.uint8,))
    if not _walkable(x, y):
        return None
    census, held = np.zeros(2, np.int64), ctypes.c_void_p()
    n, _ = _compact("mtpu_fill_band_compact", x, y, v, band_out,
                    (band_out.shape[0],), 0, n_threads, False, False,
                    _ptr(census), ctypes.byref(held))
    if n == UNSORTED:
        return None
    _check(n, "fill_band_u8_census")
    exc = (None,) * 3
    try:
        exc = _exc_buffers(n)[:3]
    finally:   # copies the held exceptions out (once made) and frees them
        library().mtpu_take_exceptions(
            held, *(None if a is None else _ptr(a) for a in exc))
    return tuple(a[:n] for a in exc), (int(census[0]), int(census[1]))


def _compact(name, x, y, v, band, window, exc_cap, n_threads, scan,
             packed4, *extra):
    """One native compact fill over the rows ``window`` (``(n_rows,)`` or
    ``(g0, g1)``): its return code and exception buffers."""
    x, y = _xy(x, y)
    v = _f64(v)
    er, ec, ev, cap = _exc_buffers(exc_cap)
    bits, ldb = ((4, 2 * band.shape[1]) if packed4
                 else (8 * band.dtype.itemsize, band.shape[1]))
    _count_fill()
    n = getattr(library(), name)(
        _ptr(x), _ptr(y), int(x.dtype == np.int64), v, len(v), _ptr(band),
        bits, *window, ldb, er, ec, ev, cap, int(n_threads), int(scan),
        *extra)
    return n, (er, ec, ev)


def _trimmed(name, n, exc, packed4):
    """A compact fill's exceptions trimmed to its count ``n``; None for a
    COO not sorted by row."""
    global FILLS4
    if n == UNSORTED:
        return None
    _check(n, f"{name} (exception capacity overflow)")
    FILLS4 += packed4
    return tuple(a[:n] for a in exc)


# numpy twins (plain versions) ---------------------------------------------

def _isint(v: np.ndarray) -> np.ndarray:
    return np.isfinite(v) & (v >= 0) & (v == np.floor(v))


def fill_band_plain(x, y, v, band_out) -> None:
    d = y - x
    sel = ((d >= 0) & (d < band_out.shape[1]) & (x >= 0)
           & (x < band_out.shape[0]))
    band_out[x[sel], d[sel]] = v[sel]


def classify_values_plain(v) -> tuple[int, int]:
    isint = _isint(v)
    return (int(np.count_nonzero(~(isint & (v < 256)))),
            int(np.count_nonzero(~(isint & (v < 65536)))))


def classify_values4_plain(v) -> int:
    return int(np.count_nonzero(~(_isint(v) & (v < 16))))


def fill_band_compact_range_plain(x, y, v, slab, g0, g1):
    d = y - x
    inb = (d >= 0) & (d < slab.shape[1]) & (x >= g0) & (x < g1)
    fit = _isint(v) & (v < (65536 if slab.dtype == np.uint16 else 256))
    sel = inb & fit
    slab[x[sel] - g0, d[sel]] = v[sel]
    sel = inb & ~fit
    return (x[sel].astype(np.int32), d[sel].astype(np.int32),
            v[sel].astype(np.float32))


def fill_band_compact_plain(x, y, v, band_out):
    return fill_band_compact_range_plain(x, y, v, band_out, 0,
                                         band_out.shape[0])


def pack_band4_plain(band):
    big_r, big_c = np.nonzero(band >= 16)
    big = (big_r.astype(np.int32), big_c.astype(np.int32),
           band[big_r, big_c].astype(np.float32))
    low = np.where(band >= 16, 0, band).astype(np.uint8)
    return np.ascontiguousarray(low[:, 0::2] | (low[:, 1::2] << 4)), big
