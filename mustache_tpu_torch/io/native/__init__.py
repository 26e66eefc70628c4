"""ctypes bindings for the native host band fill, and its numpy twins.

Torch port of the band half of ``mustache_tpu/io/native/__init__.py``
(bindings at :250-424). ``band_fill.cpp`` (a copy of the JAX package's
band functions) is compiled with g++ at first use into the port's build
cache (``kernels/build.py``, keyed by a hash of the source); a failed
build raises, and nothing here falls back to numpy. Argument dtypes and
contiguity are checked in Python before any pointer is passed; a wrong
one raises ``TypeError``.

The ``*_plain`` functions are the numpy twins the JAX package keeps
beside its native calls (``mustache_tpu/pipeline.py:67-76,109-112,
136-147,159-165``). The tests hold the native functions to them; the
pipeline does not call them.

``FILLS`` counts the native fill calls (plain integer), so a run can show
that its band went up through the native fill.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "band_fill.cpp"
N_THREADS = 8
FILLS = 0

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_U16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_P, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


def bind(lib) -> None:
    """ctypes signatures of the band entry points (as the JAX bindings)."""
    sigs = {
        "mtpu_fill_band": [_P, _P, _i32, _P, _i32, _i64, _F32, _i64, _i64,
                           _i32],
        "mtpu_fill_band_u16": [_P, _P, _i32, _F64, _i64, _U16, _i64, _i64,
                               _i32],
        "mtpu_values_fit_u16": [_F64, _i64, _i32],
        "mtpu_classify_values": [_F64, _i64, _i32, _I64],
        "mtpu_fill_band_compact": [_P, _P, _i32, _F64, _i64, _P, _i32, _i64,
                                   _i64, _I32, _I32, _F32, _i64, _i32],
        "mtpu_classify_values4": [_F64, _i64, _i32, _I64],
        "mtpu_pack_band4": [_U8, _i64, _i64, _U8, _I32, _I32, _F32, _i64,
                            _i32],
        "mtpu_fill_band_compact_range": [_P, _P, _i32, _F64, _i64, _P, _i32,
                                         _i64, _i64, _i64, _I32, _I32, _F32,
                                         _i64, _i32],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes


def library():
    """The band-fill library, built at first use (raises on failure)."""
    from mustache_tpu_torch.kernels import build

    return build.load("band_fill", bind, src=SRC)


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


def values_fit_u16(v, n_threads=N_THREADS) -> bool:
    """True when every value is a non-negative integer < 65536."""
    v = _f64(v)
    return bool(library().mtpu_values_fit_u16(v, len(v), int(n_threads)))


def fill_band_u16(x, y, v, band_out, n_threads=N_THREADS) -> None:
    """uint16 twin of :func:`fill_band`; the caller has established with
    :func:`values_fit_u16` that every value fits."""
    x, y = _xy(x, y)
    v = _f64(v)
    _out(band_out, (np.uint16,))
    _count_fill()
    _check(library().mtpu_fill_band_u16(
        _ptr(x), _ptr(y), int(x.dtype == np.int64), v, len(v), band_out,
        band_out.shape[0], band_out.shape[1], int(n_threads)),
        "fill_band_u16")


def classify_values(v, n_threads=N_THREADS) -> tuple[int, int]:
    """Exception census for the compact band: (misfit_u8, misfit_u16)
    counts of values that are not non-negative integers below 256 /
    65536."""
    v = _f64(v)
    out = np.zeros(2, np.int64)
    _check(library().mtpu_classify_values(v, len(v), int(n_threads), out),
           "classify_values")
    return int(out[0]), int(out[1])


def classify_values4(v, n_threads=N_THREADS) -> int:
    """4-bit census: count of values that are not non-negative integers
    below 16."""
    v = _f64(v)
    out = np.zeros(1, np.int64)
    _check(library().mtpu_classify_values4(v, len(v), int(n_threads), out),
           "classify_values4")
    return int(out[0])


def _exc_buffers(cap: int):
    cap = max(int(cap), 1)
    return (np.empty(cap, np.int32), np.empty(cap, np.int32),
            np.empty(cap, np.float32), cap)


def fill_band_compact(x, y, v, band_out, exc_cap, n_threads=N_THREADS):
    """Narrow-band fill with an exception list: integer-fitting values land
    in ``band_out`` (uint8 or uint16), misfits come back as ``(rows, cols,
    f32 values)``, trimmed to their count (order across threads is not
    fixed). Requires unique (x, y) pairs. Raises when more than
    ``exc_cap`` misfits turn up."""
    x, y = _xy(x, y)
    v = _f64(v)
    _out(band_out, (np.uint8, np.uint16))
    er, ec, ev, cap = _exc_buffers(exc_cap)
    _count_fill()
    n = _check(library().mtpu_fill_band_compact(
        _ptr(x), _ptr(y), int(x.dtype == np.int64), v, len(v),
        _ptr(band_out), int(band_out.dtype == np.uint16), band_out.shape[0],
        band_out.shape[1], er, ec, ev, cap, int(n_threads)),
        "fill_band_compact (exception capacity overflow)")
    return er[:n], ec[:n], ev[:n]


def fill_band_compact_range(x, y, v, slab, g0, g1, exc_cap,
                            n_threads=N_THREADS):
    """Row-windowed compact fill for the streamed upload: fill only global
    rows [g0, g1) into ``slab`` (whose row 0 is global row g0). Exception
    rows come back as global indices."""
    x, y = _xy(x, y)
    v = _f64(v)
    _out(slab, (np.uint8, np.uint16))
    if not 0 <= g0 <= g1 or g1 - g0 != slab.shape[0]:
        raise ValueError(f"rows [{g0}, {g1}) do not match a slab of "
                         f"{slab.shape[0]} rows")
    er, ec, ev, cap = _exc_buffers(exc_cap)
    _count_fill()
    n = _check(library().mtpu_fill_band_compact_range(
        _ptr(x), _ptr(y), int(x.dtype == np.int64), v, len(v), _ptr(slab),
        int(slab.dtype == np.uint16), int(g0), int(g1), slab.shape[1],
        er, ec, ev, cap, int(n_threads)),
        "fill_band_compact_range (exception capacity overflow)")
    return er[:n], ec[:n], ev[:n]


def pack_band4(band, exc_cap, out=None, n_threads=N_THREADS):
    """Nibble-pack a filled uint8 band (two counts per byte, even column in
    the low nibble) into ``out`` (new when None). In-band values >= 16 come
    back as an exception triple and are packed as 0. Returns ``(packed,
    (rows, cols, values))``."""
    _out(band, (np.uint8,))
    rows, ldb = band.shape
    if ldb % 2:
        raise ValueError(f"pack_band4 needs an even band width, got {ldb}")
    if out is None:
        out = np.empty((rows, ldb // 2), np.uint8)
    _out(out, (np.uint8,))
    if out.shape != (rows, ldb // 2):
        raise ValueError(f"packed output {out.shape} != {(rows, ldb // 2)}")
    er, ec, ev, cap = _exc_buffers(exc_cap)
    n = _check(library().mtpu_pack_band4(band, rows, ldb, out, er, ec, ev,
                                         cap, int(n_threads)),
               "pack_band4 (exception capacity overflow)")
    return out, (er[:n], ec[:n], ev[:n])


# numpy twins (plain versions) ---------------------------------------------

def _isint(v: np.ndarray) -> np.ndarray:
    return np.isfinite(v) & (v >= 0) & (v == np.floor(v))


def fill_band_plain(x, y, v, band_out) -> None:
    d = y - x
    sel = ((d >= 0) & (d < band_out.shape[1]) & (x >= 0)
           & (x < band_out.shape[0]))
    band_out[x[sel], d[sel]] = v[sel]


def values_fit_u16_plain(v) -> bool:
    return bool(v.size > 0 and float(v.min()) >= 0.0
                and float(v.max()) < 65536.0
                and not np.any(v != np.floor(v)))


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
