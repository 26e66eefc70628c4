""".cool / .mcool reader over the port's own HDF5 reader (``io/h5.py``:
numpy and zlib; no h5py, no cooler).

Copied from ``mustache_tpu/io/cool.py:1-239`` with the HDF5 access moved
from h5py to :class:`mustache_tpu_torch.io.h5.H5File`: the names,
signatures, errors and results are the JAX reader's. Nothing of the port
imports h5py.

Implements the subset of the cooler schema the detection engine needs
(reference usage: mustache.py:399-592, :1019-1029):

* ``/chroms/{name,length}``, ``/bins/{chrom,start,weight,...}``,
  ``/pixels/{bin1_id,bin2_id,count}``, ``/indexes/{chrom_offset,bin1_offset}``
* ``.mcool`` files address a resolution via ``/resolutions/<res>/...``

Band fetches use the ``bin1_offset`` index to read exactly the pixel rows
of the requested chromosome (only the chunks that hold them are
decompressed), then filter to the diagonal band — this is equivalent to
(and replaces) the reference's overlapping-window walk with Python
set-difference dedup (mustache.py:411-457), which existed only to work
around cooler's dense-window API.

Balancing matches ``cooler.matrix(balance=...)``: value = count *
weight[bin1] * weight[bin2]; NaN weights produce NaN values which the
caller's positivity filter drops (the reference reaches the same end state
through nan_to_num + ``val > 0``, mustache.py:427-487).

The band or rectangle keep, the shift of the bins to the chromosomes'
own, the balance and the drop are one threaded native pass over the
decoded columns (``native.cool_select``, ``io/native/cool_select.cpp``),
which writes only the kept rows, in file order; :func:`_select_plain` is
its numpy twin, which the tests hold it to. A kept pixel whose bin lies
outside its chromosome's weights is a malformed file: the fetch raises
``ValueError`` naming it.

A fetch opens up to three profiler ranges, once each: ``cool.read`` (the
index slice and the three pixel columns, inflated), ``cool.balance``
(the weight columns read; only where the fetch balances) and
``cool.select`` (the one native pass). :attr:`CoolFile.counters` adds up
the pixel rows read, sifted by the native pass and kept, and the HDF5
reader's inflate counters.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mustache_tpu_torch.io import native
from mustache_tpu_torch.io.h5 import H5File

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


class CoolFile:
    """Read-only view of one resolution of a .cool/.mcool file."""

    def __init__(self, path: str, resolution: int | None = None):
        self.path = path
        self._h5 = H5File(path)
        try:
            if path.endswith(".mcool") or "resolutions" in self._h5:
                if resolution is None:
                    raise ValueError(".mcool requires an explicit resolution")
                key = f"resolutions/{int(resolution)}"
                if key not in self._h5:
                    avail = (self._h5.keys("resolutions")
                             if "resolutions" in self._h5 else [])
                    raise ValueError(f"resolution {resolution} not in {path}; "
                                     f"available: {avail}")
                self._g = key + "/"       # path prefix of the resolution
            else:
                self._g = ""
        except BaseException:
            self._h5.close()
            raise
        # metadata caches: chromnames/chrom_offset are re-consulted many
        # times per fetch (membership checks, bin ranges, weights); at 1kb
        # genome scale the HDF5 re-reads add up
        self._chromnames = None
        self._chrom_offset = None
        self.rows = {"rows_read": 0, "rows_native": 0, "rows_kept": 0}

    @property
    def counters(self) -> dict:
        """Pixel rows read, sifted by the native pass and kept by this
        file's fetches, and the HDF5 reader's inflate counters
        (``H5File.counters``)."""
        return {**self.rows, **self._h5.counters}

    # -- metadata ----------------------------------------------------------
    @property
    def binsize(self) -> int:
        return int(self._h5.attrs(self._g)["bin-size"])

    @property
    def chromnames(self) -> list[str]:
        if self._chromnames is None:
            self._chromnames = [
                c.decode() if isinstance(c, bytes) else str(c)
                for c in self._h5.read(self._g + "chroms/name")]
        return self._chromnames

    @property
    def chromsizes(self) -> np.ndarray:
        return self._h5.read(self._g + "chroms/length")

    def chrom_index(self, name: str) -> int:
        try:
            return self.chromnames.index(name)
        except ValueError:
            raise NameError("wrong chromosome name!") from None

    # -- pixels ------------------------------------------------------------
    def _chrom_bin_range(self, name: str) -> tuple[int, int]:
        ci = self.chrom_index(name)
        if self._chrom_offset is None:
            self._chrom_offset = self._h5.read(
                self._g + "indexes/chrom_offset")
        off = self._chrom_offset
        return int(off[ci]), int(off[ci + 1])

    def weights(self, name: str, column: str = "weight") -> np.ndarray:
        lo, hi = self._chrom_bin_range(name)
        name = f"{self._g}bins/{column}"
        if name not in self._h5:
            raise ValueError(f"balance column {column!r} not in {self.path}")
        return self._h5.read(name, lo, hi, np.float64)

    def _read_pixels(self, p0: int, p1: int):
        """The three pixel columns for rows [p0, p1), widened to i64/f64
        as each chunk is copied out (no post-read .astype pass; at 9.3M
        rows those three extra numpy copies cost more than the reads
        themselves on a throttled VM)."""
        px = self._g + "pixels/"
        return (self._h5.read(px + "bin1_id", p0, p1, np.int64),
                self._h5.read(px + "bin2_id", p0, p1, np.int64),
                self._h5.read(px + "count", p0, p1, np.float64))

    def _sift(self, b1, b2, v, bounds, wx=None, wy=None):
        """The fetch's one native pass (:func:`native.cool_select`) over
        its decoded rows, counted; raises ``ValueError`` for a kept pixel
        whose bin lies outside its weights."""
        out = native.cool_select(b1, b2, v, bounds, wx, wy)
        if out is None:
            raise ValueError(f"a pixel's bin lies outside its chromosome's "
                             f"weights in {self.path} (malformed file)")
        self.rows["rows_read"] += len(v)
        self.rows["rows_native"] += len(v)
        self.rows["rows_kept"] += len(out[2])
        return out

    def _weights(self, balance, *chroms):
        """Each chromosome's weight column, read in a ``cool.balance``
        range; ``(None,) * len(chroms)`` when ``balance`` is False."""
        if balance is False:
            return (None,) * len(chroms)
        column = "weight" if balance is True else str(balance)
        with torch.profiler.record_function("cool.balance"):
            return tuple(self.weights(c, column) for c in chroms)

    def fetch_band(self, chrom: str, distance_bp: int,
                   balance: str | bool = True):
        """COO triplets (x, y, v) of the chromosome's upper-triangular
        diagonal band, bin coords relative to the chromosome start,
        balanced unless ``balance`` is False."""
        rf = torch.profiler.record_function
        res = self.binsize
        lo, hi = self._chrom_bin_range(chrom)
        with rf("cool.read"):
            # slice only this chromosome's rows of the genome-wide index
            # (~25MB at 1kb genome scale if read whole)
            b1off = self._h5.read(self._g + "indexes/bin1_offset", lo,
                                  hi + 1)
            p0, p1 = int(b1off[0]), int(b1off[-1])
            b1, b2, v = self._read_pixels(p0, p1)
        w, = self._weights(balance, chrom)
        with rf("cool.select"):
            return self._sift(b1, b2, v, (_I64_MIN, hi, _band_kmax(
                distance_bp, res), lo, lo), w, w)

    def fetch_rect(self, chrom1: str, chrom2: str,
                   balance: str | bool = True):
        """COO triplets (x, y, v) of the chrom1 x chrom2 rectangle, bin
        coords relative to each chromosome's start, balanced unless
        ``balance`` is False. Cooler stores pixels upper-triangular in
        genome bin order, so the stored orientation is by chromosome
        index; the result is transposed back when the caller's order
        differs."""
        i1 = self.chrom_index(chrom1)
        i2 = self.chrom_index(chrom2)
        if i1 == i2:
            raise ValueError("fetch_rect needs two distinct chromosomes")
        flip = i1 > i2
        a, b = (chrom2, chrom1) if flip else (chrom1, chrom2)
        alo, ahi = self._chrom_bin_range(a)
        blo, bhi = self._chrom_bin_range(b)
        rf = torch.profiler.record_function
        with rf("cool.read"):
            b1off = self._h5.read(self._g + "indexes/bin1_offset", alo,
                                  ahi + 1)
            p0, p1 = int(b1off[0]), int(b1off[-1])
            b1, b2, v = self._read_pixels(p0, p1)
        wa, wb = self._weights(balance, a, b)
        with rf("cool.select"):
            out = self._sift(b1, b2, v, (blo, bhi, _I64_MAX, alo, blo), wa,
                             wb)
        return (out[1], out[0], out[2]) if flip else out

    def close(self):
        self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _band_kmax(distance_bp, res) -> int:
    """The largest bin distance of the band, ``floor(distance_bp / res)``
    (int64's largest at most): for bins below 2**53, ``|b2 - b1| <=
    distance_bp / res`` exactly when ``|b2 - b1| <= _band_kmax(...)``."""
    return min(math.floor(distance_bp / res), _I64_MAX)


def _select_plain(b1, b2, v, bounds, wx=None, wy=None):
    """:func:`native.cool_select` in numpy: the passes a fetch made before
    the native sift, kept as its twin. None where a kept row's shifted bin
    lies outside its weight vector (numpy's indexing would wrap a negative
    one)."""
    c_lo, c_hi, kmax, xlo, ylo = bounds
    keep = (b2 >= c_lo) & (b2 < c_hi) & (np.abs(b2 - b1) <= kmax)
    x, y, v = b1[keep] - xlo, b2[keep] - ylo, v[keep]
    if wx is not None:
        if len(x) and (x.min() < 0 or x.max() >= len(wx) or y.min() < 0
                       or y.max() >= len(wy)):
            return None
        v = v * wx[x]
        v *= wy[y]
    return _positive(x, y, v)


def _positive(x, y, v):
    """The triplets whose value is finite and positive.

    Deliberate deviation: the reference's bare nan_to_num
    (mustache.py:428) maps +-inf to +-DBL_MAX, letting an inf-scaled
    count through the positivity filter as an absurd value; cooler
    balance weights are NaN (never inf) for masked bins, so inf here can
    only mean corrupt input — drop it instead. NaN fails > 0 on its own,
    so (v > 0) & isfinite == nan_to_num + (v > 0), minus the full-array
    scrub pass."""
    pos = (v > 0) & np.isfinite(v)
    return x[pos], y[pos], v[pos]


def read_cooler(path: str, distance_bp: int, chr1: str, chr2: str,
                balance: str | bool, counters: dict | None = None):
    """Reference-shaped entry point: returns (x, y, v, res)
    (mustache.py:399-493). ``counters``, where given, is updated with the
    fetch's :attr:`CoolFile.counters`."""
    clr = CoolFile(path)
    res = clr.binsize
    if chr1 not in clr.chromnames or chr2 not in clr.chromnames:
        raise NameError("wrong chromosome name!")
    # reference parity: a falsy norm coerces to balance=True — the
    # reference CANNOT fetch raw counts either (mustache.py:424-427
    # "if not cooler_balance: balance=True"); use CoolFile.fetch_band
    # directly for raw counts
    bal = True if not balance else balance
    if chr1 != chr2:
        # rectangle fetch for the inter-chromosomal mode (functional here;
        # the reference advertises but cannot serve it, mustache.py:689-694)
        x, y, v = clr.fetch_rect(chr1, chr2, balance=bal)
    else:
        x, y, v = clr.fetch_band(chr1, distance_bp, balance=bal)
    clr.close()
    if counters is not None:
        counters.update(clr.counters)
    return x, y, v, res


def read_mcooler(path: str, distance_bp: int, chr1: str, chr2: str, res: int,
                 balance: str | bool, counters: dict | None = None):
    """Reference-shaped entry point for .mcool (mustache.py:496-592);
    ``counters`` as :func:`read_cooler`'s."""
    clr = CoolFile(path, resolution=res)
    if chr1 not in clr.chromnames or chr2 not in clr.chromnames:
        raise NameError("wrong chromosome name!")
    # reference parity: a falsy norm coerces to balance=True — the
    # reference CANNOT fetch raw counts either (mustache.py:424-427
    # "if not cooler_balance: balance=True"); use CoolFile.fetch_band
    # directly for raw counts
    bal = True if not balance else balance
    if chr1 != chr2:
        x, y, v = clr.fetch_rect(chr1, chr2, balance=bal)
    else:
        x, y, v = clr.fetch_band(chr1, distance_bp, balance=bal)
    clr.close()
    if counters is not None:
        counters.update(clr.counters)
    return x, y, v


def cool_chrom_list(path: str, res: int | None = None) -> list[str]:
    """Chromosomes large enough to analyze (>1Mb), as the reference's
    driver discovers them (mustache.py:1019-1029)."""
    clr = CoolFile(path, resolution=res) if (
        path.endswith(".mcool")) else CoolFile(path)
    names = clr.chromnames
    sizes = clr.chromsizes
    out = [names[i] for i in range(len(names)) if sizes[i] > 1_000_000]
    clr.close()
    return out
