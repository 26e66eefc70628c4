"""Native .cool / .mcool reader (HDF5 via h5py — no cooler dependency).

Copied from ``mustache_tpu/io/cool.py:1-239``, with h5py imported only
inside the reader's calls: importing this module never loads h5py, and
without h5py opening a file raises the JAX reader's error (there is no
fallback reader).

Implements the subset of the cooler schema the detection engine needs
(reference usage: mustache.py:399-592, :1019-1029):

* ``/chroms/{name,length}``, ``/bins/{chrom,start,weight,...}``,
  ``/pixels/{bin1_id,bin2_id,count}``, ``/indexes/{chrom_offset,bin1_offset}``
* ``.mcool`` files address a resolution via ``/resolutions/<res>/...``

Band fetches use the ``bin1_offset`` index to read exactly the pixel rows
of the requested chromosome, then filter to the diagonal band — this is
equivalent to (and replaces) the reference's overlapping-window walk with
Python set-difference dedup (mustache.py:411-457), which existed only to
work around cooler's dense-window API.

Balancing matches ``cooler.matrix(balance=...)``: value = count *
weight[bin1] * weight[bin2]; NaN weights produce NaN values which the
caller's positivity filter drops (the reference reaches the same end state
through nan_to_num + ``val > 0``, mustache.py:427-487).
"""

from __future__ import annotations

import numpy as np


def _require_h5py():
    try:
        import h5py
    except ImportError:
        raise RuntimeError(".cool support requires h5py") from None
    return h5py


class CoolFile:
    """Read-only view of one resolution of a .cool/.mcool file."""

    def __init__(self, path: str, resolution: int | None = None):
        h5py = _require_h5py()
        self.path = path
        self._h5 = h5py.File(path, "r")
        if path.endswith(".mcool") or "resolutions" in self._h5:
            if resolution is None:
                raise ValueError(".mcool requires an explicit resolution")
            key = f"resolutions/{int(resolution)}"
            if key not in self._h5:
                avail = list(self._h5.get("resolutions", {}).keys())
                raise ValueError(
                    f"resolution {resolution} not in {path}; available: {avail}")
            self._g = self._h5[key]
        else:
            self._g = self._h5
        # metadata caches: chromnames/chrom_offset are re-consulted many
        # times per fetch (membership checks, bin ranges, weights); at 1kb
        # genome scale the HDF5 re-reads add up
        self._chromnames = None
        self._chrom_offset = None

    # -- metadata ----------------------------------------------------------
    @property
    def binsize(self) -> int:
        return int(self._g.attrs["bin-size"])

    @property
    def chromnames(self) -> list[str]:
        if self._chromnames is None:
            self._chromnames = [
                c.decode() if isinstance(c, bytes) else str(c)
                for c in self._g["chroms/name"][:]]
        return self._chromnames

    @property
    def chromsizes(self) -> np.ndarray:
        return self._g["chroms/length"][:]

    def chrom_index(self, name: str) -> int:
        try:
            return self.chromnames.index(name)
        except ValueError:
            raise NameError("wrong chromosome name!") from None

    # -- pixels ------------------------------------------------------------
    def _chrom_bin_range(self, name: str) -> tuple[int, int]:
        ci = self.chrom_index(name)
        if self._chrom_offset is None:
            self._chrom_offset = self._g["indexes/chrom_offset"][:]
        off = self._chrom_offset
        return int(off[ci]), int(off[ci + 1])

    def weights(self, name: str, column: str = "weight") -> np.ndarray:
        lo, hi = self._chrom_bin_range(name)
        bins = self._g["bins"]
        if column not in bins:
            raise ValueError(f"balance column {column!r} not in {self.path}")
        return bins[column][lo:hi].astype(np.float64)

    def _read_pixels(self, p0: int, p1: int):
        """The three pixel columns for rows [p0, p1), widened to
        i64/f64 DURING the HDF5 read (read_direct converts in-library —
        no post-read .astype pass; at 9.3M rows those three extra numpy
        copies cost more than the reads themselves on a throttled VM)."""
        px = self._g["pixels"]
        n = p1 - p0
        b1 = np.empty(n, np.int64)
        b2 = np.empty(n, np.int64)
        v = np.empty(n, np.float64)
        if n:
            sel = np.s_[p0:p1]
            px["bin1_id"].read_direct(b1, sel)
            px["bin2_id"].read_direct(b2, sel)
            px["count"].read_direct(v, sel)
        return b1, b2, v

    def fetch_band(self, chrom: str, distance_bp: int,
                   balance: str | bool = True):
        """COO triplets (x, y, v) of the chromosome's upper-triangular
        diagonal band, bin coords relative to the chromosome start,
        balanced unless ``balance`` is False."""
        res = self.binsize
        lo, hi = self._chrom_bin_range(chrom)
        # slice only this chromosome's rows of the genome-wide index
        # (~25MB at 1kb genome scale if read whole)
        b1off = self._g["indexes/bin1_offset"][lo:hi + 1]
        p0, p1 = int(b1off[0]), int(b1off[-1])
        b1, b2, v = self._read_pixels(p0, p1)

        keep = (b2 < hi) & (np.abs(b2 - b1) <= distance_bp / res)
        b1, b2, v = b1[keep] - lo, b2[keep] - lo, v[keep]

        if balance is not False:
            column = "weight" if balance is True else str(balance)
            w = self.weights(chrom, column)
            v *= w[b1]          # in place: v is this call's own copy
            v *= w[b2]
        # deliberate deviation: the reference's bare nan_to_num
        # (mustache.py:428) maps +-inf to +-DBL_MAX, letting an inf-scaled
        # count through the positivity filter as an absurd value; cooler
        # balance weights are NaN (never inf) for masked bins, so inf here
        # can only mean corrupt input — drop it instead. NaN fails > 0 on
        # its own, so (v > 0) & isfinite == nan_to_num + (v > 0), minus
        # the full-array scrub pass.
        pos = (v > 0) & np.isfinite(v)
        return b1[pos], b2[pos], v[pos]

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
        b1off = self._g["indexes/bin1_offset"][alo:ahi + 1]
        p0, p1 = int(b1off[0]), int(b1off[-1])
        b1, b2, v = self._read_pixels(p0, p1)
        keep = (b2 >= blo) & (b2 < bhi)
        x, y, v = b1[keep] - alo, b2[keep] - blo, v[keep]
        if balance is not False:
            column = "weight" if balance is True else str(balance)
            v *= self.weights(a, column)[x]
            v *= self.weights(b, column)[y]
        if flip:
            x, y = y, x
        # inf dropped, NaN fails > 0 — see fetch_band's deviation note
        pos = (v > 0) & np.isfinite(v)
        return x[pos], y[pos], v[pos]

    def close(self):
        self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_cooler(path: str, distance_bp: int, chr1: str, chr2: str,
                balance: str | bool):
    """Reference-shaped entry point: returns (x, y, v, res)
    (mustache.py:399-493)."""
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
    return x, y, v, res


def read_mcooler(path: str, distance_bp: int, chr1: str, chr2: str, res: int,
                 balance: str | bool):
    """Reference-shaped entry point for .mcool (mustache.py:496-592)."""
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
