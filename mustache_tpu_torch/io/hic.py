"""Native Juicer ``.hic`` reader (no hicstraw).

Torch port of ``mustache_tpu/io/hic.py`` (the JAX package's reader of the
public .hic format, versions 6-9: header, footer index, zoom data, block
index, block cull, norm vectors). The header, index and norm vectors are
read in Python; the blocks decode in one native pass
(``io/native/hic_decode.cpp``, a copy of the JAX package's decoder, built
at first use; a failed build raises). The Python decoder
(:meth:`HicFile._decode_blocks_plain`: ``zlib`` and one ``np.frombuffer``
per row-list row or dense block) is its plain twin, which the tests hold
it to.

The reader loads a whole chromosome's diagonal band at once (the
reference's overlapping-window walk via ``hicstraw.straw`` plus Python set
dedup, mustache.py:319-363, exists only to bound hicstraw's memory; the
union of its windows is exactly the band, which is read directly) and
divides counts by the requested normalization vector at both anchors, NaN
factors propagating so such pixels drop at the positivity filter.

Two profiler ranges split a chromosome's read: ``hic.decode`` (the native
block decode) and ``hic.assemble`` (the anchors ordered, the norm
vector's read and division and, in :func:`read_hic_file`, the band
filter).
"""

from __future__ import annotations

import dataclasses
import math
import struct
import zlib

import numpy as np
import torch

from mustache_tpu_torch.io.chrom import normalize_chrom


@dataclasses.dataclass
class HicChromosome:
    index: int
    name: str
    length: int


@dataclasses.dataclass
class _NormVectorKey:
    position: int
    n_bytes: int


@dataclasses.dataclass
class _BlockEntry:
    number: int
    position: int
    size: int


@dataclasses.dataclass
class _ZoomData:
    unit: str
    bin_size: int
    block_bin_count: int
    block_column_count: int
    blocks: list


def cull_band_blocks(blocks: list, zoom: "_ZoomData", version: int,
                     distance_bins: float) -> list:
    """Blocks of an intra-chromosomal zoom that can intersect the diagonal
    band ``|x - y| <= distance_bins``.

    The reference's windowed straw walk (mustache.py:319-363) only ever
    touches near-band data; decoding every block of a 1kb genome-wide zoom
    would read ~10-100x more than the band holds. Block numbers encode
    position (straw's getBlockNumbersForRegionFromBinPosition):

    * v<9: ``number = row_block * block_column_count + col_block`` with
      row from binY, col from binX; the block covers an axis-aligned
      ``block_bin_count`` square, so its minimum ``|x - y|`` is
      ``(|row - col| - 1) * block_bin_count + 1`` (0 when row == col).
    * v9 intra: ``number = depth * block_column_count + pad`` where
      ``depth = floor(log2(1 + |x-y| / (sqrt(2) * block_bin_count)))`` —
      blocks at depth d hold distances >= (2^d - 1) * sqrt(2) *
      block_bin_count.
    """
    bbc = zoom.block_bin_count
    bcc = max(zoom.block_column_count, 1)
    keep = []
    s = math.sqrt(2.0) * bbc
    for b in blocks:
        if version >= 9:
            depth = b.number // bcc
            min_dist = (2.0 ** depth - 1.0) * s
        else:
            r, c = divmod(b.number, bcc)
            min_dist = max(0, (abs(r - c) - 1) * bbc + 1)
        if min_dist <= distance_bins:
            keep.append(b)
    return keep


class _Reader:
    __slots__ = ("f",)

    def __init__(self, f):
        self.f = f

    def cstr(self) -> str:
        buf = bytearray()
        while True:
            b = self.f.read(1)
            if not b or b == b"\0":
                return buf.decode("utf-8", errors="replace")
            buf += b

    def i16(self):
        return struct.unpack("<h", self.f.read(2))[0]

    def i32(self):
        return struct.unpack("<i", self.f.read(4))[0]

    def i64(self):
        return struct.unpack("<q", self.f.read(8))[0]

    def f32(self):
        return struct.unpack("<f", self.f.read(4))[0]

    def f64(self):
        return struct.unpack("<d", self.f.read(8))[0]

    def u8(self):
        return struct.unpack("<b", self.f.read(1))[0]


class HicFile:
    """Random-access .hic file: header, footer index, norm vectors, blocks."""

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        try:
            r = _Reader(self.f)
            magic = self.f.read(3)
            if magic != b"HIC":
                raise ValueError(
                    f"{path}: not a .hic file (bad magic {magic!r})")
            self.f.read(1)
            self.version = r.i32()
            if not 6 <= self.version <= 9:
                raise ValueError(f"unsupported .hic version {self.version}")
        except Exception:
            self.f.close()
            raise
        try:
            self.master_index_pos = r.i64()
            self.genome = r.cstr()
            if self.version >= 9:
                self.nvi_position = r.i64()
                self.nvi_length = r.i64()
            self.attributes = {}
            for _ in range(r.i32()):
                k = r.cstr()
                self.attributes[k] = r.cstr()
            self.chromosomes: list[HicChromosome] = []
            for i in range(r.i32()):
                name = r.cstr()
                length = r.i64() if self.version >= 9 else r.i32()
                self.chromosomes.append(HicChromosome(i, name, length))
            self.resolutions = [r.i32() for _ in range(r.i32())]
        except struct.error as e:
            self.f.close()
            raise ValueError(f"{path}: truncated .hic header") from e
        self._footer = None

    # ------------------------------------------------------------------
    def chrom_by_name(self, name: str):
        want = normalize_chrom(name)
        for c in self.chromosomes:
            if normalize_chrom(c.name) == want:
                return c
        raise NameError("wrong chromosome name!")

    def _read_footer(self):
        if self._footer is not None:
            return self._footer
        self.f.seek(self.master_index_pos)
        r = _Reader(self.f)
        try:
            _n_bytes_v5 = r.i64() if self.version >= 9 else r.i32()
            entries = {}
            for _ in range(r.i32()):
                key = r.cstr()
                pos = r.i64()
                size = r.i32()
                entries[key] = (pos, size)
        except struct.error as e:
            raise IOError(
                f"{self.path}: truncated or corrupt .hic footer") from e

        def skip_expected_vectors(with_type: bool):
            n = r.i32()
            for _ in range(n):
                if with_type:
                    r.cstr()            # normalization type
                r.cstr()                # unit
                r.i32()                 # bin size
                if self.version >= 9:
                    nv = r.i64()
                    self.f.seek(4 * nv, 1)
                else:
                    nv = r.i32()
                    self.f.seek(8 * nv, 1)
                ns = r.i32()
                self.f.seek((4 + (4 if self.version >= 9 else 8)) * ns, 1)

        norm_vectors = {}
        try:
            skip_expected_vectors(with_type=False)
            skip_expected_vectors(with_type=True)
            for _ in range(r.i32()):
                typ = r.cstr()
                chr_idx = r.i32()
                unit = r.cstr()
                bin_size = r.i32()
                position = r.i64()
                n_bytes = r.i64() if self.version >= 9 else r.i32()
                norm_vectors[(typ, chr_idx, unit, bin_size)] = _NormVectorKey(
                    position, n_bytes)
        except struct.error:
            pass  # files with no normalization section
        self._footer = (entries, norm_vectors)
        return self._footer

    def norm_vector(self, norm: str, chr_idx: int, unit: str,
                    bin_size: int) -> np.ndarray | None:
        _, nvs = self._read_footer()
        key = nvs.get((norm, chr_idx, unit, bin_size))
        if key is None:
            return None
        self.f.seek(key.position)
        r = _Reader(self.f)
        if self.version >= 9:
            n = r.i64()
            return np.frombuffer(self.f.read(4 * n), dtype="<f4").astype(np.float64)
        n = r.i32()
        return np.frombuffer(self.f.read(8 * n), dtype="<f8").copy()

    def _matrix_zoom(self, chr1_idx: int, chr2_idx: int, unit: str,
                     bin_size: int) -> _ZoomData | None:
        entries, _ = self._read_footer()
        key = f"{chr1_idx}_{chr2_idx}"
        if key not in entries:
            return None
        pos, _size = entries[key]
        self.f.seek(pos)
        r = _Reader(self.f)
        r.i32()  # chr1 idx (redundant)
        r.i32()  # chr2 idx
        n_res = r.i32()
        for _ in range(n_res):
            z_unit = r.cstr()
            r.i32()          # zoom index
            r.f32()          # sum counts
            r.i32()          # occupied cell count
            r.f32()          # std dev
            r.f32()          # percent 95
            z_bin = r.i32()
            block_bin_count = r.i32()
            block_column_count = r.i32()
            blocks = []
            for _ in range(r.i32()):
                number = r.i32()
                position = r.i64()
                size = r.i32()
                blocks.append(_BlockEntry(number, position, size))
            if z_unit == unit and z_bin == bin_size:
                return _ZoomData(z_unit, z_bin, block_bin_count,
                                 block_column_count, blocks)
        return None

    def _decode_block(self, entry: _BlockEntry):
        """Decode one compressed block into (binX, binY, counts) arrays."""
        self.f.seek(entry.position)
        try:
            data = zlib.decompress(self.f.read(entry.size))
        except zlib.error as e:
            raise IOError(f"corrupt .hic block at offset {entry.position} "
                          f"(zlib: {e})") from e
        v = self.version
        off = 0

        def take(fmt, size):
            nonlocal off
            try:
                out = struct.unpack_from(fmt, data, off)[0]
            except struct.error as e:
                raise IOError("truncated .hic block record stream at offset "
                              f"{entry.position}") from e
            off += size
            return out

        n_records = take("<i", 4)
        if n_records == 0:
            return (np.array([], np.int64),) * 2 + (np.array([], np.float64),)
        if v < 7:
            arr = np.frombuffer(data, dtype="<i4,<i4,<f4", count=n_records,
                                offset=off)
            return (arr["f0"].astype(np.int64), arr["f1"].astype(np.int64),
                    arr["f2"].astype(np.float64))

        bin_x_off = take("<i", 4)
        bin_y_off = take("<i", 4)
        if v >= 9:
            use_float = take("<b", 1) != 0
            use_int_x = take("<b", 1) != 0
            use_int_y = take("<b", 1) != 0
        else:
            # v7/v8 store a single count-type byte with the same polarity as
            # v9's useFloatContact: 0 = int16 counts, nonzero = float32
            # (straw readBlock: useShort = byte == 0)
            use_float = take("<b", 1) != 0
            use_int_x = False
            use_int_y = False
        mtype = take("<b", 1)

        xfmt = "<i4" if use_int_x else "<i2"
        yfmt = "<i4" if use_int_y else "<i2"
        cfmt = "<f4" if use_float else "<i2"

        def frombuffer(dtype, count):
            nonlocal off
            try:
                out = np.frombuffer(data, dtype=dtype, count=max(count, 0),
                                    offset=off)
            except ValueError as e:
                raise IOError("truncated .hic block record stream at offset "
                              f"{entry.position}") from e
            off += out.nbytes
            return out

        if mtype == 1:      # list of rows: one frombuffer per row
            rec = np.dtype([("x", xfmt), ("c", cfmt)])
            xs, ys, vs = [], [], []
            for _ in range(int(frombuffer(yfmt, 1)[0])):
                bin_y = int(frombuffer(yfmt, 1)[0]) + bin_y_off
                cols = frombuffer(rec, int(frombuffer(xfmt, 1)[0]))
                xs.append(cols["x"].astype(np.int64) + bin_x_off)
                ys.append(np.full(len(cols), bin_y, np.int64))
                vs.append(cols["c"].astype(np.float64))
            if not xs:
                return (np.array([], np.int64),) * 2 + (
                    np.array([], np.float64),)
            return np.concatenate(xs), np.concatenate(ys), np.concatenate(vs)
        if mtype == 2:      # dense
            n_pts = take("<i", 4)
            # straw reads the dense width as int16 UNCONDITIONALLY — the
            # useIntXPos flag widens only the bin offsets, not w
            w = take("<h", 2)
            c = frombuffer(cfmt, n_pts)
            present = ~np.isnan(c) if use_float else c != -32768
            i = np.nonzero(present)[0]
            row = i // w
            col = i - row * w
            return ((bin_x_off + col).astype(np.int64),
                    (bin_y_off + row).astype(np.int64),
                    c[i].astype(np.float64))
        raise ValueError(f"unknown .hic block matrix type {mtype}")

    def _decode_blocks(self, blocks):
        """Decode a block list into concatenated (binX, binY, counts) with
        the native decoder, in block and record order."""
        if not blocks:
            return (np.array([], np.int64), np.array([], np.int64),
                    np.array([], np.float64))
        from mustache_tpu_torch.io import native

        with torch.profiler.record_function("hic.decode"):
            return native.decode_hic_blocks(
                self.path, np.array([b.position for b in blocks], np.int64),
                np.array([b.size for b in blocks], np.int32), self.version)

    def _decode_blocks_plain(self, blocks):
        """:meth:`_decode_blocks` in Python (``zlib`` and numpy): the
        native decoder's plain twin."""
        empty = (np.array([], np.int64), np.array([], np.int64),
                 np.array([], np.float64))
        xs, ys, vs = [], [], []
        for entry in blocks:
            bx, by, bv = self._decode_block(entry)
            if len(bv):
                xs.append(bx)
                ys.append(by)
                vs.append(bv)
        if not xs:
            return empty
        return np.concatenate(xs), np.concatenate(ys), np.concatenate(vs)

    def fetch_pair(self, chrom1: str, chrom2: str, resolution: int,
                   norm: str | bool = False, unit: str = "BP"):
        """All contact records of the chrom1 x chrom2 rectangle at a
        resolution, as bin-index COO triplets (x on chrom1's bins, y on
        chrom2's), optionally normalized by each chromosome's norm vector
        at its anchor. The .hic matrix key is stored under the
        lower-index chromosome first; the result is transposed back when
        the caller's order differs."""
        c1 = self.chrom_by_name(chrom1)
        c2 = self.chrom_by_name(chrom2)
        if c1.index == c2.index:
            raise ValueError("fetch_pair needs two distinct chromosomes")
        flip = c1.index > c2.index
        a, b = (c2, c1) if flip else (c1, c2)
        zoom = self._matrix_zoom(a.index, b.index, unit, resolution)
        empty = (np.array([], np.int64), np.array([], np.int64),
                 np.array([], np.float64))
        if zoom is None:
            return empty
        # binX is on the first (lower-index) chromosome's axis, binY on the
        # second's (straw's inter-chromosomal record convention)
        x, y, v = self._decode_blocks(zoom.blocks)
        if len(v) == 0:
            return empty
        if flip:
            x, y = y, x
        if norm and norm != "NONE":
            def nv_for(c, coord):
                nv = self.norm_vector(str(norm), c.index, unit, resolution)
                if nv is None:
                    raise ValueError(
                        f"normalization {norm!r} not available for {c.name} "
                        f"at {resolution}bp in {self.path}")
                pad = int(coord.max()) + 1 - len(nv)
                if pad > 0:
                    nv = np.concatenate([nv, np.full(pad, np.nan)])
                return nv
            v = v / (nv_for(c1, x)[x] * nv_for(c2, y)[y])
        return x, y, v

    def fetch_chromosome(self, chrom: str, resolution: int,
                         norm: str | bool = False, unit: str = "BP",
                         distance_bins: float | None = None):
        """All contact records of chrom x chrom at a resolution, as bin-index
        COO triplets (x <= y), optionally normalized. ``distance_bins``
        restricts decoding to blocks that can intersect the diagonal band
        ``|x - y| <= distance_bins`` (records beyond it may still appear —
        the caller's distance filter stays authoritative)."""
        c = self.chrom_by_name(chrom)
        x, y, v = self._chromosome_records(c, resolution, unit,
                                           distance_bins)
        if len(v) == 0:
            return x, y, v
        with torch.profiler.record_function("hic.assemble"):
            return self._assemble(chrom, c, x, y, v, resolution, norm, unit)

    def _chromosome_records(self, c: HicChromosome, resolution: int,
                            unit: str, distance_bins: float | None):
        """The decoded records of c x c as stored (x, y unordered), from
        the blocks that can meet the band when ``distance_bins`` is set."""
        zoom = self._matrix_zoom(c.index, c.index, unit, resolution)
        if zoom is None:
            return (np.array([], np.int64), np.array([], np.int64),
                    np.array([], np.float64))
        blocks = zoom.blocks
        if distance_bins is not None:
            blocks = cull_band_blocks(blocks, zoom, self.version,
                                      distance_bins)
        return self._decode_blocks(blocks)

    def _assemble(self, chrom: str, c: HicChromosome, x, y, v,
                  resolution: int, norm, unit: str):
        """Decoded records of ``chrom`` as ``x <= y`` triplets, divided by
        the ``norm`` vector at both anchors unless ``norm`` is false or
        ``"NONE"``."""
        x, y = np.minimum(x, y), np.maximum(x, y)
        if norm and norm != "NONE":
            nv = self.norm_vector(str(norm), c.index, unit, resolution)
            if nv is None:
                raise ValueError(
                    f"normalization {norm!r} not available for {chrom} at "
                    f"{resolution}bp in {self.path}")
            pad = max(int(x.max()), int(y.max())) + 1 - len(nv)
            if pad > 0:
                nv = np.concatenate([nv, np.full(pad, np.nan)])
            v = v / (nv[x] * nv[y])
        return x, y, v

    def close(self):
        self.f.close()


def read_hic_file(path: str, norm_method, chrm_size, distance_bp: int,
                  chr1: str, chr2: str, res: int):
    """Reference-shaped entry point (mustache.py:300-396): band-filtered,
    normalized COO triplets for one chromosome; default norm "KR".
    For chr1 != chr2 the full rectangle is returned (the reference
    advertises but cannot serve this, mustache.py:689-694)."""
    hic = HicFile(path)
    try:
        norm = norm_method if norm_method else "KR"
        if chr1 != chr2:
            x, y, v = hic.fetch_pair(chr1, chr2, res, norm=norm)
            v[np.isnan(v)] = 0
            keep = v > 0
            return x[keep], y[keep], v[keep]
        c = hic.chrom_by_name(chr1)
        x, y, v = hic._chromosome_records(c, res, "BP", distance_bp / res)
        if len(v) == 0:
            print(f"There is no contact in chrmosome {chr1} to work on.")
            return [], [], []
        with torch.profiler.record_function("hic.assemble"):
            x, y, v = hic._assemble(chr1, c, x, y, v, res, norm, "BP")
            # the reference zeroes only NaN here (mustache.py:384); +/-inf
            # values (e.g. from a zero normalization factor) survive to
            # the val>0 filter
            v[np.isnan(v)] = 0
            keep = (np.abs(x - y) <= distance_bp / res) & (v > 0)
            x, y, v = x[keep], y[keep], v[keep]
    finally:
        # close on error paths too: the CLI's ingest retries reopen the
        # file per attempt, so a leak per raise accumulates descriptors
        hic.close()
    if len(v) == 0:
        print(f"There is no contact in chrmosome {chr1} to work on.")
        return [], [], []
    return x, y, v
