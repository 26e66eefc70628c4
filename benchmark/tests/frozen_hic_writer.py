# Frozen copy of tests/hic_writer.py: the benchmark's CPU tests hold its own code to it. Do not edit.
"""Minimal Juicer .hic writer (format v8 and v9) — TEST-ONLY.

Generates structurally-valid .hic files so the native reader can be
round-trip tested without network access to real data. Follows the same
public format layout the reader implements (straw/hic2cool documentation);
intentionally writes through an independent code path (explicit struct
packs here vs. streamed unpacks in the reader).
"""

from __future__ import annotations

import math
import struct
import zlib
from io import BytesIO

import numpy as np


def _cstr(s: str) -> bytes:
    return s.encode() + b"\0"


def _pack_block_v6(x, y, v) -> bytes:
    """v6 block: record count then packed (int32 x, int32 y, float32 c)."""
    out = BytesIO()
    out.write(struct.pack("<i", len(v)))
    for xi, yi, vi in zip(x, y, v):
        out.write(struct.pack("<iif", int(xi), int(yi), float(vi)))
    return zlib.compress(out.getvalue())


def _pack_block_v8(x, y, v, use_short_counts: bool) -> bytes:
    """Row-list (type 1) block, int16 bins, int16/float32 counts."""
    out = BytesIO()
    out.write(struct.pack("<i", len(v)))
    bin_x_off = int(x.min()) if len(x) else 0
    bin_y_off = int(y.min()) if len(y) else 0
    out.write(struct.pack("<ii", bin_x_off, bin_y_off))
    # count-type byte, straw polarity: 0 = int16 counts, 1 = float32
    out.write(struct.pack("<b", 0 if use_short_counts else 1))
    out.write(struct.pack("<b", 1))                             # type: rows
    rows = {}
    for xi, yi, vi in zip(x, y, v):
        rows.setdefault(int(yi), []).append((int(xi), vi))
    out.write(struct.pack("<h", len(rows)))
    for yi in sorted(rows):
        out.write(struct.pack("<h", yi - bin_y_off))
        out.write(struct.pack("<h", len(rows[yi])))
        for xi, vi in sorted(rows[yi]):
            out.write(struct.pack("<h", xi - bin_x_off))
            if use_short_counts:
                out.write(struct.pack("<h", int(vi)))
            else:
                out.write(struct.pack("<f", float(vi)))
    return zlib.compress(out.getvalue())


def _pack_block_v9_dense(x, y, v, int_bins: bool,
                         float_counts: bool) -> bytes:
    """Dense (type 2) block: row-major w x h grid with missing-value
    sentinels. Per straw, the width is int16 REGARDLESS of useIntXPos
    (the flag widens only the bin offsets)."""
    out = BytesIO()
    out.write(struct.pack("<i", len(v)))
    bx, by = int(x.min()), int(y.min())
    out.write(struct.pack("<ii", bx, by))
    out.write(struct.pack("<b", 1 if float_counts else 0))  # useFloatContact
    out.write(struct.pack("<b", 1 if int_bins else 0))      # useIntXPos
    out.write(struct.pack("<b", 1 if int_bins else 0))      # useIntYPos
    out.write(struct.pack("<b", 2))                         # type: dense
    w = int(x.max()) - bx + 1
    h = int(y.max()) - by + 1
    grid = {(int(yi) - by, int(xi) - bx): vi
            for xi, yi, vi in zip(x, y, v)}
    out.write(struct.pack("<i", w * h))
    out.write(struct.pack("<h", w))
    for i in range(w * h):
        r, c = divmod(i, w)
        vi = grid.get((r, c))
        if float_counts:
            out.write(struct.pack("<f",
                                  float("nan") if vi is None else float(vi)))
        else:
            out.write(struct.pack("<h",
                                  -32768 if vi is None else int(vi)))
    return zlib.compress(out.getvalue())


def _pack_block_v9(x, y, v, int_bins: bool, float_counts: bool) -> bytes:
    out = BytesIO()
    out.write(struct.pack("<i", len(v)))
    bin_x_off = int(x.min()) if len(x) else 0
    bin_y_off = int(y.min()) if len(y) else 0
    out.write(struct.pack("<ii", bin_x_off, bin_y_off))
    out.write(struct.pack("<b", 1 if float_counts else 0))  # useFloatContact
    out.write(struct.pack("<b", 1 if int_bins else 0))      # useIntXPos
    out.write(struct.pack("<b", 1 if int_bins else 0))      # useIntYPos
    out.write(struct.pack("<b", 1))                         # type: rows
    bfmt = "<i" if int_bins else "<h"
    rows = {}
    for xi, yi, vi in zip(x, y, v):
        rows.setdefault(int(yi), []).append((int(xi), vi))
    out.write(struct.pack(bfmt, len(rows)))
    for yi in sorted(rows):
        out.write(struct.pack(bfmt, yi - bin_y_off))
        out.write(struct.pack(bfmt, len(rows[yi])))
        for xi, vi in sorted(rows[yi]):
            out.write(struct.pack(bfmt, xi - bin_x_off))
            if float_counts:
                out.write(struct.pack("<f", float(vi)))
            else:
                out.write(struct.pack("<h", int(vi)))
    return zlib.compress(out.getvalue())


def write_hic(path: str, chroms, res: int, pixels: dict, version: int = 8,
              norms: dict | None = None, use_short_counts: bool = False,
              block_bins: int = 512, dense_blocks: bool = False):
    """Write a single-resolution .hic file.

    chroms: [(name, length_bp)] (an "All" pseudo-chromosome is prepended, as
    real files have). pixels: {chrom_name: (x, y, counts)} bin triplets.
    norms: {(norm_name, chrom_name): factor_array}.
    """
    norms = norms or {}
    chrom_table = [("All", sum(c[1] for c in chroms))] + list(chroms)

    body = BytesIO()

    def write_header():
        body.write(b"HIC\0")
        body.write(struct.pack("<i", version))
        master_pos_at = body.tell()
        body.write(struct.pack("<q", 0))         # patched later
        body.write(_cstr("testgenome"))
        if version >= 9:
            body.write(struct.pack("<qq", 0, 0))  # nvi position/length
        attrs = {"software": "mustache-tpu test writer"}
        body.write(struct.pack("<i", len(attrs)))
        for k, vv in attrs.items():
            body.write(_cstr(k))
            body.write(_cstr(vv))
        body.write(struct.pack("<i", len(chrom_table)))
        for name, length in chrom_table:
            body.write(_cstr(name))
            if version >= 9:
                body.write(struct.pack("<q", length))
            else:
                body.write(struct.pack("<i", length))
        body.write(struct.pack("<i", 1))
        body.write(struct.pack("<i", res))
        return master_pos_at

    master_pos_at = write_header()

    # matrix bodies; pixel keys are a chromosome name (intra) or a
    # (name1, name2) pair (inter rectangle, x on name1's bins, y on name2's;
    # stored under the lower-index chromosome first as real files do)
    names = [n for n, _ in chrom_table]

    def key_indices(key):
        if isinstance(key, tuple):
            i1, i2 = names.index(key[0]), names.index(key[1])
            assert i1 < i2, "write inter pairs in chromosome-table order"
            return i1, i2
        ci = names.index(key)
        return ci, ci

    entries = {}
    for key in pixels:
        ci, cj = key_indices(key)
        length = chrom_table[ci][1]
        x, y, v = (np.asarray(a) for a in pixels[key])
        n_cols = int(np.ceil((length / res) / block_bins))
        # split into blocks; the block NUMBER encodes position per straw's
        # conventions — v<9: row_block * n_cols + col_block (row from binY);
        # v9 intra: depth * n_cols + pad with the diagonal depth/PAD scheme
        blocks = {}
        s9 = math.sqrt(2.0) * block_bins
        for xi, yi, vi in zip(x, y, v):
            if version >= 9 and ci == cj:
                depth = int(math.log2(1 + abs(int(yi) - int(xi)) / s9))
                pad = (int(xi) + int(yi)) // 2 // block_bins
                number = depth * n_cols + pad
            else:
                # straw's inter (and v<9 intra) scheme: row from binY
                number = (int(yi) // block_bins) * n_cols \
                    + (int(xi) // block_bins)
            blocks.setdefault(number, [[], [], []])
            blocks[number][0].append(xi)
            blocks[number][1].append(yi)
            blocks[number][2].append(vi)
        block_recs = []
        for number, (xs, ys, vs) in sorted(blocks.items()):
            xs = np.asarray(xs); ys = np.asarray(ys); vs = np.asarray(vs)
            if version >= 9 and dense_blocks:
                payload = _pack_block_v9_dense(
                    xs, ys, vs, int_bins=(max(xs.max(), ys.max()) > 30000),
                    float_counts=not use_short_counts)
            elif version >= 9:
                payload = _pack_block_v9(
                    xs, ys, vs, int_bins=(max(xs.max(), ys.max()) > 30000),
                    float_counts=not use_short_counts)
            elif version == 6:
                payload = _pack_block_v6(xs, ys, vs)
            else:
                payload = _pack_block_v8(xs, ys, vs, use_short_counts)
            block_recs.append((number, payload))
        start = body.tell()
        mat = BytesIO()
        mat.write(struct.pack("<iii", ci, cj, 1))
        mat.write(_cstr("BP"))
        mat.write(struct.pack("<i", 0))      # zoom index
        mat.write(struct.pack("<f", float(np.sum(v))))
        mat.write(struct.pack("<i", len(v)))  # occupied cells
        mat.write(struct.pack("<ff", 0.0, 0.0))  # stddev, percent95
        mat.write(struct.pack("<i", res))
        mat.write(struct.pack("<i", block_bins))
        mat.write(struct.pack("<i", n_cols))
        mat.write(struct.pack("<i", len(block_recs)))
        index_at = mat.tell()
        for number, payload in block_recs:
            mat.write(struct.pack("<iqi", number, 0, len(payload)))
        payload_positions = []
        for number, payload in block_recs:
            payload_positions.append(start + mat.tell())
            mat.write(payload)
        raw = bytearray(mat.getvalue())
        for bi, (number, payload) in enumerate(block_recs):
            struct.pack_into("<iqi", raw, index_at + bi * 16, number,
                             payload_positions[bi], len(payload))
        body.write(bytes(raw))
        entries[f"{ci}_{cj}"] = (start, len(raw))

    # norm vector payloads
    norm_entries = []
    for (norm_name, chrom_name), factors in norms.items():
        ci = [i for i, (n, _) in enumerate(chrom_table) if n == chrom_name][0]
        pos = body.tell()
        factors = np.asarray(factors, np.float64)
        if version >= 9:
            body.write(struct.pack("<q", len(factors)))
            body.write(factors.astype("<f4").tobytes())
            nbytes = 8 + 4 * len(factors)
        else:
            body.write(struct.pack("<i", len(factors)))
            body.write(factors.astype("<f8").tobytes())
            nbytes = 4 + 8 * len(factors)
        norm_entries.append((norm_name, ci, res, pos, nbytes))

    # footer
    master_pos = body.tell()
    foot = BytesIO()
    foot.write(struct.pack("<i", len(entries)))
    for key, (pos, size) in entries.items():
        foot.write(_cstr(key))
        foot.write(struct.pack("<qi", pos, size))
    foot.write(struct.pack("<i", 0))     # expected value vectors
    foot.write(struct.pack("<i", 0))     # normalized expected value vectors
    foot.write(struct.pack("<i", len(norm_entries)))
    for norm_name, ci, bin_size, pos, nbytes in norm_entries:
        foot.write(_cstr(norm_name))
        foot.write(struct.pack("<i", ci))
        foot.write(_cstr("BP"))
        foot.write(struct.pack("<i", bin_size))
        foot.write(struct.pack("<q", pos))
        if version >= 9:
            foot.write(struct.pack("<q", nbytes))
        else:
            foot.write(struct.pack("<i", nbytes))
    footer_bytes = foot.getvalue()
    if version >= 9:
        body.write(struct.pack("<q", len(footer_bytes)))
    else:
        body.write(struct.pack("<i", len(footer_bytes)))
    body.write(footer_bytes)

    raw = bytearray(body.getvalue())
    struct.pack_into("<q", raw, master_pos_at, master_pos)
    with open(path, "wb") as fh:
        fh.write(bytes(raw))
