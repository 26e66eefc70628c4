"""A version-8 ``.hic`` writer for the CLI cell's input, in numpy.

The byte layout is that of ``tests/hic_writer.py`` (frozen in
``benchmark/tests/frozen_hic_writer.py``) for a single resolution,
intra-chromosomal matrices, float32 counts, row-list blocks of 512 bins
and norm vectors: the same bytes, which a CPU test holds it to. That
writer packs one struct per pixel, which takes tens of seconds for a
chromosome at 5 kb; this one packs a block's records at once.
"""

from __future__ import annotations

import struct
import zlib
from io import BytesIO

import numpy as np

BLOCK_BINS = 512
RECORD = np.dtype([("x", "<i2"), ("v", "<f4")])


def _cstr(s: str) -> bytes:
    return s.encode() + b"\0"


def pack_block(x: np.ndarray, y: np.ndarray, v: np.ndarray) -> bytes:
    """One row-list block: count, bin offsets, float counts, rows of
    ``y`` ascending, each with its records of ``x`` ascending."""
    order = np.lexsort((x, y))
    x, y, v = x[order], y[order], v[order]
    x_off, y_off = int(x.min()), int(y.min())
    rows, first, counts = np.unique(y, return_index=True, return_counts=True)
    rec = np.empty(len(v), RECORD)
    rec["x"] = x - x_off
    rec["v"] = v
    raw = rec.tobytes()
    out = [struct.pack("<i", len(v)), struct.pack("<ii", x_off, y_off),
           struct.pack("<bb", 1, 1), struct.pack("<h", len(rows))]
    size = RECORD.itemsize
    for yi, i0, cnt in zip(rows.tolist(), first.tolist(), counts.tolist()):
        out.append(struct.pack("<hh", yi - y_off, cnt))
        out.append(raw[i0 * size:(i0 + cnt) * size])
    return zlib.compress(b"".join(out))


def write_hic(path: str, chroms, res: int, pixels: dict, norms: dict):
    """Write ``path``: ``chroms`` ``[(name, length_bp)]``, ``pixels``
    ``{name: (x, y, v)}`` bin triplets, ``norms`` ``{(norm, name):
    factors}``."""
    chrom_table = [("All", sum(c[1] for c in chroms))] + list(chroms)
    names = [n for n, _ in chrom_table]
    body = BytesIO()
    body.write(b"HIC\0")
    body.write(struct.pack("<i", 8))
    master_pos_at = body.tell()
    body.write(struct.pack("<q", 0))
    body.write(_cstr("testgenome"))
    attrs = {"software": "mustache-tpu test writer"}
    body.write(struct.pack("<i", len(attrs)))
    for k, vv in attrs.items():
        body.write(_cstr(k))
        body.write(_cstr(vv))
    body.write(struct.pack("<i", len(chrom_table)))
    for name, length in chrom_table:
        body.write(_cstr(name))
        body.write(struct.pack("<i", length))
    body.write(struct.pack("<i", 1))
    body.write(struct.pack("<i", res))

    entries = {}
    for key, (x, y, v) in pixels.items():
        ci = names.index(key)
        x, y, v = np.asarray(x), np.asarray(y), np.asarray(v)
        n_cols = int(np.ceil((chrom_table[ci][1] / res) / BLOCK_BINS))
        number = (y // BLOCK_BINS) * n_cols + (x // BLOCK_BINS)
        order = np.argsort(number, kind="stable")
        nums, first = np.unique(number[order], return_index=True)
        bounds = list(first) + [len(order)]
        block_recs = []
        for b, num in enumerate(nums.tolist()):
            sel = order[bounds[b]:bounds[b + 1]]
            block_recs.append((num, pack_block(x[sel], y[sel], v[sel])))
        start = body.tell()
        mat = BytesIO()
        mat.write(struct.pack("<iii", ci, ci, 1))
        mat.write(_cstr("BP"))
        mat.write(struct.pack("<i", 0))
        mat.write(struct.pack("<f", float(np.sum(v))))
        mat.write(struct.pack("<i", len(v)))
        mat.write(struct.pack("<ff", 0.0, 0.0))
        mat.write(struct.pack("<i", res))
        mat.write(struct.pack("<i", BLOCK_BINS))
        mat.write(struct.pack("<i", n_cols))
        mat.write(struct.pack("<i", len(block_recs)))
        index_at = mat.tell()
        for num, payload in block_recs:
            mat.write(struct.pack("<iqi", num, 0, len(payload)))
        positions = []
        for num, payload in block_recs:
            positions.append(start + mat.tell())
            mat.write(payload)
        raw = bytearray(mat.getvalue())
        for bi, (num, payload) in enumerate(block_recs):
            struct.pack_into("<iqi", raw, index_at + bi * 16, num,
                             positions[bi], len(payload))
        body.write(bytes(raw))
        entries[f"{ci}_{ci}"] = (start, len(raw))

    norm_entries = []
    for (norm_name, chrom_name), factors in norms.items():
        ci = names.index(chrom_name)
        pos = body.tell()
        factors = np.asarray(factors, np.float64)
        body.write(struct.pack("<i", len(factors)))
        body.write(factors.astype("<f8").tobytes())
        norm_entries.append((norm_name, ci, res, pos, 4 + 8 * len(factors)))

    master_pos = body.tell()
    foot = BytesIO()
    foot.write(struct.pack("<i", len(entries)))
    for key, (pos, size) in entries.items():
        foot.write(_cstr(key))
        foot.write(struct.pack("<qi", pos, size))
    foot.write(struct.pack("<i", 0))
    foot.write(struct.pack("<i", 0))
    foot.write(struct.pack("<i", len(norm_entries)))
    for norm_name, ci, bin_size, pos, nbytes in norm_entries:
        foot.write(_cstr(norm_name))
        foot.write(struct.pack("<i", ci))
        foot.write(_cstr("BP"))
        foot.write(struct.pack("<i", bin_size))
        foot.write(struct.pack("<q", pos))
        foot.write(struct.pack("<i", nbytes))
    footer = foot.getvalue()
    body.write(struct.pack("<i", len(footer)))
    body.write(footer)
    raw = bytearray(body.getvalue())
    struct.pack_into("<q", raw, master_pos_at, master_pos)
    with open(path, "wb") as fh:
        fh.write(bytes(raw))
