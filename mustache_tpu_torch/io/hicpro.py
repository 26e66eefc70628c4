"""HiC-Pro ``.matrix`` + ``.bed`` loader, without pandas.

Torch port of ``mustache_tpu/io/hicpro.py`` (its ``pd.read_csv`` calls,
:22,:37,:56, become the port's :func:`~mustache_tpu_torch.io.text.read_table`).
The reference CLI advertises ``-bed``/``-m`` (mustache.py:76-89) but
never uses the bed; here it is honored:

* bed: ``chrom  start  end  bin_id`` (HiC-Pro's genome-wide, sequential,
  resolution-spaced fragments)
* matrix: ``bin_id1  bin_id2  count`` (upper-triangular sparse)

Bin ids on the requested chromosome are mapped to in-chromosome bin
indices ``start // res``; the distance filter, bias division at both
anchors, positivity filter, and upper-triangular orientation then follow
the text-path semantics exactly (mustache.py:264-277).
"""

from __future__ import annotations

import numpy as np

from mustache_tpu_torch.io.text import (
    chrom_mask, count_columns, read_table, sniff_separator,
)


def read_hicpro(matrix_path: str, bed_path: str, distance_bp: int, bias,
                chromosome, res: int):
    """COO triplets ``(x, y, v)`` for one chromosome from HiC-Pro output."""
    empty = (np.array([], np.int64), np.array([], np.int64),
             np.array([], np.float64))

    sep = sniff_separator(bed_path)
    ncols = count_columns(bed_path, sep)
    if ncols < 4:
        raise ValueError(
            f"HiC-Pro bed needs 4 columns (chrom start end id), "
            f"got {ncols} in {bed_path}")
    # only start (1) and id (3) are numbers the reader needs; the other
    # columns take part in the missing-field drop only
    names, start_col, id_col = read_table(
        bed_path, sep, ncols, [c for c in range(ncols) if c not in (1, 3)],
        out_cols=(0, 1, 3))
    on_chrom = chrom_mask(names, chromosome, {})
    if not on_chrom.any():
        return empty
    ids = id_col.astype(np.int64)[on_chrom]
    starts = start_col.astype(np.int64)[on_chrom]
    bed_rows = np.nonzero(on_chrom)[0]   # file line number per kept id
    # bin id -> in-chromosome bin index (dense lookup over the id range)
    id_lo, id_hi = int(ids.min()), int(ids.max())
    id_to_bin = np.full(id_hi - id_lo + 1, -1, np.int64)
    id_to_bin[ids - id_lo] = starts // res
    # bin id -> bed file line: the key space of 1-column (HiC-Pro ICE)
    # bias files, whose factors are one line per genome-wide bed row
    id_to_row = np.full(id_hi - id_lo + 1, -1, np.int64)
    id_to_row[ids - id_lo] = bed_rows

    sep = sniff_separator(matrix_path)
    ncols = count_columns(matrix_path, sep)
    if ncols != 3:
        raise ValueError(
            f"HiC-Pro matrix needs 3 columns (id1 id2 count), "
            f"got {ncols} in {matrix_path}")
    i1, i2, v = read_table(matrix_path, sep, 3)
    i1 = i1.astype(np.int64)
    i2 = i2.astype(np.int64)

    keep = (i1 >= id_lo) & (i1 <= id_hi) & (i2 >= id_lo) & (i2 <= id_hi)
    i1, i2, v = i1[keep], i2[keep], v[keep]
    b1 = id_to_bin[i1 - id_lo]
    b2 = id_to_bin[i2 - id_lo]
    keep = (b1 >= 0) & (b2 >= 0)
    i1, i2 = i1[keep], i2[keep]
    b1, b2, v = b1[keep], b2[keep], v[keep]

    # same band filter as the text path (on bp distance, mustache.py:264)
    keep = np.abs(b1 - b2) * res <= (distance_bp / res + 1) * res
    i1, i2 = i1[keep], i2[keep]
    b1, b2, v = b1[keep], b2[keep], v[keep]

    if bias:
        if getattr(bias, "by_line", False):
            # 1-column bias: factors are keyed by genome-wide bed line
            k1 = id_to_row[i1 - id_lo]
            k2 = id_to_row[i2 - id_lo]
        else:
            # 3-column bias: keyed by chromosome-local bin (midpoint//res)
            k1, k2 = b1, b2
        v = v / bias.lookup(k1)
        v = v / bias.lookup(k2)

    pos = v > 0
    b1, b2, v = b1[pos], b2[pos], v[pos]
    x = np.minimum(b1, b2).astype(np.int64)
    y = np.maximum(b1, b2).astype(np.int64)
    return x, y, np.asarray(v, np.float64)
