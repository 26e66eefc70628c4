"""Plain-text contact loader, without pandas.

Torch port of ``mustache_tpu/io/text.py`` (the card machine has no
pandas). Accepts the two reference text layouts (mustache.py:254-297):

* 5-column ``chrom1 mid1 chrom2 mid2 count``
* 3-column ``mid1 mid2 count``

and returns upper-triangular COO triplets ``(x, y, v)`` in bin units with
the band filter ``|mid1 - mid2| <= (distance_bp/res + 1) * res`` applied on
the original bp coordinates (reference line :264) and counts divided by the
bias factor at both anchors.

:func:`read_table` stands in for ``pandas.read_csv(header=None).dropna()``:
numpy's C ``loadtxt`` parses chunks of lines, and a chunk it refuses
(ragged rows, missing fields, NA tokens) is parsed line by line with
pandas' rules for those. One deliberate difference: numbers parse
correctly rounded, as Python's ``float`` does, where pandas' default
parser can land a few ulps off for 16-17 significant digits. So a value
written with ``repr`` reads back exactly here.
"""

from __future__ import annotations

import itertools

import numpy as np

from mustache_tpu_torch.io.chrom import normalize_chrom

CHUNK_LINES = 1 << 20
STR_WIDTH = 64          # bytes kept of a string field; longer ones raise
# pandas.read_csv's default missing-value tokens
NA_TOKENS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
# NA tokens are at most 8 bytes: their first word, NUL-padded
_NA_WORDS = np.array([t.encode() for t in NA_TOKENS], dtype="S8").view("<u8")


def sniff_separator(path: str) -> str:
    """Guess the column separator from the first line (mustache.py:199-215)."""
    with open(path) as fh:
        for line in fh:
            if "\t" in line:
                return "\t"
            if " " in line.strip():
                return " "
            if "," in line:
                return ","
            if len(line.split(" ")) == 1:
                return " "
            break
    raise FileNotFoundError(path)


def count_columns(path: str, sep: str) -> int:
    """Fields in the first non-blank line (pandas' column count)."""
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\r\n")
            if line:
                return len(line.split(sep))
    return 0


def _dtype(ncols: int, str_cols) -> np.dtype:
    return np.dtype([(f"f{i}", f"S{STR_WIDTH}" if i in str_cols else "f8")
                     for i in range(ncols)])


def _parse_slow(lines, sep: str, dt: np.dtype) -> np.ndarray:
    """One chunk line by line: a short row is padded with missing fields,
    a long one raises, and a row with a missing field or NA token is
    dropped."""
    ncols = len(dt.names)
    rows = []
    for line in lines:
        line = line.rstrip("\r\n")
        if not line:
            continue
        parts = line.split(sep)
        if len(parts) > ncols:
            raise ValueError(f"expected {ncols} fields, saw {len(parts)}: "
                             f"{line!r}")
        parts += [""] * (ncols - len(parts))
        if any(p in NA_TOKENS for p in parts):
            continue
        rows.append(tuple(
            p.encode() if dt[i].kind == "S" else float(p)
            for i, p in enumerate(parts)))
    return np.array(rows, dtype=dt)


def _words(arr: np.ndarray, name: str) -> np.ndarray:
    """A string field of a structured array as [n, STR_WIDTH // 8] uint64
    words (a view; fields are NUL-padded)."""
    off = arr.dtype.fields[name][1]
    view = np.dtype({"names": ["w"], "formats": [("<u8", STR_WIDTH // 8)],
                     "offsets": [off], "itemsize": arr.dtype.itemsize})
    return arr.view(view)["w"]


def _parse_chunk(lines, sep: str, dt: np.dtype) -> np.ndarray:
    try:
        arr = np.loadtxt(lines, delimiter=sep, dtype=dt, ndmin=1,
                         comments=None, quotechar=None)
    except ValueError:
        return _parse_slow(lines, sep, dt)
    keep = np.ones(len(arr), bool)
    for name in dt.names:
        if dt[name].kind == "S":
            w = _words(arr, name)
            if np.any(w[:, -1] >> np.uint64(56)):   # last byte used
                raise ValueError(f"a text field of {STR_WIDTH}+ bytes")
            # a field of at most 8 bytes has a zero second word
            keep &= ~((w[:, 1] == 0) & np.isin(w[:, 0], _NA_WORDS))
        else:
            keep &= ~np.isnan(arr[name])
    return arr if keep.all() else arr[keep]


def read_table(path: str, sep: str, ncols: int, str_cols=(), *,
               row_filter=None, out_cols=None) -> list[np.ndarray]:
    """Columns of a headerless delimited file, as
    ``pandas.read_csv(path, sep=sep, header=None).dropna()`` would give
    them: ``str_cols`` as bytes (``S64``), the others as float64.
    ``row_filter(chunk) -> bool mask`` drops rows chunk by chunk (so a
    genome-wide file is never held whole); ``out_cols`` picks the columns
    returned (default all)."""
    dt = _dtype(ncols, set(str_cols))
    out_cols = list(range(ncols)) if out_cols is None else list(out_cols)
    parts = {c: [] for c in out_cols}
    with open(path) as fh:
        while True:
            lines = list(itertools.islice(fh, CHUNK_LINES))
            if not lines:
                break
            arr = _parse_chunk(lines, sep, dt)
            if row_filter is not None and len(arr):
                arr = arr[row_filter(arr)]
            for c in out_cols:
                parts[c].append(arr[f"f{c}"])
    return [np.concatenate(parts[c]) if parts[c]
            else np.zeros(0, dt[f"f{c}"]) for c in out_cols]


def chrom_mask(col: np.ndarray, chromosome, memo: dict) -> np.ndarray:
    """Rows whose name equals ``chromosome`` once ``chr`` is stripped from
    both (the JAX reader's ``str.replace("chr", "")``); one comparison
    pass per distinct name, decisions kept in ``memo`` across chunks."""
    want = normalize_chrom(chromosome)
    mask = np.zeros(len(col), bool)
    rest = np.ones(len(col), bool)
    while rest.any():
        name = col[int(np.argmax(rest))]
        same = col == name
        if name not in memo:
            memo[name] = normalize_chrom(
                name.decode("utf-8", errors="replace")) == want
        if memo[name]:
            mask |= same
        rest &= ~same
    return mask


def read_text_contacts(path: str, distance_bp: int, bias, chromosome, res: int):
    """Load COO triplets for one chromosome from a text contact list.

    ``bias`` is a :class:`mustache_tpu_torch.io.bias.BiasVector` or
    ``False``. Returns ``(x, y, v)`` int64/int64/float64 arrays, possibly
    empty.
    """
    empty = (np.array([], np.int64), np.array([], np.int64), np.array([], np.float64))
    sep = sniff_separator(path)
    ncols = count_columns(path, sep)
    if ncols == 5:
        memo: dict = {}

        def on_chrom(a):
            return (chrom_mask(a["f0"], chromosome, memo)
                    & chrom_mask(a["f2"], chromosome, memo))

        m1, m2, count = read_table(path, sep, 5, (0, 2), row_filter=on_chrom,
                                   out_cols=(1, 3, 4))
        if len(count) == 0:
            return empty
    elif ncols == 3:
        m1, m2, count = read_table(path, sep, 3)
    else:
        raise ValueError(f"unsupported column count {ncols} in {path}")

    keep = np.abs(m1 - m2) <= (distance_bp / res + 1) * res
    m1, m2, v = m1[keep], m2[keep], count[keep]

    b1 = np.floor_divide(m1, res)
    b2 = np.floor_divide(m2, res)
    if bias:
        v = v / bias.lookup(b1)
        v = v / bias.lookup(b2)

    pos = v > 0
    b1, b2, v = b1[pos], b2[pos], v[pos]
    x = np.minimum(b1, b2).astype(np.int64)
    y = np.maximum(b1, b2).astype(np.int64)
    return x, y, np.asarray(v, dtype=np.float64)
