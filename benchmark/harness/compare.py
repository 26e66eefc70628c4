"""The comparison that decides ``correct``: the program's loop rows
against the plain reference's.

A row is ``(key, q, scale)``: its position (a tuple of the bins, and
where the cell has them the chromosome or the differential tag), its
q-value and its scale. A cell compares the numbers its file gives a limit
for (``limits`` in ``benchmark/workloads/<cell>.json``), of these two:

* ``rows_off_share``: the rows that are not the same on both sides, as a
  share of the reference's rows: rows on one side only or listed twice,
  rows at one position with another scale (scales are ladder sigmas some
  7 % apart, so a relative 1e-5 tells float32 rounding from another
  sigma), and rows whose q lie further apart than ``Q_OFF`` in ``ln q``
  (1 %);
* ``q_gap_ln``: over the rows both sides have at one scale, the largest
  ``|ln q_program - ln q_reference|``.

``rows_off`` and ``rows_unmatched`` (the rows on one side only, listed
twice or at another scale) are reported beside them.
"""

from __future__ import annotations

import math
from collections import Counter

SCALE_RTOL = 1e-5
Q_FLOOR = 1e-300
Q_OFF = 0.01


def compare(got, ref) -> dict:
    """The compared numbers of the rows ``got`` against ``ref``, each a
    list of ``(key, q, scale)``."""
    g, r = got, ref
    dup = sum(c - 1 for c in Counter(k for k, _, _ in g).values()) + sum(
        c - 1 for c in Counter(k for k, _, _ in r).values())
    gd = {k: (q, s) for k, q, s in g}
    rd = {k: (q, s) for k, q, s in r}
    unmatched = len(set(gd) ^ set(rd)) + dup
    gap, off = 0.0, 0
    for k in set(gd) & set(rd):
        (qg, sg), (qr, sr) = gd[k], rd[k]
        if abs(sg - sr) > SCALE_RTOL * abs(sr):
            unmatched += 1
            continue
        d = abs(math.log(max(qg, Q_FLOOR)) - math.log(max(qr, Q_FLOOR)))
        gap = max(gap, d)
        off += d > Q_OFF
    return {"rows_off_share": (unmatched + off) / max(len(ref), 1),
            "q_gap_ln": gap, "rows_off": unmatched + off,
            "rows_unmatched": unmatched, "rows_reference": len(ref),
            "rows_program": len(got)}
