"""KR/ICE bias-vector reader.

Copied from ``mustache_tpu/io/bias.py:1-81``, on the port's text helpers.

Semantics match the reference (mustache.py:218-251): a bias factor that is
NaN or < 0.2 maps to +inf so the subsequent count/bias division zeroes the
bin out entirely; missing bins default to 1.0. Two formats are supported:

* 3-column ``(chrom, midpoint_bp, factor)`` — keyed by ``midpoint // res``
* 1-column ``(factor)`` — keyed by line number
"""

from __future__ import annotations

import numpy as np

from mustache_tpu_torch.io.chrom import chrom_matches
from mustache_tpu_torch.io.text import sniff_separator


class BiasVector:
    """Bin-index -> bias factor mapping with a default of 1.0.

    ``by_line`` records that the source file was the 1-column format,
    whose keys are FILE LINE NUMBERS (genome-wide row order), not
    chromosome-local bin indices — callers that know the row layout
    (e.g. the HiC-Pro reader, which has the bed) must remap."""

    def __init__(self, factors: dict[float, float], by_line: bool = False):
        self._factors = factors
        self.by_line = by_line

    def __bool__(self) -> bool:
        return True

    def get(self, key, default: float = 1.0) -> float:
        return self._factors.get(float(key), default)

    def lookup(self, bins: np.ndarray) -> np.ndarray:
        """Vectorized lookup of factors for an array of bin indices."""
        bins = np.asarray(bins)
        if bins.size == 0:
            return np.ones(0, dtype=np.float64)
        idx = bins.astype(np.int64)
        dense = self.as_array(int(idx.max()) + 1)
        return dense[idx]

    def as_array(self, n_bins: int) -> np.ndarray:
        """Dense factor array of length ``n_bins`` (default-filled with 1)."""
        out = np.ones(n_bins, dtype=np.float64)
        for k, v in self._factors.items():
            idx = int(k)
            if 0 <= idx < n_bins:
                out[idx] = v
        return out


def read_bias(path, chromosome, res: int) -> BiasVector | bool:
    """Load the bias file, or return ``False`` when no path was given."""
    if not path:
        return False
    sep = sniff_separator(path)
    factors: dict[float, float] = {}
    by_line = False
    with open(path) as fh:
        for pos, line in enumerate(fh):
            parts = line.strip().split(sep)
            if len(parts) == 3:
                if not chrom_matches(parts[0], chromosome):
                    continue
                val = float(parts[2])
                key = float(parts[1]) // res
            elif len(parts) == 1:
                val = float(parts[0])
                key = float(pos)
                by_line = True
            else:
                continue
            if np.isnan(val) or val < 0.2:
                factors[key] = np.inf
            else:
                factors[key] = val
    return BiasVector(factors, by_line=by_line)
