"""Chromosome-name utilities.

Copied from ``mustache_tpu/io/chrom.py:1-27`` (the port imports nothing
of the JAX package).
"""

from __future__ import annotations


def normalize_chrom(name) -> str:
    """Strip a leading ``chr`` prefix: ``chr21`` and ``21`` compare equal
    (reference: mustache.py:191-196)."""
    return str(name).replace("chr", "")


def chrom_matches(a, b) -> bool:
    return normalize_chrom(a) == normalize_chrom(b)


def read_chrom_sizes(path: str) -> dict[str, int]:
    """Read a UCSC-style chrom.sizes file into ``{"chr<name>": size}``
    keyed with the ``chr`` prefix re-applied after stripping, matching the
    reference keying scheme (mustache.py:1049-1054)."""
    sizes: dict[str, int] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split("\t")
            if len(parts) < 2:
                continue
            sizes["chr" + normalize_chrom(parts[0])] = int(parts[1])
    return sizes
