"""Ingest layer: contact-map loaders emitting upper-triangular COO triplets.

Torch port of ``mustache_tpu/io`` (no pandas, h5py only inside the
``.cool`` reader's calls). Every loader returns ``(x, y, v)`` with
``x <= y`` (bin indices) filtered to the requested diagonal band, matching
the invariants of the reference loaders (mustache.py:276-277, :386-390).
"""

from mustache_tpu_torch.io.bias import read_bias
from mustache_tpu_torch.io.chrom import chrom_matches, normalize_chrom, read_chrom_sizes
from mustache_tpu_torch.io.text import read_text_contacts, sniff_separator

__all__ = [
    "read_text_contacts",
    "sniff_separator",
    "read_bias",
    "chrom_matches",
    "normalize_chrom",
    "read_chrom_sizes",
]
