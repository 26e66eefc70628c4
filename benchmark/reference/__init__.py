"""Plain reference of the loop-calling method, in PyTorch at float64.

An independent transcription of the published method (the reference
Mustache's ``normalize_sparse``, ``mustache`` and ``diff_mustache``, as
the frozen numpy/scipy oracle in ``benchmark/tests/frozen_oracle.py``
renders them) over the reference's block grid and ownership masks. It
works from the raw COO triplets the harness hands both sides and imports
nothing of the program under test.

* ``normalize``: per-diagonal distance normalization.
* ``detect``: one dense block, single map and two conditions.
* ``chromosome``: the block grid over a whole chromosome.
"""
