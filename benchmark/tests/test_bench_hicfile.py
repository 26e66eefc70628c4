"""The CLI cell's ``.hic`` writer gives the frozen test writer's bytes."""

import numpy as np

from benchmark.harness import hicfile
from frozen_hic_writer import write_hic
from frozen_synthetic import synthetic_hic


def test_same_bytes_as_the_frozen_writer(tmp_path):
    a = synthetic_hic(1500, 120, seed=3, n_loops=10)[:3]
    b = synthetic_hic(1300, 120, seed=4, n_loops=10)[:3]
    chroms = [("chr21", 1500 * 5000), ("chr22", 1300 * 5000)]
    pixels = {"chr21": a, "chr22": b}
    norms = {("KR", "chr21"): np.ones(1500), ("KR", "chr22"): np.ones(1300)}
    write_hic(str(tmp_path / "a.hic"), chroms, 5000, pixels, version=8,
              norms=norms)
    hicfile.write_hic(str(tmp_path / "b.hic"), chroms, 5000, pixels, norms)
    assert (tmp_path / "a.hic").read_bytes() == (tmp_path / "b.hic"
                                                 ).read_bytes()
