"""Traffic kind ``diff``: two conditions of one chromosome (the traffic's
two maps) through ``mustache_tpu_torch.detect_diff_loops_coo``, closed
loop. A call counts the chromosome's length once."""

from __future__ import annotations

from benchmark.harness.deployment import (
    blocks_of, fused_work, make_maps, program_config,
)
from benchmark.reference import chromosome as reference
from benchmark.reference.chromosome import Deployment


class Work:
    def __init__(self, cell, seed: int, device):
        m1, m2 = make_maps(cell, seed, device)
        self.coo = (m1["x"], m1["y"], m1["v"], m2["x"], m2["y"], m2["v"])
        self.device = device
        self.cfg = cell.config
        self.program_cfg = program_config(cell.config)
        dep = Deployment(cell.config)
        n_bins = max(m1["n_bins"], m2["n_bins"])
        self.mb_per_call = n_bins * dep.resolution / 1e6
        blocks = max(blocks_of(m["x"], m["y"], dep) for m in (m1, m2))
        # both conditions' blocks go through the kernel, stacked
        self.fused_flop, self.fused_bytes = fused_work(cell.config,
                                                       2 * blocks)

    def call(self):
        from mustache_tpu_torch import detect_diff_loops_coo

        rows = detect_diff_loops_coo(*self.coo, self.program_cfg,
                                     device=self.device)
        return [((int(tag), int(x), int(y)), float(q), float(s))
                for x, y, q, s, tag in rows]

    def reference(self, device, dtype, tf32):
        rows = reference.diff_loops(*self.coo, self.cfg, device=device,
                                    dtype=dtype, tf32=tf32)
        return [((tag, x, y), q, s) for x, y, q, s, tag in rows]

    def trace_extra(self) -> dict:
        return {}

    def close(self):
        pass


def setup(cell, seed: int, device) -> Work:
    return Work(cell, seed, device)
