"""Traffic kind ``detect``: one chromosome's map, handed as host COO
triplets to ``mustache_tpu_torch.detect_loops_coo`` again and again by
one caller (a closed loop: each call waits for its rows)."""

from __future__ import annotations

from benchmark.harness.deployment import (
    blocks_of, fused_work, make_maps, program_config,
)
from benchmark.reference import chromosome as reference
from benchmark.reference.chromosome import Deployment


class Work:
    def __init__(self, cell, seed: int, device):
        (m,) = make_maps(cell, seed, device)
        self.x, self.y, self.v = m["x"], m["y"], m["v"]
        self.device = device
        self.cfg = cell.config
        self.program_cfg = program_config(cell.config)
        dep = Deployment(cell.config)
        self.mb_per_call = m["n_bins"] * dep.resolution / 1e6
        self.fused_flop, self.fused_bytes = fused_work(
            cell.config, blocks_of(self.x, self.y, dep))

    def call(self):
        from mustache_tpu_torch import detect_loops_coo

        loops = detect_loops_coo(self.x, self.y, self.v, self.program_cfg,
                                 device=self.device)
        return [((lp.bin1, lp.bin2), lp.q, lp.scale) for lp in loops]

    def reference(self, device, dtype, tf32):
        rows = reference.loops(self.x, self.y, self.v, self.cfg,
                               device=device, dtype=dtype, tf32=tf32)
        return [((x, y), q, s) for x, y, q, s in rows]

    def trace_extra(self) -> dict:
        return {}

    def close(self):
        pass


def setup(cell, seed: int, device) -> Work:
    return Work(cell, seed, device)
