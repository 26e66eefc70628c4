"""Traffic kind ``detect_short_loops``: the ``detect`` kind on maps with
Micro-C's short-range loops (``harness/shortloops.py``): one
chromosome's map, handed as host COO triplets to
``mustache_tpu_torch.detect_loops_coo`` again and again by one caller (a
closed loop: each call waits for its rows).

Beside the trace it logs the bytes the band upload handed to the card
(``pipeline.H2D_BYTES``, a program counter), for ``h2d_MB``; a program
without that counter logs nothing."""

from __future__ import annotations

from benchmark.harness import shortloops
from benchmark.harness.deployment import blocks_of, fused_work, program_config
from benchmark.kinds import detect
from benchmark.reference.chromosome import Deployment


def _h2d_bytes():
    from mustache_tpu_torch import pipeline

    return getattr(pipeline, "H2D_BYTES", None)


class Work(detect.Work):
    def __init__(self, cell, seed: int, device):
        (m,) = shortloops.make_maps(cell, seed, device)
        self.x, self.y, self.v = m["x"], m["y"], m["v"]
        self.anchors = m["anchors"]
        self.device = device
        self.cfg = cell.config
        self.program_cfg = program_config(cell.config)
        dep = Deployment(cell.config)
        self.mb_per_call = m["n_bins"] * dep.resolution / 1e6
        self.fused_flop, self.fused_bytes = fused_work(
            cell.config, blocks_of(self.x, self.y, dep))
        self._h2d_mark = _h2d_bytes()

    def trace_extra(self) -> dict:
        """``{"h2d_bytes": bytes uploaded since the last call}``, or
        nothing where the program keeps no such counter."""
        now = _h2d_bytes()
        if now is None:
            return {}
        since, self._h2d_mark = now - self._h2d_mark, now
        return {"h2d_bytes": since}


def setup(cell, seed: int, device) -> Work:
    return Work(cell, seed, device)
