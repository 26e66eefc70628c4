"""Traffic kind ``cli_hic``: the command users type, from a ``.hic`` file
of the traffic's chromosomes to a TSV of loops.

Set-up writes the maps as a version-8 ``.hic`` (float32 counts, a KR
vector of ones, so the CLI's default normalization leaves the counts as
they are) in a directory under ``TMPDIR``. Each call runs
``mustache_tpu_torch.cli.main`` in this process over every chromosome,
with its JSON phase log captured, and reads the TSV back. The reference
takes the counts as the file holds them (rounded to float32)."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import tempfile

import numpy as np

from benchmark.harness import hicfile
from benchmark.harness.deployment import (
    blocks_of, fused_work, make_maps,
)
from benchmark.reference import chromosome as reference
from benchmark.reference.chromosome import Deployment


class Work:
    def __init__(self, cell, seed: int, device):
        self.maps = make_maps(cell, seed, device)
        for m in self.maps:
            m["v"] = m["v"].astype(np.float32).astype(np.float64)
        self.device = device
        self.cfg = cfg = cell.config
        dep = Deployment(cfg)
        res = dep.resolution
        self.dir = tempfile.mkdtemp(prefix="mustache_bench_cli_")
        self.hic = os.path.join(self.dir, "maps.hic")
        hicfile.write_hic(
            self.hic, [(m["chrom"], m["n_bins"] * res) for m in self.maps],
            res, {m["chrom"]: (m["x"], m["y"], m["v"]) for m in self.maps},
            norms={("KR", m["chrom"]): np.ones(m["n_bins"])
                   for m in self.maps})
        self.out = os.path.join(self.dir, "loops.tsv")
        self.argv = ["-f", self.hic, "-ch", *[m["chrom"] for m in self.maps],
                     "-r", str(res), "-d", str(cfg["distance_bp"]),
                     "-o", self.out, "-pt", str(cfg["pt"]),
                     "-st", str(cfg["st"]), "-sz", str(cfg["sigma0"]),
                     "-oc", str(cfg["octaves"]),
                     "--engine-precision", cfg["precision"],
                     "--engine-json-log"]
        if str(device) == "cpu":
            self.argv += ["--engine-platform", "cpu"]
        self.res = res
        self.mb_per_call = sum(m["n_bins"] for m in self.maps) * res / 1e6
        self.fused_flop, self.fused_bytes = fused_work(
            cfg, sum(blocks_of(m["x"], m["y"], dep) for m in self.maps))
        self.events: list[dict] = []

    def call(self):
        from mustache_tpu_torch.cli import main

        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(list(self.argv))
        log = err.getvalue()
        if rc != 0:
            raise RuntimeError(f"the CLI exited {rc}: {log[-2000:]}"
                               f"{out.getvalue()[-2000:]}")
        self.events.extend(json.loads(line) for line in log.splitlines()
                           if line.startswith("{"))
        rows = []
        with open(self.out) as fh:
            fh.readline()
            for line in fh:
                p = line.rstrip("\n").split("\t")
                rows.append(((p[0], int(p[1]) // self.res,
                              int(p[4]) // self.res), float(p[6]),
                             float(p[7])))
        return rows

    def reference(self, device, dtype, tf32):
        rows = []
        for m in self.maps:
            rows += [((m["chrom"], x, y), q, s) for x, y, q, s in
                     reference.loops(m["x"], m["y"], m["v"], self.cfg,
                                     device=device, dtype=dtype, tf32=tf32)]
        return rows

    def trace_extra(self) -> dict:
        """The CLI's phase log of the calls since the last read."""
        events, self.events = self.events, []
        return {"runlog": events}

    def close(self):
        shutil.rmtree(self.dir, ignore_errors=True)


def setup(cell, seed: int, device) -> Work:
    return Work(cell, seed, device)
