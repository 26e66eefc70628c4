"""Checkpoint / resume manifest for multi-chromosome runs.

Copied from ``mustache_tpu/manifest.py:1-112``.

The reference writes its TSV incrementally per chromosome, so a crashed run
can only be resumed by manually re-running the missing chromosomes
(SURVEY.md section 5). Here that contract is explicit: each completed
(chromosome, config-fingerprint) unit is an atomically-written partial
output ``<out>.part.<chrom>`` plus a ``.done`` marker recording the
fingerprint; re-entry skips completed units and the final output is
assembled by concatenating parts whose marker matches the current
fingerprint. Fault domains are per chromosome — a crash loses at most the
chromosome in flight.

Completion records are ONE FILE PER UNIT (no shared manifest JSON):
concurrent multi-host processes each write only their own markers, so
there is no read-modify-write race on shared state.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import tempfile


def config_fingerprint(cfg, extra: dict | None = None) -> str:
    payload = {k: getattr(cfg, k) for k in (
        "resolution", "distance_bp", "pt", "pt2", "st", "sigma0", "octaves",
        "precision")}
    if extra:
        payload.update(extra)
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


def _atomic_write(path: str, content: str):
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path))
    with os.fdopen(fd, "w") as fh:
        fh.write(content)
    os.replace(tmp, path)


@dataclasses.dataclass
class RunManifest:
    out_path: str
    fingerprint: str

    @property
    def manifest_path(self) -> str:
        # legacy shared-manifest location; only removed by cleanup() now
        return self.out_path + ".manifest.json"

    def part_path(self, chrom: str) -> str:
        return f"{self.out_path}.part.{chrom}"

    def _done_path(self, chrom: str) -> str:
        return self.part_path(chrom) + ".done"

    def _markers(self) -> list[dict]:
        out = []
        for p in glob.glob(glob.escape(self.out_path) + ".part.*.done"):
            try:
                rec = json.load(open(p))
            except (OSError, ValueError):
                continue
            if rec.get("fingerprint") == self.fingerprint and "chrom" in rec:
                out.append(rec)
        return out

    def completed_chromosomes(self) -> set[str]:
        return {rec["chrom"] for rec in self._markers()}

    def mark_complete(self, chrom: str, n_loops: int, seconds: float,
                      rows: str):
        """Atomically write the chromosome's rows, then its done marker.
        Marker-per-unit means concurrent processes never contend."""
        _atomic_write(self.part_path(chrom), rows)
        _atomic_write(self._done_path(chrom), json.dumps({
            "fingerprint": self.fingerprint, "chrom": chrom,
            "n_loops": n_loops, "seconds": round(seconds, 2)}))

    def invalidate(self, chroms):
        """Drop any prior parts/markers for these units (fresh, non-resume
        runs must not let a previous run's results leak into assembly)."""
        for chrom in chroms:
            for p in (self._done_path(chrom), self.part_path(chrom)):
                if os.path.exists(p):
                    os.remove(p)

    def assemble(self, chrom_order, header: str):
        """Concatenate completed parts into the final output, in order.
        Only parts with a matching-fingerprint done marker are included —
        a stale part from an older or differently-configured run is not."""
        done = self.completed_chromosomes()
        with open(self.out_path, "w") as out:
            out.write(header)
            for chrom in chrom_order:
                part = self.part_path(chrom)
                if chrom in done and os.path.exists(part):
                    with open(part) as fh:
                        out.write(fh.read())

    def cleanup(self, chrom_order):
        for chrom in chrom_order:
            for p in (self._done_path(chrom), self.part_path(chrom)):
                if os.path.exists(p):
                    os.remove(p)
        if os.path.exists(self.manifest_path):
            os.remove(self.manifest_path)
