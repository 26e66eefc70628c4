"""Observability: structured per-phase logging and counters.

The reference's only instrumentation is wall-clock prints per chromosome
(mustache.py:1086-1094) and an unused ``-v`` flag. This module provides a
structured event log (JSON lines or human-readable), per-phase timings via
context managers, and the throughput counters the benchmarks report
(genome Mb/s, blocks/s). Each phase is also a
``torch.profiler.record_function`` range, so it shows up named in the
trace ``--engine-profile-dir`` writes.

Torch port of ``mustache_tpu/runlog.py`` (``jax.profiler.TraceAnnotation``
at :50 becomes ``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Any

import torch


class RunLog:
    """Event sink; one per CLI invocation or API session."""

    def __init__(self, json_mode: bool = False, quiet: bool = False,
                 stream=None):
        self.json_mode = json_mode
        self.quiet = quiet
        self.stream = stream or sys.stderr
        self.events: list[dict[str, Any]] = []

    def event(self, kind: str, **fields):
        rec = {"t": round(time.time(), 3), "event": kind, **fields}
        self.events.append(rec)
        if self.quiet:
            return
        if self.json_mode:
            self.stream.write(json.dumps(rec) + "\n")
        else:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            self.stream.write(f"[mustache-tpu] {kind} {kv}\n")
        self.stream.flush()

    @contextlib.contextmanager
    def phase(self, name: str, **fields):
        """Timed phase; also a named profiler range. The timing event is
        emitted even when the body raises (a failing phase must still
        leave its timing record)."""
        t0 = time.time()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.event(name, seconds=round(time.time() - t0, 3), **fields)

    def summary(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for e in self.events:
            if "seconds" in e:
                out[e["event"]] = out.get(e["event"], 0.0) + e["seconds"]
        return out


NULL_LOG = RunLog(quiet=True)
