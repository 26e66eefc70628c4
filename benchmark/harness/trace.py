"""Reading a profiled stretch of calls from its Chrome trace.

``torch.profiler`` exports host ranges (``record_function``: category
``user_annotation``), runtime calls with a correlation id, and the device
operations (``kernel``, ``gpu_memcpy``, ``gpu_memset``) that carry the id
of the call that launched them. A kernel belongs to a host range when the
range's span holds its launch (launch correlation: the device runs late,
so its own timestamps say nothing of which range issued it). The harness
wraps each profiled call in a ``bench.call`` range; shares and gaps are
taken over those calls' wall.
"""

from __future__ import annotations

import bisect
import heapq
import json
from collections import defaultdict

CALL = "bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name: str, limit: int = 160) -> str:
    """A device operation's name without its argument list, its leading
    ``void`` and ``(anonymous namespace)::``, at most ``limit``
    characters."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:limit]
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name.strip()[:limit]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The events of one exported trace, indexed for the readers. Times
    are the trace's microseconds."""

    def __init__(self, events: list[dict]):
        self.ranges = defaultdict(list)
        self.launch_ts = {}
        self.device = []
        for e in events:
            cat = e.get("cat", "")
            args = e.get("args") or {}
            corr = args.get("correlation")
            if cat == "user_annotation" and "dur" in e:
                self.ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                self.launch_ts[corr] = e["ts"]
            elif cat in DEVICE_CATS and "dur" in e:
                self.device.append((e["ts"], e["ts"] + e["dur"],
                                    e.get("name", ""), cat, corr))
        self.calls = sorted(self.ranges.get(CALL, []))

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as fh:
            return cls(json.load(fh).get("traceEvents", []))

    # host side ------------------------------------------------------
    def host_us(self, name: str) -> float | None:
        """Summed duration of the host range ``name``, or None if absent."""
        spans = self.ranges.get(name)
        if not spans:
            return None
        return float(sum(b - a for a, b in spans))

    # device side ----------------------------------------------------
    def kernels(self):
        return [d for d in self.device if d[3] == "kernel"]

    def launched_in(self, name: str):
        """Device operations launched inside a span of the range ``name``."""
        spans = sorted(self.ranges.get(name, []))
        starts = [a for a, _ in spans]
        out = []
        for d in self.device:
            t = self.launch_ts.get(d[4])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append(d)
        return out

    def range_device_us(self, name: str) -> float | None:
        """Device time of the kernels launched inside the range ``name``;
        None where the range is absent."""
        if not self.ranges.get(name):
            return None
        return float(sum(d[1] - d[0] for d in self.launched_in(name)
                         if d[3] == "kernel"))

    def kernel_us(self, contains: str) -> float | None:
        """Device time of the kernels whose name holds ``contains``; None
        where none ran."""
        ks = [d for d in self.kernels() if contains in d[2]]
        if not ks:
            return None
        return float(sum(d[1] - d[0] for d in ks))

    # the calls' wall ------------------------------------------------
    def window_us(self) -> float:
        return float(sum(b - a for a, b in _union(self.calls)))

    def busy_intervals(self):
        """Device activity (kernels and copies, overlaps merged) within the
        profiled calls."""
        calls = _union(self.calls)
        out = []
        for a, b in _union((d[0], d[1]) for d in self.device):
            for c0, c1 in calls:
                lo, hi = max(a, c0), min(b, c1)
                if lo < hi:
                    out.append((lo, hi))
        return out

    def busy_us(self) -> float:
        return float(sum(b - a for a, b in self.busy_intervals()))

    def top_device_ops(self, k: int = 10) -> list[list]:
        """The ``k`` device operations that took most time in all, as
        ``[name, seconds]`` (names shortened by :func:`short_name`)."""
        tot = defaultdict(float)
        for a, b, name, _, _ in self.device:
            tot[name] += b - a
        top = sorted(tot.items(), key=lambda t: -t[1])[:k]
        return [[short_name(name), us / 1e6] for name, us in top]

    def innermost_segments(self):
        """The trace's time cut at every host range's start and end, as
        sorted ``(start, end, name)`` pieces, each named by the innermost
        range open over it (the latest to start; the shorter on a tie),
        or None where no range is open."""
        spans = [(a, b, name) for name, ss in self.ranges.items()
                 for a, b in ss if b > a]
        bounds = sorted({t for a, b, _ in spans for t in (a, b)})
        spans.sort()
        out, open_, j = [], [], 0
        for lo, hi in zip(bounds, bounds[1:]):
            while j < len(spans) and spans[j][0] <= lo:
                a, b, name = spans[j]
                heapq.heappush(open_, (-a, b, name))
                j += 1
            while open_ and open_[0][1] <= lo:
                heapq.heappop(open_)
            out.append((lo, hi, open_[0][2] if open_ else None))
        return out

    def idle_gaps(self, k: int = 10) -> list[list]:
        """Idle time of the device inside the profiled calls, each gap cut
        where a host range opens or closes and every piece summed under
        the innermost range open over it; the ``k`` largest as ``[range,
        seconds]``."""
        busy = self.busy_intervals()
        gaps = []
        for c0, c1 in _union(self.calls):
            t = c0
            for a, b in busy:
                if b <= c0 or a >= c1:
                    continue
                if a > t:
                    gaps.append((t, a))
                t = max(t, b)
            if t < c1:
                gaps.append((t, c1))
        gaps.sort()
        segs = self.innermost_segments()
        tot = defaultdict(float)
        i = 0
        for a, b in gaps:
            while i < len(segs) and segs[i][1] <= a:
                i += 1
            covered = a
            for lo, hi, name in segs[i:]:
                if lo >= b:
                    break
                piece = min(hi, b) - max(lo, a)
                if piece > 0:
                    tot[name or "outside any range"] += piece
                    covered += piece
            if b - covered > 0:
                tot["outside any range"] += b - covered
        top = sorted(tot.items(), key=lambda t: -t[1])[:k]
        return [[name, us / 1e6] for name, us in top]
