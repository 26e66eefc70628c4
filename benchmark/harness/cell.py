"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, and the result line.

Set-up (``setup_s``, from the process's start) makes the cell's inputs
from the seed on the device, builds the program's kernels (only a
checkout's first run compiles: the build cache sits inside the checkout)
and warms every shape with one call. The window then calls the entry
closed loop until ``--seconds`` have passed, and ends with the call that
crosses them: the rate is all the work of whole calls over all their
time. With ``--trace 1`` the first calls of the window (the cell file's
``trace_calls``) run under ``torch.profiler`` and the per-layer readers
take their metrics from that trace; the other metrics come from
``--trace 0`` runs. Once the window has closed and the peak has been
read, the program's state is dropped and the reference runs on the card
at float64 over the same inputs; every distinct answer the window gave
is compared with it.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

from benchmark.harness import compare, guard, manifest
from benchmark.harness.trace import CALL, Trace

GIB = float(1 << 30)


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def require_cards(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} card(s), the cell asks "
                       f"for {chips}")


def p95(values) -> float:
    """The 95th percentile, ``statistics.quantiles`` (exclusive) of 20."""
    if len(values) < 2:
        return float(values[0])
    return float(statistics.quantiles(values, n=20)[-1])


def _sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _trace_metrics(cell, work, prof, calls: int,
                   extra: dict) -> tuple[dict, dict, dict]:
    """Per-layer metrics, the ``device`` trace fields and the breakdown
    from a finished profiler over ``calls`` calls; ``extra``: what the
    work logged beside the trace over those calls."""
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        tr = Trace.load(path)
    finally:
        os.unlink(path)
    ctx = {"trace": tr, "calls": calls, "fused_flop": work.fused_flop,
           "fused_bytes": work.fused_bytes, **extra}
    metrics = {}
    for m in cell.per_layer:
        value = manifest.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    window = tr.window_us() / 1e6
    dev = {"busy_s": tr.busy_us() / 1e6, "window_s": window}
    breakdown = {"device_ops": tr.top_device_ops(10),
                 "idle_gaps": tr.idle_gaps(10)}
    return metrics, dev, breakdown


def run(name: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", root=manifest.ROOT,
        out=sys.stdout, err=sys.stderr) -> int:
    """Run the cell ``name`` once and print its result line; the exit
    code. ``device="cpu"`` skips the look for a card (the tests drive a
    run so); the metrics are then the CPU's and mean nothing."""
    import torch

    cell = manifest.find_cell(name, root)
    if device != "cpu":
        require_cards(cell.chips)
        torch.cuda.init()
    kind = manifest.kind_module(cell.kind)

    work = kind.setup(cell, seed, device)
    rows = work.call()          # builds what is not built, warms the shapes
    _sync(device)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    # every distinct answer of set-up's call and the window; a call that
    # gives one already held keeps nothing
    distinct = [rows]
    walls, failed, errors = [], 0, []
    prof = None
    trace_calls = max(1, int(cell.spec.get("trace_calls", 3))) if trace else 0
    if trace:
        work.trace_extra()      # drop the warm call's log
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    extra = {}
    profiling = prof is not None
    t0 = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        rows = None
        try:
            if profiling:
                with torch.profiler.record_function(CALL):
                    rows = work.call()
                    _sync(device)
            else:
                rows = work.call()
                _sync(device)
        except Exception as exc:   # a call that fails is counted, not fatal
            failed += 1
            errors.append(f"{type(exc).__name__}: {exc}"[-500:])
        c1 = time.perf_counter()
        walls.append(c1 - c0)
        if rows is not None and not any(rows == d for d in distinct):
            distinct.append(rows)
        if profiling and len(walls) == trace_calls:
            prof.stop()
            profiling = False
            extra = work.trace_extra()
        if c1 - t0 >= seconds and not profiling:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    attempted = len(walls)
    metrics, dev_trace, breakdown = {}, {}, None
    if trace:
        metrics, dev_trace, breakdown = _trace_metrics(
            cell, work, prof, min(trace_calls, attempted), extra)
    else:
        done = attempted - failed
        values = {"Mb_per_s": done * work.mb_per_call / window_s,
                  "peak_GiB": peak / GIB,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}

    # the reference, once the program's state is gone
    if device != "cpu":
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    ref = work.reference(device, torch.float64, False)
    ref_s = time.perf_counter() - r0
    work.close()
    readings = [compare.compare(rows, ref) for rows in distinct]
    limits = cell.spec["limits"]
    checks = {}
    for key, limit in limits.items():
        checks[key] = {"value": max(r[key] for r in readings),
                       "limit": limit}
    checks["failed_calls"] = {"value": failed, "limit": 0}
    forbidden = guard.loaded_forbidden()
    if forbidden:
        err.write(f"forbidden modules loaded: {', '.join(forbidden)}\n")
        return 4
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics}
    if device != "cpu":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell.chips, "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    dev.update(dev_trace)
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks

    for e in errors[:3]:
        err.write(f"failed call: {e}\n")
    err.write(f"cell {name} seed {seed}: {attempted} calls in "
              f"{window_s:.3f} s, set-up {setup_s:.3f} s, reference "
              f"{ref_s:.3f} s, rows {readings[0]['rows_program']} against "
              f"{readings[0]['rows_reference']} ("
              f"{max(r['rows_unmatched'] for r in readings)} unmatched, "
              f"{max(r['rows_off'] for r in readings)} off, q gap "
              f"{max(r['q_gap_ln'] for r in readings):.3g}), "
              f"{len(distinct)} distinct answer(s); calls' median "
              f"{statistics.median(walls):.4f} s, p95 {p95(walls):.4f} s\n")
    for key, c in checks.items():
        err.write(f"check {key} {c['value']!r} limit {c['limit']!r}\n")
    err.flush()
    out.write(json.dumps(result) + "\n")
    out.flush()
    return 0
