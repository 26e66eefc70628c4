"""Fault injection for exercising failure detection and elastic recovery.

Copied from ``mustache_tpu/faults.py:1-70``.

The reference has no failure handling at all — a crashed worker silently
loses its block (mustache.py:931-934, no exit-code check after join).
This engine's unit of restart is the chromosome: the ingest path retries
transient errors, a unit that still fails is recorded and skipped so the
rest of the run completes, and a later ``--engine-resume`` rerun picks up
exactly the failed units via the manifest.

Faults are armed programmatically (``arm``) or via the environment
(``MTPU_FAULT_INJECT="site:count[:match]"``; comma-separated for several
sites). Instrumented sites call ``maybe_fail("site", key=value, ...)``;
an armed fault raises :class:`InjectedFault` (an ``IOError``) ``count``
times, optionally only when ``match`` equals one of the context values.
"""

from __future__ import annotations

import os
import threading

_lock = threading.Lock()
_armed: dict[str, list] = {}  # site -> [remaining, match]
_env_loaded = False


class InjectedFault(IOError):
    """Error raised at an armed fault site."""


def arm(site: str, count: int = 1, match: str | None = None) -> None:
    """Arm ``site`` to fail the next ``count`` times (``match`` limits the
    failures to calls whose context contains that value)."""
    with _lock:
        _armed[site] = [int(count), match]


def reset() -> None:
    global _env_loaded
    with _lock:
        _armed.clear()
        _env_loaded = False


def _load_env_locked() -> None:
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get("MTPU_FAULT_INJECT", "")
    for part in filter(None, (s.strip() for s in spec.split(","))):
        bits = part.split(":")
        site = bits[0]
        count = int(bits[1]) if len(bits) > 1 else 1
        match = bits[2] if len(bits) > 2 else None
        _armed.setdefault(site, [count, match])


def maybe_fail(site: str, **context) -> None:
    """Raise :class:`InjectedFault` if a fault is armed for ``site``."""
    with _lock:
        _load_env_locked()
        ent = _armed.get(site)
        if not ent or ent[0] <= 0:
            return
        if ent[1] is not None and \
                ent[1] not in {str(v) for v in context.values()}:
            return
        ent[0] -= 1
    raise InjectedFault(f"injected fault at {site} ({context})")
