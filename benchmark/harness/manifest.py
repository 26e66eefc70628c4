"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the checkout's root lists configurations, cells and
metrics. Everything else is found by name, one file each:

* ``benchmark/configs/<config>.json``: a deployment (what the program is
  configured with, its source, what was assumed and reduced);
* ``benchmark/traffic/<traffic>.json``: a traffic mix, the parameters
  that the generator and the traffic kind read; its ``kind`` names the
  module ``benchmark/kinds/<kind>.py`` that drives the program;
* ``benchmark/workloads/<cell>.json``: what belongs to one cell alone (its
  correctness limits, the calls its traced run profiles);
* ``benchmark/metrics/<metric>.py``: the reader of one per-layer metric.

A later change adds a deployment, a mix, a cell or a metric by adding
such files and entries; nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    """One cell as the harness runs it."""

    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    spec: dict           # workloads/<cell>.json
    end_to_end: list     # the manifest's end-to-end metrics this cell reports
    per_layer: list      # the manifest's per-layer metrics this cell reports

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s manifest with its files."""
    man = load_manifest(root)
    entries = {w["name"]: w for w in man["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    bench = root / "benchmark"
    config = _json(bench / "configs" / f"{entry['config']}.json")
    traffic = _json(bench / "traffic" / f"{entry['traffic']}.json")
    spec = _json(bench / "workloads" / f"{name}.json")
    e2e = [m for m in man["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in man["per_layer"] if _reports(m, name)]
    return Cell(name, entry, config, traffic, spec, e2e, per_layer)


def kind_module(kind: str):
    """``benchmark.kinds.<kind>``: the driver of a traffic kind."""
    if not NAME.match(kind) or "." in kind:
        raise ValueError(f"bad traffic kind {kind!r}")
    return importlib.import_module(f"benchmark.kinds.{kind}")


def metric_reader(metric: str):
    """``benchmark.metrics.<metric>.read``: one per-layer metric's
    reader, in the module named as the metric."""
    if not NAME.match(metric) or "." in metric:
        raise ValueError(f"no reader module can be named {metric!r}")
    return importlib.import_module(f"benchmark.metrics.{metric}").read


def check_names(man: dict) -> list[str]:
    """Every name, unit and ``reduced`` key of a manifest that breaks the
    allowed characters, and every name used twice."""
    bad = []
    seen = {"configs": set(), "workloads": set(), "metrics": set()}
    for c in man["configs"]:
        for key in [c["name"]] + list(c.get("reduced", [])):
            if not NAME.match(key):
                bad.append(f"config name or reduced key {key!r}")
        if c["name"] in seen["configs"]:
            bad.append(f"config {c['name']!r} twice")
        seen["configs"].add(c["name"])
    for w in man["workloads"]:
        for key in (w["name"], w["config"], w["traffic"]):
            if not NAME.match(key):
                bad.append(f"workload field {key!r}")
        if w["name"] in seen["workloads"]:
            bad.append(f"workload {w['name']!r} twice")
        seen["workloads"].add(w["name"])
    for m in man["end_to_end"] + man["per_layer"]:
        if not NAME.match(m["name"]):
            bad.append(f"metric name {m['name']!r}")
        if not UNIT.match(m["unit"]):
            bad.append(f"unit {m['unit']!r}")
        if m["name"] in seen["metrics"]:
            bad.append(f"metric {m['name']!r} twice")
        seen["metrics"].add(m["name"])
    return bad
