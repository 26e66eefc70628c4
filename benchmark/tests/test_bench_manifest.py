"""BENCHMARK.json against the contract's shape, and every file it names
found by name; a cell added as files is found without an edit."""

import json
import re
import shutil

import pytest

from benchmark.harness import manifest
from conftest import ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"][:2] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["configs"]) <= 24
    assert 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16
    assert 1 <= len(MAN["per_layer"]) <= 128
    assert len(json.dumps(MAN)) <= 64 * 1024
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert LINE.match(c["why"]) and LINE.match(c["source"])
        assert len(c["reduced"]) <= 16
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_names_and_units_use_the_allowed_characters():
    assert manifest.check_names(MAN) == []
    assert manifest.check_names({
        "configs": [], "workloads": [], "per_layer": [],
        "end_to_end": [{"name": "a b", "unit": "tokens per s"}]}) != []


def test_every_cell_reports_enough_and_its_files_exist():
    names = [w["name"] for w in MAN["workloads"]]
    for name in names:
        cell = manifest.find_cell(name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        manifest.kind_module(cell.kind)
        for m in cell.per_layer:
            assert callable(manifest.metric_reader(m["name"]))
        assert set(cell.spec["limits"]) <= {"rows_off_share", "q_gap_ln"}
        assert "rows_off_share" in cell.spec["limits"]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", names)) <= set(names)


def test_an_added_cell_is_found_by_name(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "hic_5kb.chr22", "config": "hic_5kb",
                             "traffic": "chr22_hg19_5kb", "chips": 1,
                             "why": "added by a later change"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    traffic = json.loads((ROOT / "benchmark/traffic/chr21_hg19_5kb.json")
                         .read_text())
    traffic["maps"][0].update(chrom="chr22", bp=51304566)
    (tmp_path / "benchmark/traffic/chr22_hg19_5kb.json").write_text(
        json.dumps(traffic))
    with pytest.raises(FileNotFoundError):
        manifest.find_cell("hic_5kb.chr22", tmp_path)
    (tmp_path / "benchmark/workloads/hic_5kb.chr22.json").write_text(
        json.dumps({"trace_calls": 5,
                    "limits": {"rows_off_share": 0.05}}))
    cell = manifest.find_cell("hic_5kb.chr22", tmp_path)
    assert cell.traffic["maps"][0]["bp"] == 51304566
    assert cell.kind == "detect" and cell.spec["trace_calls"] == 5
    assert {m["name"] for m in cell.end_to_end} == {"Mb_per_s", "peak_GiB",
                                                    "setup_s"}
    # metrics without a list of cells reach an added cell by themselves
    assert [m["name"] for m in cell.per_layer] == ["device_idle_pct"]
