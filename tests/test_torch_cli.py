"""The port's CLI (``mustache_tpu_torch.cli``) on the CPU against the JAX
package's CLI on the same files: rows with anchors and scales exact and q
within rtol 2e-4 (the f32 tolerance of the port's other parity tests),
plus the flows of tests/test_cli.py (missing file, bad resolution, text
without -ch, prefetch, ingest faults and resume, JSON log) and the modes
that raise because they are not ported yet. The JAX side runs its BH in
exact sort mode, the port's only mode."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mustache_tpu.detect as jdetect
from mustache_tpu.cli import main as jax_main
from mustache_tpu_torch import faults
from mustache_tpu_torch.cli import main, parse_args
from hic_writer import write_hic
from synthetic import synthetic_hic

RES = 5000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--engine-platform", "cpu"]
FLAGS = ["-r", "5kb", "-d", "750kb", "-pt", "0.2", "-st", "0.6"]


def _write_text(path, chroms):
    with open(path, "w") as fh:
        for chrom, (x, y, v) in chroms.items():
            for a, b, c in zip(x, y, v):
                fh.write(f"{chrom}\t{a * RES}\t{chrom}\t{b * RES}\t{c}\n")
    return str(path)


@pytest.fixture(scope="module")
def two_chroms(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tcli")
    chroms = {}
    for chrom, seed in (("chr20", 7), ("chr21", 8)):
        x, y, v, _ = synthetic_hic(1200, 150, seed=seed, n_loops=20)
        chroms[chrom] = (x, y, v)
    return _write_text(tmp / "two.txt", chroms)


def _rows(path):
    lines = open(path).read().splitlines()
    assert lines[0].startswith("BIN1_CHR\tBIN1_START")
    return [ln.split("\t") for ln in lines[1:]]


def _assert_rows_match(got, want):
    assert [r[:6] + r[7:] for r in got] == [r[:6] + r[7:] for r in want]
    np.testing.assert_allclose([float(r[6]) for r in got],
                               [float(r[6]) for r in want], rtol=2e-4)


def _jax_cli(argv, monkeypatch):
    monkeypatch.setattr(jdetect, "_BH_MODE", "sort")
    assert jax_main(argv + ["--engine-platform", "cpu"]) == 0


def test_parse_args_defaults():
    a = parse_args(["-f", "x.txt", "-r", "5kb", "-o", "out.tsv"])
    assert a.pt == 0.2 and a.st == 0.88 and a.s_z == 1.6
    assert a.octaves == 2 and a.s == 10 and a.nprocesses == 4
    assert a.chromosome == "n" and a.platform == "" and a.precision == "float32"


def test_cli_matches_jax_cli(two_chroms, tmp_path, monkeypatch):
    out, ref = str(tmp_path / "t.tsv"), str(tmp_path / "j.tsv")
    argv = ["-f", two_chroms, "-ch", "20", "21"] + FLAGS
    assert main(argv + ["-o", out] + CPU) == 0
    _jax_cli(argv + ["-o", ref], monkeypatch)
    got, want = _rows(out), _rows(ref)
    assert len(want) > 5 and {r[0] for r in want} == {"20", "21"}
    _assert_rows_match(got, want)


def test_cli_hic_matches_jax_cli(tmp_path, monkeypatch):
    """.hic input with chromosome discovery (no -ch) and a KR vector."""
    x, y, v, _ = synthetic_hic(1000, 150, seed=12, n_loops=15)
    kr = np.ones(1000)
    kr[::97] = 2.0
    path = str(tmp_path / "m.hic")
    write_hic(path, [("chr21", 1000 * RES)], RES, {"chr21": (x, y, v)},
              version=8, norms={("KR", "chr21"): kr})
    out, ref = str(tmp_path / "t.tsv"), str(tmp_path / "j.tsv")
    assert main(["-f", path, "-o", out] + FLAGS + CPU) == 0
    _jax_cli(["-f", path, "-o", ref] + FLAGS, monkeypatch)
    got, want = _rows(out), _rows(ref)
    assert len(want) > 3 and want[0][0] == "chr21"
    _assert_rows_match(got, want)


def test_cli_prefetch_matches_sequential(two_chroms, tmp_path):
    outs = []
    for extra in ([], ["--engine-no-prefetch"]):
        out = str(tmp_path / f"loops{len(extra)}.tsv")
        assert main(["-f", two_chroms, "-ch", "20", "21", "-o", out]
                    + FLAGS + CPU + extra) == 0
        outs.append(open(out).read())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) > 2


def test_cli_missing_file(tmp_path, capsys):
    rc = main(["-f", "/nonexistent", "-ch", "21", "-r", "5kb",
               "-o", str(tmp_path / "o.tsv")] + CPU)
    assert rc == 1
    assert "Couldn't find the specified contact files" in capsys.readouterr().out


def test_cli_bad_resolution(two_chroms, tmp_path, capsys):
    rc = main(["-f", two_chroms, "-ch", "21", "-r", "bogus",
               "-o", str(tmp_path / "o.tsv")] + CPU)
    assert rc == 1
    assert "Invalid resolution" in capsys.readouterr().out


def test_cli_text_requires_chromosome(two_chroms, tmp_path, capsys):
    rc = main(["-f", two_chroms, "-r", "5kb", "-o", str(tmp_path / "o.tsv")]
              + CPU)
    assert rc == 1
    assert "chromosome name" in capsys.readouterr().out


def test_ingest_fault_then_resume(two_chroms, tmp_path):
    """A fault at chr21's ingest (no retries) fails that unit only; an
    --engine-resume rerun redoes exactly it and gives the clean run's
    TSV."""
    clean = str(tmp_path / "clean.tsv")
    assert main(["-f", two_chroms, "-ch", "20", "21", "-o", clean]
                + FLAGS + CPU) == 0
    out = str(tmp_path / "o.tsv")
    argv = ["-f", two_chroms, "-ch", "20", "21", "-o", out, "--engine-resume",
            "--engine-ingest-retries", "0"] + FLAGS + CPU
    faults.reset()
    faults.arm("ingest", count=1, match="21")
    try:
        assert main(argv) == 1
    finally:
        faults.reset()
    assert {r[0] for r in _rows(out)} == {"20"}
    assert main(argv) == 0
    assert open(out).read() == open(clean).read()
    assert not [p for p in os.listdir(tmp_path) if ".part." in p]


def test_ingest_retry_recovers(two_chroms, tmp_path, capsys):
    out = str(tmp_path / "o.tsv")
    faults.reset()
    faults.arm("ingest", count=1, match="21")
    try:
        assert main(["-f", two_chroms, "-ch", "21", "-o", out] + FLAGS + CPU
                    + ["--engine-json-log"]) == 0
    finally:
        faults.reset()
    events = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()
              if ln.startswith("{")]
    assert [e["attempt"] for e in events if e["event"] == "ingest_retry"] \
        == [1]


def test_json_log_events(two_chroms, tmp_path, capsys):
    out = str(tmp_path / "o.tsv")
    assert main(["-f", two_chroms, "-ch", "21", "-o", out, "--engine-json-log",
                 "--engine-warmup"] + FLAGS + CPU) == 0
    events = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()
              if ln.startswith("{")]
    kinds = [e["event"] for e in events]
    assert kinds == ["warmup", "ingest", "detect_plan", "detect", "throughput"]
    plan = events[2]["detail"]
    assert "device=cpu" in plan and "band=u8" in plan and "slabs=1" in plan
    assert events[3]["contacts"] > 0 and events[4]["loops"] > 0
    assert all(isinstance(e["t"], float) for e in events)


def test_profile_dir_writes_a_trace(two_chroms, tmp_path):
    """--engine-profile-dir writes a torch.profiler trace holding the CLI's
    named phases."""
    prof = tmp_path / "trace"
    assert main(["-f", two_chroms, "-ch", "21", "-o", str(tmp_path / "o.tsv"),
                 "--engine-profile-dir", str(prof)] + FLAGS + CPU) == 0
    traces = [p for p in os.listdir(prof) if p.endswith(".json")]
    assert len(traces) == 1
    names = {e.get("name") for e in json.load(
        open(prof / traces[0]))["traceEvents"]}
    assert {"ingest", "detect"} <= names


@pytest.mark.parametrize("extra,match", [
    (["--engine-mesh", "block"], "sharding"),
    (["--engine-mesh", "rowshard"], "sharding"),
    (["--engine-nprocs", "2"], "sharding"),
    (["--engine-coordinator", "localhost:1234"], "sharding"),
    (["-ch2", "20"], "inter"),
])
def test_unported_modes_raise(two_chroms, tmp_path, capsys, extra, match):
    """The sharding modes raise ``NotImplementedError`` before any work.
    The inter case (``-ch2`` != ``-ch``) is ported: from a text file it
    prints the reference's gate message and records the pair as a failed
    unit at stage "gate" (exit 1, header-only TSV), as the JAX CLI does."""
    out = tmp_path / "o.tsv"
    argv = ["-f", two_chroms, "-ch", "21", "-o", str(out)] + FLAGS + CPU \
        + extra
    if match == "inter":
        assert main(argv + ["--engine-json-log"]) == 1
        cap = capsys.readouterr()
        assert ("Interchromosomal analysis is only supported for .hic and "
                ".cool input formats.") in cap.out
        failed = [json.loads(ln) for ln in cap.err.splitlines()
                  if ln.startswith("{") and '"unit_failed"' in ln]
        assert [(e["unit"], e["stage"]) for e in failed] == \
            [("21__x__20", "gate")]
        assert _rows(out) == []
        return
    with pytest.raises(NotImplementedError, match=match):
        main(argv)
    assert not out.exists()


def test_no_platform_flag_means_the_card(two_chroms, tmp_path, monkeypatch):
    """Without --engine-platform the CLI runs on the card; a host without
    CUDA raises before any work and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o.tsv"
    for extra in ([], ["--engine-platform", "cuda"],
                  ["--engine-platform", "gpu"]):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["-f", two_chroms, "-ch", "21", "-o", str(out)] + FLAGS
                 + extra)
    assert not out.exists()


def test_python_dash_m(two_chroms, tmp_path):
    """``python -m mustache_tpu_torch`` in a fresh interpreter: the CPU
    when asked, an error without CUDA otherwise."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = tmp_path / "o.tsv"
    base = [sys.executable, "-m", "mustache_tpu_torch", "-f", two_chroms,
            "-ch", "21", "-o", str(out)] + FLAGS
    res = subprocess.run(base + CPU, capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert len(_rows(out)) > 2
    res = subprocess.run(base, capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert res.returncode != 0 and "cuda" in res.stderr.lower()
