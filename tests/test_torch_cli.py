"""The port's CLI (``mustache_tpu_torch.cli``) on the CPU against the JAX
package's CLI on the same files: rows with anchors and scales exact and q
within rtol 2e-4 (the f32 tolerance of the port's other parity tests),
plus the flows of tests/test_cli.py (missing file, bad resolution, text
without -ch, prefetch, ingest faults and resume, JSON log) and the
sharding flags. The JAX CLI's output on these files is the committed
golden ``tests/data/torch_port_cpu_f32_golden.json`` (``tools/
make_torch_golden.py --slice cpu_f32``: the JAX CLI run as the JAX
package's tests run it, BH in exact sort mode; both of the port's BH
modes give its rows)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_cases as C
from mustache_tpu_torch import faults
from mustache_tpu_torch.cli import main, parse_args
from hic_writer import write_hic
from synthetic import synthetic_hic

RES = 5000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--engine-platform", "cpu"]
FLAGS = C.F32_CLI_FLAGS
TWO = ["-ch", "20", "21"]


@pytest.fixture(scope="module")
def two_chroms(tmp_path_factory):
    """chr20 and chr21 (one 2000^2 block each) as one text file."""
    tmp = tmp_path_factory.mktemp("tcli")
    return C.write_text(tmp / "two.txt", C.F32_CLI_CHROMS)


@pytest.fixture(scope="module")
def two_run(two_chroms, tmp_path_factory):
    """The port's CLI on both chromosomes, once for the module: its TSV."""
    out = str(tmp_path_factory.mktemp("tcli_run") / "t.tsv")
    assert main(["-f", two_chroms, "-o", out] + TWO + FLAGS + CPU) == 0
    return out


@pytest.fixture(scope="module")
def golden():
    return C.load_golden(C.GOLDEN_F32)


def _rows(path):
    lines = open(path).read().splitlines()
    assert lines[0].startswith("BIN1_CHR\tBIN1_START")
    return [ln.split("\t") for ln in lines[1:]]


def _text_rows(text):
    lines = text.splitlines()
    assert lines[0].startswith("BIN1_CHR\tBIN1_START")
    return [ln.split("\t") for ln in lines[1:]]


def _assert_rows_match(got, want):
    assert [r[:6] + r[7:] for r in got] == [r[:6] + r[7:] for r in want]
    np.testing.assert_allclose([float(r[6]) for r in got],
                               [float(r[6]) for r in want], rtol=2e-4)


def test_parse_args_defaults():
    a = parse_args(["-f", "x.txt", "-r", "5kb", "-o", "out.tsv"])
    assert a.pt == 0.2 and a.st == 0.88 and a.s_z == 1.6
    assert a.octaves == 2 and a.s == 10 and a.nprocesses == 4
    assert a.chromosome == "n" and a.platform == "" and a.precision == "float32"


def test_cli_matches_jax_cli(two_run, golden):
    got, want = _rows(two_run), _text_rows(golden["cli_text"])
    assert len(want) > 5 and {r[0] for r in want} == {"20", "21"}
    _assert_rows_match(got, want)


def test_cli_hic_matches_jax_cli(tmp_path, golden):
    """.hic input with chromosome discovery (no -ch) and a KR vector."""
    (nb, d_px), kw = C.F32_CLI_HIC
    x, y, v, _ = synthetic_hic(nb, d_px, **kw)
    path = str(tmp_path / "m.hic")
    write_hic(path, [("chr21", nb * RES)], RES, {"chr21": (x, y, v)},
              version=8, norms={("KR", "chr21"): C.kr_vector(nb)})
    out = str(tmp_path / "t.tsv")
    assert main(["-f", path, "-o", out] + FLAGS + CPU) == 0
    got, want = _rows(out), _text_rows(golden["cli_hic"])
    assert len(want) > 3 and want[0][0] == "chr21"
    _assert_rows_match(got, want)


def test_cli_prefetch_matches_sequential(two_chroms, two_run, tmp_path):
    """The module's run (prefetch on: chr21's ingest overlaps chr20's
    detection) against a run without the lookahead."""
    out = str(tmp_path / "loops1.tsv")
    assert main(["-f", two_chroms, "-o", out, "--engine-no-prefetch"]
                + TWO + FLAGS + CPU) == 0
    outs = [open(two_run).read(), open(out).read()]
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


def test_ingest_fault_then_resume(two_chroms, two_run, tmp_path):
    """A fault at chr21's ingest (no retries) fails that unit only; an
    --engine-resume rerun redoes exactly it and gives the clean run's
    TSV (the module's run)."""
    clean = two_run
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
    (["--engine-mesh", "block"], "replicate"),
    (["--engine-mesh", "rowshard"], "rowshard"),
    (["--engine-nprocs", "1", "--engine-coordinator", "localhost:1234"],
     "unsharded"),
    (["--engine-nprocs", "2"], "coordinator"),
    (["-ch2", "20"], "inter"),
])
def test_unported_modes_raise(two_run, two_chroms, tmp_path, capsys, extra,
                              match):
    """The sharding flags are ported: ``--engine-mesh block`` (a one-entry
    mesh of the CPU) and a one-process run with a coordinator give the
    unsharded rows exactly; ``rowshard`` normalizes on the host, so its
    rows hold anchors and scales exact and q within the JAX dryrun's rtol
    5e-3 (``__graft_entry__.py``); ``--engine-nprocs 2`` without a
    coordinator stops before any work. The inter case (``-ch2`` != ``-ch``)
    is ported: from a text file it prints the reference's gate message and
    records the pair as a failed unit at stage "gate" (exit 1, header-only
    TSV), as the JAX CLI does."""
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
    if match == "coordinator":
        with pytest.raises(ValueError, match=match):
            main(argv)
        assert not out.exists()
        return
    assert main(argv + ["--engine-json-log"]) == 0
    events = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()
              if ln.startswith("{")]
    mesh = [e for e in events if e["event"] == "mesh"]
    want = [r for r in _rows(two_run) if r[0] == "21"]
    got = _rows(out)
    assert len(want) > 2
    if match == "unsharded":
        assert not mesh and got == want
        return
    assert [(e["devices"], e["placement"]) for e in mesh] == \
        [(["cpu"], match)]
    if match == "replicate":
        assert got == want
    else:
        assert [r[:6] + r[7:] for r in got] == [r[:6] + r[7:] for r in want]
        np.testing.assert_allclose([float(r[6]) for r in got],
                                   [float(r[6]) for r in want], rtol=5e-3)


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
    env.update(C.SUBPROCESS_ENV)
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
