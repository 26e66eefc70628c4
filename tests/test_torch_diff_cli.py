"""The port's differential CLI (``mustache_tpu_torch.diff_cli``) on the CPU
against the JAX package's (``mustache_tpu.diff_cli``) on the same files:
all four output files (``.loop1 .diffloop1 .loop2 .diffloop2``) with the
same header and rows, anchors and scales exact and q within rtol 2e-4; a
resume after an injected ingest fault; the error exits; the JSON log; and
the sharding flags. The JAX diff CLI's four files on these inputs are the
committed golden ``tests/data/torch_port_cpu_f32_golden.json``
(``tools/make_torch_golden.py --slice cpu_f32``: BH in exact sort mode,
on one device; both of the port's BH modes give its rows)."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_cases as C
from mustache_tpu_torch import faults
from mustache_tpu_torch.diff_cli import SUFFIXES, main, parse_args
from hic_writer import write_hic
from synthetic import synthetic_hic

RES = 5000
CPU = ["--engine-platform", "cpu"]
FLAGS = C.F32_DIFF_CLI_FLAGS


@pytest.fixture(scope="module")
def golden():
    return C.load_golden(C.GOLDEN_F32)


def _write_golden(files: dict, prefix: str) -> str:
    """The golden's four files written as ``prefix`` + suffix."""
    for sfx, text in files.items():
        with open(prefix + sfx, "w") as fh:
            fh.write(text)
    return prefix


def _port_cli(argv):
    """The port's CLI with its JSON log captured: (rc, events)."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv + CPU + ["--engine-json-log"])
    return rc, [json.loads(ln) for ln in err.getvalue().splitlines()
                if ln.startswith("{")]


@pytest.fixture(scope="module")
def text_runs(tmp_path_factory, golden):
    """Two conditions as text files (chr20 and chr21 each, one 2000^2
    block each), through the port's CLI; the JAX CLI's files from the
    golden."""
    tmp = tmp_path_factory.mktemp("tdiffcli")
    paths = [C.write_text(tmp / f"{cond}.txt", chroms)
             for cond, chroms in C.F32_DIFF_CLI_CONDS.items()]
    argv = ["-f1", paths[0], "-f2", paths[1], "-ch", "20", "21"] + FLAGS
    port = str(tmp / "port")
    rc, events = _port_cli(argv + ["-o", port])
    assert rc == 0
    ref = _write_golden(golden["diff_cli_text"], str(tmp / "jax"))
    return dict(paths=paths, argv=argv, port=port, ref=ref, events=events)


def _rows(path):
    lines = open(path).read().splitlines()
    assert lines[0].startswith("BIN1_CHR\tBIN1_START")
    return [ln.split("\t") for ln in lines[1:]]


def _assert_files_match(port, ref):
    total = {}
    for sfx in SUFFIXES.values():
        got, want = _rows(port + sfx), _rows(ref + sfx)
        assert open(port + sfx).readline() == open(ref + sfx).readline()
        assert [r[:6] + r[7:] for r in got] == [r[:6] + r[7:] for r in want]
        np.testing.assert_allclose([float(r[6]) for r in got],
                                   [float(r[6]) for r in want], rtol=2e-4)
        total[sfx] = len(want)
    assert all(total.values()), total
    return total


def test_diff_cli_matches_jax_cli(text_runs):
    total = _assert_files_match(text_runs["port"], text_runs["ref"])
    assert {r[0] for r in _rows(text_runs["port"] + ".loop1")} == {"20", "21"}
    assert total[".loop1"] >= total[".diffloop1"]


def test_diff_cli_json_log(text_runs):
    """ingest and detect phases per chromosome, the plan, and a throughput
    event that counts the chromosome's Mb twice (both conditions)."""
    events = text_runs["events"]
    kinds = [e["event"] for e in events]
    assert kinds == ["ingest", "detect_plan", "detect", "throughput"] * 2
    plan = events[1]["detail"]
    assert "device=cpu" in plan and "cond1 band=u8" in plan
    assert "cond2 band=u8" in plan and "stacked" in plan
    tp = events[3]
    assert tp["chromosome"] == "20" and tp["rows"] > 0
    assert tp["mb"] == pytest.approx(2 * 1100 * RES / 1e6, abs=0.02)


def test_diff_cli_hic_matches_jax_cli(tmp_path, golden):
    """Two v8 .hic files, chromosome discovery (no -ch), a KR vector."""
    (nb, d_px), _ = C.F32_CLI_HIC
    paths = []
    for cond, seed in (("a", 12), ("b", 13)):
        x, y, v, _ = synthetic_hic(nb, d_px, seed=seed, n_loops=15)
        paths.append(str(tmp_path / f"{cond}.hic"))
        write_hic(paths[-1], [("chr21", nb * RES)], RES,
                  {"chr21": (x, y, v)}, version=8,
                  norms={("KR", "chr21"): C.kr_vector(nb)})
    argv = ["-f1", paths[0], "-f2", paths[1]] + FLAGS
    port = str(tmp_path / "t")
    assert _port_cli(argv + ["-o", port])[0] == 0
    ref = _write_golden(golden["diff_cli_hic"], str(tmp_path / "j"))
    _assert_files_match(port, ref)
    assert _rows(port + ".loop2")[0][0] == "chr21"


def test_ingest_fault_then_resume(text_runs, tmp_path):
    """A fault at chr21's ingest (no retries) fails that unit only; an
    --engine-resume rerun redoes exactly it and gives the clean run's four
    files, and leaves no part files behind."""
    out = str(tmp_path / "r")
    argv = text_runs["argv"] + ["-o", out, "--engine-resume",
                                "--engine-ingest-retries", "0"]
    faults.reset()
    faults.arm("ingest", count=1, match="21")
    try:
        rc, events = _port_cli(argv)
    finally:
        faults.reset()
    assert rc == 1
    assert [e["unit"] for e in events if e["event"] == "unit_failed"] \
        == ["21"]
    for sfx in SUFFIXES.values():
        assert "21" not in {r[0] for r in _rows(out + sfx)}
    rc, events = _port_cli(argv)
    assert rc == 0
    assert [e["skipping"] for e in events if e["event"] == "resume"] \
        == [["20"]]
    assert sum(e["event"] == "detect" for e in events) == 1
    for sfx in SUFFIXES.values():
        assert open(out + sfx).read() == open(text_runs["port"] + sfx).read()
    assert not [p for p in os.listdir(tmp_path) if ".part." in p]


def test_parse_args_defaults():
    a = parse_args(["-f1", "a.txt", "-f2", "b.txt", "-r", "5kb", "-o", "o"])
    assert a.pt == 0.2 and a.pt2 == 0.1 and a.st == 0.88
    assert a.platform == "" and a.precision == "float32"


def test_diff_cli_missing_file(text_runs, tmp_path, capsys):
    rc = main(["-f1", text_runs["paths"][0], "-f2", "/nonexistent", "-ch",
               "21", "-r", "5kb", "-o", str(tmp_path / "o")] + CPU)
    assert rc == 1
    assert "Couldn't find the specified contact files" in capsys.readouterr().out


def test_diff_cli_bad_resolution(text_runs, tmp_path, capsys):
    rc = main(["-f1", text_runs["paths"][0], "-f2", text_runs["paths"][1],
               "-ch", "21", "-r", "bogus", "-o", str(tmp_path / "o")] + CPU)
    assert rc == 1
    assert "Invalid resolution" in capsys.readouterr().out


@pytest.mark.parametrize("extra,match", [
    (["--engine-mesh", "block"], "replicate"),
    (["--engine-mesh", "rowshard"], "rowshard"),
    (["--engine-nprocs", "1", "--engine-coordinator", "localhost:1234"],
     "unsharded"),
    (["--engine-nprocs", "2"], "coordinator"),
    (["-ch2", "20"], "inter"),
])
def test_unported_modes_raise(text_runs, tmp_path, capsys, extra, match):
    """The sharding flags are ported: ``--engine-mesh block`` (a one-entry
    mesh of the CPU) and a one-process run with a coordinator give the
    unsharded files exactly; ``rowshard`` normalizes on the host, so its
    rows hold anchors, scales and files exact and q within the JAX
    dryrun's rtol 5e-3; ``--engine-nprocs 2`` without a coordinator stops
    before any work. The inter case (``-ch2`` != ``-ch``) stops the run as
    the JAX diff CLI does (``mustache_tpu/diff_cli.py:173-175``): its
    message, exit 1, no output file."""
    out = tmp_path / "o"
    argv = ["-f1", text_runs["paths"][0], "-f2", text_runs["paths"][1],
            "-ch", "21", "-o", str(out)] + FLAGS + extra
    if match == "inter":
        assert main(argv + CPU) == 1
        assert "Interchromosomal analysis is not supported." in \
            capsys.readouterr().out
        assert not [p for p in os.listdir(tmp_path)]
        return
    if match == "coordinator":
        with pytest.raises(ValueError, match=match):
            main(argv + CPU)
        assert not [p for p in os.listdir(tmp_path)]
        return
    rc, events = _port_cli(argv)
    assert rc == 0
    mesh = [e for e in events if e["event"] == "mesh"]
    assert mesh == [] if match == "unsharded" else \
        [(e["devices"], e["placement"]) for e in mesh] == [(["cpu"], match)]
    for sfx in SUFFIXES.values():
        want = [r for r in _rows(text_runs["port"] + sfx) if r[0] == "21"]
        got = _rows(str(out) + sfx)
        if match != "rowshard":
            assert got == want, sfx
            continue
        assert [r[:6] + r[7:] for r in got] == [r[:6] + r[7:] for r in want]
        np.testing.assert_allclose([float(r[6]) for r in got],
                                   [float(r[6]) for r in want], rtol=5e-3)


def test_no_platform_flag_means_the_card(text_runs, tmp_path, monkeypatch):
    """Without --engine-platform the diff CLI runs on the card; a host
    without CUDA raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--engine-platform", "cuda"]):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["-f1", text_runs["paths"][0], "-f2", text_runs["paths"][1],
                  "-ch", "21", "-o", str(tmp_path / "o")] + FLAGS + extra)
    assert not os.listdir(tmp_path)


def test_python_dash_m(text_runs, tmp_path):
    """``python -m mustache_tpu_torch.diff_cli`` in a fresh interpreter
    parses its flags and, with no platform flag on a host without CUDA,
    stops with an error before any work."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = str(tmp_path / "m")
    res = subprocess.run(
        [sys.executable, "-m", "mustache_tpu_torch.diff_cli"]
        + text_runs["argv"] + ["-o", out],
        capture_output=True, text=True, timeout=300, env=env, cwd=root)
    assert res.returncode != 0 and "cuda" in res.stderr.lower()
    assert not os.listdir(tmp_path)
