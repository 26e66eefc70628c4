"""Two processes of the port's CLI on the CPU, joined by a ``gloo`` group
on 127.0.0.1 (``--engine-nprocs 2``): each takes every other chromosome,
writes its part files, and process 0 assembles the TSV after the barrier.
The clean run's TSV equals the single-process run's byte for byte; with
one chromosome's ingest failing on process 1, the processes exit with
codes 0 and 1 (no hang at the barrier) and the TSV holds the other two,
as ``tests/test_distributed.py`` asks of the JAX CLI."""

import os
import socket
import subprocess
import sys

import pytest

import torch_port_cases as C
from mustache_tpu_torch.cli import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHROMS = {"chrc0": ((1100, 120), dict(seed=320, n_loops=12)),
          "chrc1": ((1100, 120), dict(seed=321, n_loops=12)),
          "chrc2": ((1100, 120), dict(seed=322, n_loops=12))}
ARGS = ["-ch", "c0", "c1", "c2", "-r", "5kb", "-pt", "0.1", "-st", "0.8",
        "-d", "600kb", "--engine-platform", "cpu",
        "--engine-ingest-retries", "0"]


@pytest.fixture(scope="module")
def contacts(tmp_path_factory):
    return C.write_text(tmp_path_factory.mktemp("dist") / "c.txt", CHROMS)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("fault", [False, True], ids=["clean", "fault"])
def test_two_process_cli(contacts, tmp_path, fault):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")])
    env.update(C.SUBPROCESS_ENV)
    if fault:
        env["MTPU_FAULT_INJECT"] = "ingest:100:c1"   # c1 always fails
    out = tmp_path / "multi.tsv"
    base = [sys.executable, "-m", "mustache_tpu_torch", "-f", contacts,
            "-o", str(out), "--engine-coordinator",
            f"127.0.0.1:{_free_port()}", "--engine-nprocs", "2"] + ARGS
    procs = [subprocess.Popen(base + ["--engine-procid", str(pid)], env=env,
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for pid in range(2)]
    rcs, outs = [], []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=120)   # a barrier hang trips this
            rcs.append(p.returncode)
            outs.append(o.decode()[-2000:])
    finally:
        for p in procs:
            p.kill()
    if fault:
        assert rcs == [0, 1], outs
        chroms = {ln.split("\t")[0]
                  for ln in out.read_text().splitlines()[1:]}
        assert chroms == {"c0", "c2"}
        return
    assert rcs == [0, 0], outs
    single = tmp_path / "single.tsv"
    assert main(["-f", contacts, "-o", str(single)] + ARGS) == 0
    assert out.read_bytes() == single.read_bytes()
    assert len(out.read_text().splitlines()) > 3     # header + loops
    # the parts stay (process 0 cannot see its peers' failures)
    assert len([p for p in os.listdir(tmp_path) if p.endswith(".done")]) == 3
