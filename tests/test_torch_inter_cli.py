"""The port's CLI on inter-chromosomal pairs (``-ch c1 -ch2 c2``) on the
CPU against the JAX package's CLI on the same files: from ``.cool``
(``tests/test_cool.py::build_cool``, h5py) and ``.hic`` v8 and v9
(``tests/hic_writer.py``, KR vectors applied), the same TSV: rows in
order, anchors and scales exact, log q within the JAX package's f32
parity rule (rtol 2e-4, atol 1e-4 on log q, ``tests/test_pallas.py:
71-72``). At these q (log q near -50) rtol 2e-4 in q itself is the f32
noise floor: two f32 paths' q can part by more than that, each about as
far from float64 (``tools/f32_tolerance.py --inter``;
tests/test_torch_inter.py holds both within 1e-3 of float64 in log q). From text, the
reference's gate message and a ``unit_failed`` event at stage "gate", as
the JAX CLI gives, while a run's intra unit still runs (its ingest
prefetched behind the gated pair)."""

import contextlib
import io
import json
import math

import numpy as np
import pytest

from mustache_tpu.cli import main as jax_main
from mustache_tpu_torch.cli import main
from hic_writer import write_hic
from synthetic import synthetic_hic, synthetic_inter
import torch_port_cases  # noqa: F401  (one torch thread per worker)

RES = 5000
CPU = ["--engine-platform", "cpu"]
FLAGS = ["-r", "5kb", "-pt", "0.1", "-st", "0.5"]
N1, N2 = 700, 500


def _rows(path):
    lines = open(path).read().splitlines()
    assert lines[0].startswith("BIN1_CHR\tBIN1_START")
    return [ln.split("\t") for ln in lines[1:]]


def _run(cli, argv, platform):
    """(rc, stdout, JSON events) of one CLI run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli(argv + ["--engine-json-log", "--engine-platform", platform])
    return rc, out.getvalue(), [json.loads(ln) for ln in
                                err.getvalue().splitlines()
                                if ln.startswith("{")]


def _same_tsv(tmp_path, argv, names):
    got, want = str(tmp_path / "t.tsv"), str(tmp_path / "j.tsv")
    assert _run(main, argv + ["-o", got], "cpu")[0] == 0
    assert _run(jax_main, argv + ["-o", want], "cpu")[0] == 0
    g, w = _rows(got), _rows(want)
    assert len(w) >= 5
    assert {(r[0], r[3]) for r in w} == {names}
    assert [r[:6] + r[7:] for r in g] == [r[:6] + r[7:] for r in w]
    np.testing.assert_allclose([math.log(float(r[6])) for r in g],
                               [math.log(float(r[6])) for r in w],
                               rtol=2e-4, atol=1e-4)


@pytest.fixture(scope="module")
def maps():
    xi, yi, vi, _ = synthetic_inter(N1, N2, seed=21, n_loops=8)
    xa, ya, va, _ = synthetic_hic(N1, 60, seed=22)
    return (xi, yi, vi), (xa, ya, va)


def test_inter_from_cool(maps, tmp_path):
    from test_cool import build_cool

    (xi, yi, vi), (xa, ya, va) = maps
    path = str(tmp_path / "inter.cool")
    build_cool(path, [("chr1", N1 * RES), ("chr2", N2 * RES)], RES,
               {"chr1": (xa, ya, va), ("chr1", "chr2"): (xi, yi, vi)})
    _same_tsv(tmp_path, ["-f", path, "-ch", "chr1", "-ch2", "chr2",
                         "-norm", "weight"] + FLAGS, ("chr1", "chr2"))


@pytest.mark.parametrize("version", [8, 9])
def test_inter_from_hic(maps, tmp_path, version):
    (xi, yi, vi), (xa, ya, va) = maps
    path = str(tmp_path / f"inter_v{version}.hic")
    norms = {("KR", "c1"): np.full(N1, 2.0), ("KR", "c2"): np.full(N2, 4.0)}
    write_hic(path, [("c1", N1 * RES), ("c2", N2 * RES)], RES,
              {"c1": (xa, ya, va), ("c1", "c2"): (xi, yi, vi)},
              version=version, norms=norms)
    _same_tsv(tmp_path, ["-f", path, "-ch", "c1", "-ch2", "c2"] + FLAGS,
              ("c1", "c2"))


def test_inter_from_text_is_gated(tmp_path):
    """From text, the inter pair fails at the gate with the reference's
    message and a ``unit_failed`` event, in both CLIs (exit 1). In the
    port's ``-ch chr1 chr1 -ch2 chr2 chr1`` run the intra unit, prefetched
    behind the gated pair, still runs and writes the rows of a run of that
    unit alone."""
    x, y, v, _ = synthetic_hic(300, 60, seed=31, n_loops=6)
    path = tmp_path / "c.txt"
    with open(path, "w") as fh:
        for a, b, c in zip(x, y, v):
            fh.write(f"chr1\t{a * RES}\tchr1\t{b * RES}\t{c}\n")
    flags = ["-f", str(path), "-r", "5kb", "-d", "300kb", "-pt", "0.1",
             "-st", "0.8"]
    gate_msg = ("Interchromosomal analysis is only supported for .hic and "
                ".cool input formats.")

    def gated(cli, chroms, out):
        rc, stdout, events = _run(cli, flags + chroms + ["-o", out], "cpu")
        return (rc, [ln for ln in stdout.splitlines() if "Interchromosomal"
                     in ln],
                [(e["unit"], e["stage"]) for e in events
                 if e["event"] == "unit_failed"])

    pair = ["-ch", "chr1", "-ch2", "chr2"]
    want = (1, [gate_msg], [("chr1__x__chr2", "gate")])
    assert gated(jax_main, pair, str(tmp_path / "j.tsv")) == want
    assert gated(main, pair, str(tmp_path / "t.tsv")) == want
    assert _rows(tmp_path / "t.tsv") == _rows(tmp_path / "j.tsv") == []

    both, alone = str(tmp_path / "both.tsv"), str(tmp_path / "alone.tsv")
    assert gated(main, ["-ch", "chr1", "chr1", "-ch2", "chr2", "chr1"],
                 both) == want
    assert _run(main, flags + ["-ch", "chr1", "-o", alone], "cpu")[0] == 0
    assert _rows(both) == _rows(alone) and len(_rows(alone)) > 0
