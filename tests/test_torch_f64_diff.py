"""The port's differential calling in its host-normalize modes on the
CPU against the JAX package: ``detect_diff_loops_coo`` at float64 with
the exact normalize, ``find_diff_loops`` at float64 on raw values, and
the diff CLI with ``--engine-precision float64``, on the maps of
tests/test_diff.py and the files of tests/test_torch_diff_cli.py
(``tests/torch_port_cases.py``).

The JAX results are read from ``tests/data/torch_port_cpu_f64_golden.json``
(``tools/make_torch_golden.py --slice cpu_f64``: float64, sort-mode BH,
on the CPU). Both sides run the float64 triple ladder, so rows, their
order, anchors, scales and tags are exact and q agrees within rtol
1e-9."""

import numpy as np
import pytest
import torch

import torch_port_cases as C
from mustache_tpu_torch import (
    DetectionConfig, detect_diff_loops_coo, find_diff_loops,
)
from mustache_tpu_torch.diff_cli import SUFFIXES, main

F64_RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread in this module: the suite runs six workers on a
    few cores, where torch's own thread pool only oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return C.load_golden()


def assert_rows(got, want):
    assert len(want) > 10 and {r[4] for r in want} >= {1, 2, 3, 4}
    assert [list(r[:2]) + list(r[3:]) for r in got] == \
        [r[:2] + r[3:] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=F64_RTOL)


def test_detect_diff_loops_coo_f64_exact_matches_jax(golden):
    x1, y1, v1, x2, y2, v2 = C.diff_maps("diff_exact")
    v10, v20 = v1.copy(), v2.copy()
    _, _, _, ckw, kw = C.DIFF["diff_exact"]
    logs = []
    got = detect_diff_loops_coo(
        x1, y1, v1, x2, y2, v2, DetectionConfig(**C.cfg_kwargs(ckw)),
        device="cpu", log=logs.append, **kw)
    assert np.array_equal(v1, v10) and np.array_equal(v2, v20)
    assert "route=ladder precision=float64" in logs[0]
    assert logs[0].count("band=float64") == 2
    assert logs[0].count("host_normalize=exact") == 2
    assert_rows(got, golden["diff_exact"])


def test_find_diff_loops_f64_raw_matches_jax(golden):
    got = find_diff_loops(*C.diff_maps("find_diff_raw"), device="cpu",
                          **C.FIND_DIFF_KW)
    assert_rows(got, golden["find_diff_raw"])


def test_diff_cli_f64_matches_jax_cli(golden, tmp_path):
    paths = [C.write_text(tmp_path / f"{c}.txt", chroms)
             for c, chroms in C.DIFF_CLI_CONDS.items()]
    out = str(tmp_path / "diff")
    assert main(["-f1", paths[0], "-f2", paths[1], "-o", out,
                 "--engine-platform", "cpu"] + C.DIFF_CLI_FLAGS) == 0
    for sfx in SUFFIXES.values():
        got = open(out + sfx).read().splitlines()
        want = golden["diff_cli_f64"][sfx].splitlines()
        assert got[0] == want[0] and len(want) > 5, sfx
        split = [[ln.split("\t") for ln in rows[1:]] for rows in (got, want)]
        assert [r[:6] + r[7:] for r in split[0]] == \
            [r[:6] + r[7:] for r in split[1]], sfx
        np.testing.assert_allclose([float(r[6]) for r in split[0]],
                                   [float(r[6]) for r in split[1]],
                                   rtol=F64_RTOL, err_msg=sfx)
