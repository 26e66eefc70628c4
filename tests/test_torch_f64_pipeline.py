"""The port's host-normalize modes end to end on the CPU against the JAX
package: ``detect_loops_coo`` at float64 with the exact and no normalize,
``find_loops`` at float64 (the fast host normalize), and the CLI with
``--engine-precision float64``, on the maps of tests/test_pipeline.py and
the files of tests/test_torch_cli.py (``tests/torch_port_cases.py``).

The JAX results are read from ``tests/data/torch_port_cpu_f64_golden.json``
(``tools/make_torch_golden.py --slice cpu_f64``: float64, sort-mode BH,
on the CPU). Both sides run float64 through the same ladder, so rows,
their order, anchors and scales are exact and q agrees within rtol 1e-9.
The f32 exact-normalize run goes through the kernel route and is held to
the f64 rows under the f32 rule (q within rtol 2e-4)."""

import numpy as np
import pytest
import torch

import torch_port_cases as C
from mustache_tpu_torch import DetectionConfig, detect_loops_coo, find_loops
from mustache_tpu_torch.cli import main

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


def _rows(loops):
    return [[lp.bin1, lp.bin2, lp.q, lp.scale] for lp in loops]


def assert_rows(got, want, rtol=F64_RTOL):
    assert len(want) > 5
    assert [r[:2] + r[3:] for r in got] == [r[:2] + r[3:] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=rtol)


@pytest.mark.parametrize("name", sorted(C.SINGLE))
def test_detect_loops_coo_f64_matches_jax(name, golden):
    x, y, v = C.single_map(name)
    v0 = v.copy()
    _, _, ckw, kw = C.SINGLE[name]
    logs = []
    got = detect_loops_coo(x, y, v, DetectionConfig(**C.cfg_kwargs(ckw)),
                           device="cpu", log=logs.append, **kw)
    assert np.array_equal(v, v0)                # the caller's v untouched
    mode = "exact" if kw.get("exact_normalize") else "off"
    assert "route=ladder precision=float64 band=float64" in logs[0]
    assert f"host_normalize={mode}" in logs[0]
    assert_rows(_rows(got), golden[name])


def test_find_loops_f64_and_exact_f32(golden):
    """find_loops at float64 (the fast host normalize); then the f32
    exact-normalize run (host band, kernel route) lands on the f64 exact
    rows within the f32 tolerance."""
    x, y, v = C.single_map("find_fast")
    v0 = v.copy()
    got = find_loops(x, y, v, device="cpu", **C.FIND_KW)
    assert np.array_equal(v, v0)
    assert_rows(_rows(got), golden["find_fast"])
    ckw = C.SINGLE["single_exact"][2]
    logs = []
    f32 = detect_loops_coo(
        x, y, v, DetectionConfig(**dict(C.cfg_kwargs(ckw),
                                        precision="float32")),
        exact_normalize=True, device="cpu", log=logs.append)
    assert "route=kernel precision=float32 band=float32" in logs[0]
    assert_rows(_rows(f32), golden["single_exact"], rtol=2e-4)


def test_cli_f64_matches_jax_cli(golden, tmp_path):
    txt = C.write_text(tmp_path / "two.txt", C.CLI_CHROMS)
    out = tmp_path / "o.tsv"
    assert main(["-f", txt, "-o", str(out), "--engine-platform", "cpu"]
                + C.CLI_FLAGS) == 0
    got = out.read_text().splitlines()
    want = golden["cli_f64"].splitlines()
    assert got[0] == want[0] and len(want) > 10
    split = [[ln.split("\t") for ln in rows[1:]] for rows in (got, want)]
    assert [r[:6] + r[7:] for r in split[0]] == \
        [r[:6] + r[7:] for r in split[1]]
    np.testing.assert_allclose([float(r[6]) for r in split[0]],
                               [float(r[6]) for r in split[1]],
                               rtol=F64_RTOL)
