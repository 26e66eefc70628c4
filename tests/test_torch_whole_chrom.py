"""Whole chromosomes on the port's main path, at CPU size: the device
normalize in row slabs, pipelined batches with a regrow, and the
plumbing of chip_smoke.py's phase 14 (whole chromosomes at 1 kb).

* The slabbed normalize (``bandnorm.normalize_band_device``) equals the
  whole-band one (``chip_smoke.whole_band_normalize``, the form it
  replaced) bit for bit at slabs of 1 row, of a height that does not
  divide the rows and of the whole band, in the local regime (f32 and
  uint16 bands), the short-column regime and the global regime, and the
  JAX package's ``normalize_band_device`` at rtol 2e-4, atol 2e-4 (the
  tolerance of ``tests/test_torch_bandnorm.py``). Its peak memory, from
  the profiler's allocation events, stays within 4 f32 bands where the
  whole-band form's is about 15.
* Five blocks in five pipelined batches, with the candidate capacity so
  small that blocks in the middle batches regrow, give the one-batch
  run's rows bit for bit at float32 and float64, and at float64 the JAX
  package's (``tests/data/torch_port_batches_f64_5kb_golden.tsv``,
  ``tools/make_torch_golden.py --slice batches_f64_5kb``) under the
  port's float64 rule.
* Phase 14's workloads have the geometry of hg38 chr21 and chr1 at 1 kb,
  the batch rule splits them into 2 and 8 batches on an 80 GB card, and
  their JAX goldens read back through ``compare_to_golden``.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import torch_port_cases  # noqa: E402,F401  (one torch thread per worker)
from mustache_tpu.bandnorm import normalize_band_device as jax_normalize  # noqa: E402
from mustache_tpu_torch import DetectionConfig, detect_loops_coo  # noqa: E402
from mustache_tpu_torch import bandnorm, pipeline, sharding  # noqa: E402
from mustache_tpu_torch.detect import band_width  # noqa: E402
from synthetic import synthetic_hic  # noqa: E402

RES = 5000
GOLDEN_BATCHES_F64 = os.path.join(ROOT, "tests", "data",
                                  "torch_port_batches_f64_5kb_golden.tsv")
# (n, d_px, dtype, regime): the map is synthetic_hic(n, d_px, seed=3)
NORM_CASES = {
    "local-f32": (900, 120, np.float32, "local"),
    "local-u16": (900, 120, np.uint16, "local"),
    "short-cols": (850, 400, np.float32, "short"),
    "global": (300, 200, np.float32, "global"),
}


def _raw_band(n, d_px, dtype):
    x, y, v, _ = synthetic_hic(n, d_px, seed=3, n_loops=10)
    width = max(n, 256)
    band = np.zeros((max(n, width), band_width(width, d_px)), dtype)
    d = y - x
    sel = d < band.shape[1]
    band[x[sel], d[sel]] = v[sel]
    return band


def _regime(band, n, d_px):
    r = bandnorm._norm_regime(*band.shape, n, RES, d_px)
    return "global" if r[0] == "global" else ("short" if r[3] else "local")


@pytest.mark.parametrize("slab", ["1", "37", "whole"])
@pytest.mark.parametrize("case", sorted(NORM_CASES))
def test_slabbed_normalize_is_the_whole_band_one(case, slab, monkeypatch):
    n, d_px, dtype, regime = NORM_CASES[case]
    raw = _raw_band(n, d_px, dtype)
    assert _regime(raw, n, d_px) == regime
    rows = raw.shape[0]
    assert rows % 37
    slab_rows = {"1": 1, "37": 37, "whole": rows}[slab]
    monkeypatch.setattr(bandnorm, "slab_rows_for", lambda r, c: slab_rows)
    src = torch.from_numpy(raw.copy())
    got, gw = bandnorm.normalize_band_device(src, n, RES, d_px)
    want, ww = chip_smoke.whole_band_normalize(torch.from_numpy(raw), n, RES,
                                               d_px)
    assert torch.equal(src, torch.from_numpy(raw)), "the input was modified"
    assert got.dtype == torch.float32 and got.shape == raw.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(gw, ww)
    jgot, jw = jax_normalize(raw.copy(), n, RES, d_px)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), rtol=2e-4,
                               atol=2e-4)


def _cpu_peak_bytes(fn) -> int:
    """Bytes the CPU allocator held at the peak of ``fn()`` beyond what it
    held before, from the profiler's memory events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts, profile_memory=True) as prof:
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            mem = [ev["args"] for ev in json.load(fh)["traceEvents"]
                   if ev.get("name") == "[memory]"]
    base = mem[0]["Total Allocated"] - mem[0]["Bytes"]
    return max(m["Total Allocated"] for m in mem) - base


def test_slabbed_normalize_peak_memory(monkeypatch):
    """A 20,000 x 128 band in the default slabs of a sixteenth of its rows
    (without the 2^22-cell floor, which keeps a band this small in one
    slab): the widened band normalized in place, the peak within 4 f32
    bands; the whole-band form peaks at about 15."""
    n, d_px = 20000, 120
    raw = torch.from_numpy(_raw_band(n, d_px, np.uint16))
    assert raw.shape == (20000, 128)
    band_bytes = 4 * raw.numel()
    monkeypatch.setattr(bandnorm, "_SLAB_MIN_CELLS", 1)
    assert bandnorm.slab_rows_for(*raw.shape) == 1250
    out = {}
    peak = _cpu_peak_bytes(lambda: out.setdefault(
        "got", bandnorm.normalize_band_device(raw, n, RES, d_px)[0]))
    whole_peak = _cpu_peak_bytes(lambda: out.setdefault(
        "want", chip_smoke.whole_band_normalize(raw, n, RES, d_px)[0]))
    assert torch.equal(out["got"], out["want"])
    assert peak <= 4 * band_bytes < whole_peak


@pytest.fixture(scope="module", params=["float32", "float64"])
def five_blocks(request):
    """The five-block 5 kb map of the batches golden, in one batch, at
    each precision."""
    x, y, v, _ = synthetic_hic(7700, 120, seed=141, n_loops=60,
                               loop_strength=3.0)
    cfg = DetectionConfig(resolution=RES, distance_bp=120 * RES, pt=0.1,
                          st=0.8, precision=request.param)
    logs = []
    rows = detect_loops_coo(x, y, v, cfg.with_(block_batch=5), device="cpu",
                            log=logs.append)
    assert "blocks=5 " in logs[0] and "batch=5 " in logs[0]
    return (x, y, v), cfg, rows


def test_pipelined_batches_with_a_regrow(five_blocks, monkeypatch):
    """Five pipelined batches of one block, at a capacity of 16 candidates
    that blocks of the middle batches overflow, give the one-batch rows
    bit for bit on both routes (float32: the kernel route; float64: the
    ladder route and host normalize), and at float64 the JAX package's
    rows (fields exact, q within rtol 1e-9). The float32 rows of this map
    differ from the JAX package's float32 rows by up to 2.2e-4 in q on
    four BH-tied rows, where both sit 5.7e-4 and 7.9e-4 from the float64
    q: f32 rounding, beyond the f32 rule's 2e-4, so the JAX comparison of
    this map is made at float64."""
    (x, y, v), cfg, one_batch = five_blocks
    seen = []
    real = pipeline._maybe_regrow

    def spy(block_out, cfg_, rerun, sig_count):
        seen.append(sig_count(block_out))
        return real(block_out, cfg_, rerun, sig_count)

    monkeypatch.setattr(pipeline, "_maybe_regrow", spy)
    K = 16
    logs = []
    got = detect_loops_coo(x, y, v, cfg.with_(block_batch=1, max_candidates=K),
                           device="cpu", log=logs.append)
    assert "batch=1 " in logs[0] and len(seen) == 5
    # blocks 1-3 are the middle batches; one of them regrows past K
    assert any(sig > K for sig in seen[1:4]), seen
    assert got == one_batch and len(got) > 0
    if cfg.precision == "float64":
        _, golden = chip_smoke.read_tsv(GOLDEN_BATCHES_F64)
        chip_smoke.compare_exact(chip_smoke.loops_tsv_rows(got, "chr2", RES),
                                 golden, "batches")


def test_whole_chromosome_geometry_and_batches(monkeypatch):
    assert chip_smoke.whole_chrom_geometry(chip_smoke.CHR21_1KB) == (
        23, (46784, 2048))
    assert chip_smoke.whole_chrom_geometry(chip_smoke.CHR1_1KB) == (
        124, (273904, 2048))
    cfg = chip_smoke.whole_chrom_cfg(chip_smoke.CHR1_1KB)
    assert (cfg.chunk_size, cfg.distance_px) == (4000, 2000)
    per_block = pipeline.block_bytes("kernel", 4000, 2048, 4)
    assert per_block == 780_288_000
    for free, batch, batches in ((78e9, 16, (2, 8)), (20e9, 12, (2, 11))):
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda dev, free=free: (int(free), int(80e9)))
        got = [sharding._batch_size(cfg, blocks, torch.device("cuda"),
                                    per_block) for blocks in (23, 124)]
        assert got == [batch, batch]
        assert tuple(-(-blocks // b) for blocks, b in
                     zip((23, 124), got)) == batches
    plan = ("n=248956 blocks=124 of 4000^2 batch=16 device=cuda:0 "
            "route=kernel precision=float32 band=u4")
    assert chip_smoke.plan_batches(plan) == (124, 16, 8)


@pytest.mark.parametrize("chrom,n_rows", [("chr21", 561), ("chr1", 0)])
def test_whole_chrom_golden_reads_back(chrom, n_rows):
    """The JAX goldens of phase 14: reference-format TSVs of the one
    chromosome, held to themselves by ``compare_to_golden``, and a q
    outside the f32 rule fails. chr1's map calls no loops in the JAX
    package: its sparsity filter (``c2 >= 0.6`` over the box of
    half-width 2·s1, mustache.py's constant) rejects every candidate
    where the background occupancy at the loop distances is 0.13-0.23."""
    path = {"chr21": chip_smoke.GOLDEN_CHR21_1KB,
            "chr1": chip_smoke.GOLDEN_CHR1_1KB}[chrom]
    header, golden = chip_smoke.read_tsv(path)
    assert header == chip_smoke.read_tsv(chip_smoke.GOLDEN)[0]
    assert len(golden) == n_rows and {r[0] for r in golden} <= {chrom}
    assert chip_smoke.compare_to_golden(golden, golden, tag="test") == (
        n_rows, 0.0)
    if n_rows:
        far = [list(r) for r in golden]
        far[100][6] = repr(float(far[100][6]) * (1 + 1e-3))
        with pytest.raises(SystemExit):
            chip_smoke.compare_to_golden(far, golden, tag="test")


def test_planted_shares_and_workload_process():
    from mustache_tpu_torch.pipeline import Loop

    anchors = [(100, 300), (500, 900), (2000, 2600)]
    loops = [Loop(101, 302, 0.01, 2.0), Loop(700, 800, 0.02, 2.0),
             Loop(2003, 2600, 0.01, 2.0)]
    assert chip_smoke.planted_shares(loops, anchors) == (1 / 3, 1 / 3)
    assert chip_smoke.planted_shares([], anchors) == (0.0, 0.0)
    spec = ((600, 80), dict(seed=5, n_loops=8, density=0.9,
                            density_decay=0.25))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        proc = chip_smoke.start_workload_process(spec, path)
        x, y, v, a = chip_smoke.load_workload_process(proc, path)
        assert not os.path.exists(path)
    wx, wy, wv, wa = synthetic_hic(*spec[0], **spec[1])
    for got, want in ((x, wx), (y, wy), (v, wv)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert [tuple(r) for r in a.tolist()] == [tuple(r) for r in wa]
    proc = subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(3)"])
    with pytest.raises(SystemExit):
        chip_smoke.load_workload_process(proc, os.path.join(ROOT, "absent"))
