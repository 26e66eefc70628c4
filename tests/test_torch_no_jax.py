"""The port never imports JAX, the JAX package, pandas or h5py: checked in
a fresh interpreter (this test process has JAX loaded already through
conftest.py) that imports every module of the port and runs
inter-chromosomal detection (one 512^2 tile), the warmup's builds, the
CLI on the CPU from a text file through a one-entry mesh (float32: the
sharded runner, one 2000^2 block) and from a .hic file at float64 (one
block), the differential CLI on two text files (one block each), and
the .cool reader on a file of ``tools/write_cool.py`` (the port's own
HDF5 reader: h5py never loads)."""

import os
import subprocess
import sys
import torch_port_cases  # one torch thread per worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import os, sys, tempfile
sys.path[:0] = [ROOT, ROOT + "/tests"]
import numpy as np
import mustache_tpu_torch as mt
import mustache_tpu_torch.__main__  # noqa: F401
from mustache_tpu_torch import (bandnorm, cli, config, detect, device,  # noqa: F401
                                diff, diff_cli, dryrun, faults, inter,
                                ladder, manifest, normalize, pipeline,
                                runlog, scalespace, sharding, warmup)
from mustache_tpu_torch.io import bias, chrom, cool, hic, hicpro, native, text  # noqa: F401
from mustache_tpu_torch.kernels import build, fused_ladder  # noqa: F401
from synthetic import synthetic_hic
from hic_writer import write_hic
x, y, v, _ = synthetic_hic(400, 60, seed=3, n_loops=6)
cfg = mt.DetectionConfig(resolution=5000, distance_bp=300_000, pt=0.1, st=0.8)
from synthetic import synthetic_inter
xi, yi, vi, _ = synthetic_inter(300, 200, seed=5, n_loops=4)
inter_rows = inter.detect_inter_loops_coo(xi, yi, vi, cfg.with_(st=0.5,
                                          min_tested=5000), chunk=512,
                                          device="cpu")
warmup.warm(device.resolve_device("cpu"))
tmp = tempfile.mkdtemp()
txt, h = os.path.join(tmp, "c.txt"), os.path.join(tmp, "c.hic")
with open(txt, "w") as fh:
    for a, b, c in zip(x, y, v):
        fh.write(f"chr1\t{a * 5000}\tchr1\t{b * 5000}\t{c}\n")
write_hic(h, [("chr1", 400 * 5000)], 5000, {"chr1": (x, y, v)}, version=8)
outs = [os.path.join(tmp, "o32.tsv"), os.path.join(tmp, "o64.tsv")]
rcs = [cli.main(["-f", f, "-ch", "1", "-r", "5kb", "-d", "300kb", "-o",
                 o, "-pt", "0.1", "-st", "0.8", "-norm", "NONE",
                 "--engine-platform", "cpu"] + extra)
       for f, o, extra in ((txt, outs[0], ["--engine-mesh", "block"]),
                           (h, outs[1], ["--engine-precision", "float64"]))]
loops, f64 = (open(o).read().splitlines()[1:] for o in outs)
x2, y2, v2, _ = synthetic_hic(400, 60, seed=4, n_loops=6)
txt2 = os.path.join(tmp, "c2.txt")
with open(txt2, "w") as fh:
    for a, b, c in zip(x2, y2, v2):
        fh.write(f"chr1\t{a * 5000}\tchr1\t{b * 5000}\t{c}\n")
rcs.append(diff_cli.main(["-f1", txt, "-f2", txt2, "-ch", "1", "-r", "5kb",
                          "-d", "300kb", "-o", os.path.join(tmp, "d"),
                          "-pt", "0.1", "-st", "0.8",
                          "--engine-platform", "cpu"]))
sys.path.insert(0, ROOT + "/tools")
from write_cool import write_cool
cool_path = os.path.join(tmp, "c.cool")
write_cool(cool_path, [("chr1", 400 * 5000)], 5000, {"chr1": (x, y, v)},
           count_dtype=np.float64)
cx, cy, cv, _ = cool.read_cooler(cool_path, 300_000, "chr1", "chr1", True)
print("COOL", len(cv), cool.cool_chrom_list(cool_path))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mustache_tpu", "pandas", "h5py"))
print("LOOPS", len(loops), len(f64), len(inter_rows))
print("RCS", rcs)
print("BAD_MODULES", bad)
"""


def test_port_imports_and_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(torch_port_cases.SUBPROCESS_ENV)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT.replace("ROOT", repr(ROOT))],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout.splitlines()
    assert "BAD_MODULES []" in out, res.stdout
    assert "RCS [0, 0, 0]" in out, res.stdout
    counts = next(l for l in out if l.startswith("LOOPS")).split()[1:]
    assert int(counts[0]) > 0 and int(counts[1]) > 0 and int(counts[2]) > 0
    assert any(l.startswith("COOL ") and int(l.split()[1]) > 1000
               and l.endswith("['chr1']") for l in out), res.stdout
