"""The port never imports JAX, the JAX package, pandas or h5py: checked in
a fresh interpreter (this test process has JAX loaded already through
conftest.py) that imports every module of the port and runs detection
and the CLI on the CPU from a text file and a .hic file. h5py may load
only inside the .cool reader's call, which this script does not make."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import os, sys, tempfile
sys.path[:0] = [ROOT, ROOT + "/tests"]
import numpy as np
import mustache_tpu_torch as mt
import mustache_tpu_torch.__main__  # noqa: F401
from mustache_tpu_torch import (bandnorm, cli, config, detect, device,  # noqa: F401
                                faults, manifest, pipeline, runlog, scalespace)
from mustache_tpu_torch.io import bias, chrom, cool, hic, hicpro, native, text  # noqa: F401
from mustache_tpu_torch.kernels import build, fused_ladder  # noqa: F401
from synthetic import synthetic_hic
from hic_writer import write_hic
x, y, v, _ = synthetic_hic(400, 60, seed=3, n_loops=6)
cfg = mt.DetectionConfig(resolution=5000, distance_bp=300_000, pt=0.1, st=0.8)
loops = mt.detect_loops_coo(x, y, v, cfg, device="cpu")
tmp = tempfile.mkdtemp()
txt, h = os.path.join(tmp, "c.txt"), os.path.join(tmp, "c.hic")
with open(txt, "w") as fh:
    for a, b, c in zip(x, y, v):
        fh.write(f"chr1\t{a * 5000}\tchr1\t{b * 5000}\t{c}\n")
write_hic(h, [("chr1", 400 * 5000)], 5000, {"chr1": (x, y, v)}, version=8)
rcs = [cli.main(["-f", f, "-ch", "1", "-r", "5kb", "-d", "300kb", "-o",
                 os.path.join(tmp, "o.tsv"), "-pt", "0.1", "-st", "0.8",
                 "-norm", "NONE", "--engine-platform", "cpu"])
       for f in (txt, h)]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mustache_tpu", "pandas", "h5py"))
print("LOOPS", len(loops))
print("RCS", rcs)
print("BAD_MODULES", bad)
"""


def test_port_imports_and_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT.replace("ROOT", repr(ROOT))],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout.splitlines()
    assert "BAD_MODULES []" in out, res.stdout
    assert "RCS [0, 0]" in out, res.stdout
    assert int(next(l for l in out if l.startswith("LOOPS")).split()[1]) > 0
