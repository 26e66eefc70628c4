"""The port never imports JAX: checked in a fresh interpreter (this test
process has JAX loaded already through conftest.py)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
sys.path[:0] = [ROOT, ROOT + "/tests"]
import numpy as np
import mustache_tpu_torch as mt
from mustache_tpu_torch.kernels import build, fused_ladder  # noqa: F401
from synthetic import synthetic_hic
x, y, v, _ = synthetic_hic(400, 60, seed=3, n_loops=6)
cfg = mt.DetectionConfig(resolution=5000, distance_bp=300_000, pt=0.1, st=0.8)
loops = mt.detect_loops_coo(x, y, v, cfg, device="cpu")
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "mustache_tpu.")) or m == "mustache_tpu")
print("LOOPS", len(loops))
print("JAX_MODULES", bad)
"""


def test_port_imports_and_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT.replace("ROOT", repr(ROOT))],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout.splitlines()
    assert "JAX_MODULES []" in out, res.stdout
    assert int(next(l for l in out if l.startswith("LOOPS")).split()[1]) > 0
