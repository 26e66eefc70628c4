"""The port's compile check and multi-device dryrun (``mustache_tpu_torch.
dryrun``, the counterparts of ``__graft_entry__.py``) on the CPU: the
detector through the dense runner, the single-map pipeline through the
replicate placement and the differential one through both, on a mesh of
four ``"cpu"`` entries, each held to the unsharded run. The production
geometry (10,096 bins of 2000^2 blocks at d_px 400, both placements) is
too slow for the plain path on the CPU; ``chip_smoke.py`` phase 10 runs
it on the card."""

import numpy as np
import pytest
import torch

from mustache_tpu_torch import dryrun
import torch_port_cases  # noqa: F401  (one torch thread per worker)


def test_entry_runs_one_block():
    fn, args = dryrun.entry(device="cpu")
    out = fn(*args)
    assert out["cand_x"].shape == (512,)
    assert int(out["nz_count"]) > 0 and int(out["n_tested"]) > 0
    assert args[0].device == torch.device("cpu")


def test_dryrun_multichip_on_four_cpu_entries(capsys):
    report = dryrun.dryrun_multichip(4, ["cpu"] * 4, production=False)
    out = capsys.readouterr().out
    assert "dense-runner mesh={'block': 2, 'row': 2}" in out
    assert "row split == the {'block': 4, 'row': 1} mesh" in out
    assert "detector OK" in out and "pipeline OK" in out
    assert "diff OK" in out and "production geometry: not run" in out
    assert report["mesh"] == {"block": 4, "row": 1}
    assert report["dense_mesh"] == {"block": 2, "row": 2}
    assert len(report["dense_held_row2"]) == 4
    assert report["pipeline_rows"] > 0 and report["diff_rows"] > 0
    assert 0 <= report["diff_rowshard_q_dist"] < 5e-3
    assert np.isfinite(report["diff_rowshard_q_dist"])


@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (2, (2, 1)), (3, (3, 1)),
                                     (4, (2, 2)), (6, (3, 2)), (8, (4, 2))])
def test_dense_mesh_is_the_jax_dryruns(n, shape):
    """The dense runner's mesh splits rows over a pair only where the JAX
    dryrun does: an even count of at least four entries."""
    assert dryrun.dense_mesh_shape(n) == shape
