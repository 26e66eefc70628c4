"""Whole runs of the harness on small CPU cells (``conftest.TINY``, each
held to the limits of the real cell of its kind), skipping only the look
for a card: a sound run comes out correct; the control (the reference in
TF32 in the program's place) and each fault planted under the timed path
come out not correct."""

import io
import json
import time

import pytest
import torch

from benchmark.harness import cell


def run(root, name, seed=7, trace=False):
    out, err = io.StringIO(), io.StringIO()
    rc = cell.run(name, seed, 0.5, trace, t_start=time.perf_counter(),
                  device="cpu", root=root, out=out, err=err)
    assert rc == 0, err.getvalue()
    lines = err.getvalue().strip().splitlines()
    assert lines[-1].startswith("check failed_calls")
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["tiny.detect", "tiny.diff", "tiny.cli"])
def test_a_sound_run_is_correct(tiny_root, name):
    res = run(tiny_root, name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"Mb_per_s", "setup_s"} <= set(res["metrics"])


def test_a_traced_run_reads_its_layers(tiny_root):
    res = run(tiny_root, "tiny.detect", trace=True)
    assert res["correct"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name,kind", [("tiny.detect", "detect"),
                                       ("tiny.diff", "diff"),
                                       ("tiny.cli", "cli_hic")])
def test_the_control_is_not_correct(tiny_root, monkeypatch, name, kind):
    import importlib

    mod = importlib.import_module(f"benchmark.kinds.{kind}")
    monkeypatch.setattr(mod.Work, "call", lambda self: self.reference(
        self.device, torch.float32, True))
    res = run(tiny_root, name, seed=11)
    assert not res["correct"], res["checks"]


def _answer_altered(finish_block):
    def fn(*a, **k):
        return [[r[0], r[1], 2 * r[2], r[3]] for r in finish_block(*a, **k)]
    return fn


def _half_left_out(finish_block):
    def fn(out, *, block_index, **k):
        rows = finish_block(out, block_index=block_index, **k)
        return rows if block_index % 2 else []
    return fn


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out",
                                   "state_unchanged"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    from mustache_tpu_torch import pipeline

    if fault == "state_unchanged":
        # the normalize hands its input on unchanged (the raw counts)
        bands = pipeline.normalized_bands
        monkeypatch.setattr(pipeline, "normalized_bands",
                            lambda *a, normalize, **k: bands(
                                *a, normalize=False, **k))
    else:
        wrap = {"answer_altered": _answer_altered,
                "half_left_out": _half_left_out}[fault]
        monkeypatch.setattr(pipeline, "finish_block",
                            wrap(pipeline.finish_block))
    res = run(tiny_root, "tiny.detect", seed=13)
    assert not res["correct"], res["checks"]
