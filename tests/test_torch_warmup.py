"""``mustache_tpu_torch.warmup`` on the CPU: it builds the g++ libraries
(band fill, host normalize, .hic decoder, HDF5 chunk decoder, cooler
pixel sift) into the
build cache and loads
them, never calls nvcc (the fused kernel is built only for the card),
prints each build's seconds, and is what the CLIs' ``--engine-warmup``
(``cli.warm``) runs."""

import pytest
import torch

from mustache_tpu_torch import cli, warmup
from mustache_tpu_torch.kernels import build
from mustache_tpu_torch.runlog import RunLog
import torch_port_cases  # noqa: F401  (one torch thread per worker)

GXX_LIBS = {"band_fill", "normalize", "hic_decode", "h5_chunks",
            "cool_select"}


@pytest.fixture
def no_nvcc(monkeypatch):
    def refuse():
        raise AssertionError("nvcc called for a CPU warmup")
    monkeypatch.setattr(build, "nvcc", refuse)


def test_warm_cpu_builds_the_gxx_libraries(no_nvcc):
    assert set(warmup.libraries(torch.device("cpu"))) == GXX_LIBS
    assert set(warmup.libraries(torch.device("cuda"))) == \
        GXX_LIBS | {"fused_ladder"}
    lines = []
    seconds = warmup.warm(torch.device("cpu"), log=lines.append)
    assert set(seconds) == GXX_LIBS and all(s >= 0 for s in seconds.values())
    for name, (src, _) in warmup.libraries(torch.device("cpu")).items():
        assert build.library_path(name, src).exists()
        assert name in build._LOADED
    assert sorted(ln.split(":")[0] for ln in lines) == sorted(GXX_LIBS)


def test_main_cpu(no_nvcc, capsys, tmp_path):
    sizes = tmp_path / "sizes.txt"
    sizes.write_text("chr1 1000000\nchr2 800000\n")
    assert warmup.main(["-r", "5kb", "--sizes-file", str(sizes), "--diff",
                        "--engine-platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"2 chromosomes of {sizes} at 5000 bp, differential on cpu" in out
    assert "nothing compiles per shape" in out
    for name in GXX_LIBS:
        assert f"[warmup] {name}: " in out
    assert "[warmup] 5 libraries ready" in out


def test_cli_warm_runs_warmup(monkeypatch):
    calls = []
    monkeypatch.setattr(warmup, "warm", lambda dev, log=None:
                        calls.append(dev) or {})
    log = RunLog(quiet=True)
    cli.warm(torch.device("cpu"), log)
    assert calls == [torch.device("cpu")]
    assert [e["event"] for e in log.events] == ["warmup"]


def test_main_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        warmup.main(["-r", "5kb"])
