"""Where the port's build cache lives (``kernels/build.py::build_dir``): an
environment override first, then the package's own ``kernels/_build``
when it can be written, then ``~/.cache/mustache_tpu_torch/build`` (a
read-only install). No compiler is needed: only the path is chosen here.
A directory under a regular file cannot be made, even by root, so that
stands in for an unwritable install."""

from pathlib import Path

import pytest

from mustache_tpu_torch.kernels import build
import torch_port_cases  # noqa: F401  (one torch thread per worker)


@pytest.fixture
def paths(tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("")
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv(build.BUILD_DIR_ENV, raising=False)
    return dict(pkg=tmp_path / "pkg" / "_build", blocked=blocker / "_build",
                home=home, tmp=tmp_path)


def test_package_dir_when_writable(paths, monkeypatch):
    monkeypatch.setattr(build, "PACKAGE_BUILD_DIR", paths["pkg"])
    assert build.build_dir() == paths["pkg"] and paths["pkg"].is_dir()
    # the hashed library names live there
    assert build.library_path("fused_ladder").parent == paths["pkg"]


def test_user_cache_when_the_package_is_read_only(paths, monkeypatch):
    monkeypatch.setattr(build, "PACKAGE_BUILD_DIR", paths["blocked"])
    want = paths["home"] / ".cache" / "mustache_tpu_torch" / "build"
    assert build.build_dir() == want and want.is_dir()


def test_environment_override_comes_first(paths, monkeypatch):
    monkeypatch.setattr(build, "PACKAGE_BUILD_DIR", paths["pkg"])
    monkeypatch.setenv(build.BUILD_DIR_ENV, str(paths["tmp"] / "mine"))
    assert build.build_dir() == Path(paths["tmp"] / "mine")
    assert not paths["pkg"].exists()


def test_no_writable_directory_raises(paths, monkeypatch):
    monkeypatch.setattr(build, "PACKAGE_BUILD_DIR", paths["blocked"])
    monkeypatch.setenv("HOME", str(paths["tmp"] / "file"))
    with pytest.raises(RuntimeError, match=build.BUILD_DIR_ENV):
        build.build_dir()


def test_concurrent_builds_compile_once(tmp_path, monkeypatch):
    """Builders that share the cache (several engine processes on one
    host, here threads with their own lock descriptors) compile a source
    once: the others wait on the file lock and get the same library; no
    temporary file is left."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    src = tmp_path / "tiny.cpp"
    src.write_text('extern "C" int mtt_tiny() { return 7; }\n')
    monkeypatch.setenv(build.BUILD_DIR_ENV, str(tmp_path / "cache"))
    calls = []
    real = build._command

    def counting(s, out):
        calls.append(out)
        return real(s, out)

    monkeypatch.setattr(build, "_command", counting)
    with ThreadPoolExecutor(4) as ex:
        got = list(ex.map(lambda _: build.build("tiny", src), range(4)))
    assert len(set(got)) == 1 and len(calls) == 1
    assert ctypes.CDLL(str(got[0])).mtt_tiny() == 7
    left = sorted(p.name for p in (tmp_path / "cache").iterdir())
    assert left == sorted([got[0].name, got[0].with_suffix(".log").name,
                           got[0].with_suffix(".lock").name])
