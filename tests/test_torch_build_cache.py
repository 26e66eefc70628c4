"""Where the port's build cache lives (``kernels/build.py::build_dir``): an
environment override first, then the package's own ``kernels/_build``
when it can be written, then ``~/.cache/mustache_tpu_torch/build`` (a
read-only install). No compiler is needed: only the path is chosen here.
A directory under a regular file cannot be made, even by root, so that
stands in for an unwritable install."""

from pathlib import Path

import pytest

from mustache_tpu_torch.kernels import build


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
