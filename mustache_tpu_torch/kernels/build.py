"""Build-at-first-use for the port's native code.

Each CUDA source ``csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` into ``lib<name>_<hash>.so`` in the build cache
(:func:`build_dir`); a C++ host source (the band fill, normalize,
``.hic`` block decoder, HDF5 chunk decoder and cooler pixel sift of
``io/native``) is compiled the same way by
``g++``. The hash covers the
source and the flags, so an edited source rebuilds and a stale library
is never loaded; nothing depends on the
host it was built on (no ``-march=native``). Libraries are loaded with
``ctypes``. For CUDA, ptxas reports each kernel's registers, shared
memory and spills (``-Xptxas -v``); the compiler's report is kept beside
the library and read with :func:`build_log`. Nothing here runs at import
time; a missing compiler or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
PACKAGE_BUILD_DIR = Path(__file__).resolve().parent / "_build"
BUILD_DIR_ENV = "MUSTACHE_TPU_TORCH_BUILD_DIR"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
GXX_LIBS = ("-lpthread",)
# libraries one source links beside GXX_LIBS: the .hic and HDF5 chunk
# decoders' zlib, by its runtime name (no development symlink needed)
SOURCE_LIBS = {"hic_decode.cpp": ("-l:libz.so.1",),
               "h5_chunks.cpp": ("-l:libz.so.1",)}

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source at first use")
    return found


def gxx() -> str:
    """Path of the host C++ compiler: $CXX, then g++ on $PATH."""
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found is None:
        raise RuntimeError("g++ not found (set CXX): the port's native host "
                           "band fill is built from source at first use")
    return found


def _writable(path: Path) -> bool:
    """``path`` exists as a writable directory, or can be made one."""
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError:
        return False
    return os.access(path, os.W_OK | os.X_OK)


def build_dir() -> Path:
    """The build cache: ``$MUSTACHE_TPU_TORCH_BUILD_DIR`` when set (used as
    given, made if missing); else the package's ``kernels/_build`` when it
    can be written; else ``~/.cache/mustache_tpu_torch/build`` (a
    read-only install, as the JAX package's compile cache falls back in
    ``mustache_tpu/runtime.py``). Raises when no candidate can be
    written."""
    env = os.environ.get(BUILD_DIR_ENV)
    if env:
        return Path(env).expanduser()
    for cand in (PACKAGE_BUILD_DIR,
                 Path.home() / ".cache" / "mustache_tpu_torch" / "build"):
        if _writable(cand):
            return cand
    raise RuntimeError(
        f"no writable build directory: set {BUILD_DIR_ENV} (tried "
        f"{PACKAGE_BUILD_DIR} and ~/.cache/mustache_tpu_torch/build)")


def _source(name: str, src: Path | None) -> Path:
    return src if src is not None else CSRC / f"{name}.cu"


def _libs(src: Path) -> tuple[str, ...]:
    return GXX_LIBS + SOURCE_LIBS.get(src.name, ())


def _command(src: Path, out: str) -> list[str]:
    if src.suffix == ".cu":
        return [nvcc(), *NVCC_FLAGS, "-o", out, str(src)]
    return [gxx(), *GXX_FLAGS, "-o", out, str(src), *_libs(src)]


def _flags(src: Path) -> tuple[str, ...]:
    return NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS + _libs(src)


def library_path(name: str, src: Path | None = None) -> Path:
    src = _source(name, src)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(_flags(src)).encode()).hexdigest()
    return build_dir() / f"lib{name}_{digest[:16]}.so"


def _write_atomic(path: Path, text: str) -> None:
    fd, tmp = tempfile.mkstemp(suffix=path.suffix, dir=path.parent)
    with os.fdopen(fd, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)


def build(name: str, src: Path | None = None) -> Path:
    """Compile ``src`` (default ``csrc/<name>.cu``) unless its hashed
    library exists. Processes that share the build directory (several
    engine processes on one host) take an exclusive file lock for the
    build, so one compiles and the others wait and load its library; the
    report and the library are written under temporary names and renamed
    into place, so an interrupted build never leaves a partial file."""
    src = _source(name, src)
    out = library_path(name, src)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():                 # built while this one waited
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            res = subprocess.run(_command(src, tmp), capture_output=True,
                                 text=True, timeout=600)
            if res.returncode != 0:
                raise RuntimeError(f"build of {name} failed "
                                   f"({res.returncode}):\n"
                                   + res.stderr[-4000:])
            _write_atomic(out.with_suffix(".log"), res.stdout + res.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def build_log(name: str, src: Path | None = None) -> str:
    """The compiler's output (for CUDA, ptxas's report) from the build of
    ``name``."""
    return build(name, src).with_suffix(".log").read_text()


def load(name: str, bind, src: Path | None = None) -> ctypes.CDLL:
    """Build (if needed) and load ``src`` (default ``csrc/<name>.cu``);
    ``bind(lib)`` sets the ctypes signatures of its entry points (once per
    process)."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, src)))
            bind(lib)
            _LOADED[name] = lib
        return lib
