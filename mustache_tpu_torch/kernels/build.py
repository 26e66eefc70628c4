"""Build-at-first-use for the port's native code.

Each CUDA source ``csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` into ``_build/lib<name>_<hash>.so``; a C++ host
source (the band fill of ``io/native``) is compiled the same way by
``g++``. The hash covers the source and the flags, so an edited source
rebuilds and a stale library is never loaded; nothing depends on the
host it was built on (no ``-march=native``). Libraries are loaded with
``ctypes``. For CUDA, ptxas reports each kernel's registers, shared
memory and spills (``-Xptxas -v``); the compiler's report is kept beside
the library and read with :func:`build_log`. Nothing here runs at import
time; a missing compiler or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
GXX_LIBS = ("-lpthread",)

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


def _source(name: str, src: Path | None) -> Path:
    return src if src is not None else CSRC / f"{name}.cu"


def _command(src: Path, out: str) -> list[str]:
    if src.suffix == ".cu":
        return [nvcc(), *NVCC_FLAGS, "-o", out, str(src)]
    return [gxx(), *GXX_FLAGS, "-o", out, str(src), *GXX_LIBS]


def _flags(src: Path) -> tuple[str, ...]:
    return NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS + GXX_LIBS


def library_path(name: str, src: Path | None = None) -> Path:
    src = _source(name, src)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(_flags(src)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(name: str, src: Path | None = None) -> Path:
    """Compile ``src`` (default ``csrc/<name>.cu``) unless its hashed
    library exists. The library is written under a temporary name and
    renamed into place, so a concurrent or interrupted build never leaves
    a partial file."""
    src = _source(name, src)
    out = library_path(name, src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(_command(src, tmp), capture_output=True,
                             text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"build of {name} failed ({res.returncode}):\n"
                               + res.stderr[-4000:])
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
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
