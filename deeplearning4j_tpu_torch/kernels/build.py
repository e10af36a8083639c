"""Build the port's CUDA C++ sources at first use and load them.

Each source under ``csrc/`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library, loaded with ctypes. The
library lands in ``_build/<name>-<hash>/`` inside the package (listed in
.gitignore), keyed by a hash of the source, the shared ``*.cuh`` headers
and the flags, so an edited source or header rebuilds and an unchanged
one is reused. Nothing is built when a module is imported: the first
launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

# every source under csrc/, in the order the kernels were ported
SOURCES = ("lstm_seq_infer", "lstm_seq_bwd", "gru_seq", "gru_seq_bwd")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives (keyed by the
    source, every header under ``csrc/`` and the flags)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}" / f"lib{name}.so"


def build_log(name: str) -> str:
    """The compiler's output for the current build of ``name`` (register
    and shared-memory use from ``-Xptxas -v``), or "" before a build."""
    log = library_path(name).with_name("build.log")
    return log.read_text() if log.exists() else ""


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu`` unless its library exists; returns
    (process, temporary output, output) or None."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    out.with_name("build.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name} ({proc.returncode}):\n{log}")
    os.replace(tmp, out)


def load_all(names) -> list[ctypes.CDLL]:
    """The loaded libraries of several sources, the missing ones built
    together: one nvcc per source, all started at once."""
    with _lock:
        todo = [n for n in names if n not in _loaded]
        started = {n: _start(n) for n in todo}
        try:
            for n, st in started.items():
                if st is not None:
                    _finish(n, st)
        finally:
            for st in started.values():   # never leave a compiler behind
                if st is not None and st[0].poll() is None:
                    st[0].kill()
                    st[0].wait()
        for n in todo:
            _loaded[n] = ctypes.CDLL(str(library_path(n)))
        return [_loaded[n] for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return load_all([name])[0]
