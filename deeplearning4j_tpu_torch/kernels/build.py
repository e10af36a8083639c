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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

# every source under csrc/, in the order the kernels were ported
SOURCES = ("lstm_seq_infer", "lstm_seq_bwd", "gru_seq", "gru_seq_bwd",
           "rnn_step", "flash_attn_fwd", "flash_attn_bwd", "probe_matmul",
           "fused_bottleneck")

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


def _entry(name: str, entry: str, args, stream: bool):
    """``entry`` of the loaded ``csrc/<name>.cu``, its argument types
    declared from ``args`` on the first call (ctypes would cut 64-bit
    pointers otherwise): tensors (None for a null pointer) go as pointers,
    ints as int, floats as float, then a stream where ``stream``."""
    lib = load(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_float if isinstance(a, float) else
                       ctypes.c_int if isinstance(a, int) else
                       ctypes.c_void_p for a in args] + (
                           [ctypes.c_void_p] if stream else [])
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib, fn


def _error(lib, name: str, what: str, rc: int) -> RuntimeError:
    msg = getattr(lib, f"{name}_error_string")(rc).decode() if rc > 0 else ""
    return RuntimeError(f"{what} failed: {msg} ({rc})")


def call(name: str, entry: str, what: str, args, device) -> None:
    """Launch ``entry(*args, stream)`` of ``csrc/<name>.cu`` on the current
    stream of ``device``. A non-zero return code raises RuntimeError, with
    the runtime's message where the code is a cudaError_t."""
    lib, fn = _entry(name, entry, args, stream=True)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args), stream)
    if rc != 0:
        raise _error(lib, name, f"{what} launch", rc)


def query(name: str, entry: str, what: str, args, device) -> int:
    """``entry(*args)`` of ``csrc/<name>.cu``, a host-side question that
    launches nothing, asked on ``device`` (a tensor goes as its pointer: a
    CPU tensor takes an answer): its return code when 0 or
    negative (the source's own codes); a positive one, a cudaError_t,
    raises RuntimeError."""
    lib, fn = _entry(name, entry, args, stream=False)
    with torch.cuda.device(device):
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args))
    if rc > 0:
        raise _error(lib, name, what, rc)
    return rc
