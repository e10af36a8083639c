"""Native host loops of the data path: ``etl.cpp`` built at first use and
bound with ctypes.

Counterpart of ``deeplearning4j_tpu/native/__init__.py``, with the port's
own copy of ``etl.cpp`` (the same four entries and arithmetic:
``sg_pairs``, ``csv_parse``, ``hwc_to_chw``, ``resize_hwc_to_chw``). The
library is built with ``g++`` into ``deeplearning4j_tpu_torch/_build/``
(git-ignored) under a name keyed by a hash of the source, as
``kernels/build.py`` does for the CUDA sources; nothing is built when the
module is imported, and nothing is written beside the source. A build
lands under a temporary name and is renamed into place, so processes that
build at once (test workers, forked ETL workers) never load a half-written
file.

Each entry returns None when the library could not be built or loaded, and
every caller then takes its numpy twin (the same math), as in the JAX
package. ``available()`` says whether the library is live and ``load()``
raises with the build's error where it is not: a run that must not go
quietly to numpy (``chip_smoke.py`` on the card) asks ``load()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "etl.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_state = {"lib": None, "tried": False, "error": None}


def library_path() -> Path:
    """Where the library built from ``etl.cpp`` lives (keyed by the
    source and the flags)."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update("\0".join(CXX_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    return BUILD_DIR / f"etl-{tag}" / "libetl.so"


def _build(so: Path):
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.{threading.get_ident()}")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()


def _declare(lib):
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.sg_pairs.restype = ctypes.c_long
    lib.sg_pairs.argtypes = [i32p, i64p, ctypes.c_int64, i32p, i32p, i32p]
    lib.csv_parse.restype = ctypes.c_long
    lib.csv_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, f32p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.hwc_to_chw.restype = None
    lib.hwc_to_chw.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, f32p]
    lib.resize_hwc_to_chw.restype = None
    lib.resize_hwc_to_chw.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_float, f32p]
    return lib


def _load():
    """The loaded library, built on first use; None (with the reason kept
    for ``load()``) where the toolchain is missing or the build fails."""
    with _LOCK:
        if _state["lib"] is not None or _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            _state["lib"] = _declare(ctypes.CDLL(str(so)))
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None)
            if isinstance(detail, bytes):
                detail = detail.decode(errors="replace")
            _state["error"] = f"{type(e).__name__}: {e}" + (
                f"\n{detail}" if detail else "")
        return _state["lib"]


def available() -> bool:
    return _load() is not None


def load():
    """The loaded library; raises RuntimeError with the build's error
    where it could not be built or loaded."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native ETL library ({SRC.name}) did not "
                           f"build or load: {_state['error']}")
    return lib


def sg_pairs_flat(flat, offsets, bs):
    """sg_pairs over the flat token array + sentence offsets directly
    (no per-sentence Python list): the 10M-word-corpus path."""
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(flat, dtype=np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    bs = np.ascontiguousarray(bs, dtype=np.int32)
    if len(flat) == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    cap = int(2 * bs.sum())
    centers = np.empty(cap, np.int32)
    contexts = np.empty(cap, np.int32)
    n = lib.sg_pairs(flat, offsets, len(offsets) - 1, bs, centers,
                     contexts)
    return centers[:n].copy(), contexts[:n].copy()


def sg_pairs(encoded_sentences, bs):
    """Skip-gram pairs across sentences. encoded_sentences: list of int32
    arrays; bs: int32 window draws, concatenated per token. Returns
    (centers, contexts) int32 arrays, or None if the native lib is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    if not encoded_sentences:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    idxs = np.ascontiguousarray(np.concatenate(encoded_sentences),
                                dtype=np.int32)
    offsets = np.zeros(len(encoded_sentences) + 1, np.int64)
    np.cumsum([len(s) for s in encoded_sentences], out=offsets[1:])
    bs = np.ascontiguousarray(bs, dtype=np.int32)
    cap = int(2 * bs.sum())
    centers = np.empty(cap, np.int32)
    contexts = np.empty(cap, np.int32)
    n = lib.sg_pairs(idxs, offsets, len(encoded_sentences), bs, centers,
                     contexts)
    return centers[:n].copy(), contexts[:n].copy()


def csv_parse(text: bytes, delimiter=",") -> np.ndarray | None:
    """Parse a numeric CSV blob -> [rows, cols] float32, or None when the
    native lib is unavailable or the data isn't plain numeric CSV."""
    lib = _load()
    if lib is None:
        return None
    if isinstance(text, str):
        text = text.encode()
    delim = delimiter.encode()[:1]
    cap = max(16, text.count(delim) + text.count(b"\n") + 2)
    out = np.empty(cap, np.float32)
    cols = ctypes.c_int64(0)
    rows = lib.csv_parse(text, len(text), delim, out, cap,
                         ctypes.byref(cols))
    if rows < 0 or cols.value == 0:
        return None
    return out[:rows * cols.value].reshape(rows, cols.value).copy()


def resize_hwc_to_chw(img_u8: np.ndarray, out_h: int, out_w: int,
                      flip_h=False, scale=1.0, shift=0.0):
    """Fused bilinear resize + [H,W,C]u8 -> [C,oh,ow]f32 + affine
    normalize in one native pass, or None when the lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    img_u8 = np.ascontiguousarray(img_u8, dtype=np.uint8)
    if img_u8.ndim == 2:
        img_u8 = img_u8[:, :, None]
    h, w, c = img_u8.shape
    if h == 0 or w == 0 or out_h <= 0 or out_w <= 0:
        return None  # callers fall back to the Python path's clear error
    dst = np.empty((c, int(out_h), int(out_w)), np.float32)
    lib.resize_hwc_to_chw(img_u8, h, w, c, int(out_h), int(out_w),
                          int(bool(flip_h)), float(scale), float(shift),
                          dst)
    return dst


def hwc_to_chw(img_u8: np.ndarray, flip_h=False, scale=1.0, shift=0.0):
    """[H,W,C] uint8 -> [C,H,W] float32 (optionally h-flipped and affine
    scaled), or None when the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    img_u8 = np.ascontiguousarray(img_u8, dtype=np.uint8)
    if img_u8.ndim == 2:
        img_u8 = img_u8[:, :, None]
    h, w, c = img_u8.shape
    dst = np.empty((c, h, w), np.float32)
    lib.hwc_to_chw(img_u8, h, w, c, int(bool(flip_h)), float(scale),
                   float(shift), dst)
    return dst
