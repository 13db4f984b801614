"""ctypes bindings for the port's host library (``csrc/host/vqa_native.cpp``),
the counterpart of ``vqa_tpu/native.py``.

At first use the library is compiled by ``g++`` with the flags of
``native/Makefile`` into ``build/host/`` at the repository root, named by a
hash of the source and the flags, and loaded with ``ctypes``; nothing is
written anywhere else. ``-march=native`` builds it for the machine that
builds it, so a ``build/`` directory carried to another machine is not to
be reused. The C ABI keeps the binding free of pybind11 and of torch, so
the data layer stays numpy only.

Every entry point gives the same bytes as numpy, and the numpy routes stay
only where the JAX package keeps them: no library (no ``g++``, a failed
build), or a source that is not C-contiguous. :data:`ROUTES` counts the
calls that took each route, so a run can show which one its feed took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "host" / "vqa_native.cpp"
BUILD_DIR = _PKG.parent / "build" / "host"
# native/Makefile's CXXFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-pthread")

# calls of this module's entry points by the route they took since the last
# reset: "native" (the library ran) or "fallback" (numpy or Python gave the
# result, or the caller must)
ROUTES = {"native": 0, "fallback": 0}

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


class HostBuildError(RuntimeError):
    """The host library could not be built."""


def reset_routes() -> None:
    with _lock:
        for name in ROUTES:
            ROUTES[name] = 0


def _count(route: str) -> None:
    with _lock:
        ROUTES[route] += 1


def build() -> Path:
    """Compile the library into ``build/host/`` unless the one for this
    exact source and these flags is there; returns its path. Raises
    :class:`HostBuildError` without ``g++`` or with the compiler's output."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    lib_path = BUILD_DIR / f"libvqa_native_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        raise HostBuildError("g++ not found on PATH: the host library cannot "
                             "be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-shared", "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired as e:
        raise HostBuildError(f"{' '.join(cmd)} timed out") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise HostBuildError(
            f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib_path)   # atomic: no process loads a half-written file
    return lib_path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (HostBuildError, OSError):
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        signatures = {
            "gather_rows_bytes": [u8p, i64p, ctypes.c_int64, ctypes.c_int64,
                                  u8p, ctypes.c_int],
            "gather_rows_f16_to_f32": [u16p, i64p, ctypes.c_int64,
                                       ctypes.c_int64, f32p, ctypes.c_int],
            "spatial_relation_graphs": [f64p, ctypes.c_int64, ctypes.c_int64,
                                        f64p, f64p, i8p, ctypes.c_int],
            "densify_answers": [i64p, i32p, i32p, ctypes.c_int64,
                                ctypes.c_int64, f32p, ctypes.c_int],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library built and loaded."""
    return _load() is not None


def threads() -> int:
    """Worker threads of the native gathers and scatters:
    ``VQA_NATIVE_THREADS`` (the JAX package's variable) where set, else up
    to 32 (a thread moves a few GB/s of memcpy-bound rows, so fewer would
    cap the int8 feed below what one card consumes)."""
    env = os.environ.get("VQA_NATIVE_THREADS")
    if env:
        return max(1, int(env))
    return min(32, os.cpu_count() or 1)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def gather_rows(src: np.ndarray, rows: np.ndarray,
                widen_f16: bool = True) -> np.ndarray:
    """``src[rows]`` as a fresh contiguous array, gathered by the library's
    threads; float16 sources widen to float32 when ``widen_f16``. ``src``
    [N, ...] may be a memory map. Falls back to numpy fancy indexing without
    the library or for a source that is not C-contiguous."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    lib = _load()
    if lib is None or not src.flags["C_CONTIGUOUS"]:
        _count("fallback")
        out = np.asarray(src[rows])
        return out.astype(np.float32) if (widen_f16 and
                                          out.dtype == np.float16) else out
    n = src.shape[0]
    if rows.size and (rows.min() < -n or rows.max() >= n):
        raise IndexError(f"row index out of range for {n} rows")
    rows = np.where(rows < 0, rows + n, rows)   # numpy's negative indices
    _count("native")
    row_shape = src.shape[1:]
    row_elems = int(np.prod(row_shape))
    if src.dtype == np.float16 and widen_f16:
        out = np.empty((len(rows),) + row_shape, np.float32)
        lib.gather_rows_f16_to_f32(
            _ptr(src, ctypes.c_uint16), _ptr(rows, ctypes.c_int64), len(rows),
            row_elems, _ptr(out, ctypes.c_float), threads())
        return out
    out = np.empty((len(rows),) + row_shape, src.dtype)
    lib.gather_rows_bytes(
        _ptr(src, ctypes.c_uint8), _ptr(rows, ctypes.c_int64), len(rows),
        row_elems * src.dtype.itemsize, _ptr(out, ctypes.c_uint8), threads())
    return out


def spatial_relation_graphs_native(bbox: np.ndarray, w: np.ndarray,
                                   h: np.ndarray) -> Optional[np.ndarray]:
    """[B, N, N] int8 relation labels of ``bbox`` [B, N, 4] in images of
    widths ``w`` and heights ``h`` [B] (``relation.relation_graphs_batched``'s
    labels); None without the library."""
    lib = _load()
    if lib is None:
        _count("fallback")
        return None
    bbox = np.ascontiguousarray(bbox, np.float64)
    w = np.ascontiguousarray(w, np.float64)
    h = np.ascontiguousarray(h, np.float64)
    if bbox.ndim != 3 or bbox.shape[2] != 4 \
            or w.shape != bbox.shape[:1] or h.shape != bbox.shape[:1]:
        raise ValueError(f"bbox {bbox.shape} must be [B, N, 4] with w "
                         f"{w.shape} and h {h.shape} [B]")
    _count("native")
    B, N, _ = bbox.shape
    out = np.empty((B, N, N), np.int8)
    lib.spatial_relation_graphs(
        _ptr(bbox, ctypes.c_double), B, N, _ptr(w, ctypes.c_double),
        _ptr(h, ctypes.c_double), _ptr(out, ctypes.c_int8), threads())
    return out


def densify_answers_native(ans_dicts, ans_dim: int) -> Optional[np.ndarray]:
    """Dense soft scores min(count, 3) / 3 [len(ans_dicts), ans_dim] f32 from
    {answer index: count} dicts; None without the library."""
    lib = _load()
    if lib is None:
        _count("fallback")
        return None
    offsets = np.zeros(len(ans_dicts) + 1, np.int64)
    idx_list, cnt_list = [], []
    for r, d in enumerate(ans_dicts):
        for k, v in d.items():
            idx_list.append(int(k))
            cnt_list.append(int(v))
        offsets[r + 1] = len(idx_list)
    indices = np.asarray(idx_list, np.int32)
    counts = np.asarray(cnt_list, np.int32)
    if len(indices) == 0:
        indices = np.zeros(1, np.int32)
        counts = np.zeros(1, np.int32)
    elif indices.min() < 0 or indices.max() >= ans_dim:
        raise IndexError(f"answer index out of range for ans_dim {ans_dim}")
    _count("native")
    out = np.empty((len(ans_dicts), ans_dim), np.float32)
    lib.densify_answers(
        _ptr(offsets, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(counts, ctypes.c_int32), len(ans_dicts), ans_dim,
        _ptr(out, ctypes.c_float), threads())
    return out
