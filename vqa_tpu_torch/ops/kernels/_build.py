"""Build, load and launch the port's CUDA kernels.

At first use every ``vqa_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a``, one ``nvcc`` per source, all started together, and linked into
one shared library with a plain C interface, under ``build/kernels/`` at the
repository root, named by a hash of the sources and flags, and loaded with
``ctypes``. Each C entry point launches on the
stream it is given, allocates nothing, and returns ``cudaGetLastError()``;
:func:`launch` raises when that is not 0 and counts the launch in
:data:`LAUNCHES`. There is no fallback: a missing ``nvcc`` or a failed
build raises :class:`KernelBuildError` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# launches of each kernel since the last reset, by kernel name; a run reads
# them to show that its path went through the kernels
LAUNCHES = {"gru_v2": 0, "dequant_matmul": 0, "pool_int8": 0,
            "vocab_topk_lse": 0, "decode_att_fwd": 0, "decode_att_bwd": 0,
            "decode_att_dvp": 0, "int8_matmul_dequant": 0,
            "int8_matmul_dequant_3d": 0, "gcn_chain_fused": 0,
            "fused_multiply_attention_pool": 0, "gru_last_state": 0,
            "gru_last_state_v3": 0}

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_ENTRY_POINTS = {
    # x_q, scale, w_nk, out, M, K, N, stream
    "dequant_matmul_forward": (_P, _P, _P, _P, _I, _I, _I, _P),
    # w, x_q, out, B, N, D, stream
    "pool_int8_forward": (_P, _P, _P, _I, _I, _I, _P),
    # h, w, b, part_v, part_i, part_ms, vals, idx, lse, R, H, V, k,
    # tiles_per_split, grid, stream
    "vocab_topk_lse_forward": (_P,) * 9 + (_I,) * 6 + (_P,),
    # vp, pool, w, qp, k, att, att_v, mask, seed, t, B, objs, H, D,
    # att_scale, thresh, act, pool_kind, stream
    "decode_att_fwd": (_P,) * 8 + (_U, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                                   _P),
    # vp, pool, w, att, g_attv, d_qp, m, dl, seed, t, B, objs, H, D, thresh,
    # act, pool_kind, stream
    "decode_att_bwd": (_P,) * 8 + (_U, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # dls, qps, k, out, seed, T, B, objs, H, att_scale, thresh, act,
    # out_kind, nb, gc, tc, stages, grid, stream
    "decode_att_dvp": (_P,) * 4 + (_U, _I, _I, _I, _I, _F) + (_I,) * 8 + (_P,),
    # x_q, x_scale, w_nk, w_scale, bias, out, M, K, N, xs_bf16, out_bf16,
    # relu, stream
    "int8_matmul_forward": (_P,) * 6 + (_I,) * 6 + (_P,),
    # out_self, proj, alpha, graph, bias, out, B, D, L, is_bf16, groups,
    # tiles_per_group, stages, grid, stream
    "gcn_chain_forward": (_P,) * 6 + (_I,) * 8 + (_P,),
    # v, q, wv_t, wq_t, bv, bq, wl, bl, qp (scratch), pooled, att, B, N,
    # Dv, H, Hq, vec_bf16, images, cluster, passes, stages, grid, stream
    # (two launches, one count)
    "fused_attention_forward": (_P,) * 11 + (_I,) * 11 + (_P,),
    # &fixed, &per_stage, &smem_limit, &sms (no stream, launches nothing)
    "fused_attention_query": (_P,) * 4,
    # xi, w, bh, out, h16 [2, B, H] or null, B, T, H, cluster, stream
    "gru_last_state_forward": (_P,) * 5 + (_I,) * 4 + (_P,),
    # emb [B, T, E8], wi [3H, E8], bi, w, bh, out, h16, B, T, H, E, E8,
    # cluster, stream
    "gru_last_state_v3_forward": (_P,) * 7 + (_I,) * 6 + (_P,),
    # H, v3, &resident, &capacity[5], &sms (no stream, launches nothing)
    "gru_query": (_I, _I, _P, _P, _P),
}

_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """The kernel library could not be built or loaded."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels can only be built on a machine with the "
        "CUDA toolkit")


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``build/kernels/`` unless the library for
    these exact sources and flags is already there; returns its path. Each
    source compiles in its own ``nvcc`` process, all at once, and one more
    links the objects."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in CSRC.iterdir() if p.is_file()):
        digest.update(src.name.encode() + src.read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"libvqa_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _find_nvcc()
    obj_dir = BUILD_DIR / f"obj_{tag}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    objs = [obj_dir / f"{src.stem}.o" for src in sources]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(sources, objs))]
    failures = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}): "
                            f"{' '.join(cmd)}\n{err}")
    if failures:
        raise KernelBuildError("\n".join(failures))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib_path)   # atomic: no process loads a half-written file
    shutil.rmtree(obj_dir, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.vqa_kernels_error_string.argtypes = (ctypes.c_int,)
        lib.vqa_kernels_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def holds(rules, *args, **kwargs) -> bool:
    """Whether a kernel's shape and type ``rules`` accept ``args``: the
    rules raise ValueError or TypeError, and the wrapper calls them before
    it builds, so a module's ``supports`` and its wrapper's refusals are
    the same test."""
    try:
        rules(*args, **kwargs)
    except (ValueError, TypeError):
        return False
    return True


def check_dtype(kernel: str, name: str, got: torch.dtype,
                want: torch.dtype) -> None:
    """Raise TypeError unless operand ``name`` has the dtype ``want``."""
    if got != want:
        raise TypeError(f"{kernel}: {name} must be {want}, got {got}")


def check_operand(kernel: str, name: str, t: torch.Tensor,
                  dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    that needs no gradient (the kernels define no backward)."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, not {device}")
    check_dtype(kernel, name, t.dtype, dtype)
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{kernel}: the kernel has no backward; call it "
                           "under torch.no_grad() or torch.inference_mode()")


def query(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry``, which launches nothing, on ``device``
    with ``args`` (results come back through the pointers among them), and
    raise on a CUDA error. Counts nothing."""
    lib = library()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args)
    if rc != 0:
        msg = lib.vqa_kernels_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} in {entry}: {msg}")


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream with
    ``args`` (tensors become their data pointers), raise on a CUDA error,
    and count one launch of ``kernel``."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args]
        rc = getattr(lib, entry)(*cargs, stream)
    if rc != 0:
        msg = lib.vqa_kernels_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch: {msg}")
    LAUNCHES[kernel] += 1
