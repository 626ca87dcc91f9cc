"""Build and bind the port's hand-written CUDA kernels (``csrc/``).

At first use the sources are compiled with ``nvcc`` for ``sm_90a``, one
process per ``.cu`` file, all started together, then linked into one
shared library with a plain C interface.  The library lives under
``<repo>/build/kernels/<hash>/``, keyed by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads at once.
It is loaded with ``ctypes``: pointers come from ``Tensor.data_ptr()``
and the stream from ``torch.cuda.current_stream().cuda_stream``, each
passed as ``c_void_p``.  Every C entry point returns
``cudaGetLastError()`` after its launch; ``check`` raises on non-zero.

``LAUNCHES`` counts, per kernel, the launches its wrapper made.  A
wrapper adds one right after a launch that returned 0 and nowhere else,
so a run can show that a path really went through the kernels.

Nothing here runs at import: the CPU tests import every module, and a
CPU-only host has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bbox.cu", "cascade.cu", "flash_attn.cu", "gather_pip.cu",
           "pip.cu", "segment.cu")
HEADERS = ("pip.cuh",)
# -fmad=false: no FMA contraction, so products round as numpy/XLA round
# them (the crossing test and the quantize must be bit-equal).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"

LAUNCHES = {"assign_cascade": 0, "bbox_count_select": 0, "bbox_mask": 0,
            "crossings_candidates": 0, "crossings_gathered": 0,
            "crossings_one": 0, "flash_attn_bhsd": 0,
            "segment_reduce_sorted": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_N = ctypes.c_int64
_F = ctypes.c_float
# C signature of every entry point (restype c_int = cudaGetLastError()).
_SIGNATURES = {
    "repro_assign_cascade": [_P] * 15 + [_N] + [_I] * 8 + [_P],
    "repro_crossings_candidates": [_P] * 5 + [_N, _I, _P],
    "repro_crossings_gathered": [_P] * 3 + [_N, _I, _P],
    "repro_crossings_one": [_P] * 3 + [_N, _I, _P],
    "repro_bbox_mask": [_P] * 3 + [_N, _I, _P],
    "repro_bbox_count_select": [_P] * 4 + [_N, _I, _P],
    "repro_segment_reduce_sorted": [_P] * 8 + [_N, _I, _P],
    "repro_segment_tile_rows": [],
    "repro_flash_attn_bhsd": [_P] * 4 + [_I] * 5 + [_F, _P],
}

_lock = threading.Lock()
_lib = None
BUILD_INFO: dict = {}     # path, seconds, cached, log — set by load()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not path:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA "
                           "kernels cannot be built here")
    return path


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands together; raise with their output if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "\n".join(f"$ {' '.join(c)}\n{o}" for c, o in zip(cmds, outs))
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"CUDA kernel build failed:\n{log}")
    return log


def build() -> Path:
    """Compile and link the library if this source hash has none yet;
    return its path.  The result is renamed into place whole, so a
    concurrent or interrupted build never leaves a half-written .so."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        BUILD_INFO.update(path=str(lib_path), seconds=0.0, cached=True,
                          log=(out_dir / "build.log").read_text()
                          if (out_dir / "build.log").exists() else "")
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, s.replace(".cu", ".o")) for s in SOURCES]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                         str(CSRC / s), "-o", o]
                        for s, o in zip(SOURCES, objs)])
        tmp_lib = os.path.join(tmp, LIB_NAME)
        log += _run_all([[nvcc, "-shared", "-o", tmp_lib, *objs]])
        os.replace(tmp_lib, lib_path)
    (out_dir / "build.log").write_text(log)
    BUILD_INFO.update(path=str(lib_path),
                      seconds=time.perf_counter() - t0, cached=False,
                      log=log)
    return lib_path


def load():
    """The bound library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error; else count the launch."""
    if status != 0:
        msg = load().repro_cuda_error_string(status).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error "
                           f"{status} ({msg})")
    LAUNCHES[kernel] += 1


def require(t, name: str, dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    whose shape matches ``shape`` (None = any size on that axis)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_aligned(t, name: str, nbytes: int) -> None:
    """Raise unless ``t``'s data is ``nbytes``-aligned (the kernels load
    points as float2 and edges / boxes as float4)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name} must be {nbytes}-byte aligned (vector "
                         f"loads)")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def ptr_or_null(t) -> ctypes.c_void_p:
    """``ptr(t)``, or a null pointer for ``None``."""
    return ctypes.c_void_p() if t is None else ptr(t)


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
