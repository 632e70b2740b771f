"""Build and load the hand-written Hopper kernels.

The CUDA sources under ``csrc/`` expose a plain C interface.  At first use
each source is compiled by its own ``nvcc`` (all started together) for
``sm_90a``, the objects are linked into one shared library under
``build/repro_torch_kernels/`` at the repository root, and the library is
loaded with ``ctypes``.  The library's name carries a hash of the sources
and flags, so an edited source builds anew.  A failed build raises; nothing
falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("filter_compact.cu", "groupby_sum.cu", "zonemap.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()
build_seconds: float | None = None     # wall time of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the repro_torch CUDA kernels are "
                       "built with nvcc at first use on a CUDA machine")


def _digest(csrc: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources in ``csrc`` (one nvcc each, in parallel) and
    link them into one shared library in ``build_dir``; returns its path.
    Reuses a library already built from the same sources and flags."""
    global build_seconds
    lib_path = build_dir / f"librepro_torch_kernels-{_digest(csrc)}.so"
    if lib_path.exists():
        return lib_path
    t0 = time.perf_counter()
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}-{threading.get_ident()}"
    objs = [build_dir / f"{Path(s).stem}-{tag}.o" for s in SOURCES]
    procs = [_run([nvcc, *NVCC_FLAGS, "-c", str(csrc / s), "-o", str(o)])
             for s, o in zip(SOURCES, objs)]
    errors = []
    for s, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc {s} failed ({p.returncode}):\n{out}")
    if errors:
        raise RuntimeError("\n".join(errors))
    tmp = lib_path.with_suffix(f".{tag}.tmp")
    link = _run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)])
    out, _ = link.communicate()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{out}")
    os.replace(tmp, lib_path)
    for o in objs:
        o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return lib_path


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "fc_tile_rows": [],
    "fc_max_cols": [],
    "fc_count": [_P, _L, _P, _P, _P],
    "fc_scatter_cols": [_P, _L, _P, _P, _P, _P, _I, _I, _P],
    "gb_max_slots": [],
    "gb_max_blocks": [],
    "gb_threads": [],
    "gb_sum_small": [_I, _P, _P, _L, _I, _I, _P, _P, _I, _P, _P, _P],
    "gb_piece_rows": [],
    "gb_sum_sorted": [_I, _P, _P, _P, _L, _I, _L, _P, _P, _P, _P, _L, _P, _P,
                      _P],
    "zm_threads": [],
    "zm_min_blocks": [],
    "zm_minmax": [_I, _P, _L, _L, _I, _L, _P, _P, _P, _P],
}


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                handle = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _LIB = handle
    return _LIB


def check(err: int, what: str) -> None:
    """Raise when a C entry reports a CUDA error (its cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {err}")


def stream_of(t) -> int:
    """The current PyTorch stream of ``t``'s device, as a pointer value."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
