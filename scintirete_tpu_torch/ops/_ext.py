"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface, under `build/kernels/` beside the
package, named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused. The libraries are built at first
use, all sources in parallel (one `nvcc` each), and loaded with `ctypes`.
A missing `nvcc` or a failed build raises: there is no fallback.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry points: name -> (library = csrc source stem, symbol, argtypes)
SIGNATURES = {
    "pivot_scan": (
        "pivot_scan", "scnt_pivot_entry_scan", [_P] * 7 + [_I] * 4 + [_P],
    ),
    "lane_scan": (
        "lane_scan", "scnt_knn_lane_scan",
        [_P] * 8 + [_I, _I, _LL, _I, _I, _I, _I, _P],
    ),
    "lane_scan_masked": (
        "lane_scan", "scnt_knn_lane_scan_masked",
        [_P] * 9 + [_I, _I, _LL, _I, _I, _I, _P],
    ),
    "lane_topk_scan": (
        "lane_scan", "scnt_lane_topk_scan",
        [_P] * 6 + [_I, _I, _LL, _I, _I, _I, _P],
    ),
    # the packed scans take a workspace and a slice count
    "flat_packed_bf16": (
        "flat_scan", "scnt_flat_packed_bf16",
        [_P] * 7 + [_I, _I, _LL, _I, _I, _I, _I, _P],
    ),
    # the int8 scans take their raw inputs and scratch for preparing them;
    # the unpacked one reads no workspace, group size or slice count
    **{
        entry: (
            "flat_scan", f"scnt_{entry}",
            [_P] * 11 + [_I, _I, _I, _LL, _I, _I, _I, _I, _P],
        )
        for entry in ("flat_packed_int8", "flat_lane_int8")
    },
}
LIBRARIES = sorted({lib for lib, _, _ in SIGNATURES.values()})

_lock = threading.Lock()
_loaded: dict[str, ctypes._CFuncPtr] = {}
# seconds the first kernel() call took to build or find the libraries and
# load them; None until a kernel is first asked for
load_seconds: float | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel library (one per `csrc/*.cu`) that is not
    built yet, all at once. Returns {library name: path}. The compiler's
    report (registers, shared memory, spills) is kept beside each library
    as `<lib>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in LIBRARIES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(path.with_suffix(".so.log"), "w")
        procs[name] = (
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT,
            ),
            tmp, path, log,
        )
    failed = []
    for name, (proc, tmp, path, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}, see {log.name}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed: " + "; ".join(failed))
    return paths


def check_tensor(t, name: str, dtype, shape: tuple, device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device`: what a kernel's C interface takes."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: want {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kernel(name: str) -> ctypes._CFuncPtr:
    """The loaded C entry point `name` of SIGNATURES (built on first use)."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    global load_seconds
    with _lock:
        if not _loaded:
            t0 = time.perf_counter()
            libs = {n: ctypes.CDLL(str(p)) for n, p in build_all().items()}
            for entry, (lib_name, symbol, argtypes) in SIGNATURES.items():
                f = getattr(libs[lib_name], symbol)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _loaded[entry] = f
            load_seconds = time.perf_counter() - t0
        return _loaded[name]
