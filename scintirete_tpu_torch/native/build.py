"""Compilation + ctypes loading of the port's C++ link-application library.

A copy of `scintirete_tpu/native/build.py` with two changes. The shared
object is compiled with g++ -O3 into `build/native/` beside the package
(as `ops/_ext.py` places `build/kernels/`), named by a hash of the source,
and no environment variable moves it. It is compiled without
-march=native: a checkout's `build/` may be copied to another host, and a
library tuned to the CPU that built it could stop another with an illegal
instruction. Any failure (no compiler, read-only
checkout) degrades to the pure-Python implementations, which stay the
semantics oracle; `load_native()` says whether the library is in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "link_apply.cpp"
BUILD_DIR = _SRC.parent.parent.parent / "build" / "native"
_LOCK = threading.Lock()
_CACHED: Optional[ctypes.CDLL] = None
_FAILED = False


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"link_apply_{digest}.so"


def load_native() -> Optional[ctypes.CDLL]:
    """Returns the loaded library, or None when unavailable."""
    global _CACHED, _FAILED
    if _CACHED is not None:
        return _CACHED
    if _FAILED:
        return None
    with _LOCK:
        if _CACHED is not None or _FAILED:
            return _CACHED
        try:
            so_path = _lib_path()
            if not so_path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    [
                        "g++", "-O3", "-shared", "-fPIC",
                        "-std=c++17", str(_SRC), "-o", str(tmp),
                    ],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(str(so_path))
            lib.apply_chunk.restype = ctypes.c_int32
            lib.incoming_cap.restype = ctypes.c_int32
            _CACHED = lib
            return lib
        except (OSError, subprocess.SubprocessError):
            _FAILED = True
            return None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def apply_chunk_native(
    store,
    cand_slots,  # np [Lc, B, efc] i32
    cand_dists,  # np [Lc, B, efc] f32
    new_slots,  # np [B] i64
    levels,  # np [B] i32
    intra,  # np [B, B] f32
    frozen_max: int,
) -> Optional[list[tuple[int, int]]]:
    """Run the C++ link application. Returns the dirty (layer, row) pairs,
    or None if the native library is unavailable (caller falls back)."""
    import numpy as np

    lib = load_native()
    if lib is None:
        return None

    i32p = ctypes.POINTER(ctypes.c_int32)
    n_layers = len(store.layers)
    layer_nbrs = (i32p * max(n_layers, 1))()
    layer_rowof = (i32p * max(n_layers, 1))()
    for idx, ls in enumerate(store.layers):
        layer_nbrs[idx] = _ptr(ls.nbrs, ctypes.c_int32)
        layer_rowof[idx] = _ptr(ls.row_of, ctypes.c_int32)

    B = len(new_slots)
    efc = cand_slots.shape[2] if cand_slots.size else 0
    max_dirty = int(B * (store.m0 + 2) * (2 + n_layers))
    dirty = np.empty((max_dirty, 2), np.int32)
    n_dirty = ctypes.c_int64(0)
    entry = ctypes.c_int64(store.entry_slot)
    max_layer = ctypes.c_int32(store.max_layer)

    cand_slots = np.ascontiguousarray(cand_slots, np.int32)
    cand_dists = np.ascontiguousarray(cand_dists, np.float32)
    new_slots = np.ascontiguousarray(new_slots, np.int64)
    levels = np.ascontiguousarray(levels, np.int32)
    intra = np.ascontiguousarray(intra, np.float32)
    deleted_u8 = store.deleted.view(np.uint8)

    status = lib.apply_chunk(
        _ptr(store.vectors, ctypes.c_float),
        ctypes.c_int64(store.cap),
        ctypes.c_int64(store.dim),
        _ptr(store.neighbors0, ctypes.c_int32),
        ctypes.c_int32(store.m0),
        ctypes.c_int32(n_layers),
        layer_nbrs,
        layer_rowof,
        ctypes.c_int32(store.m),
        _ptr(deleted_u8, ctypes.c_uint8),
        ctypes.c_int32(int(store.metric)),
        ctypes.c_int32(1 if store.params.neighbor_heuristic else 0),
        _ptr(cand_slots, ctypes.c_int32),
        _ptr(cand_dists, ctypes.c_float),
        ctypes.c_int32(cand_slots.shape[0] if cand_slots.size else 0),
        ctypes.c_int32(B),
        ctypes.c_int32(efc),
        _ptr(new_slots, ctypes.c_int64),
        _ptr(levels, ctypes.c_int32),
        _ptr(intra, ctypes.c_float),
        ctypes.c_int32(frozen_max),
        ctypes.byref(entry),
        ctypes.byref(max_layer),
        _ptr(dirty, ctypes.c_int32),
        ctypes.c_int64(max_dirty),
        ctypes.byref(n_dirty),
    )
    store.entry_slot = int(entry.value)
    store.max_layer = int(max_layer.value)
    if status != 0:
        # dirty buffer overflow: invalidate so the next sync re-uploads
        store.invalidate_dirty()
        store.version += 1
        return []
    return [
        (int(dirty[i, 0]), int(dirty[i, 1])) for i in range(int(n_dirty.value))
    ]


def incoming_cap_native(
    fwd_i, fwd_d, max_deg: int
) -> Optional[tuple]:
    """Reverse-edge cap in C++ (see link_apply.cpp incoming_cap). Returns
    (inc_i, inc_d) or None when the native library is unavailable."""
    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    fwd_i = np.ascontiguousarray(fwd_i, np.int32)
    fwd_d = np.ascontiguousarray(fwd_d, np.float32)
    nm, F = fwd_i.shape
    inc_i = np.full((nm, max_deg), -1, np.int32)
    inc_d = np.full((nm, max_deg), np.inf, np.float32)
    lib.incoming_cap(
        _ptr(fwd_i, ctypes.c_int32),
        _ptr(fwd_d, ctypes.c_float),
        ctypes.c_int64(nm),
        ctypes.c_int32(F),
        ctypes.c_int32(max_deg),
        _ptr(inc_i, ctypes.c_int32),
        _ptr(inc_d, ctypes.c_float),
    )
    return inc_i, inc_d
