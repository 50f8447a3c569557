"""Where a flat scan's time goes on one GPU: the product against the fold.

    python3 scripts/torch_flat_split.py

Compiles three copies of `scintirete_tpu_torch/csrc/flat_scan.cu` into
build/flat_split/: the kernel as it is; "product only", whose epilogue
keeps just a running minimum of the raw dots (the ring, the TMA copies and
the wgmma products, no score and no fold); and "fold only", which issues
no product (the ring, the copies and the score and fold of unchanged
accumulators). The three scans of flat_scan.cu share that body, so each
copy holds all three. Times each C entry (scnt_flat_packed_bf16, and
scnt_flat_packed_int8 and scnt_flat_lane_int8 with their input
preparation; no wrapper) on a cosine scan of B = 1024 and 1 queries
against a 2^20 x 128 base (B = 1 split into slices as the wrapper splits
the packed scans; the unpacked int8 scan walks in one piece), in turns
(the three copies, then the reverse), medians of 20 CUDA-event timings.
The last two copies compute wrong keys by design: only their times mean
anything. Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the regions of the kernel that the copies replace
MMA_START = "        for (int k = 0; k < ksteps; ++k) {\n          if constexpr (kInt8)"
MMA_END = "        wgmma_commit();"
NO_MMA = "        if (ksteps < 0) wgmma_fence();  // never: no product is issued\n"
FOLD_START = "      const bool first = kGrouped && t % group == 0;"
FOLD_END = "      __syncwarp();\n      if (l == 0) mbar_arrive(&empty[prev]);\n    }\n\n#pragma"
MIN_ONLY = """#pragma unroll
      for (int j = 0; j < 32; ++j)
        k1[j] = fminf(k1[j], static_cast<float>(acc[j]));
"""


def variants(src: str) -> dict[str, str]:
    for anchor in (MMA_START, MMA_END, FOLD_START, FOLD_END):
        if anchor not in src:
            sys.exit("flat_scan.cu changed: update this script's anchors")
    a, b = src.index(FOLD_START), src.index(FOLD_END)
    m0 = src.index(MMA_START)
    m1 = src.index(MMA_END, m0)
    return {
        "kernel": src,
        "product only": src[:a] + MIN_ONLY + src[b:],
        "fold only": src[:m0] + NO_MMA + src[m1:],
    }


def build_all(texts: dict[str, str], out: Path) -> dict[str, dict]:
    """One nvcc per copy, all started together; returns each copy's three
    entry points."""
    from scintirete_tpu_torch.ops import _ext

    procs = {}
    for name, text in texts.items():
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for h in _ext.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / "flat_scan.cu").write_text(text)
        lib = d / "flat_scan.so"
        procs[name] = (lib, subprocess.Popen(
            [_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", str(lib),
             str(d / "flat_scan.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        ))
    libs = {}
    for name, (lib, proc) in procs.items():
        if proc.wait() != 0:
            sys.exit(f"{name}: nvcc failed\n{proc.stderr.read().decode()}")
        libs[name] = {}
        for entry in ("flat_packed_bf16", "flat_packed_int8",
                      "flat_lane_int8"):
            _, symbol, argtypes = _ext.SIGNATURES[entry]
            fn = getattr(ctypes.CDLL(str(lib)), symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            libs[name][entry] = fn
    return libs


def main() -> None:
    import torch

    from scintirete_tpu_torch.ops import packed_scan as ps

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    src = (ROOT / "scintirete_tpu_torch/csrc/flat_scan.cu").read_text()
    out = ROOT / "build" / "flat_split"
    libs = build_all(variants(src), out)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    N, D, B = 1 << 20, 128, 1024
    b32 = torch.randn(N, D, generator=g, device=dev)
    b32 = b32 / b32.norm(dim=1, keepdim=True)
    q32 = b32[:B].contiguous()
    invalid = torch.zeros(N, device=dev)
    bsq = (b32 * b32).sum(1)
    base8, scale = ps.quantize_rows(b32)
    keys = torch.empty((B, 2048), device=dev)
    rows = torch.empty((B, 2048), dtype=torch.int32, device=dev)
    ws = torch.empty((16, 1, 2048), device=dev)
    # the int8 entries quantize the queries and prepare the [N] terms into
    # scratch themselves (as the wrappers call them)
    scratch = (torch.empty((B, D), dtype=torch.int8, device=dev),
               torch.empty(B, device=dev), torch.empty((2, N), device=dev))
    inputs = {
        "flat_packed_bf16": ((q32.to(torch.bfloat16),
                              b32.to(torch.bfloat16), bsq, invalid), (D,)),
        "flat_packed_int8": ((q32, base8, scale, bsq, invalid, *scratch),
                             (D, D)),
        "flat_lane_int8": ((q32, base8, scale, bsq, invalid, *scratch),
                           (D, D)),
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def run(fn, entry, b):
        lead, widths = inputs[entry]
        # the unpacked scan reads no slice count: it never splits
        slices = ps._slices(b, N // 1024, sms)
        ptrs = [None if t is None else t.data_ptr()
                for t in (*lead, keys, rows, ws)]
        err = fn(*ptrs, b, *widths, N, N // 1024, 1, slices, 2, stream)
        if err:
            sys.exit(f"launch failed: cudaError {err}")

    def median_ms(fn, entry, b, reps=20):
        run(fn, entry, b)
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run(fn, entry, b)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return float(np.median(times))

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}")
    for name in list(libs) + list(reversed(libs)):
        times = ", ".join(
            f"{entry.removeprefix('flat_')} B={b} {median_ms(libs[name][entry], entry, b):.4f} ms"
            for entry in inputs for b in (B, 1)
        )
        print(f"{name}: {times}", flush=True)


if __name__ == "__main__":
    main()
