"""Where the pivot scan's time goes on one GPU: products, operand loads, host.

    python3 scripts/torch_pivot_split.py

Compiles three copies of `scintirete_tpu_torch/csrc/pivot_scan.cu` into
build/pivot_split/: the kernel as it is; "products only", whose product
loop reads its operands from shared memory once per 32-deep chunk instead
of once per 4 depth values (the FFMA stream, the ring and the fold, with
1/8 of the shared-memory loads); and "loads only", whose product loop
keeps every shared-memory load but sums each operand into one of 16
accumulators (64 FADD per 4 depth values) instead of issuing 256 FFMA.
Times each C entry on a cosine scan of B = 256 and 1 queries against
65,536 x 128 pivots, in turns (the
three copies, then the reverse), medians of 50 CUDA-event timings: one
call per timing (as the wrapper is timed), and 20 calls back to back per
timing (the device's time per call, the host's enqueue hidden). Then the
wrapper (`pivot_entry_scan`) against the kernel's C entry, and the
kernel's device time from torch.profiler. The last two copies compute
wrong distances by design: only their times mean anything. Needs a CUDA
card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the product loop's operand loads and its FFMA block
LOOP = ("#pragma unroll\n      for (int c = 0; c < kChunk / 4; ++c) {\n"
        "        float4 a[kRows], b[8];\n")
HOISTED = ("      float4 a[kRows], b[8];\n#pragma unroll\n"
           "      for (int c = 0; c < kChunk / 4; ++c) {\n")
LOADS = ("          a[i] = lds128(", "          b[j] = lds128(")
FMA = """            acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
"""
ADD_ONLY = """            if (j == 0) acc[i][0] += (a[i].x + a[i].y) + (a[i].z + a[i].w);
            if (i == 0) acc[0][j] += (b[j].x + b[j].y) + (b[j].z + b[j].w);
"""


def variants(src: str) -> dict[str, str]:
    for anchor in (LOOP, FMA, *LOADS):
        if anchor not in src:
            sys.exit("pivot_scan.cu changed: update this script's anchors")
    once = src.replace(LOOP, HOISTED)
    for load in LOADS:
        once = once.replace(load, load.replace("          ", "          if (c == 0) "))
    return {
        "kernel": src,
        "products only": once,
        "loads only": src.replace(FMA, ADD_ONLY),
    }


def build_all(texts: dict[str, str], out: Path) -> dict:
    """One nvcc per copy, all started together; returns each copy's entry."""
    from scintirete_tpu_torch.ops import _ext

    procs = {}
    for name, text in texts.items():
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for h in _ext.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / "pivot_scan.cu").write_text(text)
        lib = d / "pivot_scan.so"
        procs[name] = (lib, subprocess.Popen(
            [_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", str(lib),
             str(d / "pivot_scan.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        ))
    fns = {}
    _, symbol, argtypes = _ext.SIGNATURES["pivot_scan"]
    for name, (lib, proc) in procs.items():
        if proc.wait() != 0:
            sys.exit(f"{name}: nvcc failed\n{proc.stderr.read().decode()}")
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from scintirete_tpu_torch.ops.pivot_scan import pivot_entry_scan

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    src = (ROOT / "scintirete_tpu_torch/csrc/pivot_scan.cu").read_text()
    fns = build_all(variants(src), ROOT / "build" / "pivot_split")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    R, D, B = 65536, 128, 256
    pv = torch.randn(R, D, generator=g, device=dev)
    pv = pv / pv.norm(dim=1, keepdim=True)
    q = torch.randn(B, D, generator=g, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    psq = (pv * pv).sum(1)
    pdel = torch.zeros(R, device=dev)
    keys = torch.empty(B, dtype=torch.int64, device=dev)
    d = torch.empty(B, device=dev)
    i = torch.empty(B, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (q, pv, psq, pdel, keys, d, i)]

    def call(fn, b):
        err = fn(*ptrs, b, R, D, 2, stream)
        if err:
            sys.exit(f"launch failed: cudaError {err}")

    def median_ms(run, inner=1, reps=50):
        run()
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(inner):
                run()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / inner)
        return float(np.median(times))

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}")
    for name in list(fns) + list(reversed(fns)):
        times = ", ".join(
            f"B={b} {median_ms(lambda: call(fns[name], b)):.4f} ms "
            f"(back to back {median_ms(lambda: call(fns[name], b), 20, 10):.4f})"
            for b in (B, 1)
        )
        print(f"{name}: {times}", flush=True)
    for b in (B, 1):
        qb = q[:b]
        wrapper = median_ms(lambda: pivot_entry_scan(qb, pv, psq, pdel, 2))
        entry = median_ms(lambda: call(fns["kernel"], b))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                pivot_entry_scan(qb, pv, psq, pdel, 2)
            torch.cuda.synchronize()
        device = {e.key: e.device_time_total / e.count / 1e3
                  for e in prof.key_averages() if e.device_time_total > 0}
        print(f"B={b}: wrapper {wrapper:.4f} ms, C entry {entry:.4f} ms, "
              f"device time per call (torch.profiler): "
              + ", ".join(f"{k[:40]} {v:.4f} ms" for k, v in device.items()),
              flush=True)


if __name__ == "__main__":
    main()
