"""Where a graph-build lane scan's time goes on one GPU: the product against the fold.

    python3 scripts/torch_lane_split.py

Compiles three copies of `scintirete_tpu_torch/csrc/lane_scan.cu` into
build/lane_split/: the kernel as it is; "product only", whose epilogue keeps
just a running minimum of each score (the ring, the TMA copies and the
wgmma products, no fold); and "fold only", which issues no product (the
ring, the copies and the fold of unchanged accumulators). Times each
through the same C entry point on a cosine scan of B = 2048, 1024 and 128
queries against a 2^20 x 128 bf16 base, in turns (kernel, product only,
fold only, then the reverse), medians of 20 CUDA-event timings. The two
copies compute wrong lanes by design: only their times mean anything.
Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the two regions of the kernel's consumer loop that the copies replace
MMA = """        for (int k = 0; k < ksteps; ++k)
          wgmma_m64n64k16(acc, sw128_desc(a_addr + 32 * k),
                          sw128_desc(b_addr + 32 * k), (kc | k) != 0);"""
NO_MMA = """        if (ksteps < 0)  // never: no product is issued
          wgmma_m64n64k16(acc, sw128_desc(a_addr), sw128_desc(b_addr), 1);"""
FOLD_START = "      // _fold_best_two: the displaced best becomes a second-best"
FOLD_END = "\n    }\n\n#pragma unroll\n    for (int j = 0; j < 32; ++j) {\n      const int b ="
MIN_ONLY = """#pragma unroll
      for (int j = 0; j < 32; ++j)
        d1[j] = fminf(d1[j], __fsub_rn(c[2 * (j >> 2) + (j & 1)], acc[j]));"""


def variants(src: str) -> dict[str, str]:
    if MMA not in src or FOLD_START not in src or FOLD_END not in src:
        sys.exit("lane_scan.cu changed: update this script's anchors")
    a, b = src.index(FOLD_START), src.index(FOLD_END)
    return {
        "kernel": src,
        "product only": src[:a] + MIN_ONLY + src[b:],
        "fold only": src.replace(MMA, NO_MMA),
    }


def build(name: str, text: str, out: Path):
    from scintirete_tpu_torch.ops import _ext

    d = out / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    (d / "lane_scan.cu").write_text(text)
    lib = d / "lane_scan.so"
    subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", str(lib),
                    str(d / "lane_scan.cu")], check=True,
                   capture_output=True)
    _, symbol, argtypes = _ext.SIGNATURES["lane_scan"]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    src = (ROOT / "scintirete_tpu_torch/csrc/lane_scan.cu").read_text()
    fns = {name: build(name, text, ROOT / "build" / "lane_split")
           for name, text in variants(src).items()}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    N, D = 1 << 20, 128
    b32 = torch.randn(N, D, generator=g, device=dev)
    b32 = b32 / b32.norm(dim=1, keepdim=True)
    base = b32.to(torch.bfloat16)
    bsq = (b32 * b32).sum(1)
    q = base[:2048].contiguous()
    si = torch.arange(2048, dtype=torch.int32, device=dev)
    out = [torch.empty((2048, 1024), dtype=t, device=dev)
           for t in (torch.float32, torch.int32) * 2]
    stream = torch.cuda.current_stream().cuda_stream

    def run(fn, B):
        err = fn(q.data_ptr(), si.data_ptr(), base.data_ptr(), bsq.data_ptr(),
                 *(o.data_ptr() for o in out), B, D, N, N, N // 1024, 2, 1,
                 stream)
        if err:
            sys.exit(f"launch failed: cudaError {err}")

    def median_ms(fn, B, reps=20):
        run(fn, B)
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run(fn, B)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}")
    for name in list(fns) + list(reversed(fns)):
        times = ", ".join(f"B={B} {median_ms(fns[name], B):.4f} ms"
                          for B in (2048, 1024, 128))
        print(f"{name}: {times}", flush=True)


if __name__ == "__main__":
    main()
