"""Where a flat search batch's time goes in the PyTorch/CUDA port, on one GPU.

    python3 scripts/torch_flat_profile.py [--n 1000000] [--batch 1024]

Builds a cosine flat collection of clustered vectors through the port's
Engine on the card and a FlatIndex of the same vectors (int8 scan copy, the
default), then times one batch of queries through each surface
(FlatIndex.search_batch_arrays, FlatIndex.search_batch,
Collection.search_batch_arrays, Collection.search_batch), splits a
FlatIndex batch into its device part (submit + synchronize) and its host
part (collect + assemble), does the same split for a FlatIndex with the
bf16 scan copy, and prints a cProfile of Collection.search_batch.
Host-clock medians of 7 calls, each ending with every result on the host.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import pstats
import subprocess
import sys
import time

import numpy as np


def median_s(fn, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("this profile needs a CUDA card")
    sys.path.insert(0, ".")
    from scintirete_tpu_torch import (
        CollectionConfig,
        DistanceMetric,
        SearchParams,
    )
    from scintirete_tpu_torch.engine import Engine
    from scintirete_tpu_torch.index.flat import FlatIndex

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    rng = np.random.default_rng(args.seed)
    centers = rng.standard_normal((max(args.n // 100, 100), 128)) * 2.0
    base = (centers[rng.integers(0, len(centers), args.n)]
            + 0.4 * rng.standard_normal((args.n, 128))).astype(np.float32)
    q = (base[rng.integers(0, args.n, args.batch)]
         + 0.2 * rng.standard_normal((args.batch, 128))).astype(np.float32)
    col = Engine(device="cuda").create_database("d").create_collection(
        CollectionConfig(name="c", metric=DistanceMetric.COSINE,
                         index_type="flat")
    )
    col.insert([(v, None) for v in base])
    idx = FlatIndex(128, metric=DistanceMetric.COSINE, device="cuda")
    idx.bulk_insert(list(range(1, args.n + 1)), base)
    idx16 = FlatIndex(128, metric=DistanceMetric.COSINE, device="cuda",
                      scan_dtype="bfloat16")
    idx16.bulk_insert(list(range(1, args.n + 1)), base)
    sp = SearchParams(top_k=10)
    col.search_batch(q, sp)
    idx.search_batch(q, sp)
    idx16.search_batch(q, sp)

    def device_part(index=idx):
        pending = index.search_submit(q, sp)
        torch.cuda.synchronize()
        return pending

    pending = device_part()
    pending16 = device_part(idx16)
    for name, fn in (
        ("FlatIndex device part (submit + synchronize)", device_part),
        ("FlatIndex host part (collect + tuples)",
         lambda: idx.search_collect(pending)),
        ("FlatIndex (bf16 scan copy) device part",
         lambda: device_part(idx16)),
        ("FlatIndex (bf16 scan copy) host part",
         lambda: idx16.search_collect(pending16)),
        ("FlatIndex (bf16 scan copy).search_batch_arrays",
         lambda: idx16.search_batch_arrays(q, sp)),
        ("FlatIndex.search_batch_arrays", lambda: idx.search_batch_arrays(q, sp)),
        ("FlatIndex.search_batch", lambda: idx.search_batch(q, sp)),
        ("Collection.search_batch_arrays",
         lambda: col.search_batch_arrays(q, sp)),
        ("Collection.search_batch", lambda: col.search_batch(q, sp)),
    ):
        print(f"{name}: {median_s(fn) * 1e3:.3f} ms per batch of {args.batch}")
    gc.disable()
    print(f"Collection.search_batch, collector off: "
          f"{median_s(lambda: col.search_batch(q, sp)) * 1e3:.3f} ms")
    gc.enable()
    prof = cProfile.Profile()
    prof.enable()
    col.search_batch(q, sp)
    prof.disable()
    pstats.Stats(prof).sort_stats("cumulative").print_stats(14)


if __name__ == "__main__":
    main()
