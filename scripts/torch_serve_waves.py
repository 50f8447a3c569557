"""Does an HNSW query's answer depend on the wave it rides in? On one GPU.

    python3 scripts/torch_serve_waves.py [--n 200000] [--queries 1024]

The server's batcher stacks concurrent single-query Search RPCs into waves
of 1 to `search_batch_size` rows, and the engine searches them as one
batch. This script builds a cosine HNSW collection of clustered vectors
(chip_smoke.py's generator and graph parameters) through the port's Engine
on the card, searches the queries once in sub-batches of 256 (the
reference answers), then again in random waves of 1-64 rows and one at a
time, and counts the queries whose ids, or whose distances in any bit,
differ from the reference. It does so for the search as it is (the beam's
dot an elementwise product and sum) and for variants: the dot as
`torch.bmm` (the port's earlier form), and each with every wave padded to
256 rows with copies of its last query; it prints the median seconds of a
wave of 1, 64 and 256 queries for each. Needs a CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("this check needs a CUDA card")
    sys.path.insert(0, ".")
    import chip_smoke
    from scintirete_tpu_torch import (
        CollectionConfig,
        DistanceMetric,
        SearchParams,
    )
    from scintirete_tpu_torch.engine import Engine
    from scintirete_tpu_torch.index import device as device_mod

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(args.seed)
    base, queries, _ = chip_smoke.make_dataset(rng, args.n, args.queries)
    col = Engine(device="cuda").create_database("d").create_collection(
        CollectionConfig(name="c", metric=DistanceMetric.COSINE,
                         hnsw=chip_smoke.hnsw_params()))
    t0 = time.perf_counter()
    col.insert([(v, None) for v in base])
    torch.cuda.synchronize()
    print(f"built {args.n} x {base.shape[1]} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    sp = SearchParams(top_k=10, ef_search=12)
    width = 256

    def padded(q):
        """Search q [B, D] as a batch of `width` rows (copies of its last
        row appended) and keep the first B answers."""
        pad = np.repeat(q[-1:], width - len(q), axis=0)
        ids, d = col.search_batch_arrays(np.concatenate([q, pad]), sp)
        return ids[: len(q)], d[: len(q)]

    original = device_mod._cmp_dist

    def bmm_dist(q, q_sq, q_norm, vecs, v_sq, metric):
        """_cmp_dist with its dot as a batched matrix product."""
        dots = torch.bmm(vecs.float(), q.float()[:, :, None])[:, :, 0]
        if metric == int(DistanceMetric.L2):
            return q_sq[:, None] + v_sq - 2.0 * dots
        if metric == int(DistanceMetric.INNER_PRODUCT):
            return -dots
        denom = q_norm[:, None] * torch.sqrt(v_sq)
        cos = torch.where(denom > 1e-30,
                          dots / torch.clamp(denom, min=1e-30), 0.0)
        cos = torch.clamp(cos, -1.0, 1.0)
        zero = (q_sq[:, None] <= 1e-30) | (v_sq <= 1e-30)
        return torch.where(zero, 1.0, 1.0 - cos)

    variants = {
        "as is": (original, lambda q: col.search_batch_arrays(q, sp)),
        "bmm dot": (bmm_dist, lambda q: col.search_batch_arrays(q, sp)),
        "as is, padded to 256": (original, padded),
        "bmm dot, padded to 256": (bmm_dist, padded),
    }
    wave_rng = np.random.default_rng(args.seed + 1)
    widths = []
    left = args.queries
    while left > 0:
        w = int(min(left, wave_rng.integers(1, 65)))
        widths.append(w)
        left -= w
    col.search_batch_arrays(queries[:width], sp)  # the mirror's upload
    for name, (dist_fn, search) in variants.items():
        device_mod._cmp_dist = dist_fn
        try:
            ref_i, ref_d = col.search_batch_arrays(queries, sp)
            got_i, got_d, s = [], [], 0
            for w in widths:
                i, d = search(queries[s : s + w])
                got_i.append(i)
                got_d.append(d)
                s += w
            got_i, got_d = np.concatenate(got_i), np.concatenate(got_d)
            one_i, one_d = zip(*(search(queries[j : j + 1]) for j in range(64)))
            one_i, one_d = np.concatenate(one_i), np.concatenate(one_d)
            times = {}
            for b in (1, 64, 256):
                search(queries[:b])
                torch.cuda.synchronize()
                ts = []
                for _ in range(7):
                    t0 = time.perf_counter()
                    search(queries[:b])
                    ts.append(time.perf_counter() - t0)
                times[b] = float(np.median(ts))
        finally:
            device_mod._cmp_dist = original
        print(
            f"{name}: waves of 1-64 ({len(widths)} waves): "
            f"{int(np.any(got_i != ref_i, axis=1).sum())} of {args.queries} "
            f"queries with other ids, "
            f"{int(np.any(got_d != ref_d, axis=1).sum())} with other "
            f"distance bits (largest difference "
            f"{float(np.abs(got_d - ref_d).max()):.3g}); one at a time: "
            f"{int(np.any(one_i != ref_i[:64], axis=1).sum())} of 64 with other "
            f"ids, {int(np.any(one_d != ref_d[:64], axis=1).sum())} with other "
            f"distance bits; median s a wave of 1 / 64 / 256: "
            + " / ".join(f"{times[b]:.4f}" for b in (1, 64, 256)),
            flush=True,
        )


if __name__ == "__main__":
    main()
