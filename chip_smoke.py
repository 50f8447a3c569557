"""Chip check of the PyTorch/CUDA port (`scintirete_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero and prints no result line:
 1. a CUDA card must be present; prints its name and power limit;
 2. builds every CUDA kernel of the port from the sources in the checkout
    (nvcc, into build/kernels/) and prints the build seconds;
 3. holds each kernel against its plain torch version on the card, at the
    shapes of the main path: pivot_entry_scan (B=256, D=128, R=65,536 and a
    ragged R, 3 metrics, deleted pivots, all deleted) and knn_lane_topc
    (B=2048, N=1,048,576, D=128, c=64, 3 metrics, partial n_valid); prints
    the largest distance difference, the share of equal ids and the median
    times of kernel and plain version (CUDA events);
 4. drives the main path at full size: Engine -> create_database ->
    create_collection (cosine HNSW, m=16, ef_construction=200,
    ef_search=12, seed=42, heuristic) -> Collection.insert of a 1,000,000 x
    128 corpus of the clustered workload-v2 generator -> search_batch in
    batches of 1024 (k=10); checks recall@10 >= 0.95 against the port's
    brute-force top-k on the card, that both kernels were launched by this
    run, then deletes 1% of the ids and checks none of them comes back;
 5. prints the kernels' JSON line, the card's line, and last
    {"ok": true, "device": {...}}.

This script imports nothing of JAX and nothing of the JAX package; the
port it drives uses only the JAX package's jax-free modules (types, errors,
config, utils.rwlock, native.build). The data is made from --seed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

RECALL_GATE = 0.95
DIM, K, BATCH = 128, 10, 1024
N_BASE, N_QUERIES = 1_000_000, 4096
N_CLUSTERS_PER_100K = 1000


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare(name, d_k, i_k, d_p, i_p, atol, rtol):
    """Kernel vs plain: distances within atol + rtol*|d| wherever finite
    (f32 sums in another order), ids equal except where the two distances
    tie within that tolerance. Returns (max_abs_err, share of equal ids)."""
    import torch

    fin = torch.isfinite(d_p)
    if not torch.equal(fin, torch.isfinite(d_k)):
        fail(f"{name}: finite pattern differs between kernel and plain")
    diff = (d_k - d_p).abs()[fin]
    err = float(diff.max()) if diff.numel() else 0.0
    tol = atol + rtol * d_p.abs()[fin]
    if diff.numel() and bool((diff > tol).any()):
        fail(f"{name}: distance differs by {err}")
    same = i_k == i_p
    share = float(same.float().mean())
    if not bool(((d_k - d_p).abs() <= atol + rtol * d_p.abs())[~same & fin].all()):
        fail(f"{name}: ids differ where the distances do not tie")
    return err, share


def check_pivot(dev, seed):
    import torch

    from scintirete_tpu_torch.ops.pivot_scan import (
        pivot_entry_scan,
        pivot_entry_scan_plain,
    )

    g = torch.Generator(device=dev).manual_seed(seed)
    B, D = 256, 128
    worst_err, worst_share, timing = 0.0, 1.0, None
    for R in (65536, 65536 - 300):
        for metric in (1, 2, 3):
            q = torch.randn(B, D, generator=g, device=dev)
            pv = torch.randn(R, D, generator=g, device=dev)
            if metric == 2:
                q = q / q.norm(dim=1, keepdim=True)
                pv = pv / pv.norm(dim=1, keepdim=True)
            psq = (pv * pv).sum(1)
            pdel = torch.zeros(R, device=dev)
            pdel[::7] = 1.0
            args = (q, pv, psq, pdel, metric)
            d_k, i_k = pivot_entry_scan(*args)
            d_p, i_p = pivot_entry_scan_plain(*args)
            torch.cuda.synchronize()
            err, share = compare(
                f"pivot_entry_scan R={R} metric={metric}", d_k, i_k, d_p,
                i_p, atol=1e-4, rtol=1e-5,
            )
            log(f"pivot_entry_scan R={R} metric={metric}: max|dd|={err:.3g} "
                f"ids equal {share:.6f}")
            worst_err, worst_share = max(worst_err, err), min(worst_share, share)
            if R == 65536 and metric == 2:
                timing = (
                    median_ms(lambda: pivot_entry_scan(*args), 50),
                    median_ms(lambda: pivot_entry_scan_plain(*args), 20),
                )
        d_k, i_k = pivot_entry_scan(q, pv, psq, torch.ones(R, device=dev), 1)
        if not (bool(torch.isinf(d_k).all()) and bool((i_k == -1).all())):
            fail("pivot_entry_scan: all-deleted case must give (+inf, -1)")
    log(f"pivot_entry_scan B=256 R=65536 D=128 cosine: kernel "
        f"{timing[0]:.4f} ms, plain {timing[1]:.4f} ms")
    return worst_err, timing


def check_lane(dev, seed):
    import torch

    from scintirete_tpu_torch.ops.lane_scan import (
        LANES,
        knn_lane_topc,
        lane_scan,
        lane_scan_plain,
    )

    g = torch.Generator(device=dev).manual_seed(seed + 1)
    B, N, D, c = 2048, 1 << 20, 128, 64
    worst_err, worst_share, timing = 0.0, 1.0, None
    base32 = torch.randn(N, D, generator=g, device=dev)
    for metric in (1, 2, 3):
        b32 = base32 / base32.norm(dim=1, keepdim=True) if metric == 2 else base32
        base = b32.to(torch.bfloat16)
        bsq = (b32 * b32).sum(1)
        qb = base[:B].contiguous()
        si = torch.arange(B, dtype=torch.int32, device=dev)
        n_valid = 700_001
        tiles = -(-n_valid // LANES)
        k_out = lane_scan(qb, si, base, bsq, n_valid, metric, tiles)
        p_out = lane_scan_plain(qb, si, base, bsq, n_valid, metric, tiles)
        torch.cuda.synchronize()
        for (dk, ik), (dp, ip), which in (
            ((k_out[0], k_out[1]), (p_out[0], p_out[1]), "best"),
            ((k_out[2], k_out[3]), (p_out[2], p_out[3]), "second"),
        ):
            err, share = compare(
                f"knn_lane_topc metric={metric} lane {which}", dk, ik, dp, ip,
                atol=1e-4, rtol=1e-5,
            )
            worst_err, worst_share = max(worst_err, err), min(worst_share, share)
        cd, ci = knn_lane_topc(qb, si, base, bsq, n_valid, metric, c, tiles)
        if tuple(cd.shape) != (B, c) or not bool(torch.isfinite(cd).all()):
            fail("knn_lane_topc: top-c must be finite [B, c]")
        if bool((ci >= n_valid).any()) or bool((ci == si[:, None]).any()):
            fail("knn_lane_topc: masked row returned")
        if bool((cd[:, 1:] < cd[:, :-1]).any()):
            fail("knn_lane_topc: top-c not ascending")
        log(f"knn_lane_topc metric={metric}: max|dd|={worst_err:.3g} "
            f"ids equal {worst_share:.6f}")
        if metric == 2:
            full = (qb, si, base, bsq, N, metric, N // LANES)
            timing = (
                median_ms(lambda: lane_scan(*full), 10),
                median_ms(lambda: lane_scan_plain(*full), 3),
            )
    log(f"knn_lane_topc B=2048 N=1048576 D=128 cosine full scan: kernel "
        f"{timing[0]:.3f} ms, plain {timing[1]:.3f} ms")
    return worst_err, timing


def make_dataset(rng, n, n_queries):
    """Workload v2 (bench.py's generator): cluster centers + per-point
    noise; queries are perturbed near-duplicates of base points."""
    n_clusters = max(N_CLUSTERS_PER_100K * n // 100_000, 100)
    centers = rng.standard_normal((n_clusters, DIM)).astype(np.float32) * 2.0
    assign = rng.integers(0, n_clusters, n)
    base = (centers[assign] + 0.4 * rng.standard_normal((n, DIM))).astype(
        np.float32
    )
    qi = rng.integers(0, n, n_queries)
    queries = (
        base[qi] + 0.2 * rng.standard_normal((n_queries, DIM))
    ).astype(np.float32)
    return base, queries


def ground_truth(dev, queries, base, valid, metric):
    import torch

    from scintirete_tpu_torch.ops.topk import brute_force_topk

    b = torch.from_numpy(base).to(dev)
    v = torch.from_numpy(valid).to(dev)
    out = []
    for s in range(0, len(queries), BATCH):
        q = torch.from_numpy(queries[s : s + BATCH]).to(dev)
        _, idx = brute_force_topk(q, b, v, metric, K)
        out.append(idx.cpu().numpy())
    return np.concatenate(out)


def recall_of(results, true_rows) -> float:
    hits = 0
    for res, truth in zip(results, true_rows):
        hits += len({r.id - 1 for r in res} & set(truth.tolist()))
    return hits / (K * len(true_rows))


def run_main_path(dev, n, n_queries, seed):
    import torch

    from scintirete_tpu_torch import (
        CollectionConfig,
        DistanceMetric,
        HNSWParams,
        SearchParams,
    )
    from scintirete_tpu_torch.engine import Engine
    from scintirete_tpu_torch.ops.lane_scan import lane_scan
    from scintirete_tpu_torch.ops.pivot_scan import pivot_entry_scan

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    base, queries = make_dataset(rng, n, n_queries)
    log(f"dataset {n} x {DIM} + {n_queries} queries in "
        f"{time.perf_counter() - t0:.1f} s")
    true_i = ground_truth(dev, queries, base, np.ones(n, bool), 2)

    pivot_entry_scan.launches = 0
    lane_scan.launches = 0
    engine = Engine(device=dev)
    col = engine.create_database("smoke").create_collection(CollectionConfig(
        name="c", metric=DistanceMetric.COSINE,
        hnsw=HNSWParams(m=16, ef_construction=200, ef_search=12, seed=42,
                        neighbor_heuristic=True),
    ))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ids = col.insert([(v, None) for v in base])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if ids != list(range(1, n + 1)):
        fail("insert must assign ids 1..n")
    sp = SearchParams(top_k=K, ef_search=12)
    col.search_batch(queries[:BATCH], sp)  # first search: mirror upload
    t0 = time.perf_counter()
    results = []
    for s in range(0, n_queries, BATCH):
        results.extend(col.search_batch(queries[s : s + BATCH], sp))
    search_s = time.perf_counter() - t0
    qps = n_queries / search_s
    launches = {"pivot_entry_scan": pivot_entry_scan.launches,
                "knn_lane_topc": lane_scan.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for res in results:
        if len(res) != K:
            fail(f"search returned {len(res)} hits, want {K}")
        d = np.asarray([r.distance for r in res])
        if not np.all(np.isfinite(d)) or np.any(np.diff(d) < 0):
            fail("search distances must be finite and ascending")
        if np.any(d < -1e-6) or np.any(d > 2 + 1e-6):
            fail("cosine distances must lie in [0, 2]")
    rec = recall_of(results, true_i)
    log(f"main path n={n}: build {build_s:.2f} s, search {n_queries} "
        f"queries in {search_s:.3f} s = {qps:.1f} QPS, recall@10 {rec:.4f}, "
        f"peak device memory {peak_gb:.2f} GiB, launches {launches}")
    if rec < RECALL_GATE:
        fail(f"recall@10 {rec:.4f} < {RECALL_GATE}")
    for name, cnt in launches.items():
        if cnt <= 0:
            fail(f"{name} was not launched by the main path")

    del_ids = [int(i) for i in rng.choice(n, n // 100, replace=False) + 1]
    if col.delete(del_ids) != len(del_ids):
        fail("delete must tombstone every id once")
    gone = set(del_ids)
    results = []
    for s in range(0, n_queries, BATCH):
        results.extend(col.search_batch(queries[s : s + BATCH], sp))
    if any(r.id in gone for res in results for r in res):
        fail("a deleted id came back from search")
    valid = np.ones(n, bool)
    valid[np.asarray(del_ids) - 1] = False
    rec_del = recall_of(results, ground_truth(dev, queries, base, valid, 2))
    log(f"after deleting {len(del_ids)} ids: recall@10 {rec_del:.4f} "
        f"against the survivors, no deleted id returned")
    if rec_del < RECALL_GATE:
        fail(f"recall@10 after delete {rec_del:.4f} < {RECALL_GATE}")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="data seed")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    here = os.path.dirname(os.path.abspath(__file__))
    # the JAX package's C++ reverse-edge capper builds inside the checkout
    os.environ.setdefault(
        "SCINTIRETE_NATIVE_CACHE", os.path.join(here, "build", "native")
    )
    from scintirete_tpu_torch.ops import _ext

    card = card_line()
    log(f"card: {card}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    paths = _ext.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name, path in paths.items():
        for line in open(f"{path}.log"):
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    p_err, p_ms = check_pivot(dev, args.seed)
    l_err, l_ms = check_lane(dev, args.seed)
    launches = run_main_path(dev, N_BASE, N_QUERIES, args.seed)

    kernels = [
        {"name": "pivot_entry_scan", "route": "cuda",
         "source": "scintirete_tpu_torch/csrc/pivot_scan.cu",
         "replaces": "scintirete_tpu/ops/pallas_pivot.py:77",
         "launches": launches["pivot_entry_scan"], "max_abs_err": p_err,
         "ms": p_ms[0], "plain_ms": p_ms[1]},
        {"name": "knn_lane_topc", "route": "cuda",
         "source": "scintirete_tpu_torch/csrc/lane_scan.cu",
         "replaces": "scintirete_tpu/ops/pallas_scan.py:642",
         "launches": launches["knn_lane_topc"], "max_abs_err": l_err,
         "ms": l_ms[0], "plain_ms": l_ms[1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
