"""Chip check of the PyTorch/CUDA port (`scintirete_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero and prints no result line:
 1. a CUDA card must be present; prints its name and power limit;
 2. builds every CUDA kernel of the port from the sources in the checkout
    (nvcc, into build/kernels/) and the C++ link-application library (g++,
    into build/native/), and fails unless the C++ library loaded (so no
    number below comes from its numpy fallback); prints the build seconds,
    each kernel's registers and spills (-Xptxas -v) and instruction counts
    in the SASS (cuobjdump): HGMMA (bf16 wgmma) in the lane scan's, HGMMA
    and IGMMA (s8 wgmma) in the flat scan's, FFMA in the pivot scan's,
    failing if any of these is 0, and IDP4A (a __dp4a body) in the flat
    scan's and HMMA (TF32 or half products) in the pivot scan's, failing
    if either is not 0;
 3. holds each of the seven kernels against its plain torch version on the
    card, at the shapes of the main path: pivot_entry_scan (B=256 and 1,
    D=128, R=65,536, a ragged R and 262,144, 3 metrics, deleted pivots,
    all deleted; timed through its wrapper and as its C entry alone, and
    at B=1 and R=262,144 too), knn_lane_topc
    (B=2048, N=1,048,576, D=128, c=64, 3 metrics, partial n_valid) and
    knn_lane_topc_masked (B=2048, N=1,048,576, D=128, c=64, 3 metrics,
    self rows; mask = non-members of the layer-4 membership of a level
    draw, about 1/16 of the rows kept, plus 1% tombstones and a padded
    tail past 1,000,000), and the four scans of the flat index
    (lane_topk_scan_packed_int8 at tile groups of 1 and 4,
    lane_topk_scan_packed, lane_topk_scan_int8, lane_topk_scan: B=1024,
    N=1,048,576, D=128, 3 metrics, 1% deleted rows and an invalid tail
    past 1,000,000; the int8 scans must equal their plain versions bit for
    bit, the bf16 ones within the f32 sum-order tolerance (packed keys:
    their scores, tile ids cleared, within one kept unit plus the f32
    summation bound of the rows picked); both packed scans also with one
    query (the tile walk split into slices) and with 4,096, the other two
    batch sizes the flat path launches them at, at every metric and int8
    group, and timed at one query too; the unpacked int8 scan also at one
    query and 4,096, bit for bit, and timed at one query); the two graph-build
    scans also at B=1, at B=1,568 (a ragged round of the build) and with
    one tile on the 1M base, and at D=100 (padded to 104 columns) and
    D=768 (queries streamed) on a 65,536-row base, 3 metrics; prints the
    largest difference, the share of equal ids, the median times of
    kernel, plain version and the library product inside (torch.matmul on
    bf16, torch._int_mm on int8; CUDA events), and the kernel's bound (the
    larger of its operations over the card's peak and its bytes over
    3.35 TB/s);
 4. drives the main path at full size: Engine -> create_database ->
    create_collection (cosine HNSW, m=16, ef_construction=200,
    ef_search=12, seed=42, heuristic) -> Collection.insert of a 1,000,000 x
    128 corpus of the clustered workload-v2 generator -> search_batch in
    batches of 1024 (k=10); checks recall@10 >= 0.95 against the port's
    brute-force top-k on the card, that both build/search kernels were
    launched by this run, then deletes 1% of the ids and checks none of
    them comes back; then replays the build's candidate-scan schedule
    alone (the same level draw, every device-built layer, the same
    (query rows, prefix tiles) of each launch) and prints its scan seconds
    (CUDA events) per layer and in all beside the build seconds, failing
    unless it launches the scan as often as the build did;
 5. append: inserts 4 batches of 4,096 new vectors (same generator and
    centers) into that collection through Collection.insert (the batched
    append); prints seconds and vectors/s per batch; searches 4,096
    perturbed copies of base and appended points at ef_search=12 and fails
    below recall@10 0.95 against the brute force over every live vector;
    queries every appended vector and fails if fewer than 0.99 of them
    find their own id first; fails unless knn_lane_topc_masked was
    launched by this phase; prints each batch's seconds in its masked
    scans (CUDA events around each knn_lane_topc_masked call: the kernel
    and its exact top-c) beside the rest;
 6. chunked insertion: a fresh collection of the same config takes 50,000
    x 128 clustered vectors in 50 batches of 1,000 (each under the append
    threshold, so every batch takes the chunked device path); prints the
    seconds per batch and fails below recall@10 0.90 at ef_search=64;
 7. flat index at full size: Engine -> create_collection
    (index_type="flat", cosine) -> Collection.insert of the same 1,000,000
    x 128 corpus -> search_batch in batches of 1024 and one
    search_batch_arrays of all 4,096 queries; fails below recall@10 0.99
    against the brute force, if any returned distance differs from the
    exact distance of its row by more than 1e-5, if arrays and tuples
    disagree, if a deleted id comes back after deleting 1%, or if
    lane_topk_scan_packed_int8 was not launched; prints insert seconds,
    QPS at both batch sizes and peak device memory. Then the same corpus
    through FlatIndex(scan_dtype="bfloat16") directly, same checks, and
    lane_topk_scan_packed must have been launched. The counts of all four
    flat scans are set to 0 before this phase and read after it;
 8. durability (persistence/ and the engine's AOF bridge), each phase in a
    temporary directory whose free space it prints before it writes, and
    fails under twice what it is about to write; each prints one JSON line
    with its seconds, file bytes, recover()'s report and the card:
    A. after the append, on the 1M HNSW collection: a snapshot through a
       PersistenceManager (everysec), an AOF tail of 2 x 4,096 new vectors
       with metadata (logged as the server logs them, elements as lists)
       and 1,000 deletes (half old, half new); recovery into a fresh
       Engine on the card, timed apart (RDB load, restore, AOF replay,
       first search with the mirror upload); fails unless the report says
       3 commands and nothing degraded, every surviving tail vector reads
       back bit for bit with its metadata, no deleted id is readable or
       returned, recall@10 >= 0.95 and no lower than the live engine's,
       and pivot_entry_scan and knn_lane_topc_masked ran in the recovery
       and its searches; prints how many queries return other ids than
       the live engine;
    B. in the flat phase, the int8 collection after its delete: a
       snapshot recovered into a fresh engine, whose search_batch_arrays
       must equal the live one's bit for bit, ids and distances, and must
       launch lane_topk_scan_packed_int8;
    C. with no snapshot ever taken: a fresh engine logs 12 inserts of
       4,096 vectors and 1,000 deletes, and recovers from the AOF alone
       (the first INSERT builds through knn_lane_topc, the other 11 take
       the masked append; both must run in the replay; same checks as A);
       then a 100,000-row flat collection in the AOF-only regime is
       rewritten (maybe_rewrite_aof, records of 100 vectors), recovered
       from the rewritten log alone, and must search bit for bit as the
       live one and hand out the same next id;
 9. D, the server (server/, composed in process as
    `python -m scintirete_tpu_torch.cli.server_main` composes it): a
    ScintireteService on the card over phase A's data directory (its RDB
    and AOF tail), gRPC and HTTP on 127.0.0.1; times the recovery and the
    warm-up and fails if the warm-up warned. Then, each with its gate:
    A's 4,096 queries as 4 BatchSearch calls of 1,024 (ids equal to A's
    live collection's search_batch_arrays on every query, recall@10 >=
    0.95; QPS beside the same calls in process); the same queries as one
    Search RPC each from 64 client threads through the batcher (QPS, p50
    and p99 latency, its waves' widths; every answer equal to its
    BatchSearch one, ids and distance bits, whatever wave it rode in); 64
    of them over HTTP with Bearer auth (equal to the gRPC answers, bit for
    bit) and one wrong password on both transports (the
    reference's error); two InsertVectors of 4,096 onto the recovered
    graph, timed apart (>= 0.99 of them find themselves first), and
    DeleteVectors of 1,000 ids (none comes back); a flat cosine
    collection created over gRPC and fed the 1M corpus in InsertVectors of
    4,096 (vec/s with the AOF log), 4 BatchSearch calls of 1,024 and 256
    single Search calls (recall@10 >= 0.99, distances within 1e-5 of
    exact, singles equal to BatchSearch); the launches of pivot_entry_scan, knn_lane_topc_masked and
    lane_topk_scan_packed_int8 in all this must be above 0. Then Save over
    gRPC, the in-process server stops, and `python -m
    scintirete_tpu_torch.cli.server_main -config <toml>` starts on the same
    directory as a subprocess: 64 HNSW and 64 flat queries answer as
    before, every acknowledged write reads back (each surviving inserted
    HNSW vector in its own top 10, every flat row first for itself, the
    collections' counts), a one-shot `cli.main` command runs, and SIGTERM
    ends it with exit code 0; prints seconds from spawn to its first
    answer, and one JSON line for the phase;
10. E, the rest of the HNSW index (one JSON line for the phase):
    E1, right after phase 4's deletes, searches the main path's graph
    (kNN upper layers) through Collection's index in pivot mode, mid
    greedy, mid beam 4 and the pure greedy walk (HNSWIndex's entry_mode,
    ef_upper, descent_mid): QPS over the 4,096 queries in
    search_batch_arrays calls of 1,024, recall@10 against the survivors,
    the mean serial steps of a sub-batch above and at layer 0, and for
    each descent mode how many of 1,024 queries change ids or distance
    bits between one batch and waves of 32; gates: mid greedy >= 0.98,
    mid beam 4 >= 0.99, no deleted id in any mode, pivot_entry_scan
    launched; then pivot_entry_scan is held to its plain version at the
    mid scan's own shape (the graph's mid table, the 4,096 queries in
    sub-batches of 256; atol 1e-4, ids equal but for ties), launches not
    counted. After phase A frees its collection: E2 builds the corpus
    afresh with upper_mode="seq" (seconds of layer 0 and of the upper
    phase, its rounds, tiles and serial steps), searches it by the pure
    greedy walk, pure beams 2 and 4 and mid greedy (gate: pure beam 4 >=
    0.98) and checks its mid scan as E1's; E3 builds it with refine_rounds=1 (build and refine
    seconds; layer 0's kNN@10 overlap against the exact neighbors on
    4,096 sampled rows before and after the pass, which must not fall;
    pivot recall@10 >= 0.95). Each index is freed before the next is
    built, and knn_lane_topc and pivot_entry_scan must have been launched
    by E2 and E3;
11. S, sharding (one JSON line for the phase), after phase E frees its
    graphs: S1 builds the 1M corpus as ShardedHNSWIndex(devices=[cuda:0,
    cuda:0]) in one bulk_insert (two kNN builds of 500,000; seconds per
    shard and in all, each shard's build_stats); S2 searches the 4,096
    queries in batches of 1,024 (QPS, recall@10 >= 0.95 and no more than
    0.005 below the main path's unsharded recall in this run) and holds
    1,024 queries in waves of 32 against one batch (0 ids and 0 distance
    bits may differ); S3 deletes the main path's 1% (none may come back,
    recall@10 against the survivors) and appends 4 x 4,096 rows round
    robin, 2,048 a shard a batch, so each takes the batched append (seconds
    per batch; every appended row must find itself first); S4 exports the
    graph state and imports it onto the same two devices: the 4,096
    answers must be equal in ids and distance bits; S5 cuts the corpus to
    65,536 rows: an Engine with TPUConfig(shard_devices=2) on this one
    card serves an HNSW collection unsharded, as the JAX package does on
    one chip (recall@10 >= 0.95), and Collection.from_state of a two-shard
    state re-shards it onto the card's one device (recall@10 >= 0.95).
    pivot_entry_scan, knn_lane_topc and knn_lane_topc_masked must each be
    launched by the phase; peak device memory is printed;
12. prints the kernels' JSON line (seven entries; launches of the main
    path, phase E, phase S, the durability phases and phase D), the card's
    line, and last {"ok": true, "device": {...}}.

On one H100 the whole run takes about 7-10 minutes of the 20 it may take,
the durability phases about a minute of it, phase D about two, phase E
about one and a half and phase S about two or three; it prints its
total. Phase D's restart splits `server_main`'s spawn-to-first-answer
time from its log: up to main(), main's imports, the recovery, starting
the listeners, up to the first answer; the warm-up and the kernel
libraries' load run after it, in the background. A second interpreter,
which only imports `server_main` under `python -X importtime`, then
splits the imports before main() into torch's and the package's, apart
from the timed restart.

This script imports nothing of JAX and nothing of the JAX package, and
reads no environment variable. The data is made from --seed.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

RECALL_GATE = 0.95
FLAT_RECALL_GATE = 0.99  # exact search: only first-pass rounding can miss
FLAT_DIST_TOL = 1e-5  # returned distance against the exact one of its row
SELF_GATE = 0.99
CHUNKED_GATE = 0.90  # tests/test_bulk_build.py gates the chunked build here
DIM, K, BATCH = 128, 10, 1024
N_BASE, N_QUERIES = 1_000_000, 4096
N_CLUSTERS_PER_100K = 1000
APPEND_BATCHES, APPEND_BATCH = 4, 4096
CHUNKED_BATCHES, CHUNKED_BATCH = 50, 1000
AOF_INSERTS = 12  # phase C: logged inserts of APPEND_BATCH vectors
REWRITE_ROWS = 100_000  # phase C: the flat collection the rewrite compacts
# phase D: the server
SERVE_PASSWORD = "smoke-password"
SERVE_THREADS = 64  # client threads sending one Search RPC per query
SERVE_HTTP = 64  # queries over HTTP
SERVE_FLAT_ROWS = N_BASE  # the flat collection fed over gRPC
SERVE_FLAT_SINGLES = 256  # flat single-query Search RPCs
SERVE_RESTART = 64  # queries per collection checked across the restart
INGEST_BATCH = 4096  # vectors per InsertVectors request
# the card's published peaks (H100 SXM data sheet, dense): operations/s
# by input type, and device-memory bytes/s
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12


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


def hnsw_params():
    """The main path's graph parameters (the HNSW phases' collections)."""
    from scintirete_tpu_torch import HNSWParams

    return HNSWParams(m=16, ef_construction=200, ef_search=12, seed=42,
                      neighbor_heuristic=True)


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


def bound_ms(flops: float, kind: str, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over the peak rate of their input type and the bytes (each input read
    once, each output written once) over the memory rate."""
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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


def pivot_entry_ms(q, pv, psq, pdel, metric):
    """The pivot scan's C entry alone (no wrapper): median ms of 50, the
    inputs already TMA-wide and the outputs allocated once."""
    import torch

    from scintirete_tpu_torch.ops._ext import kernel

    B, D = q.shape
    keys = torch.empty(B, dtype=torch.int64, device=q.device)
    d = torch.empty(B, dtype=torch.float32, device=q.device)
    i = torch.empty(B, dtype=torch.int32, device=q.device)
    fn = kernel("pivot_scan")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (q, pv, psq, pdel, keys, d, i)]

    def run():
        err = fn(*ptrs, B, pv.shape[0], D, metric, stream)
        if err:
            fail(f"pivot_entry_scan C entry: cudaError {err}")

    return median_ms(run, 50)


def check_pivot(dev, seed):
    import torch

    from scintirete_tpu_torch.ops.pivot_scan import (
        pivot_entry_scan,
        pivot_entry_scan_plain,
    )

    g = torch.Generator(device=dev).manual_seed(seed)
    D = 128
    worst_err, worst_share, timing, extra = 0.0, 1.0, None, {}
    for R in (65536, 65536 - 300, 262144):
        for metric in (1, 2, 3):
            q_all = torch.randn(256, D, generator=g, device=dev)
            pv = torch.randn(R, D, generator=g, device=dev)
            if metric == 2:
                q_all = q_all / q_all.norm(dim=1, keepdim=True)
                pv = pv / pv.norm(dim=1, keepdim=True)
            psq = (pv * pv).sum(1)
            pdel = torch.zeros(R, device=dev)
            pdel[::7] = 1.0
            for B in (256, 1):  # a search sub-batch and the single search
                q = q_all[:B]
                args = (q, pv, psq, pdel, metric)
                d_k, i_k = pivot_entry_scan(*args)
                d_p, i_p = pivot_entry_scan_plain(*args)
                torch.cuda.synchronize()
                err, share = compare(
                    f"pivot_entry_scan B={B} R={R} metric={metric}", d_k, i_k,
                    d_p, i_p, atol=1e-4, rtol=1e-5,
                )
                log(f"pivot_entry_scan B={B} R={R} metric={metric}: "
                    f"max|dd|={err:.3g} ids equal {share:.6f}")
                worst_err = max(worst_err, err)
                worst_share = min(worst_share, share)
            if metric != 2:
                continue
            full = (q_all, pv, psq, pdel, metric)
            if R == 65536:
                timing = (
                    median_ms(lambda: pivot_entry_scan(*full), 50),
                    median_ms(lambda: pivot_entry_scan_plain(*full), 20),
                    # the product inside alone, as one library call
                    median_ms(lambda: torch.matmul(q_all, pv.T), 50),
                )
                extra["entry"] = pivot_entry_ms(q_all, pv, psq, pdel, metric)
                # q, pivots, their norms and tombstones in; (d, i) out
                nbytes = 4 * (256 * D + R * D + 2 * R + 2 * 256)
                bound = bound_ms(2.0 * 256 * R * D, "f32", nbytes)
                extra["B=1"] = median_ms(
                    lambda: pivot_entry_scan(q_all[:1], *full[1:]), 50
                )
            elif R == 262144:
                extra["R=262144"] = median_ms(
                    lambda: pivot_entry_scan(*full), 50
                )
        d_k, i_k = pivot_entry_scan(q_all, pv, psq, torch.ones(R, device=dev), 1)
        if not (bool(torch.isinf(d_k).all()) and bool((d_k > 0).all())
                and bool((i_k == -1).all())):
            fail("pivot_entry_scan: all-deleted case must give (+inf, -1)")
    log(f"pivot_entry_scan B=256 R=65536 D=128 cosine: kernel "
        f"{timing[0]:.4f} ms through its wrapper, C entry alone "
        f"{extra['entry']:.4f} ms, plain {timing[1]:.4f} ms, matmul "
        f"{timing[2]:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); kernel "
        f"at B=1 {extra['B=1']:.4f} ms, at R=262144 {extra['R=262144']:.4f} "
        f"ms; ids equal {worst_share:.6f} at worst")
    return worst_err, timing, bound


def compare_lanes(name, k_out, p_out):
    """compare() on both halves of a lane scan's (d1, i1, d2, i2), kernel
    against plain; logs and returns (largest distance difference, least
    share of equal ids)."""
    import torch

    torch.cuda.synchronize()
    worst, least = 0.0, 1.0
    for which, (dk, ik, dp, ip) in (
        ("best", (k_out[0], k_out[1], p_out[0], p_out[1])),
        ("second", (k_out[2], k_out[3], p_out[2], p_out[3])),
    ):
        err, share = compare(f"{name} lane {which}", dk, ik, dp, ip,
                             atol=1e-4, rtol=1e-5)
        worst, least = max(worst, err), min(least, share)
    log(f"{name}: max|dd|={worst:.3g} ids equal {least:.6f}")
    return worst, least


def check_lane_depths(dev, seed):
    """Both graph-build scans at the depths the main path does not give: a D
    the kernel pads (100 -> 104 columns) and one whose queries stream
    through the ring (768), on a 65,536-row base. Returns the largest
    distance difference of each kernel."""
    import torch

    from scintirete_tpu_torch.ops.lane_scan import (
        LANES,
        lane_scan,
        lane_scan_masked,
        lane_scan_masked_plain,
        lane_scan_plain,
    )

    g = torch.Generator(device=dev).manual_seed(seed + 5)
    B, N = 300, 65536
    worst = {"knn_lane_topc": 0.0, "knn_lane_topc_masked": 0.0}
    for D in (100, 768):
        base32 = torch.randn(N, D, generator=g, device=dev)
        invalid = (torch.rand(N, generator=g, device=dev) < 0.3).float()
        si = torch.randperm(N, generator=g, device=dev)[:B].to(torch.int32)
        for metric in (1, 2, 3):
            b32 = base32 / base32.norm(dim=1, keepdim=True) if metric == 2 else base32
            base = b32.to(torch.bfloat16)
            bsq = (b32 * b32).sum(1)
            qb = base[si.long()].contiguous()
            tag = f"metric={metric} B={B} N={N} D={D}"
            err, _ = compare_lanes(
                f"knn_lane_topc {tag}",
                lane_scan(qb, si, base, bsq, N - 777, metric, N // LANES),
                lane_scan_plain(qb, si, base, bsq, N - 777, metric, N // LANES),
            )
            worst["knn_lane_topc"] = max(worst["knn_lane_topc"], err)
            err, _ = compare_lanes(
                f"knn_lane_topc_masked {tag}",
                lane_scan_masked(qb, si, base, bsq, invalid, metric, N // LANES),
                lane_scan_masked_plain(qb, si, base, bsq, invalid, metric,
                                       N // LANES),
            )
            worst["knn_lane_topc_masked"] = max(
                worst["knn_lane_topc_masked"], err
            )
    return worst


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
    worst_err, timing = 0.0, None
    base32 = torch.randn(N, D, generator=g, device=dev)
    for metric in (1, 2, 3):
        b32 = base32 / base32.norm(dim=1, keepdim=True) if metric == 2 else base32
        base = b32.to(torch.bfloat16)
        bsq = (b32 * b32).sum(1)
        qb = base[:B].contiguous()
        si = torch.arange(B, dtype=torch.int32, device=dev)
        n_valid = 700_001
        tiles = -(-n_valid // LANES)
        # the path's shape; one query, a ragged round of the build (1,568
        # rows) and one tile
        for b, nv, t in ((B, n_valid, tiles), (1, n_valid, tiles),
                         (1568, N, N // LANES), (B, LANES, 1)):
            err, _ = compare_lanes(
                f"knn_lane_topc metric={metric} B={b} grid_tiles={t}",
                lane_scan(qb[:b], si[:b], base, bsq, nv, metric, t),
                lane_scan_plain(qb[:b], si[:b], base, bsq, nv, metric, t),
            )
            worst_err = max(worst_err, err)
        cd, ci = knn_lane_topc(qb, si, base, bsq, n_valid, metric, c, tiles)
        if tuple(cd.shape) != (B, c) or not bool(torch.isfinite(cd).all()):
            fail("knn_lane_topc: top-c must be finite [B, c]")
        if bool((ci >= n_valid).any()) or bool((ci == si[:, None]).any()):
            fail("knn_lane_topc: masked row returned")
        if bool((cd[:, 1:] < cd[:, :-1]).any()):
            fail("knn_lane_topc: top-c not ascending")
        if metric == 2:
            full = (qb, si, base, bsq, N, metric, N // LANES)
            timing = (
                median_ms(lambda: lane_scan(*full), 10),
                median_ms(lambda: lane_scan_plain(*full), 3),
                median_ms(lambda: torch.matmul(qb, base.T), 10),
            )
    # bf16 q and base, f32 norms in; four [B, LANES] lane arrays out
    nbytes = 2 * (B * D + N * D) + 4 * (N + B) + 16 * B * LANES
    bound = bound_ms(2.0 * B * N * D, "bf16", nbytes)
    log(f"knn_lane_topc B=2048 N=1048576 D=128 cosine full scan: kernel "
        f"{timing[0]:.3f} ms, plain {timing[1]:.3f} ms, matmul "
        f"{timing[2]:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    return worst_err, timing, bound


def check_lane_masked(dev, seed):
    import torch

    from scintirete_tpu_torch.ops.lane_scan import (
        LANES,
        knn_lane_topc_masked,
        lane_scan_masked,
        lane_scan_masked_plain,
    )

    g = torch.Generator(device=dev).manual_seed(seed + 2)
    rng = np.random.default_rng(seed + 2)
    B, N, D, c, count = 2048, 1 << 20, 128, 64, 1_000_000
    # mask of an upper layer of an append: a level draw (P(level >= l) =
    # 2^-l, as GraphStore.draw_levels), membership of layer 4 (about 1/16
    # of the rows), 1% tombstones, and the padded tail past `count`
    levels = np.floor(-np.log(1.0 - rng.random(N)) / np.log(2.0))
    inv = (levels < 4) | (rng.random(N) < 0.01)
    inv[count:] = True
    invalid = torch.from_numpy(inv.astype(np.float32)).to(dev)
    members = np.nonzero(~inv)[0]
    # queries are members (self rows excluded in-kernel) plus outsiders
    q_rows = np.concatenate([members[: B // 2], rng.integers(0, count, B // 2)])
    si = torch.from_numpy(q_rows.astype(np.int32)).to(dev)
    tiles = -(-count // LANES)
    worst_err, timing = 0.0, None
    base32 = torch.randn(N, D, generator=g, device=dev)
    for metric in (1, 2, 3):
        b32 = base32 / base32.norm(dim=1, keepdim=True) if metric == 2 else base32
        base = b32.to(torch.bfloat16)
        bsq = (b32 * b32).sum(1)
        qb = base[si.long()].contiguous()
        for b, t in ((B, tiles), (1, tiles), (1568, N // LANES), (B, 1)):
            err, _ = compare_lanes(
                f"knn_lane_topc_masked metric={metric} B={b} grid_tiles={t}",
                lane_scan_masked(qb[:b], si[:b], base, bsq, invalid, metric, t),
                lane_scan_masked_plain(
                    qb[:b], si[:b], base, bsq, invalid, metric, t
                ),
            )
            worst_err = max(worst_err, err)
        cd, ci = knn_lane_topc_masked(
            qb, si, base, bsq, invalid, metric, c, tiles, q_sq=bsq[si.long()]
        )
        if tuple(cd.shape) != (B, c) or not bool(torch.isfinite(cd).all()):
            fail("knn_lane_topc_masked: top-c must be finite [B, c]")
        if bool((invalid[ci.long()] > 0.5).any()) or bool(
            (ci == si[:, None]).any()
        ):
            fail("knn_lane_topc_masked: masked or self row returned")
        if bool((cd[:, 1:] < cd[:, :-1]).any()):
            fail("knn_lane_topc_masked: top-c not ascending")
        if metric == 2:
            full = (qb, si, base, bsq, invalid, metric, N // LANES)
            timing = (
                median_ms(lambda: lane_scan_masked(*full), 10),
                median_ms(lambda: lane_scan_masked_plain(*full), 3),
                median_ms(lambda: torch.matmul(qb, base.T), 10),
            )
    # bf16 q and base, f32 norms and mask in; four lane arrays out
    nbytes = 2 * (B * D + N * D) + 4 * (2 * N + B) + 16 * B * LANES
    bound = bound_ms(2.0 * B * N * D, "bf16", nbytes)
    log(f"knn_lane_topc_masked B=2048 N=1048576 D=128 cosine full scan: "
        f"kernel {timing[0]:.3f} ms, plain {timing[1]:.3f} ms, matmul "
        f"{timing[2]:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    return worst_err, timing, bound


FLAT_B, FLAT_N, FLAT_COUNT = 1024, 1 << 20, 1_000_000
KEY_RTOL = 2.0**-10  # one unit of the last mantissa bit a packed key keeps


def flat_kernel_inputs(dev, seed):
    """Inputs of the four flat scans at the flat path's shape: one search
    batch against a full 2^20-row capacity, 1% deleted rows, and the rows
    past 1,000,000 zero and invalid as in a FlatIndex mirror."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed + 4)
    base32 = torch.randn(FLAT_N, DIM, generator=g, device=dev)
    base32[FLAT_COUNT:] = 0.0
    q = torch.randn(FLAT_B, DIM, generator=g, device=dev)
    invalid = (torch.rand(FLAT_N, generator=g, device=dev) < 0.01).float()
    invalid[FLAT_COUNT:] = 1.0
    return q, base32, invalid


def scan_form(x, metric):
    """Cosine scans rank by -dot over normalized rows; zero rows stay 0."""
    if metric != 2:
        return x
    n = x.norm(dim=1, keepdim=True)
    return (x / n.clamp(min=1e-30)) * (n > 1e-30)


def no_invalid_row(name, rows, invalid):
    if bool((invalid[rows.clamp(min=0).long()] > 0.5)[rows >= 0].any()):
        fail(f"{name}: a deleted or empty row came out of the scan")


def log_timing(name, what, timing, bound, one_ms=None):
    lib = "no single call" if timing[2] is None else f"{timing[2]:.3f} ms"
    one = "" if one_ms is None else f", kernel at B=1 {one_ms:.4f} ms"
    log(f"{name} B={FLAT_B} N={FLAT_N} D={DIM} cosine: kernel "
        f"{timing[0]:.3f} ms, plain {timing[1]:.3f} ms, {what} {lib}, "
        f"bound {bound[0]:.4f} ms ({bound[1]}){one}")


def other_batches(dev, metric):
    """The flat path's other two batch sizes for one launch: all 4,096
    queries (a grid four times deeper, one slice) and one query (127
    padded rows in its block; the tile walk split into slices)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(4096)
    q_all = scan_form(
        torch.randn(N_QUERIES, DIM, generator=g, device=dev), metric
    )
    return q_all, (N_QUERIES, 1)


def int_mm_ms(q8, base8):
    """The int8 product alone as one library call, where torch._int_mm's
    shape rules take it; None (with the reason) where they do not."""
    import torch

    try:
        return median_ms(lambda: torch._int_mm(q8, base8.T), 10)
    except RuntimeError as exc:
        log(f"torch._int_mm does not take this product: {exc}")
        return None


def check_packed_int8(dev, inputs):
    import torch

    from scintirete_tpu_torch.ops import packed_scan as ps

    name = "lane_topk_scan_packed_int8"
    q, base32, invalid = inputs
    worst, timing = 0.0, None
    for metric in (1, 2, 3):
        qs, b32 = scan_form(q, metric), scan_form(base32, metric)
        base8, scale = ps.quantize_rows(b32)
        bsq = (b32 * b32).sum(1)
        # the flat path's other batch sizes, on the same base
        q_all, sizes = other_batches(dev, metric)
        q8_all, qs2_all = ps.packed_int8_inputs(
            q_all, scale, bsq, invalid, metric
        )[:2]
        for tps in (1, 4):  # tile groups of 1 and 4
            group = min(ps._PREMIN, tps)
            args = (qs, base8, scale, bsq, invalid, metric)
            keys, rows = ps.lane_topk_scan_packed_int8(*args, tps=tps)
            q8, qs2, bs, bq = ps.packed_int8_inputs(qs, scale, bsq, invalid, metric)

            def plain():
                return ps.lane_topk_scan_packed_int8_plain(
                    q8, qs2, base8, bs, bq, metric, group
                )

            want = plain()
            torch.cuda.synchronize()
            same = keys.view(torch.int32) == want.view(torch.int32)
            worst = max(worst, float((keys - want).abs().max()))
            # the s8 x s8 -> s32 product is exact and no multiply is
            # contracted: bit for bit
            if not bool(same.all()):
                fail(f"{name} metric={metric} tps={tps}: "
                     f"{int((~same).sum())} keys differ from the plain version")
            if not torch.equal(rows, ps.unpack_lane_keys(want)[1]):
                fail(f"{name} metric={metric} tps={tps}: rows differ")
            no_invalid_row(name, rows, invalid)
            log(f"{name} metric={metric} group={group}: keys equal bit for "
                f"bit, rows equal")
            if metric == 2 and tps == 1:
                timing = (
                    median_ms(lambda: ps.lane_topk_scan_packed_int8(*args), 10),
                    median_ms(plain, 2),
                    int_mm_ms(q8, base8),
                )
            want = ps.lane_topk_scan_packed_int8_plain(
                q8_all, qs2_all, base8, bs, bq, metric, group
            )
            for b in sizes:
                keys, rows = ps.lane_topk_scan_packed_int8(
                    q_all[:b], *args[1:], tps=tps
                )
                if not torch.equal(keys.view(torch.int32),
                                   want[:b].view(torch.int32)):
                    fail(f"{name} metric={metric} group={group} B={b}: keys "
                         f"differ from the plain version")
                if not torch.equal(rows, ps.unpack_lane_keys(want[:b])[1]):
                    fail(f"{name} metric={metric} group={group} B={b}: rows "
                         f"differ")
                no_invalid_row(name, rows, invalid)
                log(f"{name} metric={metric} group={group} B={b}: keys equal "
                    f"bit for bit, rows equal")
            if metric == 2 and tps == 1:
                one_ms = median_ms(
                    lambda: ps.lane_topk_scan_packed_int8(q_all[:1], *args[1:]),
                    10,
                )
    # f32 queries, int8 base, scales, norms and mask in; keys and rows out
    nbytes = 4 * FLAT_B * DIM + FLAT_N * DIM + 12 * FLAT_N + 16 * FLAT_B * 1024
    bound = bound_ms(2.0 * FLAT_B * FLAT_N * DIM, "int8", nbytes)
    log_timing(name, "torch._int_mm", timing, bound, one_ms)
    return worst, timing, bound


def check_packed(dev, inputs):
    import torch

    from scintirete_tpu_torch.ops import packed_scan as ps

    name = "lane_topk_scan_packed"
    q, base32, invalid = inputs
    worst, timing = 0.0, None
    for metric in (1, 2, 3):
        qs, b32 = scan_form(q, metric), scan_form(base32, metric)
        base = b32.to(torch.bfloat16)
        bsq = (b32 * b32).sum(1)
        args = (qs, base, bsq, invalid, metric)
        # the path's batch, then its other two sizes on the same base
        q_all, sizes = other_batches(dev, metric)
        for qx in (qs, *(q_all[:b] for b in sizes)):
            b = qx.shape[0]
            keys, rows = ps.lane_topk_scan_packed(qx, *args[1:])
            want = ps.lane_topk_scan_packed_plain(
                qx.to(torch.bfloat16), base, bsq, invalid, metric
            )
            torch.cuda.synchronize()
            if not bool(torch.isfinite(keys).all()):
                fail(f"{name} metric={metric} B={b}: a packed key is not "
                     f"finite")
            worst = max(worst, float((keys - want).abs().max()))
            # the kernel sums each dot in f32 in another order than the
            # library: the scores (tile ids cleared: rows of a near tie
            # that the two sides order differently carry different ids)
            # within one kept unit plus the f32 summation bound of the
            # rows either side picked (packed_bf16_sum_bound)
            same = rows == ps.unpack_lane_keys(want)[1]
            score = ps.packed_key_scores(keys)
            want_score = ps.packed_key_scores(want)
            diff = (score - want_score).abs()
            unit = KEY_RTOL * want_score.abs()
            sums = ps.packed_bf16_sum_bound(
                rows, want, qx.to(torch.bfloat16), base, bsq, metric
            )
            over = diff > unit + sums
            if bool(over.any()):
                fail(f"{name} metric={metric} B={b}: {int(over.sum())} key "
                     f"scores beyond the bound (up to {float(diff.max())}; "
                     f"{int((over & ~same).sum())} of them where the rows "
                     f"differ)")
            past_unit = int((diff > unit).sum())
            share = float(same.float().mean())
            bits = float((keys.view(torch.int32) == want.view(torch.int32))
                         .float().mean())
            if share < 0.999:
                fail(f"{name} metric={metric} B={b}: only {share:.6f} of the "
                     f"rows equal")
            no_invalid_row(name, rows, invalid)
            log(f"{name} metric={metric} B={b}: max|dk|="
                f"{float((keys - want).abs().max()):.3g} max|d score|="
                f"{float(diff.max()):.3g}, {past_unit} of {diff.numel()} "
                f"past one kept unit (largest sum bound "
                f"{float(sums.max()):.3g}), keys bit-equal {bits:.6f} rows "
                f"equal {share:.6f}")
        if metric == 2:
            qb = qs.to(torch.bfloat16)
            timing = (
                median_ms(lambda: ps.lane_topk_scan_packed(*args), 10),
                median_ms(lambda: ps.lane_topk_scan_packed_plain(
                    qb, base, bsq, invalid, metric), 2),
                median_ms(lambda: torch.matmul(qb, base.T), 10),
            )
            one_ms = median_ms(
                lambda: ps.lane_topk_scan_packed(q_all[:1], *args[1:]), 10
            )
    # f32 queries, bf16 base, norms and mask in; keys and rows out
    nbytes = 4 * FLAT_B * DIM + 2 * FLAT_N * DIM + 8 * FLAT_N + 16 * FLAT_B * 1024
    bound = bound_ms(2.0 * FLAT_B * FLAT_N * DIM, "bf16", nbytes)
    log_timing(name, "matmul", timing, bound, one_ms)
    return worst, timing, bound


def check_lane_int8(dev, inputs):
    import torch

    from scintirete_tpu_torch.ops import packed_scan as ps

    name = "lane_topk_scan_int8"
    q, base32, invalid = inputs
    worst, timing, one_ms = 0.0, None, None
    for metric in (1, 2, 3):
        qs, b32 = scan_form(q, metric), scan_form(base32, metric)
        base8, scale = ps.quantize_rows(b32)
        bsq = (b32 * b32).sum(1)
        args = (qs, base8, scale, bsq, invalid, metric)
        q8, q_scale = ps.quantize_rows(qs)

        def plain():
            return ps.lane_topk_scan_int8_plain(
                q8, q_scale, base8, scale, bsq, invalid, metric
            )

        # the path's batch, then one query and 4,096 (one full walk each
        # block; the walk is never split)
        q_all, sizes = other_batches(dev, metric)
        q8_all, qs_all = ps.quantize_rows(q_all)
        want_all = ps.lane_topk_scan_int8_plain(
            q8_all, qs_all, base8, scale, bsq, invalid, metric
        )
        for qx, (want_d, want_i) in (
            (qs, plain()),
            *((q_all[:b], (want_all[0][:b], want_all[1][:b])) for b in sizes),
        ):
            d, i = ps.lane_topk_scan_int8(qx, *args[1:])
            torch.cuda.synchronize()
            b = qx.shape[0]
            # exact product, no contraction: equal bit for bit
            if not (torch.equal(d.view(torch.int32), want_d.view(torch.int32))
                    and torch.equal(i, want_i)):
                fail(f"{name} metric={metric} B={b}: "
                     f"{int((d.view(torch.int32) != want_d.view(torch.int32)).sum())}"
                     f" scores and {int((i != want_i).sum())} rows differ from "
                     f"the plain version")
            fin = torch.isfinite(want_d)
            worst = max(worst, float((d - want_d).abs()[fin].max()))
            no_invalid_row(name, i, invalid)
            log(f"{name} metric={metric} B={b}: scores and rows equal bit for "
                f"bit")
        if metric == 2:
            timing = (
                median_ms(lambda: ps.lane_topk_scan_int8(*args), 10),
                median_ms(plain, 2),
                int_mm_ms(q8, base8),
            )
            one_ms = median_ms(
                lambda: ps.lane_topk_scan_int8(q_all[:1], *args[1:]), 10
            )
    nbytes = 4 * FLAT_B * DIM + FLAT_N * DIM + 12 * FLAT_N + 16 * FLAT_B * 1024
    bound = bound_ms(2.0 * FLAT_B * FLAT_N * DIM, "int8", nbytes)
    log_timing(name, "torch._int_mm", timing, bound, one_ms)
    return worst, timing, bound


def check_lane_flat(dev, inputs):
    import torch

    from scintirete_tpu_torch.ops import packed_scan as ps

    name = "lane_topk_scan"
    q, base32, invalid = inputs
    worst, timing = 0.0, None
    for metric in (1, 2, 3):
        qs, b32 = scan_form(q, metric), scan_form(base32, metric)
        base = b32.to(torch.bfloat16)
        qb = qs.to(torch.bfloat16)
        bsq = (b32 * b32).sum(1)
        args = (qs, base, bsq, invalid, metric)
        d, i = ps.lane_topk_scan(*args)
        want_d, want_i = ps.lane_topk_scan_plain(qb, base, bsq, invalid, metric)
        torch.cuda.synchronize()
        err, share = compare(f"{name} metric={metric}", d, i, want_d, want_i,
                             atol=1e-4, rtol=1e-5)
        worst = max(worst, err)
        no_invalid_row(name, i, invalid)
        log(f"{name} metric={metric}: max|dd|={err:.3g} ids equal {share:.6f}")
        if metric == 2:
            timing = (
                median_ms(lambda: ps.lane_topk_scan(*args), 10),
                median_ms(lambda: ps.lane_topk_scan_plain(
                    qb, base, bsq, invalid, metric), 2),
                median_ms(lambda: torch.matmul(qb, base.T), 10),
            )
    nbytes = 4 * FLAT_B * DIM + 2 * FLAT_N * DIM + 8 * FLAT_N + 16 * FLAT_B * 1024
    bound = bound_ms(2.0 * FLAT_B * FLAT_N * DIM, "bf16", nbytes)
    log_timing(name, "matmul", timing, bound)
    return worst, timing, bound


def make_dataset(rng, n, n_queries):
    """Workload v2 (bench.py's generator): cluster centers + per-point
    noise; queries are perturbed near-duplicates of base points. Returns
    (base, queries, centers)."""
    n_clusters = max(N_CLUSTERS_PER_100K * n // 100_000, 100)
    centers = rng.standard_normal((n_clusters, DIM)).astype(np.float32) * 2.0
    base = points_near(rng, centers, n)
    queries = perturbed(rng, base, n_queries)
    return base, queries, centers


def points_near(rng, centers, n):
    assign = rng.integers(0, len(centers), n)
    return (centers[assign] + 0.4 * rng.standard_normal((n, DIM))).astype(
        np.float32
    )


def perturbed(rng, points, n_queries):
    qi = rng.integers(0, len(points), n_queries)
    return (
        points[qi] + 0.2 * rng.standard_normal((n_queries, DIM))
    ).astype(np.float32)


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
        SearchParams,
    )
    from scintirete_tpu_torch.engine import Engine
    from scintirete_tpu_torch.ops.lane_scan import lane_scan
    from scintirete_tpu_torch.ops.pivot_scan import pivot_entry_scan

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    base, queries, centers = make_dataset(rng, n, n_queries)
    log(f"dataset {n} x {DIM} + {n_queries} queries in "
        f"{time.perf_counter() - t0:.1f} s")
    true_i = ground_truth(dev, queries, base, np.ones(n, bool), 2)

    pivot_entry_scan.launches = 0
    lane_scan.launches = 0
    engine = Engine(device=dev)
    col = engine.create_database("smoke").create_collection(CollectionConfig(
        name="c", metric=DistanceMetric.COSINE, hnsw=hnsw_params(),
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
    true_after = ground_truth(dev, queries, base, valid, 2)
    rec_del = recall_of(results, true_after)
    log(f"after deleting {len(del_ids)} ids: recall@10 {rec_del:.4f} "
        f"against the survivors, no deleted id returned")
    if rec_del < RECALL_GATE:
        fail(f"recall@10 after delete {rec_del:.4f} < {RECALL_GATE}")
    flat_case = (queries, true_i, del_ids, true_after)
    return (launches, engine, col, base, valid, centers, rng, flat_case,
            build_s, rec)


def replay_build_scans(dev, base, build_s, main_launches):
    """The 1M build's candidate-scan schedule alone: the level draw of the
    main path's collection (the first draw of a fresh store with its seed),
    every layer built on the device (more than HOST_LAYER_MAX members),
    and for each the doubling-round query tiles of `_query_tiles` with
    their prefixes, each one lane_scan launch over the build's padded
    scan base (cosine), timed with CUDA events around each layer. Fails
    unless it launches as often as the build did."""
    import torch

    from scintirete_tpu_torch import DistanceMetric
    from scintirete_tpu_torch.index import knn_build
    from scintirete_tpu_torch.index.store import GraphStore
    from scintirete_tpu_torch.ops.lane_scan import lane_scan

    n = len(base)
    store = GraphStore(DIM, hnsw_params(), DistanceMetric.COSINE)
    levels = store.draw_levels(n)
    ctx = knn_build._make_build_ctx(base, 2, dev)
    si = torch.arange(ctx["npad"], dtype=torch.int32, device=dev)
    layers = []
    for lv in range(int(levels.max()) + 1):
        nm = int(np.count_nonzero(levels >= lv))
        if nm > knn_build.HOST_LAYER_MAX:
            layers.append((lv, nm, list(knn_build._query_tiles(ctx, nm))))
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(layers) + 1)]
    events[0].record()
    for (lv, nm, tiles), done in zip(layers, events[1:]):
        for qs, qe, prefix in tiles:
            lane_scan(ctx["base"][qs:qe], si[qs:qe], ctx["base"],
                      ctx["base_sq"], prefix, 2, knn_build._grid_for(prefix))
        done.record()
    events[-1].synchronize()
    launches = sum(len(t) for _, _, t in layers)
    total_s = events[0].elapsed_time(events[-1]) / 1e3
    for (lv, nm, tiles), a, b in zip(layers, events, events[1:]):
        rows = sum(knn_build._grid_for(p) for _, _, p in tiles)
        log(f"  layer {lv}: {nm} members, {len(tiles)} launches, "
            f"{rows} tile passes of {knn_build.LANES} rows, "
            f"{a.elapsed_time(b) / 1e3:.4f} s")
    log(f"build scan replay: {launches} launches in {total_s:.4f} s of "
        f"scan (CUDA events) beside the build's {build_s:.2f} s")
    if launches != main_launches:
        fail(f"the replay launched {launches} scans, the build "
             f"{main_launches}")
    del ctx
    torch.cuda.empty_cache()


def sass_count(path, opcode: str):
    """How many instructions of `opcode` the library's SASS holds
    (`cuobjdump -sass`), or None where the toolkit has no cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    out = subprocess.run([exe, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        return None
    return sum(opcode in line for line in out.stdout.splitlines())


def check_results(results, n_want):
    for res in results:
        if len(res) != n_want:
            fail(f"search returned {len(res)} hits, want {n_want}")
        d = np.asarray([r.distance for r in res])
        if not np.all(np.isfinite(d)) or np.any(np.diff(d) < 0):
            fail("search distances must be finite and ascending")


def run_append(dev, col, base, valid, centers, rng):
    """Batched append onto the built 1M collection, right after its
    delete (so the append's cached adjacency must see the tombstones)."""
    import torch

    from scintirete_tpu_torch import SearchParams
    from scintirete_tpu_torch.index import knn_build
    from scintirete_tpu_torch.ops.lane_scan import lane_scan, lane_scan_masked

    n = len(base)
    new = points_near(rng, centers, APPEND_BATCHES * APPEND_BATCH)
    lane_scan_masked.launches = 0
    lane_scan.launches = 0
    # the scans' share of a batch: CUDA events around each call the append
    # makes of knn_lane_topc_masked (the masked kernel and its exact top-c)
    spans = []
    scan_call = knn_build.knn_lane_topc_masked

    def timed_scan(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = scan_call(*a, **k)
        ev[1].record()
        spans.append(ev)
        return out

    knn_build.knn_lane_topc_masked = timed_scan
    per_batch = []
    try:
        for b in range(APPEND_BATCHES):
            chunk = new[b * APPEND_BATCH : (b + 1) * APPEND_BATCH]
            spans.clear()
            t0 = time.perf_counter()
            ids = col.insert([(v, None) for v in chunk])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            want = n + b * APPEND_BATCH + 1
            if ids != list(range(want, want + APPEND_BATCH)):
                fail("append must assign the next ids")
            per_batch.append(dt)
            scan_s = sum(a.elapsed_time(z) for a, z in spans) / 1e3
            log(f"append batch {b}: {APPEND_BATCH} vectors in {dt:.3f} s = "
                f"{APPEND_BATCH / dt:.1f} vec/s; {len(spans)} masked scans "
                f"with their top-c {scan_s:.4f} s (CUDA events), the rest "
                f"{dt - scan_s:.3f} s")
    finally:
        knn_build.knn_lane_topc_masked = scan_call
    launches = lane_scan_masked.launches
    log(f"append launches: knn_lane_topc_masked {launches}, knn_lane_topc "
        f"{lane_scan.launches}")
    if launches <= 0:
        fail("knn_lane_topc_masked was not launched by the append")

    everything = np.concatenate([base, new])
    live = np.concatenate([valid, np.ones(len(new), bool)])
    queries = np.concatenate([
        perturbed(rng, base[valid], N_QUERIES // 2),
        perturbed(rng, new, N_QUERIES // 2),
    ])
    sp = SearchParams(top_k=K, ef_search=12)
    results = []
    for s in range(0, len(queries), BATCH):
        results.extend(col.search_batch(queries[s : s + BATCH], sp))
    check_results(results, K)
    rec = recall_of(results, ground_truth(dev, queries, everything, live, 2))
    top1 = []
    for s in range(0, len(new), BATCH):
        res = col.search_batch(new[s : s + BATCH], SearchParams(top_k=1, ef_search=12))
        top1.extend(r[0].id if r else -1 for r in res)
    self_share = float(np.mean(
        np.asarray(top1) == np.arange(n + 1, n + len(new) + 1)
    ))
    log(f"after appending {len(new)}: recall@10 {rec:.4f} over every live "
        f"vector, appended vectors finding themselves first {self_share:.4f}")
    if rec < RECALL_GATE:
        fail(f"recall@10 after append {rec:.4f} < {RECALL_GATE}")
    if self_share < SELF_GATE:
        fail(f"appended self top-1 {self_share:.4f} < {SELF_GATE}")
    return launches, everything, live


def run_chunked(dev, seed):
    """Chunked device insertion: batches under the append threshold into
    a fresh collection of the main path's config."""
    import torch

    from scintirete_tpu_torch import (
        CollectionConfig,
        DistanceMetric,
        SearchParams,
    )
    from scintirete_tpu_torch.engine import Engine

    rng = np.random.default_rng(seed + 3)
    n = CHUNKED_BATCHES * CHUNKED_BATCH
    base, queries, _ = make_dataset(rng, n, 1024)
    col = Engine(device=dev).create_database("chunked").create_collection(
        CollectionConfig(
            name="c", metric=DistanceMetric.COSINE, hnsw=hnsw_params(),
        )
    )
    per_batch = []
    for b in range(CHUNKED_BATCHES):
        t0 = time.perf_counter()
        col.insert([(v, None) for v in
                    base[b * CHUNKED_BATCH : (b + 1) * CHUNKED_BATCH]])
        torch.cuda.synchronize()
        per_batch.append(time.perf_counter() - t0)
    log("chunked batch seconds: " + " ".join(f"{t:.3f}" for t in per_batch))
    log(f"chunked: {n} vectors in {sum(per_batch):.2f} s, median batch "
        f"{float(np.median(per_batch)):.3f} s, max {max(per_batch):.3f} s")
    results = col.search_batch(queries, SearchParams(top_k=K, ef_search=64))
    check_results(results, K)
    rec = recall_of(results, ground_truth(dev, queries, base, np.ones(n, bool), 2))
    log(f"chunked: recall@10 {rec:.4f} at ef_search=64")
    if rec < CHUNKED_GATE:
        fail(f"chunked recall@10 {rec:.4f} < {CHUNKED_GATE}")
    return per_batch


# phase E: the descent and mid-layer entries, the seq upper build and
# the refined build. name -> (entry_mode, ef_upper, descent_mid)
E_MODES = {
    "pivot": ("pivot", 1, True),
    "mid greedy": ("descent", 1, True),
    "mid beam 4": ("descent", 4, True),
    "pure greedy": ("descent", 1, False),
    "pure beam 2": ("descent", 2, False),
    "pure beam 4": ("descent", 4, False),
}
# recall@10 gates at ef 12 (E1: kNN upper layers; E2: seq upper layers;
# E3: the refined build in pivot mode); other modes are printed only
E1_GATES = {"mid greedy": 0.98, "mid beam 4": 0.99}
E2_GATES = {"pure beam 4": 0.98}
E3_GATE = 0.95
E_WAVE, E_WAVE_ROWS = 32, 1024  # waves of 32 against one batch of 1,024
E3_ROWS = N_BASE  # the refined build's corpus (cut if phase E runs long)
E3_SAMPLE = 4096  # rows whose layer-0 kNN@10 overlap is taken
# phase S: two shards of the main path's corpus on the one card
S_SHARDS = 2
S_RECALL_SLACK = 0.005  # below the main path's unsharded recall@10
S_ENGINE_ROWS = 65_536  # S5's cut of the corpus
S_KERNELS = ("pivot_entry_scan", "knn_lane_topc", "knn_lane_topc_masked")


def e_mode(idx, name):
    idx.entry_mode, idx.ef_upper, idx.descent_mid = E_MODES[name]


def e_search(tag, idx, queries, truth, gone, names, gates, waves=()):
    """Search `queries` (batches of BATCH, k = 10, ef 12) in each named
    mode of E_MODES on the index `idx`: QPS, recall@10 against `truth`
    (rows), the mean serial loop steps of a sub-batch above and at layer 0,
    and for the modes in `waves` how many of E_WAVE_ROWS queries change
    ids or distance bits between one batch and waves of E_WAVE. Fails on a
    missed gate or a deleted id. Returns {mode: numbers}."""
    import torch

    from scintirete_tpu_torch import SearchParams

    sp = SearchParams(top_k=K, ef_search=12)
    dev_idx = idx._get_device()
    out = {}
    for name in names:
        e_mode(idx, name)
        idx.search_batch_arrays(queries[:BATCH], sp)  # mirror / mid table
        dev_idx.steps.update(batches=0, upper=0, layer0=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = np.concatenate([
            idx.search_batch_arrays(queries[s : s + BATCH], sp)[0]
            for s in range(0, len(queries), BATCH)
        ])
        secs = time.perf_counter() - t0
        st = dict(dev_idx.steps)
        r = {"qps": len(queries) / secs, "recall": recall_of_ids(ids, truth),
             "upper_steps": st["upper"] / st["batches"],
             "layer0_steps": st["layer0"] / st["batches"]}
        if np.any(ids == 0):
            fail(f"E {tag} {name}: a query got fewer than {K} hits")
        if gone and set(ids.ravel().tolist()) & gone:
            fail(f"E {tag} {name}: a deleted id came back")
        if name in waves:
            q = queries[:E_WAVE_ROWS]
            ids_b, d_b = idx.search_batch_arrays(q, sp)
            parts = [idx.search_batch_arrays(q[w : w + E_WAVE], sp)
                     for w in range(0, len(q), E_WAVE)]
            ids_w = np.concatenate([p[0] for p in parts])
            d_w = np.concatenate([p[1] for p in parts])
            r["wave_ids_differ"] = int(np.any(ids_w != ids_b, axis=1).sum())
            r["wave_bits_differ"] = int(np.any(
                d_w.view(np.uint32) != d_b.view(np.uint32), axis=1).sum())
        log(f"E {tag} {name}: {r['qps']:.1f} QPS, recall@10 "
            f"{r['recall']:.4f}, steps a sub-batch {r['upper_steps']:.1f} "
            f"above layer 0 + {r['layer0_steps']:.1f} at it"
            + (f", waves of {E_WAVE} vs one batch of {E_WAVE_ROWS}: "
               f"{r['wave_ids_differ']} ids / {r['wave_bits_differ']} "
               "distance bits differ" if name in waves else ""))
        if name in gates and r["recall"] < gates[name]:
            fail(f"E {tag} {name}: recall@10 {r['recall']:.4f} < "
                 f"{gates[name]}")
        out[name] = r
    e_mode(idx, "pivot")
    return out


def check_entry_scan(tag, idx, queries, table="mid", waves=()):
    """pivot_entry_scan against its plain version at a search's own shape:
    the HNSWIndex's mid table (table "mid") or pivot table ("pivot") —
    rows pre-normalized, their squared norms and tombstones — against
    `queries` in the sub-batches a search scans them in, and then the
    first E_WAVE_ROWS queries in sub-batches of each size in `waves`, at
    the pivot check's tolerance. Its launches are taken off the wrapper's
    count again. Returns the largest distance difference."""
    import torch

    from scintirete_tpu_torch.ops.pivot_scan import (
        pivot_entry_scan,
        pivot_entry_scan_plain,
    )

    dev_idx = idx._get_device()
    a = dev_idx.graph.arrays
    metric = int(idx.store.metric)
    rows = a["mid_slots"] if table == "mid" else a["pivots"]
    vecs, sq = a[f"{table}_vecs"], a[f"{table}_sq"]
    dele = a["deleted"][rows].float()
    counted = pivot_entry_scan.launches
    worst, least = 0.0, 1.0
    for size, qs in ((dev_idx.max_batch, queries),
                     *((w, queries[:E_WAVE_ROWS]) for w in waves)):
        for s in range(0, len(qs), size):
            q = torch.from_numpy(qs[s : s + size]).to(dev_idx.device)
            if metric == 2:
                q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-30)
            args = (q, vecs, sq, dele, metric)
            d_k, i_k = pivot_entry_scan(*args)
            d_p, i_p = pivot_entry_scan_plain(*args)
            torch.cuda.synchronize()
            err, share = compare(
                f"{tag} {table} scan B={q.shape[0]} R={dele.shape[0]}", d_k,
                i_k, d_p, i_p, atol=1e-4, rtol=1e-5,
            )
            worst, least = max(worst, err), min(least, share)
    pivot_entry_scan.launches = counted
    sizes = "/".join(str(b) for b in (dev_idx.max_batch, *waves))
    log(f"{tag} {table} scan: pivot_entry_scan B={sizes} R={dele.shape[0]} "
        f"({int(dele.sum())} deleted) against plain on {len(queries)} "
        f"queries: max|dd|={worst:.3g} ids equal {least:.6f}")
    return worst


def run_descent_modes(col, queries, truth, del_ids):
    """E1: the main path's graph (kNN upper layers, 1% deleted), searched
    in pivot mode and through the descent entries; then the mid scan's
    kernel is held to its plain version on this graph's mid table.
    Returns the phase's numbers; the index is left in pivot mode."""
    idx = col._index
    t0 = time.perf_counter()
    out = e_search("E1 (kNN uppers)", idx, queries, truth, set(del_ids),
                   ["pivot", "mid greedy", "mid beam 4", "pure greedy"],
                   E1_GATES, waves=("mid greedy", "mid beam 4",
                                    "pure greedy"))
    g = idx._get_device().graph
    out["mid_level"] = g.mid_level
    out["mid_members"] = int(g.arrays["mid_slots"].shape[0])
    out["mid_scan_max_abs_err"] = check_entry_scan("E1", idx, queries)
    out["phase_s"] = time.perf_counter() - t0
    log(f"E1: mid layer {g.mid_level} ({out['mid_members']} members), "
        f"phase {out['phase_s']:.1f} s")
    return out


def knn10_overlap(dev, base, adj, rows):
    """Mean share of each sampled row's exact 10 nearest neighbors (cosine,
    itself excluded) that its adjacency row holds."""
    import torch

    from scintirete_tpu_torch.ops.topk import brute_force_topk

    b = torch.from_numpy(base).to(dev)
    valid = torch.ones(len(base), dtype=torch.bool, device=dev)
    hits = 0
    for s in range(0, len(rows), BATCH):
        r = rows[s : s + BATCH]
        _, idx = brute_force_topk(torch.from_numpy(base[r]).to(dev), b, valid,
                                  2, K + 1)
        idx = idx.cpu().numpy()
        for row, nn, a in zip(r, idx, adj[r]):
            true10 = [x for x in nn.tolist() if x != row][:K]
            hits += len(set(true10) & set(a[a >= 0].tolist()))
    return hits / (K * len(rows))


def run_seq_and_refine(dev, base, queries, truth, seed):
    """E2: a fresh 1M build with seq upper layers, searched by the pure
    walk and the mid entry. E3: a fresh build with refine_rounds=1 (layer
    0's kNN@10 overlap before and after the pass, pivot-mode recall).
    Each index is freed before the next is built."""
    import dataclasses

    import torch

    from scintirete_tpu_torch import DistanceMetric
    from scintirete_tpu_torch.index.hnsw import HNSWIndex

    out = {}
    n = len(base)
    t0 = time.perf_counter()
    idx = HNSWIndex(DIM, hnsw_params(), DistanceMetric.COSINE, device=dev,
                    upper_mode="seq")
    idx.bulk_insert(list(range(1, n + 1)), base)
    torch.cuda.synchronize()
    st = idx.build_stats
    e2 = {"build_s": time.perf_counter() - t0,
          **{k: st[k] for k in ("layer0_s", "upper_s", "upper_rounds",
                                "upper_tiles", "upper_steps")}}
    log(f"E2 seq build {n}: {e2['build_s']:.2f} s (layer 0 "
        f"{e2['layer0_s']:.2f} s, upper layers {e2['upper_s']:.2f} s in "
        f"{e2['upper_rounds']} rounds, {e2['upper_tiles']} tiles, "
        f"{e2['upper_steps']} serial steps)")
    e2.update(e_search("E2 (seq uppers)", idx, queries, truth, set(),
                       ["pure greedy", "pure beam 2", "pure beam 4",
                        "mid greedy"], E2_GATES))
    e2["mid_scan_max_abs_err"] = check_entry_scan("E2", idx, queries)
    out["E2"] = e2
    del idx, st
    gc.collect()
    torch.cuda.empty_cache()

    n3 = min(E3_ROWS, n)
    rows3 = base[:n3]
    params = dataclasses.replace(hnsw_params(), refine_rounds=1)
    t0 = time.perf_counter()
    idx = HNSWIndex(DIM, params, DistanceMetric.COSINE, device=dev)
    idx.bulk_insert(list(range(1, n3 + 1)), rows3)
    torch.cuda.synchronize()
    st = idx.build_stats
    e3 = {"rows": n3, "build_s": time.perf_counter() - t0,
          "layer0_s": st["layer0_s"], "refine_s": st["refine_s"]}
    sample = np.random.default_rng(seed + 9).choice(n3, E3_SAMPLE,
                                                    replace=False)
    e3["knn10_before"] = knn10_overlap(dev, rows3, st["unrefined0"], sample)
    e3["knn10_after"] = knn10_overlap(dev, rows3,
                                      idx.store.neighbors0[:n3], sample)
    truth3 = (truth if n3 == n else
              ground_truth(dev, queries, rows3, np.ones(n3, bool), 2))
    e3.update(e_search("E3 (refined)", idx, queries, truth3, set(),
                       ["pivot"], {"pivot": E3_GATE}))
    log(f"E3 refined build {n3}: {e3['build_s']:.2f} s (layer 0 "
        f"{e3['layer0_s']:.2f} s, refine pass {e3['refine_s']:.2f} s); "
        f"layer-0 kNN@10 overlap on {E3_SAMPLE} rows {e3['knn10_before']:.4f}"
        f" before, {e3['knn10_after']:.4f} after")
    if e3["knn10_after"] < e3["knn10_before"]:
        fail("E3: the refine pass lowered layer 0's kNN@10 overlap")
    out["E3"] = e3
    del idx, st
    gc.collect()
    torch.cuda.empty_cache()
    return out


def answers_arrays(results, k=K):
    """search_batch's [(id, dist)] lists -> (ids u64 [B, k], dists f32
    [B, k]); 0 / inf where a query got fewer than k hits."""
    ids = np.zeros((len(results), k), np.uint64)
    dists = np.full((len(results), k), np.inf, np.float32)
    for b, row in enumerate(results):
        for j, (vid, dist) in enumerate(row):
            ids[b, j], dists[b, j] = vid, dist
    return ids, dists


def sharded_search(idx, queries, k=K):
    """search_batch over `queries` in batches of BATCH (ef 12): (ids,
    dists) arrays and the seconds taken."""
    import torch

    from scintirete_tpu_torch import SearchParams

    sp = SearchParams(top_k=k, ef_search=12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = []
    for s in range(0, len(queries), BATCH):
        res.extend(idx.search_batch(queries[s : s + BATCH], sp))
    secs = time.perf_counter() - t0
    return (*answers_arrays(res, k), secs)


@contextlib.contextmanager
def widest_scans():
    """While open, the two graph-build lane scans keep, for each scan base
    they run over, copies of the inputs and outputs of their widest launch
    (query rows x tiles). Yields {(name, base id): (size, base, inputs,
    outputs)}; each entry holds its base, so no other base can take its
    address while it is kept. A wrapper stands in for the module
    attribute that the kernel's own body counts its launches on, so it
    carries the count while it is in place and hands it back."""
    import torch

    from scintirete_tpu_torch.ops import lane_scan as mod

    kept, wrapped = {}, {}
    for attr, name in (("lane_scan", "knn_lane_topc"),
                       ("lane_scan_masked", "knn_lane_topc_masked")):
        def run(*args, _fn=getattr(mod, attr), _name=name):
            out = _fn(*args)
            key = (_name, args[2].data_ptr())
            size = args[0].shape[0] * args[-1]
            if size > kept.get(key, (0,))[0]:
                kept[key] = (size, args[2], tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args
                ), tuple(o.clone() for o in out))
            return out

        wrapped[attr] = getattr(mod, attr)
        run.launches = wrapped[attr].launches
        setattr(mod, attr, run)
    try:
        yield kept
    finally:
        for attr, fn in wrapped.items():
            fn.launches = getattr(mod, attr).launches
            setattr(mod, attr, fn)


def check_widest_scans(tag, kept, want, want_bases):
    """Each kept launch (widest_scans) against its plain version on the
    same inputs, at the lane checks' tolerance; fails unless kernel `want`
    ran over `want_bases` scan bases or more. Returns {name: largest
    distance difference}."""
    from scintirete_tpu_torch.ops.lane_scan import (
        lane_scan_masked_plain,
        lane_scan_plain,
    )

    plain = {"knn_lane_topc": lane_scan_plain,
             "knn_lane_topc_masked": lane_scan_masked_plain}
    worst, bases = {}, {}
    for (name, _), (_, _, args, outs) in sorted(kept.items(),
                                                key=lambda kv: kv[0][0]):
        err, _ = compare_lanes(
            f"{tag} {name} B={args[0].shape[0]} N={args[2].shape[0]} "
            f"grid_tiles={args[-1]}", outs, plain[name](*args))
        worst[name] = max(worst.get(name, 0.0), err)
        bases[name] = bases.get(name, 0) + 1
    if bases.get(want, 0) < want_bases:
        fail(f"{tag}: {want} ran over {bases.get(want, 0)} scan bases, want "
             f"{want_bases} or more")
    kept.clear()
    return worst


def check_cosine_rows(tag, ids, dists):
    if np.any(ids == 0):
        fail(f"{tag}: a query got fewer than {ids.shape[1]} hits")
    if not np.all(np.isfinite(dists)) or np.any(np.diff(dists, axis=1) < 0):
        fail(f"{tag}: distances must be finite and ascending")
    if np.any(dists < -1e-6) or np.any(dists > 2 + 1e-6):
        fail(f"{tag}: cosine distances must lie in [0, 2]")


def rows_differing(a, b):
    """Queries whose ids, and whose distance bits, differ between two
    answers (ids, dists)."""
    return (int(np.any(a[0] != b[0], axis=1).sum()),
            int(np.any(a[1].view(np.uint32) != b[1].view(np.uint32),
                       axis=1).sum()))


def run_sharded(card, base, flat_case, main_recall, centers, seed):
    """Phase S: the main path's corpus as two shards on the one card (S1
    build, S2 search and waves, S3 deletes and appends, S4 export and
    import), then S5 the engine's shard-count rule at a cut size. Each
    kernel is also held against its plain version at the phase's own
    shapes: every shard's widest build and append scan over its own scan
    base, and every searched pivot table in the search's sub-batches (and
    in waves of E_WAVE). Returns the phase's launches of the three kernels
    it reaches and each one's largest difference from its plain version."""
    import dataclasses

    import torch

    from scintirete_tpu_torch import (
        CollectionConfig,
        DistanceMetric,
        SearchParams,
    )
    from scintirete_tpu_torch.config import TPUConfig
    from scintirete_tpu_torch.engine import Collection, Engine
    from scintirete_tpu_torch.index.hnsw import HNSWIndex
    from scintirete_tpu_torch.parallel import ShardedHNSWIndex

    queries, truth, del_ids, truth_after = flat_case
    n = len(base)
    devices = [torch.device("cuda", 0)] * S_SHARDS
    t_phase = time.perf_counter()
    out = {"phase": "S: the 1M HNSW collection as two shards on one card",
           "card": card, "devices": [str(d) for d in devices]}
    counters = kernel_counters()
    for name in S_KERNELS:
        counters[name].launches = 0
    torch.cuda.reset_peak_memory_stats()

    # S1: one bulk_insert, two kNN builds of n / 2
    idx = ShardedHNSWIndex(DIM, hnsw_params(), DistanceMetric.COSINE,
                           devices=devices)
    shard_s = []
    for sub in idx.subs:
        def timed(ids, vecs, _insert=sub.bulk_insert):
            t0 = time.perf_counter()
            _insert(ids, vecs)
            torch.cuda.synchronize()
            shard_s.append(time.perf_counter() - t0)
        sub.bulk_insert = timed
    t0 = time.perf_counter()
    with widest_scans() as kept:
        idx.bulk_insert(list(range(1, n + 1)), base)
        torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    for sub in idx.subs:
        del sub.bulk_insert
    # each shard's widest build scan, over its own scan base
    errs = check_widest_scans("S1", kept, "knn_lane_topc", S_SHARDS)
    out["shard_build_s"] = shard_s
    out["shard_rows"] = [sub.size() for sub in idx.subs]
    out["build_stats"] = [
        {k: v for k, v in sub.build_stats.items() if np.isscalar(v)}
        for sub in idx.subs
    ]
    log(f"S1 two-shard build of {n}: {out['build_s']:.2f} s (shards "
        + ", ".join(f"{t:.2f} s" for t in shard_s)
        + f"), build_stats {out['build_stats']}")

    # S2: search, recall against the main path's, waves
    sharded_search(idx, queries[:BATCH])  # each shard's mirror upload
    ids, dists, secs = sharded_search(idx, queries)
    check_cosine_rows("S2", ids, dists)
    out["qps"] = len(queries) / secs
    out["recall"] = recall_of_ids(ids, truth)
    out["main_path_recall"] = main_recall
    q = queries[:E_WAVE_ROWS]
    one = sharded_search(idx, q)[:2]
    parts = [sharded_search(idx, q[w : w + E_WAVE])[:2]
             for w in range(0, len(q), E_WAVE)]
    waves = tuple(np.concatenate([p[i] for p in parts]) for i in range(2))
    out["wave_ids_differ"], out["wave_bits_differ"] = rows_differing(waves, one)
    log(f"S2: {out['qps']:.1f} QPS, recall@10 {out['recall']:.4f} (main "
        f"path {main_recall:.4f}); waves of {E_WAVE} vs one batch of "
        f"{E_WAVE_ROWS}: {out['wave_ids_differ']} ids / "
        f"{out['wave_bits_differ']} distance bits differ")
    if out["recall"] < max(RECALL_GATE, main_recall - S_RECALL_SLACK):
        fail(f"S2: recall@10 {out['recall']:.4f} under {RECALL_GATE} or "
             f"more than {S_RECALL_SLACK} below the main path's "
             f"{main_recall:.4f}")
    if out["wave_ids_differ"] or out["wave_bits_differ"]:
        fail("S2: an answer depends on its wave")

    # S3: the main path's deletes, then 4 appends round robin
    for vid in del_ids:
        if not idx.delete(vid):
            fail(f"S3: id {vid} was deleted twice")
    ids, dists, _ = sharded_search(idx, queries)
    check_cosine_rows("S3", ids, dists)
    if np.isin(ids, np.asarray(del_ids, np.uint64)).any():
        fail("S3: a deleted id came back")
    out["recall_after_delete"] = recall_of_ids(ids, truth_after)
    if out["recall_after_delete"] < RECALL_GATE:
        fail(f"S3: recall@10 after delete {out['recall_after_delete']:.4f}")
    new = points_near(np.random.default_rng(seed + 13), centers,
                      APPEND_BATCHES * APPEND_BATCH)
    out["append_s"] = []
    with widest_scans() as kept:
        for b in range(APPEND_BATCHES):
            start = n + b * APPEND_BATCH + 1
            t0 = time.perf_counter()
            idx.bulk_insert(list(range(start, start + APPEND_BATCH)),
                            new[b * APPEND_BATCH : (b + 1) * APPEND_BATCH])
            torch.cuda.synchronize()
            out["append_s"].append(time.perf_counter() - t0)
    masked = counters["knn_lane_topc_masked"].launches
    # each shard's widest append scan, over its append base
    for name, err in check_widest_scans("S3", kept, "knn_lane_topc_masked",
                                        S_SHARDS).items():
        errs[name] = max(errs.get(name, 0.0), err)
    self_ids = sharded_search(idx, new, k=1)[0][:, 0]
    out["appended_self_first"] = float(np.mean(
        self_ids == np.arange(n + 1, n + len(new) + 1, dtype=np.uint64)))
    log(f"S3: deleted {len(del_ids)}, none back, recall@10 "
        f"{out['recall_after_delete']:.4f}; appends of {APPEND_BATCH} in "
        + ", ".join(f"{t:.3f}" for t in out["append_s"])
        + f" s, {masked} masked scans; appended rows first for themselves "
        f"{out['appended_self_first']:.4f}")
    if masked <= 0:
        fail("S3: knn_lane_topc_masked was not launched by the appends")
    if out["appended_self_first"] < 1.0:
        fail("S3: an appended row did not find itself first")
    # each shard's pivot table (1% deleted) as its searches scan it
    errs["pivot_entry_scan"] = max(
        check_entry_scan(f"S3 shard {s}", sub, queries, "pivot", (E_WAVE,))
        for s, sub in enumerate(idx.subs)
    )

    # S4: export, import onto the same devices, the same answers
    t0 = time.perf_counter()
    state = idx.export_graph_state()
    out["export_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ShardedHNSWIndex.import_graph_state(state, params=hnsw_params(),
                                               devices=devices)
    out["import_s"] = time.perf_counter() - t0
    del state
    before = sharded_search(idx, queries)[:2]
    after = sharded_search(back, queries)[:2]
    out["import_ids_differ"], out["import_bits_differ"] = rows_differing(
        after, before)
    log(f"S4: export {out['export_s']:.2f} s, import {out['import_s']:.2f} "
        f"s; {out['import_ids_differ']} ids / {out['import_bits_differ']} "
        f"distance bits of {len(queries)} answers differ after the import")
    if out["import_ids_differ"] or out["import_bits_differ"]:
        fail("S4: the imported index answers differently")
    out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del idx, back
    gc.collect()
    torch.cuda.empty_cache()

    # S5: the engine's shard-count rule on this card, at a cut size
    rows = base[:S_ENGINE_ROWS]
    truth5 = ground_truth(torch.device("cuda"), queries, rows,
                          np.ones(len(rows), bool), 2)
    out["engine_cut"] = (f"S5 on the first {S_ENGINE_ROWS} rows of the "
                         "corpus, to keep the phase short")
    config = CollectionConfig(name="c", metric=DistanceMetric.COSINE,
                              hnsw=hnsw_params())
    tpu = TPUConfig(shard_devices=S_SHARDS)
    want_shards = min(S_SHARDS, torch.cuda.device_count())
    col = Engine(device="cuda", tpu_config=tpu).create_database("s") \
        .create_collection(config)
    col.insert([(v, None) for v in rows])
    sharded = isinstance(col._index, ShardedHNSWIndex)
    if sharded != (want_shards > 1) or (
            not sharded and type(col._index) is not HNSWIndex):
        fail(f"S5: shard_devices={S_SHARDS} over {want_shards} card(s) gave "
             f"{type(col._index).__name__}")
    sp = SearchParams(top_k=K, ef_search=12)
    ids5, _ = col.search_batch_arrays(queries, sp)
    for s, sub in enumerate(getattr(col._index, "subs", [col._index])):
        errs["pivot_entry_scan"] = max(errs["pivot_entry_scan"], check_entry_scan(
            f"S5 engine shard {s}", sub, queries, "pivot"))
    out["engine_index"] = type(col._index).__name__
    out["engine_recall"] = recall_of_ids(ids5, truth5)
    two = ShardedHNSWIndex(DIM, hnsw_params(), DistanceMetric.COSINE,
                           devices=devices)
    two.bulk_insert(list(range(1, len(rows) + 1)), rows)
    state = {"config": {"name": "r", "metric": int(DistanceMetric.COSINE),
                        "hnsw": dataclasses.asdict(hnsw_params()),
                        "device_dtype": "float32", "index_type": "hnsw"},
             "next_id": len(rows) + 1, "deleted_count": 0, "metadata": {},
             "graph": two.export_graph_state()}
    del two
    t0 = time.perf_counter()
    restored = Collection.from_state(state, tpu_config=tpu, device="cuda")
    out["reshard_s"] = time.perf_counter() - t0
    out["restored_shards"] = restored._index.S
    ids5, _ = restored.search_batch_arrays(queries, sp)
    out["restored_recall"] = recall_of_ids(ids5, truth5)
    for s, sub in enumerate(restored._index.subs):
        errs["pivot_entry_scan"] = max(errs["pivot_entry_scan"], check_entry_scan(
            f"S5 restored shard {s}", sub, queries, "pivot"))
    log(f"S5: shard_devices={S_SHARDS} on {torch.cuda.device_count()} card(s)"
        f" serves {out['engine_index']} at recall@10 "
        f"{out['engine_recall']:.4f}; a two-shard state restores onto "
        f"{out['restored_shards']} shard(s) in {out['reshard_s']:.2f} s at "
        f"recall@10 {out['restored_recall']:.4f}")
    if restored._index.S != want_shards:
        fail(f"S5: a two-shard state restored onto {restored._index.S} "
             f"shards, want {want_shards}")
    for key in ("engine_recall", "restored_recall"):
        if out[key] < RECALL_GATE:
            fail(f"S5: {key} {out[key]:.4f} < {RECALL_GATE}")
    del col, restored, state
    gc.collect()
    torch.cuda.empty_cache()

    launches = {name: counters[name].launches for name in S_KERNELS}
    out["launches"] = launches
    out["max_abs_err"] = errs
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase S in {out['phase_s']:.1f} s, peak device memory "
        f"{out['peak_device_gib']:.2f} GiB, launches {launches}")
    print(json.dumps(out), flush=True)
    for name, cnt in launches.items():
        if cnt <= 0:
            fail(f"S: {name} was not launched by the phase")
    return launches, errs


def check_flat_results(name, ids, dists, queries, base, truth, gone=()):
    """ids u64 [B, K], dists f32 [B, K] of a flat search: recall@10
    against the brute force, every distance the exact cosine distance of
    its row, ascending, and no deleted id."""
    from scintirete_tpu_torch.ops.distance import distance_np

    if ids.shape != (len(queries), K) or not np.all(ids > 0):
        fail(f"{name}: want {K} hits for every query")
    if not np.all(np.isfinite(dists)) or np.any(np.diff(dists, axis=1) < 0):
        fail(f"{name}: distances must be finite and ascending")
    rows = ids.astype(np.int64) - 1
    rec = float(np.mean([
        len(set(r.tolist()) & set(t.tolist())) / K for r, t in zip(rows, truth)
    ]))
    worst = 0.0
    for b in range(len(queries)):
        exact = distance_np(queries[b : b + 1], base[rows[b]], 2)[0]
        worst = max(worst, float(np.abs(exact - dists[b]).max()))
    if gone and np.isin(ids, np.fromiter(gone, np.uint64, len(gone))).any():
        fail(f"{name}: a deleted id came back from search")
    if rec < FLAT_RECALL_GATE:
        fail(f"{name}: recall@10 {rec:.4f} < {FLAT_RECALL_GATE}")
    if worst > FLAT_DIST_TOL:
        fail(f"{name}: a distance is off its exact value by {worst:.3g}")
    return rec, worst


def timed_flat_searches(name, search_batch, search_arrays, queries):
    """Batches of 1024 through the tuple surface and one call of all the
    queries through the array surface: (ids, dists) of each, and QPS."""
    import torch

    search_batch(queries[:BATCH])  # first search: the mirror's upload
    torch.cuda.synchronize()
    hits, per_batch = [], []
    full_passes = gc.get_stats()[2]["collections"]
    for s in range(0, len(queries), BATCH):
        t0 = time.perf_counter()
        hits.extend(search_batch(queries[s : s + BATCH]))
        per_batch.append(time.perf_counter() - t0)
    full_passes = gc.get_stats()[2]["collections"] - full_passes
    qps_batch = len(queries) / sum(per_batch)
    log(f"{name}: seconds per batch of {BATCH} "
        + " ".join(f"{t:.4f}" for t in per_batch)
        + f" ({full_passes} full passes of Python's collector among them)")
    t0 = time.perf_counter()
    ids_a, dists_a = search_arrays(queries)
    qps_all = len(queries) / (time.perf_counter() - t0)
    if any(len(h) != K for h in hits):
        fail(f"{name}: want {K} hits for every query")
    ids_t = np.asarray([[vid for vid, _ in h] for h in hits], np.uint64)
    dists_t = np.asarray([[d for _, d in h] for h in hits], np.float32)
    if not np.array_equal(ids_t, ids_a):
        fail(f"{name}: search_batch and search_batch_arrays return other ids")
    if np.abs(dists_t - dists_a).max() > 1e-6:
        fail(f"{name}: search_batch and search_batch_arrays return other distances")
    return ids_a, dists_a, qps_batch, qps_all


def run_flat(dev, base, flat_case, card):
    """The flat index at full size, through the engine (int8 scan copy)
    and through FlatIndex(scan_dtype="bfloat16") directly."""
    import torch

    from scintirete_tpu_torch import (
        CollectionConfig,
        DistanceMetric,
        SearchParams,
    )
    from scintirete_tpu_torch.engine import Engine
    from scintirete_tpu_torch.index.flat import FlatIndex
    from scintirete_tpu_torch.ops.packed_scan import (
        lane_topk_scan,
        lane_topk_scan_int8,
        lane_topk_scan_packed,
        lane_topk_scan_packed_int8,
    )

    queries, true_i, del_ids, true_after = flat_case
    n = len(base)
    sp = SearchParams(top_k=K)
    gone = set(del_ids)
    scans = (lane_topk_scan_packed_int8, lane_topk_scan_packed,
             lane_topk_scan_int8, lane_topk_scan)
    for op in scans:
        op.launches = 0

    engine = Engine(device=dev)
    col = engine.create_database("flat").create_collection(
        CollectionConfig(name="c", metric=DistanceMetric.COSINE,
                         index_type="flat")
    )
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ids = col.insert([(v, None) for v in base])
    insert_s = time.perf_counter() - t0
    if ids != list(range(1, n + 1)):
        fail("flat insert must assign ids 1..n")
    t0 = time.perf_counter()
    col.search_batch(queries[:1], sp)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0

    def tuples(q):
        return [[(r.id, r.distance) for r in res]
                for res in col.search_batch(q, sp)]

    ids_a, dists_a, qps_batch, qps_all = timed_flat_searches(
        "flat (int8)", tuples, lambda q: col.search_batch_arrays(q, sp),
        queries,
    )
    rec, worst = check_flat_results(
        "flat (int8)", ids_a, dists_a, queries, base, true_i
    )
    if col.delete(del_ids) != len(del_ids):
        fail("flat delete must tombstone every id once")
    ids_d, dists_d = col.search_batch_arrays(queries, sp)
    rec_del, _ = check_flat_results(
        "flat (int8) after delete", ids_d, dists_d, queries, base, true_after,
        gone,
    )
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches = {
        "lane_topk_scan_packed_int8": lane_topk_scan_packed_int8.launches,
    }
    log(f"flat n={n} int8 scan copy: insert {insert_s:.2f} s, first search "
        f"(mirror upload) {upload_s:.2f} s, {qps_batch:.1f} QPS in batches of "
        f"{BATCH}, {qps_all:.1f} QPS in one batch of {len(queries)}, "
        f"recall@10 {rec:.4f}, max distance error {worst:.3g}, after "
        f"deleting {len(del_ids)}: recall@10 {rec_del:.4f} and no deleted id; "
        f"peak device memory {peak_gb:.2f} GiB, launches {launches}")
    if launches["lane_topk_scan_packed_int8"] <= 0:
        fail("lane_topk_scan_packed_int8 was not launched by the flat path")
    if lane_topk_scan_packed.launches != 0:
        fail("the int8 flat path must not take the bf16 scan")
    # phase B: its counts are read apart and added
    launches["lane_topk_scan_packed_int8"] += persist_flat(
        dev, card, engine, col, queries, (ids_d, dists_d), sp
    )
    del col, engine

    idx = FlatIndex(DIM, metric=DistanceMetric.COSINE, device=dev,
                    scan_dtype="bfloat16")
    t0 = time.perf_counter()
    idx.bulk_insert(list(range(1, n + 1)), base)
    insert_s = time.perf_counter() - t0
    ids_a, dists_a, qps_batch, qps_all = timed_flat_searches(
        "flat (bf16)", lambda q: idx.search_batch(q, sp),
        lambda q: idx.search_batch_arrays(q, sp), queries,
    )
    rec, worst = check_flat_results(
        "flat (bf16)", ids_a, dists_a, queries, base, true_i
    )
    for vid in del_ids:
        idx.delete(vid)
    ids_d, dists_d = idx.search_batch_arrays(queries, sp)
    rec_del, _ = check_flat_results(
        "flat (bf16) after delete", ids_d, dists_d, queries, base, true_after,
        gone,
    )
    # the unpacked scans have no caller on any path, in the JAX package
    # either: their counts are read like the others and come out 0
    launches.update({op.__name__: op.launches for op in scans[1:]})
    log(f"flat n={n} bf16 scan copy: insert {insert_s:.2f} s, "
        f"{qps_batch:.1f} QPS in batches of {BATCH}, {qps_all:.1f} QPS in "
        f"one batch of {len(queries)}, recall@10 {rec:.4f}, max distance "
        f"error {worst:.3g}, after delete recall@10 {rec_del:.4f} and no "
        f"deleted id; launches {launches['lane_topk_scan_packed']}")
    if launches["lane_topk_scan_packed"] <= 0:
        fail("lane_topk_scan_packed was not launched by the bf16 flat path")
    return launches


def add_launches(launches, more):
    for name, cnt in more.items():
        launches[name] += cnt


def ensure_space(path, nbytes, what):
    """Print the free bytes where a phase is about to write nbytes, and
    fail under twice that."""
    free = shutil.disk_usage(path).free
    log(f"{what}: {free} bytes free in the temporary directory, about "
        f"{nbytes} to write")
    if free < 2 * nbytes:
        fail(f"{what}: {free} bytes free, under twice the {nbytes} to write")


def snapshot_bound(col, dim) -> int:
    """A bound on the bytes of a snapshot of one collection, from its public
    counts: twice its f32 vectors (at D = 128 a row's neighbour tables,
    level, tombstone, id and metadata take less than its vector)."""
    return 2 * 4 * dim * col.count()


def timed_recover(pm):
    """pm.recover() with its parts timed apart on the host clock, each
    ending in a synchronize: the RDB load (read + decode), the restore
    into the engine and the AOF replay (read + decode + apply)."""
    import torch

    spans = {}

    def wrap(obj, attr, key):
        fn = getattr(obj, attr)

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans[key] = time.perf_counter() - t0
            return out

        setattr(obj, attr, timed)

    wrap(pm.rdb, "load", "rdb_load_s")
    wrap(pm.engine, "restore_state", "restore_s")
    wrap(pm.aof, "replay", "aof_replay_s")
    t0 = time.perf_counter()
    report = pm.recover()
    torch.cuda.synchronize()
    spans["recover_s"] = time.perf_counter() - t0
    for key in ("rdb_load_s", "restore_s", "aof_replay_s"):
        spans.setdefault(key, 0.0)
    return report, spans


def log_inserts(pm, col, db, name, rows, tag):
    """Insert rows as the server does (elements as lists, a small
    metadata dict each), then log them; returns (ids, log seconds)."""
    pairs = [(v.tolist(), {"tag": tag, "row": i}) for i, v in enumerate(rows)]
    ids = col.insert(pairs)
    t0 = time.perf_counter()
    pm.log_insert_vectors(db, name, [
        {"id": vid, "elements": e, "metadata": m}
        for vid, (e, m) in zip(ids, pairs)
    ])
    return ids, time.perf_counter() - t0


def search_all(col, queries, sp):
    out = []
    for s in range(0, len(queries), BATCH):
        out.extend(col.search_batch(queries[s : s + BATCH], sp))
    return out


def check_recovered(name, col, rows, ids, gone, tags):
    """Every surviving logged vector reads back bit for bit with its
    metadata; no deleted id reads back."""
    for i, vid in enumerate(ids):
        if vid in gone:
            continue
        v = col.get(vid)
        got = np.asarray(v.elements, np.float32)
        if not np.array_equal(got.view(np.uint32), rows[i].view(np.uint32)):
            fail(f"{name}: vector {vid} did not read back bit for bit")
        if v.metadata != tags[i]:
            fail(f"{name}: vector {vid} came back with metadata {v.metadata}")
    if col.get_multiple(sorted(gone)):
        fail(f"{name}: a deleted id reads back after recovery")


def compare_searches(name, live_res, rec_res, truth, gone):
    """Recall of both against the truth; fails below the gate, below the
    live engine's or on a deleted id; returns (recalls, queries whose ids
    differ, the first few of them)."""
    if any(r.id in gone for res in rec_res for r in res):
        fail(f"{name}: a deleted id came back from search")
    check_results(rec_res, K)
    rec_live = recall_of(live_res, truth)
    rec_back = recall_of(rec_res, truth)
    differ = [q for q, (a, b) in enumerate(zip(live_res, rec_res))
              if [r.id for r in a] != [r.id for r in b]]
    if rec_back < RECALL_GATE:
        fail(f"{name}: recall@10 {rec_back:.4f} < {RECALL_GATE}")
    if rec_back < rec_live:
        fail(f"{name}: recall@10 {rec_back:.4f} after recovery, "
             f"{rec_live:.4f} before")
    return rec_live, rec_back, len(differ), differ[:8]


def persist_hnsw(dev, card, engine, col, everything, live, centers, rng,
                 tmp):
    """Phase A: snapshot of the 1M HNSW collection, an AOF tail, recovery
    into a fresh engine on the card. Leaves the RDB and the AOF tail in
    `tmp` for phase D. Returns the phase's launches and what phase D
    checks against: the queries, their true rows, the deleted ids and the
    live collection's search_batch_arrays answers (ids, dists)."""
    import torch

    from scintirete_tpu_torch import SearchParams
    from scintirete_tpu_torch.engine import Engine
    from scintirete_tpu_torch.ops.lane_scan import lane_scan, lane_scan_masked
    from scintirete_tpu_torch.ops.pivot_scan import pivot_entry_scan
    from scintirete_tpu_torch.persistence import PersistenceManager

    t_phase = time.perf_counter()
    sp = SearchParams(top_k=K, ef_search=12)
    tail = points_near(rng, centers, 2 * APPEND_BATCH)
    out = {"phase": "A: HNSW 1M, RDB + AOF tail", "card": card}
    pm = PersistenceManager(engine, tmp)  # everysec
    ensure_space(tmp, snapshot_bound(col, tail.shape[1])
                 + tail.size * 9 * 2, "A")
    t0 = time.perf_counter()
    pm.save_snapshot()
    out["save_s"] = time.perf_counter() - t0
    out["rdb_bytes"] = pm.rdb.size_bytes()
    tail_ids, tags, log_s = [], [], []
    for b in range(2):
        rows = tail[b * APPEND_BATCH : (b + 1) * APPEND_BATCH]
        ids, dt = log_inserts(pm, col, "smoke", "c", rows, f"tail{b}")
        tail_ids += ids
        tags += [{"tag": f"tail{b}", "row": i} for i in range(len(rows))]
        log_s.append(dt)
    out["log_insert_s"] = log_s
    old = np.flatnonzero(live) + 1
    dels = sorted(
        [int(i) for i in rng.choice(old, 500, replace=False)]
        + [int(i) for i in rng.choice(tail_ids, 500, replace=False)]
    )
    if col.delete(dels) != len(dels):
        fail("A: delete must tombstone every id once")
    pm.log_delete_vectors("smoke", "c", dels)
    gone = set(dels)
    corpus = np.concatenate([everything, tail])
    alive = np.concatenate([live, np.ones(len(tail), bool)])
    alive[np.asarray(dels) - 1] = False
    queries = np.concatenate([
        perturbed(rng, everything[live], N_QUERIES // 2),
        perturbed(rng, tail, N_QUERIES // 2),
    ])
    truth = ground_truth(dev, queries, corpus, alive, 2)
    live_res = search_all(col, queries, sp)
    live_arrays = [col.search_batch_arrays(queries[s : s + BATCH], sp)
                   for s in range(0, len(queries), BATCH)]
    live_arrays = (np.concatenate([i for i, _ in live_arrays]),
                   np.concatenate([d for _, d in live_arrays]))
    pm.stop()
    out["aof_bytes"] = os.path.getsize(pm.aof.path)

    for op in (pivot_entry_scan, lane_scan, lane_scan_masked):
        op.launches = 0
    back = Engine(device=dev)
    pm2 = PersistenceManager(back, tmp)
    report, spans = timed_recover(pm2)
    out.update(spans)
    replay_masked = lane_scan_masked.launches
    col2 = back.get_database("smoke").get_collection("c")
    t0 = time.perf_counter()
    rec_res = col2.search_batch(queries[:BATCH], sp)
    torch.cuda.synchronize()
    out["first_search_s"] = time.perf_counter() - t0
    rec_res += search_all(col2, queries[BATCH:], sp)
    pm2.stop()
    out.update({k: report[k] for k in ("rdb_loaded", "aof_commands",
                                       "degraded")})
    if not report["rdb_loaded"] or report["aof_commands"] != 3 \
            or report["degraded"]:
        fail(f"A: recover() reported {report}")
    check_recovered("A", col2, tail, tail_ids, gone, tags)
    (out["recall_live"], out["recall_recovered"], out["queries_differing"],
     out["first_differing"]) = compare_searches(
        "A", live_res, rec_res, truth, gone)
    launches = {"pivot_entry_scan": pivot_entry_scan.launches,
                "knn_lane_topc_masked": lane_scan_masked.launches,
                "knn_lane_topc": lane_scan.launches}
    out["launches"] = launches
    out["masked_launches_in_replay"] = replay_masked
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(out), flush=True)
    if replay_masked <= 0 or launches["pivot_entry_scan"] <= 0:
        fail("A: the replay must run knn_lane_topc_masked and the search "
             "pivot_entry_scan")
    del back, col2
    torch.cuda.empty_cache()
    return launches, (queries, truth, gone, live_arrays)


def persist_flat(dev, card, engine, col, queries, want, sp):
    """Phase B: snapshot of the 1M flat collection (int8 copy), recovered
    into a fresh engine; its arrays search equals the live one's bit for
    bit. Returns lane_topk_scan_packed_int8's launches in the phase."""
    import torch

    from scintirete_tpu_torch.engine import Engine
    from scintirete_tpu_torch.ops.packed_scan import lane_topk_scan_packed_int8
    from scintirete_tpu_torch.persistence import PersistenceManager

    t_phase = time.perf_counter()
    out = {"phase": "B: flat 1M int8, RDB", "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        pm = PersistenceManager(engine, tmp)
        ensure_space(tmp, snapshot_bound(col, queries.shape[1]), "B")
        t0 = time.perf_counter()
        pm.save_snapshot()
        out["save_s"] = time.perf_counter() - t0
        out["rdb_bytes"] = pm.rdb.size_bytes()
        pm.stop()
        lane_topk_scan_packed_int8.launches = 0
        back = Engine(device=dev)
        pm2 = PersistenceManager(back, tmp)
        report, spans = timed_recover(pm2)
        pm2.stop()
    out.update(spans)
    col2 = back.get_database("flat").get_collection("c")
    t0 = time.perf_counter()
    ids, dists = col2.search_batch_arrays(queries, sp)
    torch.cuda.synchronize()
    out["first_search_s"] = time.perf_counter() - t0
    out.update({k: report[k] for k in ("rdb_loaded", "aof_commands",
                                       "degraded")})
    out["launches"] = lane_topk_scan_packed_int8.launches
    out["arrays_equal"] = bool(np.array_equal(ids, want[0])
                               and np.array_equal(dists.view(np.uint32),
                                                  want[1].view(np.uint32)))
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(out), flush=True)
    if not report["rdb_loaded"] or report["degraded"]:
        fail(f"B: recover() reported {report}")
    if not out["arrays_equal"]:
        fail("B: the recovered flat collection searches to other ids or "
             "distances")
    if out["launches"] <= 0:
        fail("B: lane_topk_scan_packed_int8 was not launched after recovery")
    del back, col2
    torch.cuda.empty_cache()
    return out["launches"]


def persist_aof_only(dev, card, seed):
    """Phase C: recovery from the AOF alone, with no snapshot ever taken:
    an HNSW collection of 12 logged inserts of 4,096 and 1,000 deletes,
    then a 100,000-row flat collection compacted by an AOF rewrite."""
    import dataclasses

    import torch

    from scintirete_tpu_torch import (
        CollectionConfig,
        DistanceMetric,
        SearchParams,
    )
    from scintirete_tpu_torch.engine import Engine
    from scintirete_tpu_torch.ops.lane_scan import lane_scan, lane_scan_masked
    from scintirete_tpu_torch.ops.pivot_scan import pivot_entry_scan
    from scintirete_tpu_torch.persistence import PersistenceManager

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 5)
    n = AOF_INSERTS * APPEND_BATCH
    base, queries, _ = make_dataset(rng, n, N_QUERIES)
    sp = SearchParams(top_k=K, ef_search=12)
    params = hnsw_params()
    out = {"phase": f"C: HNSW AOF only, {AOF_INSERTS} x {APPEND_BATCH}",
           "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        engine = Engine(device=dev)
        pm = PersistenceManager(engine, tmp)
        ensure_space(tmp, base.size * 9 + n * 64, "C (HNSW)")
        db = engine.create_database("aof")
        pm.log_create_database("aof")
        col = db.create_collection(CollectionConfig(
            name="c", metric=DistanceMetric.COSINE, hnsw=params,
        ))
        pm.log_create_collection("aof", "c", {
            "metric": int(DistanceMetric.COSINE),
            "hnsw": dataclasses.asdict(params),
            "device_dtype": "float32", "index_type": "hnsw",
        })
        ids, tags, log_s = [], [], []
        for b in range(AOF_INSERTS):
            rows = base[b * APPEND_BATCH : (b + 1) * APPEND_BATCH]
            got, dt = log_inserts(pm, col, "aof", "c", rows, f"b{b}")
            ids += got
            tags += [{"tag": f"b{b}", "row": i} for i in range(len(rows))]
            log_s.append(dt)
        out["log_insert_s"] = log_s
        dels = sorted(int(i) for i in rng.choice(ids, 1000, replace=False))
        col.delete(dels)
        pm.log_delete_vectors("aof", "c", dels)
        gone = set(dels)
        alive = np.ones(n, bool)
        alive[np.asarray(dels) - 1] = False
        truth = ground_truth(dev, queries, base, alive, 2)
        live_res = search_all(col, queries, sp)
        pm.stop()
        out["aof_bytes"] = os.path.getsize(pm.aof.path)

        for op in (pivot_entry_scan, lane_scan, lane_scan_masked):
            op.launches = 0
        back = Engine(device=dev)
        pm2 = PersistenceManager(back, tmp)
        report, spans = timed_recover(pm2)
        pm2.stop()
    out.update(spans)
    replayed = {"knn_lane_topc": lane_scan.launches,
                "knn_lane_topc_masked": lane_scan_masked.launches}
    col2 = back.get_database("aof").get_collection("c")
    t0 = time.perf_counter()
    rec_res = col2.search_batch(queries[:BATCH], sp)
    torch.cuda.synchronize()
    out["first_search_s"] = time.perf_counter() - t0
    rec_res += search_all(col2, queries[BATCH:], sp)
    out.update({k: report[k] for k in ("rdb_loaded", "aof_commands",
                                       "degraded")})
    if report["rdb_loaded"] or report["degraded"] \
            or report["aof_commands"] != AOF_INSERTS + 3:
        fail(f"C: recover() reported {report}")
    check_recovered("C", col2, base, ids, gone, tags)
    (out["recall_live"], out["recall_recovered"], out["queries_differing"],
     out["first_differing"]) = compare_searches(
        "C", live_res, rec_res, truth, gone)
    launches = {"pivot_entry_scan": pivot_entry_scan.launches, **replayed}
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(out), flush=True)
    if min(launches.values()) <= 0:
        fail("C: the replay must build through knn_lane_topc and append "
             "through knn_lane_topc_masked, and the search run "
             "pivot_entry_scan")
    del engine, col, back, col2
    torch.cuda.empty_cache()
    persist_rewrite(dev, card, rng)
    return launches


def persist_rewrite(dev, card, rng):
    """Phase C, flat part: a 100,000-row flat collection in the AOF-only
    regime, compacted by maybe_rewrite_aof() into records of 100 vectors,
    recovered from the rewritten log alone."""
    import dataclasses

    import torch

    from scintirete_tpu_torch import (
        CollectionConfig,
        DistanceMetric,
        HNSWParams,
        SearchParams,
    )
    from scintirete_tpu_torch.engine import Engine
    from scintirete_tpu_torch.persistence import PersistenceManager

    t_phase = time.perf_counter()
    n, step = REWRITE_ROWS, 10_000
    base, queries, _ = make_dataset(rng, n, BATCH)
    sp = SearchParams(top_k=K)
    out = {"phase": f"C: flat {n}, AOF rewrite", "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        engine = Engine(device=dev)
        pm = PersistenceManager(engine, tmp, aof_rewrite_size_bytes=1 << 16)
        ensure_space(tmp, 2 * (base.size * 9 + n * 64), "C (flat)")
        col = engine.create_database("aof").create_collection(
            CollectionConfig(name="f", metric=DistanceMetric.COSINE,
                             index_type="flat")
        )
        pm.log_create_database("aof")
        pm.log_create_collection("aof", "f", {
            "metric": int(DistanceMetric.COSINE),
            "hnsw": dataclasses.asdict(HNSWParams()),
            "device_dtype": "float32", "index_type": "flat",
        })
        ids = []
        for s in range(0, n, step):
            ids += log_inserts(pm, col, "aof", "f", base[s : s + step],
                               "f")[0]
        dels = sorted({n} | {int(i) for i in rng.choice(ids, 999,
                                                         replace=False)})
        col.delete(dels)
        pm.log_delete_vectors("aof", "f", dels)
        pm.aof.flush()
        out["aof_bytes_before"] = pm.aof.size_bytes()
        want = col.search_batch_arrays(queries, sp)
        t0 = time.perf_counter()
        if not pm.maybe_rewrite_aof():
            fail("C: the AOF rewrite did not run")
        out["rewrite_s"] = time.perf_counter() - t0
        out["aof_bytes"] = pm.aof.size_bytes()
        pm.stop()
        back = Engine(device=dev)
        pm2 = PersistenceManager(back, tmp)
        report, spans = timed_recover(pm2)
        pm2.stop()
    out.update(spans)
    out["records"] = report["aof_commands"]
    col2 = back.get_database("aof").get_collection("f")
    t0 = time.perf_counter()
    got = col2.search_batch_arrays(queries, sp)
    torch.cuda.synchronize()
    out["first_search_s"] = time.perf_counter() - t0
    out.update({k: report[k] for k in ("rdb_loaded", "aof_commands",
                                       "degraded")})
    extra = queries[:1]
    out["next_id_live"] = col.insert([(extra[0], None)])[0]
    out["next_id_recovered"] = col2.insert([(extra[0], None)])[0]
    out["arrays_equal"] = bool(np.array_equal(got[0], want[0])
                               and np.array_equal(got[1].view(np.uint32),
                                                  want[1].view(np.uint32)))
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(out), flush=True)
    want_records = 2 + -(-(n - len(dels)) // 100)
    if report["rdb_loaded"] or report["degraded"] \
            or report["aof_commands"] != want_records:
        fail(f"C: recover() of the rewritten log reported {report}, want "
             f"{want_records} commands")
    if not out["arrays_equal"]:
        fail("C: the flat collection recovered from the rewritten log "
             "searches to other ids or distances")
    if out["next_id_live"] != out["next_id_recovered"]:
        fail("C: the recovered collection hands out another next id")
    del engine, col, back, col2
    torch.cuda.empty_cache()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def packed_search(client, pb, db, col, queries, k, ef=None, per_call=BATCH):
    """BatchSearch in calls of `per_call` queries: (ids u64 [B, k], dists
    f32 [B, k], seconds of each call)."""
    ids, dists, secs = [], [], []
    for s in range(0, len(queries), per_call):
        q = np.ascontiguousarray(queries[s : s + per_call], np.float32)
        req = pb.BatchSearchRequest(
            auth=pb.AuthInfo(password=SERVE_PASSWORD), db_name=db,
            collection_name=col, queries_packed=q.tobytes(),
            num_queries=len(q), dim=q.shape[1], top_k=k,
        )
        if ef is not None:
            req.ef_search = ef
        t0 = time.perf_counter()
        resp = client.BatchSearch(req)
        secs.append(time.perf_counter() - t0)
        ids.append(np.frombuffer(resp.ids_packed, np.uint64).reshape(len(q), k))
        dists.append(
            np.frombuffer(resp.distances_packed, np.float32).reshape(len(q), k)
        )
    return np.concatenate(ids), np.concatenate(dists), secs


def threaded_searches(client, pb, db, col, queries, k, ef, threads):
    """One Search RPC per query, query i from client thread i mod
    `threads`: (ids [B, k] u64, dists [B, k] f32, each RPC's seconds,
    wall seconds)."""
    ids = np.zeros((len(queries), k), np.uint64)
    dists = np.full((len(queries), k), np.inf, np.float32)
    lat = np.zeros(len(queries))
    errors = []

    def worker(t):
        try:
            for i in range(t, len(queries), threads):
                req = pb.SearchRequest(
                    auth=pb.AuthInfo(password=SERVE_PASSWORD), db_name=db,
                    collection_name=col, query_vector=queries[i].tolist(),
                    top_k=k,
                )
                if ef is not None:
                    req.ef_search = ef
                t0 = time.perf_counter()
                resp = client.Search(req)
                lat[i] = time.perf_counter() - t0
                hits = [(r.id, r.distance) for r in resp.results]
                ids[i, : len(hits)] = [h[0] for h in hits]
                dists[i, : len(hits)] = [h[1] for h in hits]
        except Exception as exc:  # reported below, after every join
            errors.append(repr(exc))

    pool = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for th in pool:
        th.start()
    for th in pool:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in pool):
        fail(f"single-query Search RPCs failed: {errors[:3]}")
    return ids, dists, lat, wall


def http_search(port, db, col, query, k, ef, password):
    """One Search over the HTTP gateway: (status, JSON body)."""
    import urllib.error
    import urllib.request

    body = json.dumps({"query_vector": query.tolist(), "top_k": k,
                       "ef_search": ef}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v1/databases/{db}/collections/{col}"
        "/search", data=body, method="POST",
        headers={"Authorization": f"Bearer {password}",
                 "Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def insert_request(pb, db, col, rows):
    return pb.InsertVectorsRequest(
        auth=pb.AuthInfo(password=SERVE_PASSWORD), db_name=db,
        collection_name=col,
        vectors=[pb.Vector(elements=r) for r in rows.tolist()],
    )


def recall_of_ids(ids, truth) -> float:
    rows = ids.astype(np.int64) - 1
    return float(np.mean([len(set(r.tolist()) & set(t.tolist())) / K
                          for r, t in zip(rows, truth)]))


def latency_ms(lat):
    return {"p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3)}


def wave_stats(wave_log):
    widths = np.asarray([w for w, _ in wave_log])
    return {"waves": int(len(widths)), "mean_width": float(widths.mean()),
            "p50_width": float(np.median(widths)),
            "max_width": int(widths.max()),
            "wave_ms_p50": float(np.median([s for _, s in wave_log]) * 1e3)}


def same_as_batch(name, out, ids_s, d_s, ids_b, d_b):
    """Single-query answers against the same queries' BatchSearch ones:
    counts the queries whose ids, or distance bits, differ, and fails on
    any (the batcher only stacks queries)."""
    ids_differ = np.flatnonzero(np.any(ids_s != ids_b, axis=1))
    bits_differ = np.flatnonzero(np.any(d_s != d_b, axis=1))
    out[f"{name}_single_ids_differing_from_batch"] = int(len(ids_differ))
    out[f"{name}_single_distance_bits_differing"] = int(len(bits_differ))
    out[f"{name}_single_first_differing"] = bits_differ[:8].tolist()
    if len(ids_differ) or len(bits_differ):
        fail(f"D: {len(ids_differ)} {name} single-query answers have other "
             f"ids and {len(bits_differ)} other distance bits than their "
             "BatchSearch ones")


def kernel_counters():
    """name -> the wrapper object whose `launches` counts its kernel."""
    from scintirete_tpu_torch.ops import packed_scan
    from scintirete_tpu_torch.ops.lane_scan import lane_scan, lane_scan_masked
    from scintirete_tpu_torch.ops.pivot_scan import pivot_entry_scan

    return {
        "pivot_entry_scan": pivot_entry_scan,
        "knn_lane_topc": lane_scan,
        "knn_lane_topc_masked": lane_scan_masked,
        "lane_topk_scan_packed_int8": packed_scan.lane_topk_scan_packed_int8,
        "lane_topk_scan_packed": packed_scan.lane_topk_scan_packed,
        "lane_topk_scan_int8": packed_scan.lane_topk_scan_int8,
        "lane_topk_scan": packed_scan.lane_topk_scan,
    }


def serve_hnsw(out, service, client, pb, port_http, a_case, centers, rng):
    """Phase D on the recovered HNSW collection: BatchSearch, single
    Search RPCs through the batcher, HTTP, auth, two inserts and a delete.
    Returns (the ids deleted in all, the surviving inserted (ids, rows),
    the answers to the first SERVE_RESTART queries after the writes)."""
    import grpc

    from scintirete_tpu_torch import SearchParams

    queries, truth, gone, (live_ids, _) = a_case
    ids_b, d_b, secs = packed_search(client, pb, "smoke", "c", queries, K, 12)
    out["hnsw_batch_qps"] = len(queries) / sum(secs)
    out["hnsw_batch_s"] = secs
    out["hnsw_ids_differing_from_live"] = int(
        np.any(ids_b != live_ids, axis=1).sum())
    out["hnsw_recall"] = recall_of_ids(ids_b, truth)
    col = service.engine.get_database("smoke").get_collection("c")
    sp = SearchParams(top_k=K, ef_search=12)
    inproc = []
    for s in range(0, len(queries), BATCH):
        t0 = time.perf_counter()
        col.search_batch_arrays(queries[s : s + BATCH], sp)
        inproc.append(time.perf_counter() - t0)
    out["hnsw_inprocess_qps"] = len(queries) / sum(inproc)
    if out["hnsw_ids_differing_from_live"]:
        fail("D: BatchSearch ids differ from phase A's live collection on "
             f"{out['hnsw_ids_differing_from_live']} queries")
    if out["hnsw_recall"] < RECALL_GATE:
        fail(f"D: HNSW recall@10 {out['hnsw_recall']:.4f} < {RECALL_GATE}")
    if np.isin(ids_b, np.fromiter(gone, np.uint64, len(gone))).any():
        fail("D: a deleted id came back from BatchSearch")

    service.batcher.wave_log.clear()
    ids_s, d_s, lat, wall = threaded_searches(
        client, pb, "smoke", "c", queries, K, 12, SERVE_THREADS)
    out["hnsw_single_qps"] = len(queries) / wall
    out.update({f"hnsw_single_{k}": v for k, v in latency_ms(lat).items()})
    out["hnsw_single_waves"] = wave_stats(service.batcher.wave_log)
    # a query's answer must not depend on the wave it rode in
    same_as_batch("hnsw", out, ids_s, d_s, ids_b, d_b)
    out["hnsw_single_recall"] = recall_of_ids(ids_s, truth)
    if out["hnsw_single_recall"] < RECALL_GATE:
        fail(f"D: single-query recall@10 {out['hnsw_single_recall']:.4f}")

    # the same queries over HTTP, one at a time (so each rides a wave of
    # its own): the gRPC answers, ids and distance bits
    t0 = time.perf_counter()
    for i in range(SERVE_HTTP):
        status, body = http_search(port_http, "smoke", "c", queries[i], K, 12,
                                   SERVE_PASSWORD)
        got_ids = [int(r["id"]) for r in body.get("results", [])]
        # protojson writes a float field at the digits that round-trip f32
        got_d = np.asarray([r.get("distance", 0.0) for r in body["results"]],
                           np.float32)
        if status != 200 or got_ids != ids_s[i].tolist() \
                or not np.array_equal(got_d, d_s[i]):
            fail(f"D: HTTP answer {i} ({status}: {got_ids}, {got_d}) "
                 f"differs from its gRPC one ({ids_s[i]}, {d_s[i]})")
    out["http_search_s"] = (time.perf_counter() - t0) / SERVE_HTTP
    status, body = http_search(port_http, "smoke", "c", queries[0], K, 12,
                               "wrong")
    try:
        client.Search(pb.SearchRequest(
            auth=pb.AuthInfo(password="wrong"), db_name="smoke",
            collection_name="c", query_vector=queries[0].tolist(), top_k=K))
        fail("D: a wrong password was accepted over gRPC")
    except grpc.RpcError as exc:
        grpc_err = (exc.code().name, exc.details())
    out["wrong_password"] = {"http": [status, body], "grpc": list(grpc_err)}
    if (status, body.get("code"), body.get("error")) != (
            401, 2000, "invalid credentials") or grpc_err != (
            "UNAUTHENTICATED", "invalid credentials"):
        fail(f"D: a wrong password got {out['wrong_password']}")

    new = points_near(rng, centers, 2 * APPEND_BATCH)
    ins_ids, ins_s = [], []
    for b in range(2):
        req = insert_request(
            pb, "smoke", "c", new[b * APPEND_BATCH : (b + 1) * APPEND_BATCH])
        t0 = time.perf_counter()
        resp = client.InsertVectors(req)
        ins_s.append(time.perf_counter() - t0)
        ids = list(resp.inserted_ids)
        if len(ids) != APPEND_BATCH or ids != list(range(ids[0], ids[0] + len(ids))) \
                or (ins_ids and ids[0] != ins_ids[-1] + 1):
            fail("D: InsertVectors must assign the next ids")
        ins_ids += ids
    out["hnsw_insert_s"] = ins_s
    ins_ids = np.asarray(ins_ids, np.uint64)
    ids_new, _, _ = packed_search(client, pb, "smoke", "c", new, K, 12)
    out["hnsw_insert_self_first"] = float(np.mean(ids_new[:, 0] == ins_ids))
    if out["hnsw_insert_self_first"] < SELF_GATE:
        fail(f"D: inserted vectors find themselves first "
             f"{out['hnsw_insert_self_first']:.4f} < {SELF_GATE}")

    # live ids that the queries find: their deletion must show
    old_live = np.unique(truth.astype(np.int64).ravel() + 1)
    dels = sorted([int(i) for i in rng.choice(old_live, 500, replace=False)]
                  + [int(i) for i in rng.choice(ins_ids, 500, replace=False)])
    t0 = time.perf_counter()
    resp = client.DeleteVectors(pb.DeleteVectorsRequest(
        auth=pb.AuthInfo(password=SERVE_PASSWORD), db_name="smoke",
        collection_name="c", ids=dels))
    out["hnsw_delete_s"] = time.perf_counter() - t0
    if resp.deleted_count != len(dels):
        fail(f"D: DeleteVectors deleted {resp.deleted_count} of {len(dels)}")
    all_gone = np.fromiter(gone | set(dels), np.uint64)
    ids_a, d_a, _ = packed_search(client, pb, "smoke", "c", queries, K, 12)
    if np.isin(ids_a, all_gone).any():
        fail("D: a deleted id came back after DeleteVectors")
    keep = ~np.isin(ins_ids, np.asarray(dels, np.uint64))
    surviving = (ins_ids[keep], new[keep])
    return all_gone, surviving, (ids_a[:SERVE_RESTART], d_a[:SERVE_RESTART])


def serve_flat(out, service, client, pb, dev, base, flat_case):
    """Phase D on a flat collection fed over gRPC: returns (its rows,
    the queries, the answers to the first SERVE_RESTART of them)."""
    queries, true_i = flat_case[0], flat_case[1]
    n = SERVE_FLAT_ROWS
    rows = base[:n]
    if n < len(base):
        true_i = ground_truth(dev, queries, rows, np.ones(n, bool), 2)
    out["flat_rows"] = n
    client.CreateCollection(pb.CreateCollectionRequest(
        auth=pb.AuthInfo(password=SERVE_PASSWORD), db_name="smoke",
        collection_name="flat", metric_type=pb.COSINE, index_type="flat"))
    build_s, rpc_s = 0.0, []
    for s in range(0, n, INGEST_BATCH):
        t0 = time.perf_counter()
        req = insert_request(pb, "smoke", "flat", rows[s : s + INGEST_BATCH])
        t1 = time.perf_counter()
        resp = client.InsertVectors(req)
        rpc_s.append(time.perf_counter() - t1)
        build_s += t1 - t0
        if resp.inserted_count != len(req.vectors) \
                or resp.inserted_ids[0] != s + 1:
            fail("D: flat InsertVectors must assign ids 1..n in order")
    out["flat_ingest_vec_s"] = n / sum(rpc_s)
    out["flat_ingest_rpc_s"] = sum(rpc_s)
    out["flat_ingest_request_build_s"] = build_s
    out["flat_ingest_rpc_max_s"] = max(rpc_s)
    _, _, first = packed_search(client, pb, "smoke", "flat", queries[:BATCH], K)
    out["flat_first_search_s"] = first[0]  # the mirror's upload
    ids_b, d_b, secs = packed_search(client, pb, "smoke", "flat", queries, K)
    out["flat_batch_qps"] = len(queries) / sum(secs)
    out["flat_recall"], out["flat_max_dist_err"] = check_flat_results(
        "D flat BatchSearch", ids_b, d_b, queries, rows, true_i)
    service.batcher.wave_log.clear()
    sq = queries[:SERVE_FLAT_SINGLES]
    ids_s, d_s, lat, wall = threaded_searches(
        client, pb, "smoke", "flat", sq, K, None, SERVE_THREADS)
    out["flat_single_qps"] = len(sq) / wall
    out.update({f"flat_single_{k}": v for k, v in latency_ms(lat).items()})
    out["flat_single_waves"] = wave_stats(service.batcher.wave_log)
    same_as_batch("flat", out, ids_s, d_s, ids_b[: len(sq)], d_b[: len(sq)])
    out["flat_single_recall"], err = check_flat_results(
        "D flat Search", ids_s, d_s, sq, rows, true_i[:SERVE_FLAT_SINGLES])
    out["flat_max_dist_err"] = max(out["flat_max_dist_err"], err)
    return rows, queries, (ids_b[:SERVE_RESTART], d_b[:SERVE_RESTART])


def startup_split(log_path, t_spawn, t_answer):
    """Where the restarted `server_main` spent its time from spawn to
    first answer, from its log: up to main() (wall clocks); main's own
    imports, the recovery and the listeners' start from its "startup"
    line; then up to the first answer. The warm-up search and the kernel
    libraries' first load run after the listeners start, in the
    background ("search prewarm done")."""
    startup, warm = None, None
    with open(log_path) as fh:
        for line in fh:
            if line.startswith("{"):
                rec = json.loads(line)
                if rec.get("msg") == "startup":
                    startup = rec
                elif rec.get("msg") == "search prewarm done":
                    warm = rec
    if startup is None:
        fail("D restart: the server logged no startup line")
    return {
        "spawn_to_main_s": startup["main_start"] - t_spawn,
        "main_imports_s": startup["imports_s"],
        "recovery_s": startup["recovery_s"],
        "listen_s": startup["listen_s"],
        "listening_to_first_answer_s": t_answer - startup["listening"],
        "warm_up_s": warm and warm["seconds"],
        "kernel_load_s": warm and warm.get("kernel_load_s"),
    }


def import_split(root):
    """The imports before `server_main`'s main(), in an interpreter of
    their own under `-X importtime` (its cumulative microseconds per
    module): seconds of the torch import and of the port package's
    (torch included), and the interpreter's wall time in all."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-X", "importtime", "-c",
         "import scintirete_tpu_torch.cli.server_main"],
        cwd=root, capture_output=True, text=True, timeout=300,
    )
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"D: importing server_main failed: {run.stderr[-2000:]}")
    cumulative = {}
    for line in run.stderr.splitlines():
        cols = line.split("|")
        if line.startswith("import time:") and len(cols) == 3 \
                and cols[1].strip().isdigit():
            cumulative.setdefault(cols[2].strip(), int(cols[1]) / 1e6)
    return {"torch_import_s": cumulative.get("torch"),
            "package_import_s": cumulative.get("scintirete_tpu_torch"),
            "interpreter_wall_s": wall}


def restart_server(out, data_dir, dev, a_queries, flat_queries, before,
                   all_gone, surviving, flat_rows, infos):
    """Phase D's restart: `python -m scintirete_tpu_torch.cli.server_main`
    on the saved directory answers as the in-process server did, every
    acknowledged write reads back, a one-shot CLI command runs, and
    SIGTERM ends it with exit code 0."""
    from scintirete_tpu_torch.proto import scintirete_pb2 as pb
    from scintirete_tpu_torch.server.grpc_server import GrpcClient

    root = os.path.dirname(os.path.abspath(__file__))
    grpc_port, http_port = free_port(), free_port()
    config = os.path.join(data_dir, "server.toml")
    with open(config, "w") as fh:
        fh.write(
            f'[server]\ngrpc_port = {grpc_port}\nhttp_port = {http_port}\n'
            f'passwords = ["{SERVE_PASSWORD}"]\n'
            f'[persistence]\ndata_dir = "{data_dir}"\n'
            "[observability]\nmetrics_enabled = false\n"
            f'[tpu]\nplatform = "{dev.type}"\n'
        )
    log_path = os.path.join(data_dir, "server.log")
    logf = open(log_path, "w")
    t_spawn = time.perf_counter()
    t_spawn_wall = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "scintirete_tpu_torch.cli.server_main",
         "-config", config],
        cwd=root, stdout=logf, stderr=subprocess.STDOUT,
    )
    client = GrpcClient(f"127.0.0.1:{grpc_port}", timeout=600)
    auth = pb.AuthInfo(password=SERVE_PASSWORD)

    def server_failed(msg):
        logf.flush()
        with open(log_path) as fh:
            tail = fh.read()[-3000:]
        fail(f"D restart: {msg}; the server's log ends:\n{tail}")

    import grpc

    try:
        deadline = time.time() + 600
        while True:
            try:
                client.ListDatabases(pb.ListDatabasesRequest(auth=auth))
                break
            except grpc.RpcError:
                if proc.poll() is not None:
                    server_failed(f"exited with {proc.returncode} at start")
                if time.time() > deadline:
                    server_failed("no answer in 600 s")
                time.sleep(0.1)
        out["restart_first_answer_s"] = time.perf_counter() - t_spawn
        t_answer_wall = time.time()
        hnsw_q, flat_q = a_queries[:SERVE_RESTART], flat_queries[:SERVE_RESTART]
        t0 = time.perf_counter()
        ids_h, d_h, _ = packed_search(client, pb, "smoke", "c", hnsw_q, K, 12)
        out["restart_first_search_s"] = time.perf_counter() - t0
        ids_f, d_f, _ = packed_search(client, pb, "smoke", "flat", flat_q, K)
        for name, got, want in (("HNSW", (ids_h, d_h), before[0]),
                                ("flat", (ids_f, d_f), before[1])):
            if not np.array_equal(got[0], want[0]) \
                    or np.abs(got[1] - want[1]).max() > 1e-6:
                server_failed(f"{name} answers differ after the restart")
        for name, want in infos.items():
            got = client.GetCollectionInfo(pb.GetCollectionInfoRequest(
                auth=auth, db_name="smoke", collection_name=name))
            if (got.vector_count, got.deleted_count) != want:
                server_failed(f"collection {name} counts "
                              f"{(got.vector_count, got.deleted_count)}, want "
                              f"{want}")
        ins_ids, ins_rows = surviving
        ids_r, _, _ = packed_search(client, pb, "smoke", "c", ins_rows, K, 64)
        missing = int((~np.any(ids_r == ins_ids[:, None], axis=1)).sum())
        out["restart_hnsw_inserts_missing"] = missing
        if missing or np.isin(ids_r, all_gone).any():
            server_failed(f"{missing} acknowledged HNSW inserts did not read "
                          "back, or a deleted id came back")
        t0 = time.perf_counter()
        ids_r, _, _ = packed_search(client, pb, "smoke", "flat", flat_rows, 1,
                                    per_call=4 * BATCH)
        out["restart_flat_readback_s"] = time.perf_counter() - t0
        wrong = int((ids_r[:, 0] != np.arange(1, len(flat_rows) + 1)).sum())
        out["restart_flat_rows_not_first"] = wrong
        if wrong:
            server_failed(f"{wrong} flat rows do not find themselves first")
        cli = subprocess.run(
            [sys.executable, "-m", "scintirete_tpu_torch.cli.main", "-p",
             str(grpc_port), "-a", SERVE_PASSWORD, "-d", "smoke",
             "collection", "info", "flat"],
            cwd=root, capture_output=True, text=True, timeout=120,
        )
        out["cli_one_shot"] = cli.stdout.strip()
        if cli.returncode != 0 or f"vectors={len(flat_rows)}" not in cli.stdout:
            server_failed(f"the one-shot CLI printed {cli.stdout!r} "
                          f"{cli.stderr[-500:]!r}")
        client.close()
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
        out["restart_sigterm_exit_s"] = time.perf_counter() - t0
        out["restart_exit_code"] = rc
        if rc != 0:
            server_failed(f"exit code {rc} on SIGTERM")
        logf.flush()
        out["restart_split"] = startup_split(log_path, t_spawn_wall,
                                             t_answer_wall)
        out["import_split"] = import_split(root)
        for key in ("restart_split", "import_split"):
            log(f"D {key} (spawn to first answer "
                f"{out['restart_first_answer_s']:.2f} s): "
                + ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                            else f"{k} {v}" for k, v in out[key].items()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        logf.close()


def serve(dev, card, data_dir, a_case, base, flat_case, centers, seed):
    """Phase D: the port's server on the card over phase A's directory."""
    import torch

    from scintirete_tpu_torch.config import Config
    from scintirete_tpu_torch.proto import scintirete_pb2 as pb
    from scintirete_tpu_torch.server.grpc_server import GrpcClient, GrpcServer
    from scintirete_tpu_torch.server.http_server import HttpGateway
    from scintirete_tpu_torch.server.service import ScintireteService

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 11)
    out = {"phase": "D: server, recovered 1M HNSW + flat over gRPC / HTTP",
           "card": card}
    if SERVE_FLAT_ROWS < N_BASE:
        out["cut"] = (f"flat collection cut to {SERVE_FLAT_ROWS} rows "
                      "(fused_min_cap) to keep the phase near 120 s")
    # the flat rows' AOF records (9 bytes a float) and a snapshot of both
    # collections beside the one it replaces
    ensure_space(data_dir, SERVE_FLAT_ROWS * DIM * 9
                 + 2 * 4 * DIM * (N_BASE + 6 * APPEND_BATCH + SERVE_FLAT_ROWS)
                 + os.path.getsize(os.path.join(data_dir, "vector.rdb")), "D")
    counters = kernel_counters()
    for op in counters.values():
        op.launches = 0
    cfg = Config()
    cfg.server.passwords = [SERVE_PASSWORD]
    cfg.persistence.data_dir = data_dir
    t0 = time.perf_counter()
    service = ScintireteService(cfg, device=dev)
    report = service.start()
    torch.cuda.synchronize()
    out["recover_s"] = time.perf_counter() - t0
    out.update({k: report[k] for k in ("rdb_loaded", "aof_commands",
                                       "degraded")})
    service._warm_thread.join(timeout=600)
    out["warm"] = service._warm_info
    if service._warm_thread.is_alive() or service._warm_error \
            or not service._warm_info:
        fail(f"D: the warm-up warned: {service._warm_error}")
    if not report["rdb_loaded"] or report["aof_commands"] != 3 \
            or report["degraded"]:
        fail(f"D: recover() reported {report}")
    grpc_server = GrpcServer(service, "127.0.0.1", 0)
    gateway = HttpGateway(service, "127.0.0.1", 0)
    grpc_server.start()
    gateway.start()
    client = GrpcClient(f"127.0.0.1:{grpc_server.port}", timeout=600)
    auth = pb.AuthInfo(password=SERVE_PASSWORD)
    try:
        all_gone, surviving, hnsw_before = serve_hnsw(
            out, service, client, pb, gateway.port, a_case, centers, rng)
        flat_rows, flat_queries, flat_before = serve_flat(
            out, service, client, pb, dev, base, flat_case)
        resp = client.Save(pb.SaveRequest(auth=auth))
        out["save_s"] = resp.duration_seconds
        out["rdb_bytes"] = resp.snapshot_size
        infos = {}
        for name in ("c", "flat"):
            info = client.GetCollectionInfo(pb.GetCollectionInfoRequest(
                auth=auth, db_name="smoke", collection_name=name))
            infos[name] = (info.vector_count, info.deleted_count)
    finally:
        client.close()
        gateway.stop()
        grpc_server.stop()
        service.stop()
    launches = {name: op.launches for name, op in counters.items()}
    out["launches"] = launches
    del service
    gc.collect()
    torch.cuda.empty_cache()
    restart_server(out, data_dir, dev, a_case[0], flat_queries,
                   (hnsw_before, flat_before), all_gone, surviving,
                   flat_rows, infos)
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(out), flush=True)
    for name in ("pivot_entry_scan", "knn_lane_topc_masked",
                 "lane_topk_scan_packed_int8"):
        if launches[name] <= 0:
            fail(f"D: {name} was not launched by the server's path")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="data seed")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    from scintirete_tpu_torch.native.build import load_native
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
    # tensor-core instructions: bf16 wgmma is HGMMA, s8 wgmma IGMMA; the
    # flat scans keep no __dp4a body (IDP4A), and the pivot scan's f32
    # products stay off the tensor cores (no HMMA: no TF32)
    for lib, opcode, want in (("lane_scan", "HGMMA", True),
                              ("flat_scan", "HGMMA", True),
                              ("flat_scan", "IGMMA", True),
                              ("flat_scan", "IDP4A", False),
                              ("pivot_scan", "HMMA", False),
                              ("pivot_scan", "FFMA", True)):
        count = sass_count(paths[lib], opcode)
        if count is None:
            log(f"{lib}: no cuobjdump in the toolkit, {opcode} count "
                f"not taken")
            continue
        log(f"{lib}: {count} {opcode} instructions in its SASS "
            f"(cuobjdump -sass)")
        if want and count == 0:
            fail(f"{lib} has no {opcode} instruction")
        if not want and count > 0:
            fail(f"{lib} must have no {opcode} instruction")

    t0 = time.perf_counter()
    if load_native() is None:
        fail("the C++ link-application library did not build or load")
    log(f"C++ library built and loaded in {time.perf_counter() - t0:.2f} s")

    checks = {
        "pivot_entry_scan": check_pivot(dev, args.seed),
        "knn_lane_topc": check_lane(dev, args.seed),
        "knn_lane_topc_masked": check_lane_masked(dev, args.seed),
    }
    for name, err in check_lane_depths(dev, args.seed).items():
        worst, timing, bound = checks[name]
        checks[name] = (max(worst, err), timing, bound)
    flat_inputs = flat_kernel_inputs(dev, args.seed)
    checks["lane_topk_scan_packed_int8"] = check_packed_int8(dev, flat_inputs)
    checks["lane_topk_scan_packed"] = check_packed(dev, flat_inputs)
    checks["lane_topk_scan_int8"] = check_lane_int8(dev, flat_inputs)
    checks["lane_topk_scan"] = check_lane_flat(dev, flat_inputs)
    del flat_inputs
    torch.cuda.empty_cache()
    (launches, engine, col, base, valid, centers, rng, flat_case, build_s,
     main_recall) = run_main_path(dev, N_BASE, N_QUERIES, args.seed)
    replay_build_scans(dev, base, build_s, launches["knn_lane_topc"])
    # phase E1: the main path's graph through the descent entries
    t_e = time.perf_counter()
    counters = kernel_counters()
    counters["pivot_entry_scan"].launches = 0
    e_out = {"phase": "E: descent / mid entry, seq upper build, refine",
             "card": card,
             "E1": run_descent_modes(col, flat_case[0], flat_case[3],
                                     flat_case[2])}
    e1_pivot = counters["pivot_entry_scan"].launches
    if e1_pivot <= 0:
        fail("E1: pivot_entry_scan was not launched")
    launches["pivot_entry_scan"] += e1_pivot
    e_out["launches"] = {"pivot_entry_scan": e1_pivot, "knn_lane_topc": 0}
    e_s = time.perf_counter() - t_e
    launches["knn_lane_topc_masked"], everything, live = run_append(
        dev, col, base, valid, centers, rng
    )
    # phase A's directory (the 1M HNSW RDB and its AOF tail) is where
    # phase D's server starts
    with tempfile.TemporaryDirectory() as serve_dir:
        a_launches, a_case = persist_hnsw(
            dev, card, engine, col, everything, live, centers, rng, serve_dir
        )
        add_launches(launches, a_launches)
        del col, engine
        gc.collect()
        torch.cuda.empty_cache()
        # phases E2 and E3: fresh 1M builds, one graph on the card at a time
        t_e = time.perf_counter()
        for name in ("pivot_entry_scan", "knn_lane_topc"):
            counters[name].launches = 0
        e_out.update(run_seq_and_refine(dev, base, flat_case[0],
                                        flat_case[1], args.seed))
        for name in ("pivot_entry_scan", "knn_lane_topc"):
            if counters[name].launches <= 0:
                fail(f"E2/E3: {name} was not launched")
            launches[name] += counters[name].launches
            e_out["launches"][name] += counters[name].launches
        e_out["phase_s"] = e_s + time.perf_counter() - t_e
        # the mid scans' kernel checks join the pivot kernel's error
        worst, timing, bound = checks["pivot_entry_scan"]
        checks["pivot_entry_scan"] = (
            max(worst, e_out["E1"]["mid_scan_max_abs_err"],
                e_out["E2"]["mid_scan_max_abs_err"]), timing, bound)
        log(f"phase E in {e_out['phase_s']:.1f} s")
        print(json.dumps(e_out), flush=True)
        s_launches, s_errs = run_sharded(card, base, flat_case, main_recall,
                                         centers, args.seed)
        add_launches(launches, s_launches)
        # phase S's kernel checks at its own shapes join each kernel's error
        for name, err in s_errs.items():
            worst, timing, bound = checks[name]
            checks[name] = (max(worst, err), timing, bound)
        run_chunked(dev, args.seed)
        launches.update(run_flat(dev, base, flat_case, card))
        add_launches(launches, persist_aof_only(dev, card, args.seed))
        add_launches(launches, serve(
            dev, card, serve_dir, a_case, base, flat_case, centers, args.seed
        ))

    log(f"all phases in {time.perf_counter() - t_start:.1f} s")
    meta = {
        "pivot_entry_scan": ("pivot_scan.cu", "pallas_pivot.py:77"),
        "knn_lane_topc": ("lane_scan.cu", "pallas_scan.py:642"),
        "knn_lane_topc_masked": ("lane_scan.cu", "pallas_scan.py:561"),
        "lane_topk_scan_packed_int8": ("flat_scan.cu", "pallas_scan.py:396"),
        "lane_topk_scan_packed": ("flat_scan.cu", "pallas_scan.py:335"),
        "lane_topk_scan_int8": ("flat_scan.cu", "pallas_scan.py:746"),
        "lane_topk_scan": ("lane_scan.cu", "pallas_scan.py:819"),
    }
    kernels = []
    for name, (err, ms, bound) in checks.items():
        src, tpu = meta[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"scintirete_tpu_torch/csrc/{src}",
            "replaces": f"scintirete_tpu/ops/{tpu}",
            "launches": launches[name], "max_abs_err": err,
            "ms": ms[0], "plain_ms": ms[1], "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": ms[2],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
