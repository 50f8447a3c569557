"""Chip check of the PyTorch/CUDA port (`scintirete_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero and prints no result line:
 1. a CUDA card must be present; prints its name and power limit;
 2. builds every CUDA kernel of the port from the sources in the checkout
    (nvcc, into build/kernels/) and the C++ link-application library (g++,
    into build/native/), and fails unless the C++ library loaded (so no
    number below comes from its numpy fallback); prints the build seconds;
 3. holds each of the seven kernels against its plain torch version on the
    card, at the shapes of the main path: pivot_entry_scan (B=256, D=128, R=65,536 and a
    ragged R, 3 metrics, deleted pivots, all deleted), knn_lane_topc
    (B=2048, N=1,048,576, D=128, c=64, 3 metrics, partial n_valid) and
    knn_lane_topc_masked (B=2048, N=1,048,576, D=128, c=64, 3 metrics,
    self rows; mask = non-members of the layer-4 membership of a level
    draw, about 1/16 of the rows kept, plus 1% tombstones and a padded
    tail past 1,000,000), and the four scans of the flat index
    (lane_topk_scan_packed_int8 at tile groups of 1 and 4,
    lane_topk_scan_packed, lane_topk_scan_int8, lane_topk_scan: B=1024,
    N=1,048,576, D=128, 3 metrics, 1% deleted rows and an invalid tail
    past 1,000,000; the int8 scans must equal their plain versions bit for
    bit, the bf16 ones within the f32 sum-order tolerance;
    lane_topk_scan_packed_int8 also with one query and with 4,096, the
    other two batch sizes the flat path launches it at); prints the
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
    them comes back;
 5. append: inserts 4 batches of 4,096 new vectors (same generator and
    centers) into that collection through Collection.insert (the batched
    append); prints seconds and vectors/s per batch; searches 4,096
    perturbed copies of base and appended points at ef_search=12 and fails
    below recall@10 0.95 against the brute force over every live vector;
    queries every appended vector and fails if fewer than 0.99 of them
    find their own id first; fails unless knn_lane_topc_masked was
    launched by this phase;
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
 8. prints the kernels' JSON line (seven entries), the card's line, and
    last {"ok": true, "device": {...}}.

On one H100 the whole run takes 2 to 3.5 minutes of the 20 it may take.

This script imports nothing of JAX and nothing of the JAX package, and
reads no environment variable. The data is made from --seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
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
                    # the product inside alone, as one library call
                    median_ms(lambda: torch.matmul(q, pv.T), 50),
                )
                # q, pivots, their norms and tombstones in; (d, i) out
                nbytes = 4 * (B * D + R * D + 2 * R + 2 * B)
                bound = bound_ms(2.0 * B * R * D, "f32", nbytes)
        d_k, i_k = pivot_entry_scan(q, pv, psq, torch.ones(R, device=dev), 1)
        if not (bool(torch.isinf(d_k).all()) and bool((i_k == -1).all())):
            fail("pivot_entry_scan: all-deleted case must give (+inf, -1)")
    log(f"pivot_entry_scan B=256 R=65536 D=128 cosine: kernel "
        f"{timing[0]:.4f} ms, plain {timing[1]:.4f} ms, matmul "
        f"{timing[2]:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    return worst_err, timing, bound


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
    worst_err, worst_share, timing = 0.0, 1.0, None
    base32 = torch.randn(N, D, generator=g, device=dev)
    for metric in (1, 2, 3):
        b32 = base32 / base32.norm(dim=1, keepdim=True) if metric == 2 else base32
        base = b32.to(torch.bfloat16)
        bsq = (b32 * b32).sum(1)
        qb = base[si.long()].contiguous()
        k_out = lane_scan_masked(qb, si, base, bsq, invalid, metric, tiles)
        p_out = lane_scan_masked_plain(qb, si, base, bsq, invalid, metric, tiles)
        torch.cuda.synchronize()
        for (dk, ik), (dp, ip), which in (
            ((k_out[0], k_out[1]), (p_out[0], p_out[1]), "best"),
            ((k_out[2], k_out[3]), (p_out[2], p_out[3]), "second"),
        ):
            err, share = compare(
                f"knn_lane_topc_masked metric={metric} lane {which}", dk, ik,
                dp, ip, atol=1e-4, rtol=1e-5,
            )
            worst_err, worst_share = max(worst_err, err), min(worst_share, share)
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
        log(f"knn_lane_topc_masked metric={metric}: max|dd|={worst_err:.3g} "
            f"ids equal {worst_share:.6f}")
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


def log_timing(name, what, timing, bound):
    lib = "no single call" if timing[2] is None else f"{timing[2]:.3f} ms"
    log(f"{name} B={FLAT_B} N={FLAT_N} D={DIM} cosine: kernel "
        f"{timing[0]:.3f} ms, plain {timing[1]:.3f} ms, {what} {lib}, "
        f"bound {bound[0]:.4f} ms ({bound[1]})")


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
        for tps in (1, 4):  # tile groups of 1 and 4
            args = (qs, base8, scale, bsq, invalid, metric)
            keys, rows = ps.lane_topk_scan_packed_int8(*args, tps=tps)
            q8, qs2, bs, bq = ps.packed_int8_inputs(qs, scale, bsq, invalid, metric)

            def plain():
                return ps.lane_topk_scan_packed_int8_plain(
                    q8, qs2, base8, bs, bq, metric, min(ps._PREMIN, tps)
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
            log(f"{name} metric={metric} group={min(ps._PREMIN, tps)}: keys "
                f"equal bit for bit, rows equal")
            if metric == 2 and tps == 1:
                timing = (
                    median_ms(lambda: ps.lane_topk_scan_packed_int8(*args), 10),
                    median_ms(plain, 2),
                    int_mm_ms(q8, base8),
                )
                # the flat path also launches this scan with one query
                # (a block with 63 padded query rows) and with all 4,096
                # (a grid four times deeper): same base, cosine, bit for bit
                g = torch.Generator(device=dev).manual_seed(4096)
                q_all = scan_form(
                    torch.randn(N_QUERIES, DIM, generator=g, device=dev), metric
                )
                want = ps.lane_topk_scan_packed_int8_plain(
                    *ps.packed_int8_inputs(q_all, scale, bsq, invalid, metric)[:2],
                    base8, bs, bq, metric, 1,
                )
                for b in (N_QUERIES, 1):
                    keys, rows = ps.lane_topk_scan_packed_int8(
                        q_all[:b], *args[1:]
                    )
                    if not torch.equal(keys.view(torch.int32),
                                       want[:b].view(torch.int32)):
                        fail(f"{name} B={b}: keys differ from the plain version")
                    if not torch.equal(rows, ps.unpack_lane_keys(want[:b])[1]):
                        fail(f"{name} B={b}: rows differ")
                    log(f"{name} metric={metric} B={b}: keys equal bit for "
                        f"bit, rows equal")
    # f32 queries, int8 base, scales, norms and mask in; keys and rows out
    nbytes = 4 * FLAT_B * DIM + FLAT_N * DIM + 12 * FLAT_N + 16 * FLAT_B * 1024
    bound = bound_ms(2.0 * FLAT_B * FLAT_N * DIM, "int8", nbytes)
    log_timing(name, "torch._int_mm", timing, bound)
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
        qb = qs.to(torch.bfloat16)
        bsq = (b32 * b32).sum(1)
        args = (qs, base, bsq, invalid, metric)
        keys, rows = ps.lane_topk_scan_packed(*args)
        want = ps.lane_topk_scan_packed_plain(qb, base, bsq, invalid, metric)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(keys).all()):
            fail(f"{name} metric={metric}: a packed key is not finite")
        diff = (keys - want).abs()
        worst = max(worst, float(diff.max()))
        # the f32 sum of a product runs in another order than the
        # library's: one unit of the last mantissa bit a key keeps
        if bool((diff > KEY_RTOL * want.abs() + 1e-30).any()):
            fail(f"{name} metric={metric}: keys differ by {float(diff.max())}")
        share = float((rows == ps.unpack_lane_keys(want)[1]).float().mean())
        bits = float((keys.view(torch.int32) == want.view(torch.int32))
                     .float().mean())
        if share < 0.999:
            fail(f"{name} metric={metric}: only {share:.6f} of the rows equal")
        no_invalid_row(name, rows, invalid)
        log(f"{name} metric={metric}: max|dk|={float(diff.max()):.3g} keys "
            f"bit-equal {bits:.6f} rows equal {share:.6f}")
        if metric == 2:
            timing = (
                median_ms(lambda: ps.lane_topk_scan_packed(*args), 10),
                median_ms(lambda: ps.lane_topk_scan_packed_plain(
                    qb, base, bsq, invalid, metric), 2),
                median_ms(lambda: torch.matmul(qb, base.T), 10),
            )
    # f32 queries, bf16 base, norms and mask in; keys and rows out
    nbytes = 4 * FLAT_B * DIM + 2 * FLAT_N * DIM + 8 * FLAT_N + 16 * FLAT_B * 1024
    bound = bound_ms(2.0 * FLAT_B * FLAT_N * DIM, "bf16", nbytes)
    log_timing(name, "matmul", timing, bound)
    return worst, timing, bound


def check_lane_int8(dev, inputs):
    import torch

    from scintirete_tpu_torch.ops import packed_scan as ps

    name = "lane_topk_scan_int8"
    q, base32, invalid = inputs
    worst, timing = 0.0, None
    for metric in (1, 2, 3):
        qs, b32 = scan_form(q, metric), scan_form(base32, metric)
        base8, scale = ps.quantize_rows(b32)
        bsq = (b32 * b32).sum(1)
        args = (qs, base8, scale, bsq, invalid, metric)
        d, i = ps.lane_topk_scan_int8(*args)
        q8, q_scale = ps.quantize_rows(qs)

        def plain():
            return ps.lane_topk_scan_int8_plain(
                q8, q_scale, base8, scale, bsq, invalid, metric
            )

        want_d, want_i = plain()
        torch.cuda.synchronize()
        # exact product, no contraction: equal, not merely close
        err, share = compare(f"{name} metric={metric}", d, i, want_d, want_i,
                             atol=0.0, rtol=0.0)
        worst = max(worst, err)
        if share < 1.0:
            fail(f"{name} metric={metric}: ids differ from the plain version")
        no_invalid_row(name, i, invalid)
        log(f"{name} metric={metric}: scores and ids equal")
        if metric == 2:
            timing = (
                median_ms(lambda: ps.lane_topk_scan_int8(*args), 10),
                median_ms(plain, 2),
                int_mm_ms(q8, base8),
            )
    nbytes = 4 * FLAT_B * DIM + FLAT_N * DIM + 12 * FLAT_N + 16 * FLAT_B * 1024
    bound = bound_ms(2.0 * FLAT_B * FLAT_N * DIM, "int8", nbytes)
    log_timing(name, "torch._int_mm", timing, bound)
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
        HNSWParams,
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
    true_after = ground_truth(dev, queries, base, valid, 2)
    rec_del = recall_of(results, true_after)
    log(f"after deleting {len(del_ids)} ids: recall@10 {rec_del:.4f} "
        f"against the survivors, no deleted id returned")
    if rec_del < RECALL_GATE:
        fail(f"recall@10 after delete {rec_del:.4f} < {RECALL_GATE}")
    flat_case = (queries, true_i, del_ids, true_after)
    return launches, col, base, valid, centers, rng, flat_case


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
    from scintirete_tpu_torch.ops.lane_scan import lane_scan, lane_scan_masked

    n = len(base)
    new = points_near(rng, centers, APPEND_BATCHES * APPEND_BATCH)
    lane_scan_masked.launches = 0
    lane_scan.launches = 0
    per_batch = []
    for b in range(APPEND_BATCHES):
        chunk = new[b * APPEND_BATCH : (b + 1) * APPEND_BATCH]
        t0 = time.perf_counter()
        ids = col.insert([(v, None) for v in chunk])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want = n + b * APPEND_BATCH + 1
        if ids != list(range(want, want + APPEND_BATCH)):
            fail("append must assign the next ids")
        per_batch.append(dt)
        log(f"append batch {b}: {APPEND_BATCH} vectors in {dt:.3f} s = "
            f"{APPEND_BATCH / dt:.1f} vec/s")
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
    return launches, per_batch


def run_chunked(dev, seed):
    """Chunked device insertion: batches under the append threshold into
    a fresh collection of the main path's config."""
    import torch

    from scintirete_tpu_torch import (
        CollectionConfig,
        DistanceMetric,
        HNSWParams,
        SearchParams,
    )
    from scintirete_tpu_torch.engine import Engine

    rng = np.random.default_rng(seed + 3)
    n = CHUNKED_BATCHES * CHUNKED_BATCH
    base, queries, _ = make_dataset(rng, n, 1024)
    col = Engine(device=dev).create_database("chunked").create_collection(
        CollectionConfig(
            name="c", metric=DistanceMetric.COSINE,
            hnsw=HNSWParams(m=16, ef_construction=200, ef_search=12, seed=42,
                            neighbor_heuristic=True),
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


def run_flat(dev, base, flat_case):
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

    col = Engine(device=dev).create_database("flat").create_collection(
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
    del col

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="data seed")
    args = ap.parse_args()

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

    t0 = time.perf_counter()
    if load_native() is None:
        fail("the C++ link-application library did not build or load")
    log(f"C++ library built and loaded in {time.perf_counter() - t0:.2f} s")

    checks = {
        "pivot_entry_scan": check_pivot(dev, args.seed),
        "knn_lane_topc": check_lane(dev, args.seed),
        "knn_lane_topc_masked": check_lane_masked(dev, args.seed),
    }
    flat_inputs = flat_kernel_inputs(dev, args.seed)
    checks["lane_topk_scan_packed_int8"] = check_packed_int8(dev, flat_inputs)
    checks["lane_topk_scan_packed"] = check_packed(dev, flat_inputs)
    checks["lane_topk_scan_int8"] = check_lane_int8(dev, flat_inputs)
    checks["lane_topk_scan"] = check_lane_flat(dev, flat_inputs)
    del flat_inputs
    torch.cuda.empty_cache()
    launches, col, base, valid, centers, rng, flat_case = run_main_path(
        dev, N_BASE, N_QUERIES, args.seed
    )
    launches["knn_lane_topc_masked"], _ = run_append(
        dev, col, base, valid, centers, rng
    )
    del col
    run_chunked(dev, args.seed)
    launches.update(run_flat(dev, base, flat_case))

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
