"""Builder candidate scan: lane best-two fold + exact top-c.

Port of `scintirete_tpu/ops/pallas_scan.py::knn_lane_topc`. Lane j keeps
the two least ranking scores among base rows {j, j + LANES, j + 2 LANES,
...} of the first `grid_tiles` tiles, folded in tile order with strict <
(`_fold_best_two`). Scores are RANKING form (L2 b^2 - 2 dot, cosine/IP
-dot) on bf16 inputs with f32 sums; columns >= n_valid and each row's own
index are masked out. The 2 * LANES winners are then reduced to an exact
top-c and finalized (L2 sqrt(s + q^2), cosine 1 + s).

`lane_scan` computes the four lane arrays: the CUDA kernel
(`csrc/lane_scan.cu`) on CUDA tensors, the plain version `lane_scan_plain`
on CPU tensors. `knn_lane_topc` is the full wrapper.
"""

from __future__ import annotations

import torch

from scintirete_tpu.types import DistanceMetric
from scintirete_tpu_torch.ops.topk import stable_smallest

_L2 = int(DistanceMetric.L2)
_COSINE = int(DistanceMetric.COSINE)
_IP = int(DistanceMetric.INNER_PRODUCT)

LANES = 1024


def _fold_best_two(s, si, d1, i1, d2, i2):
    """Fold a [B, LANES] score block into the per-lane (best, second-best)
    running minima; the displaced best becomes a second-best candidate."""
    promoted = s < d1
    mid_d = torch.where(promoted, d1, s)
    mid_i = torch.where(promoted, i1, si)
    d1 = torch.where(promoted, s, d1)
    i1 = torch.where(promoted, si, i1)
    second = mid_d < d2
    d2 = torch.where(second, mid_d, d2)
    i2 = torch.where(second, mid_i, i2)
    return d1, i1, d2, i2


def lane_scan_plain(qb, self_idx, base, base_sq, n_valid: int, metric: int,
                    grid_tiles: int):
    """Plain torch version of the Pallas kernel body: one tile of LANES
    base rows per step, folded in tile order."""
    B = qb.shape[0]
    dev = qb.device
    q32 = qb.float()
    d1 = torch.full((B, LANES), torch.inf, device=dev)
    d2 = torch.full((B, LANES), torch.inf, device=dev)
    i1 = torch.full((B, LANES), -1, dtype=torch.int32, device=dev)
    i2 = torch.full((B, LANES), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(LANES, dtype=torch.int32, device=dev)
    self_col = self_idx.to(torch.int32)[:, None]
    for t in range(grid_tiles):
        rows = slice(t * LANES, (t + 1) * LANES)
        dots = q32 @ base[rows].float().T  # bf16 products are exact in f32
        if metric == _L2:
            s = base_sq[rows][None, :] - 2.0 * dots
        else:
            s = -dots
        si = (lane + t * LANES)[None, :].expand(B, LANES)
        bad = (si >= n_valid) | (si == self_col)
        s = torch.where(bad, torch.inf, s)
        d1, i1, d2, i2 = _fold_best_two(s, si, d1, i1, d2, i2)
    return d1, i1, d2, i2


def lane_scan(qb, self_idx, base, base_sq, n_valid: int, metric: int,
              grid_tiles: int):
    """Lane arrays (d1, i1, d2, i2), each [B, LANES]: the body of the
    Pallas call. qb [B, D] bf16, self_idx [B] i32, base [N, D] bf16 with
    N % LANES == 0 and grid_tiles * LANES <= N, base_sq [N] f32."""
    B, D = qb.shape
    N = base.shape[0]
    if N % LANES or not 0 <= grid_tiles <= N // LANES:
        raise ValueError(
            f"lane_scan: N={N} must be a multiple of {LANES} covering "
            f"grid_tiles={grid_tiles}"
        )
    if qb.device.type == "cpu":
        return lane_scan_plain(
            qb, self_idx, base, base_sq, n_valid, metric, grid_tiles
        )
    if qb.device.type != "cuda":
        raise ValueError(f"lane_scan: unsupported device {qb.device}")
    from scintirete_tpu_torch.ops._ext import check_tensor as _check
    from scintirete_tpu_torch.ops._ext import kernel

    dev = qb.device
    _check(qb, "qb", torch.bfloat16, (B, D), dev)
    _check(self_idx, "self_idx", torch.int32, (B,), dev)
    _check(base, "base", torch.bfloat16, (N, D), dev)
    _check(base_sq, "base_sq", torch.float32, (N,), dev)
    if metric not in (_L2, _COSINE, _IP):
        raise ValueError(f"unsupported metric code: {metric}")
    d1 = torch.empty((B, LANES), dtype=torch.float32, device=dev)
    d2 = torch.empty((B, LANES), dtype=torch.float32, device=dev)
    i1 = torch.empty((B, LANES), dtype=torch.int32, device=dev)
    i2 = torch.empty((B, LANES), dtype=torch.int32, device=dev)
    aligned = D % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (qb, base))
    err = kernel("lane_scan")(
        qb.data_ptr(), self_idx.data_ptr(), base.data_ptr(),
        base_sq.data_ptr(), d1.data_ptr(), i1.data_ptr(), d2.data_ptr(),
        i2.data_ptr(), B, D, N, int(n_valid), grid_tiles, metric,
        int(aligned), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"knn_lane_topc launch failed: cudaError {err}")
    lane_scan.launches += 1
    return d1, i1, d2, i2


lane_scan.launches = 0


def knn_lane_topc(queries, self_idx, base, base_sq, n_valid: int,
                  metric: int, c: int, grid_tiles: int, q_sq=None):
    """Top-c prefix neighbors of each query row over the first
    grid_tiles * LANES base rows, self-excluded, with TRUE finalized
    distances. Returns (cd [B, c] f32 asc, ci [B, c] i32), -1/inf padded.

    queries [B, D] f32 or bf16 scan-form rows (normalized for cosine);
    q_sq [B] f32: the true squared norms for the L2 finalization."""
    qb = queries.float().to(torch.bfloat16).contiguous()
    d1, i1, d2, i2 = lane_scan(
        qb, self_idx.to(torch.int32).contiguous(), base, base_sq, n_valid,
        metric, grid_tiles,
    )
    lane_d = torch.cat([d1, d2], dim=1)
    lane_i = torch.cat([i1, i2], dim=1)
    cd, sel = stable_smallest(lane_d, c)  # lax.top_k's tie order
    ci = lane_i.gather(1, sel)
    if metric == _L2:
        if q_sq is None:
            q32 = queries.float()
            q_sq = (q32 * q32).sum(dim=1)
        cd = torch.sqrt(torch.clamp(cd + q_sq[:, None], min=0.0))
    elif metric == _COSINE:
        cd = 1.0 + cd  # -cos -> 1 - cos
    cd = torch.where(ci < 0, torch.inf, cd)
    return cd, ci
