"""Fused pivot-entry scan: per query, the nearest of R sampled pivots.

Port of `scintirete_tpu/ops/pallas_pivot.py::pivot_entry_scan`. The
distance is the comparison form (IP -dot; L2 q^2 + p^2 - 2 dot; cosine
1 - dot on pre-normalized rows), f32 throughout with no TF32: it enters
the beam's candidate list. Deleted pivots (flag > 0.5) score +inf. Ties go
to the lowest pivot index; when every pivot is deleted the result is
(+inf, -1).

`pivot_entry_scan` runs the CUDA kernel (`csrc/pivot_scan.cu`) on CUDA
tensors and the plain version `pivot_entry_scan_plain` on CPU tensors. The
kernel takes any R (the Pallas kernel needed R % 512 == 0) and masks the
ragged edge itself; its C entry sets up, scans and writes (d, i), so the
wrapper only allocates. Its TMA copies take rows of whole 16-byte units:
a D that is not a multiple of 4 is padded with zero columns here (a copy
of the pivots on every call; the main path's widths need none).
"""

from __future__ import annotations

import torch

from scintirete_tpu_torch.ops.lane_scan import tma_rows
from scintirete_tpu_torch.types import DistanceMetric

_L2 = int(DistanceMetric.L2)
_COSINE = int(DistanceMetric.COSINE)
_IP = int(DistanceMetric.INNER_PRODUCT)


def pivot_distance_block(queries, pivot_vecs, pivot_sq, pivot_deleted,
                         metric: int):
    """The [B, R] comparison-form distances the scan minimizes (deleted
    pivots +inf), as one f32 matrix product."""
    q32 = queries.float()
    dots = q32 @ pivot_vecs.float().T
    if metric == _IP:
        d = -dots
    elif metric == _L2:
        qsq = (q32 * q32).sum(dim=1, keepdim=True)
        d = (qsq + pivot_sq[None, :]) - 2.0 * dots
    else:
        d = 1.0 - dots
    return torch.where(pivot_deleted[None, :] > 0.5, torch.inf, d)


def pivot_entry_scan_plain(queries, pivot_vecs, pivot_sq, pivot_deleted,
                           metric: int):
    """Plain torch version: the [B, R] distance block and its argmin."""
    d = pivot_distance_block(queries, pivot_vecs, pivot_sq, pivot_deleted,
                             metric)
    # torch.argmin returns the first minimal index: the lowest-index rule
    best_i = torch.argmin(d, dim=1)
    best_d = d.gather(1, best_i[:, None])[:, 0]
    best_i = torch.where(torch.isinf(best_d), -1, best_i).to(torch.int32)
    return best_d, best_i


def pivot_entry_scan(queries, pivot_vecs, pivot_sq, pivot_deleted,
                     metric: int):
    """Returns (best_dist [B] f32 comparison form, best_pivot [B] i32).

    queries [B, D] f32 (pre-normalized for cosine), pivot_vecs [R, D] f32
    (pre-normalized for cosine), pivot_sq [R] f32, pivot_deleted [R] f32."""
    if queries.device.type == "cpu":
        return pivot_entry_scan_plain(
            queries, pivot_vecs, pivot_sq, pivot_deleted, metric
        )
    if queries.device.type != "cuda":
        raise ValueError(f"pivot_entry_scan: unsupported device {queries.device}")
    from scintirete_tpu_torch.ops._ext import check_tensor as _check
    from scintirete_tpu_torch.ops._ext import kernel

    B, D = queries.shape
    R = pivot_vecs.shape[0]
    dev = queries.device
    _check(queries, "queries", torch.float32, (B, D), dev)
    _check(pivot_vecs, "pivot_vecs", torch.float32, (R, D), dev)
    _check(pivot_sq, "pivot_sq", torch.float32, (R,), dev)
    _check(pivot_deleted, "pivot_deleted", torch.float32, (R,), dev)
    if metric not in (_L2, _COSINE, _IP):
        raise ValueError(f"unsupported metric code: {metric}")
    # TMA rows: whole 16-byte units (D % 4 == 0), 16-byte aligned starts
    q, piv = tma_rows(queries), tma_rows(pivot_vecs)
    keys = torch.empty(B, dtype=torch.int64, device=dev)
    best_d = torch.empty(B, dtype=torch.float32, device=dev)
    best_i = torch.empty(B, dtype=torch.int32, device=dev)
    err = kernel("pivot_scan")(
        q.data_ptr(), piv.data_ptr(), pivot_sq.data_ptr(),
        pivot_deleted.data_ptr(), keys.data_ptr(), best_d.data_ptr(),
        best_i.data_ptr(), B, R, q.shape[1], metric,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pivot_entry_scan launch failed: cudaError {err}")
    pivot_entry_scan.launches += 1
    return best_d, best_i


pivot_entry_scan.launches = 0
