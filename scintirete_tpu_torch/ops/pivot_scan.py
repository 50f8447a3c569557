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
ragged edge itself.
"""

from __future__ import annotations

import torch

from scintirete_tpu.types import DistanceMetric

_L2 = int(DistanceMetric.L2)
_COSINE = int(DistanceMetric.COSINE)
_IP = int(DistanceMetric.INNER_PRODUCT)


def pivot_entry_scan_plain(queries, pivot_vecs, pivot_sq, pivot_deleted,
                           metric: int):
    """Plain torch version: the [B, R] distance block and its argmin."""
    q32 = queries.float()
    dots = q32 @ pivot_vecs.float().T
    if metric == _IP:
        d = -dots
    elif metric == _L2:
        qsq = (q32 * q32).sum(dim=1, keepdim=True)
        d = (qsq + pivot_sq[None, :]) - 2.0 * dots
    else:
        d = 1.0 - dots
    d = torch.where(pivot_deleted[None, :] > 0.5, torch.inf, d)
    # torch.argmin returns the first minimal index: the lowest-index rule
    best_i = torch.argmin(d, dim=1)
    best_d = d.gather(1, best_i[:, None])[:, 0]
    best_i = torch.where(torch.isinf(best_d), -1, best_i).to(torch.int32)
    return best_d, best_i


def _decode_keys(keys):
    """(mono(d) << 32 | idx) int64 keys -> (d f32, idx i32); empty -> -1."""
    hi = (keys >> 32) & 0xFFFFFFFF
    lo = keys & 0xFFFFFFFF
    bits = torch.where(hi >= 0x80000000, hi - 0x80000000, 0xFFFFFFFF - hi)
    d = bits.to(torch.int32).view(torch.float32)
    empty = (lo == 0xFFFFFFFF) | torch.isinf(d)
    d = torch.where(empty, torch.inf, d)
    idx = torch.where(empty, -1, lo).to(torch.int32)
    return d, idx


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
    qsq = (queries * queries).sum(dim=1)
    keys = torch.empty(B, dtype=torch.int64, device=dev)
    keys.fill_(-1)  # all ones: larger than any real key
    aligned = D % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (queries, pivot_vecs)
    )
    err = kernel("pivot_scan")(
        queries.data_ptr(), qsq.data_ptr(), pivot_vecs.data_ptr(),
        pivot_sq.data_ptr(), pivot_deleted.data_ptr(), keys.data_ptr(),
        B, R, D, metric, int(aligned), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pivot_entry_scan launch failed: cudaError {err}")
    pivot_entry_scan.launches += 1
    return _decode_keys(keys)


pivot_entry_scan.launches = 0
