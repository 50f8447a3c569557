"""Exact flat scan: distance product + top-k over the whole collection.

Port of `scintirete_tpu/ops/flat_scan.py`, the compute path of
`index.flat.FlatIndex`. Three entry points:

- `flat_topk`: one [B, N] distance block and its k least values when the
  block is small, otherwise a walk over base tiles, each reduced to its k
  least and merged exactly into the running top-k, so peak memory is
  O(B * tile);
- `flat_topk_fused`: the packed lane scan (`ops/packed_scan.py`) selects
  2 * LANES winners per query without the score matrix ever existing,
  then the `width` best are reranked against the exact matrix;
- `flat_topk_rerank`: `flat_topk` over a bf16 scan copy for a `width`
  candidate pool, reranked against the exact matrix.

Where the JAX package selects with `lax.approx_min_k`, the port takes the
exact k least with `lax.top_k`'s tie order (a stable ascending sort), so
the `recall_target` argument is gone; on the CPU the JAX call is exact as
well, which lets tests compare the two id for id. The first-pass products
are plain `torch.matmul` through `pairwise_distance`, as the JAX package
leaves them to XLA. The rerank is an elementwise multiply and a sum over
the depth, so it is true f32 whatever `allow_tf32` says; returned
distances are `pairwise_distance`'s values up to the order of the sum.
"""

from __future__ import annotations

import torch

from scintirete_tpu_torch.ops.distance import (
    dist_from_dots,
    pairwise_distance,
    preprocess_norms,
)
from scintirete_tpu_torch.ops.topk import stable_smallest
from scintirete_tpu_torch.types import DistanceMetric

# most elements of the [B, N] score block taken in one shot (f32: 1 GiB)
_SINGLE_SHOT_ELEMS = 256 * 1024 * 1024
_TILE = 262144


def _pad_to_k(top_d, top_i, k: int):
    """Pad [B, kk] results out to k columns with (+inf, -1) and mark every
    infinite distance as empty."""
    pad = k - top_d.shape[1]
    if pad > 0:
        B = top_d.shape[0]
        top_d = torch.cat([top_d, top_d.new_full((B, pad), torch.inf)], dim=1)
        top_i = torch.cat([top_i, top_i.new_full((B, pad), -1)], dim=1)
    return top_d, torch.where(torch.isinf(top_d), -1, top_i).to(torch.int32)


def flat_topk(queries, base, valid, metric: int, k: int,
              base_sq_norms=None, tile: int = _TILE):
    """Returns (distances [B, k] f32 asc, slot indices [B, k] i32).

    queries [B, D]; base [N, D] f32 or bf16 (the product runs on the
    base's storage type); valid [N] bool, False for empty or deleted
    slots, which surface as +inf distance with index -1."""
    B = queries.shape[0]
    N = base.shape[0]
    if base_sq_norms is None:
        base_sq_norms = preprocess_norms(base)
    kk = min(k, N)

    if B * N <= _SINGLE_SHOT_ELEMS or N <= tile:
        d = pairwise_distance(queries, base, metric, base_sq_norms)
        d = torch.where(valid[None, :], d, torch.inf)
        top_d, top_i = stable_smallest(d, kk)
    else:
        dev = queries.device
        top_d = torch.full((B, kk), torch.inf, device=dev)
        top_i = torch.full((B, kk), -1, dtype=torch.int64, device=dev)
        for start in range(0, N, tile):
            stop = min(start + tile, N)  # rows past N would only be invalid
            d = pairwise_distance(
                queries, base[start:stop], metric, base_sq_norms[start:stop]
            )
            d = torch.where(valid[None, start:stop], d, torch.inf)
            td, ti = stable_smallest(d, min(kk, stop - start))
            # running list first: on equal distances the earlier entry wins
            all_d = torch.cat([top_d, td], dim=1)
            all_i = torch.cat([top_i, ti + start], dim=1)
            top_d, sel = stable_smallest(all_d, kk)
            top_i = all_i.gather(1, sel)
    return _pad_to_k(top_d, top_i, k)


def _pad_cols(q, width: int):
    """Queries widened with zero columns to a scan copy's `width` (the copy
    is padded for the scan kernels' TMA); zero columns change no dot and
    no norm."""
    pad = width - q.shape[1]
    return torch.nn.functional.pad(q, (0, pad)) if pad > 0 else q


def _rerank(q32, exact_base, ti, metric: int, k: int):
    """Exact f32 distances of the candidate slots ti [B, W] (-1 = empty)
    and the k least of them. The dot is a multiply and a sum, never a
    matrix product, so no reduced-precision product mode can reach it."""
    cand = exact_base[ti.clamp(min=0).long()].float()  # [B, W, D]
    dots = (q32[:, None, :] * cand).sum(dim=-1)
    q_sq = (q32 * q32).sum(dim=-1, keepdim=True)
    c_sq = (cand * cand).sum(dim=-1)
    d = dist_from_dots(dots, q_sq, c_sq, metric)
    d = torch.where(ti < 0, torch.inf, d)
    top_d, sel = stable_smallest(d, min(k, ti.shape[1]))
    return _pad_to_k(top_d, ti.gather(1, sel), k)


def flat_topk_fused(queries, scan_base, exact_base, valid, metric: int,
                    k: int, base_sq_norms, width: int = 64, base_scale=None,
                    tps: int = 1, query_scale=None):
    """Exact search through the packed lane scan: one pass over the scan
    copy selects 2 * LANES winners per query, the `width` best of them are
    reranked against `exact_base`; returned distances are
    `pairwise_distance`'s values.

    queries [B, D] f32, or f16 / int8 (cast up here: fewer bytes to copy
    to the device; int8 queries come with `query_scale` [B] f32 and are
    dequantized first). scan_base [N, D'] bf16 or int8 (then `base_scale`
    [N] f32 is required), pre-normalized for cosine, N % LANES == 0, with
    D' >= D: columns past D are zero;
    exact_base [N, D] f32 or bf16; valid [N] bool; base_sq_norms [N] f32,
    of the scan-form f32 rows. `tps` groups the int8 scan's tiles (see
    `lane_topk_scan_packed_int8`)."""
    from scintirete_tpu_torch.ops.packed_scan import (
        lane_topk_scan_packed,
        lane_topk_scan_packed_int8,
    )

    q32 = queries.float()
    if query_scale is not None:
        q32 = q32 * query_scale[:, None]
    invalid = 1.0 - valid.float()  # the scans mask on > 0.5
    if metric == int(DistanceMetric.COSINE):
        qn = torch.sqrt((q32 * q32).sum(dim=1, keepdim=True))
        q_scan = torch.where(qn > 1e-30, q32 / torch.clamp(qn, min=1e-30), 0.0)
    else:
        q_scan = q32
    q_scan = _pad_cols(q_scan, scan_base.shape[1])
    if scan_base.dtype == torch.int8:
        if base_scale is None:
            raise ValueError("an int8 scan copy needs its per-row scales")
        lane_d, lane_i = lane_topk_scan_packed_int8(
            q_scan, scan_base, base_scale, base_sq_norms, invalid, metric,
            tps=tps,
        )
    else:
        lane_d, lane_i = lane_topk_scan_packed(
            q_scan, scan_base, base_sq_norms, invalid, metric, tps=tps,
        )
    width = min(width, lane_d.shape[1])
    _, sel = stable_smallest(lane_d, width)
    ti = lane_i.gather(1, sel)  # [B, W] rows (-1 = empty)
    return _rerank(q32, exact_base, ti, metric, k)


def flat_topk_rerank(queries, scan_base, exact_base, valid, metric: int,
                     k: int, base_sq_norms, width: int = 64,
                     tile: int = _TILE):
    """Two-pass exact search: `flat_topk` over the bf16 scan copy (D' >=
    D columns, zero past D) for a top-`width` candidate pool, then those
    candidates re-scored against `exact_base` in f32. recall@k is limited
    only by a true neighbor falling more than width - k bf16 ranks below
    its f32 rank."""
    width = min(width, scan_base.shape[0])
    _, ti = flat_topk(
        _pad_cols(queries, scan_base.shape[1]), scan_base, valid, metric,
        width, base_sq_norms, tile=tile,
    )  # [B, W] candidate slots (-1 padded)
    return _rerank(queries.float(), exact_base, ti, metric, k)
