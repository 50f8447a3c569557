"""Builder candidate scans: lane best-two fold + exact top-c.

Ports of `scintirete_tpu/ops/pallas_scan.py::knn_lane_topc` and
`::knn_lane_topc_masked`. Lane j keeps the two least ranking scores among
base rows {j, j + LANES, j + 2 LANES, ...} of the first `grid_tiles`
tiles, folded in tile order with strict < (`_fold_best_two`). Scores are
RANKING form (L2 b^2 - 2 dot, cosine/IP -dot) on bf16 inputs with f32
sums; masked rows and each query's own row are excluded. The mask is the
prefix bound (columns >= n_valid) for `knn_lane_topc`, and a per-row f32
`invalid` array (masked where > 0.5) for `knn_lane_topc_masked`. The
2 * LANES winners are then reduced to an exact top-c and finalized (L2
sqrt(s + q^2), cosine 1 + s).

`lane_scan` / `lane_scan_masked` compute the four lane arrays: the CUDA
kernel (`csrc/lane_scan.cu`: bf16 wgmma fed by TMA, the fold in the
epilogue; one templated body, two entry points) on CUDA tensors, the plain
versions `lane_scan_plain` / `lane_scan_masked_plain` on CPU tensors.
`knn_lane_topc` and `knn_lane_topc_masked` are the full wrappers.

The kernel's TMA copies need rows of whole 16-byte units (D % 8 == 0 in
bf16) and 16-byte aligned starts. Callers that keep a scan base make it
`scan_width(D)` columns wide, zero-padded (`index/knn_build.py`), so the
main path copies nothing; the wrappers pad any other input (`tma_rows`).
Zero columns change no dot product and no norm. The fold state keeps
16-bit tile ids, so one launch scans at most MAX_TILES tiles.
"""

from __future__ import annotations

import torch

from scintirete_tpu_torch.types import DistanceMetric
from scintirete_tpu_torch.ops.topk import stable_smallest

_L2 = int(DistanceMetric.L2)
_COSINE = int(DistanceMetric.COSINE)
_IP = int(DistanceMetric.INNER_PRODUCT)

LANES = 1024
MAX_TILES = 65535  # 16-bit tile ids in the kernel's fold state, 0xffff = empty


def scan_width(dim: int, elem_bytes: int = 2) -> int:
    """Columns of a scan base for `dim`-wide vectors of `elem_bytes`-byte
    values: a whole number of 16-byte units per row (bf16: `dim` rounded
    up to a multiple of 8, int8: of 16, f32: of 4)."""
    unit = 16 // elem_bytes
    return -(-dim // unit) * unit


def tma_rows(t):
    """[R, D] rows (bf16, int8 or f32) as the scan kernels' TMA copies take
    them (whole 16-byte units per row, 16-byte aligned start): `t` itself
    when it is so, else a copy with zero columns appended."""
    pad = scan_width(t.shape[1], t.element_size()) - t.shape[1]
    if pad == 0 and t.data_ptr() % 16 == 0:
        return t
    return torch.nn.functional.pad(t, (0, pad)) if pad else t.clone()


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


def _fold_tiles_plain(qb, self_idx, base, base_sq, metric: int,
                      grid_tiles: int, masked_rows):
    """Plain torch version of the Pallas kernel bodies: one tile of LANES
    base rows per step, folded in tile order. `masked_rows(lo, hi)` gives
    the mask of base rows [lo, hi); rows past N are masked and add
    nothing to a product."""
    B, D = qb.shape
    N = base.shape[0]
    dev = qb.device
    q32 = qb.float()
    d1 = torch.full((B, LANES), torch.inf, device=dev)
    d2 = torch.full((B, LANES), torch.inf, device=dev)
    i1 = torch.full((B, LANES), -1, dtype=torch.int32, device=dev)
    i2 = torch.full((B, LANES), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(LANES, dtype=torch.int32, device=dev)
    self_col = self_idx.to(torch.int32)[:, None]
    for t in range(grid_tiles):
        lo = t * LANES
        hi = min(lo + LANES, N)
        tile = base[lo:hi].float()
        tile_sq = base_sq[lo:hi]
        bad_rows = masked_rows(lo, hi)
        if hi - lo < LANES:  # ragged last tile
            pad = LANES - (hi - lo)
            tile = torch.cat([tile, tile.new_zeros((pad, D))])
            tile_sq = torch.cat([tile_sq, tile_sq.new_zeros(pad)])
            bad_rows = torch.cat(
                [bad_rows, torch.ones(pad, dtype=torch.bool, device=dev)]
            )
        dots = q32 @ tile.T  # bf16 products are exact in f32
        if metric == _L2:
            s = tile_sq[None, :] - 2.0 * dots
        else:
            s = -dots
        si = (lane + lo)[None, :].expand(B, LANES)
        bad = bad_rows[None, :] | (si == self_col)
        s = torch.where(bad, torch.inf, s)
        d1, i1, d2, i2 = _fold_best_two(s, si, d1, i1, d2, i2)
    return d1, i1, d2, i2


def lane_scan_plain(qb, self_idx, base, base_sq, n_valid: int, metric: int,
                    grid_tiles: int):
    """Plain version of `lane_scan`: rows >= n_valid are masked."""
    lane = torch.arange(LANES, dtype=torch.int32, device=qb.device)
    return _fold_tiles_plain(
        qb, self_idx, base, base_sq, metric, grid_tiles,
        lambda lo, hi: lane[: hi - lo] + lo >= n_valid,
    )


def lane_scan_masked_plain(qb, self_idx, base, base_sq, invalid,
                           metric: int, grid_tiles: int):
    """Plain version of `lane_scan_masked`: rows with invalid > 0.5, and
    rows >= N, are masked."""
    return _fold_tiles_plain(
        qb, self_idx, base, base_sq, metric, grid_tiles,
        lambda lo, hi: invalid[lo:hi] > 0.5,
    )


def _checked_lane_arrays(qb, self_idx, base, base_sq, metric: int,
                         grid_tiles: int):
    """Check the CUDA inputs both scans share. Returns the four empty lane
    arrays (d1, i1, d2, i2), each [B, LANES], the queries and the base as
    the kernel takes them (`tma_rows`), and whether they are so."""
    from scintirete_tpu_torch.ops._ext import check_tensor

    B, D = qb.shape
    N = base.shape[0]
    dev = qb.device
    check_tensor(qb, "qb", torch.bfloat16, (B, D), dev)
    check_tensor(self_idx, "self_idx", torch.int32, (B,), dev)
    check_tensor(base, "base", torch.bfloat16, (N, D), dev)
    check_tensor(base_sq, "base_sq", torch.float32, (N,), dev)
    if metric not in (_L2, _COSINE, _IP):
        raise ValueError(f"unsupported metric code: {metric}")
    if grid_tiles > MAX_TILES:
        raise ValueError(
            f"grid_tiles={grid_tiles} exceeds the kernel's {MAX_TILES} tiles "
            f"({MAX_TILES * LANES} rows)"
        )
    d = [torch.empty((B, LANES), dtype=torch.float32, device=dev)
         for _ in range(2)]
    i = [torch.empty((B, LANES), dtype=torch.int32, device=dev)
         for _ in range(2)]
    qb, base = tma_rows(qb), tma_rows(base)
    aligned = qb.shape[1] % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (qb, base)
    )
    return (d[0], i[0], d[1], i[1]), qb, base, aligned


def lane_scan(qb, self_idx, base, base_sq, n_valid: int, metric: int,
              grid_tiles: int):
    """Lane arrays (d1, i1, d2, i2), each [B, LANES]: the body of the
    Pallas call. qb [B, D] bf16, self_idx [B] i32, base [N, D] bf16 with
    N % LANES == 0 and grid_tiles * LANES <= N, base_sq [N] f32."""
    B = qb.shape[0]
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
    from scintirete_tpu_torch.ops._ext import kernel

    (d1, i1, d2, i2), qb, base, aligned = _checked_lane_arrays(
        qb, self_idx, base, base_sq, metric, grid_tiles
    )
    err = kernel("lane_scan")(
        qb.data_ptr(), self_idx.data_ptr(), base.data_ptr(),
        base_sq.data_ptr(), d1.data_ptr(), i1.data_ptr(), d2.data_ptr(),
        i2.data_ptr(), B, qb.shape[1], N, int(n_valid), grid_tiles, metric,
        int(aligned), torch.cuda.current_stream(qb.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"knn_lane_topc launch failed: cudaError {err}")
    lane_scan.launches += 1
    return d1, i1, d2, i2


lane_scan.launches = 0


def lane_scan_masked(qb, self_idx, base, base_sq, invalid, metric: int,
                     grid_tiles: int):
    """Lane arrays (d1, i1, d2, i2), each [B, LANES], of the masked scan:
    the body of the masked Pallas call. qb [B, D] bf16, self_idx [B] i32
    (-1 = no exclusion), base [N, D] bf16 (any N), base_sq [N] f32,
    invalid [N] f32 (> 0.5 = masked), grid_tiles * LANES < N + LANES."""
    B = qb.shape[0]
    N = base.shape[0]
    if not 0 <= grid_tiles <= -(-N // LANES):
        raise ValueError(
            f"lane_scan_masked: grid_tiles={grid_tiles} exceeds the "
            f"{-(-N // LANES)} tiles of N={N}"
        )
    if qb.device.type == "cpu":
        return lane_scan_masked_plain(
            qb, self_idx, base, base_sq, invalid, metric, grid_tiles
        )
    if qb.device.type != "cuda":
        raise ValueError(f"lane_scan_masked: unsupported device {qb.device}")
    from scintirete_tpu_torch.ops._ext import check_tensor, kernel

    check_tensor(invalid, "invalid", torch.float32, (N,), qb.device)
    (d1, i1, d2, i2), qb, base, aligned = _checked_lane_arrays(
        qb, self_idx, base, base_sq, metric, grid_tiles
    )
    err = kernel("lane_scan_masked")(
        qb.data_ptr(), self_idx.data_ptr(), base.data_ptr(),
        base_sq.data_ptr(), invalid.data_ptr(), d1.data_ptr(), i1.data_ptr(),
        d2.data_ptr(), i2.data_ptr(), B, qb.shape[1], N, grid_tiles, metric,
        int(aligned), torch.cuda.current_stream(qb.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"knn_lane_topc_masked launch failed: cudaError {err}"
        )
    lane_scan_masked.launches += 1
    return d1, i1, d2, i2


lane_scan_masked.launches = 0


def _top_c(lanes, queries, metric: int, c: int, q_sq):
    """Exact top-c of the 2 * LANES lane winners, finalized: the Pallas
    wrappers' tail. Returns (cd [B, c] f32 asc, ci [B, c] i32)."""
    d1, i1, d2, i2 = lanes
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


def knn_lane_topc(queries, self_idx, base, base_sq, n_valid: int,
                  metric: int, c: int, grid_tiles: int, q_sq=None):
    """Top-c prefix neighbors of each query row over the first
    grid_tiles * LANES base rows, self-excluded, with TRUE finalized
    distances. Returns (cd [B, c] f32 asc, ci [B, c] i32), -1/inf padded.

    queries [B, D] f32 or bf16 scan-form rows (normalized for cosine);
    q_sq [B] f32: the true squared norms for the L2 finalization."""
    qb = queries.float().to(torch.bfloat16).contiguous()
    lanes = lane_scan(
        qb, self_idx.to(torch.int32).contiguous(), base, base_sq, n_valid,
        metric, grid_tiles,
    )
    return _top_c(lanes, queries, metric, c, q_sq)


def knn_lane_topc_masked(queries, self_idx, base, base_sq, invalid,
                         metric: int, c: int, grid_tiles: int, q_sq=None):
    """Masked-subset variant of `knn_lane_topc`: top-c over the base rows
    of the first grid_tiles tiles whose invalid mask is <= 0.5,
    self-excluded, TRUE finalized distances. One cached base serves layer
    0 and every upper layer of an append (mask = non-member | deleted |
    padding). Returns (cd [B, c] f32 asc, ci [B, c] i32), -1/inf padded."""
    qb = queries.float().to(torch.bfloat16).contiguous()
    lanes = lane_scan_masked(
        qb, self_idx.to(torch.int32).contiguous(), base, base_sq,
        invalid.float().contiguous(), metric, grid_tiles,
    )
    return _top_c(lanes, queries, metric, c, q_sq)
