"""Whole-corpus lane scans of the flat index: score + per-lane best-two.

Ports of the flat half of `scintirete_tpu/ops/pallas_scan.py`:
`lane_topk_scan_packed_int8`, `lane_topk_scan_packed`,
`lane_topk_scan_int8`, `lane_topk_scan`, with `quantize_rows`,
`unpack_lane_keys` and the packing helpers.

Lane j keeps the two least ranking scores among base rows {j, j + LANES,
j + 2 LANES, ...}, folded in tile order. Scores are RANKING form (L2
b^2 - 2 dot, cosine/IP -dot; the int8 scans dequantize the exact s8 x s8
-> s32 product with per-row scales); the caller reranks the 2 * LANES
winners in exact f32 (`ops/flat_scan.py::flat_topk_fused`).

The packed scans carry the tile id in the low `_TILE_BITS` mantissa bits
of each f32 score, so the fold is three min/max operations on one array
pair:

    key = f32(score) with the low 13 mantissa bits = tile index
    k1  = min(k1, key);  k2 = min(k2, max(k1_old, key))

The order of f32 values survives the replaced bits for either sign (they
move a value by at most 2^-10 relative), and the winner's row is read back
from its own bit pattern. A packed key must never be NaN: an inf or NaN
score ORed with tile bits would be a NaN key, and a NaN latches (JAX) or
vanishes from (CUDA `fminf`) its lane for the rest of the scan. So the
bf16 scan clamps every score into the finite band +-_SENTINEL before it
packs, and the int8 scan's wrapper clamps scales and norms on the [N]- and
[B]-sized arrays so every score the scan forms is finite by construction.

Each wrapper launches its CUDA kernel (`csrc/flat_scan.cu`;
`lane_topk_scan` the third entry point of `csrc/lane_scan.cu`) on CUDA
tensors, and its plain version (`*_plain`, the Pallas body repeated tile by
tile) on CPU tensors. The kernels take any B.
"""

from __future__ import annotations

import torch

from scintirete_tpu_torch.ops.lane_scan import LANES, _fold_best_two
from scintirete_tpu_torch.types import DistanceMetric

_L2 = int(DistanceMetric.L2)
_COSINE = int(DistanceMetric.COSINE)
_IP = int(DistanceMetric.INNER_PRODUCT)

_TILE_BITS = 13  # 2^13 tiles = 8M rows at LANES = 1024
_TILE_MASK = (1 << _TILE_BITS) - 1
_SENTINEL = 3.0e38  # "no candidate"; stays finite with tile bits in it
# int8 packed scan: tiles pre-reduced per pack + fold
_PREMIN = 4
# Per-row and per-query dequantization scales are clamped here so the int8
# score cannot overflow f32 even at the joint worst case:
# |2 dots (qs bs)| <= 2 * 127 * 127 * D * _SCALE_CAP^2 = 6.6e37 for
# D <= 8192, and |bsq| <= _BSQ_CAP, so |s| <= 1.4e38 < f32 max. Rows with
# a larger true scale lose first-pass ranking fidelity only; the exact f32
# rerank still returns exact distances.
_SCALE_CAP = 5.0e14
_BSQ_CAP = 7.0e37
_MAX_D_INT8 = 8192  # the clamp above is sized for this depth


def quantize_rows(v: torch.Tensor):
    """Per-row symmetric int8: (q8 [N, D] i8, scale [N] f32) with
    v ~= q8 * scale[:, None]. Zero rows quantize to zeros with scale 0.
    Rounds half to even, as numpy and JAX do."""
    amax = v.abs().amax(dim=-1, keepdim=True)
    scale = amax / 127.0
    q = torch.where(
        scale > 0.0, torch.round(v / torch.clamp(scale, min=1e-30)), 0.0
    )
    return q.clamp(-127, 127).to(torch.int8), scale[..., 0].float()


def _pack_tile(s, tile: int):
    """Clamp scores into the finite band (NaN ranks last) and replace
    their low mantissa bits with the tile id."""
    s = torch.clamp(s, -_SENTINEL, _SENTINEL)
    s = torch.where(s != s, _SENTINEL, s)
    return _pack_tile_ids(s, tile)


def _pack_tile_ids(s, ids):
    """Replace the low mantissa bits of FINITE scores with tile ids (an
    int or an i32 tensor). No clamp: the caller guarantees finiteness."""
    bits = s.contiguous().view(torch.int32)
    bits = (bits & ~_TILE_MASK) | ids
    return bits.view(torch.float32)


def unpack_lane_keys(keys, lanes: int = LANES):
    """[B, 2 * lanes] packed keys -> (scores f32, rows i32, valid bool).
    Row = embedded tile index * lanes + lane position; the scores keep
    their replaced low bits (callers rerank in exact f32)."""
    bits = keys.contiguous().view(torch.int32)
    tile = bits & _TILE_MASK
    lane = torch.arange(
        keys.shape[1], dtype=torch.int32, device=keys.device
    ) % lanes
    rows = tile * lanes + lane[None, :]
    valid = keys < (_SENTINEL * 0.5)
    return keys, torch.where(valid, rows, -1), valid


def _fold_best_two_packed(key, k1, k2):
    return torch.minimum(k1, key), torch.minimum(k2, torch.maximum(k1, key))


def _int_dots(q8, tile8):
    """Exact s8 x s8 -> s32 product, rounded to f32 as an int32 -> f32
    conversion rounds (nearest even). CUDA has no integer matmul and an
    f32 matmul of int8 values is exact only up to D = 1040 (127 * 127 * D
    < 2^24), so the product runs in float64, which holds every sum up to
    D = 8192 and far beyond exactly, on either device."""
    return (q8.double() @ tile8.double().T).float()


# ---------------------------------------------------------------------------
# plain versions: the Pallas bodies, one tile of LANES base rows per step
# ---------------------------------------------------------------------------


def lane_topk_scan_plain(qb, base, base_sq, invalid, metric: int):
    """Plain version of `lane_topk_scan`'s lane arrays: (d [B, 2 LANES],
    i [B, 2 LANES]) with +inf / -1 in empty places."""
    B = qb.shape[0]
    N = base.shape[0]
    dev = qb.device
    q32 = qb.float()
    d1 = torch.full((B, LANES), torch.inf, device=dev)
    d2 = torch.full((B, LANES), torch.inf, device=dev)
    i1 = torch.full((B, LANES), -1, dtype=torch.int32, device=dev)
    i2 = torch.full((B, LANES), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(LANES, dtype=torch.int32, device=dev)
    for t in range(N // LANES):
        rows = slice(t * LANES, (t + 1) * LANES)
        dots = q32 @ base[rows].float().T  # bf16 products are exact in f32
        if metric == _L2:
            s = base_sq[None, rows] - 2.0 * dots
        else:
            s = -dots
        s = torch.where(invalid[None, rows] > 0.5, torch.inf, s)
        si = (lane + t * LANES)[None, :].expand(B, LANES)
        d1, i1, d2, i2 = _fold_best_two(s, si, d1, i1, d2, i2)
    return torch.cat([d1, d2], dim=1), torch.cat([i1, i2], dim=1)


def lane_topk_scan_int8_plain(q8, q_scale, base8, base_scale, base_sq,
                              invalid, metric: int):
    """Plain version of `lane_topk_scan_int8`'s lane arrays."""
    B = q8.shape[0]
    N = base8.shape[0]
    dev = q8.device
    qs = q_scale[:, None]
    d1 = torch.full((B, LANES), torch.inf, device=dev)
    d2 = torch.full((B, LANES), torch.inf, device=dev)
    i1 = torch.full((B, LANES), -1, dtype=torch.int32, device=dev)
    i2 = torch.full((B, LANES), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(LANES, dtype=torch.int32, device=dev)
    for t in range(N // LANES):
        rows = slice(t * LANES, (t + 1) * LANES)
        dots = _int_dots(q8, base8[rows])
        if metric == _L2:
            s = base_sq[None, rows] - 2.0 * dots * (qs * base_scale[None, rows])
        else:
            s = -dots * base_scale[None, rows]
        s = torch.where(invalid[None, rows] > 0.5, torch.inf, s)
        si = (lane + t * LANES)[None, :].expand(B, LANES)
        d1, i1, d2, i2 = _fold_best_two(s, si, d1, i1, d2, i2)
    return torch.cat([d1, d2], dim=1), torch.cat([i1, i2], dim=1)


def lane_topk_scan_packed_plain(qb, base, base_sq, invalid, metric: int):
    """Plain version of the packed bf16 scan: keys [B, 2 LANES] f32."""
    B = qb.shape[0]
    N = base.shape[0]
    dev = qb.device
    q32 = qb.float()
    k1 = torch.full((B, LANES), _SENTINEL, device=dev)
    k2 = torch.full((B, LANES), _SENTINEL, device=dev)
    for t in range(N // LANES):
        rows = slice(t * LANES, (t + 1) * LANES)
        dots = q32 @ base[rows].float().T
        if metric == _L2:
            s = base_sq[None, rows] - 2.0 * dots
        else:
            s = -dots
        s = torch.where(invalid[None, rows] > 0.5, _SENTINEL, s)
        k1, k2 = _fold_best_two_packed(_pack_tile(s, t), k1, k2)
    return torch.cat([k1, k2], dim=1)


def lane_topk_scan_packed_int8_plain(q8, qs2, base8, bs, bsq, metric: int,
                                     group: int):
    """Plain version of the packed int8 scan: keys [B, 2 LANES] f32.
    `bs` / `bsq` carry the masking (0 / _SENTINEL on invalid rows) and the
    clamps; `group` tiles are pre-reduced (strict <, the earlier tile wins
    a tie) before one pack and one fold."""
    B = q8.shape[0]
    N = base8.shape[0]
    dev = q8.device
    k1 = torch.full((B, LANES), _SENTINEL, device=dev)
    k2 = torch.full((B, LANES), _SENTINEL, device=dev)
    m = mi = None
    for t in range(N // LANES):
        rows = slice(t * LANES, (t + 1) * LANES)
        dots = _int_dots(q8, base8[rows])
        if metric == _L2:
            s = bsq[None, rows] - dots * (qs2[:, None] * bs[None, rows])
        else:
            s = bsq[None, rows] - dots * bs[None, rows]
        if t % group == 0:
            m = s
            mi = torch.full((B, LANES), t, dtype=torch.int32, device=dev)
        else:
            mi = torch.where(s < m, t, mi)
            m = torch.minimum(s, m)
        if t % group == group - 1:
            k1, k2 = _fold_best_two_packed(_pack_tile_ids(m, mi), k1, k2)
    return torch.cat([k1, k2], dim=1)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_scan_shape(name: str, N: int, tps: int = 1) -> None:
    if tps < 1 or N % (tps * LANES):
        raise ValueError(
            f"{name}: N={N} must be a multiple of tps * {LANES} (tps={tps})"
        )


def _check_packed_shape(name: str, N: int, tps: int) -> None:
    _check_scan_shape(name, N, tps)
    if N // LANES > (1 << _TILE_BITS):
        raise ValueError(
            f"{name}: {N // LANES} tiles do not fit the {_TILE_BITS} "
            f"tile-id bits of a packed key (at most {LANES << _TILE_BITS} rows)"
        )


def _check_rows(name: str, N: int, **arrays) -> None:
    """The per-row arrays hold one value for each of the base's N rows."""
    for label, t in arrays.items():
        if tuple(t.shape) != (N,):
            raise ValueError(
                f"{name}: {label} must have shape ({N},), got {tuple(t.shape)}"
            )


def _check_metric(metric: int) -> None:
    if metric not in (_L2, _COSINE, _IP):
        raise ValueError(f"unsupported metric code: {metric}")


def _launch_flat(entry: str, name: str, q, q_scale, base, base_scale,
                 base_sq, invalid, metric: int, group: int, align: int):
    """Check the CUDA inputs, launch one `csrc/flat_scan.cu` entry and
    return its two [B, 2 LANES] outputs (f32, i32). Optional inputs the
    entry does not read are None."""
    from scintirete_tpu_torch.ops._ext import check_tensor, kernel

    B, D = q.shape
    N = base.shape[0]
    dev = q.device
    _check_metric(metric)
    check_tensor(base, "base", q.dtype, (N, D), dev)
    if not q.is_contiguous():
        raise ValueError("queries must be contiguous")
    for t, tname, shape in (
        (q_scale, "query scale", (B,)), (base_scale, "base_scale", (N,)),
        (base_sq, "base_sq", (N,)), (invalid, "invalid", (N,)),
    ):
        if t is not None:
            check_tensor(t, tname, torch.float32, shape, dev)
    out_f = torch.empty((B, 2 * LANES), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, 2 * LANES), dtype=torch.int32, device=dev)
    aligned = D % align == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, base)
    )

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = kernel(entry)(
        q.data_ptr(), ptr(q_scale), base.data_ptr(), ptr(base_scale),
        base_sq.data_ptr(), ptr(invalid), out_f.data_ptr(),
        out_i.data_ptr(), B, D, N, N // LANES, group, metric, int(aligned),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out_f, out_i


def _device_kind(t, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def lane_topk_scan_packed(queries, base, base_sq, invalid, metric: int,
                          tps: int = 1):
    """Packed bf16 lane scan. queries [B, D] f32 (pre-normalized for
    cosine), base [N, D] bf16 with N % (tps * LANES) == 0, base_sq [N] f32,
    invalid [N] f32 (> 0.5 = deleted or empty slot). Returns (keys
    [B, 2 LANES] f32 ranking form with embedded tile ids, rows
    [B, 2 LANES] i32, -1 = empty). `tps` (tiles per step of the TPU grid)
    does not change the result."""
    name = "lane_topk_scan_packed"
    N = base.shape[0]
    _check_packed_shape(name, N, tps)
    _check_rows(name, N, base_sq=base_sq, invalid=invalid)
    qb = queries.float().to(torch.bfloat16).contiguous()
    if _device_kind(qb, name) == "cpu":
        keys = lane_topk_scan_packed_plain(qb, base, base_sq, invalid, metric)
        return keys, unpack_lane_keys(keys)[1]
    keys, rows = _launch_flat(
        "flat_packed_bf16", name, qb, None, base, None, base_sq, invalid,
        metric, 1, 8,
    )
    lane_topk_scan_packed.launches += 1
    return keys, rows


lane_topk_scan_packed.launches = 0


def packed_int8_inputs(queries, base_scale, base_sq, invalid, metric: int):
    """The packed int8 scan's finiteness and masking invariants, set on
    the [N]- and [B]-sized arrays: scales clamped to [0, _SCALE_CAP] with
    NaN -> 0; norms clamped to +-_BSQ_CAP (L2) or zero (cosine, IP);
    invalid rows get bs = 0 (kills the dot term whatever the int8 bits
    are) and bsq = _SENTINEL, so their score is exactly the "no candidate"
    sentinel with no per-score mask. Returns (q8, qs2, bs, bsq); qs2 is
    twice the clamped query scale (the L2 factor folded in)."""
    q8, q_scale = quantize_rows(queries.float())
    bad = invalid > 0.5
    bs = torch.nan_to_num(base_scale, nan=0.0, posinf=_SCALE_CAP, neginf=0.0)
    bs = torch.where(bad, 0.0, torch.clamp(bs, 0.0, _SCALE_CAP))
    if metric == _L2:
        bsq = torch.nan_to_num(base_sq, nan=_BSQ_CAP, posinf=_BSQ_CAP)
        bsq = torch.clamp(bsq, -_BSQ_CAP, _BSQ_CAP)
    else:
        bsq = torch.zeros_like(base_sq)
    bsq = torch.where(bad, _SENTINEL, bsq)
    qs2 = 2.0 * torch.clamp(
        torch.nan_to_num(q_scale, nan=0.0, posinf=_SCALE_CAP, neginf=0.0),
        0.0, _SCALE_CAP,
    )
    return q8.contiguous(), qs2, bs, bsq


def lane_topk_scan_packed_int8(queries, base8, base_scale, base_sq, invalid,
                               metric: int, tps: int = 1):
    """Packed int8 lane scan. queries [B, D] f32 (quantized per row here),
    base8 [N, D] i8 per-row quantized, base_scale / base_sq / invalid [N]
    f32. Groups of g = min(_PREMIN, tps) tiles, aligned at multiples of g
    from tile 0, are pre-reduced before one pack and fold, so `tps`
    changes which candidates survive. Returns (keys, rows) as
    `lane_topk_scan_packed`."""
    name = "lane_topk_scan_packed_int8"
    N, D = base8.shape
    _check_packed_shape(name, N, tps)
    if D > _MAX_D_INT8:
        raise ValueError(f"{name}: the overflow clamp is sized for D <= 8192")
    _check_metric(metric)
    _check_rows(name, N, base_scale=base_scale, base_sq=base_sq,
                invalid=invalid)
    group = min(_PREMIN, tps)
    if tps % group:
        raise ValueError(
            f"{name}: tps={tps} is not a whole number of {group}-tile groups"
        )
    q8, qs2, bs, bsq = packed_int8_inputs(
        queries, base_scale, base_sq, invalid, metric
    )
    if _device_kind(q8, name) == "cpu":
        keys = lane_topk_scan_packed_int8_plain(
            q8, qs2, base8, bs, bsq, metric, group
        )
        return keys, unpack_lane_keys(keys)[1]
    keys, rows = _launch_flat(
        "flat_packed_int8", name, q8, qs2, base8, bs, bsq, None, metric,
        group, 16,
    )
    lane_topk_scan_packed_int8.launches += 1
    return keys, rows


lane_topk_scan_packed_int8.launches = 0


def lane_topk_scan_int8(queries, base8, base_scale, base_sq, invalid,
                        metric: int):
    """Unpacked int8 lane scan: (d [B, 2 LANES] f32 ranking form, rows
    [B, 2 LANES] i32, -1 / +inf = empty). Inputs as
    `lane_topk_scan_packed_int8`; N % LANES == 0."""
    name = "lane_topk_scan_int8"
    N = base8.shape[0]
    _check_scan_shape(name, N)
    _check_rows(name, N, base_scale=base_scale, base_sq=base_sq,
                invalid=invalid)
    q8, q_scale = quantize_rows(queries.float())
    q8 = q8.contiguous()
    if _device_kind(q8, name) == "cpu":
        return lane_topk_scan_int8_plain(
            q8, q_scale, base8, base_scale, base_sq, invalid, metric
        )
    d, i = _launch_flat(
        "flat_lane_int8", name, q8, q_scale, base8, base_scale, base_sq,
        invalid, metric, 1, 16,
    )
    lane_topk_scan_int8.launches += 1
    return d, i


lane_topk_scan_int8.launches = 0


def lane_topk_scan(queries, base, base_sq, invalid, metric: int):
    """Unpacked bf16 lane scan: (scores [B, 2 LANES] ranking form, rows
    [B, 2 LANES] i32, -1 / +inf = empty). queries [B, D] f32, base [N, D]
    bf16 with N % LANES == 0, base_sq / invalid [N] f32."""
    name = "lane_topk_scan"
    N = base.shape[0]
    _check_scan_shape(name, N)
    _check_rows(name, N, base_sq=base_sq, invalid=invalid)
    qb = queries.float().to(torch.bfloat16).contiguous()
    if _device_kind(qb, name) == "cpu":
        return lane_topk_scan_plain(qb, base, base_sq, invalid, metric)
    d, i = _launch_flat(
        "lane_topk_scan", name, qb, None, base, None, base_sq, invalid,
        metric, 1, 8,
    )
    lane_topk_scan.launches += 1
    return d, i


lane_topk_scan.launches = 0
