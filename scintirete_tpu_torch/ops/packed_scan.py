"""Whole-corpus lane scans of the flat index: score + per-lane best-two.

Ports of the flat half of `scintirete_tpu/ops/pallas_scan.py`:
`lane_topk_scan_packed_int8`, `lane_topk_scan_packed`,
`lane_topk_scan_int8`, `lane_topk_scan`, with `quantize_rows`,
`unpack_lane_keys` and the packing helpers (and `packed_bf16_sum_bound`,
how far two bf16 scans that sum in different orders may part).

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

All four kernels run on the tensor cores with operands fed by TMA,
which wants rows of whole 16-byte units (`lane_scan.scan_width`: D a
multiple of 8 in bf16, of 16 in int8): callers that keep a scan copy make
it that wide (`index/flat.py`), and the wrappers pad any other input with
zero columns, which change no dot, no norm and no int8 scale. The packed
scans' tile walk may be split into slices that run side by side and merge
(see `_slices`): packed keys never tie, so the merge gives the same bits.
The unpacked scans break ties by tile order and walk in one piece.
"""

from __future__ import annotations

import torch

from scintirete_tpu_torch.ops.lane_scan import (
    LANES,
    MAX_TILES,
    _fold_best_two,
    tma_rows,
)
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
    # divided by a tensor, not a Python number: on CUDA ATen multiplies by
    # the rounded reciprocal of a scalar divisor, one unit off the true
    # quotient that numpy, JAX and the card's int8 scan entry take
    scale = amax / torch.full((), 127.0, device=amax.device)
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


def packed_key_scores(keys):
    """Packed keys with their tile ids cleared: the truncated scores."""
    bits = keys.contiguous().view(torch.int32)
    return (bits & ~_TILE_MASK).view(torch.float32)


def packed_bf16_sum_bound(rows, other_keys, qb, base, base_sq,
                          metric: int):
    """How far the scores of two packed bf16 scans of the same inputs may
    part when each sums its dots in f32 in its own order (a tensor-core
    product against torch.matmul): [B, 2 LANES] f32, per key. `rows` are
    one scan's rows, `other_keys` the other scan's keys.

    A score is a sum of n exact f32 terms (a product of two bf16 values is
    exact in f32): -q_k b_k for cosine and IP (n = D), base_sq and
    -2 q_k b_k for L2 (n = D + 1). In any order an f32 sum lies within
    gamma_n M of the exact sum (gamma_n = n u / (1 - n u), u = 2^-24, M
    the sum of the terms' magnitudes), so a row's two scores part by at
    most 2 gamma_n M, and a lane's least (and second least) scores by at
    most the largest such bound over the rows either scan picked for it.
    Packing truncates the last 13 bits on top of this (one kept unit)."""
    B, D = qb.shape
    picked = torch.cat([rows, unpack_lane_keys(other_keys)[1]], dim=1).long()
    qa = qb.float().abs()
    mag = torch.empty(picked.shape, device=qb.device)
    step = max(1, (1 << 24) // (picked.shape[1] * D))
    for s in range(0, B, step):
        r = picked[s : s + step].clamp_min(0)
        mag[s : s + step] = (
            qa[s : s + step, None, :] * base[r, :D].float().abs()
        ).sum(-1)
    n = D
    if metric == _L2:
        n = D + 1
        mag = 2.0 * mag + base_sq.abs()[picked.clamp_min(0)]
    mag = torch.where(picked >= 0, mag, 0.0)
    u = 2.0**-24
    gamma = n * u / (1.0 - n * u)
    lane = 2.0 * gamma * mag.view(B, 4, LANES).amax(1)
    return lane.repeat(1, 2)


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


_SLICE_MAX = 16


def _slices(B: int, groups: int, sms: int) -> int:
    """How many slices to split a packed scan's walk of `groups` tile
    groups into. A launch is ceil(B / 128) query tiles x 16 lane ranges of
    blocks, one block per SM at a time; S slices make S times the blocks,
    each 1/S of the walk, so the launch takes about ceil(blocks S / sms) / S
    walks. Take the least S with the least such time, and a larger S only
    where it saves a tenth (each slice adds a pipeline fill and a merge)."""
    blocks = -(-B // 128) * (LANES // 64)
    best, best_t = 1, -(-blocks // sms)
    for s in range(2, min(groups, _SLICE_MAX) + 1):
        t = -(-blocks * s // sms) / s
        if t < 0.9 * best_t:
            best, best_t = s, t
    return best


def _check_inputs(q, base, base_dtype=None, **arrays) -> None:
    """A scan's CUDA inputs: contiguous queries, a base of their width and
    of their type (or `base_dtype`), and f32 [N] or [B] arrays (None where
    not read), all on the queries' device."""
    from scintirete_tpu_torch.ops._ext import check_tensor

    B, D = q.shape
    N = base.shape[0]
    check_tensor(base, "base", base_dtype or q.dtype, (N, D), q.device)
    if not q.is_contiguous():
        raise ValueError("queries must be contiguous")
    for label, t in arrays.items():
        if t is not None:
            shape = (B,) if label.startswith("query") else (N,)
            check_tensor(t, label, torch.float32, shape, q.device)


def _launch_packed(entry: str, name: str, lead, B: int, N: int, tail,
                   group: int, metric: int, dev, split: bool = True):
    """Launch a flat scan entry of the packed argument list, `lead`
    (pointers) first and `tail` (sizes) after the outputs, with its walk
    split into slices and their workspace where `split`; returns the two
    [B, 2 LANES] outputs (f32, i32)."""
    from scintirete_tpu_torch.ops._ext import kernel

    _check_metric(metric)
    tiles = N // LANES
    slices = 1
    if split:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        slices = _slices(B, tiles // group, sms)
    ws = None
    if slices > 1:
        ws = torch.empty((slices, B, 2 * LANES), dtype=torch.float32,
                         device=dev)
    out_f = torch.empty((B, 2 * LANES), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, 2 * LANES), dtype=torch.int32, device=dev)
    err = kernel(entry)(
        *lead, out_f.data_ptr(), out_i.data_ptr(),
        None if ws is None else ws.data_ptr(), *tail, N, tiles, group,
        slices, metric, torch.cuda.current_stream(dev).cuda_stream,
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
    _check_inputs(qb, base, base_sq=base_sq, invalid=invalid)
    # TMA rows of whole 16-byte units; the column arrays are bulk-copied
    # 64 rows (256 bytes) at a time
    qb, base = tma_rows(qb), tma_rows(base)
    base_sq, invalid = (
        t if t.data_ptr() % 16 == 0 else t.clone() for t in (base_sq, invalid)
    )
    keys, rows = _launch_packed(
        "flat_packed_bf16", name,
        (qb.data_ptr(), base.data_ptr(), base_sq.data_ptr(),
         invalid.data_ptr()),
        qb.shape[0], N, (qb.shape[0], qb.shape[1]), 1, metric, qb.device,
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
    twice the clamped query scale (the L2 factor folded in). On the card
    the scan's C entry makes the same arrays itself, op for op, in two
    launches (`csrc/flat_scan.cu` `prep_queries_int8`,
    `prep_columns_int8`)."""
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


def _launch_int8(entry: str, name: str, queries, base8, base_scale,
                 base_sq, invalid, group: int, metric: int, split: bool):
    """Launch an int8 scan entry on the caller's arrays. The entry makes
    the scan's inputs itself (the query quantization and the [N] column
    terms; two launches in place of ~20 small torch ops) into scratch
    allocated here."""
    q = queries.float().contiguous()
    _check_inputs(q, base8, torch.int8, base_scale=base_scale,
                  base_sq=base_sq, invalid=invalid)
    base8 = tma_rows(base8)
    (B, D), (N, Dp) = q.shape, base8.shape
    q8 = torch.empty((B, Dp), dtype=torch.int8, device=q.device)
    qs = torch.empty(B, dtype=torch.float32, device=q.device)
    cols = torch.empty((2, N), dtype=torch.float32, device=q.device)
    return _launch_packed(
        entry, name,
        tuple(t.data_ptr() for t in (q, base8, base_scale, base_sq, invalid,
                                     q8, qs, cols)),
        B, N, (B, D, Dp), group, metric, q.device, split=split,
    )


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
    if _device_kind(queries, name) == "cpu":
        q8, qs2, bs, bsq = packed_int8_inputs(
            queries, base_scale, base_sq, invalid, metric
        )
        keys = lane_topk_scan_packed_int8_plain(
            q8, qs2, base8, bs, bsq, metric, group
        )
        return keys, unpack_lane_keys(keys)[1]
    keys, rows = _launch_int8(
        "flat_packed_int8", name, queries, base8, base_scale, base_sq,
        invalid, group, metric, split=True,
    )
    lane_topk_scan_packed_int8.launches += 1
    return keys, rows


lane_topk_scan_packed_int8.launches = 0


def lane_topk_scan_int8(queries, base8, base_scale, base_sq, invalid,
                        metric: int):
    """Unpacked int8 lane scan: (d [B, 2 LANES] f32 ranking form, rows
    [B, 2 LANES] i32, -1 / +inf = empty). Inputs as
    `lane_topk_scan_packed_int8`; N % LANES == 0. Scales and norms are
    used as they are (no clamp). On the card the walk is never split (the
    fold breaks ties by tile order) and its tile ids are 16 bits wide, so
    one call takes at most MAX_TILES tiles."""
    name = "lane_topk_scan_int8"
    N = base8.shape[0]
    _check_scan_shape(name, N)
    _check_metric(metric)
    _check_rows(name, N, base_scale=base_scale, base_sq=base_sq,
                invalid=invalid)
    if _device_kind(queries, name) == "cpu":
        q8, q_scale = quantize_rows(queries.float())
        return lane_topk_scan_int8_plain(
            q8.contiguous(), q_scale, base8, base_scale, base_sq, invalid,
            metric,
        )
    if N // LANES > MAX_TILES:
        raise ValueError(f"{name}: more than {MAX_TILES} tiles of {LANES} rows")
    d, i = _launch_int8(
        "flat_lane_int8", name, queries, base8, base_scale, base_sq, invalid,
        1, metric, split=False,
    )
    lane_topk_scan_int8.launches += 1
    return d, i


lane_topk_scan_int8.launches = 0


def lane_topk_scan(queries, base, base_sq, invalid, metric: int):
    """Unpacked bf16 lane scan: (scores [B, 2 LANES] ranking form, rows
    [B, 2 LANES] i32, -1 / +inf = empty). queries [B, D] f32, base [N, D]
    bf16 with N % LANES == 0, base_sq / invalid [N] f32. On the card the
    kernel is the graph-build scans' (`lane_scan.tma_rows` pads a D that is not
    a multiple of 8)."""
    name = "lane_topk_scan"
    N = base.shape[0]
    _check_scan_shape(name, N)
    _check_rows(name, N, base_sq=base_sq, invalid=invalid)
    qb = queries.float().to(torch.bfloat16).contiguous()
    if _device_kind(qb, name) == "cpu":
        return lane_topk_scan_plain(qb, base, base_sq, invalid, metric)
    if N // LANES > MAX_TILES:
        raise ValueError(f"{name}: more than {MAX_TILES} tiles of {LANES} rows")
    _check_metric(metric)
    _check_inputs(qb, base, base_sq=base_sq, invalid=invalid)
    from scintirete_tpu_torch.ops._ext import kernel

    qb, base = tma_rows(qb), tma_rows(base)
    B, D = qb.shape
    d = torch.empty((B, 2 * LANES), dtype=torch.float32, device=qb.device)
    i = torch.empty((B, 2 * LANES), dtype=torch.int32, device=qb.device)
    err = kernel("lane_topk_scan")(
        qb.data_ptr(), base.data_ptr(), base_sq.data_ptr(),
        invalid.data_ptr(), d.data_ptr(), i.data_ptr(), B, D, N, N // LANES,
        metric, 1, torch.cuda.current_stream(qb.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    lane_topk_scan.launches += 1
    return d, i


lane_topk_scan.launches = 0
