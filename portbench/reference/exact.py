"""Exact distances and exact top-k in plain PyTorch.

Distances are in the finalized form the service returns (Scintirete's
convention): L2 is the square root of the summed squared differences,
cosine is 1 - clamp(q.x / (|q| |x|), -1, 1) with a zero vector at 1, inner
product is -q.x. Pair distances are computed elementwise from the
differences or products (no expanded form, no cancellation); the exact
top-k ranks by one matrix product per block.

`precision` is "f32" (float32, TF32 off: the reference) or "tf32" (every
operand rounded to TF32's 10-bit mantissa first, products summed in
float32, as a TF32 matrix product reads them: the control one step below
the configuration's float32). The rounding is explicit, so both precisions
give the same numbers on the CPU and on the card.
"""

from __future__ import annotations

import torch

METRICS = ("l2", "cosine", "ip")
_EPS = 1e-30


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to the nearest TF32 value (10 mantissa bits,
    ties to even), kept in float32."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    bits = torch.where(bits >= (1 << 31), bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def in_precision(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return x.float()
    if precision == "tf32":
        return round_tf32(x.float())
    raise ValueError(f"unknown precision {precision!r}")


def pair_distances(q: torch.Tensor, x: torch.Tensor, metric: str,
                   precision: str = "f32") -> torch.Tensor:
    """Distances of q [M, D] to x [M, k, D] -> [M, k]."""
    q = in_precision(q, precision)[:, None, :]
    x = in_precision(x, precision)
    if metric == "l2":
        return torch.sqrt(((q - x) ** 2).sum(-1))
    dots = (q * x).sum(-1)
    if metric == "ip":
        return -dots
    if metric == "cosine":
        qn = torch.sqrt((q * q).sum(-1))
        xn = torch.sqrt((x * x).sum(-1))
        denom = qn * xn
        cos = torch.clamp(dots / torch.clamp(denom, min=_EPS), -1.0, 1.0)
        return torch.where(denom > _EPS, 1.0 - cos, torch.ones_like(cos))
    raise ValueError(f"unknown metric {metric!r}")


def _rank_form(q, x, metric: str):
    """Block of ranking scores [Bq, Bn] (lower is nearer)."""
    dots = q @ x.T
    if metric == "l2":
        return (x * x).sum(-1)[None, :] - 2.0 * dots
    if metric == "ip":
        return -dots
    xn = torch.sqrt((x * x).sum(-1)).clamp(min=_EPS)
    qn = torch.sqrt((q * q).sum(-1)).clamp(min=_EPS)
    return -(dots / xn[None, :]) / qn[:, None]


def exact_topk(queries: torch.Tensor, base: torch.Tensor, metric: str, k: int,
               precision: str = "f32", block_q: int = 1024,
               block_n: int = 1 << 18) -> torch.Tensor:
    """Rows [Q, k] of the k nearest base rows of each query, nearest
    first. `queries` and `base` live on the device the work runs on."""
    no_tf32()
    out = []
    for qs in range(0, len(queries), block_q):
        q = in_precision(queries[qs:qs + block_q], precision)
        best_s = torch.full((len(q), 0), float("inf"), device=q.device)
        best_i = torch.zeros((len(q), 0), dtype=torch.int64, device=q.device)
        for ns in range(0, len(base), block_n):
            x = in_precision(base[ns:ns + block_n], precision)
            s = _rank_form(q, x, metric)
            kk = min(k, s.shape[1])
            bs, bi = torch.topk(s, kk, dim=1, largest=False)
            best_s = torch.cat([best_s, bs], 1)
            best_i = torch.cat([best_i, bi + ns], 1)
            keep = torch.topk(best_s, min(k, best_s.shape[1]), dim=1,
                              largest=False).indices
            best_s, best_i = best_s.gather(1, keep), best_i.gather(1, keep)
        out.append(best_i)
    return torch.cat(out) if out else torch.zeros((0, k), dtype=torch.int64)


def answer_distances(queries: torch.Tensor, rows: torch.Tensor,
                     table: torch.Tensor, metric: str, precision: str = "f32",
                     block: int = 1 << 14) -> torch.Tensor:
    """Distances of queries [M, D] to table[rows] for rows [M, k] (a row
    < 0 gives +inf), in blocks of `block` answers."""
    no_tf32()
    out = []
    for s in range(0, len(queries), block):
        r = rows[s:s + block]
        x = table[r.clamp(min=0)]
        d = pair_distances(queries[s:s + block], x, metric, precision)
        out.append(torch.where(r >= 0, d, torch.full_like(d, float("inf"))))
    return torch.cat(out) if out else torch.zeros(rows.shape)
