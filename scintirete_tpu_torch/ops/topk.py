"""Exact brute-force top-k scan (port of `scintirete_tpu/ops/topk.py`).

The recall oracle for HNSW tests and for the chip check. The base streams
through [B, tile] distance blocks with a running top-k merged per tile, so
peak memory is O(B * (tile + k)). Ties go to the lower index, as
`lax.top_k` breaks them: every selection is a stable ascending sort.
"""

from __future__ import annotations

import torch

from scintirete_tpu_torch.ops.distance import pairwise_distance, preprocess_norms

_DEFAULT_TILE = 65536


def stable_smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k(-d, k)` along dim 1: the k least values and their
    positions, ties to the lower position (torch.topk promises no tie
    order, a stable ascending sort does)."""
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def brute_force_topk(
    queries: torch.Tensor,  # [B, D]
    base: torch.Tensor,  # [N, D]
    valid: torch.Tensor,  # [N] bool — False for empty/deleted slots
    metric: int,
    k: int,
    base_sq_norms: torch.Tensor | None = None,
    tile: int = _DEFAULT_TILE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (distances [B, k] f32 asc, slot indices [B, k] i32).

    Invalid slots surface as +inf distance with index -1."""
    B = queries.shape[0]
    N = base.shape[0]
    dev = queries.device
    if base_sq_norms is None:
        base_sq_norms = preprocess_norms(base)
    best_d = torch.full((B, 0), torch.inf, device=dev)
    best_i = torch.full((B, 0), -1, dtype=torch.int64, device=dev)
    for start in range(0, N, tile):
        stop = min(start + tile, N)
        d = pairwise_distance(
            queries, base[start:stop], metric, base_sq_norms[start:stop]
        )
        d = torch.where(valid[None, start:stop], d, torch.inf)
        td, ti = stable_smallest(d, min(k, stop - start))
        # running list first: on equal distances the lower index wins
        all_d = torch.cat([best_d, td], dim=1)
        all_i = torch.cat([best_i, ti + start], dim=1)
        best_d, sel = stable_smallest(all_d, k)
        best_i = all_i.gather(1, sel)
    if best_d.shape[1] < k:  # pad out to k
        pad = k - best_d.shape[1]
        best_d = torch.cat([best_d, torch.full((B, pad), torch.inf, device=dev)], 1)
        best_i = torch.cat(
            [best_i, torch.full((B, pad), -1, dtype=torch.int64, device=dev)], 1
        )
    best_i = torch.where(torch.isinf(best_d), -1, best_i)
    return best_d, best_i.to(torch.int32)
