"""Vectorized result assembly: device (slots, dists) -> [(id, dist)] rows.

A copy of `scintirete_tpu/index/results.py` (pure numpy), kept in the port
because importing anything under `scintirete_tpu.index` pulls in jax.

The per-element filtering comprehension this replaces cost ~107 ms at
B=16k x k=10 (a quarter of the whole serving pass); in the common case —
every slot valid, which holds whenever k <= live — assembly is one numpy
gather plus C-speed zips (~10 ms). Result shape matches the reference's
SearchResult list (hnsw.go:324-345): per query, ascending [(id, dist)].
"""

from __future__ import annotations

import numpy as np


def assemble_results(
    slot_to_id: np.ndarray, slots_b: np.ndarray, dists_b: np.ndarray
) -> list[list[tuple[int, float]]]:
    ids_b = slot_to_id[np.maximum(slots_b, 0)]
    if slots_b.min(initial=0) >= 0:
        return [
            list(zip(i_row, d_row))
            for i_row, d_row in zip(ids_b.tolist(), dists_b.tolist())
        ]
    valid_b = slots_b >= 0
    return [
        [(vid, dist) for vid, dist, ok in zip(i_row, d_row, ok_row) if ok]
        for i_row, d_row, ok_row in zip(
            ids_b.tolist(), dists_b.tolist(), valid_b.tolist()
        )
    ]


def assemble_arrays(
    slot_to_id: np.ndarray, slots_b: np.ndarray, dists_b: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Packed variant for the BatchSearch RPC: (ids u64 [B,k], dists f32
    [B,k]) with id 0 / +inf marking missing hits (ID 0 is never assigned —
    reference hnsw.go:139 reserves it as the no-entrypoint sentinel). No
    per-hit Python objects: two gathers and a where, so a 4096x10 result
    costs microseconds instead of the ~40k tuple constructions the
    list-of-tuples assembly pays."""
    valid = slots_b >= 0
    ids_b = np.where(valid, slot_to_id[np.maximum(slots_b, 0)], 0).astype(
        np.uint64
    )
    dists = np.where(valid, dists_b, np.float32(np.inf)).astype(
        np.float32, copy=False
    )
    return ids_b, dists
