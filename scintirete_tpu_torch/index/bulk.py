"""Bulk insertion: device-assisted chunked inserts (port of
`scintirete_tpu/index/bulk.py`).

HNSW insertion is sequential (each insert must see the links of prior
inserts). The device compromise:

1. allocate slots + draw levels for a CHUNK of new vectors,
2. run the batched insert descent against the frozen pre-chunk graph
   (`DeviceIndex.build_descent_raw`: per vector and per layer, the efc best
   candidates),
3. apply link updates on the host IN CHUNK ORDER, merging in exact
   distances to earlier chunk members (so intra-chunk connectivity matches
   what sequential insertion would have discovered): the C++ engine of
   `native/link_apply.cpp` when it builds, the Python loop below otherwise
   (also the semantics oracle),
4. the dirty rows scatter to the device mirror before the next chunk's
   descent.

Chunks are pipelined one ahead, as in the JAX package: chunk t+1 descends
before chunk t's links apply, so it sees a graph stale by one extra chunk
(the same approximation the chunking already makes). The port's descent
syncs with the host every step, so the pipelining keeps the semantics
rather than overlapping work. The JAX package pads every chunk to
`chunk_size` rows (one compiled shape); the port does not.

Small graphs bootstrap through plain sequential host insertion (also the
semantics oracle and the path of an index without a device), and small
batches always stay on the host.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np

from scintirete_tpu_torch.index import host_algo
from scintirete_tpu_torch.index.store import GraphStore
from scintirete_tpu_torch.ops.distance import distance_np

# below this size, sequential host insertion is faster than device dispatch
BOOTSTRAP_SIZE = 256
DEFAULT_CHUNK = 1024
# batches smaller than this skip the device entirely (online single-vector
# inserts must not pay the batch machinery)
SMALL_BATCH = 48


def bulk_insert(
    store: GraphStore,
    vectors: np.ndarray,
    device=None,  # DeviceIndex; None = host-only
    chunk_size: int = DEFAULT_CHUNK,
    write_ctx=None,  # callable -> context manager guarding store mutation
    on_slots=None,  # called with each group of new slots INSIDE a write section
) -> list[int]:
    """Insert a batch of vectors; returns their slots in order.

    ``write_ctx`` (e.g. ``RWLock.write``) is entered around every store
    mutation phase and released between chunks: the graph's invariants
    hold at chunk boundaries, so concurrent readers see a consistent
    partial graph. ``on_slots`` lets the caller register id mappings
    atomically with the links that make those slots reachable."""
    wctx = write_ctx if write_ctx is not None else nullcontext
    vectors = np.asarray(vectors, np.float32)
    n = len(vectors)
    slots: list[int] = []

    with wctx():
        levels = store.draw_levels(n)
        # one up-front capacity reservation: device shapes stay fixed for
        # the whole build (one full upload, then incremental scatters)
        store.reserve(levels)
        if device is None or n < SMALL_BATCH:
            boot = n
        else:
            boot = max(0, min(n, BOOTSTRAP_SIZE - store.live))

    for pos0 in range(0, boot, 256):
        hi = min(boot, pos0 + 256)
        with wctx():
            group = [
                host_algo.insert(store, vectors[i], int(levels[i]))
                for i in range(pos0, hi)
            ]
            slots.extend(group)
            if on_slots:
                on_slots(group)

    pos = boot
    pending = None
    while pos < n or pending is not None:
        with wctx():
            dispatched = None
            if pos < n:
                # early chunks stay small relative to the graph to bound
                # staleness
                step = min(chunk_size, max(128, store.live))
                dispatched = _dispatch_chunk(
                    store, device, vectors[pos : pos + step],
                    levels[pos : pos + step],
                )
                pos += step
            if pending is not None:
                applied = _apply_chunk(store, *pending)
                slots.extend(applied)
                if on_slots:
                    on_slots(applied)
            pending = dispatched
    return slots


def _dispatch_chunk(store, device, chunk, levels):
    """Allocate slots + run the descent against the current graph (new
    slots are unreachable until linked, so syncing them first is safe)."""
    frozen_max = store.max_layer  # the descent sees the pre-dispatch graph
    efc = max(store.params.ef_construction, store.m0)
    lv = levels.astype(np.int32)
    new_slots = store.alloc_slots(chunk, lv)
    raw = device.build_descent_raw(store, chunk, lv, efc)
    return chunk, levels, new_slots, device.assemble_descent(raw, efc), \
        frozen_max, efc


def _apply_chunk(
    store: GraphStore,
    chunk: np.ndarray,  # [B, D]
    levels: np.ndarray,  # [B]
    new_slots: np.ndarray,
    cands: tuple[np.ndarray, np.ndarray],  # (slots, dists) [L+1, B, efc]
    frozen_max: int,
    efc: int,
) -> list[int]:
    # intra-chunk exact distances
    intra = distance_np(chunk, chunk, store.metric)  # [B, B]
    cand_slots, cand_dists = cands
    from scintirete_tpu_torch.native.build import apply_chunk_native

    dirty_pairs = apply_chunk_native(
        store, cand_slots, cand_dists, new_slots,
        levels.astype(np.int32), intra, frozen_max,
    )
    if dirty_pairs is not None:
        store.mark_rows(dirty_pairs)
        store.linked_count = max(store.linked_count, int(new_slots[-1]) + 1)
        return [int(s) for s in new_slots]
    return _apply_chunk_py(
        store, levels, new_slots, cand_slots, cand_dists, intra, frozen_max,
        efc,
    )


def _apply_chunk_py(store, levels, new_slots, cand_slots, cand_dists, intra,
                    frozen_max, efc) -> list[int]:
    """Pure-Python link application (the fallback and the semantics
    oracle of the C++ engine)."""
    B = len(new_slots)
    # chunk members eligible per layer, in insertion order
    order_by_layer: dict[int, list[int]] = {}
    max_lvl = int(levels.max(initial=0))
    for lc in range(0, max_lvl + 1):
        order_by_layer[lc] = [j for j in range(B) if levels[j] >= lc]

    for i in range(B):
        level = int(levels[i])
        slot = int(new_slots[i])
        for lc in range(level, -1, -1):
            # frozen-graph candidates (when the layer existed at descent)
            if lc <= frozen_max and lc < cand_slots.shape[0]:
                cs = cand_slots[lc, i].astype(np.int64)
                cd = cand_dists[lc, i]
                keep = (cs >= 0) & (cs != slot)
                cs, cd = cs[keep], cd[keep]
                if lc >= 1 and cs.size:
                    # beams can return seed nodes that are not members of a
                    # sparse layer; linking to them would break the layer
                    # invariant
                    member = store.layers[lc - 1].row_of[cs] >= 0
                    cs, cd = cs[member], cd[member]
            else:
                cs = np.empty(0, np.int64)
                cd = np.empty(0, np.float32)
            # earlier chunk members present at this layer
            members = [j for j in order_by_layer.get(lc, ()) if j < i]
            if members:
                mem = np.asarray(members)
                cs = np.concatenate([cs, new_slots[mem]])
                cd = np.concatenate([cd, intra[i, mem]])
            if cs.size == 0:
                continue
            order = np.argsort(cd, kind="stable")[:efc]
            cs, cd = cs[order], cd[order]
            max_conn = store.max_degree(lc)
            selected = host_algo.select_neighbors(store, cs, cd, max_conn)
            selected = selected.astype(np.int32)
            store.set_neighbors(slot, lc, selected)
            for nbr in selected:
                host_algo._add_link(store, int(nbr), slot, lc)
        if level > store.max_layer or store.entry_slot < 0:
            store.max_layer = max(store.max_layer, level)
            store.entry_slot = slot
    store.linked_count = max(store.linked_count, int(new_slots[-1]) + 1)
    return [int(s) for s in new_slots]
