"""Host-side HNSW algorithm over the flat-array store.

A copy of `scintirete_tpu/index/host_algo.py` (pure numpy), kept in the port
because importing anything under `scintirete_tpu.index` pulls in jax.

This is the mutation path and the correctness oracle for the batched device
kernels. It reproduces the reference's algorithmic behavior
(reference: internal/core/algorithm/hnsw.go):

- searchLayer keeps a best-list of size `num_closest`, a nearest-first
  frontier, and a visited set; stops when the frontier head is worse than the
  worst kept candidate once full (hnsw.go:487-557).
- Deleted nodes are skipped entirely during traversal — never entered into
  candidates or used for routing (hnsw.go:527-530).
- Neighbor selection is the *simple* top-M-by-distance variant, not the
  diversity heuristic (hnsw.go:560-583).
- Insert descends maxLayer..level+1 with ef=1, then beam-searches with
  ef_construction on layers min(level, maxLayer)..0, linking bidirectionally
  and pruning overfull neighbors; the selected neighbors seed the next layer
  (hnsw.go:216-249).
- Delete is tombstone-only; deleting the entrypoint promotes the
  highest-level live node (hnsw.go:260-289, :617-634).

Distances are numpy-batched per expansion (one call per visited node covers
all its neighbors at once) instead of the reference's per-pair scalar loop.

Known deviation (documented): when a new node's level exceeds the old
maxLayer, the reference still "searches" the not-yet-populated top layers and
ends up linking the new node to the entrypoint *above the entrypoint's own
level* (a side effect of deriving node level from connection lists,
hnsw.go:216-249 + :471-484). This store keeps explicit levels, so those
phantom top-layer links don't exist; the new node simply becomes the
entrypoint for the new top layers. Recall behavior is equivalent.
"""

from __future__ import annotations

import heapq

import numpy as np

from scintirete_tpu_torch.index.store import GraphStore
from scintirete_tpu_torch.ops.distance import distance_np


def _distances(store: GraphStore, q: np.ndarray, slots: np.ndarray) -> np.ndarray:
    return distance_np(q, store.vectors[slots], store.metric)


def search_layer(
    store: GraphStore,
    q: np.ndarray,
    entry_slots: np.ndarray,
    num_closest: int,
    layer: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Beam search within one layer. Returns (slots, dists) ascending.

    Entry slots that are deleted are dropped; if none survive, returns empty
    (reference: hnsw.go:492-506).
    """
    entry_slots = np.unique(np.asarray(entry_slots, dtype=np.int64))
    entry_slots = entry_slots[entry_slots >= 0]
    entry_slots = entry_slots[~store.deleted[entry_slots]]
    if entry_slots.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.float32)

    visited = np.zeros(store.cap, dtype=bool)
    visited[entry_slots] = True

    entry_dists = _distances(store, q, entry_slots)
    order = np.argsort(entry_dists, kind="stable")
    cand_slots = list(entry_slots[order][:num_closest])
    cand_dists = list(entry_dists[order][:num_closest])

    frontier: list[tuple[float, int]] = [
        (float(d), int(s)) for d, s in zip(entry_dists, entry_slots)
    ]
    heapq.heapify(frontier)

    table, row_of = store.adjacency(layer)
    deleted = store.deleted

    while frontier:
        d, slot = heapq.heappop(frontier)
        if len(cand_dists) >= num_closest and d > cand_dists[-1]:
            break

        row = slot if row_of is None else int(row_of[slot])
        if row < 0:
            continue
        nbrs = table[row]
        nbrs = nbrs[nbrs >= 0]
        if nbrs.size == 0:
            continue
        fresh = nbrs[~visited[nbrs]]
        if fresh.size == 0:
            continue
        visited[fresh] = True
        fresh = fresh[~deleted[fresh]]
        if fresh.size == 0:
            continue

        dists = _distances(store, q, fresh)
        # merge into the kept best-list (vectorized equivalent of the
        # reference's insert-or-replace-worst + insertion sort)
        worst = cand_dists[-1] if len(cand_dists) >= num_closest else np.inf
        take = dists < worst if len(cand_dists) >= num_closest else np.ones_like(dists, bool)
        for s, dist in zip(fresh[take], dists[take]):
            heapq.heappush(frontier, (float(dist), int(s)))
        merged_slots = np.concatenate([np.asarray(cand_slots, np.int64), fresh])
        merged_dists = np.concatenate([np.asarray(cand_dists, np.float32), dists])
        order = np.argsort(merged_dists, kind="stable")[:num_closest]
        cand_slots = list(merged_slots[order])
        cand_dists = list(merged_dists[order])

    return np.asarray(cand_slots, np.int64), np.asarray(cand_dists, np.float32)


def greedy_descent(
    store: GraphStore, q: np.ndarray, from_layer: int, to_layer: int
) -> np.ndarray:
    """ef=1 descent from `from_layer` down to `to_layer` (exclusive)."""
    entries = np.asarray([store.entry_slot], np.int64)
    for lc in range(from_layer, to_layer, -1):
        slots, _ = search_layer(store, q, entries, 1, lc)
        if slots.size:
            entries = slots
    return entries


def select_neighbors(
    store: GraphStore,
    cand_slots: np.ndarray,  # sorted ascending by distance to the query
    cand_dists: np.ndarray,
    max_conn: int,
) -> np.ndarray:
    """Neighbor selection. Simple nearest-M (reference: hnsw.go:560-583) or,
    when params.neighbor_heuristic is set, the diversity heuristic: keep a
    candidate only if it is closer to the query than to every already-kept
    neighbor, then fill remaining slots from the pruned set."""
    if not store.params.neighbor_heuristic or len(cand_slots) <= max_conn:
        return cand_slots[:max_conn]
    scan_cap = 128  # matches the native engine's kHeuristicScanCap
    selected: list[int] = []
    pruned: list[int] = []
    fill_from = len(cand_slots)
    for idx, (slot, d) in enumerate(zip(cand_slots, cand_dists)):
        if len(selected) == max_conn or idx >= scan_cap:
            fill_from = idx
            break
        if selected:
            d_sel = _distances(
                store, store.vectors[int(slot)], np.asarray(selected, np.int64)
            )
            if (d_sel <= d).any():  # closer to a kept neighbor than to q
                pruned.append(int(slot))
                continue
        selected.append(int(slot))
    for slot in pruned:  # keepPrunedConnections: fill remaining slots
        if len(selected) == max_conn:
            break
        selected.append(slot)
    for slot in cand_slots[fill_from:]:
        if len(selected) == max_conn:
            break
        selected.append(int(slot))
    return np.asarray(selected, dtype=cand_slots.dtype)


def insert(store: GraphStore, vector: np.ndarray, level: int | None = None) -> int:
    """Insert one vector; returns its slot. Sequential reference semantics."""
    if level is None:
        level = store.draw_level()
    slot = store.alloc_slot(np.asarray(vector, np.float32), level)

    if store.entry_slot < 0:
        store.entry_slot = slot
        store.max_layer = level
        store.linked_count = max(store.linked_count, slot + 1)
        return slot

    old_max = store.max_layer
    q = store.vectors[slot]
    entries = greedy_descent(store, q, old_max, level)

    for lc in range(min(level, old_max), -1, -1):
        cand_slots, cand_dists = search_layer(
            store, q, entries, store.params.ef_construction, lc
        )
        max_conn = store.max_degree(lc)
        selected = select_neighbors(store, cand_slots, cand_dists, max_conn)
        store.set_neighbors(slot, lc, selected.astype(np.int32))
        for nbr in selected:
            _add_link(store, int(nbr), slot, lc)
        entries = selected if selected.size else entries

    if level > old_max:
        store.max_layer = level
        store.entry_slot = slot
    store.linked_count = max(store.linked_count, slot + 1)
    return slot


def _add_link(store: GraphStore, from_slot: int, to_slot: int, layer: int) -> None:
    """Append a link and prune to max degree by distance
    (reference: pruneConnections hnsw.go:586-614 — keeps the closest live
    neighbors, dropping deleted ones in the process)."""
    nbrs = store.get_neighbors(from_slot, layer)
    if to_slot in nbrs:
        return
    nbrs = np.append(nbrs, to_slot)
    max_conn = store.max_degree(layer)
    if nbrs.size > max_conn:
        live = nbrs[~store.deleted[nbrs]]
        d = _distances(store, store.vectors[from_slot], live)
        order = np.argsort(d, kind="stable")
        if store.params.neighbor_heuristic:
            nbrs = select_neighbors(store, live[order], d[order], max_conn)
        else:
            nbrs = live[order[:max_conn]]
    store.set_neighbors(from_slot, layer, nbrs.astype(np.int32))


def delete(store: GraphStore, slot: int) -> bool:
    """Tombstone a slot. Returns False if it was already deleted."""
    if store.deleted[slot]:
        return False
    store.mark_deleted(slot)
    store.live -= 1
    if store.entry_slot == slot:
        _find_new_entrypoint(store)
    return True


def _find_new_entrypoint(store: GraphStore) -> None:
    """Promote the highest-level live node (reference: hnsw.go:617-634)."""
    n = store.count
    alive = (store.levels[:n] >= 0) & ~store.deleted[:n]
    if not alive.any():
        store.entry_slot = -1
        store.max_layer = -1
        return
    levels = np.where(alive, store.levels[:n], -1)
    best = int(np.argmax(levels))
    store.entry_slot = best
    store.max_layer = int(levels[best])


def search(
    store: GraphStore,
    q: np.ndarray,
    top_k: int,
    ef_search: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Full query: greedy descent then layer-0 beam (reference: hnsw.go:292-350).

    Returns (slots, dists) ascending, at most top_k, deleted filtered.
    """
    if store.entry_slot < 0 or store.live == 0:
        return np.empty(0, np.int64), np.empty(0, np.float32)
    ef = ef_search if ef_search and ef_search > 0 else store.params.ef_search
    ef = max(ef, top_k)
    entries = greedy_descent(store, q, store.max_layer, 0)
    slots, dists = search_layer(store, q, entries, ef, 0)
    keep = ~store.deleted[slots] if slots.size else np.empty(0, bool)
    slots, dists = slots[keep], dists[keep]
    return slots[:top_k], dists[:top_k]
