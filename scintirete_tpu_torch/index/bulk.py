"""Bulk insertion by sequential host inserts (port of the host path of
`scintirete_tpu/index/bulk.py`).

Small batches, and every batch of an index without a device, insert one
vector at a time through `host_algo.insert`, the reference's semantics.
The JAX package sends the rest of a large batch (past a 256-vector
bootstrap) through chunked device descents (`DeviceIndex.build_descent`);
that path is not ported yet and raises before the store is touched (see
ROADMAP.md).
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np

from scintirete_tpu_torch.index import host_algo
from scintirete_tpu_torch.index.store import GraphStore

# below this size, sequential host insertion is faster than device dispatch
BOOTSTRAP_SIZE = 256
# batches smaller than this skip the device entirely
SMALL_BATCH = 48


def bulk_insert(
    store: GraphStore,
    vectors: np.ndarray,
    use_device: bool = False,
    write_ctx=None,  # callable -> context manager guarding store mutation
    on_slots=None,  # called with each group of new slots INSIDE a write section
) -> list[int]:
    """Insert a batch of vectors; returns their slots in order.

    ``write_ctx`` (e.g. ``RWLock.write``) is entered around every group of
    256 inserts and released between groups, so concurrent readers see a
    consistent partial graph. ``on_slots`` lets the caller register id
    mappings atomically with the links that make those slots reachable."""
    wctx = write_ctx if write_ctx is not None else nullcontext
    vectors = np.asarray(vectors, np.float32)
    n = len(vectors)
    if not use_device or n < SMALL_BATCH:
        boot = n
    else:
        boot = max(0, min(n, BOOTSTRAP_SIZE - store.live))
    if boot < n:
        raise NotImplementedError(
            f"chunked device insertion of {n - boot} vectors "
            "(bulk.py / DeviceIndex.build_descent) is not ported yet: "
            "ROADMAP.md Queue 1, chunked build item"
        )
    slots: list[int] = []
    with wctx():
        levels = store.draw_levels(n)
        store.reserve(levels)
    for pos0 in range(0, n, 256):
        hi = min(n, pos0 + 256)
        with wctx():
            group = [
                host_algo.insert(store, vectors[i], int(levels[i]))
                for i in range(pos0, hi)
            ]
            slots.extend(group)
            if on_slots:
                on_slots(group)
    return slots
