"""The port's batched append against the JAX package's, on the CPU.

The port builds a 2,500-vector collection from one seed; the JAX package
takes that graph (its state dict) and the level stream's state, and both
append the same 2,200 vectors (at least APPEND_MIN, so both take the
batched append) onto the same graph. (The build itself is held to the JAX
build in tests/test_torch_build.py.) The JAX side takes its fused path
(bf16 scans, the masked Pallas kernel in interpret mode), which is the path
the port always takes. Levels, slots, entry point and layer membership
come from the seeded numpy streams and must be equal. Neighbor lists may
differ where bf16 scores tie or f32 sums round differently, so they are
held to a per-layer overlap and to recall.
"""

import numpy as np
import pytest
import torch

from scintirete_tpu.index import HNSWIndex as JaxHNSWIndex
from scintirete_tpu.types import DistanceMetric, HNSWParams, SearchParams
from scintirete_tpu_torch.index.hnsw import HNSWIndex
from scintirete_tpu_torch.ops.distance import distance_np

# one intra-op thread: the suite runs its files in parallel worker
# processes on the CPU, and every worker imports every test module at
# collection, so this holds for each of them
torch.set_num_threads(1)

N1, N2, D, NQ, K = 2500, 2200, 16, 200, 10
N = N1 + N2
COS, L2 = DistanceMetric.COSINE, DistanceMetric.L2
PARAMS = HNSWParams(m=8, ef_construction=64, ef_search=12, seed=11,
                    neighbor_heuristic=True)
# m = 40: 2 * m0 = 160 > 128, where the JAX package's layer-0 flush takes
# its host chain and the port keeps its single resident path
PARAMS_M40 = HNSWParams(m=40, ef_construction=64, ef_search=12, seed=13,
                        neighbor_heuristic=True)
# mean share of the JAX append's neighbors that the port's append also
# has, per layer. Measured: 1.0 on every layer of the cosine append, and
# 0.9967 (layer 0) / 0.9917 (layer 1) / 1.0 above for the m = 40 L2 one,
# where JAX's host chain takes the forward scan's distances and the port
# recomputes them; asserted with a margin
OVERLAP_MIN = 0.97


def _corpus(seed, n):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((30, D)).astype(np.float32) * 2.0
    base = (centers[rng.integers(0, 30, n)]
            + 0.4 * rng.standard_normal((n, D))).astype(np.float32)
    # queries near base points and near appended points
    qi = np.concatenate([rng.integers(0, N1, NQ // 2),
                         rng.integers(N1, N, NQ // 2)])
    queries = (base[qi] + 0.2 * rng.standard_normal((NQ, D))).astype(np.float32)
    return base, queries


def _build_both(base, params, metric):
    """The port builds the first N1 vectors; the JAX package takes that
    graph and the level stream where the build left it, so the two
    appends of the rest start from one graph and draw the same levels."""
    port = HNSWIndex(D, params, metric, device="cpu")
    port.bulk_insert(list(range(1, N1 + 1)), base[:N1])
    jax_idx = JaxHNSWIndex.import_graph_state(port.export_graph_state())
    jax_idx.store.rng.bit_generator.state = port.store.rng.bit_generator.state
    port.bulk_insert(list(range(N1 + 1, N + 1)), base[N1:N])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCNT_BUILD_INTERPRET", "1")
        mp.setenv("SCNT_BUILD_SCAN_DTYPE", "bfloat16")
        mp.setenv("SCNT_APPEND_INTERPRET", "1")
        jax_idx.bulk_insert(list(range(N1 + 1, N + 1)), base[N1:N])
    return port, jax_idx


@pytest.fixture(scope="module")
def data():
    return _corpus(5, N)


@pytest.fixture(scope="module")
def built(data):
    return _build_both(data[0], PARAMS, COS)


def _truth(base, queries, metric):
    d = distance_np(queries, base, metric)
    return np.argsort(d, axis=1, kind="stable")[:, :K] + 1


def _recall(results, truth):
    return np.mean([
        len({vid for vid, _ in r} & set(t.tolist())) / K
        for r, t in zip(results, truth)
    ])


def _overlap(a, b):
    shares = []
    for ra, rb in zip(a, b):
        want = set(rb[rb >= 0].tolist())
        if want:
            shares.append(len(set(ra[ra >= 0].tolist()) & want) / len(want))
    return float(np.mean(shares)) if shares else 1.0  # edgeless top layer


def _overlaps(ps, js):
    return [_overlap(ps.neighbors0[:N], js.neighbors0[:N])] + [
        _overlap(pl.nbrs[: pl.count], jl.nbrs[: jl.count])
        for pl, jl in zip(ps.layers, js.layers)
    ]


def _assert_same_structure(ps, js):
    assert ps.count == js.count == N
    np.testing.assert_array_equal(ps.levels[:N], js.levels[:N])
    assert ps.entry_slot == js.entry_slot and ps.max_layer == js.max_layer
    assert len(ps.layers) == len(js.layers)
    for pl, jl in zip(ps.layers, js.layers):
        assert pl.count == jl.count
        np.testing.assert_array_equal(
            pl.node_slot[: pl.count], jl.node_slot[: jl.count]
        )
        np.testing.assert_array_equal(pl.row_of[:N], jl.row_of[:N])


def _assert_invariants(s, n):
    nb = s.neighbors0[:n]
    assert nb.shape[1] == s.m0 and nb.max() < n and nb.min() >= -1
    assert (nb >= 0).sum(axis=1).min() >= 1
    for slot, row in enumerate(nb):
        live = row[row >= 0]
        assert slot not in live and len(set(live.tolist())) == len(live)
        assert np.all(row[len(live):] == -1)  # -1 padding only at the tail
    for layer, ls in enumerate(s.layers, start=1):
        assert np.all(s.levels[ls.node_slot[: ls.count]] >= layer)
        for r in range(ls.count):
            slot = ls.node_slot[r]
            live = ls.nbrs[r][ls.nbrs[r] >= 0]
            assert slot not in live and len(set(live.tolist())) == len(live)
            assert np.all(ls.row_of[live] >= 0), f"non-member at layer {layer}"


def test_same_levels_slots_entry_and_membership(built):
    port, jax_idx = built
    _assert_same_structure(port.store, jax_idx.store)
    assert [port.id_to_slot[i] for i in range(1, N + 1)] == [
        jax_idx.id_to_slot[i] for i in range(1, N + 1)
    ]


def test_neighbor_overlap_per_layer(built):
    port, jax_idx = built
    shares = _overlaps(port.store, jax_idx.store)
    print("per-layer neighbor overlap with the JAX append:", shares)
    assert min(shares) >= OVERLAP_MIN, shares


def test_graph_invariants_and_incoming_edges(built):
    port, _ = built
    s = port.store
    _assert_invariants(s, N)
    # every appended node is reachable: some other node links to it
    linked = np.zeros(N, bool)
    nb = s.neighbors0[:N]
    linked[nb[nb >= 0]] = True
    assert linked[N1:N].all()


def test_recall_and_state_crosses_both_ways(built, data):
    base, queries = data
    port, jax_idx = built
    truth = _truth(base[:N], queries, COS)
    sp = SearchParams(top_k=K, ef_search=12)
    port_rec = _recall(port.search_batch(queries, sp), truth)
    # the JAX-appended graph, searched by the same (port) search
    jax_graph = HNSWIndex.import_graph_state(
        jax_idx.export_graph_state(), device="cpu"
    )
    jax_rec = _recall(jax_graph.search_batch(queries, sp), truth)
    assert port_rec >= 0.93 and port_rec >= jax_rec - 0.01, (port_rec, jax_rec)
    # the port-appended graph loads in the JAX package and searches there
    back = JaxHNSWIndex.import_graph_state(port.export_graph_state())
    assert _recall(back.search_batch(queries, sp), truth) >= port_rec - 0.01


def test_scan_cache_hits_and_a_delete_misses_the_adjacency():
    # sizes chosen so that only the first append grows the capacity (the
    # cached base is padded to it): 4,000 -> 8,400 -> 10,448 -> 12,496
    n1, a1, a2, a3 = 4000, 4400, 2048, 2048
    base = _corpus(7, n1 + a1 + a2 + a3)[0]
    idx = HNSWIndex(D, PARAMS, COS, device="cpu")
    idx.bulk_insert(list(range(1, n1 + 1)), base[:n1])
    cache = idx._append_scan_cache
    assert cache["lineage"] is idx.store.lineage  # seeded by the build
    npad = cache["npad"]
    # pad rows of the seeded base stay zero, live rows are the scan form
    seeded = cache["base"].float().numpy()
    assert not seeded[n1:].any()
    unit = base[:n1] / np.linalg.norm(base[:n1], axis=1, keepdims=True)
    np.testing.assert_allclose(seeded[:n1], unit, atol=1e-2)
    # the first append grows the capacity (new pad): both caches miss
    n = n1 + a1
    idx.bulk_insert(list(range(n1 + 1, n + 1)), base[n1:n])
    assert cache["npad"] > npad
    assert not cache["scan_hit_last"] and not cache["graph_hit_last"]
    # a second append that fits hits both
    idx.bulk_insert(list(range(n + 1, n + a2 + 1)), base[n : n + a2])
    assert cache["scan_hit_last"] and cache["graph_hit_last"]
    n += a2
    # a delete between appends: the scan base still hits (no vector
    # changed), the resident adjacency must miss and see the tombstones
    dead = list(range(1, n + 1, 7))
    for vid in dead:
        idx.delete(vid)
    before = idx.store.neighbors0[:n].copy()
    idx.bulk_insert(list(range(n + 1, n + a3 + 1)), base[n : n + a3])
    assert cache["scan_hit_last"] and not cache["graph_hit_last"]
    s = idx.store
    dead_slots = np.asarray([idx.id_to_slot[v] for v in dead])
    changed = np.flatnonzero((s.neighbors0[:n] != before).any(axis=1))
    assert len(changed) > 100
    # every re-selected row dropped its tombstoned neighbors, and no new
    # node links to a tombstone
    assert not np.isin(s.neighbors0[changed], dead_slots).any()
    assert not np.isin(s.neighbors0[n : n + a3], dead_slots).any()
    _assert_invariants(s, n + a3)
    # appended vectors find themselves through the kept device mirror
    res = idx.search_batch(base[n : n + 64], SearchParams(top_k=1))
    assert np.mean([r[0][0] == n + 1 + i for i, r in enumerate(res)]) >= 0.95


def test_l2_append_at_m40_on_the_resident_path():
    base, queries = _corpus(9, N)
    port, jax_idx = _build_both(base, PARAMS_M40, L2)
    _assert_same_structure(port.store, jax_idx.store)
    _assert_invariants(port.store, N)
    shares = _overlaps(port.store, jax_idx.store)
    print("m=40 L2 per-layer overlap with the JAX host chain:", shares)
    assert min(shares) >= OVERLAP_MIN, shares
    truth = _truth(base, queries, L2)
    sp = SearchParams(top_k=K, ef_search=12)
    port_rec = _recall(port.search_batch(queries, sp), truth)
    jax_graph = HNSWIndex.import_graph_state(
        jax_idx.export_graph_state(), device="cpu"
    )
    jax_rec = _recall(jax_graph.search_batch(queries, sp), truth)
    assert port_rec >= 0.93 and port_rec >= jax_rec - 0.01, (port_rec, jax_rec)
