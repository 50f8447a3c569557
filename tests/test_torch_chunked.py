"""The port's chunked device insertion against the JAX package's, on the CPU.

Both packages insert the same 480 vectors in batches of 200, 200 and 80
(each under the append threshold, so past the 256-vector host bootstrap
every batch takes the chunked path: the build descent against the frozen
graph, then the C++ link application). Levels and layer membership come from the
seeded numpy streams and must be equal; neighbor lists may differ where
f32 sums taken in another order break a near-tie differently, so they
are held to an overlap and to recall. The build descent itself is held to
the JAX `_build_descent_kernel`'s slots on one frozen graph.
"""

import numpy as np
import pytest

from scintirete_tpu.index import HNSWIndex as JaxHNSWIndex
from scintirete_tpu.types import DistanceMetric, HNSWParams, SearchParams
from scintirete_tpu_torch.index.hnsw import HNSWIndex
from scintirete_tpu_torch.ops.distance import distance_np

N, BATCH, D, NQ, K = 480, 200, 16, 100, 10
PARAMS = HNSWParams(m=8, ef_construction=48, ef_search=64, seed=21,
                    neighbor_heuristic=True)
# mean share of the JAX build's neighbors that the port's build also has,
# per layer: measured 1.0 on every layer of this corpus; asserted with a
# margin for near-ties that f32 sum order may break the other way
OVERLAP_MIN = 0.95
# distances of the descent's candidates (f32 sums in another order; L2
# compared squared, see the test)
DIST_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((12, D)).astype(np.float32) * 2.0
    base = (centers[rng.integers(0, 12, N)]
            + 0.5 * rng.standard_normal((N, D))).astype(np.float32)
    queries = (base[rng.integers(0, N, NQ)]
               + 0.2 * rng.standard_normal((NQ, D))).astype(np.float32)
    return base, queries


def _insert_in_batches(idx, base):
    for s in range(0, N, BATCH):
        e = min(s + BATCH, N)
        idx.bulk_insert(list(range(s + 1, e + 1)), base[s:e])


@pytest.fixture(scope="module")
def built(data):
    base, _ = data
    port = HNSWIndex(D, PARAMS, DistanceMetric.COSINE, device="cpu")
    _insert_in_batches(port, base)
    jax_idx = JaxHNSWIndex(D, PARAMS, DistanceMetric.COSINE)
    _insert_in_batches(jax_idx, base)
    return port, jax_idx


def _recall(idx, base, queries):
    truth = np.argsort(distance_np(queries, base, 2), axis=1,
                       kind="stable")[:, :K] + 1
    res = idx.search_batch(queries, SearchParams(top_k=K, ef_search=64))
    return np.mean([
        len({vid for vid, _ in r} & set(t.tolist())) / K
        for r, t in zip(res, truth)
    ])


def _overlap(a, b):
    shares = []
    for ra, rb in zip(a, b):
        want = set(rb[rb >= 0].tolist())
        if want:
            shares.append(len(set(ra[ra >= 0].tolist()) & want) / len(want))
    return float(np.mean(shares)) if shares else 1.0


def test_same_levels_and_membership(built):
    port, jax_idx = built
    ps, js = port.store, jax_idx.store
    assert ps.count == js.count == N
    np.testing.assert_array_equal(ps.levels[:N], js.levels[:N])
    assert ps.max_layer == js.max_layer
    for pl, jl in zip(ps.layers, js.layers):
        assert pl.count == jl.count
        np.testing.assert_array_equal(
            pl.node_slot[: pl.count], jl.node_slot[: jl.count]
        )


def test_neighbor_overlap(built):
    port, jax_idx = built
    ps, js = port.store, jax_idx.store
    shares = [_overlap(ps.neighbors0[:N], js.neighbors0[:N])] + [
        _overlap(pl.nbrs[: pl.count], jl.nbrs[: jl.count])
        for pl, jl in zip(ps.layers, js.layers)
    ]
    print("per-layer neighbor overlap with the JAX chunked build:", shares)
    assert min(shares) >= OVERLAP_MIN, shares


def test_recall_against_sequential_host_build(built, data):
    base, queries = data
    port, _ = built
    seq = HNSWIndex(D, PARAMS, DistanceMetric.COSINE, use_device=False,
                    device="cpu")
    _insert_in_batches(seq, base)
    r_chunked, r_seq = _recall(port, base, queries), _recall(seq, base, queries)
    assert r_chunked >= 0.90, r_chunked
    assert r_chunked >= r_seq - 0.05, (r_chunked, r_seq)
    s = port.store
    assert ((s.neighbors0[:N] >= 0).sum(axis=1) <= s.m0).all()
    assert not np.any(s.neighbors0[:N] == np.arange(N)[:, None])


def _untied_positions(d, rel=1e-5):
    """[..., W] True where a finite ascending distance is more than rel
    (relative) away from both of its neighbors in the row: the positions
    whose id no sum-order rounding can swap."""
    d = np.asarray(d, np.float64)
    with np.errstate(invalid="ignore"):
        gap = np.diff(d, axis=-1) > rel * np.maximum(1.0, np.abs(d[..., 1:]))
    edge = np.ones(d.shape[:-1] + (1,), bool)
    apart = np.concatenate([edge, gap], -1) & np.concatenate([gap, edge], -1)
    return apart & np.isfinite(d)


@pytest.mark.parametrize("metric", [DistanceMetric.L2, DistanceMetric.COSINE])
def test_build_descent_matches_jax_on_a_frozen_graph(built, data, metric):
    base, queries = data
    _, jax_idx = built
    state = jax_idx.export_graph_state()
    state["metric"] = int(metric)
    port = HNSWIndex.import_graph_state(state, device="cpu")
    ref = JaxHNSWIndex.import_graph_state(state)
    rng = np.random.default_rng(4)
    levels = np.minimum(
        np.floor(-np.log(1.0 - rng.random(NQ)) / np.log(2.0)), 3
    ).astype(np.int32)
    efc = 48
    got_s, got_d = port._get_device().build_descent(
        port.store, queries, levels, efc
    )
    want_s, want_d = ref._get_device().build_descent(
        ref.store, queries, levels, efc
    )
    assert got_s.shape == want_s.shape
    fin = np.isfinite(want_d)
    assert np.array_equal(fin, np.isfinite(got_d))
    if metric == DistanceMetric.L2:
        # sqrt amplifies the sum-order error of a cancelled difference near
        # 0: compare squared distances, relative to the norms that cancel
        scale = np.sum(queries**2, axis=1)[None, :, None] + np.max(
            np.sum(base**2, axis=1)
        )
        g, w = got_d[fin].astype(np.float64), want_d[fin].astype(np.float64)
        assert np.all(np.abs(g**2 - w**2)
                      <= 1e-5 * np.broadcast_to(scale, fin.shape)[fin])
    else:
        np.testing.assert_allclose(got_d[fin], want_d[fin], **DIST_TOL)
    # ground layer for every query; upper layers for queries above them
    untied = _untied_positions(want_d)
    assert untied.sum() > 0.9 * fin.sum()
    np.testing.assert_array_equal(got_s[untied], want_s[untied])
    np.testing.assert_array_equal(got_s[~fin], want_s[~fin])  # -1 padding
