"""The port's pivot search against the JAX package's, on one JAX-built graph.

The JAX package builds a graph of 5000 vectors (enough for a 512-pivot
sample, which its Pallas pivot scan needs); the graph crosses to the port
through export_graph_state / import_graph_state. For each metric both
packages search the same graph: the JAX side runs `_search_kernel_pivot`
with the Pallas scan in interpret mode, the port runs `search_batch` on the
CPU. Slots must be equal on every query whose reference top-k has no
near-tie, with distances within rtol = atol = 1e-5 (f32 sums in another
order); the same holds after tombstoning 5% of the ids, which exercises the
mirror's dirty-row sync.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from scintirete_tpu.index import HNSWIndex as JaxHNSWIndex
from scintirete_tpu.index.device import DeviceIndex as JaxDeviceIndex
from scintirete_tpu.index.device import _search_kernel_pivot as jax_search
from scintirete_tpu.types import DistanceMetric, HNSWParams, SearchParams
from scintirete_tpu_torch.index.hnsw import HNSWIndex

N, D, NQ, K, EF = 5000, 16, 64, 10, 32
METRICS = [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((50, D)).astype(np.float32) * 2.0
    base = (centers[rng.integers(0, 50, N)]
            + 0.4 * rng.standard_normal((N, D))).astype(np.float32)
    queries = (base[rng.integers(0, N, NQ)]
               + 0.2 * rng.standard_normal((NQ, D))).astype(np.float32)
    queries[5] = 0.0  # zero query: cosine distance 1 to everything
    return base, queries


@pytest.fixture(scope="module")
def jax_state(data):
    base, _ = data
    with pytest.MonkeyPatch.context() as mp:
        # the fused bf16 build (Pallas lane scan in interpret mode): the
        # path the port always takes, and the quickest JAX build on a CPU
        mp.setenv("SCNT_BUILD_INTERPRET", "1")
        mp.setenv("SCNT_BUILD_SCAN_DTYPE", "bfloat16")
        return _jax_build(base)


def _jax_build(base):
    idx = JaxHNSWIndex(
        D, HNSWParams(m=8, ef_construction=64, ef_search=EF, seed=3,
                      neighbor_heuristic=True),
        DistanceMetric.COSINE,
    )
    idx.bulk_insert(list(range(1, N + 1)), base)
    return idx.export_graph_state()


def _with_metric(state, metric):
    s = dict(state)
    s["metric"] = int(metric)
    return s


def _jax_slots(jidx, queries, metric):
    dev = JaxDeviceIndex()
    dev.sync(jidx.store)
    a = dev.graph.arrays
    d, s, _ = jax_search(
        jnp.asarray(queries), a["vectors"], a["sq_norms"], a["deleted"],
        a["neighbors0"], a["pivots"], a["pivot_vecs"], a["pivot_sq"],
        metric=int(metric), ef=EF, k=K, max_steps=EF + 64,
        use_pallas=True, interpret=True,
    )
    return np.asarray(s), np.asarray(d)


def _untied(d, rel=1e-5):
    d = np.asarray(d, np.float64)
    gap = np.diff(d, axis=1)
    fin = np.isfinite(d[:, 1:])
    return np.all(~fin | (gap > rel * np.maximum(1.0, np.abs(d[:, 1:]))), axis=1)


def _assert_same(port, jidx, queries, metric):
    want_s, want_d = _jax_slots(jidx, queries, metric)
    got_s, got_d = port._get_device().search(port.store, queries, K, EF)
    rows = _untied(want_d)
    assert rows.mean() >= 0.9
    np.testing.assert_array_equal(got_s[rows], want_s[rows])
    if metric == DistanceMetric.L2:
        # sqrt amplifies the f32 sum-order error of q^2 + v^2 - 2 dot where
        # the norms cancel: compare squared distances, 1e-5 relative to them
        scale = np.sum(queries * queries, axis=1)[:, None] + np.max(
            np.sum(port.store.vectors**2, axis=1))
        err = np.abs(got_d**2 - want_d**2)[rows]
        assert np.all(err <= 1e-5 * np.broadcast_to(scale, got_d.shape)[rows])
    else:
        np.testing.assert_allclose(got_d[rows], want_d[rows], rtol=1e-5, atol=1e-5)
    # the public surface returns the same hits, as ids
    res = port.search_batch(queries, SearchParams(top_k=K, ef_search=EF))
    ids = [[vid for vid, _ in r] for r in res]
    for i in np.flatnonzero(rows):
        assert ids[i] == [int(v) for v in port.slot_to_id[want_s[i][want_s[i] >= 0]]]
    return res


@pytest.mark.parametrize("metric", METRICS)
def test_pivot_search_matches_jax_before_and_after_tombstones(
    data, jax_state, metric
):
    base, queries = data
    state = _with_metric(jax_state, metric)
    port = HNSWIndex.import_graph_state(state, device="cpu")
    jidx = JaxHNSWIndex.import_graph_state(state)
    _assert_same(port, jidx, queries, metric)
    mirror = port._get_device().graph

    rng = np.random.default_rng(int(metric))
    gone = [int(v) for v in rng.choice(N, N // 20, replace=False) + 1]
    for vid in gone:
        assert port.delete(vid)
        jidx.delete(vid)
    full_uploads = []
    real_full = mirror._full_upload
    mirror._full_upload = lambda store: (full_uploads.append(1), real_full(store))
    res = _assert_same(port, jidx, queries, metric)
    assert not full_uploads, "a tombstone must sync by dirty-row scatter"
    dead = set(gone)
    assert not any(vid in dead for r in res for vid, _ in r)


def test_arrays_and_submit_collect_agree_with_search_batch(data, jax_state):
    _, queries = data
    port = HNSWIndex.import_graph_state(jax_state, device="cpu",
                                        search_batch_size=16)
    sp = SearchParams(top_k=K, ef_search=EF)
    want = port.search_batch(queries, sp)
    ids, dists = port.search_batch_arrays(queries, sp)
    assert ids.shape == (NQ, K) and ids.dtype == np.uint64
    for i, r in enumerate(want):
        assert [vid for vid, _ in r] == ids[i].tolist()
        np.testing.assert_array_equal([d for _, d in r], dists[i])
    assert port.search_collect(port.search_submit(queries, sp)) == want
    piped = port.search_batch_pipelined([queries[:20], queries[20:]], sp)
    assert piped[0] + piped[1] == want
    # the zero query's cosine distances are all 1
    assert all(d == 1.0 for _, d in want[5])


def test_graph_state_round_trips_through_the_port(jax_state):
    port = HNSWIndex.import_graph_state(jax_state, device="cpu")
    out = port.export_graph_state()
    assert out.keys() == jax_state.keys()
    for key, val in jax_state.items():
        if isinstance(val, np.ndarray):
            assert out[key].dtype == val.dtype
            np.testing.assert_array_equal(out[key], val)
    for lo, li in zip(out["layers"], jax_state["layers"]):
        np.testing.assert_array_equal(lo["nbrs"], li["nbrs"])
        np.testing.assert_array_equal(lo["node_slot"], li["node_slot"])
