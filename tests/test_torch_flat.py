"""The port's FlatIndex (device="cpu") against the JAX package's, the slice
as a whole: the same inserts, deletes and queries give the same ids, and
distances within 1e-5 (f32 sums in another order), on both routes of the
port: the fused packed lane scan (`fused_min_cap=1024`, int8 and bf16 scan
copies) and the two-pass bf16 rerank (the default at these sizes). Both are
held to the numpy oracle with recall@10 >= 0.99. The state dict crosses
between the two packages either way.
"""

import numpy as np
import pytest
import torch

from scintirete_tpu.engine import Collection as JaxCollection
from scintirete_tpu.index.flat import FlatIndex as JaxFlatIndex
from scintirete_tpu.types import CollectionConfig as JaxCollectionConfig
from scintirete_tpu_torch import (
    CollectionConfig,
    DistanceMetric,
    HNSWParams,
    SearchParams,
)
from scintirete_tpu_torch.config import TPUConfig
from scintirete_tpu_torch.engine import Collection, Engine
from scintirete_tpu_torch.errors import ErrorCode, ScintireteError
from scintirete_tpu_torch.index.flat import FlatIndex
from scintirete_tpu_torch.ops.distance import distance_np

METRICS = [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT]
ROUTES = {
    "fused_int8": dict(fused_min_cap=1024),
    "fused_bf16": dict(fused_min_cap=1024, scan_dtype="bfloat16"),
    "rerank": dict(),
}
DIST_TOL = 1e-5


def _flat(dim, metric=DistanceMetric.L2, **kw):
    return FlatIndex(dim=dim, metric=metric, device="cpu", **kw)


def _ids(res):
    return [[vid for vid, _ in row] for row in res]


def _dists(res):
    return [[d for _, d in row] for row in res]


def _oracle(queries, base, deleted, metric, k):
    d = distance_np(queries, base, metric)
    d = np.where(np.asarray(deleted)[None, :], np.inf, d)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(d, idx, axis=1)


def _assert_same_results(got, want):
    assert _ids(got) == _ids(want)
    for g, w in zip(_dists(got), _dists(want)):
        np.testing.assert_allclose(g, w, rtol=DIST_TOL, atol=DIST_TOL)


@pytest.fixture
def corpus(rng):
    base = rng.standard_normal((3000, 24)).astype(np.float32)
    queries = rng.standard_normal((32, 24)).astype(np.float32)
    return base, queries


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_flat_index_matches_jax_and_oracle(corpus, rng, metric, route):
    """Inserts in two batches, deletes, more inserts and searches, in step
    with the JAX package's FlatIndex on the CPU."""
    base, queries = corpus
    port = _flat(24, metric, **ROUTES[route])
    ref = JaxFlatIndex(dim=24, metric=metric, use_device=True)
    sp = SearchParams(top_k=10)
    deleted = np.zeros(3000, bool)
    for idx in (port, ref):
        idx.bulk_insert(list(range(1, 2001)), base[:2000])
    _assert_same_results(port.search_batch(queries, sp),
                         ref.search_batch(queries, sp))
    gone = rng.choice(2000, 150, replace=False)
    for idx in (port, ref):
        for g in gone:
            assert idx.delete(int(g) + 1) is True
        idx.bulk_insert(list(range(2001, 3001)), base[2000:])
    deleted[gone] = True
    got = port.search_batch(queries, sp)
    _assert_same_results(got, ref.search_batch(queries, sp))
    assert port.size() == ref.size() == 2850

    fused = route != "rerank"
    assert port._dev["scan"].dtype == (
        torch.int8 if route == "fused_int8" else torch.bfloat16
    )
    assert ("scan_scale" in port._dev) == (route == "fused_int8")
    assert port.cap == 4096 and (port.cap >= port.fused_min_cap) == fused

    want_i, want_d = _oracle(queries, base, deleted, metric, 10)
    hits = sum(len(set(g) & set((w + 1).tolist()))
               for g, w in zip(_ids(got), want_i))
    assert hits / want_i.size >= 0.99
    for g_i, g_d, w_i, w_d in zip(_ids(got), _dists(got), want_i, want_d):
        if g_i == (w_i + 1).tolist():
            np.testing.assert_allclose(g_d, w_d, rtol=1e-4, atol=DIST_TOL)
    assert not set(sum(_ids(got), [])) & set((gone + 1).tolist())


@pytest.mark.parametrize("metric", [DistanceMetric.L2, DistanceMetric.COSINE])
@pytest.mark.parametrize("route", list(ROUTES))
def test_scan_copy_padded_to_tma_width(rng, metric, route):
    """dim = 20: the scan copy is made with zero columns up to whole 16-byte
    rows (the packed scans' TMA copies): 32 int8 or 24 bf16 columns. The
    fused route pads its queries to match, and so does the two-pass route
    below fused_min_cap, whose bf16 copy feeds flat_topk: ids and
    distances stay the JAX package's, also after a scattered update."""
    base = rng.standard_normal((2600, 20)).astype(np.float32)
    queries = rng.standard_normal((16, 20)).astype(np.float32)
    port = _flat(20, metric, **ROUTES[route])
    ref = JaxFlatIndex(dim=20, metric=metric, use_device=True)
    sp = SearchParams(top_k=10)
    for idx in (port, ref):
        idx.bulk_insert(list(range(1, 2001)), base[:2000])
    _assert_same_results(port.search_batch(queries, sp),
                         ref.search_batch(queries, sp))
    int8 = route == "fused_int8"
    assert port._dev["scan"].shape == (2048, 32 if int8 else 24)
    assert not port._dev["scan"][:, 20:].any()
    for idx in (port, ref):  # the capacity holds: a scatter of dirty rows
        idx.bulk_insert(list(range(2001, 2049)), base[2000:2048])
        assert idx.delete(5) is True
    _assert_same_results(port.search_batch(queries, sp),
                         ref.search_batch(queries, sp))
    assert port._dev["scan"].shape == (2048, 32 if int8 else 24)
    assert not port._dev["scan"][:, 20:].any()


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("query_dtype,tol", [("f16", 2e-3), ("int8", 2e-2)])
def test_narrow_query_dtypes(corpus, route, query_dtype, tol):
    """f16 / int8 query copies deviate by their input rounding only; the
    int8 form exists on the fused route alone."""
    base, queries = corpus
    idx = _flat(24, DistanceMetric.COSINE, query_dtype=query_dtype,
                **ROUTES[route])
    idx.bulk_insert(list(range(1, 3001)), base)
    got = idx.search_batch(queries, SearchParams(top_k=10))
    want_i, want_d = _oracle(queries, base, np.zeros(3000, bool), 2, 10)
    hits = sum(len(set(g) & set((w + 1).tolist()))
               for g, w in zip(_ids(got), want_i))
    assert hits / want_i.size >= 0.95
    for b, (g_i, g_d) in enumerate(zip(_ids(got), _dists(got))):
        ref = distance_np(queries[b : b + 1], base[np.asarray(g_i) - 1], 2)[0]
        np.testing.assert_allclose(g_d, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("tps", [1, 2, 4])
def test_scan_tps_groups_keep_recall(corpus, tps):
    base, queries = corpus
    idx = _flat(24, DistanceMetric.L2, fused_min_cap=1024, scan_tps=tps)
    idx.bulk_insert(list(range(1, 3001)), base)
    got = idx.search_batch(queries, SearchParams(top_k=10))
    want_i, _ = _oracle(queries, base, np.zeros(3000, bool), 1, 10)
    hits = sum(len(set(g) & set((w + 1).tolist()))
               for g, w in zip(_ids(got), want_i))
    assert hits / want_i.size >= 0.99


def test_constructor_contracts(monkeypatch, rng):
    with pytest.raises(ValueError, match="power of two"):
        _flat(8, scan_tps=3)
    with pytest.raises(ValueError, match="query_dtype"):
        _flat(8, query_dtype="f64")
    with pytest.raises(TypeError, match="fused_mincap"):
        _flat(8, fused_mincap=1024)  # a misspelt option is not swallowed
    idx = _flat(8, fused_min_cap=1024, scan_tps=8)
    idx.bulk_insert(list(range(1, 1500)), rng.standard_normal((1499, 8)))
    with pytest.raises(ValueError, match="does not divide"):  # 2 tiles
        idx.search(np.zeros(8), SearchParams(top_k=1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FlatIndex(dim=8)  # the default device is the card


def test_big_k_takes_the_exact_scan(corpus):
    """k > 128 leaves the fused route (a lane keeps two candidates)."""
    base, queries = corpus
    idx = _flat(24, DistanceMetric.L2, fused_min_cap=1024)
    idx.bulk_insert(list(range(1, 3001)), base)
    got = idx.search_batch(queries[:4], SearchParams(top_k=200))
    want_i, _ = _oracle(queries[:4], base, np.zeros(3000, bool), 1, 200)
    assert _ids(got) == (want_i + 1).tolist()


@pytest.mark.parametrize("use_device", [True, False], ids=["device", "host"])
def test_delete_and_tombstone_semantics(rng, use_device):
    base = rng.standard_normal((50, 8)).astype(np.float32)
    idx = _flat(8, use_device=use_device)
    idx.bulk_insert(list(range(1, 51)), base)
    assert idx.delete(7) is True
    assert idx.delete(7) is False  # double delete reports not-live
    assert not idx.contains(7) and idx.has_id(7) and idx.size() == 49
    with pytest.raises(ScintireteError):
        idx.get_vector(7)
    np.testing.assert_array_equal(idx.get_vector(8), base[7])
    res = idx.search(base[6], SearchParams(top_k=50))
    assert 7 not in [r[0] for r in res] and len(res) == 49
    with pytest.raises(ScintireteError) as exc:
        idx.delete(9999)
    assert exc.value.code == ErrorCode.VECTOR_NOT_FOUND


def test_duplicate_ids_rejected(rng):
    idx = _flat(4, use_device=False)
    idx.insert(1, [1, 0, 0, 0])
    with pytest.raises(ScintireteError):
        idx.insert(1, [0, 1, 0, 0])  # an id that exists
    with pytest.raises(ScintireteError) as exc:  # a repeat within one batch
        idx.bulk_insert([7, 7], rng.standard_normal((2, 4)).astype(np.float32))
    assert exc.value.code == ErrorCode.INVALID_PARAMETER
    assert idx.size() == 1  # nothing partially registered
    with pytest.raises(ScintireteError) as exc:
        idx.bulk_insert([9], np.zeros((1, 5), np.float32))
    assert exc.value.code == ErrorCode.DIMENSION_MISMATCH


@pytest.mark.parametrize("route", list(ROUTES))
def test_incremental_device_sync(rng, route):
    """Inserts and deletes after the first search are visible through the
    dirty-row scatter (the capacity stays 2048, so no full upload)."""
    idx = _flat(8, **ROUTES[route])
    base = rng.standard_normal((1100, 8)).astype(np.float32)
    idx.bulk_insert(list(range(1, 1101)), base)
    idx.search(base[0], SearchParams(top_k=1))  # forces the first sync
    mirror = idx._dev["vectors"]
    extra = rng.standard_normal((8,)).astype(np.float32)
    idx.insert(2000, extra)
    idx.delete(1)
    ids = [r[0] for r in idx.search(extra, SearchParams(top_k=100))]
    assert ids[0] == 2000 and 1 not in ids
    assert idx._dev["vectors"] is mirror  # scattered in place
    assert idx.search(base[0], SearchParams(top_k=1))[0][0] != 1


def test_failed_scatter_forces_full_upload(rng, monkeypatch):
    idx = _flat(8)
    base = rng.standard_normal((40, 8)).astype(np.float32)
    idx.bulk_insert(list(range(1, 41)), base)
    idx.search(base[0], SearchParams(top_k=1))
    extra = rng.standard_normal((8,)).astype(np.float32)
    idx.insert(41, extra)
    real_put = FlatIndex._put

    def broken(self, a, dtype=None):
        raise RuntimeError("copy failed")

    monkeypatch.setattr(FlatIndex, "_put", broken)
    with pytest.raises(RuntimeError, match="copy failed"):
        idx.search(extra, SearchParams(top_k=1))
    assert idx._dirty is None
    monkeypatch.setattr(FlatIndex, "_put", real_put)
    assert idx.search(extra, SearchParams(top_k=1))[0][0] == 41


def test_capacity_growth_reuploads(rng):
    idx = _flat(4)
    data = rng.standard_normal((600, 4)).astype(np.float32)
    idx.bulk_insert(list(range(1, 201)), data[:200])
    assert idx.cap == 256
    assert idx.search(data[199], SearchParams(top_k=1))[0][0] == 200
    idx.bulk_insert(list(range(201, 601)), data[200:])  # doubles twice
    assert idx.cap == 1024 and idx.size() == 600
    assert idx.search(data[599], SearchParams(top_k=1))[0][0] == 600
    assert idx._dev["vectors"].shape == (1024, 4)
    assert idx.stats().nodes == 600 and idx.memory_bytes() > 1024 * 16


def test_scan_copy_modes(rng):
    vecs = rng.standard_normal((300, 8)).astype(np.float32)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    ids = list(range(1, 301))
    slow = _flat(8, DistanceMetric.COSINE, fast_scan=False)
    fast = _flat(8, DistanceMetric.COSINE)
    half = _flat(8, DistanceMetric.COSINE, device_dtype="bfloat16")
    half_big = _flat(8, DistanceMetric.COSINE, device_dtype="bfloat16",
                     fused_min_cap=256)
    for idx in (slow, fast, half, half_big):
        idx.bulk_insert(ids, vecs)
    sp = SearchParams(top_k=5)
    rs, rf = slow.search_batch(q, sp), fast.search_batch(q, sp)
    half.search_batch(q, sp)
    rb = half_big.search_batch(q, sp)
    assert "scan" not in slow._dev and "scan" in fast._dev
    assert "scan_sq" in fast._dev  # cosine ranks with scan-form norms
    assert "scan" not in half._dev  # bf16 rows scan at the narrow rate already
    assert half_big._dev["scan"].dtype == torch.int8  # int8 + bf16 rerank
    assert half_big._dev["vectors"].dtype == torch.bfloat16
    _assert_same_results(rf, rs)
    # reranked on bf16-rounded rows: near neighbours may swap places
    assert [set(r) for r in _ids(rb)] == [set(r) for r in _ids(rs)]
    # rows past `count` are zero in the scan copy, with norm 0 and invalid
    assert not fast._dev["valid"][300:].any()
    assert not fast._dev["scan_sq"][300:].any()


def test_collect_after_delete_sees_submit_snapshot(rng):
    base = rng.standard_normal((300, 8)).astype(np.float32)
    idx = _flat(8)
    idx.bulk_insert(list(range(1, 301)), base)
    params = SearchParams(top_k=3)
    q = base[9:10]
    want = idx.search_batch(q, params)
    pending = idx.search_submit(q, params)
    assert idx.delete(10) is True  # id 10 == base[9], the top-1 hit
    got = idx.search_collect(pending)
    assert got == want and got[0][0][0] == 10
    assert idx.search_batch(q, params)[0][0][0] != 10


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("route", ["fused_int8", "rerank"])
def test_pipelined_matches_sequential(rng, depth, route):
    base = rng.standard_normal((1200, 16)).astype(np.float32)
    idx = _flat(16, DistanceMetric.COSINE, search_batch_size=20,
                **ROUTES[route])
    idx.bulk_insert(list(range(1, 1201)), base)
    for vid in (5, 100, 699):
        idx.delete(vid)
    params = SearchParams(top_k=7)
    batches = [rng.standard_normal((48, 16)).astype(np.float32)
               for _ in range(4)]
    want = [idx.search_batch(q, params) for q in batches]
    assert idx.search_batch_pipelined(batches, params, depth=depth) == want
    arrays = idx.search_batch_pipelined_arrays(batches, params, depth=depth)
    for (ids, dists), rows in zip(arrays, want):
        assert ids.tolist() == _ids(rows)
        np.testing.assert_array_equal(dists, np.float32(_dists(rows)))


@pytest.mark.parametrize("use_device", [True, False], ids=["device", "host"])
def test_arrays_collect_equals_tuple_collect(rng, use_device):
    base = rng.standard_normal((90, 8)).astype(np.float32)
    idx = _flat(8, use_device=use_device)
    idx.bulk_insert(list(range(1, 91)), base)
    idx.delete(3)
    q = rng.standard_normal((6, 8)).astype(np.float32)
    sp = SearchParams(top_k=4)
    tuples = idx.search_collect(idx.search_submit(q, sp))
    ids, dists = idx.search_collect_arrays(idx.search_submit(q, sp))
    assert ids.dtype == np.uint64 and dists.dtype == np.float32
    assert ids.tolist() == _ids(tuples)
    np.testing.assert_array_equal(dists, np.float32(_dists(tuples)))
    ids2, dists2 = idx.search_batch_arrays(q, sp)
    np.testing.assert_array_equal(ids2, ids)
    np.testing.assert_array_equal(dists2, dists)
    assert tuples == idx.search_batch(q, sp)


def test_empty_index_and_top_k_past_live(rng):
    idx = _flat(8)
    ref = JaxFlatIndex(dim=8, metric=DistanceMetric.L2)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    sp = SearchParams(top_k=5)
    assert idx.search_batch(q, sp) == ref.search_batch(q, sp) == [[], [], []]
    ids, dists = idx.search_batch_arrays(q, sp)
    assert ids.shape == (3, 0) and dists.shape == (3, 0)
    assert idx.search_collect(idx.search_submit(q, sp)) == [[], [], []]
    ids, dists = idx.search_collect_arrays(idx.search_submit(q, sp))
    assert ids.shape == (3, 0) and dists.shape == (3, 0)
    base = rng.standard_normal((4, 8)).astype(np.float32)
    for i in (idx, ref):
        i.bulk_insert([1, 2, 3, 4], base)
        i.delete(2)
    got = idx.search_batch(q, sp)  # top_k 5 > 3 live
    assert all(len(r) == 3 for r in got)
    _assert_same_results(got, ref.search_batch(q, sp))
    with pytest.raises(ScintireteError):
        idx.search_batch(np.zeros((2, 7), np.float32), sp)
    idx.set_ef_search(77)  # accepted for parity, no beam to set
    assert idx.params.ef_search == 77


@pytest.mark.parametrize("route", ["fused_int8", "rerank"])
def test_graph_state_crosses_both_ways(corpus, route):
    """The slice's state carried across: the JAX index's exported dict
    imports into the port's, and the port's back, with equal results."""
    base, queries = corpus
    ref = JaxFlatIndex(dim=24, metric=DistanceMetric.COSINE)
    ref.bulk_insert(list(range(1, 3001)), base)
    ref.delete(5)
    sp = SearchParams(top_k=7)
    state = ref.export_graph_state()
    port = FlatIndex.import_graph_state(state, device="cpu", **ROUTES[route])
    assert port.size() == 2999 and not port.contains(5) and port.has_id(5)
    want = ref.search_batch(queries, sp)
    _assert_same_results(port.search_batch(queries, sp), want)
    back = port.export_graph_state()
    assert set(back) == set(state)
    for key in state:
        a, b = state[key], back[key]
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, key
    again = JaxFlatIndex.import_graph_state(back)
    assert again.search_batch(queries, sp) == want


def _flat_config(cls=CollectionConfig):
    return cls(name="c", metric=DistanceMetric.L2, hnsw=HNSWParams(seed=3),
               index_type="flat")


def test_collection_state_crosses_both_ways(rng):
    data = rng.standard_normal((60, 8)).astype(np.float32)
    ref = JaxCollection(_flat_config(JaxCollectionConfig), use_device=True)
    ids = ref.insert([(v, {"i": i}) for i, v in enumerate(data)])
    ref.delete(ids[:3])
    port = Collection.from_state(ref.export_state(), device="cpu")
    assert isinstance(port._index, FlatIndex) and port.count() == 57
    assert port.config.index_type == "flat"
    sp = SearchParams(top_k=4)
    got = port.search_batch(data[10:14], sp)
    want = ref.search_batch(data[10:14], sp)
    assert [[h.id for h in r] for r in got] == [[h.id for h in r] for r in want]
    assert got[0][0].metadata == {"i": 10}
    again = JaxCollection.from_state(port.export_state(), use_device=True)
    assert again.count() == 57
    assert [[h.id for h in r] for r in again.search_batch(data[10:14], sp)] \
        == [[h.id for h in r] for r in want]
    assert port.insert([(data[0], None)]) == [61]  # next id survives


def test_engine_flat_collection_lifecycle(rng):
    engine = Engine(device="cpu", tpu_config=TPUConfig(search_batch_size=16))
    col = engine.create_database("db").create_collection(_flat_config())
    data = rng.standard_normal((70, 8)).astype(np.float32)
    ids = col.insert([(v, {"i": i}) for i, v in enumerate(data)])
    assert col.info().index_type == "flat"
    assert col._index.search_batch_size == 16 and col._index.fast_scan
    sp = SearchParams(top_k=3)
    assert [r[0].id for r in col.search_batch(data[:40], sp)] == ids[:40]
    arr_ids, _ = col.search_batch_arrays(data[:5], sp)
    assert arr_ids[:, 0].tolist() == ids[:5]
    assert col.delete([ids[0]]) == 1 and col.delete([ids[0]]) == 0
    assert col.count() == 69
    assert col.search(data[0], sp)[0].id != ids[0]
    assert col.compact() == 1 and col.count() == 69
    assert not col._index.has_id(ids[0])  # physically gone
    assert col.search(data[3], sp)[0].id == ids[3]
    engine2 = Engine(device="cpu", tpu_config=TPUConfig(flat_fast_scan=False))
    engine2.restore_state(engine.export_state())
    col2 = engine2.get_database("db").get_collection("c")
    assert isinstance(col2._index, FlatIndex) and col2.count() == 69
    assert not col2._index.fast_scan  # a restore honours the serving knobs
    assert col2.search(data[5], sp)[0].id == ids[5]
    assert col2.get(ids[5]).metadata == {"i": 5}
