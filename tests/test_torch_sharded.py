"""The port's sharded indexes against the JAX package's, on the CPU.

The JAX side runs `scintirete_tpu.parallel` on the 8-device CPU mesh that
`tests/conftest.py` forces (dp = 1); the port runs
`scintirete_tpu_torch.parallel` over a list of CPU devices (a device may
repeat). Both get the same numpy inputs from a seed. Shards of a hundred
or so rows build by host inserts in both packages, so their graphs must be
equal array for array. Ids must be equal wherever the reference ranking
has no near-tie, with distances within rtol = atol = 1e-5 (f32 sums in
another order), the tolerance the unsharded search is held to
(`tests/test_torch_search.py`).

Not mirrored from `tests/test_parallel.py`: the dp-axis tests, the pow-2
padding test and the f16 query upload, workarounds the port drops, and
the descent entry, the pipelined loops and the flat bf16 copy, options
the sharded port leaves out because no caller sets them.
"""

import numpy as np
import pytest

from scintirete_tpu.config import TPUConfig as JaxTPUConfig
from scintirete_tpu.engine import Collection as JaxCollection
from scintirete_tpu.parallel import ShardedFlatIndex as JaxShardedFlat
from scintirete_tpu.parallel import ShardedHNSWIndex as JaxShardedHNSW
from scintirete_tpu.parallel import make_default_mesh as jax_mesh
from scintirete_tpu.types import CollectionConfig as JaxCollectionConfig
from scintirete_tpu.types import DistanceMetric as JaxMetric
from scintirete_tpu.types import HNSWParams as JaxHNSWParams
from scintirete_tpu.types import SearchParams as JaxSearchParams
from scintirete_tpu_torch.config import TPUConfig
from scintirete_tpu_torch.engine import Collection, Engine
from scintirete_tpu_torch.index.flat import FlatIndex
from scintirete_tpu_torch.index.hnsw import HNSWIndex
from scintirete_tpu_torch.ops.distance import distance_np
from scintirete_tpu_torch.parallel import (
    CPU_SHARD_DEVICES,
    ShardedFlatIndex,
    ShardedHNSWIndex,
    make_default_mesh,
)
from scintirete_tpu_torch.types import (
    CollectionConfig,
    DistanceMetric,
    HNSWParams,
    SearchParams,
)

N, D, NQ, K, S = 240, 16, 24, 10, 4
TOL = dict(rtol=1e-5, atol=1e-5)
PARAMS = dict(m=8, ef_construction=40, ef_search=12, seed=3,
              neighbor_heuristic=True)


def _untied(d, rel=1e-5):
    """Rows whose distances have no two neighbours within `rel`."""
    d = np.asarray(d, np.float64)
    with np.errstate(invalid="ignore"):  # inf - inf past the last hit
        gap = np.diff(d, axis=1)
    fin = np.isfinite(d[:, 1:])
    return np.all(~fin | (gap > rel * np.maximum(1.0, np.abs(d[:, 1:]))),
                  axis=1)


def _arrays(results, k=K):
    """[(id, dist)] lists -> (ids [B, k] i64, dists [B, k] f64), 0 / inf
    padded."""
    ids = np.zeros((len(results), k), np.int64)
    dists = np.full((len(results), k), np.inf)
    for b, row in enumerate(results):
        for j, (vid, dist) in enumerate(row):
            ids[b, j], dists[b, j] = vid, dist
    return ids, dists


def _assert_same_answers(got, want, min_untied=0.9):
    got_i, got_d = _arrays(got)
    want_i, want_d = _arrays(want)
    rows = _untied(want_d)
    assert rows.mean() >= min_untied
    np.testing.assert_array_equal(got_i[rows], want_i[rows])
    fin = np.isfinite(want_d)
    assert np.array_equal(np.isfinite(got_d), fin)
    np.testing.assert_allclose(got_d[fin], want_d[fin], **TOL)


def _recall(results, base, queries, metric, ids_of_rows):
    want = distance_np(queries, base, metric)
    hits = 0
    for b, row in enumerate(results):
        true = {ids_of_rows[i] for i in np.argsort(want[b], kind="stable")[:K]}
        hits += len(true & {vid for vid, _ in row})
    return hits / (K * len(results))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((12, D)).astype(np.float32) * 2.0
    base = (centers[rng.integers(0, 12, N)]
            + 0.5 * rng.standard_normal((N, D))).astype(np.float32)
    queries = (base[rng.integers(0, N, NQ)]
               + 0.2 * rng.standard_normal((NQ, D))).astype(np.float32)
    return base, queries


@pytest.fixture(scope="module")
def built(data):
    """The same 4-shard cosine collection built by both packages."""
    base, _ = data
    ids = list(range(1, N + 1))
    jax_idx = JaxShardedHNSW(D, JaxHNSWParams(**PARAMS), JaxMetric.COSINE,
                             mesh=jax_mesh(S))
    jax_idx.bulk_insert(ids, base)
    port = ShardedHNSWIndex(D, HNSWParams(**PARAMS), DistanceMetric.COSINE,
                            devices=make_default_mesh(S, "cpu"))
    port.bulk_insert(ids, base)
    return port, jax_idx


def _fresh(n=200, dim=12, seed=2, shards=S, metric=DistanceMetric.L2):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    idx = ShardedHNSWIndex(
        dim, HNSWParams(m=8, ef_construction=40, ef_search=40, seed=seed),
        metric, devices=make_default_mesh(shards, "cpu"),
    )
    idx.bulk_insert(list(range(1, n + 1)), vecs)
    return idx, vecs


# ----- the device list and the shard-count rule -----


def test_the_cpu_shard_count_stands_for_the_jax_host_platform():
    import jax

    assert CPU_SHARD_DEVICES == len(jax.devices()) == 8
    assert len(make_default_mesh(device="cpu")) == 8
    assert make_default_mesh(3, "cpu") == [make_default_mesh(1, "cpu")[0]] * 3
    with pytest.raises(ValueError, match="9 shard devices"):
        make_default_mesh(9, "cpu")


@pytest.mark.parametrize("shard_devices", [1, 2, 4, 16])
def test_collections_shard_as_the_jax_engine_does(shard_devices):
    port = Collection(CollectionConfig(name="c"),
                      tpu_config=TPUConfig(shard_devices=shard_devices),
                      device="cpu")
    ref = JaxCollection(JaxCollectionConfig(name="c"),
                        tpu_config=JaxTPUConfig(shard_devices=shard_devices))
    assert port._shard_count() == ref._shard_count()
    port._ensure_index(D)
    ref._ensure_index(D)
    assert type(port._index).__name__ == type(ref._index).__name__
    assert getattr(port._index, "S", 1) == getattr(ref._index, "S", 1)
    # neither shards a host-only collection
    host = Collection(CollectionConfig(name="h"), use_device=False,
                      tpu_config=TPUConfig(shard_devices=shard_devices),
                      device="cpu")
    assert isinstance(host._ensure_index(D), HNSWIndex)


def test_flat_collections_are_never_sharded(data):
    base, _ = data
    col = Engine(device="cpu", tpu_config=TPUConfig(shard_devices=2)) \
        .create_database("d").create_collection(
            CollectionConfig(name="f", index_type="flat"))
    col.insert([(v, None) for v in base[:64]])
    assert isinstance(col._index, FlatIndex)
    assert col.search(base[7], SearchParams(top_k=1))[0].id == 8


# ----- the sharded HNSW index -----


def test_shard_graphs_equal_the_jax_shards(built):
    port, jax_idx = built
    got, want = port.export_graph_state(), jax_idx.export_graph_state()
    assert got["sharded"] is want["sharded"] is True
    assert (got["dim"], got["metric"]) == (want["dim"], want["metric"])
    assert len(got["shards"]) == len(want["shards"]) == S
    for g, w in zip(got["shards"], want["shards"]):
        assert g["params"] == w["params"]
        for key in ("count", "live", "entry_slot", "max_layer"):
            assert g[key] == w[key]
        for key in ("vectors", "levels", "deleted", "neighbors0",
                    "slot_to_id"):
            np.testing.assert_array_equal(g[key], w[key])
        assert len(g["layers"]) == len(w["layers"])
        for gl, wl in zip(g["layers"], w["layers"]):
            np.testing.assert_array_equal(gl["node_slot"], wl["node_slot"])
            np.testing.assert_array_equal(gl["nbrs"], wl["nbrs"])


@pytest.mark.parametrize("top_k", [K, 5, 3, 1])
def test_search_matches_jax(built, data, top_k):
    _, queries = data
    port, jax_idx = built
    got = port.search_batch(queries, SearchParams(top_k=top_k))
    want = jax_idx.search_batch(queries, JaxSearchParams(top_k=top_k))
    assert all(len(r) == top_k for r in got)
    _assert_same_answers(got, want)


def test_recall_at_least_jax(built, data):
    base, queries = data
    port, jax_idx = built
    sp = SearchParams(top_k=K)
    ids = list(range(1, N + 1))
    got = _recall(port.search_batch(queries, sp), base, queries, 2, ids)
    want = _recall(jax_idx.search_batch(queries, JaxSearchParams(top_k=K)),
                   base, queries, 2, ids)
    assert got >= want >= 0.9


def test_empty_shards_add_no_hits_where_jax_returns_id_0():
    """With fewer rows than shards, a shard with no rows has nothing to
    return. The port searches only shards that hold live rows and answers
    as the numpy oracle does; the JAX package searches every shard, and an
    empty one's zero row comes back as id 0, an id never assigned (a
    recorded departure, ROADMAP.md Queue 3)."""
    vecs = np.random.default_rng(0).standard_normal((2, 8)).astype(np.float32)
    port = ShardedHNSWIndex(8, HNSWParams(m=8, seed=1), DistanceMetric.L2,
                            devices=make_default_mesh(S, "cpu"))
    port.bulk_insert([1, 2], vecs)
    ref = JaxShardedHNSW(8, JaxHNSWParams(m=8, seed=1), JaxMetric.L2,
                         mesh=jax_mesh(S))
    ref.bulk_insert([1, 2], vecs)
    got = port.search_batch(vecs[:1], SearchParams(top_k=5))[0]
    oracle = distance_np(vecs[:1], vecs, DistanceMetric.L2)[0]
    assert [vid for vid, _ in got] == [1, 2]
    np.testing.assert_allclose([d for _, d in got], oracle, **TOL)
    want = ref.search_batch(vecs[:1], JaxSearchParams(top_k=5))[0]
    assert 0 in {vid for vid, _ in want}


def test_submit_collect_matches_plain(built, data):
    _, queries = data
    port, _ = built
    sp = SearchParams(top_k=4, ef_search=32)
    batches = [queries[i : i + 6] for i in range(0, NQ, 6)]
    plain = [port.search_batch(b, sp) for b in batches]
    # submitted together, collected afterwards in order
    payloads = [port.search_submit(b, sp) for b in batches]
    assert [port.search_collect(p) for p in payloads] == plain


def test_deletes_across_shards_and_sorted_results():
    port, vecs = _fresh(n=40, dim=8, seed=2)
    jax_idx = JaxShardedHNSW(
        8, JaxHNSWParams(m=8, ef_construction=40, ef_search=40, seed=2),
        JaxMetric.L2, mesh=jax_mesh(S),
    )
    jax_idx.bulk_insert(list(range(1, 41)), vecs)
    gone = (1, 2, 3, 9, 17)
    owners = {port._id_shard[v] for v in gone}
    assert len(owners) > 1
    for vid in gone:
        assert port.delete(vid)
        jax_idx.delete(vid)
    assert not port.delete(1)  # already a tombstone
    assert port.size() == 35 and not port.contains(9) and port.has_id(9)
    res = port.search_batch(vecs[:4], SearchParams(top_k=5))
    for r in res:
        assert not set(gone) & {x[0] for x in r}
        dists = [x[1] for x in r]
        assert dists == sorted(dists)
    want = jax_idx.search_batch(vecs[:4], JaxSearchParams(top_k=5))
    assert [[x[0] for x in r] for r in res] == [[x[0] for x in r] for r in want]
    with pytest.raises(Exception, match="vector not found"):
        port.get_vector(999)


def test_insert_into_one_shard_resyncs_only_that_shard():
    port, vecs = _fresh(n=200, dim=16, seed=3)
    sp = SearchParams(top_k=3)
    port.search_batch(vecs[:2], sp)  # every shard's first upload
    mirrors = [sub._get_device().graph for sub in port.subs]
    before = [(g._version, dict(g.arrays)) for g in mirrors]
    full_uploads = []
    for g in mirrors:
        real = g._full_upload
        g._full_upload = (lambda real: lambda store: (
            full_uploads.append(1), real(store)))(real)
    target = port._insert_cursor % port.S
    new = np.random.default_rng(9).standard_normal((1, 16)).astype(np.float32)
    port.bulk_insert([1001], new)
    assert port._id_shard[1001] == target
    res = port.search_batch(new, SearchParams(top_k=1))
    assert res[0][0][0] == 1001
    assert not full_uploads, "one insert must sync by dirty-row scatter"
    for j, (g, (version, arrays)) in enumerate(zip(mirrors, before)):
        assert (g._version != version) == (j == target)
        if j != target:
            assert all(g.arrays[k] is arrays[k] for k in arrays)


def test_submit_payload_keeps_its_ids_across_delete_and_insert():
    """Copy on write of the slot -> id table: a payload taken before a
    delete and an insert into its shards decodes the ids it found."""
    port, vecs = _fresh(n=200, dim=16, seed=4)
    sp = SearchParams(top_k=5)
    want = port.search_batch(vecs[:8], sp)
    payload = port.search_submit(vecs[:8], sp)
    table = payload[3].copy()
    hit = want[0][0][0]
    port.delete(hit)
    port.bulk_insert(list(range(2001, 2001 + S)),
                     vecs[:S] + np.float32(1e-3))
    after = port.search_batch(vecs[:8], sp)  # refreshes the table
    assert hit not in {vid for vid, _ in after[0]}
    assert port._slot_ids is not payload[3]
    np.testing.assert_array_equal(payload[3], table)
    assert port.search_collect(payload) == want


def test_restore_on_another_shard_count_reshards_as_jax_does():
    port, vecs = _fresh(n=200, dim=12, seed=2)
    port.delete(7)
    state = port.export_graph_state()
    params = HNSWParams(m=8, ef_construction=40, ef_search=40, seed=2)
    back = ShardedHNSWIndex.import_graph_state(
        state, params=params, devices=make_default_mesh(2, "cpu"))
    assert back.S == 2 and back.size() == 199 and not back.contains(7)
    assert not back.has_id(7)
    res = back.search_batch(vecs[:4], SearchParams(top_k=3))
    assert [r[0][0] for r in res] == [1, 2, 3, 4]
    # the JAX package re-shards the same state into the same graphs
    ref = JaxShardedHNSW.import_graph_state(
        state, params=JaxHNSWParams(m=8, ef_construction=40, ef_search=40,
                                    seed=2),
        mesh=jax_mesh(2))
    for g, w in zip(back.export_graph_state()["shards"],
                    ref.export_graph_state()["shards"]):
        np.testing.assert_array_equal(g["slot_to_id"], w["slot_to_id"])
        np.testing.assert_array_equal(g["neighbors0"], w["neighbors0"])
    # at the same shard count the state comes back without a rebuild
    same = ShardedHNSWIndex.import_graph_state(
        state, devices=make_default_mesh(S, "cpu"))
    for g, w in zip(same.export_graph_state()["shards"], state["shards"]):
        np.testing.assert_array_equal(g["neighbors0"], w["neighbors0"])
    assert same.search_batch(vecs[:4], SearchParams(top_k=3)) == \
        port.search_batch(vecs[:4], SearchParams(top_k=3))


# ----- the engine -----


def _port_collection(shards=S, metric=DistanceMetric.L2):
    return Collection(
        CollectionConfig(name="c", metric=metric, hnsw=HNSWParams(
            m=8, ef_construction=60, ef_search=60, seed=9,
            neighbor_heuristic=True)),
        tpu_config=TPUConfig(shard_devices=shards), device="cpu",
    )


def _jax_collection(shards=S, metric=JaxMetric.L2):
    return JaxCollection(
        JaxCollectionConfig(name="c", metric=metric, hnsw=JaxHNSWParams(
            m=8, ef_construction=60, ef_search=60, seed=9,
            neighbor_heuristic=True)),
        tpu_config=JaxTPUConfig(shard_devices=shards),
    )


def test_sharded_collection_inserts_searches_deletes_and_compacts():
    rng = np.random.default_rng(0)
    col = _port_collection()
    vecs = rng.standard_normal((160, 16)).astype(np.float32)
    ids = col.insert([(v, {"i": i}) for i, v in enumerate(vecs)])
    assert isinstance(col._index, ShardedHNSWIndex) and col._index.S == 4
    assert col.count() == 160
    res = col.search_batch(vecs[:4], SearchParams(top_k=5))
    assert [r[0].id for r in res] == ids[:4]
    assert res[0][0].metadata == {"i": 0}
    assert col.get(ids[5]).elements == pytest.approx(vecs[5].tolist())
    assert col.delete(ids[:10]) == 10 and col.count() == 150
    assert ids[0] not in [r.id for r in col.search(vecs[0], SearchParams(top_k=5))]
    state = col.export_state()
    assert state["graph"]["sharded"] is True
    back = Collection.from_state(state, tpu_config=TPUConfig(shard_devices=4),
                                 device="cpu")
    assert isinstance(back._index, ShardedHNSWIndex) and back._index.S == 4
    assert back.count() == 150
    sp = SearchParams(top_k=5)
    assert [x.id for x in back.search(vecs[7], sp)] == \
        [x.id for x in col.search(vecs[7], sp)]
    assert col.compact() == 10 and col.count() == 150
    assert isinstance(col._index, ShardedHNSWIndex)
    assert col.search(vecs[11], SearchParams(top_k=3))[0].id == ids[11]


@pytest.fixture(scope="module")
def collections(data):
    """The same 4-shard cosine collection in both engines, 3 ids deleted."""
    base, _ = data
    port = _port_collection(metric=DistanceMetric.COSINE)
    ref = _jax_collection(metric=JaxMetric.COSINE)
    rows = base[:160]
    assert port.insert([(v, {"i": i}) for i, v in enumerate(rows)]) == \
        ref.insert([(v, {"i": i}) for i, v in enumerate(rows)])
    for col in (port, ref):
        col.delete([3, 4, 5])
    return port, ref


def test_batch_search_arrays_equal_the_jax_engines(data, collections):
    _, queries = data
    port, ref = collections
    sp = dict(top_k=K, ef_search=12)
    got_i, got_d = port.search_batch_arrays(queries, SearchParams(**sp))
    want_i, want_d = ref.search_batch_arrays(queries, JaxSearchParams(**sp))
    assert got_i.shape == want_i.shape == (NQ, K)
    assert got_i.dtype == want_i.dtype == np.uint64
    rows = _untied(want_d)
    np.testing.assert_array_equal(got_i[rows], want_i[rows])
    np.testing.assert_allclose(got_d, want_d, **TOL)


def test_sharded_states_cross_between_the_packages(data, collections):
    _, queries = data
    port, ref = collections
    sp, jsp = SearchParams(top_k=K), JaxSearchParams(top_k=K)

    def answers(col, params):
        return [[(h.id, h.distance) for h in r]
                for r in col.search_batch(queries, params)]

    # JAX-written state -> the port, and the port's -> JAX
    from_jax = Collection.from_state(ref.export_state(),
                                     tpu_config=TPUConfig(shard_devices=4),
                                     device="cpu")
    from_port = JaxCollection.from_state(
        port.export_state(), tpu_config=JaxTPUConfig(shard_devices=4))
    assert from_jax._index.S == from_port._index.S == 4
    assert from_jax.get(12).metadata == {"i": 11}
    assert from_jax.count() == from_port.count() == 157
    _assert_same_answers(answers(from_jax, sp), answers(ref, jsp))
    _assert_same_answers(answers(from_port, jsp), answers(port, sp))
    # with no shard count configured, both restore over every device
    assert Collection.from_state(ref.export_state(), device="cpu")._index.S \
        == JaxCollection.from_state(ref.export_state())._index.S \
        == CPU_SHARD_DEVICES


def test_sharded_snapshot_recovers_and_the_admin_tool_sums_its_shards(
    data, tmp_path
):
    from scintirete_tpu_torch.cli.admin_main import _memstat
    from scintirete_tpu_torch.persistence import PersistenceManager
    from scintirete_tpu_torch.persistence.rdb import RDBManager

    base, queries = data
    tpu = TPUConfig(shard_devices=2)
    live = Engine(device="cpu", tpu_config=tpu)
    pm = PersistenceManager(live, str(tmp_path))
    col = live.create_database("d").create_collection(
        CollectionConfig(name="c", hnsw=HNSWParams(**PARAMS)))
    col.insert([(v, None) for v in base[:120]])
    col.delete([5])
    pm.save_snapshot()
    pm.stop()
    state = RDBManager(str(tmp_path / "vector.rdb")).load()
    graph = state["databases"]["d"]["collections"]["c"]["graph"]
    assert graph["sharded"] is True and len(graph["shards"]) == 2
    stat = _memstat(state)["databases"]["d"]["c"]
    assert (stat["shards"], stat["count"], stat["live"]) == (2, 120, 119)
    back = Engine(device="cpu", tpu_config=tpu)
    pm = PersistenceManager(back, str(tmp_path))
    assert pm.recover()["rdb_loaded"]
    pm.stop()
    rec = back.get_database("d").get_collection("c")
    assert isinstance(rec._index, ShardedHNSWIndex) and rec.count() == 119
    sp = SearchParams(top_k=K)
    assert [[h.id for h in r] for r in rec.search_batch(queries, sp)] == \
        [[h.id for h in r] for r in col.search_batch(queries, sp)]


# ----- the sharded flat index -----


@pytest.mark.parametrize("metric", [1, 2, 3])
def test_sharded_flat_is_exact_and_matches_jax(metric):
    rng = np.random.default_rng(metric)
    vecs = rng.standard_normal((200, 16)).astype(np.float32)
    queries = rng.standard_normal((6, 16)).astype(np.float32)
    ids = list(range(100, 300))
    port = ShardedFlatIndex(16, metric, devices=make_default_mesh(8, "cpu"))
    port.build(ids, vecs)
    ref = JaxShardedFlat(16, metric, mesh=jax_mesh(8))
    ref.build(ids, vecs)
    res = port.search(queries, k=5)
    want = distance_np(queries, vecs, metric)
    for b in range(6):
        order = np.argsort(want[b], kind="stable")[:5]
        assert [r[0] for r in res[b]] == [ids[i] for i in order]
        np.testing.assert_allclose([r[1] for r in res[b]], want[b][order],
                                   rtol=1e-4, atol=1e-4)
    _assert_same_answers([[(v, d) for v, d in r] for r in res],
                         ref.search(queries, k=5), min_untied=1.0)
    # k past a shard's rows pads each shard's list, as the JAX index does
    big = port.search(queries[:2], k=40)
    assert [len(r) for r in big] == [40, 40]
    assert [r[0] for r in big[0]] == [r[0] for r in ref.search(queries[:2], k=40)[0]]


@pytest.mark.parametrize("metric", [DistanceMetric.L2, DistanceMetric.COSINE])
def test_sharded_flat_submit_collect(metric):
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    idx = ShardedFlatIndex(16, metric, devices=make_default_mesh(4, "cpu"))
    idx.build(list(range(300)), vecs)
    batches = [vecs[i * 6 : (i + 1) * 6] for i in range(4)]
    plain = [idx.search(b, k=4) for b in batches]
    payloads = [idx.search_submit(b, 4) for b in batches]
    assert [idx.search_collect(p) for p in payloads] == plain
    assert [r[0][0] for r in plain[0]] == list(range(6))
