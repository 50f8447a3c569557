"""The port's bulk build against the JAX package's, and the engine surface.

Both packages build the same 3000-vector cosine collection from one seed;
the JAX side takes its fused bf16 path (Pallas lane scan in interpret
mode), which is the path the port always takes. Levels, entry point and
layer membership come from the seeded numpy streams and must be equal.
Neighbor lists may differ where bf16 scores tie or f32 sums round
differently, so they are held to a per-layer overlap and to recall.
"""

import numpy as np
import pytest

from scintirete_tpu.index import HNSWIndex as JaxHNSWIndex
from scintirete_tpu.types import (
    CollectionConfig,
    DistanceMetric,
    HNSWParams,
    SearchParams,
)
from scintirete_tpu_torch.config import TPUConfig
from scintirete_tpu_torch.engine import Engine
from scintirete_tpu_torch.index.hnsw import HNSWIndex
from scintirete_tpu_torch.ops.distance import distance_np

N, D, NQ, K = 3000, 16, 200, 10
PARAMS = HNSWParams(m=8, ef_construction=64, ef_search=12, seed=11,
                    neighbor_heuristic=True)
# mean share of the JAX build's neighbors that the port's build also has,
# per layer. Measured on this corpus: 0.99996 at layer 0 and 1.0 on every
# upper layer (bf16 images agree; only f32 sum-order near-ties differ);
# asserted with a margin
OVERLAP_MIN = 0.97


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((30, D)).astype(np.float32) * 2.0
    base = (centers[rng.integers(0, 30, N)]
            + 0.4 * rng.standard_normal((N, D))).astype(np.float32)
    queries = (base[rng.integers(0, N, NQ)]
               + 0.2 * rng.standard_normal((NQ, D))).astype(np.float32)
    return base, queries


@pytest.fixture(scope="module")
def built(data):
    base, _ = data
    port = HNSWIndex(D, PARAMS, DistanceMetric.COSINE, device="cpu")
    port.bulk_insert(list(range(1, N + 1)), base)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCNT_BUILD_INTERPRET", "1")
        mp.setenv("SCNT_BUILD_SCAN_DTYPE", "bfloat16")
        jax_idx = JaxHNSWIndex(D, PARAMS, DistanceMetric.COSINE)
        jax_idx.bulk_insert(list(range(1, N + 1)), base)
    return port, jax_idx


def _truth(base, queries):
    d = distance_np(queries, base, DistanceMetric.COSINE)
    return np.argsort(d, axis=1, kind="stable")[:, :K] + 1


def _recall(results, truth):
    return np.mean([
        len({vid for vid, _ in r} & set(t.tolist())) / K
        for r, t in zip(results, truth)
    ])


def test_same_levels_entry_and_membership(built):
    port, jax_idx = built
    ps, js = port.store, jax_idx.store
    np.testing.assert_array_equal(ps.levels[:N], js.levels[:N])
    assert ps.entry_slot == js.entry_slot and ps.max_layer == js.max_layer
    assert len(ps.layers) == len(js.layers)
    for pl, jl in zip(ps.layers, js.layers):
        assert pl.count == jl.count
        np.testing.assert_array_equal(
            pl.node_slot[: pl.count], jl.node_slot[: jl.count]
        )
        np.testing.assert_array_equal(pl.row_of[:N], jl.row_of[:N])


def _overlap(a, b):
    shares = []
    for ra, rb in zip(a, b):
        want = set(rb[rb >= 0].tolist())
        if want:
            shares.append(len(set(ra[ra >= 0].tolist()) & want) / len(want))
    return float(np.mean(shares)) if shares else 1.0  # edgeless top layer


def test_neighbor_overlap_per_layer(built):
    port, jax_idx = built
    ps, js = port.store, jax_idx.store
    shares = [_overlap(ps.neighbors0[:N], js.neighbors0[:N])] + [
        _overlap(pl.nbrs[: pl.count], jl.nbrs[: jl.count])
        for pl, jl in zip(ps.layers, js.layers)
    ]
    print("per-layer neighbor overlap with the JAX build:", shares)
    assert min(shares) >= OVERLAP_MIN, shares


def test_graph_invariants(built):
    port, _ = built
    s = port.store
    nb = s.neighbors0[:N]
    assert nb.shape[1] == s.m0 and nb.max() < N and nb.min() >= -1
    assert (nb >= 0).sum(axis=1).min() >= 1
    for slot, row in enumerate(nb):
        live = row[row >= 0]
        assert slot not in live and len(set(live.tolist())) == len(live)
        # -1 padding only at the tail
        assert np.all(row[len(live):] == -1)
    for layer, ls in enumerate(s.layers, start=1):
        for r in range(ls.count):
            slot = ls.node_slot[r]
            live = ls.nbrs[r][ls.nbrs[r] >= 0]
            assert slot not in live and len(set(live.tolist())) == len(live)
            assert np.all(ls.row_of[live] >= 0), f"non-member at layer {layer}"
            assert np.all(s.levels[live] >= layer)


def test_recall_and_state_crosses_to_jax(built, data):
    base, queries = data
    port, jax_idx = built
    truth = _truth(base, queries)
    sp = SearchParams(top_k=K, ef_search=12)
    port_rec = _recall(port.search_batch(queries, sp), truth)
    # the JAX-built graph, searched by the same (port) search
    jax_graph = HNSWIndex.import_graph_state(
        jax_idx.export_graph_state(), device="cpu"
    )
    jax_rec = _recall(jax_graph.search_batch(queries, sp), truth)
    assert port_rec >= jax_rec - 0.01
    assert port_rec >= 0.95
    # the port-built graph loads in the JAX package and searches there
    back = JaxHNSWIndex.import_graph_state(port.export_graph_state())
    assert _recall(back.search_batch(queries, sp), truth) >= port_rec - 0.01


def test_unported_paths_raise_before_mutation(built, data):
    """What the port still leaves out raises NotImplementedError naming
    ROADMAP.md, before it changes anything: the descent search entry mode,
    refine_rounds > 0, sharding and AOF replay. The flat index is ported:
    a flat collection is created."""
    base, _ = data
    port, _ = built
    before = port.export_graph_state()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port._get_device().search(port.store, base[:4], K, 12,
                                  entry_mode="descent")
    after = port.export_graph_state()
    assert after["count"] == before["count"]
    np.testing.assert_array_equal(after["neighbors0"], before["neighbors0"])
    assert port.size() == N

    refine = HNSWIndex(D, HNSWParams(seed=1, refine_rounds=1),
                       DistanceMetric.COSINE, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        refine.bulk_insert(list(range(1, N + 1)), base)
    assert refine.store.count == 0 and refine.size() == 0

    engine = Engine(device="cpu")
    db = engine.create_database("db")
    flat = db.create_collection(CollectionConfig(name="f", index_type="flat"))
    assert flat.info().index_type == "flat"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(device="cpu", tpu_config=TPUConfig(shard_devices=2)) \
            .create_database("x").create_collection(CollectionConfig(name="s"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.apply_command({"command_type": "CREATE_DATABASE"})
    assert db.list_collections() == ["f"] and engine.list_databases() == ["db"]


def test_engine_surface_on_cpu(data):
    base, queries = data
    engine = Engine(device="cpu")
    db = engine.create_database("db")
    # few vectors, narrow beams: the host insert path is the slow one here
    col = db.create_collection(CollectionConfig(
        name="c", metric=DistanceMetric.COSINE,
        hnsw=HNSWParams(m=8, ef_construction=24, seed=11,
                        neighbor_heuristic=True),
    ))
    vecs = base[:120]
    ids = col.insert([(v, {"i": i}) for i, v in enumerate(vecs)])
    assert ids == list(range(1, 121)) and col.count() == 120
    sp = SearchParams(top_k=5)
    hit = col.search(vecs[17], sp)[0]
    assert hit.id == 18 and hit.metadata == {"i": 17} and hit.distance < 1e-5
    assert col.delete([18, 19, 999]) == 2
    res = col.search_batch(vecs[15:20], sp)
    assert all(h.id not in (18, 19) for r in res for h in r)
    assert col.compact() == 2 and col.count() == 118
    assert col.search(vecs[17], sp)[0].id != 18
    assert col.get(20).elements == pytest.approx(vecs[19].tolist())
    snap = engine.export_state()
    engine2 = Engine(device="cpu")
    engine2.restore_state(snap)
    col2 = engine2.get_database("db").get_collection("c")
    assert [h.id for h in col2.search(vecs[30], sp)] == [
        h.id for h in col.search(vecs[30], sp)
    ]
    assert engine.stats()["vectors"] == 118
    flat = db.create_collection(CollectionConfig(name="f", index_type="flat"))
    flat.insert([(v, None) for v in vecs[:40]])
    assert flat.search(vecs[7], sp)[0].id == 8
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(device="cpu", tpu_config=TPUConfig(shard_devices=2)) \
            .create_database("x").create_collection(CollectionConfig(name="s"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.apply_command({"command_type": "CREATE_DATABASE"})
    assert db.list_collections() == ["c", "f"]
