"""The port's descent search entry: its mid-layer table and its arguments.

The parity of the four descent modes with the JAX package's (3 metrics,
before and after tombstones) is in tests/test_torch_search.py, on that
file's JAX-built graph. This file holds the mid table's refresh rules
(`tests/test_hnsw.py`'s TestMidLayerEntry: a cap change on a synced
mirror, tombstones, an insert that grows the mid layer) and the routing of
HNSWIndex's search arguments, on one graph the port builds (2100 x 16,
cosine) with a mid-layer cap of 256 members (the module constant
`device.MID_CAP`, set for each test).
"""

import numpy as np
import pytest

from scintirete_tpu_torch.index import device as dmod
from scintirete_tpu_torch.index.device import mid_layer_host
from scintirete_tpu_torch.index.hnsw import HNSWIndex
from scintirete_tpu_torch.types import DistanceMetric, HNSWParams, SearchParams

N, D, NQ, K, EF = 2100, 16, 64, 10, 24
MID_CAP = 256


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    centers = rng.standard_normal((40, D)).astype(np.float32) * 2.0
    base = (centers[rng.integers(0, 40, N)]
            + 0.4 * rng.standard_normal((N, D))).astype(np.float32)
    queries = (base[rng.integers(0, N, NQ)]
               + 0.2 * rng.standard_normal((NQ, D))).astype(np.float32)
    return base, queries


@pytest.fixture(autouse=True)
def mid_cap(monkeypatch):
    monkeypatch.setattr(dmod, "MID_CAP", MID_CAP)


@pytest.fixture(scope="module")
def state(data):
    base, _ = data
    idx = HNSWIndex(D, HNSWParams(m=8, ef_construction=32, ef_search=EF,
                                  seed=3, neighbor_heuristic=True),
                    DistanceMetric.COSINE, device="cpu")
    idx.bulk_insert(list(range(1, N + 1)), base)
    return idx.export_graph_state()


def test_entry_mode_arguments_route_the_index(data, state):
    """HNSWIndex's entry_mode / ef_upper / descent_mid reach the device
    search, and a bad entry mode raises before anything runs."""
    _, queries = data
    port = HNSWIndex.import_graph_state(state, device="cpu",
                                        entry_mode="descent", ef_upper=4)
    sp = SearchParams(top_k=K, ef_search=EF)
    got = port.search_batch_arrays(queries, sp)[0]
    want_s, _ = port._get_device().search(
        port.store, queries, K, EF, entry_mode="descent", ef_upper=4,
    )
    np.testing.assert_array_equal(got, port.slot_to_id[want_s])
    steps = port._get_device().steps
    assert steps["batches"] >= 1 and steps["upper"] > 0
    with pytest.raises(ValueError, match="entry_mode"):
        port._get_device().search(port.store, queries, K, EF,
                                  entry_mode="walk")
    with pytest.raises(ValueError, match="entry_mode"):
        HNSWIndex(D, device="cpu", entry_mode="walk")


def test_mid_cap_change_refreshes_table(state, monkeypatch):
    """A cap changed on an already-synced mirror re-derives the mid table
    at the next search, with no store change (test_hnsw.py's
    test_mid_cap_change_refreshes_table). The table is built only at the
    first mid-entry search: pivot searches never hold it."""
    port = HNSWIndex.import_graph_state(state, device="cpu")
    dev = port._get_device()
    q = port.store.vectors[:4]
    g = dev.graph
    dev.search(port.store, q, 5, 30)
    dev.search(port.store, q, 5, 30, entry_mode="descent", descent_mid=False)
    assert "mid_slots" not in g.arrays and g.mid_level == 0
    monkeypatch.setattr(dmod, "MID_CAP", 64)
    dev.search(port.store, q, 5, 30, entry_mode="descent")
    lvl_small = g.mid_level
    version = port.store.version
    monkeypatch.setattr(dmod, "MID_CAP", 1024)
    dev.search(port.store, q, 5, 30, entry_mode="descent")
    lvl_big = g.mid_level
    assert port.store.version == version
    assert 1 <= lvl_big < lvl_small
    n_small = port.store.layers[lvl_small - 1].count
    n_big = port.store.layers[lvl_big - 1].count
    assert n_small <= 64 < n_big <= 1024
    assert g.arrays["mid_slots"].shape[0] == n_big
    # once built, the table follows the cap through HNSWIndex's searches
    monkeypatch.setattr(dmod, "MID_CAP", 64)
    port.entry_mode = "descent"
    port.search_batch(q, SearchParams(top_k=5, ef_search=30))
    assert g.mid_level == lvl_small


def test_mid_excludes_deleted(data, state):
    """Tombstoned ids never come back from a mid-entry search, the mid
    layer's own members included (test_hnsw.py's test_mid_excludes_deleted)."""
    base, _ = data
    port = HNSWIndex.import_graph_state(state, device="cpu")
    dev = port._get_device()
    dev.sync(port.store, mid=True)
    mids = dev.graph.arrays["mid_slots"].numpy()
    dead = {3, 10, 77, 500, 1200} | {int(s) + 1 for s in mids[::2]}
    for vid in dead:
        port.delete(vid)
    for ef_upper in (1, 4):
        s, _ = dev.search(port.store, base[:32], 10, 60,
                          entry_mode="descent", ef_upper=ef_upper)
        got = {int(x) + 1 for x in s[s >= 0]}
        assert not (dead & got)
        assert (s[:, 0] >= 0).all()


def test_mid_table_follows_an_insert_that_grows_a_layer(data, state):
    """An insert that adds members to the mid layer refreshes the mirror's
    mid table by the incremental sync (no full upload): it equals the
    table rebuilt from the store, the new members included."""
    base, _ = data
    port = HNSWIndex.import_graph_state(state, device="cpu",
                                        entry_mode="descent")
    dev = port._get_device()
    dev.sync(port.store, mid=True)
    graph = dev.graph
    level = graph.mid_level
    before = port.store.layers[level - 1].count
    full_uploads = []
    real_full = graph._full_upload
    graph._full_upload = lambda store: (full_uploads.append(1), real_full(store))
    rng = np.random.default_rng(23)
    # 90 rows fit the store's capacity (4,096), so the sync stays
    # incremental; they take the chunked device insertion
    new = (base[rng.integers(0, N, 90)]
           + 0.05 * rng.standard_normal((90, D))).astype(np.float32)
    assert port.store.cap >= N + 90
    port.bulk_insert(list(range(N + 1, N + 91)), new)
    after = port.store.layers[level - 1].count
    assert after > before, "no new member at the mid layer: pick more rows"
    s, _ = dev.search(port.store, new[:16], 10, 60, entry_mode="descent")
    assert not full_uploads
    want = mid_layer_host(port.store)
    assert graph.mid_level == want["mid_level"]
    np.testing.assert_array_equal(graph.arrays["mid_slots"].numpy(),
                                  want["mid_slots"])
    np.testing.assert_array_equal(graph.arrays["mid_vecs"].numpy(),
                                  want["mid_vecs"])
    assert (graph.arrays["mid_slots"].numpy() >= N).any()
    # the inserted vectors find themselves through the descent
    hits = sum(int(s[i, 0]) == port.id_to_slot[N + 1 + i] for i in range(16))
    assert hits >= 15
