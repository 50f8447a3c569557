"""An L2 HNSW collection at GIST-1M's 960-wide rows, on the CPU: built
through the port's `Engine` (`Collection.insert`, the kNN bulk build) and
searched through `ScintireteService.BatchSearch` on the device path (the
plain torch versions of the pivot scan and the layer-0 beam), held to the
benchmark's plain reference (`portbench/reference/exact.py`, plain torch).

The data is the benchmark's workload v2 (`portbench/datagen.py`) at
D = 960, cut to 3,000 rows and 200 queries; m 16 and ef_construction 200
as the `gist1m-hnsw` configuration has them. Also checked: the layer-0
beam's counters (`DeviceIndex.steps`: "queries", "dist_rows") count what
the eager step ran.
"""

import numpy as np
import pytest
import torch

from portbench import datagen
from portbench.reference import exact
from scintirete_tpu_torch import CollectionConfig, DistanceMetric, HNSWParams
from scintirete_tpu_torch.config import Config
from scintirete_tpu_torch.engine import Engine
from scintirete_tpu_torch.index import device as device_mod
from scintirete_tpu_torch.proto import scintirete_pb2 as pb
from scintirete_tpu_torch.server.service import ScintireteService

PASSWORD = "gist-shape-password"
DIM, N, QUERIES, K = 960, 3000, 200, 10
DATA = {"n": N, "dim": DIM, "queries": QUERIES, "centres": 40,
        "centre_scale": 2.0, "point_noise": 0.4, "query_noise": 0.2}
# The answers are scored from their differences, as the reference scores
# them, in float32 sums whose order may differ: ~1e-6 at d ~ 6-20. (The
# beam's own form, |q|^2 + |x|^2 - 2 q.x, strays by up to ~1e-3 here: at
# D = 960 and centre_scale 2.0 the norms are about 4,000.)
DIST_TOL = 1e-5
# ef 50 over a 3,000-row graph: the beam misses few of the exact top-10
RECALL_MIN = 0.99


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    data = datagen.dataset(2**31 + 960, DATA)
    cfg = Config()
    cfg.server.passwords = [PASSWORD]
    cfg.persistence.data_dir = str(tmp_path_factory.mktemp("gist"))
    cfg.tpu.device_search_min_size = 0  # the device path at this size
    cfg.tpu.shard_devices = 1
    engine = Engine(use_device=True, tpu_config=cfg.tpu, device="cpu")
    col = engine.create_database("db").create_collection(CollectionConfig(
        name="gist", metric=DistanceMetric.L2,
        hnsw=HNSWParams(m=16, ef_construction=200, ef_search=50, seed=17),
    ))
    ids = np.asarray(col.insert([(r, None) for r in data.base]), np.uint64)
    svc = ScintireteService(cfg, engine=engine, device="cpu")
    svc.start()
    if svc._warm_thread is not None:  # its warm-up search, before the tests'
        svc._warm_thread.join()
    yield {"data": data, "ids": ids, "svc": svc, "col": col}
    svc.stop()
    engine.close()


def batch_search(svc, queries):
    resp = svc.BatchSearch(pb.BatchSearchRequest(
        auth=pb.AuthInfo(password=PASSWORD), db_name="db",
        collection_name="gist", queries_packed=queries.astype(np.float32).tobytes(),
        num_queries=len(queries), dim=DIM, top_k=K, dtype="f32"))
    ids = np.frombuffer(resp.ids_packed, np.uint64).reshape(-1, K)
    dists = np.frombuffer(resp.distances_packed, np.float32).reshape(-1, K)
    return ids, dists


def test_served_answers_hold_to_the_reference(served):
    data, svc = served["data"], served["svc"]
    ids, dists = batch_search(svc, data.queries)
    row_of = {int(v): r for r, v in enumerate(served["ids"])}
    assert all(int(v) in row_of for v in ids.ravel())  # ids known
    rows = np.vectorize(lambda v: row_of[int(v)])(ids)
    assert all(len(set(r)) == K for r in rows)  # each once
    assert (np.diff(dists, axis=1) >= 0).all()  # nearest first

    base, q = torch.from_numpy(data.base), torch.from_numpy(data.queries)
    ref = exact.answer_distances(q, torch.from_numpy(rows), base, "l2").numpy()
    assert np.abs(dists.astype(np.float64) - ref).max() <= DIST_TOL
    truth = exact.exact_topk(q, base, "l2", K).numpy()
    found = np.array([len(set(t) & set(r)) for t, r in zip(truth, rows)])
    assert found.mean() / K >= RECALL_MIN, found.mean() / K
    # no query answered wholly from another cluster (see the next test)
    assert found.min() > 0


def test_every_cluster_holds_an_entry_pivot(served, monkeypatch):
    """The beam walks only the layer-0 component its entry pivot lies in,
    and here each cluster is a component of its own. At the JAX package's
    16 rows per pivot a cluster of this data holds no pivot, and its
    queries were answered from another cluster (recall 0.98); at the
    port's ROWS_PER_PIVOT every cluster holds one."""
    data, store = served["data"], served["col"]._index.store
    cent = data.centres
    cluster = np.argmin((cent * cent).sum(1) - 2.0 * data.base @ cent.T, axis=1)

    def covered():
        pivots = device_mod.pivot_sample_host(store)["pivots"]
        return np.unique(cluster[pivots]).size

    assert covered() == np.unique(cluster).size
    monkeypatch.setattr(device_mod, "ROWS_PER_PIVOT", 16)
    assert covered() < np.unique(cluster).size


def test_beam_counters_count_the_eager_steps(served, monkeypatch):
    """One sub-batch of 200 queries (search_batch_size 256): "queries"
    grows by 200 and "dist_rows" by the layer-0 steps x 200 rows x expand
    x degree. The rows the eager step scored (`_DistTo` calls) are those,
    plus the steps of the last block past convergence, which the counter
    leaves out."""
    col, data = served["col"], served["data"]
    dev = col._index._get_device()
    scored = []
    plain = device_mod._DistTo.__call__
    monkeypatch.setattr(device_mod._DistTo, "__call__",
                        lambda self, slots: (scored.append(slots.shape),
                                             plain(self, slots))[1])
    before = dict(dev.steps)
    batch_search(served["svc"], data.queries)
    after = dev.steps
    grew = {key: after[key] - before[key] for key in after}
    per_row = device_mod.SEARCH_EXPAND * col._index.store.m * 2
    assert dev._graphs is None  # the CPU runs the eager step
    assert grew["batches"] == 1 and grew["queries"] == QUERIES
    assert grew["layer0"] > 0
    assert grew["dist_rows"] == grew["layer0"] * QUERIES * per_row
    assert set(scored) == {(QUERIES, per_row)}
    extra = len(scored) - grew["layer0"]
    assert 0 <= extra < device_mod.BEAM_BLOCK
