"""The port's span tracer (`observability/trace.py`) on the CPU: the span
tree of a `BatchSearch` served over the port's `GrpcServer` on an HNSW and
on a flat collection, the beam's step and sync spans against the index's
step counter, the serving split of `scripts/torch_trace_split.py`, two
searching threads, the tracer off, the bulk build's `build_stats`, the
buffer's bound, the request-duration histogram's clock and the export
into a `torch.profiler` Chrome trace. Tiny collections; no JAX."""

import collections
import importlib.util
import json
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from scintirete_tpu_torch.cli import server_main
from scintirete_tpu_torch.config import Config
from scintirete_tpu_torch.engine import Engine
from scintirete_tpu_torch.index import device as device_mod
from scintirete_tpu_torch.observability import trace
from scintirete_tpu_torch.proto import scintirete_pb2 as pb
from scintirete_tpu_torch.server import service as service_mod
from scintirete_tpu_torch.server.grpc_server import GrpcClient, GrpcServer
from scintirete_tpu_torch.server.service import ScintireteService
from scintirete_tpu_torch.types import (
    CollectionConfig,
    DistanceMetric,
    HNSWParams,
    SearchParams,
)

ROOT = Path(__file__).resolve().parent.parent
PASSWORD = "trace-password"
DIM, N_HNSW, N_FLAT, B = 16, 2100, 600, 300


def _split_module():
    spec = importlib.util.spec_from_file_location(
        "torch_trace_split", ROOT / "scripts" / "torch_trace_split.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SPLIT = _split_module()


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """An HNSW ("h", built by the kNN bulk build with the tracer on) and
    a flat ("f") collection behind a started service and gRPC server."""
    cfg = Config()
    cfg.server.passwords = [PASSWORD]
    cfg.persistence.data_dir = str(tmp_path_factory.mktemp("data"))
    cfg.tpu.device_search_min_size = 0
    cfg.tpu.warm_search_on_start = False
    engine = Engine(use_device=True, tpu_config=cfg.tpu, device="cpu")
    db = engine.create_database("d")
    rng = np.random.default_rng(0)
    base = rng.standard_normal((N_HNSW, DIM)).astype(np.float32)
    trace.drain()
    trace.enable()
    try:
        h = db.create_collection(CollectionConfig(
            name="h", metric=DistanceMetric.COSINE,
            hnsw=HNSWParams(m=16, ef_construction=32, max_layers=2,
                             seed=1)))
        h.insert([(r, None) for r in base])
    finally:
        trace.disable()
    build = trace.drain()
    f = db.create_collection(CollectionConfig(
        name="f", metric=DistanceMetric.L2, index_type="flat"))
    f.insert([(r, None) for r in base[:N_FLAT]])
    svc = ScintireteService(cfg, engine=engine, device="cpu")
    svc.start()
    server = GrpcServer(svc, port=0)
    server.start()
    client = GrpcClient(f"127.0.0.1:{server.port}", timeout=30)
    queries = base[:B] + 0.05 * rng.standard_normal((B, DIM)).astype(np.float32)
    yield {"svc": svc, "client": client, "db": db, "queries": queries,
           "build": build, "hnsw": h._index}
    client.close()
    server.stop()
    svc.stop()


def batch_search(served, col):
    q = served["queries"]
    return served["client"].BatchSearch(pb.BatchSearchRequest(
        auth=pb.AuthInfo(password=PASSWORD), db_name="d", collection_name=col,
        queries_packed=q.tobytes(), num_queries=len(q), dim=DIM, top_k=5,
        dtype="f32"))


def traced(fn):
    trace.enable()
    try:
        fn()
    finally:
        trace.disable()
    drained = trace.drain()
    assert drained.dropped == 0
    return drained.spans


def assert_nested(spans):
    """Every span lies inside its parent, on the parent's thread, in the
    parent's request."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
            assert (p.thread, p.request) == (s.thread, s.request)


def children(spans, parent, name=None):
    return [s for s in spans if s.parent == parent.id
            and (name is None or s.name == name)]


@pytest.mark.parametrize("col", ["h", "f"])
def test_batch_search_span_tree(served, col):
    spans = traced(lambda: batch_search(served, col))
    assert_nested(spans)
    assert len({s.request for s in spans}) == 1
    names = collections.Counter(s.name for s in spans)
    one = {"rpc.decode", "service.call", "service.auth", "engine.search",
           "engine.lock", "index.lock", "search.mirror", "search.upload",
           "search.collect", "index.assemble", "service.pack", "rpc.encode"}
    one |= {"flat.scan"} if col == "f" else set()
    assert all(names[n] == 1 for n in one), names
    (decode,), (call,), (encode,) = (
        [s for s in spans if s.name == n]
        for n in ("rpc.decode", "service.call", "rpc.encode"))
    assert decode.end_ns <= call.start_ns and call.end_ns <= encode.start_ns
    assert decode.parent == call.parent == encode.parent == 0
    assert call.attr == "BatchSearch"
    (search,) = children(spans, call, "engine.search")
    assert search.n == B
    assert {s.name for s in children(spans, call)} == {
        "service.auth", "engine.search", "service.pack"}
    inner = {s.name for s in children(spans, search)}
    if col == "h":
        subs = children(spans, search, "beam.subbatch")
        assert [s.n for s in subs] == [256, B - 256]
        assert inner == one - {"rpc.decode", "service.call", "service.auth",
                               "engine.search", "service.pack",
                               "rpc.encode"} | {"beam.subbatch"}
        for sub in subs:
            assert {s.name for s in children(spans, sub)} == {
                "beam.step", "beam.sync"}
    else:
        assert "beam.subbatch" not in names and "beam.step" not in names
        assert inner == {"engine.lock", "index.lock", "search.mirror",
                         "search.upload", "flat.scan", "search.collect",
                         "index.assemble"}


@pytest.mark.parametrize("mode", ["pivot", "descent"])
def test_beam_steps_are_the_step_counter(served, mode):
    index = served["hnsw"]
    index.entry_mode = mode
    try:
        before = dict(index._get_device().steps)
        spans = traced(lambda: index.search_batch_arrays(
            served["queries"], SearchParams(top_k=5, ef_search=24)))
        after = dict(index._device.steps)
    finally:
        index.entry_mode = "pivot"
    steps = collections.Counter(s.name for s in spans)
    upper = after["upper"] - before["upper"]
    layer0 = after["layer0"] - before["layer0"]
    batches = after["batches"] - before["batches"]
    assert layer0 > 0
    if mode == "pivot":
        assert upper == 0
    # a `beam.step` per upper step and per layer-0 replay: the layer-0
    # beam replays whole blocks, so up to BEAM_BLOCK - 1 replays a
    # sub-batch past its last counted step
    replays = steps["beam.step"] - upper
    block = device_mod.BEAM_BLOCK
    assert layer0 <= replays <= layer0 + (block - 1) * batches
    # one host wait per upper step and one more where that loop
    # converged; one per block of layer-0 replays
    assert (upper + replays / block <= steps["beam.sync"]
            <= upper + replays / block + 2 * batches)


@pytest.mark.parametrize("col", ["h", "f"])
def test_serving_split_partitions_the_call(served, col):
    t0 = time.monotonic()
    spans = traced(lambda: [batch_search(served, col) for _ in range(2)])
    sp = SPLIT.split(spans, t0, time.monotonic())
    assert sp["requests"] == 2 and sp["queries"] == 2 * B
    parts = [sp[k] for k in SPLIT.SERVING]
    assert min(parts) >= 0, sp
    assert sum(parts) == pytest.approx(sp["total"], rel=1e-9)
    assert 0 <= sp["beam_enqueue_cpu"]
    if col == "h":
        assert sp["beam_sync"] > 0 and sp["steps"] > 0
    else:
        assert sp["beam_enqueue"] == sp["beam_sync"] == sp["steps"] == 0
    assert set(SPLIT.per_kq(sp)) == set(SPLIT.SERVING) | {
        "beam_enqueue_cpu", "total"}
    # a request that started outside the window is left out
    assert SPLIT.split(spans, 0.0, t0)["requests"] == 0


def test_two_threads_give_two_trees(served):
    col = served["db"].get_collection("h")
    barrier = threading.Barrier(2)
    errors = []

    def search(rows):
        try:
            barrier.wait(timeout=10)
            col.search_batch_arrays(served["queries"][rows],
                                    SearchParams(top_k=5))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    def run():
        threads = [threading.Thread(target=search, args=(slice(a, a + 100),))
                   for a in (0, 100)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()

    spans = traced(run)
    assert not errors
    assert_nested(spans)
    roots = [s for s in spans if s.name == "engine.search"]
    assert len(roots) == 2 and all(r.parent == 0 and r.n == 100 for r in roots)
    assert len({r.request for r in roots}) == 2
    assert len({r.thread for r in roots}) == 2
    for r in roots:
        tree = [s for s in spans if s.request == r.request]
        assert {s.thread for s in tree} == {r.thread}
        assert all(r.start_ns <= s.start_ns <= s.end_ns <= r.end_ns
                   for s in tree)
    assert len(spans) == sum(
        len([s for s in spans if s.request == r.request]) for r in roots)


def test_tracer_off_records_nothing(served):
    batch_search(served, "h")
    served["db"].get_collection("f").search_batch_arrays(
        served["queries"], SearchParams(top_k=5))
    assert trace.span("engine.search") is trace.NO_SPAN
    assert trace.new_request() is None
    drained = trace.drain()
    assert drained.spans == [] and drained.dropped == 0


def test_build_stats_are_the_build_spans(served):
    spans = served["build"].spans
    stats = served["hnsw"].build_stats
    (layer0,) = [s for s in spans if s.name == "build.layer0"]
    upper = [s for s in spans if s.name == "build.upper"]
    (insert,) = [s for s in spans if s.name == "engine.insert"]
    assert stats["refine_s"] == 0.0
    assert stats["layer0_s"] == layer0.seconds
    assert upper and stats["upper_s"] == pytest.approx(
        sum(s.seconds for s in upper), rel=1e-12)
    assert insert.n == N_HNSW
    assert all(insert.start_ns <= s.start_ns <= s.end_ns <= insert.end_ns
               for s in [layer0, *upper])
    rest = SPLIT.build_split(spans, time.monotonic())
    assert rest["layer0"] == layer0.seconds and rest["inserts"] == 1
    assert 0 <= rest["rest"] < insert.seconds


def test_timed_span_times_itself_off():
    with trace.timed("build.layer0") as phase:
        time.sleep(0.002)
    assert phase.seconds >= 0.002
    assert trace.drain().spans == []


def test_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace.TRACER, "capacity", 3)
    trace.enable()
    for _ in range(5):
        with trace.span("x"):
            pass
    trace.disable()
    drained = trace.drain()
    assert len(drained.spans) == 3 and drained.dropped == 2
    assert trace.drain().dropped == 0


def test_request_duration_is_the_call_span(served, monkeypatch):
    hist = served["svc"].metrics.request_duration_seconds
    key = (("method", "BatchSearch"),)
    before = hist._sums.get(key, 0.0)
    # the service's wall clock steps back by an hour at each reading
    readings = iter(range(0, -3600 * 64, -3600))
    monkeypatch.setattr(service_mod, "time",
                        types.SimpleNamespace(time=lambda: next(readings)))
    spans = traced(lambda: batch_search(served, "h"))
    monkeypatch.undo()
    took = hist._sums[key] - before
    (call,) = [s for s in spans if s.name == "service.call"]
    (search,) = [s for s in spans if s.name == "engine.search"]
    assert search.seconds <= took <= call.seconds


def test_steps_counter_loses_no_count(served):
    index = served["hnsw"]
    device = index._get_device()
    q = served["queries"][:1]
    before = device.steps["batches"]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            index.search_batch_arrays(q, SearchParams(top_k=1, ef_search=8))
            for _ in range(2)]) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert device.steps["batches"] - before == 24


def test_chrome_export_lines_up_with_the_profiler(tmp_path):
    a = torch.randn(700, 700)
    prof = server_main.start_trace("cpu")
    with trace.span("probe"):
        for _ in range(4):
            a = torch.mm(a, a) / 700.0
    path = server_main.write_trace(prof, str(tmp_path / "out"))
    assert not trace.TRACER.enabled
    events = json.loads(Path(path).read_text())["traceEvents"]
    (probe,) = [e for e in events if e.get("name") == "probe"]
    assert probe["pid"] == trace.CHROME_PID and probe["ph"] == "X"
    mms = [e for e in events if e.get("name") == "aten::mm"]
    assert len(mms) == 4
    lo, hi = probe["ts"], probe["ts"] + probe["dur"]
    # the span holds each matmul, within the clocks' rounding
    for mm in mms:
        assert lo - 50 <= mm["ts"] and mm["ts"] + mm["dur"] <= hi + 50
    names = [e for e in events if e.get("ph") == "M"
             and e.get("pid") == trace.CHROME_PID]
    assert names and names[0]["args"]["name"] == "scintirete spans"
