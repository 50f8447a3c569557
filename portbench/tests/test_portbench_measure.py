"""The reference, the statistics and the open-loop generator."""

import threading
import time
from concurrent import futures

import grpc
import numpy as np
import pytest
import torch

from portbench import spec, stats, wire
from portbench.proto import scintirete_pb2 as pb
from portbench.reference import exact


@pytest.mark.parametrize("metric", exact.METRICS)
def test_exact_topk_is_numpy_argsort(metric):
    r = np.random.default_rng(3)
    base = r.standard_normal((3000, 24)).astype(np.float32)
    q = r.standard_normal((40, 24)).astype(np.float32)
    got = exact.exact_topk(torch.from_numpy(q), torch.from_numpy(base), metric, 10,
                           block_q=16, block_n=700).numpy()
    q64, b64 = q.astype(np.float64), base.astype(np.float64)
    if metric == "l2":
        d = ((q64[:, None, :] - b64[None]) ** 2).sum(-1)
    elif metric == "ip":
        d = -(q64 @ b64.T)
    else:
        d = 1 - (q64 @ b64.T) / np.linalg.norm(q64, axis=1)[:, None] / np.linalg.norm(b64, axis=1)
    want = np.argsort(d, axis=1, kind="stable")[:, :10]
    assert np.array_equal(got, want)
    dist = exact.answer_distances(torch.from_numpy(q), torch.from_numpy(want),
                                  torch.from_numpy(base), metric).numpy()
    want_d = np.take_along_axis(d, want, 1)
    if metric == "l2":
        want_d = np.sqrt(want_d)
    np.testing.assert_allclose(dist, want_d, rtol=1e-5, atol=1e-5)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0000002, 0.0])
    got = exact.round_tf32(x)
    assert got.tolist()[:3] == [1.0, 1.0, 1.0 + 2**-9] and got[3] == -3.0 and got[4] == 0
    bits = got.view(torch.int32)
    assert ((bits & 0x1FFF) == 0).all()


def test_percentile_and_rates_over_all_requests():
    # 20 chunks of 50 requests: most fast, all the slow ones in one chunk.
    lat = np.full(1000, 0.01)
    lat[:60] = 1.0
    chunk_medians = np.median(lat.reshape(20, 50), axis=1)
    assert np.percentile(chunk_medians, 95) < 1.0
    rec = {"due": np.zeros(1000), "done": lat.copy(), "ok": np.ones(1000, bool)}
    assert stats.percentile(stats.latencies_from_due(rec), 95) == 1.0
    rec["ok"][500:] = False
    assert stats.percentile(stats.latencies_from_due(rec), 95) == np.inf
    done = np.array([2.0, 3.0, np.nan, 11.0])
    assert stats.completed_rate(300.0, 1.0, done) == pytest.approx(30.0)


class _StallServer:
    """A Search service that answers at once, except that one request
    holds the only worker for `stall` seconds."""

    def __init__(self, stall: float, stall_at: int):
        self.n = 0
        self.lock = threading.Lock()

        def search(raw, context):
            with self.lock:
                self.n += 1
                i = self.n
            if i == stall_at:
                time.sleep(stall)
            return pb.SearchResponse(results=[pb.SearchResultItem(id=1, distance=0.5)])

        handler = grpc.method_handlers_generic_handler(wire.SERVICE, {
            "Search": grpc.unary_unary_rpc_method_handler(
                search, request_deserializer=pb.SearchRequest.FromString,
                response_serializer=lambda m: m.SerializeToString())})
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=1))
        self.server.add_generic_rpc_handlers((handler,))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()


def _open_loop(port: int, rate: float):
    drv = spec.driver("open_search")
    state = drv.prepare({"payload": {"queries": np.zeros((4, 3), np.float32)},
                         "password": "p", "db": "d", "collection": "c", "k": 1,
                         "seed": 9, "traffic": {"rate": rate},
                         "address": f"127.0.0.1:{port}"})
    return drv, state


def test_open_loop_times_from_due_and_shows_a_stall():
    srv = _StallServer(stall=0.6, stall_at=40)
    drv, state = _open_loop(srv.port, 100.0)
    try:
        rec = drv.run(state, time.monotonic() + 0.05, 2.0)
    finally:
        drv.close(state)
        srv.server.stop(0)
    assert len(rec["due"]) == 200 and rec["ok"].all()
    assert (np.diff(rec["due"]) >= 0).all() and rec["due"][-1] < rec["t0"] + 2.0
    lat = stats.latencies_from_due(rec)
    # the requests due during the stall waited for it
    assert stats.percentile(lat, 95) > 0.2
    assert np.median(lat) < 0.1
    assert (lat >= rec["done"] - rec["sent"] - 1e-9).all()


def test_open_loop_counts_a_late_generator():
    srv = _StallServer(stall=0.0, stall_at=-1)
    drv, state = _open_loop(srv.port, 50.0)
    try:
        # the window started 0.5 s ago: every request due before now is
        # sent late, and its latency counts from when it was due
        rec = drv.run(state, time.monotonic() - 0.5, 1.0)
    finally:
        drv.close(state)
        srv.server.stop(0)
    late = rec["sent"] - rec["due"]
    assert late[0] > 0.45
    assert stats.latencies_from_due(rec)[0] >= late[0]


def test_schedule_same_arrivals_other_order():
    drv = spec.driver("open_search")
    a, b = drv.schedule(1, 500.0, 4.0), drv.schedule(2**33 + 1, 500.0, 4.0)
    assert len(a) == len(b) == 2000
    ga = np.sort(np.diff(np.append(a, 4.0)))
    gb = np.sort(np.diff(np.append(b, 4.0)))
    np.testing.assert_allclose(ga, gb, atol=1e-9)
    assert not np.allclose(a, b)

