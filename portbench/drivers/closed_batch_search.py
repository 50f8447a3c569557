"""Closed loop of `BatchSearch` RPCs, for offline jobs that send large
batches and wait for each answer: `clients` clients, each on its own
channel, each sending its next call of `batch` queries from the pool
(k from the configuration) as soon as the last one answered, so that
exactly `clients` calls are in flight and the rate has no ceiling but
the server's.

Every call has the same size; the queries come from the pool by the
seed's stream, one stream per client. Calls are sent from t0 until the
window closes; the rate counts every query of every call sent in the
window over the time until the last of them answered.

Traffic keys: `clients`, `batch`, `warmup_calls` (per client, untimed).
"""

from __future__ import annotations

import threading
import time

import grpc
import numpy as np

from portbench import wire
from portbench.proto import scintirete_pb2 as pb

KIND = "search"
TRAFFIC_STREAM = 4


def prepare(setup: dict) -> dict:
    t = setup["traffic"]
    return dict(
        setup=setup, pool=setup["payload"]["queries"], k=setup["k"],
        batch=int(t["batch"]), who=wire.auth(setup["password"]),
        conns=[wire.Connection(setup["address"]) for _ in range(int(t["clients"]))],
    )


def _request(state: dict, idx: np.ndarray) -> bytes:
    s = state["setup"]
    return pb.BatchSearchRequest(
        auth=state["who"], db_name=s["db"], collection_name=s["collection"],
        queries_packed=state["pool"][idx].tobytes(), num_queries=len(idx),
        dim=state["pool"].shape[1], top_k=state["k"], dtype="f32",
    ).SerializeToString()


def _client(state: dict, j: int, t0: float, t_end: float, seed: int,
            out: list, calls: int | None = None) -> None:
    """Send calls back to back from t0 until t_end, or `calls` of them."""
    rng = np.random.default_rng([seed % (1 << 64), TRAFFIC_STREAM, j])
    call = state["conns"][j].calls["BatchSearch"]
    b, k = state["batch"], state["k"]
    delay = t0 - time.monotonic()
    if delay > 0:
        time.sleep(delay)
    while (len(out) < calls) if calls is not None else (time.monotonic() < t_end):
        idx = rng.integers(0, len(state["pool"]), b)
        req = _request(state, idx)
        ids = np.zeros((b, k), np.uint64)
        dists = np.full((b, k), np.inf, np.float32)
        sent = time.monotonic()
        try:
            resp = call(req, timeout=wire.DEADLINE_S)
            done, ok, err = time.monotonic(), True, None
            nq, tk = resp.num_queries, resp.top_k
            got_i = np.frombuffer(resp.ids_packed, np.uint64)
            got_d = np.frombuffer(resp.distances_packed, np.float32)
            if got_i.size == nq * tk == got_d.size:
                m, w = min(nq, b), min(tk, k)
                ids[:m, :w] = got_i.reshape(nq, tk)[:m, :w]
                dists[:m, :w] = got_d.reshape(nq, tk)[:m, :w]
        except grpc.RpcError as exc:
            done, ok, err = time.monotonic(), False, f"{exc.code()}: {exc.details()}"
        out.append((j, sent, done, ok, idx, ids, dists, err))


def _run(state: dict, t0: float, seconds: float, seed: int,
         calls: int | None = None) -> dict:
    per_client: list[list] = [[] for _ in state["conns"]]
    threads = [
        threading.Thread(target=_client, args=(state, j, t0, t0 + seconds, seed,
                                               per_client[j], calls))
        for j in range(len(state["conns"]))
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=seconds + wire.DEADLINE_S + 30)
    calls = [c for rows in per_client for c in rows]
    b, k = state["batch"], state["k"]
    ok = np.array([c[3] for c in calls], bool)
    return dict(
        kind=KIND, t0=t0, seconds=seconds,
        client=np.array([c[0] for c in calls], np.int64),
        sent=np.array([c[1] for c in calls]), done=np.array([c[2] for c in calls]),
        ok=ok, batch=b,
        pool_idx=np.concatenate([c[4] for c in calls]) if calls else np.zeros(0, np.int64),
        ids=np.concatenate([c[5] for c in calls]) if calls else np.zeros((0, k), np.uint64),
        dists=np.concatenate([c[6] for c in calls]) if calls else np.zeros((0, k), np.float32),
        query_ok=np.repeat(ok, b),
        n_errors=int((~ok).sum()), errors=[c[7] for c in calls if c[7]][:5],
    )


def warmup(state: dict) -> dict:
    n = int(state["setup"]["traffic"].get("warmup_calls", 0))
    t0 = time.monotonic()
    rec = _run(state, t0, 0.0, state["setup"]["seed"] + 1, calls=n)
    return {"calls": int(len(rec["ok"])), "failed": rec["n_errors"],
            "seconds": time.monotonic() - t0}


def run(state: dict, t0: float, seconds: float) -> dict:
    return _run(state, t0, seconds, state["setup"]["seed"])


def close(state: dict) -> None:
    for conn in state["conns"]:
        conn.close()
