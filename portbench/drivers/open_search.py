"""Open loop of single `Search` RPCs (k from the configuration), for
independent users: Poisson arrivals at the mix's fixed `rate`.

Every seed gets the same set of inter-arrival gaps (drawn once from a
fixed stream and scaled so that exactly rate x seconds requests fall in
the window) in an order of its own, and draws the queries from the pool
by its own stream. A request is timed from the moment it was due, so a
stall of the server or of the generator shows in every request behind
it; how late the generator sent is kept beside it. A request that fails
or never answers counts beyond any limit.

Traffic keys: `rate` (requests/s), `warmup_requests` (sent open loop at
the same rate before the window, untimed).
"""

from __future__ import annotations

import functools
import threading
import time

import grpc
import numpy as np

from portbench import wire
from portbench.proto import scintirete_pb2 as pb

KIND = "search"
TRAFFIC_STREAM = 4


def schedule(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Arrival offsets in [0, seconds): n = round(rate x seconds) of them."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(0).exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    gaps = gaps[np.random.default_rng([seed % (1 << 64), TRAFFIC_STREAM]).permutation(n)]
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def prepare(setup: dict) -> dict:
    pool = setup["payload"]["queries"]
    who = wire.auth(setup["password"])
    reqs = [
        pb.SearchRequest(
            auth=who, db_name=setup["db"], collection_name=setup["collection"],
            query_vector=row, top_k=setup["k"],
        ).SerializeToString()
        for row in pool.tolist()
    ]
    return dict(setup=setup, reqs=reqs, k=setup["k"], seed=setup["seed"],
                rate=float(setup["traffic"]["rate"]),
                conn=wire.Connection(setup["address"]))


def warmup(state: dict) -> dict:
    n = int(state["setup"]["traffic"].get("warmup_requests", 0))
    if n <= 0:
        return {"requests": 0}
    t0 = time.monotonic()
    rec = run(state, t0 + 0.01, n / state["rate"], seed_offset=1)
    return {"requests": int(len(rec["ok"])), "failed": int((~rec["ok"]).sum()),
            "seconds": time.monotonic() - t0}


def run(state: dict, t0: float, seconds: float, rate: float | None = None,
        seed_offset: int = 0) -> dict:
    rate = float(rate or state["rate"])
    seed = state["seed"] + seed_offset
    due = t0 + schedule(seed, rate, seconds)
    n, k = len(due), state["k"]
    pool_idx = np.random.default_rng([seed % (1 << 64), TRAFFIC_STREAM + 1]).integers(
        0, len(state["reqs"]), n)
    sent = np.zeros(n)
    done = np.full(n, np.nan)
    ok = np.zeros(n, bool)
    ids = np.zeros((n, k), np.uint64)
    dists = np.full((n, k), np.inf, np.float32)
    errors: list[str] = []
    left = [n]
    cv = threading.Condition()

    def on_done(i: int, fut) -> None:
        t = time.monotonic()
        try:
            hits = fut.result().results
            for j, hit in enumerate(hits[:k]):
                ids[i, j] = hit.id
                dists[i, j] = hit.distance
            ok[i] = True
        except grpc.RpcError as exc:
            errors.append(f"{exc.code()}: {exc.details()}")
        done[i] = t
        with cv:
            left[0] -= 1
            if left[0] == 0:
                cv.notify()

    call = state["conn"].calls["Search"]
    reqs = state["reqs"]
    for i in range(n):
        delay = due[i] - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        sent[i] = time.monotonic()
        call.future(reqs[pool_idx[i]], timeout=wire.DEADLINE_S).add_done_callback(
            functools.partial(on_done, i))
    with cv:
        cv.wait_for(lambda: left[0] == 0, timeout=wire.DEADLINE_S + 10)
    return dict(kind=KIND, rate=rate, t0=t0, seconds=seconds, pool_idx=pool_idx,
                due=due, sent=sent, done=done, ok=ok, query_ok=ok, ids=ids,
                dists=dists,
                n_errors=len(errors), errors=errors[:5])


def close(state: dict) -> None:
    state["conn"].close()
