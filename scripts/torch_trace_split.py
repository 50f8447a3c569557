"""Split a benchmark cell's served time by the port's own spans, on one GPU.

    python3 scripts/torch_trace_split.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 51] [--mode split|cost|syncs]

`split` (the default): for each seed, turns the port's span tracer
(`scintirete_tpu_torch/observability/trace.py`) on, runs the cell once as
`portbench/run.py --trace 1` does (`portbench.run.run_cell`: set-up, the
window, the device traced over a stretch in its middle), drains the
tracer and prints one JSON line: the run's own metrics beside the split
of the requests that started in the window (`split()`: ms per 1,000
queries of the transport and service, the engine's host part, the
device-to-host collect, the beam's enqueue, its CPU time and its syncs),
the bulk build's phases in set-up (`build_split()`), the device's idle
seconds of the traced stretch named after the deepest program span open
at each gap's middle (`idle_by_span()`), and the share of them no span
named.

`cost`: runs the cell untraced, with the tracer off and on in turns (off
then on for the first seed, on then off for the next, ...), and prints
each run's end-to-end metrics: what the tracer costs when it is on.

`syncs`: builds a small collection of the cell's metric and width on the
card, searches one sub-batch of 256 queries under
`torch.cuda.set_sync_debug_mode(1)` and prints every synchronising call,
by the port's source line that made it, with the span open there.

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

# program spans from the deepest layer out, then the harness's two wraps:
# an idle gap is named after the deepest span open (on any thread) at its
# middle
DEPTH = ("beam.sync", "beam.step", "search.collect", "flat.scan",
         "search.upload", "search.mirror", "index.assemble", "index.lock",
         "engine.lock", "beam.subbatch", "engine.search", "service.pack",
         "service.auth", "rpc.decode", "rpc.encode", "service.call",
         "engine.search_batch_arrays", "service.BatchSearch")
PROGRAM = frozenset(DEPTH[:16])
SERVING = ("frontend", "engine_host", "collect", "beam_enqueue",
           "beam_sync")  # these partition decode + call + encode


def requests_in(spans, lo_s: float, hi_s: float) -> dict:
    """Spans by request, for the requests whose `rpc.decode` started in
    [lo_s, hi_s) (monotonic seconds)."""
    lo, hi = int(lo_s * 1e9), int(hi_s * 1e9)
    keep = {s.request for s in spans
            if s.name == "rpc.decode" and lo <= s.start_ns < hi}
    out: dict = collections.defaultdict(list)
    for s in spans:
        if s.request in keep:
            out[s.request].append(s)
    return out


def split(spans, lo_s: float, hi_s: float) -> dict:
    """Seconds of the requests that started in [lo_s, hi_s), summed over
    them: `SERVING` (wall time that adds up to rpc.decode + service.call
    + rpc.encode), `beam_enqueue_cpu` (the thread CPU time of the beam's
    enqueue intervals), the queries (Σ n of engine.search), the requests
    and the beam steps."""
    wall: dict = collections.defaultdict(float)
    cpu: dict = collections.defaultdict(float)
    queries = steps = 0
    reqs = requests_in(spans, lo_s, hi_s)
    for group in reqs.values():
        for s in group:
            wall[s.name] += s.seconds
            cpu[s.name] += s.cpu_seconds
            if s.name == "engine.search":
                queries += s.n or 0
            steps += s.name == "beam.step"
    out = {
        "frontend": wall["rpc.decode"] + wall["rpc.encode"]
        + wall["service.call"] - wall["engine.search"],
        "engine_host": wall["engine.search"] - wall["beam.subbatch"]
        - wall["search.collect"],
        "collect": wall["search.collect"],
        "beam_enqueue": wall["beam.subbatch"] - wall["beam.sync"],
        "beam_sync": wall["beam.sync"],
        "beam_enqueue_cpu": cpu["beam.subbatch"] - cpu["beam.sync"],
        "total": wall["rpc.decode"] + wall["service.call"] + wall["rpc.encode"],
        "queries": queries, "requests": len(reqs), "steps": steps,
    }
    return out


def per_kq(sp: dict) -> dict:
    """`split()`'s seconds as ms per 1,000 queries."""
    kq = sp["queries"] / 1000.0
    keys = SERVING + ("beam_enqueue_cpu", "total")
    return {k: 1000.0 * sp[k] / kq for k in keys} if kq else {}


def build_split(spans, before_s: float) -> dict:
    """Seconds of the bulk build's phases among the spans that ended
    before `before_s`: Σ build.layer0, Σ build.upper, and Σ engine.insert
    less the build spans inside them (`rest`)."""
    end = int(before_s * 1e9)
    done = [s for s in spans if s.end_ns <= end]
    inserts = [s for s in done if s.name == "engine.insert"]
    phase = {"build.layer0": 0.0, "build.upper": 0.0}
    inside = 0.0
    for s in done:
        if s.name in phase:
            phase[s.name] += s.seconds
            if any(i.start_ns <= s.start_ns and s.end_ns <= i.end_ns
                   for i in inserts):
                inside += s.seconds
    return {"layer0": phase["build.layer0"], "upper": phase["build.upper"],
            "rest": sum(s.seconds for s in inserts) - inside,
            "inserts": len(inserts)}


def idle_by_span(gaps, spans, harness=()) -> dict:
    """Idle seconds of `gaps` ((start, end) monotonic seconds) by the
    deepest span open at each gap's middle (`DEPTH`; "no span" where
    none is), program spans and the harness's (name, start, end)."""
    rank = {n: i for i, n in enumerate(DEPTH)}
    iv = [(rank[s.name], s.start_ns / 1e9, s.end_ns / 1e9)
          for s in spans if s.name in PROGRAM]
    iv += [(rank[n], a, b) for n, a, b in harness if n in rank]
    if not iv:
        return {}
    depth, starts, ends = (np.array(c) for c in zip(*iv))
    totals: dict = collections.defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        open_ = (starts <= mid) & (mid < ends)
        label = DEPTH[int(depth[open_].min())] if open_.any() else "no span"
        totals[label] += b - a
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))


def unnamed_share(gaps, spans) -> float:
    """Percent of the gaps' idle seconds at whose middle no program span
    is open on any thread."""
    named = idle_by_span(gaps, spans)
    total = sum(named.values())
    return 100.0 * named.get("no span", 0.0) / total if total else float("nan")


def _run_cell(cell, seed: int, seconds: float, trace_run: bool,
              device: str = "cuda"):
    """`portbench.run.run_cell`; returns (result, its `Run`)."""
    from portbench import run as prun

    captured = []

    class Capture(prun.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            captured.append(self)

    plain, prun.Run = prun.Run, Capture
    try:
        result = prun.run_cell(cell, seed, seconds, trace=trace_run,
                               device=device, t_start=time.monotonic())
    finally:
        prun.Run = plain
    return result, captured[0]


def mode_split(cell, seeds, seconds, device: str = "cuda") -> None:
    from scintirete_tpu_torch.observability import trace

    for seed in seeds:
        trace.drain()
        trace.enable()
        try:
            result, run = _run_cell(cell, seed, seconds, True, device)
        finally:
            trace.disable()
        drained = trace.drain()
        rec = run.records
        t0, t1 = rec["t0"], rec["t0"] + rec["seconds"]
        sp = split(drained.spans, t0, t1)
        gaps = run.trace.gaps() if run.trace is not None else []
        harness = run.spans.items if run.spans is not None else []
        print(json.dumps({
            "cell": cell.name, "seed": seed, "correct": result["correct"],
            "dropped": drained.dropped, "spans": len(drained.spans),
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "device": result["device"],
            "split_ms_per_kq": per_kq(sp), "split_s": sp,
            "per_step_ms": {k: 1000.0 * sp[k] / sp["steps"] for k in
                            ("beam_enqueue", "beam_enqueue_cpu", "beam_sync")}
            if sp["steps"] else None,
            "build_s": build_split(drained.spans, t0),
            "idle_unnamed_pct": unnamed_share(gaps, drained.spans),
            "idle_by_span": idle_by_span(gaps, drained.spans, harness),
            "idle_by_harness": result.get("breakdown", {}).get("idle_gaps"),
        }, default=float), flush=True)


def mode_cost(cell, seeds, seconds, device: str = "cuda") -> None:
    from scintirete_tpu_torch.observability import trace

    for i, seed in enumerate(seeds):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            trace.drain()
            if on:
                trace.enable()
            try:
                result, _ = _run_cell(cell, seed, seconds, False, device)
            finally:
                trace.disable()
            drained = trace.drain()
            print(json.dumps({
                "cell": cell.name, "seed": seed, "tracer": on,
                "correct": result["correct"], "spans": len(drained.spans),
                "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            }, default=float), flush=True)


def mode_syncs(cell) -> None:
    import torch

    from scintirete_tpu_torch.engine import Engine
    from scintirete_tpu_torch.observability import trace
    from scintirete_tpu_torch.types import (
        CollectionConfig, DistanceMetric, HNSWParams, SearchParams)

    col_cfg = cell.config["collection"]
    dim = int(cell.config["data"]["dim"])
    rng = np.random.default_rng(0)
    base = rng.standard_normal((50_000, dim)).astype(np.float32)
    col = Engine(device="cuda").create_database("d").create_collection(
        CollectionConfig(name="c", metric=DistanceMetric[col_cfg["metric"].upper()],
                         hnsw=HNSWParams(m=16, ef_construction=200, seed=1),
                         index_type=col_cfg["index_type"]))
    col.insert([(v, None) for v in base])
    params = SearchParams(top_k=int(col_cfg["k"]), ef_search=50)
    q = base[:256] + 0.01 * rng.standard_normal((256, dim)).astype(np.float32)
    col.search_batch_arrays(q, params)  # the mirror and every kernel warm
    torch.cuda.synchronize()

    where: dict = collections.Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            path = Path(filename)
            if path.is_relative_to(REPO):
                path = path.relative_to(REPO)
            stack = trace.TRACER._state.stack
            where[(f"{path}:{lineno}", stack[-1].name if stack else "")] += 1

    trace.enable()
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            col.search_batch_arrays(q, params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        trace.disable()
    trace.drain()
    print(json.dumps({"cell": cell.name, "rows": len(base), "queries": len(q),
                      "syncs": sum(where.values()),
                      "by_line": [[at, span, n] for (at, span), n
                                  in where.most_common()]}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="20261018")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--mode", choices=("split", "cost", "syncs"), default="split")
    args = ap.parse_args()

    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        sys.exit("this split needs a CUDA card")
    from portbench import spec

    cell = spec.cell(spec.load_benchmark(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.mode == "split":
        mode_split(cell, seeds, args.seconds)
    elif args.mode == "cost":
        mode_cost(cell, seeds, args.seconds)
    else:
        mode_syncs(cell)


if __name__ == "__main__":
    main()
