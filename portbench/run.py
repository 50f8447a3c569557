#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed whole as `setup_s`): import torch and the port, make the
configuration's data from the seed, load the base into the port's
`Engine` in process (an HNSW base pays the bulk build here), start
`ScintireteService` and its gRPC server, start the client process and
let it warm the cell's own path. Then `--seconds` of the cell's traffic
from the client process, the program's answers judged against the plain
reference once the program's state is freed, and one JSON line last on
standard output: `correct`, `attempted`, `failed`, `metrics`, `device`
(and `breakdown` with `--trace 1`), the compared numbers beside their
limits under `checks`, last. Everything else goes to standard error.

With `--trace 1` the per-layer metrics are reported: spans around the
program's entry points for the whole window, the device traced by
`torch.profiler` over a stretch in its middle. `--control tf32` puts the
reference, one step of precision lower, in the program's place, and
`--control tf32-select` the reference that chooses its rows in that
precision and returns float32 distances (each has to come out not
correct). `--sweep r1,r2,...` sends the cell's configuration open-loop
single `Search` traffic (`drivers/open_search.py`) at each rate for
`--sweep-seconds` after one set-up and prints a row per rate (no result
line): how the knee of a serving cell is found.

Exits non-zero, with no result line, where no card is found or fewer
cards than the cell asks for, and where JAX or the JAX package is loaded
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Callable, Optional  # noqa: E402

_REPO = Path(__file__).resolve().parent.parent
if __package__ in (None, ""):
    # run as a script: the folder's own modules must not shadow the
    # standard library's (trace), and the package is found from the root
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != _REPO / "portbench"]
    sys.path.insert(0, str(_REPO))

# every build and kernel cache at a fixed place inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(_REPO / "build" / _sub)

import numpy as np  # noqa: E402

from portbench import check, datagen, spec  # noqa: E402
from portbench import trace as tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "scintirete_tpu")
START_MARGIN_S = 0.05
SWEEP_TRAFFIC = {"driver": "open_search", "warmup_requests": 500}


def log(**fields) -> None:
    print(json.dumps(fields, default=float), file=sys.stderr, flush=True)


class NoDevice(RuntimeError):
    pass


def require_cards(chips: int) -> str:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} found")
    return "cuda"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class ClientProcess:
    """The client process (`portbench.client`), spoken to by pickles."""

    def __init__(self):
        env = dict(os.environ, PYTHONPATH=str(_REPO))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "portbench.client"], cwd=str(_REPO),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)

    def send(self, msg: dict) -> None:
        pickle.dump(msg, self.proc.stdin)
        self.proc.stdin.flush()

    def recv(self) -> dict:
        return pickle.load(self.proc.stdout)

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.send({"cmd": "stop"})
                self.proc.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()
        for fh in (self.proc.stdin, self.proc.stdout):
            fh.close()


@dataclasses.dataclass
class Run:
    """A finished run, as the metric readers see it."""

    cell: spec.Cell
    records: dict
    setup: dict
    check: check.Check
    counters: dict
    spans: Optional[tracing.Spans] = None
    calls: Optional[tracing.KernelCalls] = None
    trace: Optional[tracing.DeviceTrace] = None


def wrap_service(spans: tracing.Spans, service) -> None:
    """A span around the service's entry point (before the transport
    binds it)."""
    spans.wrap(service, "BatchSearch", "service.BatchSearch")


def wrap_collection(spans: tracing.Spans, col) -> None:
    spans.wrap(col, "search_batch_arrays", "engine.search_batch_arrays")


def rooflines_read(cell: spec.Cell) -> list[str]:
    """The kernels (`roofline/<kernel>.py`) whose calls the cell's own
    per-layer readers read: each reader names them in `ROOFLINES`."""
    return sorted({k for m in cell.per_layer
                   for k in getattr(spec.load_module("layer_metrics", m["name"]),
                                    "ROOFLINES", ())})


def wrap_kernels(calls: tracing.KernelCalls, kernels: list[str]) -> None:
    import importlib

    for kernel in kernels:
        mod = spec.load_module("roofline", kernel)
        calls.wrap(importlib.import_module(mod.WRAP[0]), mod.WRAP[1], kernel,
                   mod.shape_of)


def beam_steps(system) -> Optional[dict]:
    device_index = getattr(getattr(system.collection(), "_index", None), "_device", None)
    steps = getattr(device_index, "steps", None)
    return dict(steps) if steps is not None else None


# spans from the deepest layer out: a gap is named after the deepest
# layer that had a call open at its middle
DEPTH = ("engine.search_batch_arrays", "service.BatchSearch")


def idle_by_host(trace: tracing.DeviceTrace, spans: tracing.Spans) -> list:
    """Device idle seconds of the stretch, summed by what the host was
    doing at each gap's middle: the deepest harness span open there."""
    inside = [s for s in spans.items if s[2] > trace.start and s[1] < trace.end]
    rank = {n: i for i, n in enumerate(DEPTH)}
    depth = np.array([rank.get(n, len(DEPTH)) for n, _, _ in inside])
    starts = np.array([a for _, a, _ in inside])
    ends = np.array([b for _, _, b in inside])
    totals: dict[str, float] = {}
    for a, b in trace.gaps():
        mid = 0.5 * (a + b)
        open_ = (starts <= mid) & (mid < ends) if inside else np.zeros(0, bool)
        label = (DEPTH + ("other",))[int(depth[open_].min())] if open_.any() else "no span"
        totals[label] = totals.get(label, 0.0) + (b - a)
    return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:10]


def sweep_row(rec: dict) -> dict:
    from portbench import stats

    lat = stats.latencies_from_due(rec)
    late = rec["sent"] - rec["due"]
    n = len(lat)
    tenth = max(1, n // 10)
    fin = np.where(np.isfinite(lat), lat, np.nan)
    return {
        "offered_qps": n / rec["seconds"],
        "completed_qps": stats.completed_rate(float(rec["ok"].sum()), rec["t0"], rec["done"]),
        "p50_ms": 1000 * stats.percentile(lat, 50), "p95_ms": 1000 * stats.percentile(lat, 95),
        "late_p50_ms": 1000 * stats.percentile(late, 50),
        "late_max_ms": 1000 * float(late.max()),
        "first_tenth_mean_ms": 1000 * float(np.nanmean(fin[:tenth])),
        "last_tenth_mean_ms": 1000 * float(np.nanmean(fin[-tenth:])),
        "failed": int((~rec["ok"]).sum()), "requests": n,
    }


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool = False,
             device: str = "cuda", control: Optional[str] = None,
             sweep: Optional[list[float]] = None, sweep_seconds: float = 10.0,
             tamper: Optional[Callable[[Any], None]] = None,
             t_start: float = T_START) -> dict:
    """One run of `cell`. Returns the result line's object, or with
    `sweep` {"sweep": rows}. `tamper(system)` runs after set-up, before
    the window (tests break the timed path with it)."""
    import torch

    import scintirete_tpu_torch  # noqa: F401
    from portbench.system import PASSWORD, DB, System

    on_card = device == "cuda"
    setup = {"import_s": time.monotonic() - t_start}
    t = time.monotonic()
    cfg, k = cell.config, cell.config["collection"]["k"]
    data = datagen.dataset(seed, cfg["data"])
    traffic = dict(SWEEP_TRAFFIC, rate=sweep[0]) if sweep else cell.traffic
    setup["data_s"] = time.monotonic() - t
    data_dir = tempfile.mkdtemp(prefix="portbench-")
    system = client = spans = calls = None
    try:
        t = time.monotonic()
        system = System(cfg, seed, device, data_dir)
        system.load(data.base, control)
        if on_card:
            torch.cuda.synchronize()
        setup["build_s"] = time.monotonic() - t
        t = time.monotonic()
        if trace:
            spans, calls = tracing.Spans(), tracing.KernelCalls()
        port = system.serve((lambda svc: wrap_service(spans, svc)) if trace else None)
        if trace:
            wrap_collection(spans, system.collection())
            if on_card:
                wrap_kernels(calls, rooflines_read(cell))
        if tamper is not None:
            tamper(system)
        setup["service_s"] = time.monotonic() - t
        t = time.monotonic()
        client = ClientProcess()
        client.send({"driver": traffic["driver"], "address": f"127.0.0.1:{port}",
                     "password": PASSWORD, "db": DB, "collection": system.name,
                     "k": k, "seed": seed, "traffic": traffic,
                     "payload": {"queries": data.queries}})
        warm = client.recv()["ready"]
        setup["warmup_s"] = time.monotonic() - t
        if sweep:
            rows = []
            for rate in sweep:
                client.send({"cmd": "go", "t0": time.monotonic() + START_MARGIN_S,
                             "seconds": sweep_seconds, "override": {"rate": rate}})
                rows.append(sweep_row(client.recv()["records"]))
                log(sweep=rows[-1])
            return {"sweep": rows, "setup": setup}

        counters: dict[str, Any] = {}
        if trace:
            counters["steps_before"] = beam_steps(system)
        profiler = device_trace = None
        if trace and on_card:
            profiler = tracing.DeviceProfile()
            profiler.start()
        t0 = time.monotonic() + START_MARGIN_S
        setup["setup_s"] = t0 - t_start
        client.send({"cmd": "go", "t0": t0, "seconds": seconds})
        if profiler is not None:
            stretch = min(float(traffic.get("trace_seconds", 3.0)), seconds)
            time.sleep(max(0.0, t0 + 0.5 * (seconds - stretch) - time.monotonic()))
            profiler.stretch(stretch, calls)
        records = client.recv()["records"]
        if profiler is not None:
            device_trace = profiler.stop()
        if trace:
            before = counters.pop("steps_before")
            after = beam_steps(system)
            counters["steps"] = (before, after) if before and after else None
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        client.close()
        client = None
        base_ids = system.base_ids
        if spans is not None:
            spans.unwrap()
        if calls is not None:
            calls.unwrap()
        system.stop()
        system = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        t = time.monotonic()
        judged = check.search(cell, data, records, base_ids, device)
        check_s = time.monotonic() - t
        run = Run(cell, records, setup, judged, counters, spans, calls,
                  device_trace)
        section, kind = ("per_layer", "layer_metrics") if trace else ("end_to_end", "end_to_end")
        metrics = {}
        for entry in getattr(cell, section):
            value = spec.read_metric(kind, entry, run)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        dev = {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": cell.chips if on_card else 0,
            "memory_peak_bytes": int(peak),
            "power_limit_w": power_limit_w() if on_card else None,
        }
        result = {
            "correct": judged.correct,
            "attempted": int(len(records["query_ok"])),
            "failed": int(judged.numbers["failed"]),
            "metrics": metrics,
            "device": dev,
        }
        if device_trace is not None:
            dev["busy_s"] = device_trace.busy_s()
            dev["window_s"] = device_trace.window_s
            ops = sorted(device_trace.by_name().items(), key=lambda kv: -kv[1])[:10]
            result["breakdown"] = {"device_ops": [list(kv) for kv in ops],
                                   "idle_gaps": idle_by_host(device_trace, spans)}
            log(trace_events=len(device_trace.events), trace_raw=device_trace.raw,
                trace_reach_s=device_trace.reach, profiler_s=profiler.seconds)
        log(setup=setup, check_s=check_s, answers=judged.answers,
            recall=judged.recall, miss_margins=judged.margins, warmup=warm,
            errors=records.get("errors"))
        result["checks"] = judged.table()
        return result
    finally:
        if client is not None:
            client.close()
        if system is not None:
            system.stop()
        shutil.rmtree(data_dir, ignore_errors=True)


def parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32", "tf32-select"), default=None,
                   help="put the reference in the program's place (see "
                        "portbench/reference/control.py)")
    p.add_argument("--sweep", default=None,
                   help="comma-separated offered rates of open-loop single Search")
    p.add_argument("--sweep-seconds", type=float, default=10.0)
    return p.parse_args(argv)


def main(argv: Optional[list[str]] = None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    try:
        device = require_cards(cell.chips)
    except NoDevice as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    sweep = [float(r) for r in args.sweep.split(",")] if args.sweep else None
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                      args.control, sweep, args.sweep_seconds)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    if sweep:
        print(json.dumps(result, default=float))
        return 0
    for name, item in result["checks"].items():
        print(f"check {name}: {item['value']!r} (limit {item['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
