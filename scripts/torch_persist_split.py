"""Where the port's recovery spends its host time, part by part.

    python3 scripts/torch_persist_split.py            # from the repo root
    python3 scripts/torch_persist_split.py --n 20000  # a quick run

Prints, one JSON object a line:
 1. which of msgpack, flatbuffers, grpc and google.protobuf this Python
    can import (the port's persistence needs msgpack, its admin tool's
    import-/export-reference flatbuffers, the server will need the last
    two), with the host's CPU count and the card's name and power limit
    where nvidia-smi answers;
 2. `persistence.serde` (msgpack) on one AOF insert record of 4,096 x 128
    floats as the server logs it (elements as lists, a small metadata
    dict each): dump and load seconds, medians of 5, and the record's
    bytes;
 3. a snapshot-sized state (--n x 128 f32 vectors, an HNSW graph of m = 16
    with its upper layers, and a flat index of the same rows): serde dump
    and load seconds, then `HNSWIndex.import_graph_state` and
    `FlatIndex.import_graph_state` whole, and the Python loop over every
    slot that each runs to fill its id -> slot dict, timed alone, beside
    the same dict built by one `dict(zip(...))`.

Host work only: the indexes are restored on the CPU device (their mirror
on the card is built at the first search, which chip_smoke.py times).
The data is made from --seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

DIM, M = 128, 16


def median_s(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def card():
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    return subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip() or None


def record(rng):
    from scintirete_tpu_torch.engine.database import make_command

    vecs = rng.standard_normal((4096, DIM)).astype(np.float32)
    return make_command("INSERT_VECTORS", "db", "c", {"vectors": [
        {"id": i + 1, "elements": v.tolist(), "metadata": {"row": i}}
        for i, v in enumerate(vecs)
    ]}, timestamp=1.0)


def graph_state(rng, n):
    """An HNSW graph state of n rows with the export's keys and dtypes:
    levels drawn as the store draws them, random neighbors."""
    from scintirete_tpu_torch import HNSWParams

    levels = np.floor(-np.log(1.0 - rng.random(n)) / np.log(2.0))
    levels = np.minimum(levels, 15).astype(np.int32)
    layers = []
    for lv in range(1, int(levels.max()) + 1):
        slots = np.flatnonzero(levels >= lv).astype(np.int32)
        layers.append({
            "count": len(slots), "node_slot": slots,
            "nbrs": rng.integers(0, len(slots), (len(slots), M), np.int32),
        })
    return {
        "dim": DIM, "metric": 2,
        "params": dataclasses.asdict(HNSWParams(m=M, seed=42)),
        "count": n, "live": n, "entry_slot": int(np.argmax(levels)),
        "max_layer": int(levels.max()),
        "vectors": rng.standard_normal((n, DIM)).astype(np.float32),
        "levels": levels, "deleted": np.zeros(n, np.bool_),
        "neighbors0": rng.integers(0, n, (n, 2 * M), np.int32),
        "layers": layers,
        "slot_to_id": np.arange(1, n + 1, dtype=np.uint64),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="rows")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from scintirete_tpu_torch.index.flat import FlatIndex
    from scintirete_tpu_torch.index.hnsw import HNSWIndex
    from scintirete_tpu_torch.persistence import serde

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("msgpack", "flatbuffers", "grpc", "google.protobuf")}
    print(json.dumps({"packages": have, "cpus": os.cpu_count(),
                      "card": card()}), flush=True)

    rng = np.random.default_rng(args.seed)
    cmd = record(rng)
    blob = serde.dumps(cmd)
    print(json.dumps({"record": "4096 x 128 insert", "bytes": len(blob),
                      "dump_s": median_s(lambda: serde.dumps(cmd), 5),
                      "load_s": median_s(lambda: serde.loads(blob), 5)}),
          flush=True)
    del cmd, blob

    state = graph_state(rng, args.n)
    out = {"rows": args.n}
    t0 = time.perf_counter()
    blob = serde.dumps(state)
    out["state_dump_s"] = time.perf_counter() - t0
    out["state_bytes"] = len(blob)
    t0 = time.perf_counter()
    back = serde.loads(blob)
    out["state_load_s"] = time.perf_counter() - t0
    del blob
    t0 = time.perf_counter()
    HNSWIndex.import_graph_state(back, device="cpu")
    out["hnsw_import_s"] = time.perf_counter() - t0
    flat = {"kind": "flat", **{k: back[k] for k in (
        "dim", "metric", "params", "count", "live", "vectors", "deleted",
        "slot_to_id")}}
    t0 = time.perf_counter()
    FlatIndex.import_graph_state(flat, device="cpu")
    out["flat_import_s"] = time.perf_counter() - t0

    levels, slot_to_id = back["levels"], back["slot_to_id"]

    def hnsw_loop():  # index/hnsw.py import_graph_state, the id dict
        d = {}
        for slot in range(args.n):
            if levels[slot] >= 0:
                d[int(slot_to_id[slot])] = slot
        return d

    def flat_loop():  # index/flat.py import_graph_state, the id dict
        d = {}
        for slot in range(args.n):
            d[int(slot_to_id[slot])] = slot
        return d

    out["hnsw_slot_loop_s"] = median_s(hnsw_loop, 3)
    out["flat_slot_loop_s"] = median_s(flat_loop, 3)
    out["dict_zip_s"] = median_s(
        lambda: dict(zip(slot_to_id.tolist(), range(args.n))), 3)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
