"""A client process: `python3 -m portbench.client`, started by the harness.

It imports numpy, grpc and the frozen proto copy only (no torch, nothing
of the program). The harness writes pickled messages to its stdin and
reads pickled replies from its stdout:
  1. {"driver", "address", "password", "db", "collection", "k", "seed",
     "traffic", "payload"} -> the traffic module prepares its requests, warms its
     channel and the server's path, and replies {"ready": info};
  2. {"cmd": "go", "t0", "seconds", "override"} -> the traffic module runs its
     traffic from monotonic time t0 for `seconds` and replies
     {"records": ...}; repeated for a sweep;
  3. {"cmd": "stop"} -> the process closes its channels and exits.
"""

from __future__ import annotations

import importlib.util
import pickle
import sys
from pathlib import Path


def load_driver(name: str):
    path = Path(__file__).resolve().parent / "drivers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_driver_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    inp, out = sys.stdin.buffer, sys.stdout.buffer
    setup = pickle.load(inp)
    driver = load_driver(setup["driver"])
    state = driver.prepare(setup)
    try:
        pickle.dump({"ready": driver.warmup(state)}, out)
        out.flush()
        while True:
            msg = pickle.load(inp)
            if msg["cmd"] == "stop":
                return 0
            records = driver.run(state, msg["t0"], msg["seconds"],
                                 **msg.get("override", {}))
            pickle.dump({"records": records}, out)
            out.flush()
    finally:
        driver.close(state)


if __name__ == "__main__":
    sys.exit(main())
