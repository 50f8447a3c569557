"""Cells of the real benchmark cut to a size the CPU runs in seconds, for
the harness's own tests (the program's plain torch paths, device "cpu")."""

from __future__ import annotations

import time

from portbench import spec


def cell(name: str) -> spec.Cell:
    c = spec.cell(spec.load_benchmark(), name)
    c.config["data"].update(n=3000, queries=200, centres=40)
    c.traffic.update(batch=32, warmup_calls=1)
    return c


def run(name: str, seed: int = 2**31 + 77, seconds: float = 1.5,
        device: str = "cpu", **kwargs) -> dict:
    from portbench.run import run_cell

    return run_cell(cell(name), seed, seconds, device=device,
                    t_start=time.monotonic(), **kwargs)
