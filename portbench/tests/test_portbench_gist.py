"""The `gist1m-hnsw.batch` cell: `correct` separates at D 960 as it does
in the other cells (`test_portbench_correct.py`), and its new per-layer
readers read what they should and nothing where the program lacks it.

At `tiny`'s 3,000 rows, searched on the device path as the cell's million
rows are (`device_search_min_size` 0: below it the host path answers,
whose L2 is the comparison form), with a pool of 2,000 queries: at its 200
the pool holds too few rows near the tenth to show the selection
control's misses."""

import pytest

from portbench import spec
from portbench.tests import tiny
from portbench.tests.test_portbench_correct import _search_fault
from portbench.trace import DeviceTrace, KernelCalls

CELL = "gist1m-hnsw.batch"


def run(**kwargs):
    import time

    from portbench.run import run_cell

    c = tiny.cell(CELL)
    c.config["data"].update(queries=2000)
    c.config["deployment"]["tpu"]["device_search_min_size"] = 0
    return run_cell(c, 2**31 + 77, 1.5, device="cpu", t_start=time.monotonic(),
                    **kwargs)


def test_program_is_correct():
    res = run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("control", ["tf32", "tf32-select"])
def test_controls_are_not_correct(control):
    res = run(control=control)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered", "skip"])
def test_search_faults_are_not_correct(kind):
    res = run(tamper=_search_fault(kind))
    assert not res["correct"], res["checks"]
    if kind == "skip":
        assert res["checks"]["topk_miss"]["value"] > res["checks"]["topk_miss"]["limit"]


class _Run:
    """What a traced run hands the readers: the cell, the beam's counters
    before and after the window, the pivot scan's calls in the stretch
    and the device's operations there."""

    def __init__(self, before, after, calls, events):
        self.cell = spec.cell(spec.load_benchmark(), CELL)
        self.counters = {"steps": (before, after)}
        self.calls = KernelCalls()
        self.calls.shapes["pivot_entry_scan"] = calls
        self.trace = DeviceTrace(0.0, 1.0, events)
        self.records = {}


def _read(name, run_):
    return spec.read_metric("layer_metrics", {"name": name}, run_)


def test_row_roofline_by_hand():
    """1,000 queries in the window, each scored 10 steps x 128 rows of 960
    f32; 512 of them in the stretch, whose device time is 0.1 s besides
    the pivot scan's 0.05 s."""
    before = {"batches": 0, "queries": 0, "layer0": 0, "dist_rows": 0}
    after = {"batches": 4, "queries": 1000, "layer0": 40,
             "dist_rows": 1000 * 10 * 128}
    calls = [{"B": 256, "R": 131072, "D": 960}] * 2
    events = [("pivot_scan_kernel<128>", 0.1, 0.15), ("gather", 0.2, 0.3)]
    share = _read("beam.row_roofline.gist", _Run(before, after, calls, events))
    row_bytes = 10 * 128 * 960 * 4
    assert share == pytest.approx(100.0 * row_bytes * 512 / 3.35e12 / 0.1)
    assert _read("beam.steps_per_subbatch.gist",
                 _Run(before, after, calls, events)) == 10.0
    assert _read("device.idle.gist",
                 _Run(before, after, calls, events)) == pytest.approx(85.0)
    assert _read("beam.device_ms_per_kq.gist",
                 _Run(before, after, calls, events)) == pytest.approx(
                     1000.0 * 0.1 / 0.512)


def test_readers_read_nothing_where_the_program_lacks_it():
    """A program without the "queries" / "dist_rows" counters (as before
    them), a run without a trace, and a stretch without a pivot call."""
    old = {"batches": 4, "layer0": 40, "graph_steps": 40, "graph_captures": 1}
    calls = [{"B": 256, "R": 131072, "D": 960}]
    events = [("gather", 0.2, 0.3)]
    assert _read("beam.row_roofline.gist", _Run(old, old, calls, events)) is None
    bare = _Run(old, old, calls, events)
    bare.trace = bare.calls = None
    bare.counters = {"steps": None}
    for name in ("beam.row_roofline.gist", "beam.steps_per_subbatch.gist",
                 "beam.device_ms_per_kq.gist", "pivot_entry_scan_roofline.gist",
                 "device.idle.gist"):
        assert _read(name, bare) is None, name
    new = {"batches": 0, "queries": 0, "layer0": 0, "dist_rows": 0}
    assert _read("beam.row_roofline.gist", _Run(new, new, calls, events)) is None
    assert _read("beam.row_roofline.gist", _Run(new, dict(new, queries=5), [],
                                                events)) is None
