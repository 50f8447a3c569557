"""The benchmark finds configurations, traffic mixes, metrics and roofline
counts by name, and picks up a cell and a metric added as files alone."""

import json
import shutil

import numpy as np
import pytest

from portbench import check, datagen, peaks, spec


def test_every_named_file_is_found():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        c = spec.cell(bench, w["name"])
        assert c.config["name"] == w["config"]
        assert spec.driver(c.traffic["driver"]).KIND == "search"
        assert set(c.limits) == set(check.NUMBERS) | {"tie"}
        assert c.end_to_end and c.per_layer
        assert "setup_s" in {m["name"] for m in c.end_to_end}
    for m in bench["end_to_end"]:
        assert callable(spec.load_module("end_to_end", m["name"]).read)
    for m in bench["per_layer"]:
        assert callable(spec.load_module("layer_metrics", m["name"]).read)
        for cell in m["workloads"]:
            moved = {e["name"] for e in spec.cell(bench, cell).end_to_end}
            assert m["moves"] in moved, (m["name"], cell)


def test_cell_and_metric_added_as_files(tmp_path):
    """A later change adds a traffic mix, a cell, its limits and a metric
    reader as files and entries; no existing file changes."""
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.load_benchmark()
    (tmp_path / "portbench/traffic/search-open-77.json").write_text(
        json.dumps({"driver": "open_search", "rate": 77}))
    (tmp_path / "portbench/limits/glove100-hnsw.slow.json").write_text(
        json.dumps({"failed": 0, "bad_answers": 0, "dist_gap": 1e-5, "topk_miss": 1e-3,
                    "tie": 2e-6}))
    (tmp_path / "portbench/layer_metrics/client.requests.slow.py").write_text(
        "def read(run):\n    return float(len(run.records['ok']))\n")
    bench["workloads"].append({"name": "glove100-hnsw.slow", "config": "glove100-hnsw",
                               "traffic": "search-open-77", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "client.requests.slow", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "transport",
                               "moves": "search_qps", "workloads": ["glove100-hnsw.slow"]})
    bench["end_to_end"][0]["workloads"].append("glove100-hnsw.slow")
    c = spec.cell(bench, "glove100-hnsw.slow", root=tmp_path)
    assert c.traffic["rate"] == 77 and c.limits["dist_gap"] == 1e-5
    assert [m["name"] for m in c.per_layer] == ["client.requests.slow"]
    assert "search_qps" in {m["name"] for m in c.end_to_end}

    class Run:
        records = {"ok": np.ones(5, bool)}

    entry = c.per_layer[0]
    assert spec.read_metric("layer_metrics", entry, Run(), root=tmp_path / "portbench") == 5.0


def test_data_is_the_seeds():
    d = {"n": 5000, "dim": 12, "queries": 50, "centres": 20, "centre_scale": 2.0,
         "point_noise": 0.4, "query_noise": 0.2}
    a, b, c = (datagen.dataset(s, d) for s in (2**31 + 5, 2**31 + 5, 2**31 + 6))
    for x, y in ((a.base, b.base), (a.queries, b.queries), (a.centres, b.centres)):
        assert x.dtype == np.float32 and np.array_equal(x, y)
    assert not np.array_equal(a.base, c.base)
    assert a.base.shape == (5000, 12) and a.queries.shape == (50, 12)


@pytest.mark.parametrize("kernel,shape,ops,nbytes,kind", [
    # 2 B R D; 4 B D + 4 R D + 8 R (norms, flags) + 8 B (distance, row)
    ("pivot_entry_scan", {"B": 4, "R": 8, "D": 16}, 2 * 4 * 8 * 16,
     4 * 4 * 16 + 4 * 8 * 16 + 8 * 8 + 8 * 4, "f32"),
    # 2 B N D; 4 B D (f32 queries) + N D (int8) + 12 N + 8 B 2048 (keys, rows)
    ("flat_packed_int8", {"B": 2, "N": 2048, "D": 32}, 2 * 2 * 2048 * 32,
     4 * 2 * 32 + 2048 * 32 + 12 * 2048 + 8 * 2 * 2048, "int8"),
])
def test_roofline_counts_by_hand(kernel, shape, ops, nbytes, kind):
    assert spec.load_module("roofline", kernel).work(shape) == (ops, nbytes, kind)


def test_roofline_shapes_from_calls():
    import torch

    pivot = spec.load_module("roofline", "pivot_entry_scan")
    assert pivot.shape_of(torch.zeros(5, 12), torch.zeros(64, 12), None, None, 2) == \
        {"B": 5, "R": 64, "D": 12}
    flat = spec.load_module("roofline", "flat_packed_int8")
    assert flat.shape_of(torch.zeros(3, 32), torch.zeros(4096, 32, dtype=torch.int8)) == \
        {"B": 3, "N": 4096, "D": 32}


def test_roofline_share_is_least_time_over_device_time():
    from portbench.trace import DeviceTrace, KernelCalls

    calls = KernelCalls()
    calls.shapes["pivot_entry_scan"] = [{"B": 256, "R": 65536, "D": 100}] * 2
    least = 2 * peaks.least_seconds(*spec.load_module("roofline", "pivot_entry_scan").work(
        calls.shapes["pivot_entry_scan"][0]))
    trace = DeviceTrace(0.0, 1.0, [("pivot_scan_kernel<128>", 0.1, 0.1 + least),
                                   ("finish_keys", 0.5, 0.5 + least), ("other", 0.2, 0.4)])

    class Run:
        pass

    run = Run()
    run.trace, run.calls = trace, calls
    assert peaks.roofline_share(run, "pivot_entry_scan") == pytest.approx(50.0)
    run.calls = KernelCalls()
    assert peaks.roofline_share(run, "pivot_entry_scan") is None


def test_only_the_kernels_a_cell_reads_are_wrapped():
    """A traced run wraps the kernel entries that its own per-layer
    readers name, so a roofline file added for another cell changes
    nothing in it."""
    from portbench.run import rooflines_read

    bench = spec.load_benchmark()
    assert rooflines_read(spec.cell(bench, "glove100-hnsw.batch")) == ["pivot_entry_scan"]
    assert rooflines_read(spec.cell(bench, "sift1m-flat.batch")) == ["flat_packed_int8"]
    for w in bench["workloads"]:
        for kernel in rooflines_read(spec.cell(bench, w["name"])):
            assert (spec.HERE / "roofline" / f"{kernel}.py").exists()
