"""`correct` separates: the controls (the reference one step of precision
below float32, in the program's place, in full or in its choice of rows
alone) and each fault a cell can have, planted under the timed path,
come out not correct; the program itself comes out correct. At a size
the CPU holds (`tiny`); the run skips the look for a card and drives
everything else."""

import dataclasses

import numpy as np
import pytest

from portbench.tests import tiny

SEARCH_CELLS = ("sift1m-flat.batch", "glove100-hnsw.batch")


@pytest.mark.parametrize("name", SEARCH_CELLS)
def test_program_is_correct(name):
    res = tiny.run(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", SEARCH_CELLS)
def test_program_is_correct_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    res = tiny.run(name, device="cuda")
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0


@pytest.mark.parametrize("name", SEARCH_CELLS)
def test_control_is_not_correct(name):
    res = tiny.run(name, control="tf32")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", SEARCH_CELLS)
def test_selection_control_misses_rows(name):
    """The reference choosing its rows in TF32 and returning float32
    distances passes every check but the rows': it leaves out rows that
    the program finds (at the cell's own size it reads above the limit;
    this size holds too few near rows to reach it)."""
    program = tiny.run(name)["checks"]
    res = tiny.run(name, control="tf32-select")
    checks = res["checks"]
    assert checks["dist_gap"]["value"] == 0.0 and checks["bad_answers"]["value"] == 0.0
    assert checks["topk_miss"]["value"] > max(program["topk_miss"]["value"], 0.0)


def _search_fault(kind):
    def tamper(system):
        col = system.collection()
        orig_lists, orig_arrays = col.search_batch, col.search_batch_arrays
        first = {}

        def lists(queries, params):
            if kind == "half":  # half the batch searched, its answers reused
                out = orig_lists(queries[: (len(queries) + 1) // 2], params)
                return (out * 2)[: len(queries)]
            out = orig_lists(queries, params)
            if kind == "unchanged":  # every query gets the first answer seen
                first.setdefault("a", out[0])
                return [first["a"] for _ in out]
            if kind == "skip":  # the nearest row left out, the next one
                more = orig_lists(queries, dataclasses.replace(params, top_k=params.top_k + 1))
                return [hits[1:] for hits in more]  # ...in, its distance right
            out[0][0].id += 1  # one id altered where it is produced
            return out

        def arrays(queries, params):
            if kind == "half":
                ids, d = orig_arrays(queries[: (len(queries) + 1) // 2], params)
                return np.concatenate([ids, ids])[: len(queries)], \
                    np.concatenate([d, d])[: len(queries)]
            if kind == "skip":
                ids, d = orig_arrays(queries, dataclasses.replace(params, top_k=params.top_k + 1))
                return ids[:, 1:], d[:, 1:]
            ids, d = orig_arrays(queries, params)
            if kind == "unchanged":
                first.setdefault("b", (ids[:1].copy(), d[:1].copy()))
                return np.repeat(first["b"][0], len(ids), 0), np.repeat(first["b"][1], len(d), 0)
            ids = ids.copy()
            ids[0, 0] += 1
            return ids, d

        col.search_batch, col.search_batch_arrays = lists, arrays

    return tamper


@pytest.mark.parametrize("name", SEARCH_CELLS)
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered", "skip"])
def test_search_faults_are_not_correct(name, kind):
    res = tiny.run(name, tamper=_search_fault(kind))
    assert not res["correct"], res["checks"]
    if kind == "skip":
        assert res["checks"]["topk_miss"]["value"] > res["checks"]["topk_miss"]["limit"]
