"""What decides `correct`: the program's answers, as the client received
them, held against the plain reference (`reference/exact.py`).

Every answer of the window (identical answers to the same query are
judged once) must hold k known ids, each once, in ascending order of
finite distance (`bad_answers`); each distance must lie within the
cell's `dist_gap` of the reference's float32 distance of that query to
that row; and the rows must be the right ones (`topk_miss`): the share,
over all answers, of the reference's exact top-k rows that an answer
leaves out, where a left-out row counts only if its reference distance
lies below that of the answer's farthest row by more than the cell's
`tie` (the program ranks by its own float32 distances, which stray from
the reference's by rounding, so rows closer than that may swap).
Recall@10 against the same exact top-k is logged beside them, with the
margin of each left-out row.

Each number has its limit in `limits/<cell>.json`, beside `tie`; a run
is correct when every number is at or under its limit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

NUMBERS = ("failed", "bad_answers", "dist_gap", "topk_miss")


@dataclasses.dataclass
class Check:
    numbers: dict[str, float]
    limits: dict[str, float]
    recall: Optional[float] = None
    answers: int = 0
    # the smallest margins (distance units) of left-out rows, unique answers
    margins: list = dataclasses.field(default_factory=list)

    @property
    def correct(self) -> bool:
        return all(self.numbers[n] <= self.limits[n] for n in self.numbers)

    def table(self) -> dict[str, dict[str, float]]:
        return {n: {"value": v, "limit": self.limits[n]}
                for n, v in self.numbers.items()}


def never_answered(rec: dict) -> int:
    return int(np.isnan(rec["done"]).sum())


def _lookup(ids: np.ndarray, n_ids: int) -> np.ndarray:
    """Dense id -> row table; -1 for an id that names no row."""
    table = np.full(int(ids.max()) + 2 if len(ids) else 1, -1, np.int64)
    table[ids.astype(np.int64)] = np.arange(n_ids)
    return table


def _rows_of(ids: np.ndarray, table: np.ndarray) -> np.ndarray:
    ids = ids.astype(np.int64)
    inside = (ids >= 0) & (ids < len(table))
    return np.where(inside, table[np.where(inside, ids, 0)], -1)


def _bad(rows: np.ndarray, dists: np.ndarray) -> np.ndarray:
    """Per answer: an unknown id, an id twice, a distance out of order or
    not finite."""
    srt = np.sort(rows, axis=1)
    dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    order = (np.diff(dists, axis=1) < 0).any(axis=1)
    return (rows < 0).any(axis=1) | dup | order | ~np.isfinite(dists).all(axis=1)


def _unique_answers(q: np.ndarray, ids: np.ndarray, dists: np.ndarray):
    """One entry per distinct (query, ids, distances); with the index of
    each answer's entry."""
    k = ids.shape[1]
    rec = np.empty(len(q), dtype=[("q", "<i8"), ("i", "<u8", (k,)), ("d", "<f4", (k,))])
    rec["q"], rec["i"], rec["d"] = q, ids, dists
    _, first, inverse = np.unique(rec.view(f"V{rec.dtype.itemsize}"),
                                  return_index=True, return_inverse=True)
    return first, inverse.reshape(-1)


def search(cell, data, records: dict, base_ids: np.ndarray, device) -> Check:
    import torch

    from portbench.reference import exact

    cfg = cell.config
    metric, k = cfg["collection"]["metric"], cfg["collection"]["k"]
    limits = {n: float(cell.limits[n]) for n in NUMBERS}
    tie = float(cell.limits["tie"])
    ok = records["query_ok"]
    q, ids, dists = records["pool_idx"][ok], records["ids"][ok], records["dists"][ok]
    numbers = {"failed": float(records["n_errors"] + never_answered(records)),
               "bad_answers": 0.0, "dist_gap": 0.0, "topk_miss": 0.0}
    if not len(q):
        return Check(numbers, limits)
    first, inverse = _unique_answers(q, ids, dists)
    uq, ud = q[first], dists[first]
    rows = _rows_of(ids[first], _lookup(base_ids, len(base_ids)))
    asked = np.unique(uq)

    def on_device(a):
        return torch.from_numpy(a).to(device)

    base, queries = on_device(data.base), on_device(data.queries[uq])
    truth = exact.exact_topk(on_device(data.queries[asked]), base, metric, k)
    truth = truth.cpu().numpy()[np.searchsorted(asked, uq)]
    ref = exact.answer_distances(queries, on_device(rows), base, metric).cpu().numpy()
    ref_truth = exact.answer_distances(queries, on_device(truth), base,
                                       metric).cpu().numpy()
    valid = rows >= 0
    missing = ~(truth[:, :, None] == rows[:, None, :]).any(axis=2)
    margin = ref.max(axis=1, keepdims=True) - ref_truth
    nearer = margin > tie
    numbers["bad_answers"] = float(_bad(rows, ud).sum())
    numbers["dist_gap"] = (float(np.abs(ud.astype(np.float64) - ref)[valid].max())
                           if valid.any() else 0.0)
    numbers["topk_miss"] = float(((missing & nearer).sum(axis=1) / k)[inverse].mean())
    recall = float((1.0 - missing.sum(axis=1) / k)[inverse].mean())
    return Check(numbers, limits, recall, int(ok.sum()),
                 np.sort(margin[missing])[:64].tolist())
