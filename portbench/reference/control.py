"""Controls: the reference put in the program's place.

`ControlCollection` stands where the service finds the program's
collection and answers the same calls (`search_batch`,
`search_batch_arrays`, `insert`, `info`) with exact search, each answer's
rows ordered by the distances it returns. Run through the whole served
path, each has to come out as not correct:
- "tf32": rows held in TF32 and products summed from TF32 operands
  (`exact.in_precision(..., "tf32")`), one step of precision below the
  configuration's float32, both to choose the rows and for the distances
  returned; if it passed, the comparison could not tell float32 from the
  step below it;
- "tf32-select": the rows chosen as "tf32" chooses them, their distances
  returned in float32: a lower-precision selection with an exact rerank,
  which only the check of the rows themselves (`topk_miss`) can catch.
"""

from __future__ import annotations

import threading
import types
import uuid

import numpy as np
import torch

from portbench.reference import exact

# control -> (precision of the selection, precision of the distances)
CONTROLS = {"tf32": ("tf32", "tf32"), "tf32-select": ("tf32", "f32")}


class ControlCollection:
    def __init__(self, name: str, dim: int, metric: str, device: str,
                 control: str = "tf32"):
        if control not in CONTROLS:
            raise ValueError(f"unknown control {control!r}")
        self.select, self.precision = CONTROLS[control]
        self.name = name
        self.uid = uuid.uuid4().hex
        self.metric = metric
        self.device = torch.device(device)
        self.dim = dim
        self.rows = torch.zeros((0, dim), device=self.device)
        self.ids = np.zeros(0, np.uint64)
        self.next_id = 1
        self.lock = threading.Lock()

    def insert(self, pairs) -> list[int]:
        mat = np.stack([np.asarray(e, np.float32) for e, _ in pairs])
        new = torch.from_numpy(mat).to(self.device)
        with self.lock:
            ids = list(range(self.next_id, self.next_id + len(mat)))
            self.next_id += len(mat)
            self.rows = torch.cat([self.rows, new])
            self.ids = np.concatenate([self.ids, np.asarray(ids, np.uint64)])
        return ids

    def search_batch_arrays(self, queries, params):
        q = torch.from_numpy(np.array(queries, np.float32)).to(self.device)
        with self.lock:
            rows, ids = self.rows, self.ids
        top = exact.exact_topk(q, rows, self.metric, params.top_k, self.select)
        d = exact.answer_distances(q, top, rows, self.metric, self.precision)
        d, order = torch.sort(d, dim=1, stable=True)
        top = top.gather(1, order)
        return (ids[top.cpu().numpy()].astype(np.uint64),
                d.cpu().numpy().astype(np.float32))

    def search_batch(self, queries, params):
        ids, dists = self.search_batch_arrays(queries, params)
        return [
            [types.SimpleNamespace(id=int(i), distance=float(d), metadata=None,
                                   vector=None)
             for i, d in zip(ri, rd)]
            for ri, rd in zip(ids, dists)
        ]

    def count(self) -> int:
        return len(self.ids)

    def info(self):
        return types.SimpleNamespace(
            name=self.name, dimension=self.dim, vector_count=len(self.ids),
            deleted_count=0, memory_bytes=self.rows.numel() * 4,
        )
