"""The port imports no JAX and nothing of the JAX package, and never falls
back from CUDA to the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

_SCRIPT = r"""
import sys
import numpy as np
from scintirete_tpu_torch import DistanceMetric, HNSWParams, SearchParams
from scintirete_tpu_torch.engine import Engine
from scintirete_tpu_torch.index.hnsw import HNSWIndex
from scintirete_tpu_torch.types import CollectionConfig

rng = np.random.default_rng(0)
base = rng.standard_normal((4300, 8)).astype(np.float32)
params = HNSWParams(m=4, ef_construction=16, seed=1)
idx = HNSWIndex(8, params, DistanceMetric.COSINE, device="cpu")
idx.bulk_insert(list(range(1, 2101)), base[:2100])  # the kNN bulk build
idx.bulk_insert(list(range(2101, 4301)), base[2100:])  # the batched append
hits = idx.search(base[7], SearchParams(top_k=3))
assert hits[0][0] == 8, hits
assert idx.search(base[4000], SearchParams(top_k=1))[0][0] == 4001
# the chunked device insertion, through the engine
col = Engine(device="cpu").create_database("d").create_collection(
    CollectionConfig(name="c", hnsw=params)
)
col.insert([(v, None) for v in base[:300]])
assert col.search(base[290], SearchParams(top_k=1))[0].id == 291
leaked = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.")
    or m == "scintirete_tpu" or m.startswith("scintirete_tpu.")
)
assert not leaked, leaked
print("ok")
"""


def test_port_builds_and_searches_without_jax():
    """A build, an append and a chunked insert leave neither jax nor any
    module of the JAX package in sys.modules."""
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
        timeout=120, cwd=Path(__file__).resolve().parents[1],
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_cuda_device_without_cuda_raises(monkeypatch):
    from scintirete_tpu_torch.engine import Engine
    from scintirete_tpu_torch.index.hnsw import HNSWIndex
    from scintirete_tpu.types import CollectionConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HNSWIndex(8, device="cuda")
    col = Engine().create_database("d").create_collection(
        CollectionConfig(name="c")
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        col.insert([([0.0] * 8, None)])
    assert col.count() == 0
