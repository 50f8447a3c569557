"""The port imports no JAX, and never falls back from CUDA to the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

_SCRIPT = r"""
import sys
import numpy as np
from scintirete_tpu_torch import DistanceMetric, HNSWParams, SearchParams
from scintirete_tpu_torch.index.hnsw import HNSWIndex

rng = np.random.default_rng(0)
base = rng.standard_normal((2100, 8)).astype(np.float32)
idx = HNSWIndex(8, HNSWParams(m=4, ef_construction=16, seed=1),
                DistanceMetric.COSINE, device="cpu")
idx.bulk_insert(list(range(1, 2101)), base)  # the kNN bulk build
hits = idx.search(base[7], SearchParams(top_k=3))
assert hits[0][0] == 8, hits
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("ok")
"""


def test_port_builds_and_searches_without_jax():
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
