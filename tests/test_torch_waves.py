"""A query's search answer does not depend on the other queries of its
batch. The server's batcher stacks unrelated single-query Search RPCs into
waves of 1 to `search_batch_size` rows, so an answer that moved with the
wave would differ between two identical requests (and between gRPC and
HTTP). The HNSW beam's distance is therefore an elementwise product and a
sum, whose bits do not depend on the batch (`torch.bmm` picks kernels, and
summation orders, by the batch's size: on one H100 it changed the
distance bits of 525 of 1,024 queries between waves of 1-64 and batches
of 256, `scripts/torch_serve_waves.py`).

The card test runs with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_waves.py

and imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from scintirete_tpu_torch import CollectionConfig, DistanceMetric, HNSWParams
from scintirete_tpu_torch import SearchParams
from scintirete_tpu_torch.engine import Engine
from scintirete_tpu_torch.index import device as device_mod


@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("rows", [[0], [5, 6], list(range(17))])
def test_beam_distance_bits_do_not_depend_on_the_batch(metric, rows):
    """The beam's distances of some queries alone equal, bit for bit,
    theirs inside a batch of 64 (the beam's shapes: expand 4 x degree 32
    candidates of D = 128)."""
    rng = np.random.default_rng(metric)
    q = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    vecs = torch.from_numpy(
        rng.standard_normal((64, 128, 128)).astype(np.float32))
    q_sq = (q * q).sum(dim=-1)
    v_sq = (vecs * vecs).sum(dim=-1)
    full = device_mod._cmp_dist(q, q_sq, q_sq.sqrt(), vecs, v_sq, metric)
    r = torch.tensor(rows)
    part = device_mod._cmp_dist(q[r], q_sq[r], q_sq[r].sqrt(), vecs[r],
                                v_sq[r], metric)
    assert torch.equal(part, full[r])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", list(DistanceMetric)[1:])
def test_search_answers_do_not_depend_on_the_wave(dev, metric):
    """On the card: 512 queries searched in batches of 256, in random waves
    of 1-64 and one at a time get the same ids and distance bits."""
    rng = np.random.default_rng(int(metric))
    base = rng.standard_normal((20_000, 128)).astype(np.float32)
    queries = base[:512] + 0.1 * rng.standard_normal((512, 128)).astype(
        np.float32)
    col = Engine(device=dev).create_database("d").create_collection(
        CollectionConfig(name="c", metric=metric,
                         hnsw=HNSWParams(m=16, ef_construction=100, seed=3)))
    col.insert([(v, None) for v in base])
    sp = SearchParams(top_k=10, ef_search=12)
    want_i, want_d = col.search_batch_arrays(queries, sp)
    got_i, got_d, s = [], [], 0
    while s < len(queries):
        w = int(rng.integers(1, 65))
        i, d = col.search_batch_arrays(queries[s : s + w], sp)
        got_i.append(i)
        got_d.append(d)
        s += w
    assert np.array_equal(np.concatenate(got_i), want_i)
    assert np.array_equal(np.concatenate(got_d), want_d)
    for j in range(16):
        i, d = col.search_batch_arrays(queries[j : j + 1], sp)
        assert np.array_equal(i[0], want_i[j])
        assert np.array_equal(d[0], want_d[j])
