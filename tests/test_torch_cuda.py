"""The port's CUDA kernels against their plain torch versions, on a card.

Marked `cuda`: these tests need an NVIDIA GPU with nvcc and skip without
one. On a machine with a card (no JAX needed; the repo's conftest imports
JAX, so leave it out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

They cover the shapes the main-path check (chip_smoke.py) does not: a
ragged pivot count, depths that are not a multiple of 8 (the kernels'
unvectorized loads), query counts that are not a multiple of the 64-row
tile, and a small build and search on the card.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("B,R,D", [(7, 64, 16), (100, 1000, 33), (65, 777, 128)])
def test_pivot_kernel_matches_plain(dev, metric, B, R, D):
    from scintirete_tpu_torch.ops.pivot_scan import (
        pivot_entry_scan,
        pivot_entry_scan_plain,
    )

    g = torch.Generator(device=dev).manual_seed(B * R + D)
    q = torch.randn(B, D, generator=g, device=dev)
    pv = torch.randn(R, D, generator=g, device=dev)
    if metric == 2:
        q = q / q.norm(dim=1, keepdim=True)
        pv = pv / pv.norm(dim=1, keepdim=True)
    psq = (pv * pv).sum(1)
    pdel = (torch.arange(R, device=dev) % 5 == 0).float()
    before = pivot_entry_scan.launches
    d_k, i_k = pivot_entry_scan(q, pv, psq, pdel, metric)
    d_p, i_p = pivot_entry_scan_plain(q, pv, psq, pdel, metric)
    torch.cuda.synchronize()
    assert pivot_entry_scan.launches == before + 1
    torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=1e-4)
    assert torch.equal(i_k, i_p)


@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("B,N,D,n_valid,tiles", [
    (64, 2048, 16, 2048, 2), (300, 4096, 40, 3000, 3), (129, 3072, 128, 1, 1),
])
def test_lane_kernel_matches_plain(dev, metric, B, N, D, n_valid, tiles):
    from scintirete_tpu_torch.ops.lane_scan import lane_scan, lane_scan_plain

    g = torch.Generator(device=dev).manual_seed(B + N + D)
    base32 = torch.randn(N, D, generator=g, device=dev)
    base = base32.to(torch.bfloat16)
    bsq = (base32 * base32).sum(1)
    qb = base[:B].contiguous()
    si = torch.arange(B, dtype=torch.int32, device=dev)
    k_out = lane_scan(qb, si, base, bsq, n_valid, metric, tiles)
    p_out = lane_scan_plain(qb, si, base, bsq, n_valid, metric, tiles)
    torch.cuda.synchronize()
    for k, p in zip(k_out, p_out):
        if k.dtype == torch.float32:
            fin = torch.isfinite(p)
            assert torch.equal(fin, torch.isfinite(k))
            torch.testing.assert_close(k[fin], p[fin], rtol=1e-5, atol=1e-4)
        else:
            assert (k == p).float().mean() > 0.999


def test_bad_inputs_raise(dev):
    from scintirete_tpu_torch.ops.lane_scan import lane_scan
    from scintirete_tpu_torch.ops.pivot_scan import pivot_entry_scan

    q = torch.randn(4, 16, device=dev)
    pv = torch.randn(64, 16, device=dev)
    with pytest.raises(ValueError):
        pivot_entry_scan(q, pv.double(), (pv * pv).sum(1), torch.zeros(64, device=dev), 1)
    base = torch.randn(2048, 16, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError):
        lane_scan(base[:4].float(), torch.arange(4, device=dev, dtype=torch.int32),
                  base, torch.ones(2048, device=dev), 100, 1, 1)
    with pytest.raises(ValueError):
        lane_scan(base[:4], torch.arange(4, device=dev, dtype=torch.int32),
                  base[:1000], torch.ones(1000, device=dev), 100, 1, 1)


def test_build_and_search_on_the_card(dev):
    from scintirete_tpu_torch import DistanceMetric, HNSWParams, SearchParams
    from scintirete_tpu_torch.index.hnsw import HNSWIndex
    from scintirete_tpu_torch.ops.distance import distance_np

    rng = np.random.default_rng(0)
    base = rng.standard_normal((5000, 32)).astype(np.float32)
    idx = HNSWIndex(32, HNSWParams(m=16, seed=3, neighbor_heuristic=True),
                    DistanceMetric.L2, device=dev)
    idx.bulk_insert(list(range(1, 5001)), base)
    q = base[:100] + 0.01
    res = idx.search_batch(q, SearchParams(top_k=10, ef_search=32))
    truth = np.argsort(distance_np(q, base, 1), axis=1)[:, :10] + 1
    rec = np.mean([len({v for v, _ in r} & set(t)) / 10 for r, t in zip(res, truth)])
    assert rec >= 0.95
