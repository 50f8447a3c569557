"""The port's CUDA kernels against their plain torch versions, on a card.

Marked `cuda`: these tests need an NVIDIA GPU with nvcc and skip without
one. On a machine with a card (no JAX needed; the repo's conftest imports
JAX, so leave it out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

They cover the shapes the main-path check (chip_smoke.py) does not: a
ragged pivot count, depths that are not a multiple of 8 (the kernels'
unvectorized loads), query counts that are not a multiple of the 64-row
tile, a masked scan over a ragged base and one with every row masked,
and a small build, append and search on the card.
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


@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("B,N,D,tiles,mask", [
    (64, 2048, 16, 2, "random"),  # aligned N, random mask
    (300, 3000, 40, 3, "random"),  # ragged N: rows past N are masked
    (129, 2500, 128, 3, "all"),  # every row masked
])
def test_masked_lane_kernel_matches_plain(dev, metric, B, N, D, tiles, mask):
    from scintirete_tpu_torch.ops.lane_scan import (
        knn_lane_topc_masked,
        lane_scan_masked,
        lane_scan_masked_plain,
    )

    g = torch.Generator(device=dev).manual_seed(B + N + D + 1)
    base32 = torch.randn(N, D, generator=g, device=dev)
    if metric == 2:
        base32 = base32 / base32.norm(dim=1, keepdim=True)
    base = base32.to(torch.bfloat16)
    bsq = (base32 * base32).sum(1)
    if mask == "all":
        invalid = torch.ones(N, device=dev)
    else:
        invalid = (torch.rand(N, generator=g, device=dev) < 0.5).float()
    # self rows: queries are base rows, excluded from their own lanes
    si = torch.randperm(N, generator=g, device=dev)[:B].to(torch.int32)
    qb = base[si.long()].contiguous()
    before = lane_scan_masked.launches
    k_out = lane_scan_masked(qb, si, base, bsq, invalid, metric, tiles)
    p_out = lane_scan_masked_plain(qb, si, base, bsq, invalid, metric, tiles)
    torch.cuda.synchronize()
    assert lane_scan_masked.launches == before + 1
    for k, p in zip(k_out, p_out):
        if k.dtype == torch.float32:
            fin = torch.isfinite(p)
            assert torch.equal(fin, torch.isfinite(k))
            torch.testing.assert_close(k[fin], p[fin], rtol=1e-5, atol=1e-4)
        else:
            assert (k == p).float().mean() > 0.999
    cd, ci = knn_lane_topc_masked(qb, si, base, bsq, invalid, metric, 16, tiles)
    ok = ci >= 0
    assert not bool((invalid[ci[ok].long()] > 0.5).any())
    assert not bool((ci == si[:, None]).any())
    if mask == "all":
        assert not bool(ok.any()) and bool(torch.isinf(cd).all())


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
    from scintirete_tpu_torch.ops.lane_scan import lane_scan_masked

    with pytest.raises(ValueError):  # an f64 mask
        lane_scan_masked(base[:4], torch.arange(4, device=dev, dtype=torch.int32),
                         base, torch.ones(2048, device=dev),
                         torch.zeros(2048, device=dev, dtype=torch.float64), 1, 1)
    with pytest.raises(ValueError):  # more tiles than the base holds
        lane_scan_masked(base[:4], torch.arange(4, device=dev, dtype=torch.int32),
                         base, torch.ones(2048, device=dev),
                         torch.zeros(2048, device=dev), 1, 3)


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


def test_append_and_chunked_insert_on_the_card(dev):
    from scintirete_tpu_torch import DistanceMetric, HNSWParams, SearchParams
    from scintirete_tpu_torch.index.hnsw import HNSWIndex
    from scintirete_tpu_torch.ops.lane_scan import lane_scan_masked

    rng = np.random.default_rng(1)
    base = rng.standard_normal((7100, 32)).astype(np.float32)
    params = HNSWParams(m=16, seed=3, neighbor_heuristic=True)
    idx = HNSWIndex(32, params, DistanceMetric.COSINE, device=dev)
    idx.bulk_insert(list(range(1, 5001)), base[:5000])
    before = lane_scan_masked.launches
    idx.bulk_insert(list(range(5001, 7101)), base[5000:])  # batched append
    assert lane_scan_masked.launches > before
    res = idx.search_batch(base[5000:], SearchParams(top_k=1, ef_search=32))
    assert np.mean([r[0][0] == 5001 + i for i, r in enumerate(res)]) >= 0.99

    chunked = HNSWIndex(32, params, DistanceMetric.COSINE, device=dev)
    for s in range(0, 900, 300):  # host bootstrap, then chunked descents
        chunked.bulk_insert(list(range(s + 1, s + 301)), base[s : s + 300])
    res = chunked.search_batch(base[:900], SearchParams(top_k=1, ef_search=64))
    assert np.mean([r[0][0] == 1 + i for i, r in enumerate(res)]) >= 0.99
