"""The port's CUDA kernels against their plain torch versions, on a card.

Marked `cuda`: these tests need an NVIDIA GPU with nvcc and skip without
one. On a machine with a card (no JAX needed; the repo's conftest imports
JAX, so leave it out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

They cover the shapes the main-path check (chip_smoke.py) does not: a
ragged pivot count, depths that are not a multiple of 8 (the kernels'
unvectorized loads), query counts that are not a multiple of the 64-row
tile, a masked scan over a ragged base and one with every row masked,
the four flat scans at odd shapes, with every row masked and with
overflowed norms, and a small build, append, search and flat collection on
the card.
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


def _flat_scan_inputs(dev, metric, B, N, D, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    base32 = torch.randn(N, D, generator=g, device=dev)
    q = torch.randn(B, D, generator=g, device=dev)
    if metric == 2:
        base32 = base32 / base32.norm(dim=1, keepdim=True)
        q = q / q.norm(dim=1, keepdim=True)
    bsq = (base32 * base32).sum(1)
    invalid = (torch.rand(N, generator=g, device=dev) < 0.2).float()
    invalid[N - 37:] = 1.0
    return q, base32, bsq, invalid


FLAT_SHAPES = [(64, 2048, 16), (300, 4096, 40), (129, 8192, 128), (7, 1024, 33)]


@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("B,N,D", FLAT_SHAPES)
def test_flat_int8_kernels_match_plain(dev, metric, B, N, D):
    """The int8 product is exact and no multiply is contracted, so both
    int8 scans equal their plain versions bit for bit, at groups of 1, 2
    and 4 tiles, aligned depth or not, any B."""
    from scintirete_tpu_torch.ops import packed_scan as ps

    q, base32, bsq, invalid = _flat_scan_inputs(dev, metric, B, N, D, B + N + D)
    base8, scale = ps.quantize_rows(base32)
    for tps in (1, 2, 4):
        if (N // 1024) % tps:
            continue
        before = ps.lane_topk_scan_packed_int8.launches
        keys, rows = ps.lane_topk_scan_packed_int8(
            q, base8, scale, bsq, invalid, metric, tps=tps
        )
        q8, qs2, bs, bq = ps.packed_int8_inputs(q, scale, bsq, invalid, metric)
        want = ps.lane_topk_scan_packed_int8_plain(
            q8, qs2, base8, bs, bq, metric, min(4, tps)
        )
        torch.cuda.synchronize()
        assert ps.lane_topk_scan_packed_int8.launches == before + 1
        assert torch.equal(keys.view(torch.int32), want.view(torch.int32))
        assert torch.equal(rows, ps.unpack_lane_keys(want)[1])
        assert not bool((invalid[rows[rows >= 0].long()] > 0.5).any())
    before = ps.lane_topk_scan_int8.launches
    d, i = ps.lane_topk_scan_int8(q, base8, scale, bsq, invalid, metric)
    q8, q_scale = ps.quantize_rows(q)
    want_d, want_i = ps.lane_topk_scan_int8_plain(
        q8, q_scale, base8, scale, bsq, invalid, metric
    )
    torch.cuda.synchronize()
    assert ps.lane_topk_scan_int8.launches == before + 1
    assert torch.equal(d, want_d) and torch.equal(i, want_i)


@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("B,N,D", FLAT_SHAPES)
def test_flat_bf16_kernels_match_plain(dev, metric, B, N, D):
    """bf16 products summed in f32 in another order than torch.matmul: a
    packed key within one unit of its last kept mantissa bit (2^-10
    relative), unpacked scores within rtol 1e-5 / atol 1e-4, ids equal but
    for near-ties."""
    from scintirete_tpu_torch.ops import packed_scan as ps

    q, base32, bsq, invalid = _flat_scan_inputs(dev, metric, B, N, D, B + N + D + 1)
    base = base32.to(torch.bfloat16)
    qb = q.to(torch.bfloat16)
    before = ps.lane_topk_scan_packed.launches
    keys, rows = ps.lane_topk_scan_packed(q, base, bsq, invalid, metric)
    want = ps.lane_topk_scan_packed_plain(qb, base, bsq, invalid, metric)
    torch.cuda.synchronize()
    assert ps.lane_topk_scan_packed.launches == before + 1
    assert bool(torch.isfinite(keys).all())
    torch.testing.assert_close(keys, want, rtol=2.0**-10, atol=1e-30)
    assert (rows == ps.unpack_lane_keys(want)[1]).float().mean() > 0.999
    assert not bool((invalid[rows[rows >= 0].long()] > 0.5).any())

    before = ps.lane_topk_scan.launches
    d, i = ps.lane_topk_scan(q, base, bsq, invalid, metric)
    want_d, want_i = ps.lane_topk_scan_plain(qb, base, bsq, invalid, metric)
    torch.cuda.synchronize()
    assert ps.lane_topk_scan.launches == before + 1
    fin = torch.isfinite(want_d)
    assert torch.equal(fin, torch.isfinite(d))
    torch.testing.assert_close(d[fin], want_d[fin], rtol=1e-5, atol=1e-4)
    assert (i == want_i).float().mean() > 0.999


def test_flat_scans_all_masked_and_overflow(dev):
    """Every row masked gives empty lanes; an overflowed norm and poisoned
    scales leave every packed key finite."""
    from scintirete_tpu_torch.ops import packed_scan as ps

    q, base32, bsq, _ = _flat_scan_inputs(dev, 1, 40, 2048, 32, 5)
    base8, scale = ps.quantize_rows(base32)
    ones = torch.ones(2048, device=dev)
    for keys, rows in (
        ps.lane_topk_scan_packed_int8(q, base8, scale, bsq, ones, 1),
        ps.lane_topk_scan_packed(q, base32.to(torch.bfloat16), bsq, ones, 1),
    ):
        assert bool((rows == -1).all()) and bool((keys >= 1.5e38).all())
    for d, i in (
        ps.lane_topk_scan_int8(q, base8, scale, bsq, ones, 1),
        ps.lane_topk_scan(q, base32.to(torch.bfloat16), bsq, ones, 1),
    ):
        assert bool((i == -1).all()) and bool(torch.isinf(d).all())
    base32[5] = 2.0e19
    bsq = (base32 * base32).sum(1)
    assert bool(torch.isinf(bsq[5]))
    scale[7], scale[9] = float("nan"), float("inf")
    zeros = torch.zeros(2048, device=dev)
    k8, _ = ps.lane_topk_scan_packed_int8(q, base8, scale, bsq, zeros, 1, tps=2)
    kb, _ = ps.lane_topk_scan_packed(q, base32.to(torch.bfloat16), bsq, zeros, 1)
    want = ps.lane_topk_scan_packed_plain(
        q.to(torch.bfloat16), base32.to(torch.bfloat16), bsq, zeros, 1
    )
    assert bool(torch.isfinite(k8).all()) and bool(torch.isfinite(kb).all())
    torch.testing.assert_close(kb, want, rtol=2.0**-10, atol=1e-30)


def test_flat_scan_bad_inputs_raise(dev):
    from scintirete_tpu_torch.ops import packed_scan as ps

    q, base32, bsq, invalid = _flat_scan_inputs(dev, 1, 8, 2048, 32, 6)
    base = base32.to(torch.bfloat16)
    base8, scale = ps.quantize_rows(base32)
    with pytest.raises(ValueError):  # an f32 base where bf16 is wanted
        ps.lane_topk_scan_packed(q, base32, bsq, invalid, 1)
    with pytest.raises(ValueError):  # an f64 mask
        ps.lane_topk_scan(q, base, bsq, invalid.double(), 1)
    with pytest.raises(ValueError):  # a base that is not whole tiles
        ps.lane_topk_scan_packed(q, base[:2000], bsq[:2000], invalid[:2000], 1)
    with pytest.raises(ValueError):  # scales of the wrong length
        ps.lane_topk_scan_packed_int8(q, base8, scale[:100], bsq, invalid, 1)
    with pytest.raises(ValueError):  # a non-contiguous int8 base
        ps.lane_topk_scan_int8(q[:, :16], base8[:, ::2], scale, bsq, invalid, 1)
    with pytest.raises(ValueError):  # the mask on another device
        ps.lane_topk_scan_int8(q, base8, scale, bsq, invalid.cpu(), 1)


@pytest.mark.parametrize("scan_dtype", ["int8", "bfloat16"])
def test_flat_collection_on_the_card(dev, scan_dtype):
    from scintirete_tpu_torch import DistanceMetric, SearchParams
    from scintirete_tpu_torch.index.flat import FlatIndex
    from scintirete_tpu_torch.ops import packed_scan as ps
    from scintirete_tpu_torch.ops.distance import distance_np

    rng = np.random.default_rng(2)
    base = rng.standard_normal((5000, 32)).astype(np.float32)
    q = rng.standard_normal((100, 32)).astype(np.float32)
    kernel = (ps.lane_topk_scan_packed_int8 if scan_dtype == "int8"
              else ps.lane_topk_scan_packed)
    for metric in (1, 2, 3):
        idx = FlatIndex(32, metric=DistanceMetric(metric), device=dev,
                        fused_min_cap=1024, scan_dtype=scan_dtype)
        idx.bulk_insert(list(range(1, 5001)), base)
        before = kernel.launches
        res = idx.search_batch(q, SearchParams(top_k=10))
        assert kernel.launches == before + 1
        d = distance_np(q, base, metric)
        truth = np.argsort(d, axis=1, kind="stable")[:, :10]
        rec = np.mean([len({v - 1 for v, _ in r} & set(t)) / 10
                       for r, t in zip(res, truth)])
        assert rec >= 0.99
        for b, r in enumerate(res):
            np.testing.assert_allclose(
                [x for _, x in r], d[b, [v - 1 for v, _ in r]],
                rtol=1e-4, atol=1e-5,
            )
        idx.delete(int(truth[0, 0]) + 1)
        idx.insert(9000, q[1])
        res = idx.search_batch(q, SearchParams(top_k=10))
        assert res[0][0][0] != truth[0, 0] + 1 and res[1][0][0] == 9000
    # under the fused capacity the two-pass route serves, without a kernel
    small = FlatIndex(32, device=dev)
    small.bulk_insert(list(range(1, 5001)), base)
    before = kernel.launches
    res = small.search_batch(q, SearchParams(top_k=10))
    assert kernel.launches == before
    truth = np.argsort(distance_np(q, base, 2), axis=1, kind="stable")[:, :10]
    assert [[v - 1 for v, _ in r] for r in res] == truth.tolist()
