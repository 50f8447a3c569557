"""The port's CUDA kernels against their plain torch versions, on a card.

Marked `cuda`: these tests need an NVIDIA GPU with nvcc and skip without
one. On a machine with a card (no JAX needed; the repo's conftest imports
JAX, so leave it out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

They cover the shapes the main-path check (chip_smoke.py) does not: the
pivot scan at ragged pivot and query counts, padded and streamed depths,
the pivot cap, exact ties across its blocks and with every pivot deleted;
depths that are not a multiple of the TMA unit (zero padding), depths the
scans stream through their ring (D = 768), query counts that are not a
multiple of the 64- or 128-row tiles (B = 1, 65), a single tile, a masked
scan over a ragged base and one with every row masked, exact ties that the
lane folds must break in tile order, the four flat scans at odd shapes,
with every row masked and with overflowed norms, the packed and the
unpacked int8 scans at ragged B, padded and deep D and over 2^20 rows
(split and unsplit walks for the packed ones), equal scores in every tile
of a lane, and a small build, append, search, flat collection and
two-shard index on the card.
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


def _pivot_inputs(dev, metric, B, R, D, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, D, generator=g, device=dev)
    pv = torch.randn(R, D, generator=g, device=dev)
    if metric == 2:
        q = q / q.norm(dim=1, keepdim=True)
        pv = pv / pv.norm(dim=1, keepdim=True)
    pdel = (torch.rand(R, generator=g, device=dev) < 0.1).float()
    return q, pv, (pv * pv).sum(1), pdel


def _hold_pivot(q, pv, psq, pdel, metric):
    """Kernel against plain: distances within atol 1e-4 + rtol 1e-5 (f32
    sums in another order), ids equal except where the two distances tie
    within that tolerance, and no deleted pivot."""
    from scintirete_tpu_torch.ops.pivot_scan import (
        pivot_entry_scan,
        pivot_entry_scan_plain,
    )

    before = pivot_entry_scan.launches
    d_k, i_k = pivot_entry_scan(q, pv, psq, pdel, metric)
    d_p, i_p = pivot_entry_scan_plain(q, pv, psq, pdel, metric)
    torch.cuda.synchronize()
    assert pivot_entry_scan.launches == before + 1
    assert d_k.dtype == torch.float32 and i_k.dtype == torch.int32
    torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=1e-4)
    same = i_k == i_p
    tol = 1e-4 + 1e-5 * d_p.abs()
    assert bool(((d_k - d_p).abs() <= tol)[~same].all())
    assert not bool((pdel[i_k[i_k >= 0].long()] > 0.5).any())


@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("B", [1, 63, 65, 255, 256])
@pytest.mark.parametrize("R", [65536, 65536 - 300])
def test_pivot_kernel_ragged_batches(dev, metric, B, R):
    """Query counts around the 64-row (B <= 64) and 128-row query tiles,
    on the main path's pivot count and a ragged one (a partial last tile)."""
    _hold_pivot(*_pivot_inputs(dev, metric, B, R, 128, B + R), metric)


@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("D", [33, 768])
def test_pivot_kernel_padded_and_deep(dev, metric, D):
    """D = 33 is padded to 36 columns for TMA; D = 768 streams the queries
    through the ring beside the pivots."""
    _hold_pivot(*_pivot_inputs(dev, metric, 70, 5000, D, D), metric)


@pytest.mark.parametrize("B", [1, 256])
def test_pivot_kernel_at_the_pivot_cap(dev, B):
    """R = 262,144 (PIVOT_CAP): 2,048 pivot tiles over the card's ranges."""
    _hold_pivot(*_pivot_inputs(dev, 2, B, 262144, 128, B), 2)


@pytest.mark.parametrize("metric", [1, 2, 3])
def test_pivot_kernel_ties_across_blocks(dev, metric):
    """Copies of each query's best pivot in different blocks' pivot ranges
    (and in one tile): identical rows give identical scores, and the lowest
    index wins. For inner product, pivots orthogonal to a query score
    -0.0 (-dot of +0); the kernel compares zeros of either sign as equal,
    so the lowest orthogonal pivot wins as in the plain version."""
    from scintirete_tpu_torch.ops.pivot_scan import (
        pivot_entry_scan,
        pivot_entry_scan_plain,
    )

    B, R, D = 256, 65536, 128
    g = torch.Generator(device=dev).manual_seed(metric)
    q = torch.randint(-3, 4, (B, D), generator=g, device=dev).float()
    pv = torch.randint(-3, 4, (R, D), generator=g, device=dev).float()
    # copies at p + b for query b: blocks' ranges hold about 1,000 pivots
    where = torch.tensor([60000, 40000, 20001, 999, 130], device=dev)
    for b in range(B):
        pv[where + b] = q[b] * (1.0 if metric == 1 else 3.0)
    if metric == 2:
        q = q / q.norm(dim=1, keepdim=True)
        pv = pv / pv.norm(dim=1, keepdim=True)
    psq = (pv * pv).sum(1)
    pdel = torch.zeros(R, device=dev)
    pdel[130] = 1.0  # the lowest copy of query 0's best is deleted
    d_k, i_k = pivot_entry_scan(q, pv, psq, pdel, metric)
    torch.cuda.synchronize()
    want = (130 + torch.arange(B, device=dev)).to(torch.int32)
    want[0] = 999
    assert torch.equal(i_k, want)

    if metric == 3:  # zeros of either sign tie
        qz = torch.zeros(4, D, device=dev)
        qz[:, 0] = 1.0
        pz = torch.randn(4096, D, generator=g, device=dev)
        pz[:, 0] = -pz[:, 0].abs() - 0.5  # every dot < 0: d > 0
        zero_at = torch.tensor([3000, 700, 2100], device=dev)
        pz[zero_at, 0] = 0.0  # dot exactly 0: d = -0.0
        pzd = torch.zeros(4096, device=dev)
        d_k, i_k = pivot_entry_scan(qz, pz, (pz * pz).sum(1), pzd, 3)
        d_p, i_p = pivot_entry_scan_plain(qz, pz, (pz * pz).sum(1), pzd, 3)
        torch.cuda.synchronize()
        assert bool((d_k == 0).all()) and bool((i_k == 700).all())
        assert torch.equal(i_k, i_p)


@pytest.mark.parametrize("B", [1, 65, 300])
def test_pivot_kernel_all_deleted(dev, B):
    """Every pivot deleted: (+inf, -1) for every query, written by the C
    entry itself."""
    from scintirete_tpu_torch.ops.pivot_scan import pivot_entry_scan

    q, pv, psq, _ = _pivot_inputs(dev, 1, B, 3000, 64, B)
    d, i = pivot_entry_scan(q, pv, psq, torch.ones(3000, device=dev), 1)
    torch.cuda.synchronize()
    assert bool(torch.isinf(d).all()) and bool((d > 0).all())
    assert bool((i == -1).all())


@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("B,N,D,n_valid,tiles", [
    (64, 2048, 16, 2048, 2), (300, 4096, 40, 3000, 3), (129, 3072, 128, 1, 1),
    (1, 2048, 100, 1500, 2),  # one query; D padded to 104
    (65, 3072, 768, 3072, 3),  # queries streamed through the ring
    (65, 2048, 100, 2048, 1),  # one tile
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
    (1, 3000, 100, 3, "random"),  # one query; D padded to 104
    (65, 2500, 768, 3, "random"),  # queries streamed through the ring
    (65, 2048, 128, 1, "random"),  # one tile
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


def _tied_base(dev, seed, D=40, tiles=4):
    """Small-integer rows (every product and sum is exact in f32, in any
    order), each tile a copy of the first with a third of its rows
    redrawn: rows r and r + 1024 k of one lane tie exactly."""
    g = torch.Generator(device=dev).manual_seed(seed)
    base32 = torch.randint(-2, 3, (1024, D), generator=g, device=dev).float()
    base32 = base32.repeat(tiles, 1)
    redraw = torch.rand(tiles * 1024, generator=g, device=dev) < 0.3
    redraw[:1024] = False
    base32[redraw] = torch.randint(
        -2, 3, (int(redraw.sum()), D), generator=g, device=dev
    ).float()
    return base32


@pytest.mark.parametrize("metric", [1, 2, 3])
def test_lane_kernels_break_ties_in_tile_order(dev, metric):
    """Exact ties: the strict-< fold keeps the earlier tile's row. With
    exact scores the four unpacked lane-kernel entries must equal their
    plain versions exactly, ids included: the prefix and masked graph-build
    scans (self rows excluded, their copies in other tiles not) and the
    flat index's [B, 2048] outputs, bf16 and int8 (duplicate rows quantize
    to the same int8 row and scale, so they tie exactly too)."""
    from scintirete_tpu_torch.ops import packed_scan as ps
    from scintirete_tpu_torch.ops.lane_scan import (
        lane_scan,
        lane_scan_masked,
        lane_scan_masked_plain,
        lane_scan_plain,
    )

    base32 = _tied_base(dev, metric)
    N = base32.shape[0]
    base = base32.to(torch.bfloat16)
    bsq = (base32 * base32).sum(1)
    g = torch.Generator(device=dev).manual_seed(10 + metric)
    si = torch.randperm(N, generator=g, device=dev)[:65].to(torch.int32)
    qb = base[si.long()].contiguous()
    invalid = (torch.rand(N, generator=g, device=dev) < 0.2).float()
    for k_out, p_out in (
        (lane_scan(qb, si, base, bsq, N - 100, metric, 4),
         lane_scan_plain(qb, si, base, bsq, N - 100, metric, 4)),
        (lane_scan_masked(qb, si, base, bsq, invalid, metric, 4),
         lane_scan_masked_plain(qb, si, base, bsq, invalid, metric, 4)),
        (ps.lane_topk_scan(qb.float(), base, bsq, invalid, metric),
         ps.lane_topk_scan_plain(qb, base, bsq, invalid, metric)),
    ):
        torch.cuda.synchronize()
        for k, p in zip(k_out, p_out):
            assert torch.equal(k, p)
    _hold_lane_int8(qb.float(), base32, bsq, invalid, metric)


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
    # more tiles than the fold state's 16-bit tile ids can name
    big = torch.empty((65536 * 1024, 8), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        lane_scan(big[:4], torch.arange(4, device=dev, dtype=torch.int32), big,
                  torch.zeros(big.shape[0], device=dev), 100, 1, 65536)


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
KEY_RTOL = 2.0**-10  # one unit of the last mantissa bit a packed key keeps


def _assert_bf16_keys_close(keys, rows, want, qb, base, bsq, metric):
    """Packed bf16 keys against the plain version's: their scores within
    one kept unit (KEY_RTOL) plus the f32 summation bound of the rows
    either side picked for the lane (packed_bf16_sum_bound: the kernel's
    wgmma and torch.matmul sum in different orders). The tile ids (the low
    13 bits) are cleared on both sides: two rows of a near tie that the
    sides order differently carry different ids."""
    from scintirete_tpu_torch.ops import packed_scan as ps

    score, want_score = ps.packed_key_scores(keys), ps.packed_key_scores(want)
    tol = KEY_RTOL * want_score.abs() + ps.packed_bf16_sum_bound(
        rows, want, qb, base, bsq, metric
    )
    diff = (score - want_score).abs()
    bad = diff > tol
    assert not bool(bad.any()), (
        f"{int(bad.sum())} keys out of bound; worst excess "
        f"{float((diff - tol).max())}"
    )


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
    relative) and the f32 summation bound (_assert_bf16_keys_close),
    unpacked scores within rtol 1e-5 / atol 1e-4, ids equal but for
    near-ties."""
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
    _assert_bf16_keys_close(keys, rows, want, qb, base, bsq, metric)
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


def _hold_packed_scans(q, base32, bsq, invalid, metric, tps_all=(1, 2, 4),
                       bf16_exact=False):
    """Both packed scans against their plain versions: int8 keys bit for
    bit at every tile group that divides the walk, bf16 keys within
    _assert_bf16_keys_close's bound (bit for bit where every dot is exact
    in f32) with rows >= 0.999 equal; no masked row comes out."""
    from scintirete_tpu_torch.ops import packed_scan as ps

    N = base32.shape[0]
    base8, scale = ps.quantize_rows(base32)
    for tps in tps_all:
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
        assert torch.equal(keys.view(torch.int32), want.view(torch.int32)), tps
        assert torch.equal(rows, ps.unpack_lane_keys(want)[1])
        assert not bool((invalid[rows[rows >= 0].long()] > 0.5).any())
    base = base32.to(torch.bfloat16)
    qb = q.to(torch.bfloat16)
    before = ps.lane_topk_scan_packed.launches
    keys, rows = ps.lane_topk_scan_packed(q, base, bsq, invalid, metric)
    want = ps.lane_topk_scan_packed_plain(qb, base, bsq, invalid, metric)
    torch.cuda.synchronize()
    assert ps.lane_topk_scan_packed.launches == before + 1
    assert bool(torch.isfinite(keys).all())
    if bf16_exact:
        assert torch.equal(keys.view(torch.int32), want.view(torch.int32))
    _assert_bf16_keys_close(keys, rows, want, qb, base, bsq, metric)
    assert (rows == ps.unpack_lane_keys(want)[1]).float().mean() >= 0.999
    assert not bool((invalid[rows[rows >= 0].long()] > 0.5).any())


def _hold_lane_int8(q, base32, bsq, invalid, metric):
    """The unpacked int8 scan against its plain version, bit for bit
    (scores and rows): the s8 product is exact and no multiply is
    contracted; one launch, no masked row out."""
    from scintirete_tpu_torch.ops import packed_scan as ps

    base8, scale = ps.quantize_rows(base32)
    before = ps.lane_topk_scan_int8.launches
    d, i = ps.lane_topk_scan_int8(q, base8, scale, bsq, invalid, metric)
    q8, q_scale = ps.quantize_rows(q)
    want_d, want_i = ps.lane_topk_scan_int8_plain(
        q8, q_scale, base8, scale, bsq, invalid, metric
    )
    torch.cuda.synchronize()
    assert ps.lane_topk_scan_int8.launches == before + 1
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))
    assert torch.equal(i, want_i)
    assert not bool((invalid[i[i >= 0].long()] > 0.5).any())


@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("B", [1, 63, 65, 129, 1025])
def test_lane_int8_scan_ragged_batches(dev, metric, B):
    """Query counts around the 64-row warpgroup and 128-row block edges;
    every launch walks all tiles in one piece."""
    q, base32, bsq, invalid = _flat_scan_inputs(dev, metric, B, 8192, 128, B)
    _hold_lane_int8(q, base32, bsq, invalid, metric)


@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("D", [100, 768])
def test_lane_int8_scan_padded_and_deep(dev, metric, D):
    """D = 100 is padded to 112 int8 columns for TMA; D = 768 streams the
    queries through the ring beside the base (six 128-byte chunks)."""
    q, base32, bsq, invalid = _flat_scan_inputs(dev, metric, 70, 4096, D, D)
    _hold_lane_int8(q, base32, bsq, invalid, metric)


@pytest.mark.parametrize("B", [1, 4096])
def test_lane_int8_scan_on_a_million_rows(dev, B):
    """2^20 rows, cosine: B = 1 is 16 blocks, each a full walk of 1,024
    tiles; B = 4096 is 512 blocks."""
    q, base32, bsq, invalid = _flat_scan_inputs(dev, 2, B, 1 << 20, 128, 9)
    _hold_lane_int8(q, base32, bsq, invalid, 2)


def test_lane_int8_scan_tile_cap(dev):
    """The fold state names tiles in 16 bits: more than MAX_TILES tiles
    raise before anything is launched."""
    from scintirete_tpu_torch.ops import packed_scan as ps

    n = (ps.MAX_TILES + 1) * 1024
    # only the shapes are read before the raise: views of one row will do
    base8 = torch.zeros((1, 16), dtype=torch.int8, device=dev).expand(n, 16)
    zeros = torch.zeros(1, device=dev).expand(n)
    with pytest.raises(ValueError):
        ps.lane_topk_scan_int8(torch.zeros(2, 16, device=dev), base8, zeros,
                               zeros, zeros, 1)


@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("B", [1, 63, 65, 129, 1025])
def test_packed_scans_ragged_batches(dev, metric, B):
    """Query counts around the 64-row warpgroup and 128-row block edges;
    B = 1, 63, 65 and 129 split the walk into slices, 1025 does not."""
    q, base32, bsq, invalid = _flat_scan_inputs(dev, metric, B, 8192, 128, B)
    _hold_packed_scans(q, base32, bsq, invalid, metric)


@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("D", [100, 768])
def test_packed_scans_padded_and_deep(dev, metric, D):
    """D = 100 is padded to 112 columns (int8) and 104 (bf16) for TMA;
    D = 768 streams the queries through the ring (bf16), and its int8
    dots may pass 2^22 (converted to f32 with rounding)."""
    q, base32, bsq, invalid = _flat_scan_inputs(dev, metric, 70, 4096, D, D)
    _hold_packed_scans(q, base32, bsq, invalid, metric)


@pytest.mark.parametrize("B", [1, 4096])
def test_packed_scans_on_a_million_rows(dev, B):
    """2^20 rows, cosine: B = 1 runs its walk in several slices and merges
    them, B = 4096 in one."""
    from scintirete_tpu_torch.ops import packed_scan as ps

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (ps._slices(B, 1024, sms) > 1) == (B == 1)
    q, base32, bsq, invalid = _flat_scan_inputs(dev, 2, B, 1 << 20, 128, 7)
    _hold_packed_scans(q, base32, bsq, invalid, 2, tps_all=(1, 4))


@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("B", [1, 65])
def test_packed_scans_equal_scores_across_tiles(dev, metric, B):
    """Small-integer rows repeated in every tile: each lane sees the same
    score in all 64 tiles, and only the tile id in the key tells them
    apart. Dots are exact in f32, so the bf16 keys must be bit-equal too,
    split into slices (B = 1) or not."""
    g = torch.Generator(device=dev).manual_seed(B + metric)
    rows = torch.randint(-3, 4, (1024, 32), generator=g, device=dev).float()
    base32 = rows.repeat(64, 1)
    q = torch.randint(-3, 4, (B, 32), generator=g, device=dev).float()
    bsq = (base32 * base32).sum(1)
    invalid = torch.zeros(base32.shape[0], device=dev)
    invalid[5 * 1024 : 6 * 1024 : 3] = 1.0
    _hold_packed_scans(q, base32, bsq, invalid, metric, bf16_exact=True)


@pytest.mark.parametrize("metric", [1, 2])
def test_packed_int8_prepares_inputs_as_plain(dev, metric):
    """On the card the int8 scan's entry quantizes the queries and masks
    and clamps the [N] terms itself; with NaN / inf / zero query rows and
    NaN / inf / negative scales, norms and mask values its keys still
    equal the plain version's (packed_int8_inputs) bit for bit."""
    from scintirete_tpu_torch.ops import packed_scan as ps

    q, base32, bsq, invalid = _flat_scan_inputs(dev, metric, 9, 2048, 40, 8)
    base8, scale = ps.quantize_rows(base32)
    q[1, 3] = float("nan")
    q[2, 5] = float("inf")
    q[3] = 0.0
    q[4, 7] = -1e30
    for i, v in enumerate(("nan", "inf", "-inf", "-1.0", "1e20")):
        scale[10 + i] = float(v)
        bsq[20 + i] = float(v)
    invalid[30] = float("nan")
    keys, rows = ps.lane_topk_scan_packed_int8(q, base8, scale, bsq, invalid,
                                               metric, tps=2)
    want = ps.lane_topk_scan_packed_int8_plain(
        *ps.packed_int8_inputs(q, scale, bsq, invalid, metric)[:2],
        base8, *ps.packed_int8_inputs(q, scale, bsq, invalid, metric)[2:],
        metric, 2,
    )
    torch.cuda.synchronize()
    assert torch.equal(keys.view(torch.int32), want.view(torch.int32))
    assert torch.equal(rows, ps.unpack_lane_keys(want)[1])


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


@pytest.mark.parametrize("index_type", ["hnsw", "flat"])
def test_collection_saved_and_recovered_on_the_card(dev, tmp_path, index_type):
    """A snapshot with an AOF tail, recovered into a fresh engine on the
    card, searches to the same ids and distances as before the save."""
    from scintirete_tpu_torch import (
        CollectionConfig,
        DistanceMetric,
        HNSWParams,
        SearchParams,
    )
    from scintirete_tpu_torch.engine import Engine
    from scintirete_tpu_torch.ops.pivot_scan import pivot_entry_scan
    from scintirete_tpu_torch.persistence import PersistenceManager

    rng = np.random.default_rng(4)
    base = rng.standard_normal((5000, 32)).astype(np.float32)
    q = base[::50] + 0.1 * rng.standard_normal((100, 32)).astype(np.float32)
    data_dir = str(tmp_path / "data")
    engine = Engine(device=dev)
    pm = PersistenceManager(engine, data_dir)
    col = engine.create_database("db").create_collection(CollectionConfig(
        name="c", metric=DistanceMetric.COSINE, index_type=index_type,
        hnsw=HNSWParams(m=8, ef_construction=64, seed=3),
    ))
    ids = col.insert([(v, {"i": i}) for i, v in enumerate(base)])
    col.delete(ids[:50])
    pm.save_snapshot()
    col.delete(ids[50:60])
    pm.log_delete_vectors("db", "c", ids[50:60])
    sp = SearchParams(top_k=10, ef_search=32)
    want = col.search_batch_arrays(q, sp)
    pm.stop()

    engine2 = Engine(device=dev)
    pm2 = PersistenceManager(engine2, data_dir)
    report = pm2.recover()
    pm2.stop()
    assert report["rdb_loaded"] and report["aof_commands"] == 1
    assert report["degraded"] == []
    col2 = engine2.get_database("db").get_collection("c")
    before = pivot_entry_scan.launches
    got = col2.search_batch_arrays(q, sp)
    assert (pivot_entry_scan.launches > before) == (index_type == "hnsw")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert not np.isin(got[0], np.asarray(ids[:60], np.uint64)).any()
    assert col2.get(ids[100]).metadata == {"i": 100}
    assert col2.count() == col.count() == 4940


def test_sharded_index_on_the_card(dev):
    """Two shards on one card: each builds through the lane scan, searches
    through the pivot scan, takes a batched append through the masked scan,
    and an exported state imports to the same answers, bit for bit."""
    from scintirete_tpu_torch import DistanceMetric, HNSWParams, SearchParams
    from scintirete_tpu_torch.ops.distance import distance_np
    from scintirete_tpu_torch.ops.lane_scan import lane_scan, lane_scan_masked
    from scintirete_tpu_torch.ops.pivot_scan import pivot_entry_scan
    from scintirete_tpu_torch.parallel import ShardedHNSWIndex

    rng = np.random.default_rng(2)
    base = rng.standard_normal((9100, 32)).astype(np.float32)
    devices = [dev, dev]
    idx = ShardedHNSWIndex(32, HNSWParams(m=16, seed=3, neighbor_heuristic=True),
                           DistanceMetric.COSINE, devices=devices)
    counts = [op.launches for op in (lane_scan, lane_scan_masked,
                                     pivot_entry_scan)]
    idx.bulk_insert(list(range(1, 5001)), base[:5000])  # two kNN builds
    idx.bulk_insert(list(range(5001, 9101)), base[5000:])  # two appends
    q = base[:200] + 0.01
    sp = SearchParams(top_k=10)
    res = idx.search_batch(q, sp)
    after = [op.launches for op in (lane_scan, lane_scan_masked,
                                     pivot_entry_scan)]
    assert all(a > c for a, c in zip(after, counts))
    truth = np.argsort(distance_np(q, base, 2), axis=1)[:, :10] + 1
    rec = np.mean([len({v for v, _ in r} & set(t)) / 10
                   for r, t in zip(res, truth)])
    assert rec >= 0.95
    tail = idx.search_batch(base[5000:], SearchParams(top_k=1))
    assert np.mean([r[0][0] == 5001 + i for i, r in enumerate(tail)]) >= 0.99
    back = ShardedHNSWIndex.import_graph_state(idx.export_graph_state(),
                                               devices=devices)
    assert back.search_batch(q, sp) == res
