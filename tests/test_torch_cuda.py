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
two-shard index on the card. The layer-0 beam replayed as CUDA graphs
is held to the eager step, bit for bit: across sub-batch sizes, ef, the
metrics, the entry modes and tombstones, after the mirror grows, and
with two searching threads beside a capture. At GIST-1M's width (D = 960,
L2): the pivot scan at B 256 over 65,536 and 131,072 pivots, the lane
scan at B 2,048 over 65,536 rows, and the graphed beam against the eager.
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


def test_beam_sync_spans_share_the_device_clock(dev):
    """The tracer's spans and the profiler's device events on one clock:
    a `beam.sync` waits for its copy to the host, so no such span ends
    more than 20 us before the end of the last device operation that
    started before it ended. Prints the median and the least of that
    lead (sync end less that operation's end)."""
    from torch.autograd import DeviceType

    from scintirete_tpu_torch import DistanceMetric, HNSWParams, SearchParams
    from scintirete_tpu_torch.index.hnsw import HNSWIndex
    from scintirete_tpu_torch.observability import trace

    rng = np.random.default_rng(4)
    base = rng.standard_normal((20000, 64)).astype(np.float32)
    idx = HNSWIndex(64, HNSWParams(m=16, seed=3), DistanceMetric.COSINE,
                    device=dev)
    idx.bulk_insert(list(range(1, 20001)), base)
    q = base[:256] + 0.01
    params = SearchParams(top_k=10, ef_search=50)
    idx.search_batch_arrays(q, params)  # the mirror and the kernels warm
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    trace.enable()
    try:
        idx.search_batch_arrays(q, params)
        torch.cuda.synchronize()
    finally:
        trace.disable()
        prof.stop()
    drained = trace.drain()
    syncs = [s for s in drained.spans if s.name == "beam.sync"]
    ops = sorted(((ev.start_ns() - drained.offset_ns,
                   ev.start_ns() + ev.duration_ns() - drained.offset_ns)
                  for ev in prof.profiler.kineto_results.events()
                  if ev.device_type() == DeviceType.CUDA))
    assert syncs and ops
    starts = np.array([a for a, _ in ops])
    leads = []
    for s in syncs:
        last = int(np.searchsorted(starts, s.end_ns)) - 1
        assert last >= 0
        leads.append(s.end_ns - ops[last][1])
    leads = np.array(leads) / 1e3
    print(f"beam.sync end less its last device op's end: {len(leads)} "
          f"syncs, median {np.median(leads):.1f} us, least "
          f"{leads.min():.1f} us")
    assert leads.min() >= -20.0


# (entry_mode, descent_mid, ef_upper): pivot, mid-layer entry, pure walk
GRAPH_MODES = {"pivot": ("pivot", True, 1), "mid": ("descent", True, 1),
               "descent": ("descent", False, 4)}


def _graph_index(dev, metric, n=20000, dim=48):
    from scintirete_tpu_torch import DistanceMetric, HNSWParams
    from scintirete_tpu_torch.index.hnsw import HNSWIndex

    rng = np.random.default_rng(int(metric) + 10)
    base = rng.standard_normal((n, dim)).astype(np.float32)
    idx = HNSWIndex(dim, HNSWParams(m=16, ef_construction=100, seed=3),
                    DistanceMetric(metric), device=dev)
    idx.bulk_insert(list(range(1, n + 1)), base)
    return idx, base, rng


def _graphed_and_eager(idx, queries, k, ef, mode):
    """One search with the index's graph pool and one with the eager step:
    (slots, dists, layer-0 steps, graphed steps) of each."""
    entry_mode, mid, ef_upper = GRAPH_MODES[mode]
    dev_idx = idx._get_device()
    out = []
    for graphs in (dev_idx._graphs, None):
        pool, dev_idx._graphs = dev_idx._graphs, graphs
        try:
            before = dict(dev_idx.steps)
            s, d = dev_idx.search(idx.store, queries, k, ef,
                                  entry_mode=entry_mode, ef_upper=ef_upper,
                                  descent_mid=mid)
            after = dev_idx.steps
            out.append((s, d, after["layer0"] - before["layer0"],
                        after["graph_steps"] - before["graph_steps"]))
        finally:
            dev_idx._graphs = pool
    return out


def _assert_graphed_is_eager(idx, queries, k, ef, mode):
    (gs, gd, gl, gg), (es, ed, el, eg) = _graphed_and_eager(
        idx, queries, k, ef, mode)
    where = f"B {len(queries)}, ef {ef}, {mode}"
    assert np.array_equal(gs, es), where
    assert np.array_equal(gd.view(np.uint32), ed.view(np.uint32)), where
    assert gl == el > 0 and gg == gl and eg == 0, (where, gl, el, gg, eg)


@pytest.mark.parametrize("mode", list(GRAPH_MODES))
@pytest.mark.parametrize("metric", [1, 2, 3])
def test_graphed_beam_answers_equal_eager(dev, metric, mode):
    """The layer-0 beam replayed as CUDA graphs answers as the eager step
    does, ids and distance bits, in as many counted steps: B from 1 to a
    whole sub-batch (padded rows), ef 10 / 50 / 128, the three entry
    modes, before and after tombstones."""
    idx, base, rng = _graph_index(dev, metric)
    queries = base[:256] + 0.1 * rng.standard_normal((256, 48)).astype(
        np.float32)
    for deleted in (False, True):
        if deleted:
            for vid in rng.choice(np.arange(1, 20001), 1000, replace=False):
                idx.delete(int(vid))
        for B in (1, 7, 64, 200, 256):
            for ef in (10, 50, 128):
                _assert_graphed_is_eager(idx, queries[:B], 10, ef, mode)
    pool = idx._get_device()._graphs
    assert max(pool._held.values()) <= 1  # one thread: one instance a key


def test_graphed_beam_recaptures_when_the_mirror_grows(dev):
    """Appends past the mirror's capacity replace the tensors the graphs
    read: the generation moves, the step is captured anew and answers
    still equal the eager step's."""
    idx, base, rng = _graph_index(dev, 2)
    dev_idx = idx._get_device()
    queries = base[:64] + 0.1 * rng.standard_normal((64, 48)).astype(
        np.float32)
    _assert_graphed_is_eager(idx, queries, 10, 50, "pivot")
    gen, captures = dev_idx.graph.generation, dev_idx.steps["graph_captures"]
    cap = idx.store.cap
    more = rng.standard_normal((cap, 48)).astype(np.float32)
    idx.bulk_insert(list(range(20001, 20001 + cap)), more)
    assert idx.store.cap > cap
    _assert_graphed_is_eager(idx, np.concatenate([queries, more[:64]]), 10,
                             50, "pivot")
    assert dev_idx.graph.generation > gen
    assert dev_idx.steps["graph_captures"] > captures


def test_graphed_beam_under_two_threads_and_a_capture(dev):
    """Two threads search sub-batches of 256 while a third shape is
    captured: every answer equals the eager step's and no key holds more
    than GRAPH_CAP instances."""
    import threading

    from scintirete_tpu_torch.index import device as device_mod

    idx, base, rng = _graph_index(dev, 2)
    dev_idx = idx._get_device()
    sets = [base[i * 256:(i + 1) * 256] + 0.1 * rng.standard_normal(
        (256, 48)).astype(np.float32) for i in range(4)]
    small = sets[0][:3]
    want = {}
    pool, dev_idx._graphs = dev_idx._graphs, None
    try:
        for i, q in enumerate(sets + [small]):
            want[i] = dev_idx.search(idx.store, q, 10, 50)
    finally:
        dev_idx._graphs = pool
    dev_idx.search(idx.store, sets[0], 10, 50)  # the 256-row key, warm
    errors = []

    def searcher(j):
        try:
            for r in range(6):
                i = (j + r) % 4
                s, d = dev_idx.search(idx.store, sets[i], 10, 50)
                if not (np.array_equal(s, want[i][0])
                        and np.array_equal(d.view(np.uint32),
                                           want[i][1].view(np.uint32))):
                    errors.append((j, r))
        except Exception as exc:  # reported below
            errors.append(repr(exc))

    threads = [threading.Thread(target=searcher, args=(j,)) for j in (0, 1)]
    for th in threads:
        th.start()
    s, d = dev_idx.search(idx.store, small, 10, 50)  # a new key: captures
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    assert not errors, errors
    assert np.array_equal(s, want[4][0])
    assert np.array_equal(d.view(np.uint32), want[4][1].view(np.uint32))
    held = pool._held
    assert len(held) == 2 and max(held.values()) <= device_mod.GRAPH_CAP
    assert dev_idx.steps["graph_captures"] == sum(held.values())


def test_profiler_sees_each_kernel_of_a_replay(dev):
    """torch.profiler records a replayed step's kernels one by one, as it
    does the eager step's: device operations a replay against a step.
    Prints both (the benchmark's device metrics read these events)."""
    from torch.autograd import DeviceType

    idx, base, rng = _graph_index(dev, 2)
    dev_idx = idx._get_device()
    queries = base[:256] + 0.1 * rng.standard_normal((256, 48)).astype(
        np.float32)
    counts = []
    for graphs in (dev_idx._graphs, None):
        pool, dev_idx._graphs = dev_idx._graphs, graphs
        try:
            dev_idx.search(idx.store, queries, 10, 50)  # warm, captured
            torch.cuda.synchronize()
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            before = dev_idx.steps["layer0"]
            with prof:
                dev_idx.search(idx.store, queries, 10, 50)
                torch.cuda.synchronize()
            steps = dev_idx.steps["layer0"] - before
            ops = sum(ev.device_type() == DeviceType.CUDA
                      for ev in prof.profiler.kineto_results.events())
            counts.append((ops, steps))
        finally:
            dev_idx._graphs = pool
    (g_ops, g_steps), (e_ops, e_steps) = counts
    print(f"device operations in one sub-batch of 256: graphed {g_ops}, "
          f"eager {e_ops}, over {g_steps} steps (graphed runs up to "
          f"BEAM_BLOCK - 1 more replays)")
    assert g_steps == e_steps > 0
    assert g_ops >= 0.9 * e_ops


# GIST-1M's width (the gist1m-hnsw configuration): D = 960 streams the
# queries through the kernels' rings beside the pivot and base chunks


@pytest.mark.parametrize("R", [65536, 131072])
def test_pivot_kernel_at_gist_shape(dev, R):
    """L2 at B 256 and D 960 over the pivot counts of a million rows: the
    JAX package's 16 rows a pivot (65,536) and the port's 8 (131,072)."""
    _hold_pivot(*_pivot_inputs(dev, 1, 256, R, 960, R + 960), 1)


def test_lane_kernel_at_gist_shape(dev):
    """knn_lane_topc, L2 at B 2,048, N 65,536, D 960: the lane arrays and
    the top-32 against the plain lane scan's."""
    from scintirete_tpu_torch.ops.lane_scan import (
        _top_c,
        knn_lane_topc,
        lane_scan,
        lane_scan_plain,
    )

    B, N, D, c = 2048, 65536, 960, 32
    g = torch.Generator(device=dev).manual_seed(B + N + D)
    base32 = torch.randn(N, D, generator=g, device=dev)
    base = base32.to(torch.bfloat16)
    bsq = (base32 * base32).sum(1)
    q = base32[:B]
    si = torch.arange(B, dtype=torch.int32, device=dev)
    qb = q.to(torch.bfloat16).contiguous()
    before = lane_scan.launches
    k_lanes = lane_scan(qb, si, base, bsq, N, 1, N // 1024)
    p_lanes = lane_scan_plain(qb, si, base, bsq, N, 1, N // 1024)
    kd, ki = knn_lane_topc(q, si, base, bsq, N, 1, c, N // 1024)
    pd, pi = _top_c(p_lanes, q, 1, c, None)
    torch.cuda.synchronize()
    assert lane_scan.launches == before + 2
    for k, p in list(zip(k_lanes, p_lanes)) + [(kd, pd), (ki, pi)]:
        if k.dtype == torch.float32:
            fin = torch.isfinite(p)
            assert torch.equal(fin, torch.isfinite(k))
            torch.testing.assert_close(k[fin], p[fin], rtol=1e-5, atol=1e-4)
        else:
            assert (k == p).float().mean() > 0.999
    assert not bool((ki == si[:, None]).any())


def test_graphed_beam_at_gist_width(dev):
    """The L2 layer-0 beam over 960-wide rows, replayed as a CUDA graph,
    answers as the eager step does, ids and distance bits."""
    idx, base, rng = _graph_index(dev, 1, n=20000, dim=960)
    queries = base[:256] + 0.1 * rng.standard_normal((256, 960)).astype(
        np.float32)
    for B in (1, 100, 256):
        _assert_graphed_is_eager(idx, queries[:B], 10, 50, "pivot")
