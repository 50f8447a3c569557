"""The port's seq upper-layer build and NN-descent refinement against the
JAX package's.

`upper_mode="seq"`: the port builds a 4000 x 24 clustered cosine index
(tests/test_knn_build.py:655's corpus shape and gate); the JAX package's
`_build_upper_sequential` runs once on the same base order and levels, on
its bf16 scan base (the port's). Upper-layer neighbor sets must agree at
a mean per-row overlap of at least 0.99 (the beams' distances are f32 sums
in another order, so a near-tie may pick another neighbor), both keep the
degree and membership invariants, and the port's pure greedy walk reaches
recall@10 >= 0.97. One round's pieces are held to JAX exactly: the host
seed, one `upper_insert` tile and its reverse `upper_reprune_resident`
chains from the same mirror, ids equal on at least 99% of rows (a near-tie
of f32 sums in another order may swap one neighbor).

Refinement: `refine_chain` on one tile of a shared adjacency returns the
JAX package's ids (at least 99% of rows equal, as above) with distances
within rtol = atol = 1e-5; `_refine_layer0` keeps the invariants and raises the kNN@5
overlap; `HNSWIndex(refine_rounds=1)` refines layer 0 once and its
self-queries find themselves first.
"""

import numpy as np
import pytest
import torch

from scintirete_tpu.index import knn_build as jkb
from scintirete_tpu.types import DistanceMetric, HNSWParams, SearchParams
from scintirete_tpu_torch.index import knn_build as pkb
from scintirete_tpu_torch.index.hnsw import HNSWIndex
from scintirete_tpu_torch.ops.distance import distance_np

N, D = 4000, 24
PARAMS = HNSWParams(m=8, ef_construction=60, ef_search=40, seed=11)
COS = DistanceMetric.COSINE
OVERLAP_MIN = 0.99
ROWS_EQUAL_MIN = 0.99


def clustered(rng, n, dim, n_clusters, noise=0.3):
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 2.0
    assign = rng.integers(0, n_clusters, n)
    return (centers[assign] + noise * rng.standard_normal((n, dim))).astype(
        np.float32
    )


@pytest.fixture(scope="module")
def data():
    return clustered(np.random.default_rng(1), N, D, 40)


@pytest.fixture(scope="module")
def seq_pair(data):
    port = HNSWIndex(D, PARAMS, COS, device="cpu", upper_mode="seq")
    port.bulk_insert(list(range(1, N + 1)), data)
    store = port.store
    levels = store.levels[:N].astype(np.int64)
    order = np.lexsort((
        np.random.default_rng(store.seed ^ pkb._SHUFFLE_SALT).random(N),
        -levels,
    ))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCNT_BUILD_SCAN_DTYPE", "bfloat16")
        jctx = jkb._make_build_ctx(data[order], int(COS))
        jadj = jkb._build_upper_sequential(
            jctx, levels[order].astype(np.int32), store.m
        )
    return port, order, levels[order], jctx, jadj


def _row_overlap(a, b):
    shares = []
    for ra, rb in zip(a, b):
        want = set(rb[rb >= 0].tolist())
        if want:
            shares.append(len(set(ra[ra >= 0].tolist()) & want) / len(want))
    return float(np.mean(shares)) if shares else 1.0


def _check_layer(nbrs, slots_of_layer, m):
    """Degree bound, no self edge, no repeat, members only."""
    members = set(slots_of_layer.tolist())
    for slot, row in zip(slots_of_layer, nbrs):
        live = row[row >= 0]
        assert len(live) <= m and slot not in live
        assert len(set(live.tolist())) == len(live)
        assert set(live.tolist()) <= members, "edge to a non-member"
        assert np.all(row[len(live):] == -1)


def test_seq_upper_layers_match_jax(seq_pair):
    port, order, lvls, _, jadj = seq_pair
    store = port.store
    shares = []
    for l, ls in enumerate(store.layers, start=1):
        members = order[: int(np.count_nonzero(lvls >= l))]
        got = ls.nbrs[ls.row_of[members]]
        want = np.where(jadj[l] >= 0, order[np.maximum(jadj[l], 0)], -1)
        _check_layer(got, members, store.m)
        _check_layer(want, members, store.m)
        shares.append(_row_overlap(got, want))
    print("per-layer upper neighbor overlap with the JAX seq build:", shares)
    assert min(shares) >= OVERLAP_MIN, shares
    assert port.build_stats["upper_rounds"] >= 1
    assert port.build_stats["upper_tiles"] >= port.build_stats["upper_rounds"]


def test_seq_upper_layers_route_a_greedy_walk(seq_pair, data):
    """tests/test_knn_build.py::test_greedy_descent_routes_clustered on the
    port: the pure top-down greedy walk (no mid entry) on seq upper
    layers."""
    port = seq_pair[0]
    rng = np.random.default_rng(2)
    queries = (data[rng.integers(0, N, 128)]
               + 0.1 * rng.standard_normal((128, D)).astype(np.float32))
    gt = np.argsort(distance_np(queries, data, COS), axis=1,
                    kind="stable")[:, :10]
    s, _ = port._get_device().search(port.store, queries, 10, 40,
                                     entry_mode="descent", descent_mid=False)
    hits = sum(len(set(s[i].tolist()) & set(gt[i].tolist()))
               for i in range(128))
    assert hits / 1280 >= 0.97, f"greedy-descent recall {hits / 1280:.3f}"


def test_one_seq_round_matches_jax(seq_pair, data):
    """The host seed equals JAX's; then one upper_insert tile (rows [256,
    512)) and the reverse chains of its edges, from the same mirror, return
    JAX's ids."""
    import jax.numpy as jnp

    port, order, lvls, jctx, _ = seq_pair
    m, S, efu = port.store.m, pkb._UPPER_SEED, 64
    L = int(lvls.max())
    nm = np.asarray([np.count_nonzero(lvls >= l) for l in range(1, L + 1)])
    n1 = int(nm[0])
    assert n1 >= 2 * S, "too few upper rows for a full round"

    def empty():
        return {l: np.full((int(nm[l - 1]), m), -1, np.int32)
                for l in range(1, L + 1)}

    adj_p, adj_j = empty(), empty()
    pkb._seed_upper_host(pkb._scan_form(data[order[:S]], int(COS)), lvls, S,
                         adj_p, int(COS), m)
    jkb._seed_upper_host(jctx["rows_f32"], lvls.astype(np.int32), S, adj_j,
                         int(COS), m)
    for l in adj_p:
        np.testing.assert_array_equal(adj_p[l], adj_j[l])

    offs = np.zeros(16, np.int64)
    offs[1:L] = np.cumsum(nm)[:-1]
    tot = int(nm.sum())
    ucat0 = np.full((tot, m), -1, np.int32)
    for l in range(1, L + 1):
        k = min(S, int(nm[l - 1]))
        ucat0[offs[l - 1] : offs[l - 1] + k] = adj_p[l][:k]
    nms = np.minimum(S, np.pad(nm, (0, 16 - L)))
    lc = 1
    while lc < int(lvls[S : 2 * S].max()):
        lc *= 2
    steps = (lc + 2) * (efu + 64)

    # JAX: `_build_upper_sequential`'s own first tile (the same shapes, so
    # its compiled programs serve): _QBLOCK rows from row S, levels past 2S
    # zeroed, the mirror padded to its pow-4 size
    K = jkb._kernels()
    ub = jkb._QBLOCK
    qb, _, si = K["slice_block"](jctx["base_j"], jctx["base_sq"], np.int32(S),
                                 block=ub)
    lv = np.zeros(ub, np.int32)
    lv[:S] = lvls[S : 2 * S]
    tot_pad = jkb._pad_pow4(tot, minimum=2048)
    ucat_j = jnp.asarray(np.concatenate(
        [ucat0, np.full((tot_pad - tot, m), -1, np.int32)]))
    sel_j, ucat_j = K["upper_insert"](
        qb, si, jnp.asarray(lv), jctx["base_j"], jctx["base_sq"], ucat_j,
        jnp.asarray(offs.astype(np.int32)), jnp.asarray(nms.astype(np.int32)),
        np.int32(0), np.int32(lvls[0]), metric=int(COS), ef_upper=efu, m=m,
        lc=lc, max_steps=steps,
    )
    sel_j = np.asarray(sel_j).reshape(lc + 1, ub, m)[:, :S]

    pctx = pkb._make_build_ctx(data[order], int(COS), "cpu")
    ucat_p = torch.from_numpy(ucat0.astype(np.int64))
    sel_p, _ = pkb.upper_insert(
        pctx["base"][S : 2 * S], torch.arange(S, 2 * S),
        torch.from_numpy(lvls[S : 2 * S]), pctx["base"], pctx["base_sq"],
        ucat_p, torch.from_numpy(offs), torch.from_numpy(nms), 0,
        int(lvls[0]), metric=int(COS), ef_upper=efu, m=m, lc=lc,
        max_steps=steps,
    )
    sel_p = sel_p.numpy()
    rows_eq = []
    for l in range(1, sel_p.shape[0]):
        at = lvls[S : 2 * S] >= l
        rows_eq.extend(np.all(sel_p[l][at] == sel_j[l][at], axis=1))
        # the forward rows went into the mirror
        rows = np.arange(S, 2 * S)[at]
        np.testing.assert_array_equal(
            ucat_p.numpy()[offs[l - 1] + rows], sel_p[l][at])
    assert np.mean(rows_eq) >= ROWS_EQUAL_MIN, np.mean(rows_eq)
    ucat_host = np.asarray(ucat_j)

    # the reverse chains of the tile's edges (JAX's selections on both
    # sides, so the inputs are the same), layer by layer
    for l in range(1, sel_p.shape[0]):
        rows = np.arange(S, 2 * S)[lvls[S : 2 * S] >= l]
        dst = sel_j[l][rows - S].reshape(-1).astype(np.int64)
        keep = dst >= 0
        t_rows, inc = pkb._compact_incoming_ids(
            np.repeat(rows, m)[keep], dst[keep], 2 * m)
        jt, jinc = jkb._compact_incoming_ids(
            np.repeat(rows, m)[keep].astype(np.int32), dst[keep], 2 * m)
        np.testing.assert_array_equal(t_rows, jt)
        np.testing.assert_array_equal(inc, jinc)
        ucat_l = torch.from_numpy(ucat_host[:tot].astype(np.int64))
        si_p = pkb.upper_reprune_resident(
            pctx["base"], pctx["base_sq"], ucat_l, int(offs[l - 1]),
            torch.from_numpy(t_rows), torch.from_numpy(inc), int(COS), m,
        ).numpy()
        # padded as `_build_upper_sequential` pads a chain (pad rows are dropped)
        block = jkb._RPBLOCK
        tpad = np.full(block, tot_pad, np.int32)
        tpad[: len(t_rows)] = t_rows
        ipad = np.full((block, 2 * m), -1, np.int32)
        ipad[: len(t_rows)] = inc
        si_j, _ = K["upper_reprune_resident"](
            jctx["base_j"], jctx["base_sq"], jnp.asarray(ucat_host.copy()),
            np.int32(offs[l - 1]), jnp.asarray(tpad), jnp.asarray(ipad),
            metric=int(COS), m=m,
        )
        eq = np.all(si_p == np.asarray(si_j)[: len(t_rows)], axis=1)
        assert eq.mean() >= ROWS_EQUAL_MIN, (l, eq.mean())


def test_refine_chain_matches_jax():
    """One refine_chain tile (2048 rows, the whole adjacency) from the
    same adjacency and scan base: JAX's ids and distances."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n, m0 = 2048, 16
    base = clustered(rng, n, 32, 40, noise=0.4)
    ctx = pkb._make_build_ctx(base, int(COS), "cpu")
    adj = pkb._layer_adj(ctx, n, m0, True)
    fi, fd = pkb.refine_chain(
        ctx["base"], ctx["base_sq"], torch.from_numpy(adj.astype(np.int64)), 0,
        metric=int(COS), max_deg=m0, fanout=pkb._REFINE_FANOUT,
        heuristic=True, cpool=pkb.KNN_CANDIDATES,
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCNT_BUILD_SCAN_DTYPE", "bfloat16")
        jctx = jkb._make_build_ctx(base, int(COS))
    adj_pad = np.full((jctx["npad"], m0), -1, np.int32)
    adj_pad[:n] = adj
    ji, jd = jkb._kernels()["refine_chain"](
        jctx["base_j"], jctx["base_sq"], jnp.asarray(adj_pad), np.int32(0),
        metric=int(COS), max_deg=m0, fanout=jkb._REFINE_FANOUT,
        heuristic=True, cpool=jkb.KNN_CANDIDATES,
    )
    ji, jd = np.asarray(ji)[:n], np.asarray(jd)[:n]
    fi, fd = fi.numpy(), fd.numpy()
    eq = np.all(fi == ji, axis=1)
    assert eq.mean() >= ROWS_EQUAL_MIN, eq.mean()
    np.testing.assert_allclose(fd[eq], jd[eq], rtol=1e-5, atol=1e-5)


def test_refine_layer0_improves_knn_overlap():
    """tests/test_knn_build.py::test_refine_layer0_improves_knn_overlap on
    the port: invariants kept, kNN@5 overlap raised."""
    rng = np.random.default_rng(4)
    n, m0 = 2048, 16
    base = clustered(rng, n, 32, 40, noise=0.4)
    bn = base / np.linalg.norm(base, axis=1, keepdims=True)
    d = 1.0 - bn @ bn.T
    np.fill_diagonal(d, np.inf)
    true5 = np.argsort(d, axis=1)[:, :5]

    def overlap(adj):
        return sum(len(set(adj[i][adj[i] >= 0].tolist()) & set(true5[i]))
                   for i in range(n)) / (n * 5)

    ctx = pkb._make_build_ctx(base, int(COS), "cpu")
    adj = pkb._layer_adj(ctx, n, m0, True)
    refined = pkb._refine_layer0(ctx, adj, n, m0, True, rounds=1)
    assert refined.shape == (n, m0)
    assert not np.any(refined == np.arange(n)[:, None])
    assert refined.max() < n and refined.min() >= -1
    for row in refined:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
        assert np.all(row[len(live):] == -1)
    before, after = overlap(adj), overlap(refined)
    assert after > before and after >= 0.97, (before, after)


def test_build_honors_refine_rounds(monkeypatch):
    """HNSWParams.refine_rounds refines layer 0 once in a bulk build, the
    stats keep the unrefined layer 0, and self-queries find themselves
    first (tests/test_knn_build.py::test_build_honors_refine_rounds)."""
    calls = []
    real = pkb._refine_layer0

    def spy(ctx, adj, nm, max_deg, heuristic, rounds):
        calls.append((nm, max_deg, rounds))
        return real(ctx, adj, nm, max_deg, heuristic, rounds)

    monkeypatch.setattr(pkb, "_refine_layer0", spy)
    n, dim = 2100, 24
    base = np.random.default_rng(5).standard_normal((n, dim)).astype(np.float32)
    idx = HNSWIndex(dim, HNSWParams(m=8, ef_construction=50, seed=7,
                                    neighbor_heuristic=True, refine_rounds=1),
                    DistanceMetric.L2, device="cpu")
    idx.bulk_insert(list(range(1, n + 1)), base)
    assert calls == [(n, 16, 1)]  # layer 0 only, m0 = 2m
    stats = idx.build_stats
    assert stats["refine_s"] > 0 and stats["unrefined0"].shape == (n, 16)
    before = stats["unrefined0"]
    assert not np.array_equal(before, idx.store.neighbors0[:n])
    # slot space, rows and ids: mostly the same neighbors after one round
    same = [len(set(a[a >= 0]) & set(b[b >= 0])) / max((b >= 0).sum(), 1)
            for a, b in zip(before, idx.store.neighbors0[:n])]
    assert np.mean(same) > 0.5
    res = idx.search_batch(base[:8], SearchParams(top_k=3, ef_search=40))
    assert all(r[0][0] == i + 1 for i, r in enumerate(res))
