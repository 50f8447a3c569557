"""Port ops (scintirete_tpu_torch.ops) against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX function (Pallas kernels in
interpret mode) and the port's plain torch version. Tolerance: distances
within rtol = atol = 1e-5 (f32 sums taken in another order); ids equal on
every row whose reference ranking has no near-tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scintirete_tpu.ops.distance import dist_from_dots as jax_dist_from_dots
from scintirete_tpu.ops.distance import distance_np as jax_distance_np
from scintirete_tpu.ops.distance import pairwise_distance as jax_pairwise
from scintirete_tpu.ops.pallas_pivot import pivot_entry_scan as jax_pivot_scan
from scintirete_tpu.ops.pallas_scan import knn_lane_topc as jax_knn_lane_topc
from scintirete_tpu.ops.pallas_scan import (
    knn_lane_topc_masked as jax_knn_lane_topc_masked,
)
from scintirete_tpu.ops.topk import brute_force_topk as jax_brute_force
from scintirete_tpu_torch.ops import distance as tdist
from scintirete_tpu_torch.ops.lane_scan import (
    knn_lane_topc,
    knn_lane_topc_masked,
)
from scintirete_tpu_torch.ops.pivot_scan import pivot_entry_scan
from scintirete_tpu_torch.ops.topk import brute_force_topk

METRICS = [1, 2, 3]  # L2, cosine, inner product
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _untied(d, rel=1e-5):
    """Rows [B, k] whose ascending distances have no two within rel."""
    d = np.asarray(d, np.float64)
    gap = np.diff(d, axis=1)
    scale = np.maximum(1.0, np.abs(d[:, 1:]))
    fin = np.isfinite(d[:, 1:])
    return np.all(~fin | (gap > rel * scale), axis=1)


@pytest.fixture
def vecs(rng):
    q = rng.standard_normal((12, 33)).astype(np.float32)
    b = rng.standard_normal((300, 33)).astype(np.float32)
    q[3] = 0.0  # zero query: cosine distance 1 to everything
    b[7] = 0.0  # zero base row
    return q, b


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_distance_matches_jax(vecs, metric):
    q, b = vecs
    want = np.asarray(jax_pairwise(jnp.asarray(q), jnp.asarray(b), metric))
    got = tdist.pairwise_distance(_t(q), _t(b), metric).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if metric == 2:
        assert np.all(got[3] == 1.0) and np.all(got[:, 7] == 1.0)


@pytest.mark.parametrize("metric", METRICS)
def test_dist_from_dots_and_distance_np_match_jax(vecs, metric):
    q, b = vecs
    dots = q @ b.T
    q_sq = np.sum(q * q, axis=1, keepdims=True)
    b_sq = np.sum(b * b, axis=1)[None, :]
    want = np.asarray(jax_dist_from_dots(
        jnp.asarray(dots), jnp.asarray(q_sq), jnp.asarray(b_sq), metric
    ))
    got = tdist.dist_from_dots(_t(dots), _t(q_sq), _t(b_sq), metric).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(
        tdist.distance_np(q, b, metric), jax_distance_np(q, b, metric)
    )
    np.testing.assert_array_equal(
        tdist.distance_np(q[0], b, metric), jax_distance_np(q[0], b, metric)
    )


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("tile", [64, 65536])
def test_brute_force_topk_matches_jax(vecs, metric, tile):
    q, b = vecs
    valid = np.ones(len(b), bool)
    valid[::5] = False
    want_d, want_i = jax_brute_force(
        jnp.asarray(q), jnp.asarray(b), jnp.asarray(valid), metric, 10,
        tile=tile,
    )
    got_d, got_i = brute_force_topk(_t(q), _t(b), _t(valid), metric, 10,
                                    tile=tile)
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, **TOL)
    rows = _untied(want_d)
    assert rows.mean() > 0.5
    np.testing.assert_array_equal(got_i.numpy()[rows], want_i[rows])
    assert not np.isin(got_i.numpy(), np.flatnonzero(~valid)).any()


def test_brute_force_topk_pads_past_live(vecs):
    q, b = vecs
    d, i = brute_force_topk(_t(q), _t(b[:4]), torch.ones(4, dtype=torch.bool),
                            1, 6)
    assert np.all(i.numpy()[:, 4:] == -1) and np.all(np.isinf(d.numpy()[:, 4:]))


def _pivot_inputs(rng, metric, R=1024, D=33, B=16):
    q = rng.standard_normal((B, D)).astype(np.float32)
    pv = rng.standard_normal((R, D)).astype(np.float32)
    if metric == 2:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        pv /= np.linalg.norm(pv, axis=1, keepdims=True)
    psq = np.sum(pv * pv, axis=1).astype(np.float32)
    pdel = np.zeros(R, np.float32)
    pdel[::3] = 1.0
    return q, pv, psq, pdel


@pytest.mark.parametrize("metric", METRICS)
def test_pivot_entry_scan_plain_matches_pallas(rng, metric):
    q, pv, psq, pdel = _pivot_inputs(rng, metric)
    want_d, want_i = jax_pivot_scan(
        jnp.asarray(q), jnp.asarray(pv), jnp.asarray(psq), jnp.asarray(pdel),
        metric=metric, interpret=True,
    )
    got_d, got_i = pivot_entry_scan(_t(q), _t(pv), _t(psq), _t(pdel), metric)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_i.dtype == torch.int32
    assert not np.any(pdel[got_i.numpy()] > 0.5)


def test_pivot_entry_scan_all_deleted(rng):
    q, pv, psq, _ = _pivot_inputs(rng, 1)
    pdel = np.ones(len(pv), np.float32)
    want_d, want_i = jax_pivot_scan(
        jnp.asarray(q), jnp.asarray(pv), jnp.asarray(psq), jnp.asarray(pdel),
        metric=1, interpret=True,
    )
    got_d, got_i = pivot_entry_scan(_t(q), _t(pv), _t(psq), _t(pdel), 1)
    assert np.all(np.isinf(got_d.numpy())) and np.all(np.isinf(want_d))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.all(got_i.numpy() == -1)


def test_pivot_entry_scan_ties_go_to_lowest_index(rng):
    q, pv, psq, pdel = _pivot_inputs(rng, 3, R=1024)
    pdel[:] = 0.0
    pv[700] = pv[900] = pv[100] = q[0] * 50.0  # three equal best pivots
    psq = np.sum(pv * pv, axis=1).astype(np.float32)
    _, got_i = pivot_entry_scan(_t(q), _t(pv), _t(psq), _t(pdel), 3)
    _, want_i = jax_pivot_scan(
        jnp.asarray(q), jnp.asarray(pv), jnp.asarray(psq), jnp.asarray(pdel),
        metric=3, interpret=True,
    )
    assert int(got_i[0]) == int(want_i[0]) == 100


def _assert_topc_matches(q, base_sq, metric, got_d, got_i, want_d, want_i):
    """Top-c distances within 1e-5 (L2: squared, relative to the squared
    norms that cancel) and ids equal on every row with no near-tie."""
    if metric == 1:
        # sqrt(s + q^2) amplifies the f32 sum-order error of a cancelled
        # difference near 0: compare squared distances, 1e-5 relative to
        # the squared norms that cancel
        fin = np.isfinite(want_d)
        assert np.array_equal(fin, np.isfinite(got_d))
        scale = np.sum(q * q, axis=1)[:, None] + base_sq.max()
        err = np.abs(got_d**2 - want_d**2)[fin]
        assert np.all(err <= 1e-5 * np.broadcast_to(scale, fin.shape)[fin])
    else:
        np.testing.assert_allclose(got_d, want_d, **TOL)
    untied = _untied(want_d)
    assert untied.mean() > 0.8
    np.testing.assert_array_equal(got_i[untied], want_i[untied])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("grid_tiles,n_valid", [(1, 1000), (2, 1500), (2, 2048)])
def test_knn_lane_topc_plain_matches_pallas(rng, metric, grid_tiles, n_valid):
    N, D, B, c = 2048, 33, 40, 16
    base = rng.standard_normal((N, D)).astype(np.float32)
    if metric == 2:
        base /= np.linalg.norm(base, axis=1, keepdims=True)
    base_sq = np.sum(base * base, axis=1).astype(np.float32)
    rows = rng.choice(min(n_valid, N), B, replace=False)
    q = base[rows]
    self_idx = rows.astype(np.int32)
    self_idx[::4] = -1  # no exclusion for these rows
    want_d, want_i = jax_knn_lane_topc(
        jnp.asarray(q), jnp.asarray(self_idx),
        jnp.asarray(base).astype(jnp.bfloat16), jnp.asarray(base_sq),
        n_valid, metric=metric, c=c, grid_tiles=grid_tiles, interpret=True,
    )
    got_d, got_i = knn_lane_topc(
        _t(q), _t(self_idx), _t(base).to(torch.bfloat16), _t(base_sq),
        n_valid, metric=metric, c=c, grid_tiles=grid_tiles,
    )
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    got_d, got_i = got_d.numpy(), got_i.numpy()
    _assert_topc_matches(q, base_sq, metric, got_d, got_i, want_d, want_i)
    limit = min(n_valid, grid_tiles * 1024)
    assert np.all(got_i < limit)
    assert not np.any(got_i == self_idx[:, None])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("grid_tiles", [2, 3])
def test_knn_lane_topc_masked_plain_matches_pallas(rng, metric, grid_tiles):
    """The append's masked scan: a random member subset with tombstones
    and a masked tail, queries that are members (self rows) and not."""
    N, D, B, c = 3072, 33, 40, 16
    base = rng.standard_normal((N, D)).astype(np.float32)
    if metric == 2:
        base /= np.linalg.norm(base, axis=1, keepdims=True)
    base_sq = np.sum(base * base, axis=1).astype(np.float32)
    invalid = (rng.random(N) < 0.6).astype(np.float32)
    invalid[2500:] = 1.0  # the padded tail past the store's count
    members = np.flatnonzero(invalid < 0.5)
    rows = np.concatenate([rng.choice(members, B - 8, replace=False),
                           rng.choice(np.flatnonzero(invalid > 0.5), 8)])
    q = base[rows]
    self_idx = rows.astype(np.int32)
    self_idx[::5] = -1  # no exclusion for these rows
    want_d, want_i = jax_knn_lane_topc_masked(
        jnp.asarray(q), jnp.asarray(self_idx),
        jnp.asarray(base).astype(jnp.bfloat16), jnp.asarray(base_sq),
        jnp.asarray(invalid), metric=metric, c=c, grid_tiles=grid_tiles,
        interpret=True,
    )
    got_d, got_i = knn_lane_topc_masked(
        _t(q), _t(self_idx), _t(base).to(torch.bfloat16), _t(base_sq),
        _t(invalid), metric=metric, c=c, grid_tiles=grid_tiles,
    )
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    got_d, got_i = got_d.numpy(), got_i.numpy()
    _assert_topc_matches(q, base_sq, metric, got_d, got_i, want_d, want_i)
    assert not np.any(invalid[got_i[got_i >= 0]] > 0.5)
    assert np.all(got_i < grid_tiles * 1024)
    assert not np.any(got_i == self_idx[:, None])
