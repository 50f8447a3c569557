"""The flat index's ops (scintirete_tpu_torch.ops.packed_scan / flat_scan)
against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX function (Pallas kernels in
interpret mode) and the port's plain torch version. Tolerances:

- `quantize_rows`: exactly equal.
- int8 scans: the s8 x s8 -> s32 product is exact on both sides, so packed
  keys are equal bit for bit and rows element for element for cosine and
  inner product. For L2 XLA's CPU backend contracts the score's multiply
  and subtract into one fused multiply-add, rounding once where the port
  (like its CUDA kernel, which forbids the contraction) rounds twice: a
  few keys in 10^4 then differ by one unit of the last kept mantissa bit,
  and are held to the bf16 scans' rule below.
- bf16 scans: the f32 sum of the product is taken in another order, so a
  packed key may differ by one unit of its last kept mantissa bit (relative
  2^-10) and a row wherever the two nearest keys of its lane lie closer
  than that; unpacked scores within atol 1e-4, rtol 1e-5.
- `flat_topk*`: distances within rtol 1e-5, atol 1e-6; slots equal on every
  row whose reference ranking has no near-tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scintirete_tpu.ops.flat_scan as jax_flat
import scintirete_tpu.ops.pallas_scan as jax_scan
import scintirete_tpu_torch.ops.flat_scan as port_flat
import scintirete_tpu_torch.ops.packed_scan as port_scan
from scintirete_tpu.index.flat import _quant8 as jax_quant8
from scintirete_tpu.ops.distance import distance_np
from scintirete_tpu_torch.index.flat import _quant8

L2, COS, IP = 1, 2, 3
METRICS = [L2, COS, IP]
LANES = port_scan.LANES
KEY_RTOL = 2.0**-10  # one unit of the last mantissa bit a packed key keeps
SCORE_TOL = dict(atol=1e-4, rtol=1e-5)
DIST_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    return _t(a).to(torch.bfloat16)


def _untied(d, rel=1e-5):
    """Rows [B, k] whose ascending distances have no two within rel."""
    d = np.asarray(d, np.float64)
    gap = np.diff(d, axis=1)
    scale = np.maximum(1.0, np.abs(d[:, 1:]))
    fin = np.isfinite(d[:, 1:])
    return np.all(~fin | (gap > rel * scale), axis=1)


def _inputs(rng, metric, N, D=32, B=16, deleted=0.1, tail=5):
    """(q, exact base, scan-form base, scan-form norms, invalid)."""
    q = rng.standard_normal((B, D)).astype(np.float32)
    base = rng.standard_normal((N, D)).astype(np.float32)
    if metric == COS:
        scan = base / np.linalg.norm(base, axis=1, keepdims=True)
        q_scan = q / np.linalg.norm(q, axis=1, keepdims=True)
    else:
        scan, q_scan = base, q
    scan_sq = np.sum(scan * scan, axis=1).astype(np.float32)
    invalid = (rng.random(N) < deleted).astype(np.float32)
    if tail:
        invalid[N - tail:] = 1.0
    return q, q_scan, base, scan.astype(np.float32), scan_sq, invalid


def test_constants_match():
    for name in ("_TILE_BITS", "_TILE_MASK", "_SENTINEL", "_PREMIN",
                 "_SCALE_CAP", "_BSQ_CAP", "LANES"):
        assert getattr(port_scan, name) == getattr(jax_scan, name), name


def test_quantize_rows_exactly_equal(rng):
    v = rng.standard_normal((64, 24)).astype(np.float32)
    v[3] = 0.0  # zero row: scale 0, zeros
    v[5] = np.arange(24, dtype=np.float32) - 11.5  # x.5 quotients
    v[6] *= 1e-20
    v[7] *= 1e20
    want_q, want_s = jax_scan.quantize_rows(jnp.asarray(v))
    got_q, got_s = port_scan.quantize_rows(_t(v))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert got_s[3] == 0 and not got_q[3].any()
    # the host mirrors agree with each other and with the device function
    hq, hs = _quant8(v)
    jq, js = jax_quant8(v)
    np.testing.assert_array_equal(hq, jq)
    np.testing.assert_array_equal(hs, js)
    np.testing.assert_array_equal(hq, got_q.numpy())
    np.testing.assert_array_equal(hs, got_s.numpy())


def _assert_packed_close(keys, rows, want_keys, want_rows):
    """Keys within one unit of the last kept mantissa bit; rows equal
    wherever the lane's two keys lie further apart than that."""
    np.testing.assert_allclose(keys, want_keys, rtol=KEY_RTOL, atol=1e-30)
    differ = rows != want_rows
    if differ.any():
        k1, k2 = want_keys[:, :LANES], want_keys[:, LANES:]
        near = np.abs(k1 - k2) <= KEY_RTOL * np.maximum(np.abs(k1), np.abs(k2))
        assert np.all(np.tile(near, (1, 2))[differ])
        assert differ.mean() < 1e-3


def _assert_int8_keys(keys, rows, want_keys, want_rows, metric):
    """Bit for bit, except where the reference's L2 score was contracted
    into a fused multiply-add (see the module docstring)."""
    if metric == L2:
        _assert_packed_close(keys, rows, want_keys, want_rows)
        assert (keys.view(np.int32) == want_keys.view(np.int32)).mean() > 0.999
    else:
        np.testing.assert_array_equal(
            keys.view(np.int32), want_keys.view(np.int32)
        )
        np.testing.assert_array_equal(rows, want_rows)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("tps", [1, 2, 4, 8])
def test_packed_int8_scan_matches_pallas(rng, metric, tps):
    """Groups of 1, 2, 4 and 4 tiles: which candidates survive depends on
    `tps`, and the port's survivors are the JAX package's."""
    _, q_scan, _, scan, scan_sq, invalid = _inputs(rng, metric, 8 * LANES)
    b8, sc = _quant8(scan)
    want_k, want_r = jax_scan.lane_topk_scan_packed_int8(
        jnp.asarray(q_scan), jnp.asarray(b8), jnp.asarray(sc),
        jnp.asarray(scan_sq), jnp.asarray(invalid), metric, interpret=True,
        tps=tps,
    )
    keys, rows = port_scan.lane_topk_scan_packed_int8(
        _t(q_scan), _t(b8), _t(sc), _t(scan_sq), _t(invalid), metric, tps=tps
    )
    want_k, want_r = np.asarray(want_k), np.asarray(want_r)
    _assert_int8_keys(keys.numpy(), rows.numpy(), want_k, want_r, metric)
    assert rows.dtype == torch.int32 and keys.shape == (16, 2 * LANES)
    live = rows.numpy()[rows.numpy() >= 0]
    assert live.size and not np.any(invalid[live] > 0.5)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("tps", [1, 4])
def test_packed_bf16_scan_matches_pallas(rng, metric, tps):
    _, q_scan, _, scan, scan_sq, invalid = _inputs(rng, metric, 4 * LANES)
    want_k, want_r = jax_scan.lane_topk_scan_packed(
        jnp.asarray(q_scan), jnp.asarray(scan, jnp.bfloat16),
        jnp.asarray(scan_sq), jnp.asarray(invalid), metric, interpret=True,
        tps=tps,
    )
    keys, rows = port_scan.lane_topk_scan_packed(
        _t(q_scan), _bf16(scan), _t(scan_sq), _t(invalid), metric, tps=tps
    )
    _assert_packed_close(
        keys.numpy(), rows.numpy(), np.asarray(want_k), np.asarray(want_r)
    )
    assert (rows.numpy() == np.asarray(want_r)).mean() > 0.999
    live = rows.numpy()[rows.numpy() >= 0]
    assert live.size and not np.any(invalid[live] > 0.5)
    if tps > 1:  # `tps` does not change the bf16 scan's result
        k1, r1 = port_scan.lane_topk_scan_packed(
            _t(q_scan), _bf16(scan), _t(scan_sq), _t(invalid), metric
        )
        assert torch.equal(k1, keys) and torch.equal(r1, rows)


def _assert_unpacked_close(d, i, want_d, want_i):
    fin = np.isfinite(want_d)
    np.testing.assert_array_equal(np.isfinite(d), fin)
    np.testing.assert_allclose(d[fin], want_d[fin], **SCORE_TOL)
    np.testing.assert_array_equal(i, want_i)


@pytest.mark.parametrize("metric", METRICS)
def test_lane_int8_scan_matches_pallas(rng, metric):
    _, q_scan, _, scan, scan_sq, invalid = _inputs(rng, metric, 3 * LANES)
    b8, sc = _quant8(scan)
    want_d, want_i = jax_scan.lane_topk_scan_int8(
        jnp.asarray(q_scan), jnp.asarray(b8), jnp.asarray(sc),
        jnp.asarray(scan_sq), jnp.asarray(invalid), metric, interpret=True,
    )
    d, i = port_scan.lane_topk_scan_int8(
        _t(q_scan), _t(b8), _t(sc), _t(scan_sq), _t(invalid), metric
    )
    _assert_unpacked_close(
        d.numpy(), i.numpy(), np.asarray(want_d), np.asarray(want_i)
    )
    assert i.dtype == torch.int32 and not np.any(invalid[i.numpy()[i.numpy() >= 0]] > 0.5)


def _tied_int8_base(rng, D=32, tiles=3):
    """Small-integer rows, each tile a copy of the first with a third of
    its rows redrawn: rows r and r + LANES k of one lane quantize to the
    same int8 row and scale, so their scores tie exactly on both sides."""
    first = rng.integers(-3, 4, (LANES, D)).astype(np.float32)
    scan = np.tile(first, (tiles, 1))
    redraw = rng.random(tiles * LANES) < 0.3
    redraw[:LANES] = False
    scan[redraw] = rng.integers(-3, 4, (int(redraw.sum()), D))
    return scan


@pytest.mark.parametrize("metric", METRICS)
def test_lane_int8_scan_breaks_ties_as_pallas(rng, metric):
    """Exact ties across tiles: the strict-< fold keeps the earlier tile's
    row. The port's plain version and the JAX kernel (interpret mode) agree
    on every id, and on every score."""
    scan = _tied_int8_base(rng)
    q = scan[rng.choice(LANES, 8, replace=False)] + rng.integers(
        -1, 2, (8, scan.shape[1])).astype(np.float32)
    scan_sq = np.sum(scan * scan, axis=1).astype(np.float32)
    invalid = (rng.random(len(scan)) < 0.1).astype(np.float32)
    b8, sc = _quant8(scan)
    want_d, want_i = jax_scan.lane_topk_scan_int8(
        jnp.asarray(q), jnp.asarray(b8), jnp.asarray(sc),
        jnp.asarray(scan_sq), jnp.asarray(invalid), metric, interpret=True,
    )
    d, i = port_scan.lane_topk_scan_int8(
        _t(q), _t(b8), _t(sc), _t(scan_sq), _t(invalid), metric
    )
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), **SCORE_TOL)
    # the ties are there: some lane's best has an equal score in a later tile
    rows = i.numpy()[:, :LANES]
    later = rows[rows >= 0] + LANES
    later = later[later < len(scan)]
    assert np.any(np.all(scan[later] == scan[later - LANES], axis=1))


@pytest.mark.parametrize("metric", METRICS)
def test_lane_int8_scan_padded_width_is_the_same(rng, metric):
    """The card's wrapper pads queries and base to `scan_width(D, 1)`
    columns (a multiple of 16) with zeros after quantizing: zero columns
    change no dot, no scale and no norm, so the plain result is the same
    bits with and without them."""
    from scintirete_tpu_torch.ops.lane_scan import scan_width

    _, q_scan, _, scan, scan_sq, invalid = _inputs(rng, metric, 2 * LANES,
                                                   D=40)
    b8, sc = _quant8(scan)
    pad = scan_width(40, 1) - 40
    assert pad > 0
    d0, i0 = port_scan.lane_topk_scan_int8(
        _t(q_scan), _t(b8), _t(sc), _t(scan_sq), _t(invalid), metric
    )
    d1, i1 = port_scan.lane_topk_scan_int8(
        _t(np.pad(q_scan, ((0, 0), (0, pad)))), _t(np.pad(b8, ((0, 0), (0, pad)))),
        _t(sc), _t(scan_sq), _t(invalid), metric,
    )
    assert torch.equal(d0.view(torch.int32), d1.view(torch.int32))
    assert torch.equal(i0, i1)


@pytest.mark.parametrize("metric", METRICS)
def test_lane_bf16_scan_matches_pallas(rng, metric):
    _, q_scan, _, scan, scan_sq, invalid = _inputs(rng, metric, 3 * LANES)
    want_d, want_i = jax_scan.lane_topk_scan(
        jnp.asarray(q_scan), jnp.asarray(scan, jnp.bfloat16),
        jnp.asarray(scan_sq), jnp.asarray(invalid), metric, interpret=True,
    )
    d, i = port_scan.lane_topk_scan(
        _t(q_scan), _bf16(scan), _t(scan_sq), _t(invalid), metric
    )
    _assert_unpacked_close(
        d.numpy(), i.numpy(), np.asarray(want_d), np.asarray(want_i)
    )
    assert not np.any(invalid[i.numpy()[i.numpy() >= 0]] > 0.5)


def _run_scan(side, kernel, q, scan, scan_sq, invalid, metric):
    """One of the four scans on the JAX side or the port's: (f32, i32)."""
    int8 = kernel.endswith("int8")
    if side == "jax":
        base = jnp.asarray(_quant8(scan)[0]) if int8 else jnp.asarray(
            scan, jnp.bfloat16)
        args = [jnp.asarray(q), base]
        if int8:
            args.append(jnp.asarray(_quant8(scan)[1]))
        args += [jnp.asarray(scan_sq), jnp.asarray(invalid), metric]
        out = getattr(jax_scan, kernel)(*args, interpret=True)
        return np.asarray(out[0]), np.asarray(out[1])
    base = _t(_quant8(scan)[0]) if int8 else _bf16(scan)
    args = [_t(q), base]
    if int8:
        args.append(_t(_quant8(scan)[1]))
    args += [_t(scan_sq), _t(invalid), metric]
    out = getattr(port_scan, kernel)(*args)
    return out[0].numpy(), out[1].numpy()


KERNELS = ["lane_topk_scan_packed_int8", "lane_topk_scan_packed",
           "lane_topk_scan_int8", "lane_topk_scan"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_all_rows_deleted(rng, kernel):
    _, q, _, scan, scan_sq, _ = _inputs(rng, L2, 2 * LANES)
    invalid = np.ones(2 * LANES, np.float32)
    want_f, want_i = _run_scan("jax", kernel, q, scan, scan_sq, invalid, L2)
    f, i = _run_scan("port", kernel, q, scan, scan_sq, invalid, L2)
    assert np.all(i == -1) and np.all(want_i == -1)
    np.testing.assert_array_equal(f, want_f)  # sentinel keys or +inf
    assert np.all(f >= 0.5 * port_scan._SENTINEL)


@pytest.mark.parametrize("kernel", KERNELS)
def test_ragged_query_count(rng, kernel):
    """B = 13 (no multiple of 8) gives the first 13 rows of the JAX
    package's 16-row answer: the port's scans take any B."""
    _, q, _, scan, scan_sq, invalid = _inputs(rng, COS, 2 * LANES)
    want_f, want_i = _run_scan("jax", kernel, q, scan, scan_sq, invalid, COS)
    f, i = _run_scan("port", kernel, q[:13], scan, scan_sq, invalid, COS)
    assert f.shape == (13, 2 * LANES)
    if kernel == "lane_topk_scan_packed_int8":
        _assert_int8_keys(f, i, want_f[:13], want_i[:13], COS)
    elif "packed" in kernel:
        _assert_packed_close(f, i, want_f[:13], want_i[:13])
    else:
        _assert_unpacked_close(f, i, want_f[:13], want_i[:13])


def test_scan_shape_contracts_raise(rng):
    _, q, _, scan, scan_sq, invalid = _inputs(rng, L2, LANES + 7)
    with pytest.raises(ValueError, match="multiple"):
        port_scan.lane_topk_scan(_t(q), _bf16(scan), _t(scan_sq), _t(invalid), L2)
    with pytest.raises(ValueError, match="multiple"):
        port_scan.lane_topk_scan_packed(
            _t(q), _bf16(scan[:LANES]), _t(scan_sq[:LANES]),
            _t(invalid[:LANES]), L2, tps=2,
        )
    b8, sc = _quant8(scan[:LANES])
    with pytest.raises(ValueError, match="metric"):
        port_scan.lane_topk_scan_packed_int8(
            _t(q), _t(b8), _t(sc), _t(scan_sq[:LANES]), _t(invalid[:LANES]), 9
        )
    # more tiles than the 13 tile-id bits of a packed key hold: shapes only
    n_big = ((1 << port_scan._TILE_BITS) + 1) * LANES
    big = torch.empty((n_big, 1), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tile-id bits"):
        port_scan.lane_topk_scan_packed(
            _t(q[:, :1]), big, torch.empty(n_big), torch.empty(n_big), L2
        )


def test_unpack_lane_keys_matches_jax(rng):
    keys = rng.standard_normal((4, 2 * LANES)).astype(np.float32)
    keys[0, :7] = port_scan._SENTINEL
    want = jax_scan.unpack_lane_keys(jnp.asarray(keys))
    got = port_scan.unpack_lane_keys(_t(keys))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# flat_topk_fused / flat_topk_rerank / flat_topk
# ---------------------------------------------------------------------------


def _assert_topk_matches(got, want, ref=None, min_untied=0.8):
    (d, s), (want_d, want_s) = got, want
    d, s = d.numpy(), s.numpy()
    want_d, want_s = np.asarray(want_d), np.asarray(want_s)
    assert d.shape == want_d.shape and s.dtype == np.int32
    fin = np.isfinite(want_d)
    np.testing.assert_array_equal(np.isfinite(d), fin)
    np.testing.assert_allclose(d[fin], want_d[fin], **DIST_TOL)
    rows = _untied(want_d)
    assert rows.mean() > min_untied
    np.testing.assert_array_equal(s[rows], want_s[rows])
    if ref is not None:  # exact distances of the returned slots
        for b in range(len(d)):
            ok = s[b] >= 0
            np.testing.assert_allclose(d[b][ok], ref[b, s[b][ok]], **DIST_TOL)


def _fused_pair(q, scan_j, scan_t, base_j, base_t, valid, metric, k, scan_sq,
                **kw):
    jkw = {key: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for key, v in kw.items()}
    tkw = {key: (_t(v) if isinstance(v, np.ndarray) else v)
           for key, v in kw.items()}
    want = jax_flat.flat_topk_fused(
        q[0], scan_j, base_j, jnp.asarray(valid), metric, k,
        jnp.asarray(scan_sq), interpret=True, **jkw,
    )
    got = port_flat.flat_topk_fused(
        q[1], scan_t, base_t, _t(valid), metric, k, _t(scan_sq), **tkw
    )
    return got, want


@pytest.mark.parametrize("metric", METRICS)
def test_flat_topk_fused_bf16_scan_matches_jax(rng, metric):
    q, _, base, scan, scan_sq, invalid = _inputs(rng, metric, 2 * LANES, D=24)
    valid = invalid < 0.5
    got, want = _fused_pair(
        (jnp.asarray(q), _t(q)), jnp.asarray(scan, jnp.bfloat16), _bf16(scan),
        jnp.asarray(base), _t(base), valid, metric, 10, scan_sq,
    )
    ref = np.where(valid[None, :], distance_np(q, base, metric), np.inf)
    _assert_topk_matches(got, want, ref.astype(np.float32))
    true_i = np.argsort(ref, axis=1, kind="stable")[:, :10]
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(got[1].numpy(), true_i))
    assert hits / true_i.size >= 0.95


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("tps", [1, 2])
def test_flat_topk_fused_int8_scan_matches_jax(rng, metric, tps):
    q, _, base, scan, scan_sq, invalid = _inputs(rng, metric, 2 * LANES, D=24)
    valid = invalid < 0.5
    b8, sc = _quant8(scan)
    got, want = _fused_pair(
        (jnp.asarray(q), _t(q)), jnp.asarray(b8), _t(b8), jnp.asarray(base),
        _t(base), valid, metric, 10, scan_sq, base_scale=sc, tps=tps,
    )
    ref = np.where(valid[None, :], distance_np(q, base, metric), np.inf)
    _assert_topk_matches(got, want, ref.astype(np.float32))


@pytest.mark.parametrize("metric", METRICS)
def test_flat_topk_fused_bf16_rerank_source_matches_jax(rng, metric):
    """The rerank source may be the bf16 corpus copy: distances are then
    exact f32 distances of the bf16-rounded rows on both sides."""
    q, _, base, scan, scan_sq, invalid = _inputs(rng, metric, 2 * LANES, D=24)
    b8, sc = _quant8(scan)
    got, want = _fused_pair(
        (jnp.asarray(q), _t(q)), jnp.asarray(b8), _t(b8),
        jnp.asarray(base, jnp.bfloat16), _bf16(base), invalid < 0.5, metric,
        10, scan_sq, base_scale=sc,
    )
    assert got[0].dtype == torch.float32
    _assert_topk_matches(got, want)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("query_dtype", ["f16", "int8"])
def test_flat_topk_fused_narrow_queries_match_jax(rng, metric, query_dtype):
    q, _, base, scan, scan_sq, invalid = _inputs(rng, metric, 2 * LANES, D=24)
    kw = {}
    if query_dtype == "int8":
        q8, qsc = _quant8(q)
        qs = (jnp.asarray(q8), _t(q8))
        kw["query_scale"] = qsc
        loose = dict(rtol=2e-2, atol=2e-2)
    else:
        qs = (jnp.asarray(q, jnp.float16), _t(q).to(torch.float16))
        loose = dict(rtol=2e-3, atol=2e-3)
    valid = invalid < 0.5
    got, want = _fused_pair(
        qs, jnp.asarray(scan, jnp.bfloat16), _bf16(scan), jnp.asarray(base),
        _t(base), valid, metric, 10, scan_sq, **kw,
    )
    _assert_topk_matches(got, want)
    # against the unrounded queries only the input rounding deviates
    ref = distance_np(q, base, metric).astype(np.float32)
    d, s = got[0].numpy(), got[1].numpy()
    for b in range(len(d)):
        np.testing.assert_allclose(d[b], ref[b, s[b]], **loose)


@pytest.mark.parametrize("k,width,n_valid", [(80, 64, None), (12, 64, 7)])
def test_flat_topk_fused_pads_past_width_and_live(rng, k, width, n_valid):
    q, _, base, scan, scan_sq, invalid = _inputs(
        rng, L2, LANES, D=24, deleted=0.0, tail=0
    )
    if n_valid is not None:
        invalid[n_valid:] = 1.0
    got, want = _fused_pair(
        (jnp.asarray(q), _t(q)), jnp.asarray(scan, jnp.bfloat16), _bf16(scan),
        jnp.asarray(base), _t(base), invalid < 0.5, L2, k, scan_sq,
        width=width,
    )
    # 64 ranked distances a row: a near-tie somewhere in it is common
    _assert_topk_matches(got, want, min_untied=0.3)
    n_real = min(width, n_valid or LANES)
    assert got[0].shape == (16, k)
    assert np.all(got[1].numpy()[:, n_real:] == -1)
    assert np.all(np.isinf(got[0].numpy()[:, n_real:]))
    assert np.all(got[1].numpy()[:, :n_real] >= 0)


@pytest.mark.parametrize("metric", METRICS)
def test_flat_topk_rerank_matches_jax(rng, metric):
    q, _, base, scan, scan_sq, invalid = _inputs(rng, metric, 1500, D=24)
    valid = invalid < 0.5
    want = jax_flat.flat_topk_rerank(
        jnp.asarray(q), jnp.asarray(scan, jnp.bfloat16), jnp.asarray(base),
        jnp.asarray(valid), metric, 10, jnp.asarray(scan_sq), width=40,
    )
    got = port_flat.flat_topk_rerank(
        _t(q), _bf16(scan), _t(base), _t(valid), metric, 10, _t(scan_sq),
        width=40,
    )
    ref = np.where(valid[None, :], distance_np(q, base, metric), np.inf)
    _assert_topk_matches(got, want, ref.astype(np.float32))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("tile", [None, 384])
def test_flat_topk_matches_jax(rng, metric, tile, monkeypatch):
    """The single-shot branch and, with the one-shot limit lowered and a
    small tile, the tiled branch with its exact running merge (the last
    tile is ragged: 1500 = 3 * 384 + 348)."""
    q, _, base, _, _, invalid = _inputs(rng, metric, 1500, D=24)
    valid = invalid < 0.5
    kw = {}
    if tile is not None:
        monkeypatch.setattr(jax_flat, "_SINGLE_SHOT_ELEMS", 0)
        monkeypatch.setattr(port_flat, "_SINGLE_SHOT_ELEMS", 0)
        kw["tile"] = tile
    sq = np.sum(base * base, axis=1).astype(np.float32)
    want = jax_flat.flat_topk(
        jnp.asarray(q), jnp.asarray(base), jnp.asarray(valid), metric, 10,
        jnp.asarray(sq), **kw,
    )
    got = port_flat.flat_topk(_t(q), _t(base), _t(valid), metric, 10, _t(sq), **kw)
    ref = np.where(valid[None, :], distance_np(q, base, metric), np.inf)
    _assert_topk_matches(got, want, ref.astype(np.float32))
    assert not np.isin(got[1].numpy(), np.flatnonzero(~valid)).any()


def test_flat_topk_pads_past_n(rng):
    q, _, base, _, _, _ = _inputs(rng, L2, 6, D=24, deleted=0.0, tail=0)
    valid = np.ones(6, bool)
    valid[2] = False
    want = jax_flat.flat_topk(
        jnp.asarray(q), jnp.asarray(base), jnp.asarray(valid), L2, 9
    )
    got = port_flat.flat_topk(_t(q), _t(base), _t(valid), L2, 9)
    _assert_topk_matches(got, want)
    assert np.all(got[1].numpy()[:, 5:] == -1)
    assert np.all(np.isinf(got[0].numpy()[:, 5:]))


# ---------------------------------------------------------------------------
# a packed key is never NaN (tests/test_pallas_scan.py::TestInfSafety)
# ---------------------------------------------------------------------------


def _rank_scores(q, base, b_sq, invalid):
    dots = q.astype(np.float32) @ base.astype(np.float32).T
    return np.where(invalid[None, :] > 0.5, np.inf, b_sq[None, :] - 2.0 * dots)


def test_overflowed_norm_does_not_poison_lane(rng):
    """A row whose squared norm overflows f32 must not become a NaN key,
    which would latch its lane (JAX) or vanish from it (fminf)."""
    B, D, N = 8, 16, 2 * LANES
    q = rng.standard_normal((B, D)).astype(np.float32)
    base = rng.standard_normal((N, D)).astype(np.float32)
    base[5] = 2.0e19
    with np.errstate(over="ignore"):
        b_sq = np.sum(base**2, axis=1)
    assert np.isinf(b_sq[5])
    keys, rows = port_scan.lane_topk_scan_packed(
        _t(q), _bf16(base), _t(b_sq), torch.zeros(N), L2
    )
    assert bool(torch.isfinite(keys).all())
    want_k, want_r = jax_scan.lane_topk_scan_packed(
        jnp.asarray(q), jnp.asarray(base, jnp.bfloat16), jnp.asarray(b_sq),
        jnp.zeros(N), L2, interpret=True,
    )
    _assert_packed_close(
        keys.numpy(), rows.numpy(), np.asarray(want_k), np.asarray(want_r)
    )
    got, want = _fused_pair(
        (jnp.asarray(q), _t(q)), jnp.asarray(base, jnp.bfloat16), _bf16(base),
        jnp.asarray(base), _t(base), np.ones(N, bool), L2, 5, b_sq, width=32,
    )
    d, i = got[0].numpy(), got[1].numpy()
    assert np.all(np.isfinite(d)) and np.all(i >= 0)
    np.testing.assert_array_equal(i, np.asarray(want[1]))
    sane = _rank_scores(q, base, b_sq, np.zeros(N, np.float32))
    top1 = np.argsort(np.where(np.isfinite(sane), sane, np.inf), axis=1)[:, 0]
    assert all(top1[b] in set(i[b].tolist()) for b in range(B))


def test_int8_overflow_and_nan_scales_do_not_poison(rng):
    """The int8 scan has no clamp of its own: infinite norms, infinite and
    NaN scales and deleted rows are made safe on the [N]-sized arrays."""
    B, D, N = 8, 16, 2 * LANES
    q = rng.standard_normal((B, D)).astype(np.float32)
    base = rng.standard_normal((N, D)).astype(np.float32)
    base[5] = 2.0e19
    with np.errstate(over="ignore"):
        b_sq = np.sum(base**2, axis=1)
    b8, sc = _quant8(base)
    sc[7], sc[9] = np.nan, np.inf
    invalid = np.zeros(N, np.float32)
    invalid[3] = 1.0
    keys, rows = port_scan.lane_topk_scan_packed_int8(
        _t(q), _t(b8), _t(sc), _t(b_sq), _t(invalid), L2, tps=2
    )
    want_k, want_r = jax_scan.lane_topk_scan_packed_int8(
        jnp.asarray(q), jnp.asarray(b8), jnp.asarray(sc), jnp.asarray(b_sq),
        jnp.asarray(invalid), L2, interpret=True, tps=2,
    )
    assert bool(torch.isfinite(keys).all())
    _assert_int8_keys(
        keys.numpy(), rows.numpy(), np.asarray(want_k), np.asarray(want_r), L2
    )
    got, want = _fused_pair(
        (jnp.asarray(q), _t(q)), jnp.asarray(b8), _t(b8), jnp.asarray(base),
        _t(base), invalid < 0.5, L2, 5, b_sq, base_scale=sc, width=32, tps=2,
    )
    d, i = got[0].numpy(), got[1].numpy()
    assert np.all(np.isfinite(d)) and np.all(i >= 0) and not np.any(i == 3)
    np.testing.assert_array_equal(i, np.asarray(want[1]))
    sane = _rank_scores(q, base, b_sq, invalid)
    sane[:, [5, 7, 9]] = np.inf
    top1 = np.argsort(sane, axis=1)[:, 0]
    assert all(top1[b] in set(i[b].tolist()) for b in range(B))


@pytest.mark.parametrize("tps", [4, 8])
def test_int8_premin_groups_keep_recall(rng, tps):
    q, _, base, scan, scan_sq, _ = _inputs(
        rng, L2, 8 * LANES, D=24, deleted=0.0, tail=0
    )
    b8, sc = _quant8(scan)
    d, s = port_flat.flat_topk_fused(
        _t(q), _t(b8), _t(base), torch.ones(8 * LANES, dtype=torch.bool), L2,
        10, _t(scan_sq), base_scale=_t(sc), tps=tps,
    )
    ref = distance_np(q, base, L2).astype(np.float32)
    true_i = np.argsort(ref, axis=1, kind="stable")[:, :10]
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(s.numpy(), true_i))
    assert hits / true_i.size >= 0.95
    for b in range(len(q)):
        np.testing.assert_allclose(d.numpy()[b], ref[b, s.numpy()[b]], **DIST_TOL)


def test_int8_scan_rejects_odd_group_count(rng):
    _, q, _, scan, scan_sq, invalid = _inputs(rng, L2, 6 * LANES)
    b8, sc = _quant8(scan)
    with pytest.raises(ValueError, match="groups"):
        port_scan.lane_topk_scan_packed_int8(
            _t(q), _t(b8), _t(sc), _t(scan_sq), _t(invalid), L2, tps=6
        )
    with pytest.raises(ValueError, match="scales"):
        port_flat.flat_topk_fused(
            _t(q), _t(b8), _t(scan), _t(invalid < 0.5), L2, 5, _t(scan_sq)
        )


@pytest.mark.parametrize("B,groups,want", [
    (1, 1024, 8),      # 16 blocks: eight slices fill 128 of 132 SMs
    (1, 4, 4),         # no more slices than tile groups
    (513, 1024, 3),    # 80 blocks: three slices, two waves of a third each
    (1024, 1024, 1),   # 128 blocks: one wave already
    (4096, 1024, 1),
])
def test_packed_scan_slices(B, groups, want):
    """How the card's packed scans split their tile walk, on 132 SMs."""
    assert port_scan._slices(B, groups, 132) == want


@pytest.mark.parametrize("group", [1, 4])
def test_packed_keys_merge_across_slices(rng, group):
    """The split the card's packed scans make: slices of whole tile groups
    folded apart and their (k1, k2) merged by the same fold give the one
    walk's keys bit for bit, ties included (small-integer rows repeated
    in every tile score the same in all of a lane's tiles)."""
    tiles, D = 16, 8
    rows = rng.integers(-3, 4, (LANES, D)).astype(np.float32)
    base8, scale = port_scan.quantize_rows(_t(np.tile(rows, (tiles, 1))))
    q8, qs2, bs, bsq = port_scan.packed_int8_inputs(
        _t(rng.integers(-3, 4, (3, D)).astype(np.float32)), scale,
        torch.zeros(tiles * LANES), torch.zeros(tiles * LANES), COS,
    )
    one = port_scan.lane_topk_scan_packed_int8_plain(
        q8, qs2, base8, bs, bsq, COS, group
    )
    k1 = torch.full((3, LANES), port_scan._SENTINEL)
    k2 = k1.clone()
    for lo in range(0, tiles * LANES, 4 * group * LANES):
        # a slice of 4 groups, folded on its own with its own tile ids
        part = slice(lo, lo + 4 * group * LANES)
        keys = port_scan.lane_topk_scan_packed_int8_plain(
            q8, qs2, base8[part], bs[part], bsq[part], COS, group
        ).view(torch.int32)
        ids = (keys & port_scan._TILE_MASK) + lo // LANES
        keys = ((keys & ~port_scan._TILE_MASK) | ids).view(torch.float32)
        for k in (keys[:, :LANES], keys[:, LANES:]):
            k1, k2 = port_scan._fold_best_two_packed(k, k1, k2)
    merged = torch.cat([k1, k2], dim=1)
    assert torch.equal(merged.view(torch.int32), one.view(torch.int32))
