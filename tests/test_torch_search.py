"""The port's pivot and descent searches against the JAX package's, on one
JAX-built graph.

The JAX package builds a graph of 5000 vectors (enough for a 512-pivot
sample, which its Pallas pivot scan needs); the graph crosses to the port
through export_graph_state / import_graph_state. For each metric both
packages search the same graph: the JAX side runs `_search_kernel_pivot`
with the Pallas scan in interpret mode, the port runs `search_batch` on the
CPU. The four descent modes (pure greedy walk, pure beam of ef_upper = 4,
mid-layer entry then greedy, mid-layer entry then beam 4) are held the
same way, with a mid-layer cap of 256 members so that the mid layer sits
at level 2 or above: the JAX side through `DeviceIndex.search` under its
own `SCNT_*` knobs, the port through the arguments that replace them
(its mid cap through the module constant `device.MID_CAP`).
Slots must be equal on every query whose reference top-k has no near-tie,
with distances within rtol = atol = 1e-5 (f32 sums in another order; L2:
squared distances within 1e-5 of their scale); the same holds after
tombstoning 5% of the ids, which exercises the mirror's dirty-row sync.
The beam's guard tests close the file.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from scintirete_tpu.index import HNSWIndex as JaxHNSWIndex
from scintirete_tpu.index.device import DeviceIndex as JaxDeviceIndex
from scintirete_tpu.index.device import _search_kernel_pivot as jax_search
from scintirete_tpu.index.device import mid_layer_host as jax_mid_layer_host
from scintirete_tpu.types import DistanceMetric, HNSWParams, SearchParams
from scintirete_tpu_torch.index import device as port_device
from scintirete_tpu_torch.index.hnsw import HNSWIndex

N, D, NQ, K, EF = 5000, 16, 64, 10, 32
METRICS = [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT]
MID_CAP = 256
# (ef_upper, descent_mid): the four descent modes
MODES = {"greedy": (1, False), "beam4": (4, False),
         "mid_greedy": (1, True), "mid_beam4": (4, True)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((50, D)).astype(np.float32) * 2.0
    base = (centers[rng.integers(0, 50, N)]
            + 0.4 * rng.standard_normal((N, D))).astype(np.float32)
    queries = (base[rng.integers(0, N, NQ)]
               + 0.2 * rng.standard_normal((NQ, D))).astype(np.float32)
    queries[5] = 0.0  # zero query: cosine distance 1 to everything
    return base, queries


@pytest.fixture(scope="module")
def jax_state(data):
    base, _ = data
    with pytest.MonkeyPatch.context() as mp:
        # the fused bf16 build (Pallas lane scan in interpret mode): the
        # path the port always takes, and the quickest JAX build on a CPU
        mp.setenv("SCNT_BUILD_INTERPRET", "1")
        mp.setenv("SCNT_BUILD_SCAN_DTYPE", "bfloat16")
        return _jax_build(base)


def _jax_build(base):
    idx = JaxHNSWIndex(
        D, HNSWParams(m=8, ef_construction=64, ef_search=EF, seed=3,
                      neighbor_heuristic=True),
        DistanceMetric.COSINE,
    )
    idx.bulk_insert(list(range(1, N + 1)), base)
    return idx.export_graph_state()


def _with_metric(state, metric):
    s = dict(state)
    s["metric"] = int(metric)
    return s


def _jax_slots(jidx, queries, metric):
    dev = JaxDeviceIndex()
    dev.sync(jidx.store)
    a = dev.graph.arrays
    d, s, _ = jax_search(
        jnp.asarray(queries), a["vectors"], a["sq_norms"], a["deleted"],
        a["neighbors0"], a["pivots"], a["pivot_vecs"], a["pivot_sq"],
        metric=int(metric), ef=EF, k=K, max_steps=EF + 64,
        use_pallas=True, interpret=True,
    )
    return np.asarray(s), np.asarray(d)


def _untied(d, rel=1e-5):
    d = np.asarray(d, np.float64)
    gap = np.diff(d, axis=1)
    fin = np.isfinite(d[:, 1:])
    return np.all(~fin | (gap > rel * np.maximum(1.0, np.abs(d[:, 1:]))), axis=1)


def _jax_descent(jidx, queries, mode, monkeypatch):
    ef_upper, mid = MODES[mode]
    monkeypatch.setenv("SCNT_DESCENT_MID_CAP", str(MID_CAP))
    monkeypatch.setenv("SCNT_SEARCH_EF_UPPER", str(ef_upper))
    monkeypatch.setenv("SCNT_DESCENT_MID", "1" if mid else "0")
    return JaxDeviceIndex().search(jidx.store, queries, K, EF,
                                   entry_mode="descent")


def _assert_same(port, jidx, queries, metric, mode=None, monkeypatch=None):
    """The port's slots and distances against JAX's: pivot mode, or the
    descent `mode` (the index's own arguments then select it)."""
    if mode is None:
        want_s, want_d = _jax_slots(jidx, queries, metric)
    else:
        want_s, want_d = _jax_descent(jidx, queries, mode, monkeypatch)
        port.entry_mode = "descent"
        port.ef_upper, port.descent_mid = MODES[mode]
    got_s, got_d = port._get_device().search(
        port.store, queries, K, EF, entry_mode=port.entry_mode,
        ef_upper=port.ef_upper, descent_mid=port.descent_mid,
    )
    rows = _untied(want_d)
    assert rows.mean() >= 0.9
    np.testing.assert_array_equal(got_s[rows], want_s[rows])
    if metric == DistanceMetric.L2:
        # sqrt amplifies the f32 sum-order error of q^2 + v^2 - 2 dot where
        # the norms cancel: compare squared distances, 1e-5 relative to them
        scale = np.sum(queries * queries, axis=1)[:, None] + np.max(
            np.sum(port.store.vectors**2, axis=1))
        err = np.abs(got_d**2 - want_d**2)[rows]
        assert np.all(err <= 1e-5 * np.broadcast_to(scale, got_d.shape)[rows])
    else:
        np.testing.assert_allclose(got_d[rows], want_d[rows], rtol=1e-5, atol=1e-5)
    # the public surface returns the same hits, as ids
    res = port.search_batch(queries, SearchParams(top_k=K, ef_search=EF))
    ids = [[vid for vid, _ in r] for r in res]
    for i in np.flatnonzero(rows):
        assert ids[i] == [int(v) for v in port.slot_to_id[want_s[i][want_s[i] >= 0]]]
    return res


@pytest.mark.parametrize("metric", METRICS)
def test_pivot_search_matches_jax_before_and_after_tombstones(
    data, jax_state, metric
):
    base, queries = data
    state = _with_metric(jax_state, metric)
    port = HNSWIndex.import_graph_state(state, device="cpu")
    jidx = JaxHNSWIndex.import_graph_state(state)
    _assert_same(port, jidx, queries, metric)
    mirror = port._get_device().graph

    rng = np.random.default_rng(int(metric))
    gone = [int(v) for v in rng.choice(N, N // 20, replace=False) + 1]
    for vid in gone:
        assert port.delete(vid)
        jidx.delete(vid)
    full_uploads = []
    real_full = mirror._full_upload
    mirror._full_upload = lambda store: (full_uploads.append(1), real_full(store))
    res = _assert_same(port, jidx, queries, metric)
    assert not full_uploads, "a tombstone must sync by dirty-row scatter"
    dead = set(gone)
    assert not any(vid in dead for r in res for vid, _ in r)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("metric", METRICS)
def test_descent_matches_jax_before_and_after_tombstones(
    data, jax_state, metric, mode, monkeypatch
):
    _, queries = data
    state = _with_metric(jax_state, metric)
    monkeypatch.setattr(port_device, "MID_CAP", MID_CAP)
    port = HNSWIndex.import_graph_state(state, device="cpu")
    jidx = JaxHNSWIndex.import_graph_state(state)
    _assert_same(port, jidx, queries, metric, mode, monkeypatch)
    graph = port._get_device().graph
    monkeypatch.setenv("SCNT_DESCENT_MID_CAP", str(MID_CAP))
    want_mid = jax_mid_layer_host(jidx.store)
    assert want_mid["mid_level"] >= 2
    members = want_mid["mid_slots"][want_mid["mid_slots"] >= 0]
    if MODES[mode][1]:
        assert graph.mid_level == want_mid["mid_level"]
        np.testing.assert_array_equal(graph.arrays["mid_slots"].numpy(),
                                      members)
    else:  # the pure walk never builds the mid table
        assert "mid_slots" not in graph.arrays and graph.mid_level == 0

    rng = np.random.default_rng(int(metric))
    # some of the mid layer's own members die, so its scan masks them
    gone = {int(v) for v in rng.choice(N, N // 20, replace=False) + 1}
    gone |= {int(s) + 1 for s in members[:8]}
    for vid in sorted(gone):
        assert port.delete(vid)
        jidx.delete(vid)
    full_uploads = []
    real_full = graph._full_upload
    graph._full_upload = lambda store: (full_uploads.append(1), real_full(store))
    res = _assert_same(port, jidx, queries, metric, mode, monkeypatch)
    assert not full_uploads, "a tombstone must sync by dirty-row scatter"
    assert not any(vid in gone for r in res for vid, _ in r)


def test_arrays_and_submit_collect_agree_with_search_batch(data, jax_state):
    _, queries = data
    port = HNSWIndex.import_graph_state(jax_state, device="cpu",
                                        search_batch_size=16)
    sp = SearchParams(top_k=K, ef_search=EF)
    want = port.search_batch(queries, sp)
    ids, dists = port.search_batch_arrays(queries, sp)
    assert ids.shape == (NQ, K) and ids.dtype == np.uint64
    for i, r in enumerate(want):
        assert [vid for vid, _ in r] == ids[i].tolist()
        np.testing.assert_array_equal([d for _, d in r], dists[i])
    assert port.search_collect(port.search_submit(queries, sp)) == want
    piped = port.search_batch_pipelined([queries[:20], queries[20:]], sp)
    assert piped[0] + piped[1] == want
    # the zero query's cosine distances are all 1
    assert all(d == 1.0 for _, d in want[5])


def test_graph_state_round_trips_through_the_port(jax_state):
    port = HNSWIndex.import_graph_state(jax_state, device="cpu")
    out = port.export_graph_state()
    assert out.keys() == jax_state.keys()
    for key, val in jax_state.items():
        if isinstance(val, np.ndarray):
            assert out[key].dtype == val.dtype
            np.testing.assert_array_equal(out[key], val)
    for lo, li in zip(out["layers"], jax_state["layers"]):
        np.testing.assert_array_equal(lo["nbrs"], li["nbrs"])
        np.testing.assert_array_equal(lo["node_slot"], li["node_slot"])


def test_beam_step_dedups_despite_entry_distance_mismatch():
    """tests/test_hnsw.py's TestBeamStepDedup on the port's _beam_step: an
    entry distance 1e-3 off the beam's own (the pivot or mid scan computes
    it apart from dist_to) must not let a re-proposed slot survive twice,
    and the surviving copy keeps its expanded flag."""
    import torch

    from scintirete_tpu_torch.index.device import _beam_step

    # true distances: slot0=1.0, slot2=1.0005 (between the two slot-0
    # copies under a distance-major sort), slot1=2.0
    xs = torch.tensor([1.0, 2.0, 1.0005, 4.0, 5.0, 6.0, 7.0, 8.0])
    deleted = torch.zeros(8, dtype=torch.bool)
    # slot 0 <-> slot 1 mutual neighbors: expanding 1 re-proposes 0
    neighbors0 = torch.tensor([[1, -1], [0, 2]] + [[-1, -1]] * 6)
    cand_s = torch.tensor([[0, -1, -1, -1]])
    cand_d = torch.tensor([[1.001, np.inf, np.inf, np.inf]])  # perturbed
    expanded = torch.zeros((1, 4), dtype=torch.bool)
    active = torch.ones(1, dtype=torch.bool)
    for _ in range(2):  # step 1: expand 0 -> propose 1; step 2: 1 -> 0, 2
        cand_s, cand_d, expanded = _beam_step(
            lambda slots: xs[slots], deleted, cand_s, cand_d, expanded,
            rows_of_slots=lambda s: s, nbr_lookup=lambda r: neighbors0[r],
            active=active, expand=1,
        )
    s, e = cand_s[0].numpy(), expanded[0].numpy()
    live = s[s >= 0]
    assert len(set(live.tolist())) == len(live), f"duplicate slots: {s}"
    assert set(live.tolist()) == {0, 1, 2}
    assert all(e[i] for i in range(len(s)) if s[i] in (0, 1)), (s, e)


@pytest.mark.parametrize("beam", ["layer0", "descent"])
def test_beam_lists_stay_sorted_and_monotone(data, jax_state, beam,
                                             monkeypatch):
    """The property that lets the beams run without a visited set: over
    every step of _ef_beam_layer0 and of _fused_beam_descent_lists, each
    query's list stays sorted, holds no slot twice, and its ef-th distance
    never rises (an item enters only by beating the worst)."""
    import torch

    from scintirete_tpu_torch.index import device as dmod

    _, queries = data
    port = HNSWIndex.import_graph_state(jax_state, device="cpu")
    dev = port._get_device()
    dev.sync(port.store)
    a = dev.graph.arrays
    seen = []
    real_step = dmod._beam_step

    def spy(*args, **kw):
        out = real_step(*args, **kw)
        seen.append((out[0].clone(), out[1].clone()))
        return out

    monkeypatch.setattr(dmod, "_beam_step", spy)
    q = torch.from_numpy(queries)
    dist_to = dmod._make_dist_fn(q, a["vectors"], a["sq_norms"],
                                 int(port.store.metric))
    entry, level = dev._entry_info(port.store)
    B = q.shape[0]
    cur = torch.full((B, 1), entry, dtype=torch.int64)
    if beam == "layer0":
        dmod._ef_beam_layer0(dist_to, a["neighbors0"], a["deleted"], cur,
                             dist_to(cur), EF, EF + 64)
    else:
        ent_s = torch.cat([cur, torch.full((B, 7), -1)], dim=1)
        ent_d = torch.cat([dist_to(cur), torch.full((B, 7), np.inf)], dim=1)
        dmod._fused_beam_descent_lists(
            dist_to, dmod._flat_row_of(a["up_rows_flat"], a["vectors"].shape[0]),
            a["up_nbrs_cat"], a["deleted"], ent_s, ent_d,
            torch.full((B,), level, dtype=torch.int64), max_iters=1024,
            expand=4,
        )
    assert len(seen) > 3
    worst = None
    for slots, dists in seen:
        d = dists.numpy()
        assert np.all(d[:, 1:] >= d[:, :-1]), "a list is out of order"
        for row in slots.numpy():
            live = row[row >= 0]
            assert len(set(live.tolist())) == len(live)
        if worst is not None:
            assert np.all(d[:, -1] <= worst), "an ef-th distance rose"
        worst = d[:, -1]
