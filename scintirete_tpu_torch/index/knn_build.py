"""Bulk graph construction from exact k-NN scans (port of the from-scratch
build of `scintirete_tpu/index/knn_build.py`).

Per layer, members are processed in doubling rounds over ONE shared scan
base ordered by (level desc, random): each round's rows take their top-C
candidates from an exact scan against the prefix built so far (the
`knn_lane_topc` kernel), plus long-range candidates from the first
_ROUND0 rows (the global hubs); then neighbor selection (nearest-M or the
diversity heuristic), the reverse-edge cap on the host (C++), and a final
selection over (forward u incoming). Upper layers use the same exact-kNN
constructor (the JAX package's default `knn` upper mode); layers of at
most HOST_LAYER_MAX members are built in numpy.

What the port leaves out of the JAX module, and why:
- the pow-4 base padding and the two-rung grid ladder: they bounded the
  number of compiled TPU programs. The port pads the base to a multiple of
  LANES and scans exactly the tiles a prefix covers; masked tiles never
  change a lane, so the candidates are the same;
- the packed fixed-arity fetches: a plain `.cpu()` per tile;
- the `SCNT_*` knobs: the port reads no environment and always takes the
  fused bf16 scan;
- the sequential upper-layer mode, NN-descent refinement and the batched
  append: not ported yet (see ROADMAP.md); refinement raises.
"""

from __future__ import annotations

import numpy as np
import torch

from scintirete_tpu_torch.index.store import GraphStore
from scintirete_tpu_torch.ops.lane_scan import LANES, knn_lane_topc
from scintirete_tpu_torch.ops.topk import stable_smallest

# per-node candidate pool from the kNN scan
KNN_CANDIDATES = 64
# below this many vectors a from-scratch build takes the chunked path
MIN_BUILD_SIZE = 2048
_ROUND0 = 128  # first-round prefix size (sparse enough for long-range edges)
_QBLOCK = 2048  # rows scanned per kNN dispatch
# a tiny layer costs more in dispatch latency than the whole O(nm^2) host
# computation
HOST_LAYER_MAX = 1024
# the build's own shuffle stream (same constant as the JAX package, so the
# same seed gives the same base order in both)
_SHUFFLE_SALT = 0x5CA1AB1E

_INF = float("inf")


# ---------------------------------------------------------------------------
# device chains (ports of the JAX `_kernels()` programs)
# ---------------------------------------------------------------------------


def knn_block(q_block, self_idx, base, base_sq, n_valid: int, metric: int,
              c: int):
    """Exact top-c prefix neighbors of each row (self excluded), for the
    hub scan: one [Bq, Np] distance block, as `knn_block` with one tile."""
    from scintirete_tpu_torch.ops.distance import pairwise_distance

    d = pairwise_distance(q_block, base, metric, base_sq)
    idx = torch.arange(base.shape[0], device=d.device)[None, :]
    bad = (idx >= n_valid) | (idx == self_idx[:, None])
    d = torch.where(bad, _INF, d)
    bd, bi = stable_smallest(d, c)
    return bd, torch.where(torch.isinf(bd), -1, bi).to(torch.int32)


def _select_order(cand_i, cand_d, base, metric, max_deg, heuristic):
    """Core of the reference-semantics neighbor selection: (order [B, C],
    keep [B, max_deg]) such that taking a row-aligned payload along
    order[:, :max_deg] and masking with keep reproduces the selection."""
    B, C = cand_i.shape
    valid = cand_i >= 0
    if not heuristic:
        order = torch.arange(C, device=cand_i.device).expand(B, C)
        return order, valid[:, :max_deg]

    c32 = base[cand_i.clamp(min=0).long()].float()  # [B, C, D]
    dots = torch.bmm(c32, c32.transpose(1, 2))
    sq = (c32 * c32).sum(dim=2)  # [B, C]
    if metric == 1:  # L2: compare in squared form
        dcc = sq[:, :, None] + sq[:, None, :] - 2.0 * dots
        dq = cand_d * cand_d  # cand_d is sqrt'ed L2
    elif metric == 2:  # cosine
        denom = torch.sqrt(sq[:, :, None] * sq[:, None, :])
        dcc = 1.0 - torch.clamp(
            torch.where(denom > 1e-30, dots / torch.clamp(denom, min=1e-30), 0.0),
            -1.0, 1.0,
        )
        dq = cand_d
    else:  # inner product (negated dot everywhere)
        dcc = -dots
        dq = cand_d

    sel = torch.zeros((B, C), dtype=torch.bool, device=cand_i.device)
    n_sel = torch.zeros(B, dtype=torch.int64, device=cand_i.device)
    for c in range(C):
        dmin = torch.where(sel, dcc[:, c, :], _INF).amin(dim=1)
        ok = valid[:, c] & (n_sel < max_deg) & (dq[:, c] < dmin)
        sel[:, c] = ok
        n_sel += ok
    # selected first (distance order), then pruned fill (distance order);
    # the sort must be stable
    fill_key = (~sel & valid).int() + 2 * (~valid).int()
    order = torch.argsort(fill_key, dim=1, stable=True)
    out_key = fill_key.gather(1, order)[:, :max_deg]
    return order, out_key < 2


def select_block(cand_i, cand_d, base, metric: int, max_deg: int,
                 heuristic: bool):
    """Per-node neighbor selection (reference semantics, batched)."""
    order, keep = _select_order(cand_i, cand_d, base, metric, max_deg, heuristic)
    out_i = cand_i.gather(1, order)[:, :max_deg]
    out_d = cand_d.gather(1, order)[:, :max_deg]
    return torch.where(keep, out_i, -1), torch.where(keep, out_d, _INF)


def merge_dedupe(fwd_i, fwd_d, inc_i, inc_d):
    """(forward u incoming) per row: dedupe, sorted by distance asc. Both
    sorts are stable: the first keeps a row's forward copy of an id ahead
    of its incoming copy, the second keeps equal distances in id order."""
    all_i = torch.cat([fwd_i, inc_i], dim=1)
    all_d = torch.cat([fwd_d, inc_d], dim=1)
    key_i = torch.where(all_i >= 0, all_i, 2**30)
    si, o = torch.sort(key_i, dim=1, stable=True)
    sd = all_d.gather(1, o)
    dup = torch.cat(
        [torch.zeros_like(si[:, :1], dtype=torch.bool), si[:, 1:] == si[:, :-1]],
        dim=1,
    )
    sd = torch.where(dup | (si >= 2**30), _INF, sd)
    sd, o = torch.sort(sd, dim=1, stable=True)
    si = si.gather(1, o)
    return torch.where(torch.isinf(sd), -1, si).to(torch.int32), sd


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------


def _incoming_host(fwd_i: np.ndarray, fwd_d: np.ndarray, max_deg: int):
    """Reverse edges capped at the nearest max_deg per target (host).

    For every forward edge u->v, u becomes an incoming candidate of v; an
    edge farther than max_deg nearer incoming edges can never survive the
    final prune. The C++ counting-bucket capper of the JAX package
    (native/link_apply.cpp incoming_cap) does it when it builds; the numpy
    packed-key argsort below is the same cap otherwise."""
    from scintirete_tpu.native.build import incoming_cap_native

    native = incoming_cap_native(fwd_i, fwd_d, max_deg)
    if native is not None:
        return native
    nm, F = fwd_i.shape
    src = np.repeat(np.arange(nm, dtype=np.int32), F)
    dst = fwd_i.reshape(-1)
    d = fwd_d.reshape(-1)
    valid = dst >= 0
    src, dst, d = src[valid], dst[valid], d[valid]
    inc_i = np.full((nm, max_deg), -1, np.int32)
    inc_d = np.full((nm, max_deg), np.inf, np.float32)
    if len(dst) == 0:
        return inc_i, inc_d
    # key = target << 32 | order-preserving uint32 image of the distance
    bits = d.astype(np.float32).view(np.uint32)
    mono = np.where(
        bits & 0x80000000, ~bits, bits | np.uint32(0x80000000)
    ).astype(np.uint64)
    key = (dst.astype(np.uint64) << np.uint64(32)) | mono
    order = np.argsort(key)
    dst, src, d = dst[order], src[order], d[order]
    E = len(dst)
    iota = np.arange(E)
    new_grp = np.empty(E, bool)
    new_grp[0] = True
    new_grp[1:] = dst[1:] != dst[:-1]
    grp_start = np.maximum.accumulate(np.where(new_grp, iota, 0))
    pos = iota - grp_start
    keep = pos < max_deg
    inc_i[dst[keep], pos[keep]] = src[keep]
    inc_d[dst[keep], pos[keep]] = d[keep]
    return inc_i, inc_d


def _make_build_ctx(vectors: np.ndarray, metric: int, device) -> dict:
    """Upload the ONE shared scan base a bulk build uses for every layer.

    The base holds all n vectors ordered by (level desc, random): levels are
    i.i.d., so every layer's member set is a PREFIX of this base and one
    upload serves the scans and selections of every layer. Cosine rows are
    pre-normalized (scan form); the scan runs on their bf16 image."""
    n, dim = vectors.shape
    if metric == 2:
        norms = np.linalg.norm(vectors, axis=1, keepdims=True)
        vectors = np.where(
            norms > 1e-30, vectors / np.maximum(norms, 1e-30), 0.0
        ).astype(np.float32)
    npad = -(-max(n, 1) // LANES) * LANES
    bpad = np.zeros((npad, dim), np.float32)
    bpad[:n] = vectors
    base = torch.from_numpy(bpad).to(device).to(torch.bfloat16)
    base_sq = torch.from_numpy(np.sum(bpad * bpad, axis=1)).to(device)
    sparse = min(_ROUND0, n)
    sp = np.zeros((_ROUND0 * 2, dim), np.float32)
    sp[:sparse] = vectors[:sparse]
    return {
        "n": n,
        "npad": npad,
        "metric": metric,
        "device": device,
        "base": base,
        "base_sq": base_sq,
        "sparse": sparse,
        "sp_base": torch.from_numpy(sp).to(device).to(torch.bfloat16),
        "sp_sq": torch.from_numpy(np.sum(sp * sp, axis=1)).to(device),
        "ns": min(24, max(sparse - 1, 1)),
    }


def _grid_for(prefix: int) -> int:
    """Tiles of LANES base rows that cover a prefix. The JAX package rounds
    this up to one of two rungs (a sixteenth of the base, or all of it) to
    bound its compiled programs; the extra tiles are fully masked and never
    change a lane, so the exact count gives the same candidates."""
    return -(-prefix // LANES)


def _select_host(cand_i, cand_d, member_vecs, metric, max_deg, heuristic):
    """Host mirror of select_block for one node (tiny layers)."""
    valid = cand_i >= 0
    ci, cd = cand_i[valid], cand_d[valid]
    if not heuristic or len(ci) <= max_deg:
        return ci[:max_deg]
    from scintirete_tpu_torch.ops.distance import distance_np

    selected: list[int] = []
    pruned: list[int] = []
    for idx, d in zip(ci, cd):
        if len(selected) == max_deg:
            break
        if selected:
            ds = distance_np(
                member_vecs[idx], member_vecs[np.asarray(selected)], metric
            )
            if (ds <= d).any():
                pruned.append(int(idx))
                continue
        selected.append(int(idx))
    for idx in pruned:
        if len(selected) == max_deg:
            break
        selected.append(idx)
    return np.asarray(selected[:max_deg], np.int32)


def _build_layer_host(
    member_vecs: np.ndarray, metric: int, max_deg: int,
    n_candidates: int, heuristic: bool,
) -> np.ndarray:
    """Pure-numpy layer build for tiny layers (same phases as the device)."""
    from scintirete_tpu_torch.ops.distance import distance_np

    nm = len(member_vecs)
    c = min(n_candidates + 24, nm - 1)
    d = distance_np(member_vecs, member_vecs, metric)
    np.fill_diagonal(d, np.inf)
    order = np.argsort(d, axis=1, kind="stable")[:, :c]
    cand_d = np.take_along_axis(d, order, axis=1)
    fwd = np.full((nm, max_deg), -1, np.int32)
    for i in range(nm):
        sel = _select_host(
            order[i].astype(np.int32), cand_d[i], member_vecs, metric,
            max_deg, heuristic,
        )
        fwd[i, : len(sel)] = sel
    # reverse edges + final selection over (forward u incoming)
    incoming: dict[int, list[int]] = {i: [] for i in range(nm)}
    for u in range(nm):
        for v in fwd[u]:
            if v >= 0:
                incoming[int(v)].append(u)
    out = np.full((nm, max_deg), -1, np.int32)
    for i in range(nm):
        cands = [v for v in fwd[i] if v >= 0] + incoming[i]
        cands = list(dict.fromkeys(cands))  # dedupe, keep order
        cd = d[i, cands] if cands else np.empty(0, np.float32)
        o = np.argsort(cd, kind="stable")
        ci = np.asarray(cands, np.int32)[o]
        sel = _select_host(ci, cd[o], member_vecs, metric, max_deg, heuristic)
        out[i, : len(sel)] = sel
    return out


def _query_tiles(ctx: dict, nm: int):
    """Yield (qs, qe, prefix): the doubling-round query tiles for base rows
    [0, nm). Row i scans the prefix containing its own round (early rows
    see a sparse sample -> long-range edges, which keeps the graph
    routable)."""
    start, prefix = 0, min(ctx["sparse"], nm)
    while start < nm:
        stop = prefix
        for qs in range(start, stop, _QBLOCK):
            yield qs, min(qs + _QBLOCK, stop), prefix
        start = stop
        prefix = min(prefix * 2, nm)


def _to_host(tiles, out_i: np.ndarray, out_d: np.ndarray) -> None:
    """Copy per-tile device results [(qs, qe, ci, cd)] into host tables.
    Results may be NARROWER than the table (selection width is capped by
    the candidate pool); missing columns keep their -1/inf fill."""
    for qs, qe, ci, cd in tiles:
        w = min(ci.shape[1], out_i.shape[1])
        out_i[qs:qe, :w] = ci[:, :w].cpu().numpy()
        out_d[qs:qe, :w] = cd[:, :w].cpu().numpy()


def _layer_adj(ctx, nm, max_deg, heuristic):
    """Adjacency [nm, max_deg] for base rows [0, nm) (-1 padded): per query
    tile, scan -> hub merge -> forward selection on the device; the
    reverse-edge cap on the host; then merge-with-incoming -> final
    selection on the device."""
    c = min(KNN_CANDIDATES, nm - 1)
    do_sparse = ctx["sparse"] < nm
    metric, dev = ctx["metric"], ctx["device"]

    # ---- pass 1: scan rounds -> merge hub candidates -> forward select
    fwd_i = np.full((nm, max_deg), -1, np.int32)
    fwd_d = np.full((nm, max_deg), np.inf, np.float32)
    dev_fwd = []  # per-tile device selections, kept resident for pass 2
    for qs, qe, prefix in _query_tiles(ctx, nm):
        qb = ctx["base"][qs:qe]
        si = torch.arange(qs, qe, dtype=torch.int32, device=dev)
        cd, ci = knn_lane_topc(
            qb, si, ctx["base"], ctx["base_sq"], prefix, metric=metric, c=c,
            grid_tiles=_grid_for(prefix), q_sq=ctx["base_sq"][qs:qe],
        )
        if do_sparse:
            # long-range candidates from the _ROUND0 global hubs (hub rows
            # are members of every device-built layer: nm > HOST_LAYER_MAX
            # >= _ROUND0)
            scd, sci = knn_block(
                qb, si, ctx["sp_base"], ctx["sp_sq"], ctx["sparse"],
                metric=metric, c=ctx["ns"],
            )
            ci, cd = merge_dedupe(ci, cd, sci, scd)
        sel_i, sel_d = select_block(
            ci, cd, ctx["base"], metric=metric, max_deg=max_deg,
            heuristic=heuristic,
        )
        dev_fwd.append((qs, qe, sel_i, sel_d))
    _to_host(dev_fwd, fwd_i, fwd_d)

    # ---- reverse-edge cap (C++ / numpy)
    inc_i, inc_d = _incoming_host(fwd_i, fwd_d, max_deg)

    # ---- pass 2: merge device-resident forward with incoming -> final
    out = np.full((nm, max_deg), -1, np.int32)
    out_d = np.full((nm, max_deg), np.inf, np.float32)
    final = []
    for qs, qe, sel_i, sel_d in dev_fwd:
        mi, md = merge_dedupe(
            sel_i, sel_d,
            torch.from_numpy(inc_i[qs:qe]).to(dev),
            torch.from_numpy(inc_d[qs:qe]).to(dev),
        )
        fi, fd = select_block(
            mi, md, ctx["base"], metric=metric, max_deg=max_deg,
            heuristic=heuristic,
        )
        final.append((qs, qe, fi, fd))
    _to_host(final, out, out_d)
    return out


def build(store: GraphStore, vectors: np.ndarray, device) -> list[int]:
    """From-scratch bulk build on `device`. The store must be empty."""
    if int(getattr(store.params, "refine_rounds", 0) or 0) > 0:
        raise NotImplementedError(
            "refine_rounds > 0 (NN-descent refinement) is not ported yet: "
            "ROADMAP.md Queue 1, knn_build.append_batch item"
        )
    if store.count != 0:
        raise ValueError("knn_build.build requires an empty store")
    vectors = np.asarray(vectors, np.float32)
    n = len(vectors)
    levels = store.draw_levels(n)
    store.reserve(levels)
    slots = store.alloc_slots(vectors, levels.astype(np.int32))
    metric = int(store.metric)
    heuristic0 = bool(store.params.neighbor_heuristic)
    shuffle_rng = np.random.default_rng(store.seed ^ _SHUFFLE_SALT)
    max_level = int(levels.max(initial=0))

    # ONE base order for every layer: level desc, random within level, so
    # layer l's members are exactly base rows [0, nm_l)
    order = np.lexsort((shuffle_rng.random(n), -levels.astype(np.int64)))
    ctx = _make_build_ctx(vectors[order], metric, device)

    for l in range(max_level + 1):
        nm = int(np.count_nonzero(levels >= l))
        max_deg = store.m0 if l == 0 else store.m
        heuristic = heuristic0 if l == 0 else True
        members = order[:nm]  # member slots of this layer, base order
        if nm <= 1:
            adj = np.full((nm, max_deg), -1, np.int32)
        elif nm <= HOST_LAYER_MAX:
            n_cand = KNN_CANDIDATES if l == 0 else min(KNN_CANDIDATES, 4 * store.m)
            adj = _build_layer_host(
                vectors[members], metric, max_deg, n_cand, heuristic,
            )
        else:
            adj = _layer_adj(ctx, nm, max_deg, heuristic)
        mapped = np.where(adj >= 0, members[np.maximum(adj, 0)], -1).astype(
            np.int32
        )
        if l == 0:
            store.neighbors0[members] = mapped
        else:
            ls = store.layers[l - 1]
            rows = ls.row_of[members]
            ls.nbrs[rows] = mapped[:, : store.m]

    store.max_layer = max_level
    store.entry_slot = int(order[0]) if n else -1
    store.invalidate_dirty()  # adjacency written in place: full upload next
    store.version += 1
    store.linked_count = max(store.linked_count, store.count)
    return [int(s) for s in slots]
