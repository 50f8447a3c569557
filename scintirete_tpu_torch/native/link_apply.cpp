// Native link-application engine for the chunked HNSW builder.
//
// A copy of scintirete_tpu/native/link_apply.cpp, built and loaded by the
// port's own native/build.py.
//
// The device kernel returns, per new vector and per layer, the efc best
// candidates against the frozen graph (see index/device.py). This module
// applies the links host-side in chunk order — candidate merge with earlier
// chunk members, top-M selection, bidirectional linking, and degree pruning
// (reference semantics: internal/core/algorithm/hnsw.go:224-249 insert
// linking, :560-583 simple selectNeighbors, :586-614 pruneConnections).
//
// Compiled with g++ -O3 and loaded through ctypes (build.py); the Python
// implementation in index/bulk.py stays as the fallback and oracle.
//
// Layout contract (matches index/store.py):
//   vectors     f32[cap, dim]        row-major
//   neighbors0  i32[cap, m0]         -1 padded
//   layer l>=1: nbrs i32[cap_l, m]   -1 padded, entries are node slots
//               row_of i32[cap]      node slot -> layer row, -1 absent
//   deleted     u8[cap]
//
// Dirty rows touched by this call are appended to dirty_out as
// (layer, row) pairs: layer 0 rows index neighbors0, layer l rows index
// that layer's nbrs table. The caller feeds them to the device mirror.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <algorithm>
#include <utility>
#include <vector>

namespace {

enum Metric { L2 = 1, COSINE = 2, INNER_PRODUCT = 3 };

struct Ctx {
    const float* vectors;
    int64_t cap;
    int64_t dim;
    int32_t* neighbors0;
    int32_t m0;
    int32_t n_layers;        // number of allocated upper layers
    int32_t** layer_nbrs;    // per layer: [cap_l, m]
    int32_t** layer_rowof;   // per layer: [cap]
    int32_t m;
    const uint8_t* deleted;
    int32_t metric;
    bool heuristic;          // diversity-aware neighbor selection
    int32_t* dirty_out;      // [max_dirty, 2] (layer, row)
    int64_t max_dirty;
    int64_t n_dirty;
    bool dirty_overflow;
};

// Diversity heuristic selection over distance-sorted candidates (relative
// to some query point `q_slot_dist` already encoded in the pair distances):
// keep a candidate only if it is closer to the query than to every kept
// neighbor; fill remaining slots from the pruned set. `items` must be
// sorted ascending. Writes at most max_conn entries into `out`.
size_t select_diverse(const Ctx& c,
                      const std::vector<std::pair<float, int32_t>>& items,
                      int32_t max_conn, int32_t* out);

inline float sq_norm(const Ctx& c, int64_t a) {
    const float* __restrict va = c.vectors + a * c.dim;
    float n0 = 0, n1 = 0;
    int64_t i = 0;
    for (; i + 2 <= c.dim; i += 2) {
        n0 += va[i] * va[i];
        n1 += va[i + 1] * va[i + 1];
    }
    for (; i < c.dim; ++i) n0 += va[i] * va[i];
    return n0 + n1;
}

// distance with the anchor's squared norm precomputed (prune/selection call
// this ~30x per anchor; recomputing na each time wastes a third of the MACs)
inline float distance_anchored(const Ctx& c, int64_t a, float na, int64_t b) {
    const float* __restrict va = c.vectors + a * c.dim;
    const float* __restrict vb = c.vectors + b * c.dim;
    float dot0 = 0, dot1 = 0, nb0 = 0, nb1 = 0;
    int64_t i = 0;
    for (; i + 2 <= c.dim; i += 2) {
        dot0 += va[i] * vb[i];
        dot1 += va[i + 1] * vb[i + 1];
        nb0 += vb[i] * vb[i];
        nb1 += vb[i + 1] * vb[i + 1];
    }
    for (; i < c.dim; ++i) {
        dot0 += va[i] * vb[i];
        nb0 += vb[i] * vb[i];
    }
    const float dot = dot0 + dot1, nb = nb0 + nb1;
    switch (c.metric) {
        case L2: {
            const float d2 = na + nb - 2.0f * dot;
            return std::sqrt(d2 > 0.0f ? d2 : 0.0f);
        }
        case COSINE: {
            if (na <= 1e-30f || nb <= 1e-30f) return 1.0f;
            float cosv = dot / (std::sqrt(na) * std::sqrt(nb));
            cosv = std::min(1.0f, std::max(-1.0f, cosv));
            return 1.0f - cosv;
        }
        default:
            return -dot;
    }
}

inline float distance(const Ctx& c, int64_t a, int64_t b) {
    const float* __restrict va = c.vectors + a * c.dim;
    const float* __restrict vb = c.vectors + b * c.dim;
    // four float accumulators -> the compiler vectorizes this loop
    // (a double accumulator would serialize it)
    float dot0 = 0, dot1 = 0, na0 = 0, na1 = 0, nb0 = 0, nb1 = 0;
    int64_t i = 0;
    for (; i + 2 <= c.dim; i += 2) {
        dot0 += va[i] * vb[i];
        dot1 += va[i + 1] * vb[i + 1];
        na0 += va[i] * va[i];
        na1 += va[i + 1] * va[i + 1];
        nb0 += vb[i] * vb[i];
        nb1 += vb[i + 1] * vb[i + 1];
    }
    for (; i < c.dim; ++i) {
        dot0 += va[i] * vb[i];
        na0 += va[i] * va[i];
        nb0 += vb[i] * vb[i];
    }
    const float dot = dot0 + dot1, na = na0 + na1, nb = nb0 + nb1;
    switch (c.metric) {
        case L2: {
            const float d2 = na + nb - 2.0f * dot;
            return std::sqrt(d2 > 0.0f ? d2 : 0.0f);
        }
        case COSINE: {
            if (na <= 1e-30f || nb <= 1e-30f) return 1.0f;
            float cosv = dot / (std::sqrt(na) * std::sqrt(nb));
            cosv = std::min(1.0f, std::max(-1.0f, cosv));
            return 1.0f - cosv;
        }
        default:
            return -dot;
    }
}

// the diversity heuristic scans at most this many sorted candidates before
// topping up from the pruned set — bounds the O(scan x kept) distance work
// with negligible quality impact (the tail would be fill anyway)
constexpr int32_t kHeuristicScanCap = 128;

size_t select_diverse(const Ctx& c,
                      const std::vector<std::pair<float, int32_t>>& items,
                      int32_t max_conn, int32_t* out) {
    size_t n_sel = 0;
    std::vector<int32_t> pruned;
    size_t scanned = 0;
    size_t fill_from = items.size();
    for (size_t idx = 0; idx < items.size(); ++idx) {
        const auto& [d, slot] = items[idx];
        if (n_sel == static_cast<size_t>(max_conn) ||
            scanned >= static_cast<size_t>(kHeuristicScanCap)) {
            fill_from = idx;
            break;
        }
        ++scanned;
        bool keep = true;
        const float slot_norm = n_sel ? sq_norm(c, slot) : 0.0f;
        for (size_t j = 0; j < n_sel; ++j) {
            if (distance_anchored(c, slot, slot_norm, out[j]) <= d) {
                keep = false;
                break;
            }
        }
        if (keep) {
            out[n_sel++] = slot;
        } else {
            pruned.push_back(slot);
        }
    }
    for (const int32_t slot : pruned) {  // keepPrunedConnections fill
        if (n_sel == static_cast<size_t>(max_conn)) break;
        out[n_sel++] = slot;
    }
    for (size_t idx = fill_from;
         idx < items.size() && n_sel < static_cast<size_t>(max_conn); ++idx) {
        out[n_sel++] = items[idx].second;
    }
    return n_sel;
}

inline void mark_dirty(Ctx& c, int32_t layer, int32_t row) {
    if (c.n_dirty >= c.max_dirty) {
        c.dirty_overflow = true;
        return;
    }
    c.dirty_out[2 * c.n_dirty] = layer;
    c.dirty_out[2 * c.n_dirty + 1] = row;
    ++c.n_dirty;
}

// adjacency row pointer for (slot, layer); nullptr if not a member
inline int32_t* adj_row(Ctx& c, int64_t slot, int32_t layer, int32_t* row_idx) {
    if (layer == 0) {
        *row_idx = static_cast<int32_t>(slot);
        return c.neighbors0 + slot * c.m0;
    }
    const int32_t row = c.layer_rowof[layer - 1][slot];
    *row_idx = row;
    if (row < 0) return nullptr;
    return c.layer_nbrs[layer - 1] + static_cast<int64_t>(row) * c.m;
}

// append `to` to `from`'s list at `layer`; prune to max degree by distance,
// dropping deleted entries (reference: pruneConnections)
void add_link(Ctx& c, int64_t from, int64_t to, int32_t layer) {
    int32_t row;
    int32_t* nbrs = adj_row(c, from, layer, &row);
    if (nbrs == nullptr) return;  // not a member of this layer; skip
    const int32_t max_conn = (layer == 0) ? c.m0 : c.m;

    int32_t count = 0;
    while (count < max_conn && nbrs[count] >= 0) {
        if (nbrs[count] == static_cast<int32_t>(to)) return;  // already linked
        ++count;
    }
    if (count < max_conn) {
        nbrs[count] = static_cast<int32_t>(to);
        mark_dirty(c, layer, row);
        return;
    }
    // overfull: re-select the best max_conn live neighbors of `from`
    static thread_local std::vector<std::pair<float, int32_t>> items;
    items.clear();
    items.reserve(count + 1);
    const float from_norm = sq_norm(c, from);
    for (int32_t i = 0; i < count; ++i) {
        const int32_t nb = nbrs[i];
        if (c.deleted[nb]) continue;
        items.emplace_back(distance_anchored(c, from, from_norm, nb), nb);
    }
    if (!c.deleted[to]) {
        items.emplace_back(
            distance_anchored(c, from, from_norm, to), static_cast<int32_t>(to));
    }
    std::sort(items.begin(), items.end());
    size_t keep;
    if (c.heuristic) {
        keep = select_diverse(c, items, max_conn, nbrs);
    } else {
        keep = std::min<size_t>(max_conn, items.size());
        for (size_t i = 0; i < keep; ++i) nbrs[i] = items[i].second;
    }
    for (size_t i = keep; i < static_cast<size_t>(max_conn); ++i) nbrs[i] = -1;
    mark_dirty(c, layer, row);
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 if the dirty buffer overflowed (caller falls back
// to a full device re-upload).
int32_t apply_chunk(
    const float* vectors, int64_t cap, int64_t dim,
    int32_t* neighbors0, int32_t m0,
    int32_t n_layers, int32_t** layer_nbrs, int32_t** layer_rowof, int32_t m,
    const uint8_t* deleted,
    int32_t metric,
    int32_t heuristic,
    // device descent results: [n_cand_layers, B, efc]
    const int32_t* cand_slots, const float* cand_dists,
    int32_t n_cand_layers, int32_t B, int32_t efc,
    // chunk
    const int64_t* new_slots, const int32_t* levels,
    const float* intra,  // [B, B] exact distances among chunk vectors
    int32_t frozen_max,  // store.max_layer at descent time
    // in/out: entrypoint bookkeeping
    int64_t* entry_slot_io, int32_t* max_layer_io,
    // out: dirty (layer, row) pairs
    int32_t* dirty_out, int64_t max_dirty, int64_t* n_dirty_out) {
    Ctx c{vectors, cap, dim, neighbors0, m0, n_layers,
          layer_nbrs, layer_rowof, m, deleted, metric,
          heuristic != 0, dirty_out, max_dirty, 0, false};

    std::vector<std::pair<float, int32_t>> merged;
    std::vector<int32_t> selected;

    for (int32_t i = 0; i < B; ++i) {
        const int32_t level = levels[i];
        const int64_t slot = new_slots[i];
        for (int32_t lc = level; lc >= 0; --lc) {
            merged.clear();
            // frozen-graph candidates from the device descent
            if (lc <= frozen_max && lc < n_cand_layers) {
                const int64_t base =
                    (static_cast<int64_t>(lc) * B + i) * efc;
                for (int32_t j = 0; j < efc; ++j) {
                    const int32_t cs = cand_slots[base + j];
                    if (cs < 0 || cs == static_cast<int32_t>(slot)) continue;
                    if (lc >= 1 && layer_rowof[lc - 1][cs] < 0) continue;
                    merged.emplace_back(cand_dists[base + j], cs);
                }
            }
            // earlier chunk members present at this layer
            for (int32_t j = 0; j < i; ++j) {
                if (levels[j] >= lc) {
                    merged.emplace_back(
                        intra[static_cast<int64_t>(i) * B + j],
                        static_cast<int32_t>(new_slots[j]));
                }
            }
            if (merged.empty()) continue;
            const int32_t max_conn = (lc == 0) ? m0 : m;
            std::sort(merged.begin(), merged.end());
            selected.clear();
            if (c.heuristic) {
                selected.resize(max_conn);
                selected.resize(
                    select_diverse(c, merged, max_conn, selected.data()));
            } else {
                const size_t keep =
                    std::min<size_t>(max_conn, merged.size());
                for (size_t j = 0; j < keep; ++j)
                    selected.push_back(merged[j].second);
            }
            // forward links
            int32_t row;
            int32_t* nbrs = adj_row(c, slot, lc, &row);
            if (nbrs == nullptr) continue;
            for (size_t j = 0; j < selected.size(); ++j)
                nbrs[j] = selected[j];
            const int32_t width = (lc == 0) ? m0 : m;
            for (size_t j = selected.size();
                 j < static_cast<size_t>(width); ++j)
                nbrs[j] = -1;
            mark_dirty(c, lc, row);
            // reverse links + pruning
            for (const int32_t nb : selected) add_link(c, nb, slot, lc);
        }
        if (level > *max_layer_io || *entry_slot_io < 0) {
            if (level > *max_layer_io) *max_layer_io = level;
            *entry_slot_io = slot;
        }
    }
    *n_dirty_out = c.n_dirty;
    return c.dirty_overflow ? 1 : 0;
}

// Reverse-edge cap for the bulk kNN builder (knn_build._incoming_host):
// every forward edge u->v makes u an incoming candidate of v; keep the
// max_deg NEAREST per target (exact: a farther incoming edge could never
// survive the final prune — reference: hnsw.go:586-614). Counting-bucket
// by target + per-target partial select: O(E) instead of the numpy
// packed-key argsort (O(E log E) with Python-side key assembly), which
// profiled as the largest host phase of a 1M build.
int32_t incoming_cap(
    const int32_t* fwd_i,  // [nm, F] forward neighbors (-1 padded)
    const float* fwd_d,    // [nm, F]
    int64_t nm, int32_t F, int32_t max_deg,
    int32_t* inc_i,        // [nm, max_deg] out (pre-filled -1)
    float* inc_d           // [nm, max_deg] out (pre-filled +inf)
) {
    const int64_t e_max = nm * F;
    std::vector<int64_t> count(nm + 1, 0);
    for (int64_t e = 0; e < e_max; ++e) {
        const int32_t dst = fwd_i[e];
        if (dst >= 0 && dst < nm) ++count[dst];
    }
    std::vector<int64_t> offset(nm + 1, 0);
    for (int64_t t = 0; t < nm; ++t) offset[t + 1] = offset[t] + count[t];
    const int64_t E = offset[nm];
    std::vector<int32_t> es(E);
    std::vector<float> ed(E);
    std::vector<int64_t> cursor(offset.begin(), offset.end() - 1);
    for (int64_t u = 0; u < nm; ++u) {
        const int64_t row = u * F;
        for (int32_t j = 0; j < F; ++j) {
            const int32_t dst = fwd_i[row + j];
            if (dst < 0 || dst >= nm) continue;
            const int64_t pos = cursor[dst]++;
            es[pos] = static_cast<int32_t>(u);
            ed[pos] = fwd_d[row + j];
        }
    }
    std::vector<std::pair<float, int32_t>> bucket;
    for (int64_t t = 0; t < nm; ++t) {
        const int64_t b0 = offset[t], b1 = offset[t + 1];
        const int64_t cnt = b1 - b0;
        if (cnt == 0) continue;
        bucket.clear();
        bucket.reserve(cnt);
        for (int64_t p = b0; p < b1; ++p)
            bucket.emplace_back(ed[p], es[p]);
        const int64_t keep = std::min<int64_t>(cnt, max_deg);
        if (cnt > keep)
            std::nth_element(
                bucket.begin(), bucket.begin() + keep, bucket.end());
        std::sort(bucket.begin(), bucket.begin() + keep);
        int32_t* oi = inc_i + t * max_deg;
        float* od = inc_d + t * max_deg;
        for (int64_t j = 0; j < keep; ++j) {
            od[j] = bucket[j].first;
            oi[j] = bucket[j].second;
        }
    }
    return 0;
}

}  // extern "C"
