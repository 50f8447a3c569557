// Whole-corpus lane scans of the flat (exact-scan) index: a score product
// with the per-lane best-two fold in its epilogue.
//
// Replaces, in scintirete_tpu/ops/pallas_scan.py:
// - lane_topk_scan_packed_int8 (body _lane_scan_kernel_packed_int8): entry
//   scnt_flat_packed_int8. s8 x s8 -> s32 dots (exact), score
//   bsq - dots * (qs2 * bs) for L2 or bsq - dots * bs otherwise; groups of
//   `group` tiles are pre-reduced with strict < (the earlier tile wins a
//   tie) keeping the winner's tile id, then ONE pack and ONE fold per
//   group. Masking and clamps live in the wrapper (invalid rows arrive as
//   bs = 0, bsq = 3e38), so every score is finite by construction.
// - lane_topk_scan_packed (body _lane_scan_kernel_packed, pack _pack_tile):
//   entry scnt_flat_packed_bf16. bf16 dots summed in f32, score
//   bsq - 2 dots or -dots, invalid rows -> 3e38, NaN -> 3e38, clamp to
//   +-3e38, pack per tile, same fold.
// - lane_topk_scan_int8 (body _lane_scan_kernel_int8): entry
//   scnt_flat_lane_int8. The same s8 product with the unpacked best-two
//   fold (_fold_best_two) on (score, tile); score bsq - (2 dot) (qs bs) for
//   L2 or (-dot) bs otherwise, with the caller's raw scales and norms (no
//   clamp); invalid rows score +inf in the reference, NaN here (the
//   prepared column term is NaN), and the strict-< fold drops either.
// (lane_topk_scan, the unpacked bf16 scan, is the third entry point of
// lane_scan.cu: its body is the masked graph-build scan without a self row.)
//
// Packed keys: the low 13 mantissa bits of the f32 score are replaced by
// the tile index, and the fold is k1' = min(k1, key),
// k2' = min(k2, max(k1, key)). A key must never be NaN: fminf / fmaxf drop
// a NaN operand where the TPU's minimum keeps it, so the two would part
// ways silently. The bf16 body therefore maps NaN to the sentinel before
// anything can turn it into a number (a clamp through fmaxf first would
// make NaN -3e38, the best score there is).
//
// Lane contract, shared with lane_scan.cu: base row r folds into lane
// r mod 1024. Outputs are [B, 2048]: best in columns [0, 1024), second best
// in [1024, 2048); the i32 output holds the row read back from the key (-1
// where key >= 1.5e38) or from the folded tile id (-1 where empty).
//
// What bounds the scans on an H100: the products and the fold's
// issue, about equally (scripts/torch_flat_split.py times copies without
// either). 1024 queries against 1M rows of depth 128 are 0.27 T operations
// (0.28 ms of bf16, 0.14 ms of int8 tensor-core peak) and 1.07 G scores to
// fold, each three min / max and a bit operation on the ALU pipe, while
// the base streams 128 MB (int8) or 256 MB (bf16) from memory once and
// then out of L2 once per query tile.
//
// What the design does about it (the shape of lane_scan.cu's):
// - the products run on the tensor cores, both operands in shared memory
//   with the 128-byte swizzle: bf16 wgmma m64n64k16 with f32 sums, or s8
//   wgmma m64n64k32 with s32 sums (exact; TMA copies the int8 rows as
//   UINT8, unchanged). One 128-byte row of a TMA box is 64 bf16 or 128
//   int8 depth values, four k-steps either way;
// - a block owns 128 queries (two consumer warpgroups of 64 rows) x 64
//   lanes; one producer thread keeps a ring of up to 16 base chunks (64
//   rows x 128 bytes) in flight with mbarriers, and with each tile's last
//   chunk copies the tile's two column arrays (1-D bulk copies of 64
//   floats): bs and bsq for int8, bsq and the invalid mask for bf16. No
//   thread waits on a global load;
// - the bf16 score is s = c - f dot with c = bsq (L2), -0 (cosine, IP:
//   -0 - dot is exactly -dot, signed zero included) or NaN where the row
//   is masked; the metric is a template argument;
// - queries stay in shared memory while they fit (four chunks: D <= 256
//   bf16, 512 int8) and stream beside the base chunk beyond that;
// - the fold runs in registers in the epilogue of each tile's product: a
//   wgmma accumulator element sits at the same (query, lane) tile after
//   tile, and the key carries its tile id, so the state is (k1, k2) and,
//   for int8 groups of 2 or 4 tiles, the group's running minimum with its
//   tile. The unpacked int8 scan keeps lane_scan.cu's state instead: (d1,
//   d2) and two 16-bit tile ids in one register (hopper_common.cuh
//   fold_best_two), so a launch takes at most 65,535 tiles. The metric and
//   the mode (bf16 keys, int8 keys, int8 keys of tile groups, int8 lanes)
//   are template arguments. The two warpgroups run in lockstep: letting them take turns on
//   the tensor cores (named barriers), or keeping two tiles in flight per
//   warpgroup, made ptxas serialize the wgmma (C7520, C7514) and the
//   kernel slower;
// - the int8 entries make the scan's inputs themselves in two launches
//   (the query quantization of quantize_rows and the [N] column terms:
//   packed_int8_inputs' masks and clamps for the packed scan, the raw
//   scales and norms with the mask as NaN for the unpacked one), where the
//   wrapper's ~20 small torch ops left the card waiting ~0.5 ms;
// - the s32 -> f32 conversion of an int8 dot is I2F (round to nearest).
//   An integer add into the mantissa of 1.5 * 2^23 and a subtract (exact
//   while |dot| <= 2^22) was slower on an H100: 0.91-0.92 ms against
//   0.82 ms with I2F at B = 1024, N = 2^20, D = 128. The add and the
//   subtract issue on the pipes the fold fills, I2F beside them;
// - the tile walk is split into `slices` contiguous ranges that start at a
//   group boundary, one block each, where a launch would otherwise leave
//   SMs idle (B = 1 is 16 blocks of one range each on 132 SMs). Packed
//   keys are never equal (each carries its tile's id, a group its winner's),
//   so a lane's (k1, k2) are just its two least keys, whatever the order of
//   the fold: the slices' pairs merge with the same min / max in a second
//   small pass and give the same bits as one walk. (The unpacked fold
//   breaks ties between equal scores by tile order, so the unpacked int8
//   scan, as lane_scan.cu, does not split: at small B a launch takes a
//   full walk's time.)
// TMA needs rows of whole 16-byte units and 16-byte aligned starts: int8
// D % 16 == 0, bf16 D % 8 == 0; the wrappers pad with zero columns, which
// change no dot, no norm and no int8 scale. Score arithmetic uses
// __fmul_rn / __fsub_rn so no multiply is contracted into an FMA: the int8
// scans then equal their plain versions bit for bit.
#include "hopper_common.cuh"

namespace {

constexpr int kL2 = 1;
constexpr int kLanes = 1024;
constexpr int kTileMask = (1 << 13) - 1;
constexpr int kMaxTiles = 1 << 13;  // tile ids of a packed key
constexpr float kSentinel = 3.0e38f;

__device__ __forceinline__ float pack_key(float s, int tile) {
  return __int_as_float((__float_as_int(s) & ~kTileMask) | tile);
}

__device__ __forceinline__ void fold_key(float& k1, float& k2, float key) {
  const float k1_old = k1;
  k1 = fminf(k1_old, key);
  k2 = fminf(k2, fmaxf(k1_old, key));
}

// unpack_lane_keys: row = embedded tile * 1024 + lane
__device__ __forceinline__ int key_row(float key, int lane) {
  return key < 0.5f * kSentinel
             ? (__float_as_int(key) & kTileMask) * kLanes + lane
             : -1;
}

// What a scan folds: packed keys (bf16; int8, one tile or a group a key),
// or the unpacked lanes of lane_topk_scan_int8.
enum Mode : int { kBf16Keys, kInt8Keys, kInt8Groups, kInt8Lanes };

using namespace hopper;

constexpr int kTileRows = 64;        // lanes a block covers = base rows per tile
constexpr int kQueryRows = 128;      // queries a block covers: 2 x 64
constexpr int kRowBytes = 128;       // depth bytes of one TMA box row
constexpr int kMaxStages = 16;       // base chunks in flight, at most
constexpr int kResidentChunks = 4;   // query chunks kept in shared memory
constexpr int kThreads = 384;        // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr uint32_t kBaseChunkBytes = kTileRows * kRowBytes;     // 8 KB
constexpr uint32_t kQueryChunkBytes = kQueryRows * kRowBytes;   // 16 KB
constexpr uint32_t kHalfQueryBytes = kQueryChunkBytes / 2;      // one warpgroup's rows
constexpr uint32_t kColBytes = 2 * kTileRows * 4;  // two f32 column terms per row
constexpr uint32_t kSmemBudget = 200 * 1024;

// Dynamic shared memory, byte offsets from a 1024-aligned start (the
// 128-byte swizzle repeats every 8 rows = 1024 bytes).
struct Layout {
  uint32_t query;        // resident query chunks (kc * 16 KB), or none
  uint32_t stages;       // nstages x stage_bytes
  uint32_t stage_bytes;  // base chunk, then (streamed) the query chunk
  uint32_t cols;         // nstages x kColBytes: a tile's column terms
  uint32_t bars;         // full[nstages], empty[nstages], query
  uint32_t total;
  int nstages;
};

__host__ __device__ inline Layout layout_for(int chunks) {
  const bool resident = chunks <= kResidentChunks;
  Layout L;
  L.query = 0;
  L.stages = resident ? chunks * kQueryChunkBytes : 0;
  L.stage_bytes = kBaseChunkBytes + (resident ? 0 : kQueryChunkBytes);
  const uint32_t room = kSmemBudget - L.stages - (2 * kMaxStages + 1) * 8;
  const int fit = static_cast<int>(room / (L.stage_bytes + kColBytes));
  L.nstages = fit < kMaxStages ? fit : kMaxStages;
  L.cols = L.stages + L.nstages * L.stage_bytes;
  L.bars = L.cols + L.nstages * kColBytes;
  L.total = L.bars + (2 * L.nstages + 1) * 8;
  return L;
}

template <bool kInt8>
struct Acc;
template <>
struct Acc<false> { using T = float; };
template <>
struct Acc<true> { using T = int; };

// int8 modes: q / base int8, col_a / col_b = bs / bsq [N] as prep_columns
// makes them, qs [B] = 2 x the clamped query scale (keys) or the query
// scale (lanes); kBf16Keys: q / base bf16, col_a / col_b = bsq / invalid
// [N]. The column arrays are copied per tile beside the tile's last chunk
// (1-D bulk copies), 16-byte aligned. kInt8Groups: groups of `group` > 1
// tiles. Block (x, y, z) = (query tile, lane range, slice of the tile
// walk); with one slice the block writes keys (or scores) and rows, with
// more it writes its keys to ws [slices, B, 2048] for merge_slices.
template <int kMode, bool kL2Metric>
__global__ void __launch_bounds__(kThreads, 1)
flat_scan_kernel(const __grid_constant__ CUtensorMap q_map,  // [B, D]
                 const __grid_constant__ CUtensorMap b_map,  // [N, D]
                 const float* __restrict__ qs,
                 const float* __restrict__ col_a,
                 const float* __restrict__ col_b,
                 float* __restrict__ out_f,  // [B, 2048]
                 int* __restrict__ out_i,    // [B, 2048]
                 float* __restrict__ ws,     // [slices, B, 2048] or nullptr
                 int B, int row_bytes, int tiles, int group,
                 int slice_tiles) {
  constexpr bool kInt8 = kMode != kBf16Keys;
  constexpr bool kGrouped = kMode == kInt8Groups;
  constexpr bool kUnpacked = kMode == kInt8Lanes;
  using AccT = typename Acc<kInt8>::T;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int chunks = (row_bytes + kRowBytes - 1) / kRowBytes;
  const bool resident = chunks <= kResidentChunks;
  const Layout L = layout_for(chunks);
  const int nstages = L.nstages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + nstages;
  uint64_t* qbar = empty + nstages;
  float* cols = reinterpret_cast<float*>(smem + L.cols);
  const int q0 = blockIdx.x * kQueryRows;
  const int lane0 = blockIdx.y * kTileRows;
  const int t0 = blockIdx.z * slice_tiles;
  const int t1 = min(tiles, t0 + slice_tiles);
  const int wg = threadIdx.x / 128;
  constexpr int kCols = kInt8 ? 128 : 64;  // depth values per 128-byte row

  if (threadIdx.x == 0) {
    for (int s = 0; s < nstages; ++s) {
      mbar_init(&full[s], 1);   // the producer thread (+ copied bytes)
      mbar_init(&empty[s], 8);  // one lane of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // --------------- producer: one thread feeds the ring ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      if (resident && t0 < t1) {
        mbar_arrive_tx(qbar, chunks * kQueryChunkBytes);
        for (int kc = 0; kc < chunks; ++kc)
          tma_load(smem + L.query + kc * kQueryChunkBytes, &q_map, qbar,
                   kc * kCols, q0);
      }
      const uint32_t bytes =
          kBaseChunkBytes + (resident ? 0u : kQueryChunkBytes);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t0; t < t1; ++t) {
        const int64_t r0 = static_cast<int64_t>(t) * kLanes + lane0;
        for (int kc = 0; kc < chunks; ++kc) {
          const bool last = kc == chunks - 1;
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* buf = smem + L.stages + stage * L.stage_bytes;
          mbar_arrive_tx(&full[stage], bytes + (last ? kColBytes : 0u));
          tma_load(buf, &b_map, &full[stage], kc * kCols,
                   t * kLanes + lane0);
          if (!resident)
            tma_load(buf + kBaseChunkBytes, &q_map, &full[stage],
                     kc * kCols, q0);
          if (last) {  // the tile's column terms ride with its last chunk
            float* dst = cols + stage * (kColBytes / 4);
            bulk_load(dst, col_a + r0, kColBytes / 2, &full[stage]);
            bulk_load(dst + kTileRows, col_b + r0, kColBytes / 2,
                      &full[stage]);
          }
          if (++stage == nstages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ------------- consumers: 64 query rows x 64 lanes each -------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int l = tid & 31;
    // accumulator element j of this thread: query row qa (j & 2 == 0) or
    // qa + 8, lane lane0 + 8 (j >> 2) + colx + (j & 1)
    const int qa = q0 + wg * 64 + warp * 16 + (l >> 2);
    const int qb = qa + 8;
    const int colx = 2 * (l & 3);
    float qsa = 0.f, qsb = 0.f;
    if (kInt8 && kL2Metric) {
      qsa = qa < B ? qs[qa] : 0.f;
      qsb = qb < B ? qs[qb] : 0.f;
    }

    // keys: the lane's two least keys; lanes: its (d1, d2) scores
    float k1[32], k2[32];
    float m[kGrouped ? 32 : 1];   // the group's running minimum ...
    int mi[kGrouped ? 32 : 1];    // ... and its tile
    uint32_t tp[kUnpacked ? 32 : 1];  // lanes: tile ids of d1 (low), d2 (high)
    const float none = kUnpacked ? __int_as_float(0x7f800000) : kSentinel;
#pragma unroll
    for (int j = 0; j < 32; ++j) { k1[j] = none; k2[j] = none; }
#pragma unroll
    for (int j = 0; j < (kGrouped ? 32 : 1); ++j) { m[j] = 0.f; mi[j] = 0; }
#pragma unroll
    for (int j = 0; j < (kUnpacked ? 32 : 1); ++j) tp[j] = 0xffffffffu;
    if (resident && t0 < t1) mbar_wait(qbar, 0);
    const uint32_t q_res = smem_u32(smem + L.query) + wg * kHalfQueryBytes;

    AccT acc[32];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = t0; t < t1; ++t) {
      // the tile's products, one commit group per chunk; each chunk's
      // stage but the last is released as soon as its products are done
      int prev = 0;
      for (int kc = 0; kc < chunks; ++kc) {
        mbar_wait(&full[stage], phase);
        const uint32_t b_addr =
            smem_u32(smem + L.stages + stage * L.stage_bytes);
        const uint32_t a_addr =
            resident ? q_res + kc * kQueryChunkBytes
                     : b_addr + kBaseChunkBytes + wg * kHalfQueryBytes;
        const int ksteps = min(4, (row_bytes - kc * kRowBytes + 31) / 32);
        fence_acc(acc);
        wgmma_fence();
        for (int k = 0; k < ksteps; ++k) {
          if constexpr (kInt8)
            wgmma_m64n64k32_s8(acc, sw128_desc(a_addr + 32 * k),
                               sw128_desc(b_addr + 32 * k), (kc | k) != 0);
          else
            wgmma_m64n64k16(acc, sw128_desc(a_addr + 32 * k),
                            sw128_desc(b_addr + 32 * k), (kc | k) != 0);
        }
        wgmma_commit();
        if (kc > 0) {
          wgmma_wait<1>();
          __syncwarp();
          if (l == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == nstages) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc(acc);

      // the fold, with the column terms that came with the tile's last
      // chunk (stage prev), which is released after it
      const float* cs = cols + prev * (kColBytes / 4);
      const bool first = kGrouped && t % group == 0;
      const bool close = !kGrouped || t % group == group - 1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 ca = *reinterpret_cast<const float2*>(cs + 8 * i + colx);
        const float2 cb =
            *reinterpret_cast<const float2*>(cs + kTileRows + 8 * i + colx);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float va = h ? ca.y : ca.x;
          const float vb = h ? cb.y : cb.x;
          // bf16: c = bsq (L2) or -0 (c - dot is then exactly -dot), NaN
          // where the row is masked
          const float c = vb > 0.5f ? __int_as_float(0x7fffffff)
                          : kL2Metric ? va
                                      : -0.0f;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 4 * i + 2 * e + h;  // row qa (e = 0) or qb
            float s;
            if constexpr (kUnpacked) {
              // the reference's rounding, step for step (masked: NaN)
              const float dot = __int2float_rn(acc[j]);
              s = kL2Metric
                      ? __fsub_rn(vb, __fmul_rn(__fmul_rn(2.f, dot),
                                                __fmul_rn(e ? qsb : qsa, va)))
                      : __fmul_rn(-dot, va);
            } else if constexpr (kInt8) {
              const float w = kL2Metric ? __fmul_rn(e ? qsb : qsa, va) : va;
              const float dot = __int2float_rn(acc[j]);
              s = __fsub_rn(vb, __fmul_rn(dot, w));
            } else {
              s = kL2Metric ? __fsub_rn(c, __fmul_rn(2.f, acc[j]))
                            : __fsub_rn(c, acc[j]);
              // fminf drops the NaN of a masked row or a NaN product: it
              // becomes the sentinel, and only then is the low end clamped
              s = fmaxf(fminf(s, kSentinel), -kSentinel);
            }
            if constexpr (kUnpacked) {
              fold_best_two(k1[j], k2[j], tp[j], s, static_cast<uint32_t>(t));
            } else if constexpr (kGrouped) {
              if (first || s < m[j]) mi[j] = t;
              m[j] = first ? s : fminf(s, m[j]);
              if (close) fold_key(k1[j], k2[j], pack_key(m[j], mi[j]));
            } else {
              fold_key(k1[j], k2[j], pack_key(s, t));
            }
          }
        }
      }
      __syncwarp();
      if (l == 0) mbar_arrive(&empty[prev]);
    }

#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int b = (j & 2) ? qb : qa;
      if (b >= B) continue;
      const int lane = lane0 + 8 * (j >> 2) + colx;
      if (ws == nullptr) {
        const int64_t o = static_cast<int64_t>(b) * (2 * kLanes) + lane;
        *reinterpret_cast<float2*>(out_f + o) = make_float2(k1[j], k1[j + 1]);
        *reinterpret_cast<float2*>(out_f + o + kLanes) =
            make_float2(k2[j], k2[j + 1]);
        if constexpr (kUnpacked) {
          const uint32_t ta = tp[j], tb = tp[j + 1];
          *reinterpret_cast<int2*>(out_i + o) = make_int2(
              lane_row(ta & 0xffffu, lane), lane_row(tb & 0xffffu, lane + 1));
          *reinterpret_cast<int2*>(out_i + o + kLanes) =
              make_int2(lane_row(ta >> 16, lane), lane_row(tb >> 16, lane + 1));
        } else {
          *reinterpret_cast<int2*>(out_i + o) =
              make_int2(key_row(k1[j], lane), key_row(k1[j + 1], lane + 1));
          *reinterpret_cast<int2*>(out_i + o + kLanes) =
              make_int2(key_row(k2[j], lane), key_row(k2[j + 1], lane + 1));
        }
      } else {
        const int64_t o =
            (static_cast<int64_t>(blockIdx.z) * B + b) * (2 * kLanes) + lane;
        *reinterpret_cast<float2*>(ws + o) = make_float2(k1[j], k1[j + 1]);
        *reinterpret_cast<float2*>(ws + o + kLanes) =
            make_float2(k2[j], k2[j + 1]);
      }
    }
  }
}

// The slices' (k1, k2) of each (query, lane), folded into one pair: the
// two least keys of the lane, as one walk gives them.
__global__ void merge_slices(const float* __restrict__ ws,
                             float* __restrict__ out_f, int* __restrict__ out_i,
                             int B, int slices) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * kLanes) return;
  const int64_t b = idx / kLanes;
  const int lane = static_cast<int>(idx % kLanes);
  float k1 = kSentinel, k2 = kSentinel;
  for (int z = 0; z < slices; ++z) {
    const float* p =
        ws + (static_cast<int64_t>(z) * B + b) * (2 * kLanes) + lane;
    fold_key(k1, k2, p[0]);
    fold_key(k1, k2, p[kLanes]);
  }
  const int64_t o = b * (2 * kLanes) + lane;
  out_f[o] = k1;
  out_f[o + kLanes] = k2;
  out_i[o] = key_row(k1, lane);
  out_i[o + kLanes] = key_row(k2, lane);
}

// The int8 scans' inputs, op for op as the wrappers' torch versions make
// them (equal bit for bit), in two launches instead of ~20 small torch ops.
// Queries, one warp per row (quantize_rows): scale = amax|v| / 127,
// q = round-half-even(v / max(scale, 1e-30)) clamped to +-127 (0 where
// scale is not > 0, and where the quotient is NaN), zero in the padding
// columns [D, Dp). Packed (packed_int8_inputs): qs = 2 x the scale with
// NaN -> 0 and clamped to [0, 5e14]; lanes: qs = the scale itself.
constexpr float kScaleCap = 5.0e14f;
constexpr float kBsqCap = 7.0e37f;

template <bool kUnpacked>
__global__ void prep_queries_int8(const float* __restrict__ q, int B, int D,
                                  int Dp, int8_t* __restrict__ q8,
                                  float* __restrict__ qs) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int l = threadIdx.x & 31;
  if (row >= B) return;
  const float* v = q + static_cast<int64_t>(row) * D;
  float amax = 0.f;
  int nan = 0;
  for (int k = l; k < D; k += 32) {
    const float a = fabsf(v[k]);
    nan |= a != a;
    amax = fmaxf(amax, a);
  }
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    nan |= __shfl_xor_sync(0xffffffffu, nan, o);
  }
  const float scale = nan ? __int_as_float(0x7fffffff) : __fdiv_rn(amax, 127.f);
  const float div = fmaxf(scale, 1e-30f);
  int8_t* out = q8 + static_cast<int64_t>(row) * Dp;
  for (int k = l; k < Dp; k += 32) {
    float r = 0.f;
    if (k < D && scale > 0.f) {
      r = rintf(__fdiv_rn(v[k], div));
      r = r != r ? 0.f : fminf(fmaxf(r, -127.f), 127.f);
    }
    out[k] = static_cast<int8_t>(static_cast<int>(r));
  }
  if (l == 0) {
    if constexpr (kUnpacked) {
      qs[row] = scale;
    } else {
      const float sc = scale != scale ? 0.f : scale;  // +inf clamps to the cap
      qs[row] = __fmul_rn(2.f, fminf(fmaxf(sc, 0.f), kScaleCap));
    }
  }
}

// The [N] column terms. Packed: bs = 0 where the row is invalid, else the
// scale with NaN -> 0 clamped to [0, 5e14]; bsq = 3e38 where invalid, else
// (L2) the norm with NaN -> 7e37 clamped to +-7e37, or 0. Lanes: the raw
// scale and (L2) norm, or 0, with NaN in the term the score reads last
// (bsq for L2, bs otherwise) where the row is invalid, so that its score
// is NaN, which the strict-< fold drops as it drops the reference's +inf.
template <bool kUnpacked>
__global__ void prep_columns_int8(const float* __restrict__ scale,
                                  const float* __restrict__ sq,
                                  const float* __restrict__ invalid,
                                  int64_t N, int l2, float* __restrict__ bs,
                                  float* __restrict__ bsq) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const bool bad = invalid[i] > 0.5f;
  float b = scale[i];
  float n = l2 ? sq[i] : 0.f;
  if constexpr (kUnpacked) {
    const float nan = __int_as_float(0x7fffffff);
    if (bad && l2) n = nan;
    if (bad && !l2) b = nan;
  } else {
    b = b != b ? 0.f : fminf(fmaxf(b, 0.f), kScaleCap);
    if (l2) n = n != n ? kBsqCap : fminf(fmaxf(n, -kBsqCap), kBsqCap);
    if (bad) { b = 0.f; n = kSentinel; }
  }
  bs[i] = b;
  bsq[i] = n;
}

// what one launch of the scan kernel takes besides its template
struct Launch {
  CUtensorMap q_map, b_map;
  const void *qs, *col_a, *col_b;
  void *out_f, *out_i, *ws;
  int B, row_bytes, tiles, group, slices, slice_tiles;
  cudaStream_t stream;
};

template <int kMode, bool kL2Metric>
cudaError_t start(const Launch& a) {
  auto kernel = flat_scan_kernel<kMode, kL2Metric>;
  const int smem =
      static_cast<int>(
          layout_for((a.row_bytes + kRowBytes - 1) / kRowBytes).total) + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + kQueryRows - 1) / kQueryRows, kLanes / kTileRows,
                  a.slices);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.q_map, a.b_map, static_cast<const float*>(a.qs),
      static_cast<const float*>(a.col_a), static_cast<const float*>(a.col_b),
      static_cast<float*>(a.out_f), static_cast<int*>(a.out_i),
      a.slices > 1 ? static_cast<float*>(a.ws) : nullptr, a.B, a.row_bytes,
      a.tiles, a.group, a.slice_tiles);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t start_for(const Launch& a, int metric) {
  return metric == kL2 ? start<kMode, true>(a) : start<kMode, false>(a);
}

// kMode is kBf16Keys, kInt8Keys (groups of one tile or more) or kInt8Lanes.
template <int kMode>
int launch(const void* q, const void* qs, const void* base, const void* bs,
           const void* bsq, const void* invalid, void* out_f, void* out_i,
           void* ws, int B, int D, long long N, int tiles, int group,
           int slices, int metric, void* stream) {
  if (B <= 0) return 0;
  constexpr bool kInt8 = kMode != kBf16Keys;
  constexpr bool kKeys = kMode != kInt8Lanes;
  const int elem = kInt8 ? 1 : 2;
  Launch a;
  // the column arrays are copied 64 rows (256 bytes) at a time; TMA takes
  // rows of whole 16-byte units from 16-byte aligned starts (the encoder
  // refuses others)
  a.col_a = kInt8 ? bs : bsq;
  a.col_b = kInt8 ? bsq : invalid;
  if (D <= 0 || (D * elem) % 16 != 0 || tiles < 0 ||
      tiles > (kKeys ? kMaxTiles : kMaxLaneTiles) || group < 1 ||
      tiles % group != 0 || slices < 1 || (slices > 1 && ws == nullptr) ||
      (kMode != kInt8Keys && group != 1) || (!kKeys && slices != 1) ||
      N < static_cast<long long>(tiles) * kLanes ||
      reinterpret_cast<uintptr_t>(a.col_a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.col_b) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const CUtensorMapDataType type =
      kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // with no tile to scan the base map is never read: describe the queries
  const bool scan = tiles > 0;
  if (!encode(fn, &a.q_map, type, elem, q, B, D, kQueryRows) ||
      !encode(fn, &a.b_map, type, elem, scan ? base : q, scan ? N : B, D,
              kTileRows))
    return static_cast<int>(cudaErrorInvalidValue);
  // contiguous slices of whole groups, none of them empty
  const int groups = tiles / group;
  const int per_slice = groups > 0 ? (groups + slices - 1) / slices : 1;
  a.slices = groups > 0 ? (groups + per_slice - 1) / per_slice : 1;
  a.slice_tiles = per_slice * group;
  a.qs = qs;
  a.out_f = out_f;
  a.out_i = out_i;
  a.ws = ws;
  a.B = B;
  a.row_bytes = D * elem;
  a.tiles = tiles;
  a.group = group;
  a.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      kMode == kInt8Keys && group > 1 ? start_for<kInt8Groups>(a, metric)
                                      : start_for<kMode>(a, metric);
  if (err != cudaSuccess || a.slices == 1) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(B) * kLanes;
  merge_slices<<<static_cast<unsigned>((n + 255) / 256), 256, 0, a.stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(out_f),
      static_cast<int*>(out_i), B, a.slices);
  return static_cast<int>(cudaGetLastError());
}

// An int8 scan from the caller's arrays: q [B, D] f32 (quantized here),
// base8 [N, Dp] int8 (Dp % 16 == 0, zero past D), base_scale / base_sq /
// invalid [N] f32 as the caller keeps them; q8 [B, Dp] i8, qs [B] f32 and
// cols [2, N] f32 are scratch for the prepared inputs.
template <bool kUnpacked>
int int8_scan(const void* q, const void* base8, const void* base_scale,
              const void* base_sq, const void* invalid, void* q8, void* qs,
              void* cols, void* out_f, void* out_i, void* ws, int B, int D,
              int Dp, long long N, int tiles, int group, int slices,
              int metric, void* stream) {
  if (B <= 0) return 0;
  if (D <= 0 || D > Dp || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* bs = static_cast<float*>(cols);
  float* bsq = bs + N;
  prep_queries_int8<kUnpacked><<<(B + 7) / 8, 256, 0, st>>>(
      static_cast<const float*>(q), B, D, Dp, static_cast<int8_t*>(q8),
      static_cast<float*>(qs));
  if (N > 0)
    prep_columns_int8<kUnpacked><<<static_cast<unsigned>((N + 255) / 256), 256,
                                0, st>>>(
        static_cast<const float*>(base_scale),
        static_cast<const float*>(base_sq),
        static_cast<const float*>(invalid), N, metric == kL2, bs, bsq);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<kUnpacked ? kInt8Lanes : kInt8Keys>(
      q8, qs, base8, bs, bsq, nullptr, out_f, out_i, ws, B, Dp, N, tiles,
      group, slices, metric, stream);
}

}  // namespace

// The packed scans: out_f / out_i [B, 2048] keys and rows; ws [slices, B,
// 2048] f32 scratch, read only when slices > 1.
// bf16: q [B, D] and base [N, D] bf16 (D % 8 == 0), bsq / invalid [N].
extern "C" int scnt_flat_packed_bf16(const void* q, const void* base,
                                     const void* bsq, const void* invalid,
                                     void* out_f, void* out_i, void* ws,
                                     int B, int D, long long N, int tiles,
                                     int group, int slices, int metric,
                                     void* stream) {
  return launch<kBf16Keys>(q, nullptr, base, nullptr, bsq, invalid, out_f,
                           out_i, ws, B, D, N, tiles, group, slices, metric,
                           stream);
}

// int8: the arguments of int8_scan; groups of `group` tiles.
extern "C" int scnt_flat_packed_int8(const void* q, const void* base8,
                                     const void* base_scale,
                                     const void* base_sq, const void* invalid,
                                     void* q8, void* qs2, void* cols,
                                     void* out_f, void* out_i, void* ws,
                                     int B, int D, int Dp, long long N,
                                     int tiles, int group, int slices,
                                     int metric, void* stream) {
  return int8_scan<false>(q, base8, base_scale, base_sq, invalid, q8, qs2,
                          cols, out_f, out_i, ws, B, D, Dp, N, tiles, group,
                          slices, metric, stream);
}

// The unpacked int8 scan: out_f / out_i [B, 2048] scores and rows (+inf /
// -1 where empty), one walk (the workspace, group and slice count are the
// packed entry's and are not read).
extern "C" int scnt_flat_lane_int8(const void* q, const void* base8,
                                   const void* base_scale,
                                   const void* base_sq, const void* invalid,
                                   void* q8, void* qs, void* cols,
                                   void* out_f, void* out_i, void* /*ws*/,
                                   int B, int D, int Dp, long long N,
                                   int tiles, int /*group*/, int /*slices*/,
                                   int metric, void* stream) {
  return int8_scan<true>(q, base8, base_scale, base_sq, invalid, q8, qs,
                         cols, out_f, out_i, nullptr, B, D, Dp, N, tiles, 1,
                         1, metric, stream);
}
