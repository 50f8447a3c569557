// Builder candidate scans: per-lane best-two of the ranking score over the
// first grid_tiles * 1024 base rows, self-excluded, with one of two masks.
//
// Replaces, in scintirete_tpu/ops/pallas_scan.py:
// - knn_lane_topc (kernel body _knn_lane_kernel, fold _fold_best_two): rows
//   >= n_valid are masked (the prefix bound). The candidate scan of the bulk
//   build (index/knn_build.py _layer_adj). Entry scnt_knn_lane_scan.
// - knn_lane_topc_masked (body _knn_lane_kernel_masked): a row is masked
//   when its per-row invalid[r] > 0.5 (f32 mask: non-member, deleted or
//   padding). The scans of the batched append (knn_build.append_batch),
//   layer 0 and every upper layer, over one cached full base. Entry
//   scnt_knn_lane_scan_masked; rows >= N also count as masked, so N need
//   not be a multiple of 1024.
// - lane_topk_scan (body _lane_scan_kernel): the unpacked bf16 scan of the
//   flat index. Its body is _knn_lane_kernel_masked without the self
//   exclusion, so entry scnt_lane_topk_scan launches the masked mode with
//   no self rows (self_idx = nullptr) and writes best and second best side
//   by side into [B, 2048] outputs (row stride 2048).
// All entries launch ONE templated kernel body; the mask mode is the
// template argument. The wrappers keep the Pallas wrappers' tail: the exact
// top-c of the 2048 lane winners and the finalization.
//
// Lane contract: base row r folds into lane r mod 1024, rows are folded in
// tile order (r = t * 1024 + lane for t = 0, 1, ...) with strict <, so every
// lane keeps the same two survivors as _fold_best_two on the TPU. Scores
// are s = b^2 - 2 dot (L2) or -dot (cosine on normalized rows, IP), with
// bf16 inputs and f32 sums; masked rows and a query's own row score +inf
// and never enter a lane.
//
// What bounds it on an H100: the products. One 2048-row query block
// against a 1M-row base is 2 * 2048 * 1M * 128 = 0.55 Tflop (0.56 ms at
// the bf16 tensor-core peak) against 256 MB of base: far above the card's
// bytes-per-operation line. Beside the product, the fold is ~12
// instructions per score on the CUDA cores, 2.1 G scores a full scan.
//
// What the design does about it:
// - the products run on the tensor cores: bf16 x bf16 -> f32 wgmma
//   m64n64k16 with both operands in shared memory (128-byte swizzle). A
//   block owns 128 queries x 64 lanes: two consumer warpgroups, each with
//   64 query rows, share every base tile (half the base traffic of a
//   64-query block); the grid is lane-range-major (blockIdx.x = query
//   tile), so the blocks resident together read the same base rows and
//   share them in L2;
// - one producer warp keeps a ring of kStages base chunks (64 rows x 64
//   depth, 8 KB, one TMA box each) in flight with mbarriers, and stages each
//   tile's 64 column terms beside it (b^2 for L2, 0 otherwise, +inf where
//   the row is masked), so the score keeps the old rounding:
//   s = __fsub_rn(col, __fmul_rn(f, dot)) with f = 2 (L2) or 1;
// - the query tile is loaded ONCE per block while it fits (D <= 256: at
//   most 64 KB); deeper queries stream through the ring beside the base
//   chunk, 64 columns at a time;
// - the fold runs in the epilogue of each tile's product, in registers: a
//   wgmma accumulator element sits at the same (query, lane) for the same
//   thread tile after tile, so each thread keeps (d1, t1, d2, t2) for its
//   32 pairs and folds tile t before tile t + 1. Nothing is merged across
//   warpgroups or blocks: a merge on (distance, row) would not reproduce
//   the strict-< fold on ties. The state holds tile ids, not rows (the lane
//   is implied by the register's position): two 16-bit ids in one register,
//   0xffff = empty, so a launch takes at most 65,535 tiles;
// - the self exclusion only runs on a tile whose rows meet one of the
//   thread's two self rows (the query's own row is -inf'd in the product,
//   so it scores +inf);
// - setmaxnreg gives the producer warpgroup 40 registers and the two
//   consumer warpgroups 232.
// TMA needs a row stride of whole 16-byte units: D % 8 == 0 (bf16) and
// 16-byte aligned rows, which the wrappers arrange (they pad with zero
// columns, which change no dot product and no norm). Depth past D inside a
// 64-column box is TMA's out-of-bounds zero fill, as are rows past N.
#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kL2 = 1;
constexpr int kLanes = 1024;
constexpr int kTileRows = 64;        // lanes a block covers = base rows per tile
constexpr int kQueryRows = 128;      // queries a block covers: 2 x 64
constexpr int kChunk = 64;           // depth of one TMA box: 128 bytes = one swizzle row
constexpr int kStages = 8;           // base chunks in flight
constexpr int kResidentChunks = 4;   // queries stay in shared memory up to D = 256
constexpr int kThreads = 384;        // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr uint32_t kBaseChunkBytes = kTileRows * kChunk * 2;    // 8 KB
constexpr uint32_t kQueryChunkBytes = kQueryRows * kChunk * 2;  // 16 KB
constexpr uint32_t kHalfQueryBytes = kQueryChunkBytes / 2;      // one warpgroup's rows
constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// Dynamic shared memory, byte offsets from a 1024-aligned start (the
// 128-byte swizzle repeats every 8 rows = 1024 bytes).
struct Layout {
  uint32_t query;        // resident query chunks (kc * 16 KB), or none
  uint32_t stages;       // kStages x stage_bytes
  uint32_t stage_bytes;  // base chunk, then (streamed) the query chunk
  uint32_t cols;         // kStages x 64 column terms (f32)
  uint32_t bars;         // full[kStages], empty[kStages], query
  uint32_t total;
};

__host__ __device__ inline Layout layout_for(int chunks) {
  const bool resident = chunks <= kResidentChunks;
  Layout L;
  L.query = 0;
  L.stages = resident ? chunks * kQueryChunkBytes : 0;
  L.stage_bytes = kBaseChunkBytes + (resident ? 0 : kQueryChunkBytes);
  L.cols = L.stages + kStages * L.stage_bytes;
  L.bars = L.cols + kStages * kTileRows * 4;
  L.total = L.bars + (2 * kStages + 1) * 8;
  return L;
}

// kMasked = false: rows >= n_valid are masked (invalid unused).
// kMasked = true: rows with invalid[r] > 0.5, or r >= N, are masked.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads, 1)
lane_scan_kernel(const __grid_constant__ CUtensorMap q_map,  // [B, D] bf16
                 const __grid_constant__ CUtensorMap b_map,  // [N, D] bf16
                 const int* __restrict__ self_idx,   // [B] or nullptr
                 const float* __restrict__ bsq,      // [N]
                 const float* __restrict__ invalid,  // [N] (kMasked)
                 float* __restrict__ d1o, int* __restrict__ i1o,
                 float* __restrict__ d2o, int* __restrict__ i2o,
                 int64_t ostride,  // output row stride, >= 1024
                 int B, int D, int64_t N, int n_valid, int grid_tiles,
                 int metric) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int chunks = (D + kChunk - 1) / kChunk;
  const bool resident = chunks <= kResidentChunks;
  const Layout L = layout_for(chunks);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  float* cols = reinterpret_cast<float*>(smem + L.cols);
  const int q0 = blockIdx.x * kQueryRows;
  const int lane0 = blockIdx.y * kTileRows;
  const int wg = threadIdx.x / 128;
  const float inf = __int_as_float(0x7f800000);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes (+ TMA bytes)
      mbar_init(&empty[s], 8);  // one lane of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer: one warp feeds the ring ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x & 31;
      if (resident && lane == 0) {
        mbar_arrive_tx(qbar, chunks * kQueryChunkBytes);
        for (int kc = 0; kc < chunks; ++kc)
          tma_load(smem + L.query + kc * kQueryChunkBytes, &q_map, qbar,
                   kc * kChunk, q0);
      }
      // lane owns rows 2 lane and 2 lane + 1 of every tile
      auto col_term = [&](int t, int j) -> float {
        const int64_t r = static_cast<int64_t>(t) * kLanes + lane0 + 2 * lane + j;
        bool masked;
        if (kMasked) {
          masked = r >= N || invalid[r] > 0.5f;
        } else {
          masked = r >= n_valid;
        }
        if (masked) return inf;
        return metric == kL2 ? bsq[r] : 0.f;
      };
      float n0 = 0.f, n1 = 0.f;
      if (grid_tiles > 0) { n0 = col_term(0, 0); n1 = col_term(0, 1); }
      const uint32_t bytes =
          kBaseChunkBytes + (resident ? 0u : kQueryChunkBytes);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < grid_tiles; ++t) {
        const float c0 = n0, c1 = n1;
        if (t + 1 < grid_tiles) {  // loads in flight while the ring is full
          n0 = col_term(t + 1, 0);
          n1 = col_term(t + 1, 1);
        }
        for (int kc = 0; kc < chunks; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          if (kc == 0)
            reinterpret_cast<float2*>(cols + stage * kTileRows)[lane] =
                make_float2(c0, c1);
          if (lane == 0) {
            uint8_t* buf = smem + L.stages + stage * L.stage_bytes;
            mbar_arrive_tx(&full[stage], bytes);
            tma_load(buf, &b_map, &full[stage], kc * kChunk,
                     t * kLanes + lane0);
            if (!resident)
              tma_load(buf + kBaseChunkBytes, &q_map, &full[stage],
                       kc * kChunk, q0);
          } else {
            mbar_arrive(&full[stage]);
          }
          if (++stage == kStages) { stage = 0; phase ^= 1; }
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
    const int self_a = self_idx != nullptr && qa < B ? self_idx[qa] : -1;
    const int self_b = self_idx != nullptr && qb < B ? self_idx[qb] : -1;
    const float f = metric == kL2 ? 2.f : 1.f;

    float acc[32];
    float d1[32], d2[32];
    uint32_t tp[32];  // t1 in the low half, t2 in the high half
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      acc[j] = 0.f; d1[j] = inf; d2[j] = inf; tp[j] = 0xffffffffu;
    }
    if (resident) mbar_wait(qbar, 0);
    const uint32_t q_res = smem_u32(smem + L.query) + wg * kHalfQueryBytes;

    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < grid_tiles; ++t) {
      const int row0 = t * kLanes + lane0;
      float c[16];
      int prev = 0;
      for (int kc = 0; kc < chunks; ++kc) {
        mbar_wait(&full[stage], phase);
        if (kc == 0) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float2 v = *reinterpret_cast<const float2*>(
                cols + stage * kTileRows + 8 * i + colx);
            c[2 * i] = v.x;
            c[2 * i + 1] = v.y;
          }
        }
        const uint32_t b_addr = smem_u32(smem + L.stages + stage * L.stage_bytes);
        const uint32_t a_addr =
            resident ? q_res + kc * kQueryChunkBytes
                     : b_addr + kBaseChunkBytes + wg * kHalfQueryBytes;
        const int ksteps = min(4, (D - kc * kChunk + 15) / 16);
        fence_acc(acc);
        wgmma_fence();
        for (int k = 0; k < ksteps; ++k)
          wgmma_m64n64k16(acc, sw128_desc(a_addr + 32 * k),
                          sw128_desc(b_addr + 32 * k), (kc | k) != 0);
        wgmma_commit();
        if (kc > 0) {  // the previous chunk's products are done: release it
          wgmma_wait<1>();
          __syncwarp();
          if (l == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      __syncwarp();
      if (l == 0) mbar_arrive(&empty[prev]);

      // the query's own row never enters its lanes: a -inf product scores +inf
      if (static_cast<unsigned>(self_a - row0) < kTileRows ||
          static_cast<unsigned>(self_b - row0) < kTileRows) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int r = row0 + 8 * (j >> 2) + colx + (j & 1);
          if (r == ((j & 2) ? self_b : self_a)) acc[j] = -inf;
        }
      }
      // _fold_best_two: the displaced best becomes a second-best candidate
      const uint32_t tt = static_cast<uint32_t>(t);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float s =
            __fsub_rn(c[2 * (j >> 2) + (j & 1)], __fmul_rn(f, acc[j]));
        fold_best_two(d1[j], d2[j], tp[j], s, tt);
      }
    }

#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int b = (j & 2) ? qb : qa;
      if (b >= B) continue;
      const int lane = lane0 + 8 * (j >> 2) + colx + (j & 1);
      const int64_t o = static_cast<int64_t>(b) * ostride + lane;
      d1o[o] = d1[j];
      d2o[o] = d2[j];
      i1o[o] = lane_row(tp[j] & 0xffffu, lane);
      i2o[o] = lane_row(tp[j] >> 16, lane);
    }
  }
}

template <bool kMasked>
int launch(const void* q, const void* self_idx, const void* base,
           const void* bsq, const void* invalid, void* d1, void* i1, void* d2,
           void* i2, long long ostride, int B, int D, long long N,
           int n_valid, int grid_tiles, int metric, int aligned,
           void* stream) {
  if (B <= 0) return 0;
  if (!aligned || D <= 0 || D % 8 != 0 || grid_tiles < 0 ||
      grid_tiles > kMaxLaneTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap q_map, b_map;
  // with no tile to scan the base map is never read: describe the queries
  const bool scan = grid_tiles > 0;
  if (!encode(fn, &q_map, kType, 2, q, B, D, kQueryRows) ||
      !encode(fn, &b_map, kType, 2, scan ? base : q, scan ? N : B, D,
              kTileRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(layout_for((D + kChunk - 1) / kChunk).total) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      lane_scan_kernel<kMasked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kQueryRows - 1) / kQueryRows, kLanes / kTileRows);
  lane_scan_kernel<kMasked>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          q_map, b_map, static_cast<const int*>(self_idx),
          static_cast<const float*>(bsq), static_cast<const float*>(invalid),
          static_cast<float*>(d1), static_cast<int*>(i1),
          static_cast<float*>(d2), static_cast<int*>(i2),
          static_cast<int64_t>(ostride), B, D, static_cast<int64_t>(N),
          n_valid, grid_tiles, metric);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scnt_knn_lane_scan(const void* q, const void* self_idx,
                                  const void* base, const void* bsq,
                                  void* d1, void* i1, void* d2, void* i2,
                                  int B, int D, long long N, int n_valid,
                                  int grid_tiles, int metric, int aligned,
                                  void* stream) {
  return launch<false>(q, self_idx, base, bsq, nullptr, d1, i1, d2, i2,
                       kLanes, B, D, N, n_valid, grid_tiles, metric, aligned,
                       stream);
}

extern "C" int scnt_knn_lane_scan_masked(const void* q, const void* self_idx,
                                         const void* base, const void* bsq,
                                         const void* invalid, void* d1,
                                         void* i1, void* d2, void* i2, int B,
                                         int D, long long N, int grid_tiles,
                                         int metric, int aligned,
                                         void* stream) {
  return launch<true>(q, self_idx, base, bsq, invalid, d1, i1, d2, i2,
                      kLanes, B, D, N, 0, grid_tiles, metric, aligned,
                      stream);
}

// d / i: [B, 2048], best in columns [0, 1024), second best in [1024, 2048).
extern "C" int scnt_lane_topk_scan(const void* q, const void* base,
                                   const void* bsq, const void* invalid,
                                   void* d, void* i, int B, int D,
                                   long long N, int grid_tiles, int metric,
                                   int aligned, void* stream) {
  return launch<true>(q, nullptr, base, bsq, invalid, d,
                      i, static_cast<float*>(d) + kLanes,
                      static_cast<int*>(i) + kLanes, 2 * kLanes, B, D, N, 0,
                      grid_tiles, metric, aligned, stream);
}
