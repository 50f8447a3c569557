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
//   scnt_flat_lane_int8. The int8 product with the unpacked best-two fold
//   (_fold_best_two) on (score, row id); invalid rows score +inf.
// (lane_topk_scan, the unpacked bf16 scan, is the third entry point of
// lane_scan.cu: its body is the masked graph-build scan without a self row.)
//
// Packed keys: the low 13 mantissa bits of the f32 score are replaced by
// the tile index, and the fold is k1' = min(k1, key),
// k2' = min(k2, max(k1, key)). A key must never be NaN: fminf / fmaxf drop
// a NaN operand where the TPU's minimum keeps it, so the two would part
// ways silently. The bf16 body therefore tests NaN BEFORE it clamps (a
// clamp through fmaxf would turn NaN into -3e38, the best score there is).
//
// Lane contract, shared with lane_scan.cu: base row r folds into lane
// r mod 1024 and tiles are walked IN ORDER, so every lane keeps the two
// survivors the TPU kernel keeps. Outputs are [B, 2048]: best in columns
// [0, 1024), second best in [1024, 2048); the i32 output holds the row
// read back from the key (-1 where key >= 1.5e38) or the folded row id.
//
// What bounds it on an H100: the products. 1024 queries against 1M rows of
// depth 128 are 0.27 Tflop while the base streams 128 MB (int8) or 256 MB
// (bf16) once per 64-query tile, mostly out of L2: far above the card's
// bytes-per-operation line. The first version here runs the int8 product
// with __dp4a on the CUDA cores (4 multiply-adds per instruction, exact in
// s32) and the bf16 product as f32 FMAs on exactly widened inputs, in the
// block layout of lane_scan.cu: (64 queries) x (64 lanes) per block, each
// thread owning 4 x 4 (query, lane) pairs whose running state stays in
// registers for the whole walk; the [B, N] score matrix never exists. The
// tensor cores (wgmma on bf16, s8 mma) are the next step, not taken here.
// Score arithmetic uses __fmul_rn / __fsub_rn so no multiply is contracted
// into an FMA: the int8 scans then equal their plain versions bit for bit.
#include "tile_common.cuh"

namespace {

using namespace scnt;

constexpr int kL2 = 1;
constexpr int kLanes = 1024;
constexpr int kTileMask = (1 << 13) - 1;
constexpr float kSentinel = 3.0e38f;
constexpr int KW = 16;  // 32-bit words (4 int8 each) of depth per slice

enum Mode { kPackedBf16 = 0, kPackedInt8 = 1, kLaneInt8 = 2 };

// Stage rows [row0, row0 + 64) x depth bytes [k0, k0 + 4 KW) of a row-major
// int8 [nrows, D] matrix into s[KW][64] as packed words (4 consecutive
// depth values each). Rows >= nrows and depth >= D read as 0.
__device__ __forceinline__ void stage_i8(uint32_t (*s)[TB], const int8_t* m,
                                         int64_t row0, int64_t nrows, int D,
                                         int k0, bool aligned) {
  const int t = threadIdx.x;
  const int r = t & 63;
  const int w0 = (t >> 6) * 4;  // 0, 4, 8, 12: four threads cover KW
  const int64_t row = row0 + r;
  const int k = k0 + w0 * 4;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (row < nrows && k < D) {
    const int8_t* p = m + row * D + k;
    if (aligned && D - k >= 16) {
      const uint4 a = *reinterpret_cast<const uint4*>(p);
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (k + j < D)
          w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j]))
                       << (8 * (j & 3));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) s[w0 + j][r] = w[j];
}

// acc[i][j] += s8 dot over one staged slice (4 depth values per __dp4a).
__device__ __forceinline__ void mma_slice_i8(uint32_t (*sq)[TQ],
                                             uint32_t (*sb)[TB], int ty,
                                             int tx, int acc[4][4]) {
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    const uint4 a = *reinterpret_cast<const uint4*>(&sq[k][ty * 4]);
    const uint4 b = *reinterpret_cast<const uint4*>(&sb[k][tx * 4]);
    const int av[4] = {static_cast<int>(a.x), static_cast<int>(a.y),
                       static_cast<int>(a.z), static_cast<int>(a.w)};
    const int bv[4] = {static_cast<int>(b.x), static_cast<int>(b.y),
                       static_cast<int>(b.z), static_cast<int>(b.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ float pack_key(float s, int tile) {
  return __int_as_float((__float_as_int(s) & ~kTileMask) | tile);
}

// q / base: bf16 bits (kPackedBf16) or int8 (the int8 modes). qs [B]: 2 x
// the clamped query scale (kPackedInt8), the query scale (kLaneInt8). bs
// [N]: per-row scale (int8 modes). invalid [N]: kPackedBf16 and kLaneInt8.
template <int kMode>
__global__ void __launch_bounds__(THREADS)
flat_lane_kernel(const void* __restrict__ q, const float* __restrict__ qs,
                 const void* __restrict__ base, const float* __restrict__ bs,
                 const float* __restrict__ bsq,
                 const float* __restrict__ invalid,
                 float* __restrict__ out_f,  // [B, 2048]
                 int* __restrict__ out_i,    // [B, 2048]
                 int B, int D, int64_t N, int tiles, int group, int metric,
                 bool aligned) {
  __shared__ __align__(16) uint32_t smem_q[KC][TQ];
  __shared__ __align__(16) uint32_t smem_b[KC][TB];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int lane0 = blockIdx.x * TB;
  const int q0 = blockIdx.y * TQ;
  const float inf = __int_as_float(0x7f800000);
  constexpr bool kPacked = kMode != kLaneInt8;
  const float empty = kPacked ? kSentinel : inf;

  float qscale[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = q0 + ty * 4 + i;
    qscale[i] = (kMode != kPackedBf16 && b < B) ? qs[b] : 0.f;
  }
  // packed: (v1, v2) = (k1, k2), and (m, mi) the group's running minimum
  // with its tile; unpacked: (v1, r1, v2, r2) = (d1, i1, d2, i2)
  float v1[4][4], v2[4][4], m[4][4];
  int r1[4][4], r2[4][4], mi[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v1[i][j] = empty; v2[i][j] = empty; m[i][j] = 0.f;
      r1[i][j] = -1; r2[i][j] = -1; mi[i][j] = 0;
    }

  for (int t = 0; t < tiles; ++t) {
    const int64_t row0 = static_cast<int64_t>(t) * kLanes + lane0;
    float dots[4][4];
    if constexpr (kMode == kPackedBf16) {
      float (*sq)[TQ] = reinterpret_cast<float (*)[TQ]>(smem_q);
      float (*sb)[TB] = reinterpret_cast<float (*)[TB]>(smem_b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dots[i][j] = 0.f;
      for (int k0 = 0; k0 < D; k0 += KC) {
        stage(sq, static_cast<const uint16_t*>(q), q0, B, D, k0, aligned);
        stage(sb, static_cast<const uint16_t*>(base), row0, N, D, k0,
              aligned);
        __syncthreads();
        mma_slice(sq, sb, ty, tx, dots);
        __syncthreads();
      }
    } else {
      int acc[4][4] = {};
      for (int k0 = 0; k0 < D; k0 += 4 * KW) {
        stage_i8(smem_q, static_cast<const int8_t*>(q), q0, B, D, k0,
                 aligned);
        stage_i8(smem_b, static_cast<const int8_t*>(base), row0, N, D, k0,
                 aligned);
        __syncthreads();
        mma_slice_i8(smem_q, smem_b, ty, tx, acc);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dots[i][j] = __int2float_rn(acc[i][j]);
    }

    const bool group_start = t % group == 0;
    const bool group_end = t % group == group - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = static_cast<int>(row0) + tx * 4 + j;
      const bool in_base = r < N;
      if constexpr (kMode == kPackedBf16) {
        const float br = metric == kL2 && in_base ? bsq[r] : 0.f;
        const bool bad = !in_base || invalid[r] > 0.5f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float s = metric == kL2
                        ? __fsub_rn(br, __fmul_rn(2.0f, dots[i][j]))
                        : -dots[i][j];
          if (bad || s != s) s = kSentinel;
          s = fminf(fmaxf(s, -kSentinel), kSentinel);
          const float key = pack_key(s, t);
          const float k1_old = v1[i][j];
          v1[i][j] = fminf(k1_old, key);
          v2[i][j] = fminf(v2[i][j], fmaxf(k1_old, key));
        }
      } else if constexpr (kMode == kPackedInt8) {
        const float scale = in_base ? bs[r] : 0.f;
        const float br = in_base ? bsq[r] : kSentinel;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w =
              metric == kL2 ? __fmul_rn(qscale[i], scale) : scale;
          const float s = __fsub_rn(br, __fmul_rn(dots[i][j], w));
          if (group_start || s < m[i][j]) mi[i][j] = t;
          m[i][j] = group_start ? s : fminf(s, m[i][j]);
          if (group_end) {
            const float key = pack_key(m[i][j], mi[i][j]);
            const float k1_old = v1[i][j];
            v1[i][j] = fminf(k1_old, key);
            v2[i][j] = fminf(v2[i][j], fmaxf(k1_old, key));
          }
        }
      } else {
        const float scale = in_base ? bs[r] : 0.f;
        const float br = metric == kL2 && in_base ? bsq[r] : 0.f;
        const bool bad = !in_base || invalid[r] > 0.5f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float s =
              metric == kL2
                  ? __fsub_rn(br, __fmul_rn(__fmul_rn(2.0f, dots[i][j]),
                                            __fmul_rn(qscale[i], scale)))
                  : __fmul_rn(-dots[i][j], scale);
          if (bad) s = inf;
          // _fold_best_two: the displaced best becomes a second-best
          // candidate
          const bool promoted = s < v1[i][j];
          const float mid_d = promoted ? v1[i][j] : s;
          const int mid_i = promoted ? r1[i][j] : r;
          if (promoted) { v1[i][j] = s; r1[i][j] = r; }
          if (mid_d < v2[i][j]) { v2[i][j] = mid_d; r2[i][j] = mid_i; }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = q0 + ty * 4 + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lane = lane0 + tx * 4 + j;
      const int64_t o = static_cast<int64_t>(b) * (2 * kLanes) + lane;
      if constexpr (kPacked) {
        // unpack_lane_keys: row = embedded tile * 1024 + lane
        const float k1 = v1[i][j], k2 = v2[i][j];
        r1[i][j] = k1 < 0.5f * kSentinel
                       ? (__float_as_int(k1) & kTileMask) * kLanes + lane
                       : -1;
        r2[i][j] = k2 < 0.5f * kSentinel
                       ? (__float_as_int(k2) & kTileMask) * kLanes + lane
                       : -1;
      }
      out_f[o] = v1[i][j]; out_i[o] = r1[i][j];
      out_f[o + kLanes] = v2[i][j]; out_i[o + kLanes] = r2[i][j];
    }
  }
}

template <int kMode>
int launch(const void* q, const void* qs, const void* base, const void* bs,
           const void* bsq, const void* invalid, void* out_f, void* out_i,
           int B, int D, long long N, int tiles, int group, int metric,
           int aligned, void* stream) {
  if (B <= 0) return 0;
  if (group < 1) group = 1;
  dim3 grid(kLanes / TB, (B + TQ - 1) / TQ);
  flat_lane_kernel<kMode>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          q, static_cast<const float*>(qs), base,
          static_cast<const float*>(bs), static_cast<const float*>(bsq),
          static_cast<const float*>(invalid), static_cast<float*>(out_f),
          static_cast<int*>(out_i), B, D, static_cast<int64_t>(N), tiles,
          group, metric, aligned != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SCNT_FLAT_ENTRY(name, mode)                                          \
  extern "C" int name(const void* q, const void* qs, const void* base,       \
                      const void* bs, const void* bsq, const void* invalid,  \
                      void* out_f, void* out_i, int B, int D, long long N,   \
                      int tiles, int group, int metric, int aligned,         \
                      void* stream) {                                        \
    return launch<mode>(q, qs, base, bs, bsq, invalid, out_f, out_i, B, D,   \
                        N, tiles, group, metric, aligned, stream);           \
  }

SCNT_FLAT_ENTRY(scnt_flat_packed_bf16, kPackedBf16)
SCNT_FLAT_ENTRY(scnt_flat_packed_int8, kPackedInt8)
SCNT_FLAT_ENTRY(scnt_flat_lane_int8, kLaneInt8)
