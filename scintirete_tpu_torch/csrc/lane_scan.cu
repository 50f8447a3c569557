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
// Both entries launch ONE templated kernel body (same register budget);
// the mask mode is the template argument. The wrappers keep the Pallas
// wrappers' tail: the exact top-c of the 2048 lane winners and the
// finalization.
//
// Lane contract: base row r folds into lane r mod 1024, rows are folded in
// tile order (r = t * 1024 + lane for t = 0, 1, ...) with strict <, so every
// lane keeps the same two survivors as _fold_best_two on the TPU. Scores
// are s = b^2 - 2 dot (L2) or -dot (cosine on normalized rows, IP), with
// bf16 inputs and f32 sums; masked rows and a query's own row score +inf
// and never enter a lane.
//
// What bounds it on an H100: the products. One 2048-row query block
// against a 1M-row base is 2 * 2048 * 1M * 128 = 0.55 Tflop, while the
// base streams 256 MB from device memory once per 64-query tile (mostly
// from L2 across the query tiles scheduled together): far above the
// bytes-per-flop line, so the scan is bound by how fast the products run.
// The masked mode adds one f32 mask read per base row and query tile,
// which is noise beside the 64 x 128 products it gates.
//
// What the design does about it: blocks are (64-query tile) x (64-lane
// range); each block walks the tiles IN ORDER, which is what the lane
// contract needs, staging 64 base rows per tile through shared memory and
// running a 4 x 4 register-blocked f32 product per thread on the CUDA cores
// (bf16 widened exactly to f32). The running (d1, i1, d2, i2) of each of a
// thread's 16 (query, lane) pairs stay in registers for the whole walk;
// the [B, N] score matrix never exists. Tensor cores (wgmma on bf16) are
// the next step for this kernel, not taken in this first version.
#include "tile_common.cuh"

namespace {

using namespace scnt;

constexpr int kL2 = 1;
constexpr int kLanes = 1024;

// kMasked = false: rows >= n_valid are masked (invalid unused).
// kMasked = true: rows with invalid[r] > 0.5, or r >= N, are masked.
template <bool kMasked>
__global__ void __launch_bounds__(THREADS)
knn_lane_kernel(const uint16_t* __restrict__ q,      // [B, D] bf16 bits
                const int* __restrict__ self_idx,    // [B]
                const uint16_t* __restrict__ base,   // [N, D] bf16 bits
                const float* __restrict__ bsq,       // [N]
                const float* __restrict__ invalid,   // [N] (kMasked)
                float* __restrict__ d1o, int* __restrict__ i1o,  // [B, 1024]
                float* __restrict__ d2o, int* __restrict__ i2o,
                int B, int D, int64_t N, int n_valid, int grid_tiles,
                int metric, bool aligned) {
  __shared__ __align__(16) float sq[KC][TQ];
  __shared__ __align__(16) float sb[KC][TB];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int lane0 = blockIdx.x * TB;
  const int q0 = blockIdx.y * TQ;
  const float inf = __int_as_float(0x7f800000);

  int self_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = q0 + ty * 4 + i;
    self_row[i] = b < B ? self_idx[b] : -1;
  }
  float d1[4][4], d2[4][4];
  int i1[4][4], i2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      d1[i][j] = inf; d2[i][j] = inf; i1[i][j] = -1; i2[i][j] = -1;
    }

  for (int t = 0; t < grid_tiles; ++t) {
    const int64_t row0 = static_cast<int64_t>(t) * kLanes + lane0;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < D; k0 += KC) {
      stage(sq, q, q0, B, D, k0, aligned);
      stage(sb, base, row0, N, D, k0, aligned);
      __syncthreads();
      mma_slice(sq, sb, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = static_cast<int>(row0) + tx * 4 + j;
      const bool in_base = r < N;
      const float br = metric == kL2 && in_base ? bsq[r] : 0.f;
      const bool masked =
          kMasked ? !in_base || invalid[r] > 0.5f : r >= n_valid;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = metric == kL2 ? __fsub_rn(br, __fmul_rn(2.0f, acc[i][j]))
                                : -acc[i][j];
        if (masked || r == self_row[i]) s = inf;
        // _fold_best_two: the displaced best becomes a second-best candidate
        const bool promoted = s < d1[i][j];
        const float mid_d = promoted ? d1[i][j] : s;
        const int mid_i = promoted ? i1[i][j] : r;
        if (promoted) { d1[i][j] = s; i1[i][j] = r; }
        if (mid_d < d2[i][j]) { d2[i][j] = mid_d; i2[i][j] = mid_i; }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = q0 + ty * 4 + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t o = static_cast<int64_t>(b) * kLanes + lane0 + tx * 4 + j;
      d1o[o] = d1[i][j]; i1o[o] = i1[i][j];
      d2o[o] = d2[i][j]; i2o[o] = i2[i][j];
    }
  }
}

template <bool kMasked>
int launch(const void* q, const void* self_idx, const void* base,
           const void* bsq, const void* invalid, void* d1, void* i1, void* d2,
           void* i2, int B, int D, long long N, int n_valid, int grid_tiles,
           int metric, int aligned, void* stream) {
  if (B <= 0) return 0;
  dim3 grid(kLanes / TB, (B + TQ - 1) / TQ);
  knn_lane_kernel<kMasked>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint16_t*>(q), static_cast<const int*>(self_idx),
          static_cast<const uint16_t*>(base), static_cast<const float*>(bsq),
          static_cast<const float*>(invalid), static_cast<float*>(d1),
          static_cast<int*>(i1), static_cast<float*>(d2),
          static_cast<int*>(i2), B, D, static_cast<int64_t>(N), n_valid,
          grid_tiles, metric, aligned != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scnt_knn_lane_scan(const void* q, const void* self_idx,
                                  const void* base, const void* bsq,
                                  void* d1, void* i1, void* d2, void* i2,
                                  int B, int D, long long N, int n_valid,
                                  int grid_tiles, int metric, int aligned,
                                  void* stream) {
  return launch<false>(q, self_idx, base, bsq, nullptr, d1, i1, d2, i2, B, D,
                       N, n_valid, grid_tiles, metric, aligned, stream);
}

extern "C" int scnt_knn_lane_scan_masked(const void* q, const void* self_idx,
                                         const void* base, const void* bsq,
                                         const void* invalid, void* d1,
                                         void* i1, void* d2, void* i2, int B,
                                         int D, long long N, int grid_tiles,
                                         int metric, int aligned,
                                         void* stream) {
  return launch<true>(q, self_idx, base, bsq, invalid, d1, i1, d2, i2, B, D,
                      N, 0, grid_tiles, metric, aligned, stream);
}
