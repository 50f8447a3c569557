// Pivot-entry scan: for each of B queries, the pivot (of R) with the least
// comparison-form distance, ties to the lowest pivot index.
//
// Replaces: scintirete_tpu/ops/pallas_pivot.py, pivot_entry_scan (kernel
// body _pivot_scan_kernel), the entry step of the pivot search
// (index/device.py _search_kernel_pivot).
//
// What bounds it on an H100: the f32 products. At the serving shapes
// (B <= 256, R = 65,536 .. 262,144, D = 128) the pivot matrix is 32-134 MB
// and is read B / 64 times, mostly from L2, while the products are
// 2 * B * R * D flops in true f32 (the distance enters the beam's candidate
// list, so no TF32 and no bf16). That is CUDA-core f32 work.
//
// What the design does about it: blocks are (64-query tile) x (chunk of
// pivots); each block stages its query tile and 64-pivot tiles through
// shared memory and runs a 4 x 4 register-blocked product per thread, so
// the [B, R] score matrix never exists in device memory. The per-query
// minimum is reduced across blocks in ONE pass with a 64-bit atomicMin on
// the key (order-preserving uint32 image of d) << 32 | pivot index, which
// gives the lowest-index tie rule of the Pallas kernel (argmin inside a
// tile, strict < across tiles) without a second pass. The caller maps a
// +inf minimum (every pivot deleted) to index -1.
#include "tile_common.cuh"

namespace {

using namespace scnt;

constexpr int kL2 = 1, kIP = 3;  // else cosine (2)
constexpr int kTilesPerBlock = 8;  // 512 pivots per block

__device__ __forceinline__ unsigned long long make_key(float d, int idx) {
  d = d + 0.0f;  // -0.0 -> +0.0: the Pallas kernel compares them as equal
  uint32_t bits = __float_as_uint(d);
  uint32_t mono = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<unsigned long long>(mono) << 32) |
         static_cast<uint32_t>(idx);
}

__global__ void __launch_bounds__(THREADS)
pivot_scan_kernel(const float* __restrict__ q,       // [B, D]
                  const float* __restrict__ qsq,     // [B]
                  const float* __restrict__ piv,     // [R, D]
                  const float* __restrict__ psq,     // [R]
                  const float* __restrict__ pdel,    // [R], > 0.5 = deleted
                  unsigned long long* __restrict__ keys,  // [B], in/out
                  int B, int R, int D, int metric, bool aligned) {
  __shared__ __align__(16) float sq[KC][TQ];
  __shared__ __align__(16) float sp[KC][TB];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.y * TQ;
  const int p_begin = blockIdx.x * (TB * kTilesPerBlock);
  const int p_end = min(R, p_begin + TB * kTilesPerBlock);

  float qs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = q0 + ty * 4 + i;
    qs[i] = b < B ? qsq[b] : 0.f;
  }
  unsigned long long best[4] = {~0ull, ~0ull, ~0ull, ~0ull};

  for (int p0 = p_begin; p0 < p_end; p0 += TB) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < D; k0 += KC) {
      stage(sq, q, q0, B, D, k0, aligned);
      stage(sp, piv, p0, R, D, k0, aligned);
      __syncthreads();
      mma_slice(sq, sp, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = p0 + tx * 4 + j;
      if (r >= p_end) continue;
      const bool dead = pdel[r] > 0.5f;
      const float pr = psq[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dot = acc[i][j];
        float d;
        if (metric == kIP) {
          d = -dot;
        } else if (metric == kL2) {
          // (q^2 + p^2) - 2 dot, rounded as the Pallas kernel writes it
          d = __fsub_rn(__fadd_rn(qs[i], pr), __fmul_rn(2.0f, dot));
        } else {
          d = __fsub_rn(1.0f, dot);  // cosine on pre-normalized rows
        }
        if (dead) d = __int_as_float(0x7f800000);  // +inf
        const unsigned long long key = make_key(d, r);
        best[i] = key < best[i] ? key : best[i];
      }
    }
  }

  // the 16 threads of one query row group are 16 adjacent lanes of a warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned long long v = best[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
      v = o < v ? o : v;
    }
    const int b = q0 + ty * 4 + i;
    if (tx == 0 && b < B && v != ~0ull) atomicMin(&keys[b], v);
  }
}

}  // namespace

extern "C" int scnt_pivot_entry_scan(const void* q, const void* qsq,
                                     const void* piv, const void* psq,
                                     const void* pdel, void* keys, int B,
                                     int R, int D, int metric, int aligned,
                                     void* stream) {
  if (B <= 0 || R <= 0) return 0;
  dim3 grid((R + TB * kTilesPerBlock - 1) / (TB * kTilesPerBlock),
            (B + TQ - 1) / TQ);
  pivot_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(qsq),
      static_cast<const float*>(piv), static_cast<const float*>(psq),
      static_cast<const float*>(pdel),
      static_cast<unsigned long long*>(keys), B, R, D, metric, aligned != 0);
  return static_cast<int>(cudaGetLastError());
}
