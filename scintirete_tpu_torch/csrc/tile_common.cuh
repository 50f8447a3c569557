// Shared building blocks of the port's CUDA-core scan kernels (pivot_scan.cu
// and flat_scan.cu's lane_topk_scan_int8; the other scans run on the tensor
// cores, hopper_common.cuh): a 64 x 64 score
// tile computed by 256 threads on the CUDA cores, each thread owning a
// 4 x 4 block of (query row, base row) scores accumulated in f32.
//
// Both operands are staged through shared memory in depth slices of KC
// values, transposed to [k][row] so that the inner loop reads one float4 of
// query rows and one float4 of base rows per step (16 FMAs per two shared
// loads). Inputs are f32 or bf16; bf16 values are widened to f32 exactly
// (a bf16 x bf16 product is exact in f32), so the only rounding is the f32
// sum, taken in another order than on the TPU.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace scnt {

constexpr int TQ = 64;         // query rows per block
constexpr int TB = 64;         // base rows per tile step
constexpr int KC = 32;         // depth staged per shared-memory slice
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 scores each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// 8 consecutive values of one row, widened to f32. `vec` promises that the
// row start is 16-byte aligned and that all 8 values lie inside the row.
__device__ __forceinline__ void load8(const float* p, bool vec, int valid,
                                      float v[8]) {
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < valid ? p[j] : 0.f;
  }
}

__device__ __forceinline__ void load8(const uint16_t* p, bool vec, int valid,
                                      float v[8]) {
  if (vec) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[0];
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < valid ? to_f32(p[j]) : 0.f;
  }
}

// Stage rows [row0, row0 + 64) x depth [k0, k0 + KC) of a row-major
// [nrows, D] matrix into s[KC][64] as f32. Rows >= nrows and depth >= D
// read as 0, which adds nothing to a dot product.
template <typename T>
__device__ __forceinline__ void stage(float (*s)[TB], const T* m,
                                      int64_t row0, int64_t nrows, int D,
                                      int k0, bool aligned) {
  const int t = threadIdx.x;
  const int r = t & 63;
  const int kk = (t >> 6) * 8;  // 0, 8, 16, 24: four threads cover KC
  const int64_t row = row0 + r;
  const int k = k0 + kk;
  float v[8];
  if (row < nrows && k < D) {
    const int valid = D - k;
    load8(m + row * D + k, aligned && valid >= 8, valid, v);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) s[kk + j][r] = v[j];
}

// acc[i][j] += dot over one staged slice; thread (ty, tx) owns query rows
// ty*4 .. ty*4+3 and base rows tx*4 .. tx*4+3 of the tile.
__device__ __forceinline__ void mma_slice(float (*sq)[TQ],
                                          float (*sb)[TB], int ty,
                                          int tx, float acc[4][4]) {
#pragma unroll 8
  for (int k = 0; k < KC; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&sq[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&sb[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

}  // namespace scnt
