// Hopper building blocks shared by the port's scans (lane_scan.cu,
// flat_scan.cu, pivot_scan.cu): mbarriers, TMA tile and bulk loads, wgmma
// (bf16 and s8) on operands in shared memory with the 128-byte swizzle, the
// unpacked lane fold, and the tensor-map encoder, looked up through the
// CUDA runtime so that a library links nothing beyond it. sm_90a only
// (wgmma).
//
// Operand layout: a tile is stored as rows of 128 bytes (64 bf16 or 128
// int8 values of depth), the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_
// 128B; eight rows form a 1024-byte swizzle atom. One wgmma k-step reads 32
// bytes of depth (k16 in bf16, k32 in s8), so a 128-byte row is four
// k-steps, and the descriptor of step k starts 32 k bytes into the row.
#pragma once

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One 128-byte-wide x rows box of a 2-D tensor map into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes from global to shared memory
// (both 16-byte aligned); completion is counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile stored as 128-byte rows
// with the 128-byte swizzle, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |            // leading offset (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |    // stride offset
         (static_cast<uint64_t>(1) << 62);             // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma (it sees only the issuing asm statement).
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 64] (+)= A[64 x 16] * B[64 x 16]^T in bf16 with f32 sums, both
// K-major in shared memory; scale_d = 0 starts the sum afresh.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 32] * B[64 x 32]^T in s8 with s32 sums (exact),
// both K-major in shared memory (the only layout 8-bit wgmma takes).
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// _fold_best_two on one (query, lane) pair, in the state the unpacked lane
// scans keep: (d1, d2) the lane's best and second score, their tiles as
// 16-bit ids in tp (t1 in the low half, t2 in the high half, kNoTile =
// empty). Tiles are folded in order with strict <: an equal later score
// never displaces an earlier one, the displaced best is offered to the
// second slot, and a NaN or +inf score never enters.
constexpr uint32_t kNoTile = 0xffffu;
constexpr int kMaxLaneTiles = 65535;  // tiles one launch can name

__device__ __forceinline__ void fold_best_two(float& d1, float& d2,
                                              uint32_t& tp, float s,
                                              uint32_t t) {
  const bool promoted = s < d1;
  const float mid_d = promoted ? d1 : s;
  const uint32_t mid_t = promoted ? tp : t;  // low half
  if (promoted) {
    d1 = s;
    tp = __byte_perm(tp, t, 0x3254);  // low half <- t
  }
  if (mid_d < d2) {
    d2 = mid_d;
    tp = __byte_perm(tp, mid_t, 0x5410);  // high half <- mid
  }
}

// The base row of tile id t in `lane`, -1 for an empty slot.
__device__ __forceinline__ int lane_row(uint32_t t, int lane) {
  return t == kNoTile ? -1 : static_cast<int>(t) * 1024 + lane;
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so that the
// library links nothing beyond the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess && p)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [rows, cols] row-major matrix of `elem_bytes`-byte values (f32: 4, bf16:
// 2, int8 as UINT8: 1, which TMA copies unchanged) in boxes of 128 bytes x
// box_rows rows, 128-byte swizzle, out-of-bounds elements read as zero.
inline bool encode(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type,
                   int elem_bytes, const void* ptr, long long rows, int cols,
                   int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
