// Pivot-entry scan: for each of B queries, the pivot (of R) with the least
// comparison-form distance, ties to the lowest pivot index.
//
// Replaces: scintirete_tpu/ops/pallas_pivot.py, pivot_entry_scan (kernel
// body _pivot_scan_kernel), the entry step of the pivot search
// (index/device.py _search_kernel_pivot).
//
// What bounds it on an H100: the f32 products. At the serving shapes
// (B <= 256, R = 65,536 .. 262,144, D = 128) the pivot matrix is 32-134 MB
// and the products are 2 * B * R * D flops in true f32 (the distance enters
// the beam's candidate list, so no TF32 and no bf16): 4.3 Gflop at B = 256,
// R = 65,536, 0.064 ms at the card's 67 Tflop/s. That is CUDA-core FFMA
// work, and the kernel is built to keep the FFMA pipe issuing:
// - a block owns kQ queries (128, or 64 when B <= 64) and a contiguous
//   range of 128-pivot tiles; the grid is query tiles x pivot ranges, one
//   block per SM and one wave while the query tiles are fewer than the SMs;
// - the query tile is copied ONCE into shared memory by TMA and stays
//   there while it fits (D <= 256); deeper queries stream through the
//   ring beside the pivots, 32 columns at a time;
// - one producer thread keeps a ring of pivot chunks (128 rows x 32 f32, one
//   TMA box with the 128-byte swizzle, 16 KB) in flight with mbarriers, so
//   loads overlap the products and no consumer waits on global memory
//   inside the product loop;
// - each of the 256 consumer threads holds an 8 x 8 register tile (kQ / 16
//   queries x 8 pivots, strided by 16): per 4 depth values it reads 8 + 8
//   float4 from shared memory and issues 256 FFMA. The swizzle puts the 16
//   pivot rows a half-warp reads on 16 distinct bank groups; the query reads
//   are broadcasts; setmaxnreg gives the consumers 232 registers (the
//   producer warpgroup 40), so the tile, its operands and the running
//   minima stay in registers;
// - the running minimum stays in registers as (f32 d, i32 pivot), folded
//   in increasing pivot order with strict <, so a tie keeps the lower
//   index, -0 and +0 included. Only at the end of the block's range does it
//   become a 64-bit key (order-preserving image of d + 0.0f) << 32 | index,
//   reduced over the 16 threads of a query and then across blocks by ONE
//   atomicMin per query and block: blocks run in no order, and the key's
//   order gives the lowest-index rule whatever the order;
// - q^2 (L2) is summed in the kernel, from global memory while the ring
//   fills.
// The C entry does the whole call on the caller's stream: sets the keys
// to all ones, scans, and writes (d, i) [B] itself, (+inf, -1) where no
// pivot is live. TMA wants rows of whole 16-byte units from 16-byte aligned
// starts (D % 4 == 0); the wrapper pads any other input with zero columns,
// which change no dot and no norm. Rows past R and depth past D inside a
// box are TMA's zero fill; pivots past R are masked.
#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kL2 = 1, kIP = 3;  // else cosine (2)
constexpr int kPivots = 128;     // pivots a tile = rows of one TMA box
constexpr int kChunk = 32;       // depth of one box: 32 f32 = one 128-byte swizzle row
constexpr int kConsumers = 256;  // warpgroups 0 and 1: 16 x 16 threads
constexpr int kThreads = kConsumers + 128;  // warpgroup 2: the producer
constexpr int kMaxStages = 8;
constexpr int kResidentChunks = 8;  // queries stay in shared memory up to D = 256
constexpr uint32_t kPivotChunkBytes = kPivots * 128;  // 16 KB
constexpr uint32_t kSmemBudget = 200 * 1024;
constexpr int kDevices = 64;  // devices whose launch settings are cached

// Dynamic shared memory, byte offsets from a 1024-aligned start (the
// 128-byte swizzle repeats every 8 rows = 1024 bytes).
struct Layout {
  uint32_t stages;       // nstages x stage_bytes, after the resident queries
  uint32_t stage_bytes;  // pivot chunk, then (streamed) the query chunk
  uint32_t qsq;          // kQ f32
  uint32_t bars;         // full[nstages], empty[nstages], query
  uint32_t total;
  int nstages;
};

template <int kQ>
__host__ __device__ inline Layout layout_for(int chunks) {
  const uint32_t qchunk = kQ * 128;
  const bool resident = chunks <= kResidentChunks;
  Layout L;
  L.stages = resident ? chunks * qchunk : 0;
  L.stage_bytes = kPivotChunkBytes + (resident ? 0 : qchunk);
  const uint32_t fixed = kQ * 4 + (2 * kMaxStages + 1) * 8;
  const int fit = static_cast<int>((kSmemBudget - L.stages - fixed) / L.stage_bytes);
  L.nstages = fit < kMaxStages ? fit : kMaxStages;
  L.qsq = L.stages + L.nstages * L.stage_bytes;
  L.bars = L.qsq + kQ * 4;
  L.total = L.bars + (2 * L.nstages + 1) * 8;
  return L;
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ unsigned long long make_key(float d, int idx) {
  d = d + 0.0f;  // -0.0 -> +0.0: the Pallas kernel compares them as equal
  const uint32_t bits = __float_as_uint(d);
  const uint32_t mono = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<unsigned long long>(mono) << 32) |
         static_cast<uint32_t>(idx);
}

// Block (x, y) = (query tile, range of pivot tiles); keys [B] start at all
// ones and take the atomicMin of every block's key for the query.
template <int kQ>
__global__ void __launch_bounds__(kThreads, 1)
pivot_scan_kernel(const __grid_constant__ CUtensorMap q_map,  // [B, D] f32
                  const __grid_constant__ CUtensorMap p_map,  // [R, D] f32
                  const float* __restrict__ q,     // [B, D], read for q^2
                  const float* __restrict__ psq,   // [R]
                  const float* __restrict__ pdel,  // [R], > 0.5 = deleted
                  unsigned long long* __restrict__ keys,  // [B]
                  int B, int R, int D, int ptiles, int metric) {
  constexpr int kRows = kQ / 16;  // query rows a thread
  constexpr uint32_t kQueryChunkBytes = kQ * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int chunks = (D + kChunk - 1) / kChunk;
  const bool resident = chunks <= kResidentChunks;
  const Layout L = layout_for<kQ>(chunks);
  const int nstages = L.nstages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + nstages;
  uint64_t* qbar = empty + nstages;
  float* qsq_s = reinterpret_cast<float*>(smem + L.qsq);
  const int q0 = blockIdx.x * kQ;
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.y) * ptiles / gridDim.y);
  const int t1 = static_cast<int>(static_cast<long long>(blockIdx.y + 1) * ptiles / gridDim.y);

  if (threadIdx.x == 0) {
    for (int s = 0; s < nstages; ++s) {
      mbar_init(&full[s], 1);   // the producer thread (+ copied bytes)
      mbar_init(&empty[s], kConsumers / 32);  // one lane of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // --------------- producer: one thread feeds the ring ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      if (resident) {
        mbar_arrive_tx(qbar, chunks * kQueryChunkBytes);
        for (int kc = 0; kc < chunks; ++kc)
          tma_load(smem + kc * kQueryChunkBytes, &q_map, qbar, kc * kChunk, q0);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t0; t < t1; ++t) {
        for (int kc = 0; kc < chunks; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* buf = smem + L.stages + stage * L.stage_bytes;
          mbar_arrive_tx(&full[stage], L.stage_bytes);
          tma_load(buf, &p_map, &full[stage], kc * kChunk, t * kPivots);
          if (!resident)
            tma_load(buf + kPivotChunkBytes, &q_map, &full[stage],
                     kc * kChunk, q0);
          if (++stage == nstages) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // ------- consumers: kQ / 16 query rows x 8 pivots a thread, 16 x 16 -------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ty = tid >> 4;  // query rows ty + 16 i
  const int tx = tid & 15;  // pivots p0 + tx + 16 j of every tile
  if (metric == kL2) {  // q^2 of the tile's queries, while the ring fills
    for (int r = tid >> 5; r < kQ; r += kConsumers / 32) {
      float s = 0.f;
      if (q0 + r < B) {
        const float* v = q + static_cast<int64_t>(q0 + r) * D;
        for (int k = lane; k < D; k += 32) s = fmaf(v[k], v[k], s);
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) qsq_s[r] = s;
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  }
  float qs[kRows];
  float best_d[kRows];
  int best_i[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    qs[i] = metric == kL2 ? qsq_s[ty + 16 * i] : 0.f;
    best_d[i] = __int_as_float(0x7f800000);  // +inf: nothing found yet
    best_i[i] = -1;
  }
  if (resident) mbar_wait(qbar, 0);

  // row r of a chunk sits at r * 128 bytes, its 16-byte unit c at unit
  // c ^ (r % 8); r % 8 is ty % 8 for all of a thread's queries, tx % 8 for
  // all of its pivots
  const uint32_t base = smem_u32(smem);
  const uint32_t q_off = ty * 128;
  const uint32_t p_off = tx * 128;
  const int qx = ty & 7, px = tx & 7;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t0; t < t1; ++t) {
    const int p0 = t * kPivots;
    // the tile's pivot terms, loaded before its products and read after
    float pr[8];
    bool live[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = p0 + tx + 16 * j;
      const bool in = r < R;
      live[j] = in && !(pdel[r] > 0.5f);
      pr[j] = in && metric == kL2 ? psq[r] : 0.f;
    }
    float acc[kRows][8];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int kc = 0; kc < chunks; ++kc) {
      mbar_wait(&full[stage], phase);
      const uint32_t p_addr = base + L.stages + stage * L.stage_bytes + p_off;
      const uint32_t q_addr =
          (resident ? base + kc * kQueryChunkBytes
                    : base + L.stages + stage * L.stage_bytes + kPivotChunkBytes) +
          q_off;
#pragma unroll
      for (int c = 0; c < kChunk / 4; ++c) {
        float4 a[kRows], b[8];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          a[i] = lds128(q_addr + i * 16 * 128 + ((c ^ qx) << 4));
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b[j] = lds128(p_addr + j * 16 * 128 + ((c ^ px) << 4));
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
          }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == nstages) { stage = 0; phase ^= 1; }
    }
    // the tile's scores, folded in increasing pivot order (j, then t)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!live[j]) continue;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float dot = acc[i][j];
        float d;
        if (metric == kIP) {
          d = -dot;
        } else if (metric == kL2) {
          // (q^2 + p^2) - 2 dot, rounded as the Pallas kernel writes it
          d = __fsub_rn(__fadd_rn(qs[i], pr[j]), __fmul_rn(2.0f, dot));
        } else {
          d = __fsub_rn(1.0f, dot);  // cosine on pre-normalized rows
        }
        if (d < best_d[i]) {
          best_d[i] = d;
          best_i[i] = p0 + tx + 16 * j;
        }
      }
    }
  }

  // the 16 threads of one query row are 16 adjacent lanes of a warp
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    unsigned long long v = best_i[i] < 0 ? ~0ull : make_key(best_d[i], best_i[i]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
      v = o < v ? o : v;
    }
    const int b = q0 + ty + 16 * i;
    if (tx == 0 && b < B && v != ~0ull) atomicMin(&keys[b], v);
  }
}

// keys [B] -> (d, i) [B]: all ones (no live pivot) -> (+inf, -1).
__global__ void finish_keys(const unsigned long long* __restrict__ keys,
                            float* __restrict__ d, int* __restrict__ idx,
                            int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const unsigned long long key = keys[b];
  if (key == ~0ull) {
    d[b] = __int_as_float(0x7f800000);
    idx[b] = -1;
    return;
  }
  const uint32_t mono = static_cast<uint32_t>(key >> 32);
  d[b] = __uint_as_float((mono & 0x80000000u) ? (mono & 0x7fffffffu) : ~mono);
  idx[b] = static_cast<int>(static_cast<uint32_t>(key));
}

template <int kQ>
cudaError_t scan(const void* q, const void* piv, const void* psq,
                 const void* pdel, void* keys, int B, int R, int D,
                 int metric, cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_map, p_map;
  if (!encode(fn, &q_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, q, B, D, kQ) ||
      !encode(fn, &p_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, piv, R, D,
              kPivots))
    return cudaErrorInvalidValue;
  // the SM count and the largest shared memory granted so far, per device
  static int sms_of[kDevices], smem_of[kDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kDevices) return cudaErrorNotSupported;
  if (sms_of[device] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const int sms = sms_of[device];
  const int smem =
      static_cast<int>(layout_for<kQ>((D + kChunk - 1) / kChunk).total) + 1024;
  if (smem > smem_of[device]) {
    err = cudaFuncSetAttribute(pivot_scan_kernel<kQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    smem_of[device] = smem;
  }
  // at most one block per SM (one wave): the query tiles times contiguous
  // pivot ranges
  const int qtiles = (B + kQ - 1) / kQ;
  const int ptiles = (R + kPivots - 1) / kPivots;
  int ranges = sms / qtiles;
  ranges = ranges < 1 ? 1 : ranges > ptiles ? ptiles : ranges;
  pivot_scan_kernel<kQ><<<dim3(qtiles, ranges), kThreads, smem, stream>>>(
      q_map, p_map, static_cast<const float*>(q),
      static_cast<const float*>(psq), static_cast<const float*>(pdel),
      static_cast<unsigned long long*>(keys), B, R, D, ptiles, metric);
  return cudaGetLastError();
}

}  // namespace

// q [B, D] f32, piv [R, D] f32 (D % 4 == 0, 16-byte aligned rows), psq /
// pdel [R] f32; keys [B] u64 scratch; d [B] f32 and i [B] i32 out.
extern "C" int scnt_pivot_entry_scan(const void* q, const void* piv,
                                     const void* psq, const void* pdel,
                                     void* keys, void* d, void* i, int B,
                                     int R, int D, int metric, void* stream) {
  if (B <= 0) return 0;
  if (R < 0 || D <= 0 || D % 4 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(piv) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * B, st);
  if (err == cudaSuccess && R > 0)
    err = B <= 64 ? scan<64>(q, piv, psq, pdel, keys, B, R, D, metric, st)
                  : scan<128>(q, piv, psq, pdel, keys, B, R, D, metric, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_keys<<<(B + 255) / 256, 256, 0, st>>>(
      static_cast<const unsigned long long*>(keys), static_cast<float*>(d),
      static_cast<int*>(i), B);
  return static_cast<int>(cudaGetLastError());
}
