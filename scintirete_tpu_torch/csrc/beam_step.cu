// The search's layer-0 beam step: for each query row of the candidate lists
// (cand_s / cand_d / expanded [B, ef], active [B]), one step of the beam
// and its convergence test, in place, in one launch.
//
// Replaces: no Pallas kernel. The JAX package's step is lax ops
// (scintirete_tpu/index/device.py `_beam_step`, its sorts and gathers under
// `lax.while_loop`); on the card the port ran it as ~133 small torch kernels
// a step (a replayed CUDA graph, index/device.py `BeamGraphs`). This kernel
// is that step, `_beam_step` followed by `_beam_converged` and the status
// update of `_Layer0Beam.step`, with the same answers: given the same
// distances, the lists, flags, `active` and status equal the torch step's
// bit for bit.
//
// What bounds it on an H100: the rows it gathers, and latency. A step reads,
// per active query, `expand` x degree neighbour ids, their tombstones and
// the vector rows of the live ones (4 x 32 rows of D f32 at search: 51 KB at
// D 100, 492 KB at D 960), and writes back ef entries. There is no reuse to
// exploit and few flops (2 D a row), so the least time is the rows read at
// 3.35 TB/s; at small D the chain of dependent loads (list, ids, tombstones,
// rows) sets it instead. The design:
// - one block of 256 threads per query row, so a step is one wave of blocks
//   that each walk their chain alone, with no device-wide barrier but the
//   status word at the end (closed by the last block to finish);
// - the query sits in shared memory; rows are read once, as 16-byte loads
//   by groups of 4-32 lanes (a warp covers one row at D 960, four at D 100),
//   two rows per group at a time with up to 8 loads a lane in flight, and
//   each group sums its row with a fixed shuffle tree: the summation order
//   depends on D alone, never on the batch;
// - rows of inactive queries, of unselected positions and of -1 or deleted
//   neighbours are not read (the torch step masks them to +inf);
// - the dedup and the merge of ef + expand x degree entries (178 at search,
//   456 for the append's ground beam) run in shared memory as ranks counted
//   against every other entry's 64-bit key: O(n^2) compares of broadcast
//   reads, no sort network. A list longer than 227 KB holds (ef past ~17,000
//   at degree 32) keeps the same layout in a global workspace, one slice a
//   block, which the caller allocates: the same code, slower, on any ef.
//
// The torch step's rule, which the ranks reproduce: every slot >= 0 keeps
// one copy, its expanded copy if it has one, else its least distance, ties
// to the earlier copy in [list, then candidates in expansion-neighbour
// order]; survivors and the (-1, +inf, unexpanded) padding are ordered by
// (distance, slot << 1 | unexpanded) and the first ef kept. Distances
// compare as torch's sorts compare them: -0 equals +0, NaN after +inf.
// The comparison-form distance is `_cmp_dist`'s, with the same rounding
// after the dot (__fmul_rn / __fadd_rn / __fsqrt_rn / __fdiv_rn, no FMA
// contraction), from an f32 or bf16 (widened) mirror.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL2 = 1, kCosine = 2, kIP = 3;
constexpr int kThreads = 256;
constexpr int kBatch = 8;             // 16-byte loads a lane keeps in flight per row
constexpr int kSmemMax = 232448;      // 227 KB: the most one block may use
constexpr int kDevices = 64;          // devices whose launch settings are cached
constexpr uint32_t kKeyInf = 0xFF800000u;     // order_key(+inf)
constexpr uint32_t kKeyNegInf = 0x007FFFFFu;  // order_key(-inf)

// Dynamic shared memory, byte offsets: the query (padded to whole chunks),
// then per entry (list, then candidates) its order key, packed slot and
// distance, the candidates' slots, the selected list positions, the
// dedup's marks and four words of block totals.
struct Layout {
  uint32_t q, key, pk, dist, cand, sel, dead, misc, total;
};

__host__ __device__ inline uint32_t align16(uint32_t x) { return (x + 15u) & ~15u; }

__host__ __device__ inline Layout layout_for(int ef, int expand, int deg, int D,
                                             int width) {
  const uint32_t n = ef + expand * deg;
  const uint32_t chunks = (D + width - 1) / width;
  Layout L;
  L.q = 0;
  L.key = align16(chunks * width * 4);
  L.pk = L.key + align16(4 * n);
  L.dist = L.pk + align16(4 * n);
  L.cand = L.dist + align16(4 * n);
  L.sel = L.cand + align16(4 * expand * deg);
  L.dead = L.sel + align16(4 * expand);
  L.misc = L.dead + align16(n);
  L.total = L.misc + 16;
  return L;
}

// order-preserving image of a distance as torch's sorts order them: -0 as
// +0, every NaN after +inf
__device__ __forceinline__ uint32_t order_key(float d) {
  if (isnan(d)) return 0xFFFFFFFFu;
  const uint32_t bits = __float_as_uint(__fadd_rn(d, 0.0f));
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

template <typename T>
struct Rows;

template <>
struct Rows<float> {
  static constexpr int kWidth = 4;  // columns a 16-byte chunk holds
  using Chunk = float4;
  __device__ static Chunk load(const float* row, int ch, int D, bool vec) {
    if (vec) return __ldg(reinterpret_cast<const float4*>(row) + ch);
    const int c = ch * 4;
    Chunk x;
    x.x = c < D ? __ldg(row + c) : 0.f;
    x.y = c + 1 < D ? __ldg(row + c + 1) : 0.f;
    x.z = c + 2 < D ? __ldg(row + c + 2) : 0.f;
    x.w = c + 3 < D ? __ldg(row + c + 3) : 0.f;
    return x;
  }
  __device__ static float dot(const Chunk& x, const float* qc, float acc) {
    const float4 q = *reinterpret_cast<const float4*>(qc);
    acc = __fmaf_rn(x.x, q.x, acc);
    acc = __fmaf_rn(x.y, q.y, acc);
    acc = __fmaf_rn(x.z, q.z, acc);
    return __fmaf_rn(x.w, q.w, acc);
  }
};

template <>
struct Rows<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  using Chunk = uint4;
  __device__ static Chunk load(const __nv_bfloat16* row, int ch, int D, bool vec) {
    if (vec) return __ldg(reinterpret_cast<const uint4*>(row) + ch);
    const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
    uint32_t w[4];
    const int c = ch * 8;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo = c + 2 * k < D ? __ldg(r + c + 2 * k) : 0u;
      const uint32_t hi = c + 2 * k + 1 < D ? __ldg(r + c + 2 * k + 1) : 0u;
      w[k] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float dot(const Chunk& x, const float* qc, float acc) {
    const float4 q0 = *reinterpret_cast<const float4*>(qc);
    const float4 q1 = *reinterpret_cast<const float4*>(qc + 4);
    // bf16 -> f32 is the upper half of the f32's bits
    acc = __fmaf_rn(__uint_as_float(x.x << 16), q0.x, acc);
    acc = __fmaf_rn(__uint_as_float(x.x & 0xFFFF0000u), q0.y, acc);
    acc = __fmaf_rn(__uint_as_float(x.y << 16), q0.z, acc);
    acc = __fmaf_rn(__uint_as_float(x.y & 0xFFFF0000u), q0.w, acc);
    acc = __fmaf_rn(__uint_as_float(x.z << 16), q1.x, acc);
    acc = __fmaf_rn(__uint_as_float(x.z & 0xFFFF0000u), q1.y, acc);
    acc = __fmaf_rn(__uint_as_float(x.w << 16), q1.z, acc);
    return __fmaf_rn(__uint_as_float(x.w & 0xFFFF0000u), q1.w, acc);
  }
};

// index/device.py `_cmp_dist` after its dot, rounding where it rounds
__device__ __forceinline__ float cmp_dist(float dot, float qsq, float qn,
                                          float vsq, int metric) {
  if (metric == kIP) return -dot;
  if (metric == kL2) return __fsub_rn(__fadd_rn(qsq, vsq), __fmul_rn(2.0f, dot));
  const float denom = __fmul_rn(qn, __fsqrt_rn(vsq));
  float cos = denom > 1e-30f ? __fdiv_rn(dot, fmaxf(denom, 1e-30f)) : 0.0f;
  if (!isnan(cos)) cos = fminf(fmaxf(cos, -1.0f), 1.0f);
  return (qsq <= 1e-30f || vsq <= 1e-30f) ? 1.0f : __fsub_rn(1.0f, cos);
}

// Block b = query row b. Entries 0..ef-1 are the row's list, ef + e * deg + j
// the j-th neighbour of the e-th selected entry. A packed slot is
// (slot + 1) << 1 | unexpanded, the torch step's slot << 1 | unexpanded
// plus 2: unsigned, in the same order. kGlobal: the layout lies in `work`
// (Layout::total bytes a block) instead of shared memory.
template <typename T, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
beam_step_kernel(const float* __restrict__ q,       // [B, D]
                 const float* __restrict__ q_sq,    // [B]
                 const float* __restrict__ q_norm,  // [B]
                 const T* __restrict__ vecs,        // [cap, D]
                 const float* __restrict__ sq_norms,      // [cap]
                 const bool* __restrict__ deleted,        // [cap]
                 const long long* __restrict__ nbrs0,     // [cap, deg]
                 long long* cand_s, float* cand_d, bool* expanded,  // [B, ef]
                 bool* active,                             // [B]
                 long long* status,                        // [3]
                 unsigned long long* scratch,              // [3], zero between steps
                 uint8_t* work,                            // [B, L.total] if kGlobal
                 int ef, int expand, int deg, int D, int metric, int lanes,
                 bool vec) {
  using R = Rows<T>;
  constexpr int W = R::kWidth;
  extern __shared__ __align__(16) uint8_t dyn_smem[];
  const Layout L = layout_for(ef, expand, deg, D, W);
  uint8_t* smem =
      kGlobal ? work + static_cast<long long>(blockIdx.x) * L.total : dyn_smem;
  float* qs = reinterpret_cast<float*>(smem + L.q);
  uint32_t* key = reinterpret_cast<uint32_t*>(smem + L.key);
  uint32_t* pk = reinterpret_cast<uint32_t*>(smem + L.pk);
  float* dist = reinterpret_cast<float*>(smem + L.dist);
  int* cand = reinterpret_cast<int*>(smem + L.cand);
  int* sel = reinterpret_cast<int*>(smem + L.sel);
  uint8_t* dead = smem + L.dead;
  // [0] least unexpanded key of the new list, [1] its ef-th entry's key,
  // [2] a NaN among those, [3] rows read
  uint32_t* misc = reinterpret_cast<uint32_t*>(smem + L.misc);

  const int b = blockIdx.x, tid = threadIdx.x;
  const int K = expand * deg, n = ef + K;
  const int chunks = (D + W - 1) / W;
  const long long row0 = static_cast<long long>(b) * ef;
  const bool act = active[b];

  // 1. the row's list and, if it is active, its query
  for (int i = tid; i < ef; i += kThreads) {
    const long long s = cand_s[row0 + i];
    const float d = cand_d[row0 + i];
    dist[i] = d;
    key[i] = order_key(d);
    pk[i] = (s < 0 ? 0u : 2u * static_cast<uint32_t>(s + 1)) +
            (expanded[row0 + i] ? 0u : 1u);
  }
  if (act)
    for (int j = tid; j < chunks * W; j += kThreads)
      qs[j] = j < D ? q[static_cast<long long>(b) * D + j] : 0.f;
  if (tid == 0) {
    misc[0] = 0xFFFFFFFFu;
    misc[1] = 0u;
    misc[2] = 0u;
    misc[3] = 0u;
  }
  __syncthreads();

  // 2. select: the `expand` least unexpanded entries, ties to the lower
  // position (a stable sort's first `expand`); an active query expands
  // those of them whose distance is finite
  for (int i = tid; i < ef; i += kThreads) {
    const uint32_t pi = pk[i];
    const uint32_t ui = (pi & 1u) && pi >= 2u ? key[i] : kKeyInf;
    int r = 0;
    for (int j = 0; j < ef; ++j) {
      const uint32_t pj = pk[j];
      const uint32_t uj = (pj & 1u) && pj >= 2u ? key[j] : kKeyInf;
      r += uj < ui || (uj == ui && j < i);
    }
    if (r < expand) sel[r] = act && ui > kKeyNegInf && ui < kKeyInf ? i : -1;
  }
  __syncthreads();

  // 3. the selected entries' neighbours: live ones keep their slot
  uint32_t rows = 0;
  for (int c = tid; c < K; c += kThreads) {
    const int p = sel[c / deg];
    int slot = -1;
    if (p >= 0) {
      const long long s = static_cast<long long>(pk[p] >> 1) - 1;
      const long long nb = nbrs0[s * deg + c % deg];
      if (nb >= 0 && !deleted[nb]) slot = static_cast<int>(nb);
    }
    cand[c] = slot;
    rows += slot >= 0;
  }
  if (rows) atomicAdd(&misc[3], rows);
  __syncthreads();

  // 4. their distances: a group of `lanes` threads a row, two rows at once
  const int lane = tid & (lanes - 1), group = tid / lanes;
  const int groups = kThreads / lanes;
  const unsigned mask =
      lanes == 32 ? 0xFFFFFFFFu
                  : ((1u << lanes) - 1u) << ((tid & 31) & ~(lanes - 1));
  for (int c = group; c < K; c += 2 * groups) {
    const int s0 = cand[c];
    const int s1 = c + groups < K ? cand[c + groups] : -1;
    if (s0 < 0 && s1 < 0) continue;
    float vsq0 = 0.f, vsq1 = 0.f;
    if (lane == 0) {
      if (s0 >= 0) vsq0 = __ldg(sq_norms + s0);
      if (s1 >= 0) vsq1 = __ldg(sq_norms + s1);
    }
    const T* r0 = vecs + static_cast<long long>(s0 < 0 ? 0 : s0) * D;
    const T* r1 = vecs + static_cast<long long>(s1 < 0 ? 0 : s1) * D;
    float acc0 = 0.f, acc1 = 0.f;
    for (int base = lane; base < chunks; base += lanes * kBatch) {
      typename R::Chunk x0[kBatch], x1[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int ch = base + u * lanes;
        if (ch < chunks) {
          if (s0 >= 0) x0[u] = R::load(r0, ch, D, vec);
          if (s1 >= 0) x1[u] = R::load(r1, ch, D, vec);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int ch = base + u * lanes;
        if (ch < chunks) {
          if (s0 >= 0) acc0 = R::dot(x0[u], qs + ch * W, acc0);
          if (s1 >= 0) acc1 = R::dot(x1[u], qs + ch * W, acc1);
        }
      }
    }
    for (int off = lanes / 2; off > 0; off >>= 1) {
      acc0 = __fadd_rn(acc0, __shfl_xor_sync(mask, acc0, off));
      acc1 = __fadd_rn(acc1, __shfl_xor_sync(mask, acc1, off));
    }
    if (lane == 0) {
      if (s0 >= 0) dist[ef + c] = cmp_dist(acc0, q_sq[b], q_norm[b], vsq0, metric);
      if (s1 >= 0)
        dist[ef + c + groups] = cmp_dist(acc1, q_sq[b], q_norm[b], vsq1, metric);
    }
  }
  __syncthreads();

  // 5. the candidates' entries (unexpanded; -1 / +inf where not read), and
  // the selected list entries' expansion flags
  for (int c = tid; c < K; c += kThreads) {
    const bool live = cand[c] >= 0;
    const float d = live ? dist[ef + c] : __int_as_float(0x7f800000);
    dist[ef + c] = d;
    key[ef + c] = order_key(d);
    pk[ef + c] = 2u * static_cast<uint32_t>(cand[c] + 1) + 1u;
  }
  if (tid < expand && sel[tid] >= 0) pk[sel[tid]] &= ~1u;
  __syncthreads();

  // 6. dedup: a copy of a slot is dead unless it comes first in (packed
  // slot, distance, position) among the slot's copies
  for (int i = tid; i < n; i += kThreads) {
    const uint32_t pi = pk[i];
    bool dup = false;
    if (pi >= 2u) {
      const uint32_t si = pi >> 1, ki = key[i];
      for (int j = 0; j < n; ++j) {
        const uint32_t pj = pk[j];
        if ((pj >> 1) == si) {
          const uint32_t kj = key[j];
          dup |= pj < pi || (pj == pi && (kj < ki || (kj == ki && j < i)));
        }
      }
    }
    dead[i] = dup;
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    if (dead[i]) {
      pk[i] = 1u;  // slot -1, unexpanded
      key[i] = kKeyInf;
      dist[i] = __int_as_float(0x7f800000);
    }
  }
  __syncthreads();

  // 7. merge: an entry's rank in (distance, packed slot, position) is its
  // place in the new list; the first ef are written back
  for (int i = tid; i < n; i += kThreads) {
    const unsigned long long ki =
        (static_cast<unsigned long long>(key[i]) << 32) | pk[i];
    int r = 0;
    for (int j = 0; j < n; ++j) {
      const unsigned long long kj =
          (static_cast<unsigned long long>(key[j]) << 32) | pk[j];
      r += kj < ki || (kj == ki && j < i);
    }
    if (r < ef) {
      const uint32_t p = pk[i];
      const float d = dist[i];
      cand_s[row0 + r] = static_cast<long long>(p >> 1) - 1;
      cand_d[row0 + r] = d;
      expanded[row0 + r] = !(p & 1u);
      if ((p & 1u) && p >= 2u) {  // unexpanded, slot >= 0
        if (isnan(d)) misc[2] = 1u;
        else atomicMin(&misc[0], key[i]);
      }
      if (r == ef - 1) {
        if (isnan(d)) misc[2] = 1u;
        misc[1] = key[i];
      }
    }
  }
  __syncthreads();

  // 8. `_beam_converged` of the new list, and the status: [any active,
  // steps (one more if any query was active), rows read]
  if (tid == 0) {
    const uint32_t best = misc[0];
    const bool now = !misc[2] && best <= misc[1] && best > kKeyNegInf &&
                     best < kKeyInf;
    active[b] = now;
    if (now) atomicAdd(&scratch[0], 1ull);
    if (misc[3]) atomicAdd(&scratch[1], static_cast<unsigned long long>(misc[3]));
    __threadfence();
    const unsigned long long done = atomicAdd(&scratch[2], 1ull);
    if (done == gridDim.x - 1) {  // the last block closes the step
      __threadfence();
      const unsigned long long n_active = atomicAdd(&scratch[0], 0ull);
      const unsigned long long n_rows = atomicAdd(&scratch[1], 0ull);
      status[1] += status[0];
      status[0] = n_active > 0;
      status[2] += static_cast<long long>(n_rows);
      scratch[0] = scratch[1] = scratch[2] = 0ull;
    }
  }
}

int lanes_for(int chunks) {
  return chunks > 64 ? 32 : chunks > 32 ? 16 : chunks > 4 ? 8 : 4;
}

template <typename T>
cudaError_t launch(const void* q, const void* q_sq, const void* q_norm,
                   const void* vecs, const void* sq_norms, const void* deleted,
                   const void* nbrs0, void* cand_s, void* cand_d, void* expanded,
                   void* active, void* status, void* scratch, void* work, int B,
                   int ef, int expand, int deg, int D, int metric,
                   cudaStream_t st) {
  constexpr int W = Rows<T>::kWidth;
  const int smem = static_cast<int>(layout_for(ef, expand, deg, D, W).total);
  const bool vec = D % W == 0 && reinterpret_cast<uintptr_t>(vecs) % 16 == 0;
  const int lanes = lanes_for((D + W - 1) / W);
  if (work != nullptr) {
    beam_step_kernel<T, true><<<B, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(q_sq),
        static_cast<const float*>(q_norm), static_cast<const T*>(vecs),
        static_cast<const float*>(sq_norms), static_cast<const bool*>(deleted),
        static_cast<const long long*>(nbrs0), static_cast<long long*>(cand_s),
        static_cast<float*>(cand_d), static_cast<bool*>(expanded),
        static_cast<bool*>(active), static_cast<long long*>(status),
        static_cast<unsigned long long*>(scratch), static_cast<uint8_t*>(work),
        ef, expand, deg, D, metric, lanes, vec);
    return cudaGetLastError();
  }
  static int smem_of[kDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kDevices) return cudaErrorNotSupported;
  if (smem > 48 * 1024 && smem > smem_of[device]) {
    err = cudaFuncSetAttribute(beam_step_kernel<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_of[device] = smem;
  }
  beam_step_kernel<T, false><<<B, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(q_sq),
      static_cast<const float*>(q_norm), static_cast<const T*>(vecs),
      static_cast<const float*>(sq_norms), static_cast<const bool*>(deleted),
      static_cast<const long long*>(nbrs0), static_cast<long long*>(cand_s),
      static_cast<float*>(cand_d), static_cast<bool*>(expanded),
      static_cast<bool*>(active), static_cast<long long*>(status),
      static_cast<unsigned long long*>(scratch), nullptr, ef, expand, deg, D,
      metric, lanes, vec);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the layout one block needs for a step of this shape, or -1 for a
// shape the kernel never takes. Up to 232,448 the layout lies in shared
// memory; past that the caller passes a workspace of B times these bytes.
extern "C" int scnt_beam_step_smem(int ef, int expand, int deg, int D,
                                   int elem_bytes) {
  if (ef < 1 || expand < 1 || expand > ef || deg < 1 || D < 1 ||
      (elem_bytes != 2 && elem_bytes != 4))
    return -1;
  const long long n = static_cast<long long>(ef) + static_cast<long long>(expand) * deg;
  if (n > (1 << 20) || D > (1 << 20)) return -1;
  return static_cast<int>(layout_for(ef, expand, deg, D, elem_bytes == 4 ? 4 : 8).total);
}

// q [B, D] f32, q_sq / q_norm [B] f32, vecs [cap, D] f32 (elem_bytes 4) or
// bf16 (2), sq_norms [cap] f32, deleted [cap] bool, nbrs0 [cap, deg] i64;
// cand_s i64 / cand_d f32 / expanded bool [B, ef], active [B] bool and
// status [3] i64, all updated in place; scratch [3] u64, zero before the
// first step and left zero by each. work: null where the layout fits
// shared memory, else B x scnt_beam_step_smem bytes, 16-byte aligned.
// Slots below 0 are taken as -1.
extern "C" int scnt_beam_step(const void* q, const void* q_sq, const void* q_norm,
                              const void* vecs, const void* sq_norms,
                              const void* deleted, const void* nbrs0, void* cand_s,
                              void* cand_d, void* expanded, void* active,
                              void* status, void* scratch, void* work, int B,
                              int ef, int expand, int deg, int D, int metric,
                              int elem_bytes, void* stream) {
  if (B < 0 || (metric != kL2 && metric != kCosine && metric != kIP))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = scnt_beam_step_smem(ef, expand, deg, D, elem_bytes);
  if (smem < 0 || (smem > kSmemMax) != (work != nullptr) ||
      reinterpret_cast<uintptr_t>(work) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      elem_bytes == 4
          ? launch<float>(q, q_sq, q_norm, vecs, sq_norms, deleted, nbrs0, cand_s,
                          cand_d, expanded, active, status, scratch, work, B, ef,
                          expand, deg, D, metric, st)
          : launch<__nv_bfloat16>(q, q_sq, q_norm, vecs, sq_norms, deleted,
                                  nbrs0, cand_s, cand_d, expanded, active,
                                  status, scratch, work, B, ef, expand, deg, D,
                                  metric, st);
  return static_cast<int>(err);
}
