// Multi-template dynamic time warping, the column recursion, for Hopper.
//
// Replaces cs304_tpu/ops/dtw.py:dtw_multi_template (a lax.scan over the
// sample's columns; the JAX package has no Pallas kernel of it). Plain
// version: cs304_tpu_torch/ops/dtw.py:dtw_columns_plain:
//   dist (L, H) f32, row j at dist + j * ld: sample frame j's distance to
//   each of the H concatenated template frames; is_first / is_second (H,)
//   u8 mark each word's first and second template row; end_rows (W,) i32.
//   prev = +inf (H rows), prev_min = +inf; for j = 0 .. L-1:
//     boundary = 0 at j = 0, else +inf (a word is entered only at column 0)
//     diag[r]  = is_first[r] ? boundary : prev[r-1]
//     super[r] = is_first[r] ? +inf : is_second[r] ? boundary : prev[r-2]
//     new[r]   = dist[j, r] + min(prev[r], min(diag, super))
//     pruning: new[r] = +inf where new[r] > prev_min * (1 + pruning_factor)
//              (f32: the factor's sum first, then the product)
//     prev_min = min over r of new; prev = new
//   out[w] = prev[end_rows[w]].
// Row 0 is always a word's first row and row 1 its second row or the next
// word's first, so the rows r-1 < 0 and r-2 < 0 that the JAX scan reads
// through jnp.roll's wraparound are always masked. Every operation is a
// min, a compare or one f32 add, so the kernel is bitwise its plain
// version. At column 0 every prev is +inf, so a cell is dist + 0 on a
// word's first two rows and +inf elsewhere; past it the boundary is +inf,
// so a cell's two masks are is_first (diag) and is_first | is_second
// (super).
//
// What bounds it: the L columns are a chain. Each column needs the previous
// column's minimum over all H rows (the prune threshold) and, across every
// 32 V G rows, a neighbour warp's last two rows, so a column costs at least
// one CTA barrier, one shared-memory round trip and a warp reduction: the
// serial floor, 0.140-0.207 us a column measured on an NVIDIA H100 80GB
// HBM3 at 700 W (the earlier design's bare column skeleton), far above the
// byte bound (the distances read once). The earlier design spent 0.74-0.78
// us a column at H = 1134 and 2.1 at H = 8000: its prune minimum (a warp
// butterfly, then every thread folding each warp's value in turn) was
// about half of it at H = 1134; at H = 8000 its 8 rows a thread, read at a
// stride of 8 words, most of it.
//
// Design. One CTA takes the sample; one SM works and the other SMs idle
// (the JAX package searches one sample a call, and so does the port).
// - Rows: each lane holds G runs of V rows of the previous column in
//   registers (a warp covers 32 V G contiguous rows; run g of lane l is
//   rows 32 V g + V l ..), the fewest rows a lane with at most 16 warps:
//   V G = 2, 4, 8, 16, 32 up to H = 1,024 .. 16,384 rows, then 64 (H <=
//   32,768, 128 registers). A run's distances are one conflict-free 8- or
//   16-byte shared load; its two upper neighbours (rows - 1, - 2) are lane
//   l - 1's last two, by shuffle (lane 0 takes lane 31's of run g - 1, and
//   in run 0 the previous warp's, published in shared memory). Up to 16
//   rows a lane the word-boundary masks are +inf / -inf floats applied by
//   fmaxf; past that, bits. Rows past H are marked as word starts, so no
//   cell needs a bounds test after column 0.
// - Distances reach shared memory ahead of the chain by 1-D bulk copies
//   (cp.async.bulk, the TMA, completing on one mbarrier a slot): a ring of
//   min(L, 64, 225 KB / 4 H4) whole columns (H4 = H rounded up to 4), so up
//   to L = 50 at H = 1134 the whole sample is loaded at once. A bulk copy
//   moves 16-byte multiples from 16-byte addresses, so the rows sit at a
//   stride ld that is a multiple of 4 on a 16-byte-aligned pointer
//   (ops/cuda/dtw.py re-lays other rows; DTWRecognizer writes its distances
//   so). Thread 0 refills a slot once every thread has read it.
// - The prune, one column late: a column's cells are computed from the
//   previous column before its prune, the prune applied to the min of the
//   three moves (min of pruned values = pruned min). So column j's cells
//   need column j - 1's threshold, and column j's threshold (from column
//   j - 1's minimum) is reduced beside them, off the chain.
// - The minimum: each warp publishes its minimum as an order-preserving u32
//   key (non-negatives with the sign bit flipped, negatives with every bit
//   flipped, so -0 sorts below +0; the threshold's sign of zero never
//   changes a compare, so the result stays bitwise); after the barrier lane
//   w reads warp w's key and one redux.sync min gives the column's. No
//   float atomics.
// - A column step: wait for its slot, read its distances, shuffle the
//   neighbours, ONE __syncthreads, then with no branch to the publishing
//   stores: the previous warp's edge, the threshold's reduction, the cells,
//   the warp's key (redux.sync), and lane 0 / lane 31 publish the key and
//   the last two rows in the other half of a double buffer. At the end the
//   last column, pruned, goes to shared memory and the CTA gathers
//   end_rows from it.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_ROWS = 32768;  // 16 warps of 64 rows a lane
constexpr int MAX_SLOTS = 64;
constexpr int RING_BYTES = 225 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Column c of dist into ring slot s, completing on the slot's mbarrier.
__device__ __forceinline__ void fetch_column(float* ring, uint64_t* full, const float* dist,
                                             int ld, int c, int s, uint32_t bytes) {
  mbar_expect_tx(&full[s], bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(ring + (size_t)s * (bytes / 4))), "l"(dist + (size_t)c * ld), "r"(bytes),
      "r"(smem_u32(&full[s]))
      : "memory");
}

// Ascending unsigned order of the floats' order (-0 below +0).
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(x);
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float(k ^ (~(unsigned)((int)k >> 31) | 0x80000000u));
}

// Rows at .. at+V-1 of a column in shared memory (one 8- or 16-byte read;
// at is a multiple of V below H4). MASKED: rows q+k >= H read as +inf.
template <int V, bool MASKED>
__device__ __forceinline__ void load_run(float (&d)[V], const float* col, int at, int q,
                                         int H) {
  const float INF = __int_as_float(0x7f800000);
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(col + at);
    d[0] = x.x, d[1] = x.y, d[2] = x.z, d[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(col + at);
    d[0] = x.x, d[1] = x.y;
  }
  if constexpr (MASKED) {
#pragma unroll
    for (int k = 0; k < V; ++k) d[k] = q + k < H ? d[k] : INF;
  }
}

// One run's cells of column j from column j - 1 before its prune (p, and
// n = rows q-1, q-2 of it), descending so that p[k-1], p[k-2] still hold
// column j - 1. The prune of column j - 1 (threshold thr) is taken after
// the min of the three moves: the min of pruned values is the pruned min,
// as pruning maps a value to itself or to +inf by one threshold. The
// masks: bit k of first / fs marks row q+k (FIRST, or FM false), else
// fm1[k] / fm2[k] are +inf on a marked row and -inf elsewhere, so that
// fmaxf masks a move in one instruction. m folds the run's minimum in.
template <int V, bool FIRST, bool FM, typename Mask>
__device__ __forceinline__ void run_cells(float (&p)[V], const float (&d)[V], float2 n,
                                          Mask first, Mask fs, const float* fm1,
                                          const float* fm2, float thr, float& m) {
  const float INF = __int_as_float(0x7f800000);
#pragma unroll
  for (int k = V - 1; k >= 0; --k) {
    float v;
    if (FIRST) {
      v = d[k] + (((fs >> k) & 1u) ? 0.f : INF);
    } else {
      const float r1 = k >= 1 ? p[k >= 1 ? k - 1 : 0] : n.x;
      const float r2 = k >= 2 ? p[k >= 2 ? k - 2 : 0] : (k == 1 ? n.x : n.y);
      float diag, sup;
      if constexpr (FM) {
        diag = fmaxf(r1, fm1[k]);
        sup = fmaxf(r2, fm2[k]);
      } else {
        diag = ((first >> k) & 1u) ? INF : r1;
        sup = ((fs >> k) & 1u) ? INF : r2;
      }
      const float best = fminf(p[k], fminf(diag, sup));
      v = d[k] + (best > thr ? INF : best);
    }
    p[k] = v;
    m = fminf(m, v);
  }
}

// G runs of V rows a lane (a warp covers 32 V G contiguous rows; run g of
// lane l is rows 32 V g + V l ..); STAGE: distances and neighbours fetched
// before the barrier (V G <= 32), else run by run after it (V G = 64, to
// stay within 128 registers).
template <int V, int G, bool STAGE>
__global__ void __launch_bounds__(512) dtw_kernel(
    const float* __restrict__ dist, int ld, const uint8_t* __restrict__ is_first,
    const uint8_t* __restrict__ is_second, const int* __restrict__ end_rows,
    float* __restrict__ out, int H, int L, int W, int pruning, float pruning_factor,
    int n_slots) {
  using Mask = std::conditional_t<(V * G > 32), unsigned long long, unsigned>;
  extern __shared__ __align__(16) float ring[];  // n_slots columns of H4 floats
  __shared__ uint64_t full[MAX_SLOTS];
  __shared__ unsigned s_key[2][32];  // each warp's column minimum as a key; +inf keys past
  __shared__ float2 s_edge[2][16];   // each warp's last two rows (last, last - 1)
  const float INF = __int_as_float(0x7f800000);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h4 = (H + 3) & ~3;
  const uint32_t col_bytes = (uint32_t)h4 * 4;
  const int q0 = warp * 32 * V * G + V * lane;  // run g starts at q0 + 32 V g

  if (tid == 0) {
    for (int s = 0; s < n_slots; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 64; i += blockDim.x) s_key[i >> 5][i & 31] = FULL;  // warps past the last: +inf
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < n_slots; ++c) fetch_column(ring, full, dist, ld, c, c, col_bytes);

  // Bit g V + k: row q0 + 32 V g + k is a word's first / first-or-second
  // row. Rows past H are marked both, so that past column 0 (where they
  // read +inf) a cell there is its distance plus +inf: +inf, or NaN on
  // garbage, which fminf never takes over a number, and no row below
  // reads them.
  Mask first = 0, fs = 0;
  float p[G][V];  // the previous column before its prune
  int at[G];      // each run's read offset in a column slot
#pragma unroll
  for (int g = 0; g < G; ++g) {
    at[g] = min(q0 + 32 * V * g, h4 - V);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int r = q0 + 32 * V * g + k;
      const Mask f = r >= H || is_first[r] != 0, s = r < H && is_second[r] != 0;
      first |= f << (g * V + k);
      fs |= (f | s) << (g * V + k);
      p[g][k] = INF;
    }
  }
  constexpr bool FM = V * G <= 16;  // float masks fit the registers
  float fm1[FM ? G : 1][V], fm2[FM ? G : 1][V];
  if constexpr (FM) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        fm1[g][k] = ((first >> (g * V + k)) & 1u) ? INF : -INF;
        fm2[g][k] = ((fs >> (g * V + k)) & 1u) ? INF : -INF;
      }
  }
  const float scale = 1.0f + pruning_factor;
  const int prev_warp = warp > 0 ? warp - 1 : 0;

  // thr is the threshold that prunes the last column computed: prev_min *
  // (1 + factor), prev_min the minimum of the column before it after its
  // prune. Column 0's: prev_min = +inf.
  float thr = pruning ? INF * scale : INF;
  // Column 0: every prev is +inf, so a cell is dist + 0 on a word's first
  // two rows and +inf elsewhere.
  mbar_wait(&full[0], 0);
  {
    float m = INF;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float d[V];
      load_run<V, true>(d, ring, at[g], q0 + 32 * V * g, H);
      run_cells<V, true, FM>(p[g], d, make_float2(INF, INF), first >> (g * V), fs >> (g * V),
                             fm1[FM ? g : 0], fm2[FM ? g : 0], INF, m);
    }
    const unsigned wkey = __reduce_min_sync(FULL, order_key(m));
    if (lane == 0) s_key[0][warp] = wkey;
    if (lane == 31) s_edge[0][warp] = make_float2(p[G - 1][V - 1], p[G - 1][V - 2]);
  }
  __syncthreads();  // column 0's slot read by all: refilled
  if (tid == 0 && n_slots < L) fetch_column(ring, full, dist, ld, n_slots, 0, col_bytes);
  int slot = n_slots > 1 ? 1 : 0;
  uint32_t phase = n_slots > 1 ? 0 : 1;
  // Columns 1 .. L-1. Column j's cells need column j - 1's threshold only;
  // column j's threshold (from column j - 1's minimum, one reduction over
  // the warps' published keys) is needed by column j + 1, so the reduction
  // runs beside the cells. No branch from the barrier to the publishing
  // stores.
  for (int j = 1; j < L; ++j) {
    const float* col = ring + (size_t)slot * h4;
    float dv[STAGE ? G : 1][V];
    float2 sh[STAGE ? G : 1];
    if constexpr (STAGE) {
      mbar_wait(&full[slot], phase);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        load_run<V, false>(dv[g], col, at[g], 0, H);
        sh[g] = make_float2(__shfl_sync(FULL, p[g][V - 1], (lane - 1) & 31),
                            __shfl_sync(FULL, p[g][V - 2], (lane - 1) & 31));
      }
    }
    __syncthreads();  // column j - 1 published (and, STAGE, column j read by all)
    if constexpr (!STAGE) {
      // Column j - 1's slot, read by all before this barrier: refilled.
      if (tid == 0 && j >= 2 && j - 1 + n_slots < L)
        fetch_column(ring, full, dist, ld, j - 1 + n_slots, (slot > 0 ? slot : n_slots) - 1,
                     col_bytes);
      mbar_wait(&full[slot], phase);
    }
    const int rb = (j & 1) ^ 1, wb = j & 1;
    // Lane 0's neighbours of run 0: the previous warp's last two rows (every
    // lane reads them, one broadcast, so the warp does not diverge).
    const float2 edge = s_edge[rb][prev_warp];
    float2 carry = warp > 0 ? edge : make_float2(INF, INF);
    const float raw_min = key_value(__reduce_min_sync(FULL, s_key[rb][lane]));
    float m = INF;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float2 s;
      float d[V];
      if constexpr (STAGE) {
        s = sh[g];
#pragma unroll
        for (int k = 0; k < V; ++k) d[k] = dv[g][k];
      } else {
        s = make_float2(__shfl_sync(FULL, p[g][V - 1], (lane - 1) & 31),
                        __shfl_sync(FULL, p[g][V - 2], (lane - 1) & 31));
        load_run<V, false>(d, col, at[g], 0, H);
      }
      const float2 n = lane == 0 ? carry : s;
      carry = s;  // at lane 0: lane 31's last two rows of run g, run g + 1's neighbours
      run_cells<V, false, FM>(p[g], d, n, first >> (g * V), fs >> (g * V), fm1[FM ? g : 0],
                              fm2[FM ? g : 0], thr, m);
    }
    const unsigned wkey = __reduce_min_sync(FULL, order_key(m));
    if (lane == 0) s_key[wb][warp] = wkey;
    if (lane == 31) s_edge[wb][warp] = make_float2(p[G - 1][V - 1], p[G - 1][V - 2]);
    // Column j's threshold: column j - 1's pruned minimum is its minimum, or
    // +inf when the prune took every row.
    thr = pruning ? (raw_min > thr ? INF : raw_min) * scale : INF;
    // Column j's slot, read by all before the barrier: refilled.
    if (STAGE && tid == 0 && j + n_slots < L)
      fetch_column(ring, full, dist, ld, j + n_slots, slot, col_bytes);
    if (++slot == n_slots) {
      slot = 0;
      phase ^= 1;
    }
  }
  // No copy is in flight and each thread writes only rows it read itself:
  // the ring's first slot takes the last column, pruned on the way out.
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int r = q0 + 32 * V * g + k;
      if (r < H) ring[r] = p[g][k] > thr ? INF : p[g][k];
    }
  __syncthreads();
  for (int w = tid; w < W; w += blockDim.x) out[w] = ring[end_rows[w]];
}

template <int V, int G, bool STAGE>
cudaError_t launch(int n_slots, const void* dist, int ld, const void* is_first,
                   const void* is_second, const void* end_rows, void* out, int H, int L,
                   int W, int pruning, float pruning_factor, cudaStream_t stream) {
  auto kernel = dtw_kernel<V, G, STAGE>;
  const int bytes = n_slots * ((H + 3) & ~3) * 4;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return e;
  const int warps = (H + 32 * V * G - 1) / (32 * V * G);
  kernel<<<1, 32 * warps, bytes, stream>>>(
      (const float*)dist, ld, (const uint8_t*)is_first, (const uint8_t*)is_second,
      (const int*)end_rows, (float*)out, H, L, W, pruning, pruning_factor, n_slots);
  return cudaGetLastError();
}

}  // namespace

// dist (L, H) f32 at row stride ld (a multiple of 4 >= H, dist 16-byte
// aligned), is_first / is_second (H,) u8, end_rows (W,) i32 in [0, H);
// out (W,) f32. 1 <= H <= 32768, L >= 1.
extern "C" int cs304_dtw(const void* dist, int ld, const void* is_first,
                         const void* is_second, const void* end_rows, void* out, int H,
                         int L, int W, int pruning, float pruning_factor, void* stream) {
  if (H < 1 || H > MAX_ROWS || L < 1 || W < 0 || ld < H || ld % 4 != 0 ||
      reinterpret_cast<uintptr_t>(dist) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int col_bytes = ((H + 3) & ~3) * 4;
  int n_slots = RING_BYTES / col_bytes;
  if (n_slots > MAX_SLOTS) n_slots = MAX_SLOTS;
  if (n_slots > L) n_slots = L;
  cudaStream_t s = (cudaStream_t)stream;
  // The fewest rows a lane with at most 16 warps.
#define CS304_DTW_LAUNCH(V, G, STAGE)                                                  \
  return (int)launch<V, G, STAGE>(n_slots, dist, ld, is_first, is_second, end_rows, out, \
                                  H, L, W, pruning, pruning_factor, s)
  if (H <= 512 * 2) CS304_DTW_LAUNCH(2, 1, true);
  if (H <= 512 * 4) CS304_DTW_LAUNCH(4, 1, true);
  if (H <= 512 * 8) CS304_DTW_LAUNCH(4, 2, true);
  if (H <= 512 * 16) CS304_DTW_LAUNCH(4, 4, true);
  if (H <= 512 * 32) CS304_DTW_LAUNCH(4, 8, true);
  CS304_DTW_LAUNCH(4, 16, false);
#undef CS304_DTW_LAUNCH
}
