// Quadratic-form Gaussian emissions on Hopper's tensor cores: the "high"
// (3 bf16 passes) and "default" (1 bf16 pass) precision tiers,
//   out[n, s] = (quad + lin) + cst[s]  for s < S, 0 for S <= s < s_pad,
//   quad = x2_hi . W_hi + x2_hi . W_lo + x2_lo . W_hi   ("high"),
//   quad + lin = [x2_hi; x_bf16] . [W_hi; lin_bf16]     ("default"),
// over the folded K: x2_n = [x_i x_j (i <= j)] built exactly in float32 on
// chip and split with round-to-nearest-even into hi = bf16(x2),
// lo = bf16(x2 - float(hi)); W = nhp_sym = the symmetric halves of nhp summed
// (ops/cuda/emission.fold_quad_params), split the same way. lin is the
// float32 x . lin[:, s] at "high"; at "default" its D rows ride the bf16 pass.
//
// Replaces cs304_tpu/ops/pallas/emission.py:_emission_kernel_high (:157) and
// :_emission_kernel_blocked_high (:176) (helpers _split_hi_lo, _dot3), and
// _emission_kernel / _emission_kernel_blocked (:82, :129) at
// Precision.DEFAULT (one bf16 MXU pass, _dot_bf16).
//
// What bounds it on this card: at the main path (N = 512 * 201 frames,
// S = 58) the folded function is 3 x 2 x N x S x 780 = 27.9 GFLOP of bf16
// products at "high" (0.028 ms at 989 TFLOP/s) plus a 0.47 GFLOP float32
// linear term (0.007 ms at 67 TFLOP/s); "default" does one pass and is bound
// by its ~53 MB of frames in and emissions out (0.021 ms at 3.35 TB/s).
// What the design does about it: wgmma m64nNk16 (bf16 in, float32
// accumulators in registers, one accumulator for the three passes), N = 64
// states (32 or 16 where K is too long for the operand to fit). A comes from
// registers: each thread of a warpgroup builds its own fragment (2 frames x
// 4 K rows a step) from the staged frame tile through the pair table, so x2
// never passes through shared memory and the build needs no barrier; a
// warpgroup builds four steps' fragments, then issues their wgmmas back to
// back and reads the next four steps' pair words under them, while the
// block's other warpgroups build or multiply. B is resident: a block loads
// its state tile's whole folded operand (784 x 64 x 2 halves x 2 bytes
// ~ 200 KB at D = 39, half that at one pass) into shared memory once,
// already in wgmma's core-matrix layout, and walks its share of the frame
// tiles with two warpgroups ("high") or three ("default", whose operand
// leaves the room), each on its own 64-frame tile, whose frames it fetched
// into registers while the tile before ran. The epilogue runs from the
// accumulator registers: the float32 linear term ("high", weights read
// through L1), the constant, zeros past S, float2 stores. The A build and
// that linear term, not the wgmmas, set the time: one block an SM (the
// operand fills its shared memory) leaves eight or twelve warps to hide
// their latency.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WG_ROWS = 64;  // frames per warpgroup tile (wgmma's M)
constexpr int DMAX = 64;     // largest feature dimension
constexpr int SMEM_MAX = 232448;
constexpr int CHUNK = 4;     // K steps built before their wgmmas are issued
constexpr int PF = WG_ROWS * DMAX / 128;  // frame values a thread prefetches

// Frame-tile row stride: odd, >= D + 2 (x, then 1 and 0 for the table's
// linear and padding rows).
__host__ __device__ constexpr int x_stride(int D) { return (D + 2) | 1; }

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Warpgroups per block: two beside the 3-pass operand (hi and lo), three
// beside the 1-pass one, which leaves the room.
__host__ __device__ constexpr int warpgroups(bool three) { return three ? 2 : 3; }

__host__ __device__ constexpr size_t smem_bytes(int k_pad, int n, bool three, int D) {
  return (size_t)k_pad * n * 2 * (three ? 2 : 1) + round16(2 * k_pad) +
         (size_t)warpgroups(three) * WG_ROWS * x_stride(D) * 4;
}

// A no-swizzle, K-major operand descriptor: 8 x 8 core matrices of 128
// contiguous bytes, the next core matrix along K 16 * N bytes on (leading
// byte offset), the next along the states 128 bytes on (stride byte offset).
__device__ __forceinline__ uint64_t make_desc(const void* smem, int n) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)n << 16) | ((uint64_t)8 << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// A global load that does not allocate in L1: frames are read once, and
// L1 keeps the weights that every tile reads again.
__device__ __forceinline__ float load_streaming(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        " {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// One step's A fragments (rows r and r + 8 of the warp's 16, K rows
// c, c + 1 and c + 8, c + 9 of the step): x_i * x_j for each row's table
// pair, split into bf16 hi and (at three passes) lo. pc, p8: the pair
// table's words (two pairs each) of K rows c, c + 1 and c + 8, c + 9.
template <bool THREE>
__device__ __forceinline__ void build_a(uint32_t pc, uint32_t p8, const float* x0,
                                        const float* x1, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const uint32_t words[4] = {pc, pc, p8, p8};
  const float* rows[4] = {x0, x1, x0, x1};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t p = words[r];
    const float* x = rows[r];
    const float v0 = x[p & 0xffu] * x[(p >> 8) & 0xffu];
    const float v1 = x[(p >> 16) & 0xffu] * x[p >> 24];
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    if (THREE) {
      const float2 hf = __bfloat1622float2(h);
      const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
      lo[r] = *reinterpret_cast<const uint32_t*>(&l);
    }
  }
}

template <int N, bool THREE>
__global__ void __launch_bounds__(128 * warpgroups(THREE), 1) emission_split_kernel(
    const float* __restrict__ frames, const __nv_bfloat16* __restrict__ w_hi,
    const __nv_bfloat16* __restrict__ w_lo, const int16_t* __restrict__ pairs,
    const float* __restrict__ lin, const float* __restrict__ cst,
    float* __restrict__ out, int M, int D, int S, int s_pad, int k_pad, int n_live) {
  constexpr int NWG = warpgroups(THREE);
  constexpr int NT = 128 * NWG;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile_elems = k_pad * N;
  __nv_bfloat16* b_hi = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_lo = b_hi + tile_elems;
  unsigned char* p_pairs = smem + (size_t)tile_elems * 2 * (THREE ? 2 : 1);
  float* xs_all = reinterpret_cast<float*>(p_pairs + round16(2 * k_pad));
  const int XS = x_stride(D);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int warp = wt >> 5;
  const int lane = tid & 31;
  float* xs = xs_all + wg * WG_ROWS * XS;

  const int tile = blockIdx.x % n_live;  // this block's state tile
  const int group = blockIdx.x / n_live;
  const int groups = gridDim.x / n_live;
  const int s0 = tile * N;

  // The resident operand: the state tile's folded halves and the pair table.
  {
    const uint4* src = reinterpret_cast<const uint4*>(w_hi + (size_t)tile * tile_elems);
    for (int e = tid; e < tile_elems / 8; e += NT) reinterpret_cast<uint4*>(b_hi)[e] = src[e];
    if (THREE) {
      src = reinterpret_cast<const uint4*>(w_lo + (size_t)tile * tile_elems);
      for (int e = tid; e < tile_elems / 8; e += NT) reinterpret_cast<uint4*>(b_lo)[e] = src[e];
    }
    const uint4* psrc = reinterpret_cast<const uint4*>(pairs);
    for (int e = tid; e < k_pad / 8; e += NT) reinterpret_cast<uint4*>(p_pairs)[e] = psrc[e];
  }
  // Generic-proxy stores, read by wgmma through the async proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint32_t* pw = reinterpret_cast<const uint32_t*>(p_pairs);
  const int g = lane >> 2;
  const int c = (lane & 3) * 2;
  const float* x0 = xs + (warp * 16 + g) * XS;
  const float* x1 = x0 + 8 * XS;
  const uint64_t desc_hi = make_desc(b_hi, N);
  const uint64_t desc_lo = make_desc(b_lo, N);
  const uint64_t step = 2 * N;  // one K step of 16 rows, in 16-byte units
  const int nk = k_pad / 16;
  const int frame_tiles = (M + WG_ROWS - 1) / WG_ROWS;
  const int dead0 = n_live * N;  // columns past the live tiles: all zero

  // The frame tiles' columns D (1) and D + 1 (0) never change: set once.
  for (int m = wt; m < WG_ROWS; m += 128) {
    xs[m * XS + D] = 1.f;
    xs[m * XS + D + 1] = 0.f;
  }
  // Each tile's frames are fetched into registers one tile ahead, so their
  // loads are in flight under the previous tile's wgmmas.
  float pf[PF];
  auto fetch = [&](int ft) {
    const float* src = frames + (size_t)ft * WG_ROWS * D;
    const int rows = M - ft * WG_ROWS;
    const int lim = (rows < WG_ROWS ? rows : WG_ROWS) * D;
#pragma unroll
    for (int q = 0; q < PF; ++q) {
      const int e = wt + 128 * q;
      pf[q] = e < lim ? load_streaming(src + e) : 0.f;
    }
  };
  int ft = group * NWG + wg;
  if (ft < frame_tiles) fetch(ft);
  for (; ft < frame_tiles; ft += groups * NWG) {
    const int m0 = ft * WG_ROWS;
    bar_sync(1 + wg);  // the warpgroup is done with the last tile's frames
#pragma unroll
    for (int q = 0; q < PF; ++q) {
      const int e = wt + 128 * q;
      if (e < WG_ROWS * D) {
        const int m = e / D;
        xs[m * XS + e - m * D] = pf[q];
      }
    }
    bar_sync(1 + wg);
    if (ft + groups * NWG < frame_tiles) fetch(ft + groups * NWG);

    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    fence_acc(acc);
    // K in chunks of CHUNK steps: build every A fragment of the chunk, then
    // issue its wgmmas back to back and wait. No register a wgmma reads is
    // written while one is in flight (ptxas would serialize them); the
    // other warpgroups' chunks fill the tensor cores during this one's
    // build. The next chunk's pair words are read under the wgmmas.
    uint32_t h[CHUNK][4], l[CHUNK][4];
    uint32_t wc[CHUNK], w8[CHUNK];
    auto read_pairs = [&](int k0) {
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const int k = (k0 + u) * 16 + c;
        wc[u] = k0 + u < nk ? pw[k >> 1] : 0u;
        w8[u] = k0 + u < nk ? pw[(k + 8) >> 1] : 0u;
      }
    };
    read_pairs(0);
    for (int k0 = 0; k0 < nk; k0 += CHUNK) {
#pragma unroll
      for (int u = 0; u < CHUNK; ++u)
        if (k0 + u < nk) build_a<THREE>(wc[u], w8[u], x0, x1, h[u], l[u]);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        if (k0 + u < nk) {
          const uint64_t off = (uint64_t)(k0 + u) * step;
          Wgmma<N>::mma(acc, h[u], desc_hi + off);
          if (THREE) {
            Wgmma<N>::mma(acc, h[u], desc_lo + off);
            Wgmma<N>::mma(acc, l[u], desc_hi + off);
          }
        }
      }
      wgmma_commit();
      read_pairs(k0 + CHUNK);
      wgmma_wait<0>();
    }
    fence_acc(acc);

    // Epilogue: accumulator element 4j + {0, 1} is row r0, columns
    // 8j + c + {0, 1}; 4j + {2, 3} the same columns of row r0 + 8.
    const int r0 = warp * 16 + g;
    float lin_acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) lin_acc[i] = 0.f;
    if (THREE) {  // the float32 linear term; lin stays in L1 (frames bypass it)
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float xa = x0[d];
        const float xb = x1[d];
        const float* lrow = lin + (size_t)d * s_pad + s0 + c;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const float2 wv = __ldg(reinterpret_cast<const float2*>(lrow + 8 * j));
          lin_acc[4 * j] = fmaf(xa, wv.x, lin_acc[4 * j]);
          lin_acc[4 * j + 1] = fmaf(xa, wv.y, lin_acc[4 * j + 1]);
          lin_acc[4 * j + 2] = fmaf(xb, wv.x, lin_acc[4 * j + 2]);
          lin_acc[4 * j + 3] = fmaf(xb, wv.y, lin_acc[4 * j + 3]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + r0 + 8 * h;
      if (m >= M) continue;
      float* row = out + (size_t)m * s_pad;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int s = s0 + 8 * j + c;
        const int a = 4 * j + 2 * h;
        const float v0 = s < S ? (acc[a] + lin_acc[a]) + __ldg(cst + s) : 0.f;
        const float v1 = s + 1 < S ? (acc[a + 1] + lin_acc[a + 1]) + __ldg(cst + s + 1) : 0.f;
        *reinterpret_cast<float2*>(row + s) = make_float2(v0, v1);
      }
    }
    if (tile == 0 && dead0 < s_pad) {  // the state tiles past S, once a row
      const int w4 = (s_pad - dead0) / 4;
      for (int e = wt; e < WG_ROWS * w4; e += 128) {
        const int m = m0 + e / w4;
        if (m < M)
          *reinterpret_cast<float4*>(out + (size_t)m * s_pad + dead0 + 4 * (e % w4)) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

template <int N, bool THREE>
int launch(const void* frames, const void* w_hi, const void* w_lo, const void* pairs,
           const void* lin, const void* cst, void* out, int M, int D, int S, int s_pad,
           int k_pad, cudaStream_t stream) {
  const size_t bytes = smem_bytes(k_pad, N, THREE, D);
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  constexpr int NWG = warpgroups(THREE);
  auto kernel = emission_split_kernel<N, THREE>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  // One block an SM (the operand fills its shared memory): the live state
  // tiles share the SMs, each block walking its share of frame tiles.
  const int n_live = (S + N - 1) / N;
  const int block_tiles = (M + NWG * WG_ROWS - 1) / (NWG * WG_ROWS);
  int per_tile = sms / n_live;
  per_tile = per_tile < 1 ? 1 : (per_tile > block_tiles ? block_tiles : per_tile);
  kernel<<<n_live * per_tile, 128 * NWG, bytes, stream>>>(
      (const float*)frames, (const __nv_bfloat16*)w_hi, (const __nv_bfloat16*)w_lo,
      (const int16_t*)pairs, (const float*)lin, (const float*)cst, (float*)out, M, D, S,
      s_pad, k_pad, n_live);
  return (int)cudaGetLastError();
}

}  // namespace

// frames (N, D) f32; w_hi, w_lo (s_pad / n_tile, k_pad * n_tile) bf16 and
// pairs (k_pad,) int16 from fold_quad_params (w_lo unused when passes == 1);
// lin (D, s_pad), cst (s_pad,) f32; out (N, s_pad) f32. Requires
// 1 <= D <= 64, S <= s_pad, s_pad a multiple of 64, k_pad of 16, n_tile in
// {64, 32, 16}, passes in {1, 3}, the folded tensors 16-byte aligned.
extern "C" int cs304_emission_split(
    const void* frames, const void* w_hi, const void* w_lo, const void* pairs,
    const void* lin, const void* cst, void* out, int N, int D, int S, int s_pad,
    int k_pad, int n_tile, int passes, void* stream) {
  if (D < 1 || D > DMAX || N < 1 || S < 1 || S > s_pad || s_pad % 64 || k_pad % 16 ||
      (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define CS304_SPLIT(NN)                                                               \
  if (n_tile == NN)                                                                   \
    return passes == 3 ? launch<NN, true>(frames, w_hi, w_lo, pairs, lin, cst, out, N, \
                                          D, S, s_pad, k_pad, st)                     \
                       : launch<NN, false>(frames, w_hi, w_lo, pairs, lin, cst, out,  \
                                           N, D, S, s_pad, k_pad, st);
  CS304_SPLIT(64)
  CS304_SPLIT(32)
  CS304_SPLIT(16)
#undef CS304_SPLIT
  return (int)cudaErrorInvalidValue;
}
