// Quadratic-form Gaussian emissions for Hopper, float32 ("highest"):
//   out[n, s] = x2s_n . W[:, s]   for s < S, 0 for S <= s < s_pad,
//   x2s_n = [x_i x_j (i <= j); x_0 .. x_{D-1}; 1; 0 ...],
//   W = [nhp_sym; lin; const; 0 ...]   (ops/cuda/emission.fold_quad_params),
// where nhp_sym folds the symmetric halves of vec(x x^T) . nhp:
// nhp_sym[(i, j)] = nhp[i*D+j] + nhp[j*D+i]. K = D(D+1)/2 + D + 1 = 820 at
// D = 39, padded to 832 (the unfolded sum has 1521 + 39).
//
// Replaces cs304_tpu/ops/pallas/emission.py:_emission_kernel (:82) and
// :_emission_kernel_blocked (:129), precision "highest".
//
// What bounds it on this card: FP32 arithmetic. At the main path (N = 512 *
// 201 frames, S = 58) the function needs 2 * N * S * (780 + 39) = 9.8 GFLOP,
// 0.146 ms at 67 TFLOP/s, against ~53 MB of output (0.016 ms). TF32 would
// break the float32 contract, so the tensor cores are out.
// What the design does about it: a register-tiled SIMT GEMM over the folded
// K, 8 x 8 outputs per thread (two float4 of A and two of B feed 64 FMAs),
// with the linear term and the constant as K rows, so the epilogue is a
// store. The A operand is never loaded: each 16-row chunk of x2s is built in
// shared memory from the block's staged frame tile through the pair table
// (copied into shared memory once a block), once for every state of the
// block's tile: BN = 64 states at S <= 64 (on 128 frames), 128 at S <= 128
// and 256 past that (on 64). Blocks are persistent: as many as run at once,
// each striding over (frame tile, live state tile) tasks, so no wave of
// blocks runs half empty; the task of a row's last live tile zeroes the
// columns past it. The W chunks stream in with cp.async through a 3-stage
// ring; chunk k + 1's x2s is built inside chunk k's FMA loop (never in
// front of the FMAs that wait for it), a product every few K rows, its
// loads in flight under the FMAs; one barrier a chunk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;      // K rows per chunk
constexpr int TM = 8;       // frames per thread
constexpr int TN = 8;       // states per thread
constexpr int DMAX = 64;    // largest feature dimension
constexpr int W_STAGES = 3;  // depth of the W ring

// A build flag known at compile time to be set.
struct Always {
  __device__ constexpr operator bool() const { return true; }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Frame-tile row stride: odd (conflict-free column reads), >= D + 2 (x, 1, 0).
__host__ __device__ constexpr int x_stride(int D) { return (D + 2) | 1; }

// Shared memory, in floats: the pair table (k_pad int16, rounded to 16
// bytes), the frame tile, the x2s double buffer and the W ring.
template <int BM, int BN>
__host__ __device__ constexpr int smem_floats(int D, int k_pad) {
  return ((2 * k_pad + 15) & ~15) / 4 + ((BM * x_stride(D) + 3) & ~3) + 2 * BK * BM +
         W_STAGES * BK * BN;
}

// CONST_X2: a timing variant whose x2s chunk is built once a task and
// reused (the FMAs and W loads alone). At most 128 registers a thread (64
// accumulators, 16 operands): 16 warps an SM whatever the block's size.
template <int BM, int BN, bool CONST_X2>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), 512 / ((BM / TM) * (BN / TN)))
    emission_quad_kernel(const float* __restrict__ frames, const float* __restrict__ w,
                         const int16_t* __restrict__ pairs, float* __restrict__ out, int N,
                         int D, int S, int s_pad, int k_pad, int cols, int n_live,
                         int n_tasks) {
  constexpr int NT = (BM / TM) * (BN / TN);
  static_assert(NT % BM == 0, "each thread builds x2s for one frame");
  constexpr int PER = BK * BM / NT;  // x2s products a thread builds a chunk
  constexpr int EVERY = BK / PER;    // ... one every EVERY K rows
  extern __shared__ __align__(16) float smem[];
  const int XS = x_stride(D);
  int16_t* p_pairs = reinterpret_cast<int16_t*>(smem);
  float* xs = smem + ((2 * k_pad + 15) & ~15) / 4;
  float* As = xs + ((BM * XS + 3) & ~3);  // [2][BK][BM]
  float* Ws = As + 2 * BK * BM;           // [W_STAGES][BK][BN]

  const int tid = threadIdx.x;
  for (int e = tid; e < k_pad; e += NT) p_pairs[e] = pairs[e];

  const int nk = k_pad / BK;
  // Each warp covers 4 x 8 threads of the (BM / TM) x (BN / TN) grid, so
  // a K row's A reads are 4 float4 and its B reads 8: one shared-memory
  // wavefront each.
  constexpr int GX = BN / TN;                // threads along the states
  constexpr int WX = GX < 8 ? GX : 8;        // ... of them in a warp
  const int warp = tid >> 5, lane = tid & 31;
  const int tx = (warp % (GX / WX)) * WX + lane % WX;
  const int ty = (warp / (GX / WX)) * (32 / WX) + lane / WX;
  const int am = tid % BM;
  const float* xrow = xs + am * XS;
  const bool vec = (s_pad & 3) == 0;

  const int dead0 = n_live * BN;  // columns past the live tiles: all zero
  const bool aligned = (reinterpret_cast<uintptr_t>(frames) & 15) == 0;
  for (int task = blockIdx.x; task < n_tasks; task += gridDim.x) {
    const int tile = task % n_live;
    const int m0 = (task / n_live) * BM;
    const int s0 = tile * BN;
    __syncthreads();  // the last task is done with xs, As and Ws

    auto load_w = [&](int kc) {
      if (kc < nk) {
        float* dst = Ws + (kc % W_STAGES) * BK * BN;
        for (int e = tid; e < BK * BN / 4; e += NT) {
          const int r = e / (BN / 4);
          const int c = (e - r * (BN / 4)) * 4;
          cp_async16(dst + r * BN + c, w + (size_t)(kc * BK + r) * cols + s0 + c);
        }
      }
      cp_async_commit();  // an empty group past the last chunk keeps the count
    };
    // x2s chunk: As[kk][m] = x[m][i] * x[m][j], (i, j) from the pair table.
    auto build_x2 = [&](int kc, int buf) {
      float* dst = As + buf * BK * BM;
#pragma unroll
      for (int kk = tid / BM; kk < BK; kk += NT / BM) {
        const unsigned p = static_cast<uint16_t>(p_pairs[kc * BK + kk]);
        dst[kk * BM + am] = xrow[p & 0xffu] * xrow[p >> 8];
      }
    };

    load_w(0);
    load_w(1);
    // The frame tile, with x[D] = 1 (the linear and constant rows) and
    // x[D+1] = 0 (the padding rows): one contiguous run of BM * D floats,
    // read as float4 (16-byte aligned when frames is), eight in flight.
    {
      const int lim = (min(N - m0, BM)) * D;
      const float* src = frames + (size_t)m0 * D;
#pragma unroll 8
      for (int q = tid; q < BM * D / 4; q += NT) {
        float t[4];
        if (aligned && 4 * q + 3 < lim) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(src) + q);
          t[0] = f.x, t[1] = f.y, t[2] = f.z, t[3] = f.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) t[k] = 4 * q + k < lim ? __ldg(src + 4 * q + k) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = 4 * q + k;
          const int m = e / D;
          xs[m * XS + e - m * D] = t[k];
        }
      }
      for (int m = tid; m < BM; m += NT) {
        xs[m * XS + D] = 1.f;
        xs[m * XS + D + 1] = 0.f;
      }
    }
    __syncthreads();
    build_x2(0, 0);
    if (CONST_X2) build_x2(0, 1);

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    // Chunk kc + 1's x2s is built inside chunk kc's FMA loop, one product
    // every EVERY K rows, into the buffer chunk kc - 1 used: its loads
    // run under the FMAs, and the barrier at the next chunk publishes it.
    auto chunk = [&](int kc, auto build_next) {
      const bool build = !CONST_X2 && static_cast<bool>(build_next);
      cp_async_wait<1>();  // chunk kc's W has landed
      __syncthreads();     // ... for every thread, with its x2s; chunk kc - 1 is done
      load_w(kc + 2);      // into the stage chunk kc - 1 used
      const float* A = As + (kc & 1) * BK * BM;
      const float* B = Ws + (kc % W_STAGES) * BK * BN;
      float* An = As + ((kc + 1) & 1) * BK * BM;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(A + kk * BM + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(A + kk * BM + BM / 2 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(B + kk * BN + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(B + kk * BN + BN / 2 + tx * 4);
        const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        if (kk % EVERY == EVERY - 1 && build) {
          const int row = tid / BM + (kk / EVERY) * (NT / BM);
          const unsigned p = static_cast<uint16_t>(p_pairs[(kc + 1) * BK + row]);
          An[row * BM + am] = xrow[p & 0xffu] * xrow[p >> 8];
        }
      }
    };
    // At 64-state tiles the last chunk is peeled off, so the loop's build
    // is unconditional: the one loop body keeps all its values in
    // registers (the conditional one spilled 24 B here) and runs faster;
    // at wider tiles peeling ran slower, so the build stays a test there.
    if constexpr (BN == 64) {
      for (int kc = 0; kc + 1 < nk; ++kc) chunk(kc, Always{});
      chunk(nk - 1, false);
    } else {
      for (int kc = 0; kc < nk; ++kc) chunk(kc, kc + 1 < nk);
    }
    cp_async_wait<0>();

    // The store: rows ty*4 + {0..3} and BM/2 + ty*4 + {0..3}, columns
    // tx*4 + {0..3} and BN/2 + tx*4 + {0..3}; zeros at or past S.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
      if (m >= N) continue;
      float* row = out + (size_t)m * s_pad;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = s0 + h * (BN / 2) + tx * 4;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = s + q < S ? acc[i][h * 4 + q] : 0.f;
        if (vec && s + 3 < s_pad) {
          *reinterpret_cast<float4*>(row + s) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (s + q < s_pad) row[s + q] = v[q];
        }
      }
    }
    if (tile == n_live - 1 && dead0 < s_pad) {  // the columns past the live tiles
      if (vec) {  // float4 rows: dead0 is a multiple of 64
        const int w4 = (s_pad - dead0) / 4;
        for (int e = tid; e < BM * w4; e += NT) {
          const int m = m0 + e / w4;
          if (m < N)
            *reinterpret_cast<float4*>(out + (size_t)m * s_pad + dead0 + 4 * (e % w4)) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        const int wd = s_pad - dead0;
        for (int e = tid; e < BM * wd; e += NT) {
          const int m = m0 + e / wd;
          if (m < N) out[(size_t)m * s_pad + dead0 + e % wd] = 0.f;
        }
      }
    }
  }
}

template <int BM, int BN, bool CONST_X2>
int launch(const void* frames, const void* w, const void* pairs, void* out,
           int N, int D, int S, int s_pad, int k_pad, int cols, cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (BN / TN);
  const int bytes = smem_floats<BM, BN>(D, k_pad) * 4;
  auto kernel = emission_quad_kernel<BM, BN, CONST_X2>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, bytes)) !=
      cudaSuccess)
    return (int)e;
  // Tasks: (frame tile, live state tile), the state tile fastest.
  const int n_live = (S + BN - 1) / BN;
  const int n_tasks = ((N + BM - 1) / BM) * n_live;
  int grid = (per_sm < 1 ? 1 : per_sm) * sms;
  grid = grid < n_tasks ? grid : n_tasks;
  kernel<<<grid, NT, bytes, stream>>>((const float*)frames, (const float*)w,
                                      (const int16_t*)pairs, (float*)out, N, D, S, s_pad,
                                      k_pad, cols, n_live, n_tasks);
  return (int)cudaGetLastError();
}

}  // namespace

// frames (N, D) f32; w (k_pad, cols) f32 and pairs (k_pad,) int16 from
// fold_quad_params(..., "highest"); out (N, s_pad) f32. n_tile (the state
// tile, BN) 64, 128 or 256, on frame tiles of 128, 64 and 64; cols a
// multiple of n_tile, k_pad of 16, both w and pairs 16-byte aligned,
// 1 <= D <= 64, S <= s_pad. stage: 0, or 1 for the constant-x2s timing
// variant.
extern "C" int cs304_emission_quad(
    const void* frames, const void* w, const void* pairs, void* out, int N, int D,
    int S, int s_pad, int k_pad, int cols, int n_tile, int stage, void* stream) {
  if (D < 1 || D > DMAX || N < 1 || S < 1 || S > s_pad || k_pad % BK || cols % n_tile ||
      cols < s_pad || stage < 0 || stage > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define CS304_QUAD(NTILE, BM)                                                              \
  if (n_tile == NTILE)                                                                     \
    return stage ? launch<BM, NTILE, true>(frames, w, pairs, out, N, D, S, s_pad, k_pad,  \
                                           cols, st)                                       \
                 : launch<BM, NTILE, false>(frames, w, pairs, out, N, D, S, s_pad, k_pad, \
                                            cols, st);
  CS304_QUAD(64, 128)
  CS304_QUAD(128, 64)
  CS304_QUAD(256, 64)
#undef CS304_QUAD
  return (int)cudaErrorInvalidValue;
}
