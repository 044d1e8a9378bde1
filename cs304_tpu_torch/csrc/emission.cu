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
// (no division), once for every state of the block's tile: 64 states at
// S <= 64, 256 past that; 64 frames a block either way. The W
// chunks come in with cp.async, double-buffered with the x2s chunks, so the
// next chunk's loads and build overlap this chunk's FMAs; one barrier a
// chunk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;    // K rows per chunk
constexpr int TM = 8;     // frames per thread
constexpr int TN = 8;     // states per thread
constexpr int DMAX = 64;  // largest feature dimension

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Frame-tile row stride: odd (conflict-free column reads), >= D + 2 (x, 1, 0).
__host__ __device__ constexpr int x_stride(int D) { return (D + 2) | 1; }

template <int BM, int BN>
__host__ __device__ constexpr int smem_floats(int D) {
  return ((BM * x_stride(D) + 3) & ~3) + 2 * BK * BM + 2 * BK * BN;
}

template <int BM, int BN, int NT>
__global__ void __launch_bounds__(NT) emission_quad_kernel(
    const float* __restrict__ frames, const float* __restrict__ w,
    const int16_t* __restrict__ pairs, float* __restrict__ out, int N, int D,
    int S, int s_pad, int k_pad, int cols) {
  static_assert((BM / TM) * (BN / TN) == NT, "one 8 x 8 tile per thread");
  extern __shared__ __align__(16) float smem[];
  const int XS = x_stride(D);
  float* xs = smem;
  float* As = xs + ((BM * XS + 3) & ~3);  // [2][BK][BM]
  float* Bs = As + 2 * BK * BM;           // [2][BK][BN]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int s0 = blockIdx.y * BN;

  if (s0 >= S) {  // a tile of padded state columns only
    for (int e = tid; e < BM * BN; e += NT) {
      const int m = m0 + e / BN;
      const int s = s0 + e % BN;
      if (m < N && s < s_pad) out[(size_t)m * s_pad + s] = 0.f;
    }
    return;
  }

  // The frame tile, with x[D] = 1 (the linear and constant rows) and
  // x[D+1] = 0 (the padding rows).
  for (int e = tid; e < BM * XS; e += NT) {
    const int m = e / XS;
    const int c = e - m * XS;
    float v = c == D ? 1.f : 0.f;
    if (c < D) v = m0 + m < N ? frames[(size_t)(m0 + m) * D + c] : 0.f;
    xs[e] = v;
  }
  __syncthreads();

  auto load_w = [&](int kc, int buf) {
    float* dst = Bs + buf * BK * BN;
    for (int e = tid; e < BK * BN / 4; e += NT) {
      const int r = e / (BN / 4);
      const int c = (e - r * (BN / 4)) * 4;
      cp_async16(dst + r * BN + c, w + (size_t)(kc * BK + r) * cols + s0 + c);
    }
    cp_async_commit();
  };
  // x2s chunk: As[kk][m] = x[m][i] * x[m][j], (i, j) from the pair table.
  const int am = tid % BM;
  const float* xrow = xs + am * XS;
  auto build_x2 = [&](int kc, int buf) {
    float* dst = As + buf * BK * BM;
#pragma unroll
    for (int kk = tid / BM; kk < BK; kk += NT / BM) {
      const unsigned p = static_cast<uint16_t>(__ldg(pairs + kc * BK + kk));
      dst[kk * BM + am] = xrow[p & 0xffu] * xrow[p >> 8];
    }
  };

  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nk = k_pad / BK;
  load_w(0, 0);
  build_x2(0, 0);
  cp_async_wait_all();
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int cur = kc & 1;
    if (kc + 1 < nk) {  // the next chunk, in flight under this one's FMAs
      load_w(kc + 1, cur ^ 1);
      build_x2(kc + 1, cur ^ 1);
    }
    const float* A = As + cur * BK * BM;
    const float* B = Bs + cur * BK * BN;
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
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // The store: rows ty*4 + {0..3} and BM/2 + ty*4 + {0..3}, columns
  // tx*4 + {0..3} and BN/2 + tx*4 + {0..3}; zeros at or past S.
  const bool vec = (s_pad & 3) == 0;
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
}

template <int BM, int BN, int NT>
int launch(const void* frames, const void* w, const void* pairs, void* out,
           int N, int D, int S, int s_pad, int k_pad, int cols, cudaStream_t stream) {
  const int bytes = smem_floats<BM, BN>(D) * 4;
  // Up to D = 64 the tiles pass the 48 KB a block gets without asking.
  const cudaError_t e = cudaFuncSetAttribute(
      emission_quad_kernel<BM, BN, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats<BM, BN>(DMAX) * 4);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BM - 1) / BM, (s_pad + BN - 1) / BN);
  emission_quad_kernel<BM, BN, NT><<<grid, NT, bytes, stream>>>(
      (const float*)frames, (const float*)w, (const int16_t*)pairs, (float*)out, N, D,
      S, s_pad, k_pad, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// frames (N, D) f32; w (k_pad, cols) f32 and pairs (k_pad,) int16 from
// fold_quad_params(..., "highest"); out (N, s_pad) f32. n_tile 64 (S <= 64)
// or 256 states a block; cols a multiple of n_tile, k_pad of 16, both w and
// pairs 16-byte aligned, 1 <= D <= 64, S <= s_pad.
extern "C" int cs304_emission_quad(
    const void* frames, const void* w, const void* pairs, void* out, int N, int D,
    int S, int s_pad, int k_pad, int cols, int n_tile, void* stream) {
  if (D < 1 || D > DMAX || N < 1 || S < 1 || S > s_pad || k_pad % BK ||
      cols % n_tile || cols < s_pad)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_tile == 64)
    return launch<64, 64, 64>(frames, w, pairs, out, N, D, S, s_pad, k_pad, cols, st);
  if (n_tile == 256)
    return launch<64, 256, 256>(frames, w, pairs, out, N, D, S, s_pad, k_pad, cols, st);
  return (int)cudaErrorInvalidValue;
}
