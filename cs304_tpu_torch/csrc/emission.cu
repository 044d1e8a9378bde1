// Quadratic-form Gaussian emissions for Hopper:
//   out[n, s] = (x2_n . nhp[:, s] + x_n . lin[:, s]) + cst[s],
//   x2_n = vec(x_n x_n^T)  (K = D*D = 1521 at D = 39),
// for s < S; the padded state columns S <= s < s_pad are written as 0.
//
// Replaces cs304_tpu/ops/pallas/emission.py:_emission_kernel and
// :_emission_kernel_blocked (precision "highest").
//
// What bounds it on this card: FP32 arithmetic. At the flagship shape
// (N = 512 * 151 frames, S = 58) the K = 1521 term is ~13.6 GFLOP against
// ~0.3 MB of frames and ~0.8 MB of parameters, far above the FP32 ridge.
// No tensor cores: TF32 would break the float32 ("highest") contract.
// What the design does about it: a classic register-tiled FP32 GEMM
// (64 frames x 64 states per block, 4 x 4 outputs per thread, K in chunks
// of 16) whose A operand is never loaded: each x2 chunk is generated in
// shared memory from the block's frame tile, which is staged once. x2 thus
// never exists in device memory (at the flagship it would be 470 MB);
// the nhp chunks stream through shared memory from L2. Each 64-state tile
// rebuilds its own x2 chunks, so past one tile the x2 work repeats S/64
// times; caching x2 per frame tile across state tiles is the next step.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;    // frames per block
constexpr int BN = 64;    // states per block
constexpr int BK = 16;    // K chunk
constexpr int TM = 4;     // frames per thread
constexpr int TN = 4;     // states per thread
constexpr int NT = 256;   // threads per block: (BM / TM) * (BN / TN)
constexpr int DMAX = 64;  // largest feature dimension

__global__ void __launch_bounds__(NT) emission_quad_kernel(
    const float* __restrict__ frames, const float* __restrict__ nhp,
    const float* __restrict__ lin, const float* __restrict__ cst,
    float* __restrict__ out, int N, int D, int S, int s_pad) {
  __shared__ float xs[BM][DMAX + 1];
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

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

  for (int e = tid; e < BM * D; e += NT) {
    const int m = e / D;
    const int d = e - m * D;
    xs[m][d] = (m0 + m < N) ? frames[(size_t)(m0 + m) * D + d] : 0.f;
  }
  __syncthreads();

  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int K = D * D;
  for (int k0 = 0; k0 < K; k0 += BK) {
    // The x2 chunk, generated on chip: As[kk][m] = x[m][i] * x[m][j],
    // k = i * D + j (row-major vec of x x^T, as the parameters are packed).
    for (int e = tid; e < BK * BM; e += NT) {
      const int kk = e / BM;
      const int m = e - kk * BM;
      const int k = k0 + kk;
      float v = 0.f;
      if (k < K) {
        const int i = k / D;
        const int j = k - i * D;
        v = xs[m][i] * xs[m][j];
      }
      As[kk][m] = v;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN;
      const int n = e - kk * BN;
      const int k = k0 + kk;
      const int s = s0 + n;
      Bs[kk][n] = (k < K && s < S) ? nhp[(size_t)k * s_pad + s] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 bq = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Linear term (K = D) from the staged frame tile.
  float accl[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) accl[i][j] = 0.f;
  for (int k = 0; k < D; ++k) {
    float bl[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int s = s0 + tx * TN + j;
      bl[j] = s < S ? lin[(size_t)k * s_pad + s] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float xv = xs[ty * TM + i][k];
#pragma unroll
      for (int j = 0; j < TN; ++j) accl[i][j] = fmaf(xv, bl[j], accl[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= N) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int s = s0 + tx * TN + j;
      if (s < s_pad) {
        out[(size_t)m * s_pad + s] =
            s < S ? (acc[i][j] + accl[i][j]) + cst[s] : 0.f;
      }
    }
  }
}

}  // namespace

// frames (N, D) f32; nhp (D*D, s_pad), lin (D, s_pad), cst (s_pad,) f32;
// out (N, s_pad) f32. Requires 1 <= D <= 64 and S <= s_pad.
extern "C" int cs304_emission_quad(
    const void* frames, const void* nhp, const void* lin, const void* cst,
    void* out, int N, int D, int S, int s_pad, void* stream) {
  if (D < 1 || D > DMAX || S > s_pad) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BM - 1) / BM, (s_pad + BN - 1) / BN);
  emission_quad_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)frames, (const float*)nhp, (const float*)lin,
      (const float*)cst, (float*)out, N, D, S, s_pad);
  return (int)cudaGetLastError();
}
