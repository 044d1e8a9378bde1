// Quadratic-form Gaussian emissions on Hopper's tensor cores: the "high"
// (3 bf16 passes) and "default" (1 bf16 pass) precision tiers,
//   out[n, s] = (quad + lin) + cst[s],
//   quad = x2_hi . nhp_hi + x2_hi . nhp_lo + x2_lo . nhp_hi   ("high"),
//   quad = x2_hi . nhp_hi                                      ("default"),
//   x2_n = vec(x_n x_n^T) built exactly in float32 on chip, then split with
//   round-to-nearest-even into hi = bf16(x2), lo = bf16(x2 - float(hi));
//   lin = x_n . lin[:, s] in float32 ("high") or over bf16-rounded operands
//   ("default"); padded state columns S <= s < s_pad are written as 0.
//
// Replaces cs304_tpu/ops/pallas/emission.py:_emission_kernel_high and
// :_emission_kernel_blocked_high (helpers _split_hi_lo, _dot3), and
// _emission_kernel / _emission_kernel_blocked at Precision.DEFAULT (one bf16
// MXU pass, _dot_bf16). The wrapper splits nhp into nhp_hi / nhp_lo (bf16,
// (D*D, s_pad)) once per call, as the JAX package does.
//
// What bounds it on this card: at the flagship (N = 512 * 201 frames,
// S = 58) the "high" quad term is 3 x 18.2 GFLOP of bf16 products (~55 us at
// 989 TFLOP/s) plus a 0.47 GFLOP float32 linear term (~7 us at 67 TFLOP/s);
// "default" does one pass and is bound by its ~69 MB of frames in and
// emissions out (~21 us at 3.35 TB/s).
// What the design does about it: a 64 x 64 output tile per block of four
// warps, each warp a 32 x 32 quadrant of 2 x 2 wmma bf16 16x16x16 fragments
// with float32 accumulators (one accumulator for the three passes). K runs
// in chunks of 32 (K = 1521 is zero-padded to 1536 at D = 39). The A
// operand is never loaded: each chunk of x2 is generated from the block's
// staged frame tile, split, and stored as bf16 hi / lo tiles in shared
// memory (two adjacent K columns per thread, as bf16 pairs); the nhp_hi /
// nhp_lo chunks stream in from L2 in 16-byte loads. The accumulators go
// through shared memory to an epilogue that adds the linear term (computed
// from the staged frames on the CUDA cores) and the constant. No wgmma or
// TMA yet, and each 64-state tile rebuilds its own x2 chunks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;    // frames per block
constexpr int BN = 64;    // states per block
constexpr int BK = 32;    // K chunk (two wmma k-steps)
constexpr int NT = 128;   // threads per block: four warps, 2 x 2 quadrants
constexpr int DMAX = 64;  // largest feature dimension
constexpr int AST = BK + 8;  // bf16 row stride of the A tiles (80 bytes)
constexpr int BST = BN + 8;  // bf16 row stride of the B tiles (144 bytes)
constexpr int CST = BN + 4;  // float row stride of the C tile (272 bytes)
constexpr int VEC = 8;       // bf16 per 16-byte load of the nhp tiles

constexpr int A_ELEMS = BM * AST;
constexpr int B_ELEMS = BK * BST;
// The bf16 staging tiles (a_hi, a_lo, b_hi, b_lo) and the float accumulator
// tile are never live together, so they share one buffer.
constexpr int STAGE_BYTES = (2 * A_ELEMS + 2 * B_ELEMS) * 2;
constexpr int C_BYTES = BM * CST * 4;
constexpr int TILE_BYTES = STAGE_BYTES > C_BYTES ? STAGE_BYTES : C_BYTES;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(NT) emission_split_kernel(
    const float* __restrict__ frames, const __nv_bfloat16* __restrict__ nhp_hi,
    const __nv_bfloat16* __restrict__ nhp_lo, const float* __restrict__ lin,
    const float* __restrict__ cst, float* __restrict__ out, int N, int D,
    int S, int s_pad, int passes) {
  __shared__ float xs[BM][DMAX + 1];
  __shared__ __align__(128) unsigned char tiles[TILE_BYTES];
  __nv_bfloat16* a_hi = reinterpret_cast<__nv_bfloat16*>(tiles);
  __nv_bfloat16* a_lo = a_hi + A_ELEMS;
  __nv_bfloat16* b_hi = a_lo + A_ELEMS;
  __nv_bfloat16* b_lo = b_hi + B_ELEMS;
  float* ctile = reinterpret_cast<float*>(tiles);

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

  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;  // the warp's quadrant: rows
  const int wn = (warp & 1) * 32;   // and columns of the tile
  const bool three = passes == 3;
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int K = D * D;
  const int kp = 2 * (tid % (BK / 2));  // this thread's pair of K columns
  for (int k0 = 0; k0 < K; k0 += BK) {
    // The x2 chunk, generated on chip and split: x2[m][k] = x[m][i] * x[m][j],
    // k = i * D + j (row-major vec of x x^T, as the parameters are packed),
    // two adjacent k per thread, stored as bf16 pairs.
    const int ka = k0 + kp;
    const int kb = ka + 1;
    const bool ina = ka < K;
    const bool inb = kb < K;
    const int ia = ina ? ka / D : 0;
    const int ja = ina ? ka - ia * D : 0;
    const int ib = inb ? kb / D : 0;
    const int jb = inb ? kb - ib * D : 0;
    for (int m = tid / (BK / 2); m < BM; m += NT / (BK / 2)) {
      const float va = ina ? xs[m][ia] * xs[m][ja] : 0.f;
      const float vb = inb ? xs[m][ib] * xs[m][jb] : 0.f;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(va, vb);
      *reinterpret_cast<__nv_bfloat162*>(a_hi + m * AST + kp) = hi;
      if (three) {
        const float2 h = __bfloat1622float2(hi);
        *reinterpret_cast<__nv_bfloat162*>(a_lo + m * AST + kp) =
            __floats2bfloat162_rn(va - h.x, vb - h.y);
      }
    }
    // The nhp chunks, 8 bf16 (16 bytes) a load; rows past K are zero. The
    // columns at or past S feed only accumulator columns that the epilogue
    // overwrites with 0.
    for (int e = tid; e < BK * BN / VEC; e += NT) {
      const int r = e / (BN / VEC);
      const int c = (e - r * (BN / VEC)) * VEC;
      const int kr = k0 + r;
      uint4 vh = make_uint4(0u, 0u, 0u, 0u);
      uint4 vl = vh;
      if (kr < K) {
        const size_t g = (size_t)kr * s_pad + s0 + c;
        vh = *reinterpret_cast<const uint4*>(nhp_hi + g);
        if (three) vl = *reinterpret_cast<const uint4*>(nhp_lo + g);
      }
      *reinterpret_cast<uint4*>(b_hi + r * BST + c) = vh;
      if (three) *reinterpret_cast<uint4*>(b_lo + r * BST + c) = vl;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA ah[2], al[2];
      FragB bh[2], bl[2];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::load_matrix_sync(ah[f], a_hi + (wm + 16 * f) * AST + kk, AST);
        wmma::load_matrix_sync(bh[f], b_hi + kk * BST + wn + 16 * f, BST);
      }
      if (three) {
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          wmma::load_matrix_sync(al[f], a_lo + (wm + 16 * f) * AST + kk, AST);
          wmma::load_matrix_sync(bl[f], b_lo + kk * BST + wn + 16 * f, BST);
        }
      }
#pragma unroll
      for (int fi = 0; fi < 2; ++fi)
#pragma unroll
        for (int fj = 0; fj < 2; ++fj) {
          wmma::mma_sync(acc[fi][fj], ah[fi], bh[fj], acc[fi][fj]);
          if (three) {
            wmma::mma_sync(acc[fi][fj], ah[fi], bl[fj], acc[fi][fj]);
            wmma::mma_sync(acc[fi][fj], al[fi], bh[fj], acc[fi][fj]);
          }
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int fi = 0; fi < 2; ++fi)
#pragma unroll
    for (int fj = 0; fj < 2; ++fj)
      wmma::store_matrix_sync(ctile + (wm + 16 * fi) * CST + wn + 16 * fj,
                              acc[fi][fj], CST, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: the linear term (K = D) from the staged frames, the constant,
  // and zeros in the padded state columns.
  for (int e = tid; e < BM * BN; e += NT) {
    const int r = e / BN;
    const int c = e - r * BN;
    const int m = m0 + r;
    const int s = s0 + c;
    if (m >= N || s >= s_pad) continue;
    float v = 0.f;
    if (s < S) {
      float l = 0.f;
      for (int d = 0; d < D; ++d) {
        const float x = xs[r][d];
        const float w = lin[(size_t)d * s_pad + s];
        l = three ? fmaf(x, w, l) : fmaf(round_bf16(x), round_bf16(w), l);
      }
      v = (ctile[r * CST + c] + l) + cst[s];
    }
    out[(size_t)m * s_pad + s] = v;
  }
}

}  // namespace

// frames (N, D) f32; nhp_hi, nhp_lo (D*D, s_pad) bf16 (nhp_lo unused when
// passes == 1); lin (D, s_pad), cst (s_pad,) f32; out (N, s_pad) f32.
// Requires 1 <= D <= 64, S <= s_pad, s_pad a multiple of 64, nhp_hi / nhp_lo
// 16-byte aligned and passes in {1, 3}.
extern "C" int cs304_emission_split(
    const void* frames, const void* nhp_hi, const void* nhp_lo,
    const void* lin, const void* cst, void* out, int N, int D, int S,
    int s_pad, int passes, void* stream) {
  if (D < 1 || D > DMAX || S > s_pad || s_pad % BN || N < 1 ||
      (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BM - 1) / BM, (s_pad + BN - 1) / BN);
  emission_split_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)frames, (const __nv_bfloat16*)nhp_hi,
      (const __nv_bfloat16*)nhp_lo, (const float*)lin, (const float*)cst,
      (float*)out, N, D, S, s_pad, passes);
  return (int)cudaGetLastError();
}
