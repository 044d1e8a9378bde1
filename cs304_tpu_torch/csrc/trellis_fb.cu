// The sentence forward-backward (FB) of embedded Baum-Welch training, for
// Hopper.
//
// Replaces cs304_tpu/models/train_fused.py:_banded_fb_batch (two lax.scans of
// a log-semiring recursion over the sentence band; the JAX package has no
// Pallas kernel of it). Its plain version is
// cs304_tpu_torch/ops/cuda/trellis_fb.py:banded_fb_plain:
//   log_b (B, T, S) f32; c0 / c1 / c2 (B, S) f32, destination-indexed
//   self / prev / skip log transitions; lengths (B,) i32; final (B,) i32.
//   forward:  alpha_0 = -inf except alpha_0[0] = log_b[0, 0];
//             alpha_t[j] = lse3(alpha[j] + c0[j], alpha[j-1] + c1[j],
//                               alpha[j-2] + c2[j]) + log_b[t, j]
//             for t < length, else alpha_t = alpha_{t-1};
//             ll = alpha_{T-1}[final].
//   backward: beta_{T-1} = 0 at final, -inf elsewhere (beta_end);
//             z = log_b[t+1] + beta_{t+1};
//             beta_t[j] = lse3(z[j] + c0[j], z[j+1] + c1[j+1],
//                              z[j+2] + c2[j+2]) for t + 1 < length,
//             else beta_end.
//   lse3(a, b, c): m = max(max(a, b), c); -inf unless m is finite, else
//   m + log((exp(a - m) + exp(b - m)) + exp(c - m)), in exactly this order,
//   with IEEE expf / logf (no fast math).
//
// Design. The backward never reads alpha, so the forward and the backward
// of an utterance are two independent teams of one launch, and the chain a
// launch waits for is min(length, T) - 1 steps, not twice that. A team owns
// one (utterance, direction) and holds K contiguous states a lane in
// registers (K = 2 up to 64 states, else 4), W = ceil(S / 32K) warps. The
// forward takes alpha[j-1] and alpha[j-2] from the previous lane by
// __shfl_up_sync, the backward z[j+1] + c1[j+1], z[j+2] + c2[j+2] from the
// next lane by __shfl_down_sync; past one warp the lane-31 / lane-0
// boundary values go through shared memory under one barrier a step (a
// double buffer). One-warp teams run four to a block with no barrier at all;
// a wider team is its block. Emission rows come in D steps ahead into
// registers, off the chain. Rows the recursion does not reach (t >= length
// forward, t >= length - 1 backward) are stored from the carry without a
// chain: forward rows past the chain repeat the last alpha, backward rows
// are beta_end.
//
// What bounds it on this card: the chain of min(length, T) - 1 dependent
// steps, each a shuffle, three expf, a logf and a few adds (latency); and
// the bytes: alpha and beta, (B, T, S) f32 each, written once, and the live
// emission rows read once by each team.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 32;
// Emission rows a lane holds in flight: fewer at K = 4, whose teams run up
// to 1024 threads (64 registers a thread).
__host__ __device__ constexpr int prefetch_rows(int k) { return k == 2 ? 4 : 2; }

struct FBArgs {
  const float* log_b;
  const float* c0;
  const float* c1;
  const float* c2;
  const int* lengths;
  const int* final_state;
  float* alpha;  // (B, T, S)
  float* beta;   // (B, T, S)
  float* ll;     // (B,)
  int B, T, S, w;
};

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// The JAX package's _lse3, operation for operation.
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  if (!isfinite(m)) return neg_inf();
  return m + logf((expf(a - m) + expf(b - m)) + expf(c - m));
}

template <int K>
__device__ __forceinline__ void store_row(float* out, int S, int j0, const float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (j0 + k < S) out[j0 + k] = v[k];
}

// One team's direction. tw: warp within the team, nw: its warps.
template <int K, bool BWD>
__device__ void run_team(const FBArgs& p, int b, int tw, float (*xch)[MAX_WARPS][3]) {
  const int S = p.S, T = p.T;
  const int lane = threadIdx.x & 31;
  const int nw = p.w;
  const int j0 = (tw * 32 + lane) * K;
  const float neg = neg_inf();
  const size_t base = (size_t)b * T * S;
  const float* lb = p.log_b + base;
  float* out = (BWD ? p.beta : p.alpha) + base;
  const int length = p.lengths[b];
  const int fin = p.final_state[b];
  // Steps of the chain: rows 1..n forward, rows n-1..0 backward.
  const int n = max(min(length, T) - 1, 0);

  float x[K], c0[K], c1[K], c2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    c0[k] = c1[k] = c2[k] = neg;
    if (j < S) {
      const size_t r = (size_t)b * S + j;
      c0[k] = p.c0[r];
      c1[k] = p.c1[r];
      c2[k] = p.c2[r];
    }
    if (BWD) {
      x[k] = j == fin ? 0.f : neg;
    } else {
      x[k] = j == 0 ? lb[0] : neg;
    }
  }
  if (BWD) {
    for (int t = n; t < T; ++t) store_row<K>(out + (size_t)t * S, S, j0, x);
  } else {
    store_row<K>(out, S, j0, x);
  }

  // Emission rows D steps ahead: step i reads row 1 + i (forward) or
  // n - i (backward, the row after the one it writes).
  constexpr int PREFETCH = prefetch_rows(K);
  float pf[PREFETCH][K];
  auto fetch = [&](float* dst, int i) {
    if (i < n) {
      const float* r = lb + (size_t)(BWD ? n - i : 1 + i) * S + j0;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j0 + k < S) dst[k] = __ldg(r + k);
    }
  };
#pragma unroll
  for (int d = 0; d < PREFETCH; ++d) {
#pragma unroll
    for (int k = 0; k < K; ++k) pf[d][k] = 0.f;
    fetch(pf[d], d);
  }

  for (int i0 = 0; i0 < n; i0 += PREFETCH) {
#pragma unroll
    for (int d = 0; d < PREFETCH; ++d) {
      const int i = i0 + d;
      if (i < n) {
        const int parity = i & 1;
        float nx[K];
        if constexpr (!BWD) {
          // alpha[j0 - 1], alpha[j0 - 2] from the previous lane.
          float u1 = __shfl_up_sync(FULL, x[K - 1], 1);
          float u2 = __shfl_up_sync(FULL, x[K - 2], 1);
          if (nw > 1) {
            if (lane == 31) {
              xch[parity][tw][0] = x[K - 1];
              xch[parity][tw][1] = x[K - 2];
            }
            __syncthreads();
          }
          if (lane == 0) {
            u1 = tw > 0 ? xch[parity][tw - 1][0] : neg;
            u2 = tw > 0 ? xch[parity][tw - 1][1] : neg;
          }
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float a1 = k >= 1 ? x[k - 1] : u1;
            const float a2 = k >= 2 ? x[k - 2] : (k == 1 ? u1 : u2);
            nx[k] = lse3(x[k] + c0[k], a1 + c1[k], a2 + c2[k]) + pf[d][k];
          }
        } else {
          float z[K], y1[K], y2[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            z[k] = pf[d][k] + x[k];
            y1[k] = z[k] + c1[k];
            y2[k] = z[k] + c2[k];
          }
          // y1[j0 + K], y2[j0 + K], y2[j0 + K + 1] from the next lane.
          float n1 = __shfl_down_sync(FULL, y1[0], 1);
          float n2 = __shfl_down_sync(FULL, y2[0], 1);
          float n3 = __shfl_down_sync(FULL, y2[1], 1);
          if (nw > 1) {
            if (lane == 0) {
              xch[parity][tw][0] = y1[0];
              xch[parity][tw][1] = y2[0];
              xch[parity][tw][2] = y2[1];
            }
            __syncthreads();
          }
          if (lane == 31) {
            const bool last = tw == nw - 1;
            n1 = last ? neg : xch[parity][tw + 1][0];
            n2 = last ? neg : xch[parity][tw + 1][1];
            n3 = last ? neg : xch[parity][tw + 1][2];
          }
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float k1 = k + 1 < K ? y1[k + 1] : n1;
            const float k2 = k + 2 < K ? y2[k + 2] : (k + 2 == K ? n2 : n3);
            nx[k] = lse3(z[k] + c0[k], k1, k2);
          }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) x[k] = nx[k];
        store_row<K>(out + (size_t)(BWD ? n - 1 - i : 1 + i) * S, S, j0, x);
        fetch(pf[d], i + PREFETCH);
      }
    }
  }

  if (!BWD) {
    for (int t = n + 1; t < T; ++t) store_row<K>(out + (size_t)t * S, S, j0, x);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (j0 + k == fin) p.ll[b] = x[k];
    if (fin < 0 || fin >= S) {
      if (tw == 0 && lane == 0) p.ll[b] = neg;
    }
  }
}

// One-warp teams (W = 1) run four to a block, team g of the grid being
// (utterance g / 2, direction g % 2); a wider team is its whole block.
template <int K>
__global__ void __launch_bounds__(1024) trellis_fb_kernel(const FBArgs p) {
  __shared__ float xch[2][MAX_WARPS][3];
  const int warp = threadIdx.x >> 5;
  const bool one_warp = p.w == 1;
  const int g = one_warp ? blockIdx.x * 4 + warp : blockIdx.x;
  const int tw = one_warp ? 0 : warp;
  if (g >= 2 * p.B) return;  // only a one-warp team leaves early: no block barrier
  const int b = g >> 1;
  if (g & 1) {
    run_team<K, true>(p, b, tw, xch);
  } else {
    run_team<K, false>(p, b, tw, xch);
  }
}

}  // namespace

// Largest S the kernel takes: MAX_WARPS warps of 32 lanes, 4 states a lane.
extern "C" int cs304_trellis_fb_max_states() { return MAX_WARPS * 32 * 4; }

// log_b (B, T, S), c0/c1/c2 (B, S), lengths (B,), final (B,) -> alpha,
// beta (B, T, S), ll (B,), all contiguous float32 / int32.
extern "C" int cs304_trellis_fb(
    const void* log_b, const void* c0, const void* c1, const void* c2,
    const void* lengths, const void* final_state, void* alpha, void* beta,
    void* ll, int B, int T, int S, void* stream) {
  if (B < 1 || T < 1 || S < 1 || S > cs304_trellis_fb_max_states())
    return (int)cudaErrorInvalidValue;
  FBArgs a;
  a.log_b = (const float*)log_b;
  a.c0 = (const float*)c0;
  a.c1 = (const float*)c1;
  a.c2 = (const float*)c2;
  a.lengths = (const int*)lengths;
  a.final_state = (const int*)final_state;
  a.alpha = (float*)alpha;
  a.beta = (float*)beta;
  a.ll = (float*)ll;
  a.B = B;
  a.T = T;
  a.S = S;
  const int k = S <= 64 ? 2 : 4;
  a.w = (S + 32 * k - 1) / (32 * k);
  const int teams = 2 * B;
  const int threads = a.w == 1 ? 128 : 32 * a.w;
  const int blocks = a.w == 1 ? (teams + 3) / 4 : teams;
  if (k == 2) {
    trellis_fb_kernel<2><<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  } else {
    trellis_fb_kernel<4><<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
