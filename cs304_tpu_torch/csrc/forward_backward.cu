// FBD: the dense log-semiring forward-backward of isolated-word Baum-Welch
// and forward scoring, for Hopper.
//
// Replaces cs304_tpu/ops/forward_backward.py:forward (lax.scan :47) and
// :backward (lax.scan :75), and the posteriors forward_backward forms from
// them; the JAX package has no Pallas kernel of it. Plain versions:
// cs304_tpu_torch/ops/cuda/forward_backward.py:fb_dense_plain.
//   log_b (B, T, S) f32; log_a (S, S) f32, one dense matrix shared by the
//   batch (any matrix: no band is assumed); log_init (S,) f32; log_final
//   (S,) f32 or absent; lengths (B,) i32.
//   lse(x) over a slice: m = max x; m itself where m is not finite (-inf,
//   never NaN); else logf(s) + m with s the sum of expf(x_i - m) over
//   ascending i from +0.
//   forward:  alpha_0 = log_init + log_b[0]; for t >= 1,
//             alpha_t[j] = lse_i(alpha[i] + log_a[i, j]) + log_b[t, j]
//             where t < length, else alpha_{t-1} (the carry);
//             ll = lse(alpha_{T-1} + log_final), or lse(alpha_{T-1}).
//   backward: beta_end = log_final, or zeros; beta_{T-1} = beta_end;
//             beta_t[i] = lse_j(log_a[i, j] + (log_b[t+1, j] + beta_{t+1}[j]))
//             where t + 1 < length, else beta_end.
//   posteriors: gamma[t, j] = expf((alpha_t[j] + beta_t[j]) - ll) where
//             t < length, else +0; xi[i, j] = the sum over pairs t + 1 <
//             length, ascending t from +0, of expf(((alpha_t[i] +
//             log_a[i, j]) + (log_b[t+1, j] + beta_{t+1}[j])) - ll), and
//             ll as the forward's. ll = -inf (a pinned final no path
//             reaches) gives what those formulas give: +inf or NaN, as the
//             JAX package does; nothing is substituted.
//   IEEE expf / logf (no fast math), and each add that takes an expf or
//   logf result as __fadd_rn: a plain `+` lets nvcc fuse the function's last
//   multiply into the add (an FMA, one rounding fewer), which moved xi sums
//   of subnormal terms by an ulp against the plain version's separate exp
//   and add.
//
// Design (a first, simple one). One block a sequence, a thread a state (up
// to MAX_STATES = 128: four warps), log_a in shared memory with an odd row
// stride so that both a column (forward: thread j reads log_a[i, j] for one
// i) and a row (backward: thread i reads log_a[i, j] for one j) fall on 32
// banks. Each thread keeps its own state's alpha or beta in a register and
// publishes it a step into a double-buffered shared vector: one barrier a
// step. Its emission for the next step is loaded a step ahead. The
// posteriors mode runs the forward into an alpha scratch, the backward into
// a beta scratch, then gamma row by row (each thread its own state) and xi
// in ascending t, eight pairs of rows staged a barrier, the sums in shared
// memory (each thread the same cells throughout), from the rows this block
// wrote.
//
// What bounds it on this card: the chain of 2 (min(length, T) - 1)
// dependent steps, each a barrier and S expf and one logf a thread
// (latency), and the bytes: the live emission rows read and alpha, beta or
// gamma (B, T, S) written once. At S = 5 a block is one warp with 5 busy
// lanes; the launch fills the card only through B.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int MAX_STATES = 128;
constexpr int XI_PAIRS = 8;  // pairs of rows staged a barrier in the xi pass
enum { FORWARD = 0, BACKWARD = 1, POSTERIORS = 2 };

struct FBDArgs {
  const float* log_b;
  const float* log_a;
  const float* log_init;
  const float* log_final;  // null: no final weights
  const int* lengths;
  float* alpha;  // (B, T, S): the forward's output, or the posteriors' scratch
  float* beta;   // (B, T, S): the backward's output, or the posteriors' scratch
  float* gamma;  // (B, T, S)
  float* xi;     // (B, S, S)
  float* ll;     // (B,)
  int B, T, S, lda;
};

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// Row stride of log_a in shared memory: odd, so 32 consecutive rows or
// columns lie on 32 banks.
__host__ __device__ __forceinline__ int odd_stride(int s) { return s | 1; }

// lse over a column: x_i = v[i] + a[i * lda + j], ascending i.
__device__ __forceinline__ float lse_column(const float* v, const float* a, int lda, int S,
                                            int j) {
  float m = neg_inf();
  for (int i = 0; i < S; ++i) m = fmaxf(m, v[i] + a[i * lda + j]);
  if (!isfinite(m)) return m;
  float s = 0.f;
  for (int i = 0; i < S; ++i) s = __fadd_rn(s, expf((v[i] + a[i * lda + j]) - m));
  return __fadd_rn(logf(s), m);
}

// lse over a row: x_j = a_row[j] + z[j], ascending j.
__device__ __forceinline__ float lse_row(const float* a_row, const float* z, int S) {
  float m = neg_inf();
  for (int j = 0; j < S; ++j) m = fmaxf(m, a_row[j] + z[j]);
  if (!isfinite(m)) return m;
  float s = 0.f;
  for (int j = 0; j < S; ++j) s = __fadd_rn(s, expf((a_row[j] + z[j]) - m));
  return __fadd_rn(logf(s), m);
}

// lse of a vector, ascending i (the likelihood's).
__device__ __forceinline__ float lse_vector(const float* w, int S) {
  float m = neg_inf();
  for (int i = 0; i < S; ++i) m = fmaxf(m, w[i]);
  if (!isfinite(m)) return m;
  float s = 0.f;
  for (int i = 0; i < S; ++i) s = __fadd_rn(s, expf(w[i] - m));
  return __fadd_rn(logf(s), m);
}

template <int MODE>
__global__ void __launch_bounds__(MAX_STATES) fb_dense_kernel(const FBDArgs p) {
  extern __shared__ float smem[];
  const int S = p.S, T = p.T, lda = p.lda;
  float* a_s = smem;               // (S, lda)
  float* buf = smem + S * lda;     // [2][S]: the published vector of a step
  float* ll_s = buf + 2 * S;       // the likelihood, for every thread
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int nt = blockDim.x;
  const bool own = j < S;
  for (int c = j; c < S * S; c += nt) a_s[(c / S) * lda + c % S] = p.log_a[c];
  const int length = p.lengths[b];
  const int n = min(length, T);  // live rows (<= 0 for an empty sequence)
  const size_t row0 = (size_t)b * T * S;
  const float* lb = p.log_b + row0;
  __syncthreads();

  float ll = 0.f;
  if constexpr (MODE != BACKWARD) {
    float* out = p.alpha + row0;
    float x = own ? p.log_init[j] + lb[j] : 0.f;
    if (own) out[j] = x;
    float e = (own && 1 < n) ? lb[S + j] : 0.f;
    int t = 1;
    for (; t < n; ++t) {
      float* v = buf + (t & 1) * S;
      if (own) v[j] = x;
      __syncthreads();
      const float e_next = (own && t + 1 < n) ? lb[(size_t)(t + 1) * S + j] : 0.f;
      if (own) {
        x = lse_column(v, a_s, lda, S, j) + e;
        out[(size_t)t * S + j] = x;
      }
      e = e_next;
    }
    if (own) {
      for (; t < T; ++t) out[(size_t)t * S + j] = x;  // the carry
    }
    // ll: the last step read buf[(t - 1) & 1]; this writes the other half.
    float* w = buf + (max(n, 1) & 1) * S;
    if (own) w[j] = p.log_final ? x + p.log_final[j] : x;
    __syncthreads();
    if (j == 0) {
      *ll_s = lse_vector(w, S);
      if constexpr (MODE == FORWARD) p.ll[b] = *ll_s;
    }
    __syncthreads();
    ll = *ll_s;
  }

  if constexpr (MODE != FORWARD) {
    float* out = p.beta + row0;
    const float be = own ? (p.log_final ? p.log_final[j] : 0.f) : 0.f;
    float y = be;
    if (own) {
      for (int t = max(n - 1, 0); t < T; ++t) out[(size_t)t * S + j] = be;
    }
    float e = (own && n >= 2) ? lb[(size_t)(n - 1) * S + j] : 0.f;
    for (int t = n - 2; t >= 0; --t) {
      float* z = buf + (t & 1) * S;
      if (own) z[j] = e + y;  // log_b[t+1, j] + beta_{t+1}[j]
      __syncthreads();
      e = (own && t >= 1) ? lb[(size_t)t * S + j] : 0.f;
      if (own) {
        y = lse_row(a_s + j * lda, z, S);
        out[(size_t)t * S + j] = y;
      }
    }
  }

  if constexpr (MODE == POSTERIORS) {
    if (j == 0) p.ll[b] = ll;
    __syncthreads();  // every thread's alpha and beta rows are written
    const float* al = p.alpha + row0;
    const float* be = p.beta + row0;
    float* g = p.gamma + row0;
    if (own) {
      for (int t = 0; t < T; ++t) {
        const size_t r = (size_t)t * S + j;
        g[r] = t < length ? expf((al[r] + be[r]) - ll) : 0.f;
      }
    }
    // xi: every cell's sum in shared memory, XI_PAIRS pairs at a time in
    // ascending t. The pairs' alpha_t and log_b[t+1] + beta_{t+1} rows are
    // staged (double-buffered, one barrier a group of pairs); each thread
    // owns its cells for the whole pass, so the sums need no other
    // synchronization and a thread's cells are independent terms in flight.
    float* xi_s = ll_s + 1;        // (S, S)
    float* rows = xi_s + S * S;    // [2][XI_PAIRS][2][S]
    for (int c = j; c < S * S; c += nt) xi_s[c] = 0.f;
    for (int t0 = 0, g0 = 0; t0 + 1 < n; t0 += XI_PAIRS, ++g0) {
      float* r = rows + (g0 & 1) * XI_PAIRS * 2 * S;
      const int np = min(XI_PAIRS, n - 1 - t0);
      if (own) {
        for (int d = 0; d < np; ++d) {
          const size_t q = (size_t)(t0 + d + 1) * S + j;
          r[2 * d * S + j] = al[(size_t)(t0 + d) * S + j];
          r[(2 * d + 1) * S + j] = lb[q] + be[q];
        }
      }
      __syncthreads();
      int i = j / S, k = j % S;
      for (int c = j; c < S * S; c += nt) {
        const float aik = a_s[i * lda + k];
        float acc = xi_s[c];
        for (int d = 0; d < np; ++d) {
          const float term = expf(((r[2 * d * S + i] + aik) + r[(2 * d + 1) * S + k]) - ll);
          acc = __fadd_rn(acc, term);
        }
        xi_s[c] = acc;
        for (k += nt; k >= S; k -= S) ++i;
      }
    }
    float* xo = p.xi + (size_t)b * S * S;
    for (int c = j; c < S * S; c += nt) xo[c] = xi_s[c];
  }
}

template <int MODE>
int launch(const FBDArgs& a, cudaStream_t stream) {
  // log_a, the published vector's two halves and ll; the posteriors add
  // the xi sums and two groups of staged rows.
  const size_t floats = (size_t)a.S * a.lda + 2 * a.S + 1 +
                        (MODE == POSTERIORS ? (size_t)a.S * a.S + 4 * XI_PAIRS * a.S : 0);
  const size_t bytes = floats * sizeof(float);
  auto kernel = fb_dense_kernel<MODE>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = 32 * ((a.S + 31) / 32);
  kernel<<<a.B, threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest S the kernel takes: a thread a state in one block.
extern "C" int cs304_fb_dense_max_states() { return MAX_STATES; }

// mode 0 forward -> alpha (B, T, S), ll (B,); 1 backward -> beta (B, T, S);
// 2 posteriors -> gamma (B, T, S), xi (B, S, S), ll (B,), with alpha and
// beta (B, T, S) as its scratch. log_final may be null. All contiguous
// float32 / int32 on one device.
extern "C" int cs304_fb_dense(int mode, const void* log_b, const void* log_a,
                              const void* log_init, const void* log_final,
                              const void* lengths, void* alpha, void* beta, void* gamma,
                              void* xi, void* ll, int B, int T, int S, void* stream) {
  if (B < 1 || T < 1 || S < 1 || S > MAX_STATES) return (int)cudaErrorInvalidValue;
  FBDArgs a{};
  a.log_b = (const float*)log_b;
  a.log_a = (const float*)log_a;
  a.log_init = (const float*)log_init;
  a.log_final = (const float*)log_final;
  a.lengths = (const int*)lengths;
  a.alpha = (float*)alpha;
  a.beta = (float*)beta;
  a.gamma = (float*)gamma;
  a.xi = (float*)xi;
  a.ll = (float*)ll;
  a.B = B;
  a.T = T;
  a.S = S;
  a.lda = odd_stride(S);
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case FORWARD:
      if (!alpha || !ll) return (int)cudaErrorInvalidValue;
      return launch<FORWARD>(a, st);
    case BACKWARD:
      if (!beta) return (int)cudaErrorInvalidValue;
      return launch<BACKWARD>(a, st);
    case POSTERIORS:
      if (!alpha || !beta || !gamma || !xi || !ll) return (int)cudaErrorInvalidValue;
      return launch<POSTERIORS>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
