// The sentence forward-backward (FB) of embedded Baum-Welch training, and
// the whole Baum-Welch E-step built on it, for Hopper.
//
// Replaces cs304_tpu/models/train_fused.py:_banded_fb_batch (two lax.scans of
// a log-semiring recursion over the sentence band; the JAX package has no
// Pallas kernel of it) and the posteriors its trainer forms from alpha and
// beta (gamma_of and the xi loop of _bw_body). Plain versions:
// cs304_tpu_torch/ops/cuda/trellis_fb.py:banded_fb_plain and
// banded_fb_posteriors_plain:
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
//   E-step:   llc = ll where finite, else 0 (and the utterance counts
//             nothing); gamma[t, v] = exp((alpha_t[v] + beta_t[v]) - llc)
//             for t < length, else +0; xi[k, v] = the sum, from the last pair
//             t = min(length, T) - 2 down to t = 0, one add a pair from +0,
//             of exp(((alpha_t[v-k] + c_k[v]) + z_t[v]) - llc), with
//             alpha_t[v-k] = -inf for v < k (k = 0 self, 1 prev, 2 skip).
//   lse3(a, b, c): m = max(max(a, b), c); -inf unless m is finite, else
//   m + log((exp(a - m) + exp(b - m)) + exp(c - m)), in exactly this order,
//   with IEEE expf / logf (no fast math).
//
// Design. A team holds K contiguous states a lane in registers (K = 2 up to
// 64 states, else 4), W = ceil(S / 32K) warps. A forward step takes
// alpha[j-1] and alpha[j-2] from the previous lane by __shfl_up_sync, a
// backward step z[j+1] + c1[j+1], z[j+2] + c2[j+2] from the next lane by
// __shfl_down_sync; past one warp the lane-31 / lane-0 boundary values go
// through shared memory under one barrier a step (a double buffer). One-warp
// teams run four to a block with no block barrier at all (they may leave
// early); a wider team is its block. Emission rows come in D steps ahead
// into registers, off the chain. lse3 takes the max operand's exp(m - m) =
// expf(0) = 1.0f as the constant in its own slot of the sum, which is
// bitwise the same and leaves two expf of three on the chain.
//
// Two modes:
// - FB (cs304_trellis_fb): alpha and beta in full. The backward never reads
//   alpha, so the forward and the backward of an utterance are two
//   independent teams, and the chain a launch waits for is
//   min(length, T) - 1 steps. Rows the recursion does not reach are stored
//   from the carry.
// - E-step (cs304_trellis_fb_posteriors): gamma, xi and ll, alpha and beta
//   never written. One team runs an utterance's forward and then its
//   backward, so ll is exact before any posterior is formed (a chain of
//   2 (min(length, T) - 1) steps; every one-warp team of the trainer's
//   shape is resident in one wave). The forward parks its live alpha rows
//   (t < min(length, T) - 1) in the gamma output itself; each backward step
//   reads back alpha_t (its own K states, plain loads a few rows ahead: the
//   rows were written in this launch, so no read-only path), gets
//   alpha_t[j0-1], alpha_t[j0-2] from the previous lane with the chain's
//   shuffles and barrier, adds the three xi terms into 3K register sums off
//   the chain, runs the chain for beta_t and overwrites row t with gamma_t.
//   A lane reads and writes only its own states of the gamma rows, so the
//   two passes need no memory barrier; the ll broadcast between them (a
//   shuffle, or shared memory under __syncthreads for a block team) also
//   retires the forward's last boundary exchange.
//
// What bounds it on this card: the chain of dependent steps, each a
// shuffle, two expf, a logf and a few adds (latency); and the bytes: the
// live emission rows read, and (FB) alpha and beta or (E-step) gamma and xi
// written once. The E-step's parked alpha rows (33.8 MB at the trainer's
// shape) are read back within microseconds, from the 50 MB L2.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 32;
// Values a warp hands its neighbour a step: 3 for the backward chain, 2 of
// alpha for the E-step's xi.
constexpr int XCH = 5;
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
  float* alpha;  // FB: (B, T, S)
  float* beta;   // FB: (B, T, S)
  float* gamma;  // E-step: (B, T, S), the forward's alpha rows until overwritten
  float* xi;     // E-step: (B, 3, S)
  float* ll;     // (B,)
  int B, T, S, w;
};

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// The JAX package's _lse3, bitwise: the max operand's exp(m - m) is
// expf(0) = 1.0f exactly, so it stands as 1.0f in its own slot of
// ((e_a + e_b) + e_c) and only the other two operands pay an expf (a tied
// operand gets expf(0) = 1.0f as well).
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  if (!isfinite(m)) return neg_inf();
  const int slot = a == m ? 0 : (b == m ? 1 : 2);
  const float ep = expf((slot == 0 ? b : a) - m);
  const float eq = expf((slot == 2 ? b : c) - m);
  // slot 0: (1 + e_b) + e_c; slot 1: (e_a + 1) + e_c; slot 2: (e_a + e_b) + 1.
  // Every add of an expf / logf result is __fadd_rn: nvcc may otherwise fuse
  // the function's last multiply into the add (an FMA, one rounding fewer),
  // which the plain version's separate ops do not do.
  const float s = slot == 2 ? __fadd_rn(__fadd_rn(ep, eq), 1.0f)
                            : __fadd_rn(__fadd_rn(ep, 1.0f), eq);
  return __fadd_rn(m, logf(s));
}

template <int K>
__device__ __forceinline__ void store_row(float* out, int S, int j0, const float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (j0 + k < S) out[j0 + k] = v[k];
}

template <int K>
__device__ __forceinline__ void fill_rows(float* out, int S, int j0, int lo, int hi, float v) {
  for (int t = lo; t < hi; ++t) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (j0 + k < S) out[(size_t)t * S + j0 + k] = v;
  }
}

// One forward step: x <- lse3(x + c0, x[j-1] + c1, x[j-2] + c2) + e.
// xch: this step's half of the double buffer.
template <int K>
__device__ __forceinline__ void forward_step(float (&x)[K], const float (&e)[K],
                                             const float (&c0)[K], const float (&c1)[K],
                                             const float (&c2)[K], int lane, int tw, int nw,
                                             float (*xch)[XCH]) {
  const float neg = neg_inf();
  // alpha[j0 - 1], alpha[j0 - 2] from the previous lane.
  float u1 = __shfl_up_sync(FULL, x[K - 1], 1);
  float u2 = __shfl_up_sync(FULL, x[K - 2], 1);
  if (nw > 1) {
    if (lane == 31) {
      xch[tw][0] = x[K - 1];
      xch[tw][1] = x[K - 2];
    }
    __syncthreads();
  }
  if (lane == 0) {
    u1 = tw > 0 ? xch[tw - 1][0] : neg;
    u2 = tw > 0 ? xch[tw - 1][1] : neg;
  }
  float nx[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float a1 = k >= 1 ? x[k - 1] : u1;
    const float a2 = k >= 2 ? x[k - 2] : (k == 1 ? u1 : u2);
    nx[k] = lse3(x[k] + c0[k], a1 + c1[k], a2 + c2[k]) + e[k];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = nx[k];
}

// One backward step: z = e + x, x <- lse3(z + c0, z[j+1] + c1[j+1],
// z[j+2] + c2[j+2]). With HALO it also hands on alpha_t's last two states
// under the same exchange: h1 = alpha_t[j0 - 1], h2 = alpha_t[j0 - 2].
template <int K, bool HALO>
__device__ __forceinline__ void backward_step(float (&x)[K], float (&z)[K], const float (&e)[K],
                                              const float (&c0)[K], const float (&c1)[K],
                                              const float (&c2)[K], const float (&a)[K],
                                              float& h1, float& h2, int lane, int tw, int nw,
                                              float (*xch)[XCH]) {
  const float neg = neg_inf();
  float y1[K], y2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    z[k] = e[k] + x[k];
    y1[k] = z[k] + c1[k];
    y2[k] = z[k] + c2[k];
  }
  // y1[j0 + K], y2[j0 + K], y2[j0 + K + 1] from the next lane.
  float n1 = __shfl_down_sync(FULL, y1[0], 1);
  float n2 = __shfl_down_sync(FULL, y2[0], 1);
  float n3 = __shfl_down_sync(FULL, y2[1], 1);
  if (HALO) {
    h1 = __shfl_up_sync(FULL, a[K - 1], 1);
    h2 = __shfl_up_sync(FULL, a[K - 2], 1);
  }
  if (nw > 1) {
    if (lane == 0) {
      xch[tw][0] = y1[0];
      xch[tw][1] = y2[0];
      xch[tw][2] = y2[1];
    }
    if (HALO && lane == 31) {
      xch[tw][3] = a[K - 1];
      xch[tw][4] = a[K - 2];
    }
    __syncthreads();
  }
  if (lane == 31) {
    const bool last = tw == nw - 1;
    n1 = last ? neg : xch[tw + 1][0];
    n2 = last ? neg : xch[tw + 1][1];
    n3 = last ? neg : xch[tw + 1][2];
  }
  if (HALO && lane == 0) {
    h1 = tw > 0 ? xch[tw - 1][3] : neg;
    h2 = tw > 0 ? xch[tw - 1][4] : neg;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float k1 = k + 1 < K ? y1[k + 1] : n1;
    const float k2 = k + 2 < K ? y2[k + 2] : (k + 2 == K ? n2 : n3);
    x[k] = lse3(z[k] + c0[k], k1, k2);
  }
}

// This lane's K states of a row (0 past S) through the read-only path: for
// log_b, which nothing in the launch writes.
template <int K>
__device__ __forceinline__ void load_ro(float (&dst)[K], const float* row, int j0, int S) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (j0 + k < S) dst[k] = __ldg(row + j0 + k);
}

// The same with plain loads: for the gamma rows that hold the forward's
// alpha, written earlier in this launch by this very thread.
template <int K>
__device__ __forceinline__ void load_rw(float (&dst)[K], const float* row, int j0, int S) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (j0 + k < S) dst[k] = row[j0 + k];
}

template <int K>
__device__ __forceinline__ void load_coefs(const FBArgs& p, int b, int j0, float (&c0)[K],
                                           float (&c1)[K], float (&c2)[K]) {
  const float neg = neg_inf();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    c0[k] = c1[k] = c2[k] = neg;
    if (j < p.S) {
      const size_t r = (size_t)b * p.S + j;
      c0[k] = p.c0[r];
      c1[k] = p.c1[r];
      c2[k] = p.c2[r];
    }
  }
}

// FB: one team's direction. tw: warp within the team.
template <int K, bool BWD>
__device__ void run_team(const FBArgs& p, int b, int tw, float (*xch)[MAX_WARPS][XCH]) {
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
  load_coefs<K>(p, b, j0, c0, c1, c2);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
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
  auto fetch = [&](float (&dst)[K], int i) {
    if (i < n) load_ro<K>(dst, lb + (size_t)(BWD ? n - i : 1 + i) * S, j0, S);
  };
#pragma unroll
  for (int d = 0; d < PREFETCH; ++d) {
#pragma unroll
    for (int k = 0; k < K; ++k) pf[d][k] = 0.f;
    fetch(pf[d], d);
  }

  float z[K], h1, h2;
  for (int i0 = 0; i0 < n; i0 += PREFETCH) {
#pragma unroll
    for (int d = 0; d < PREFETCH; ++d) {
      const int i = i0 + d;
      if (i < n) {
        if constexpr (!BWD) {
          forward_step<K>(x, pf[d], c0, c1, c2, lane, tw, nw, xch[i & 1]);
        } else {
          backward_step<K, false>(x, z, pf[d], c0, c1, c2, x, h1, h2, lane, tw, nw,
                                  xch[i & 1]);
        }
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
  __shared__ float xch[2][MAX_WARPS][XCH];
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

// E-step: one team, one utterance, the forward and then the backward.
// PF: rows in flight in each of the two rings (emissions, parked alpha).
template <int K, int PF>
__device__ void run_posteriors(const FBArgs& p, int b, int tw, float (*xch)[MAX_WARPS][XCH],
                               float* sh_ll) {
  const int S = p.S, T = p.T;
  const int lane = threadIdx.x & 31;
  const int nw = p.w;
  const int j0 = (tw * 32 + lane) * K;
  const float neg = neg_inf();
  const size_t base = (size_t)b * T * S;
  const float* lb = p.log_b + base;
  float* g = p.gamma + base;
  const int length = p.lengths[b];
  const int fin = p.final_state[b];
  const int live = min(max(length, 0), T);  // rows t < length
  const int n = max(live - 1, 0);           // chain steps each way; pairs 0..n-1

  float x[K], c0[K], c1[K], c2[K];
  load_coefs<K>(p, b, j0, c0, c1, c2);
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = j0 + k == 0 ? lb[0] : neg;

  // ---- forward: alpha_0..alpha_{n-1} parked in gamma's rows, alpha_n kept.
  float e[PF][K];
#pragma unroll
  for (int d = 0; d < PF; ++d) {
#pragma unroll
    for (int k = 0; k < K; ++k) e[d][k] = 0.f;
    if (d < n) load_ro<K>(e[d], lb + (size_t)(1 + d) * S, j0, S);
  }
  if (n > 0) store_row<K>(g, S, j0, x);
  for (int i0 = 0; i0 < n; i0 += PF) {
#pragma unroll
    for (int d = 0; d < PF; ++d) {
      const int i = i0 + d;
      if (i < n) {
        forward_step<K>(x, e[d], c0, c1, c2, lane, tw, nw, xch[i & 1]);
        if (i + 1 < n) store_row<K>(g + (size_t)(i + 1) * S, S, j0, x);
        if (i + PF < n) load_ro<K>(e[d], lb + (size_t)(1 + i + PF) * S, j0, S);
      }
    }
  }

  // ---- ll = alpha_n[final] on every lane of the team. For a block team
  // the barrier also retires the forward's last exchange.
  float mine = neg;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (j0 + k == fin) mine = x[k];
  const bool fin_in = fin >= 0 && fin < S;
  float ll;
  if (nw == 1) {
    ll = __shfl_sync(FULL, mine, fin_in ? fin / K : 0);
    if (!fin_in) ll = neg;
  } else {
    if (fin_in ? (j0 <= fin && fin < j0 + K) : (tw == 0 && lane == 0))
      *sh_ll = fin_in ? mine : neg;
    __syncthreads();
    ll = *sh_ll;
  }
  if (tw == 0 && lane == 0) p.ll[b] = ll;
  const bool valid = isfinite(ll);
  const float llc = valid ? ll : 0.f;

  // Rows past the utterance (all rows of one that counts nothing) are +0.
  fill_rows<K>(g, S, j0, valid ? live : 0, T, 0.f);

  float acc0[K], acc1[K], acc2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc0[k] = acc1[k] = acc2[k] = 0.f;

  if (valid && live > 0) {
    // ---- backward from beta_n = beta_end; gamma_n from the carry.
    float gr[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float be = j0 + k == fin ? 0.f : neg;
      gr[k] = expf((x[k] + be) - llc);
      x[k] = be;
    }
    store_row<K>(g + (size_t)n * S, S, j0, gr);

    // Step i computes beta_t, t = n - 1 - i: it reads log_b row t + 1 and
    // the parked alpha row t, PF steps ahead.
    float a[PF][K];
#pragma unroll
    for (int d = 0; d < PF; ++d) {
#pragma unroll
      for (int k = 0; k < K; ++k) e[d][k] = a[d][k] = neg;
      if (d < n) {
        load_ro<K>(e[d], lb + (size_t)(n - d) * S, j0, S);
        load_rw<K>(a[d], g + (size_t)(n - 1 - d) * S, j0, S);
      }
    }
    float z[K], h1, h2;
    for (int i0 = 0; i0 < n; i0 += PF) {
#pragma unroll
      for (int d = 0; d < PF; ++d) {
        const int i = i0 + d;
        if (i < n) {
          const int t = n - 1 - i;
          backward_step<K, true>(x, z, e[d], c0, c1, c2, a[d], h1, h2, lane, tw, nw,
                                 xch[i & 1]);
          // xi terms of pair t (off the chain), then gamma_t.
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float p1 = k >= 1 ? a[d][k - 1] : h1;
            const float p2 = k >= 2 ? a[d][k - 2] : (k == 1 ? h1 : h2);
            // __fadd_rn: no FMA of expf's last multiply into the sum (lse3).
            acc0[k] = __fadd_rn(acc0[k], expf(((a[d][k] + c0[k]) + z[k]) - llc));
            acc1[k] = __fadd_rn(acc1[k], expf(((p1 + c1[k]) + z[k]) - llc));
            acc2[k] = __fadd_rn(acc2[k], expf(((p2 + c2[k]) + z[k]) - llc));
            gr[k] = expf((a[d][k] + x[k]) - llc);
          }
          store_row<K>(g + (size_t)t * S, S, j0, gr);
          if (i + PF < n) {
            load_ro<K>(e[d], lb + (size_t)(n - i - PF) * S, j0, S);
            load_rw<K>(a[d], g + (size_t)(n - 1 - i - PF) * S, j0, S);
          }
        }
      }
    }
  }
  float* xo = p.xi + (size_t)b * 3 * S;
  store_row<K>(xo, S, j0, acc0);
  store_row<K>(xo + S, S, j0, acc1);
  store_row<K>(xo + 2 * S, S, j0, acc2);
}

// One-warp teams, four utterances a block, no block barrier.
template <int K>
__global__ void __launch_bounds__(128) trellis_fb_posteriors_warp_kernel(const FBArgs p) {
  __shared__ float xch[2][MAX_WARPS][XCH];  // untouched by one-warp teams
  const int b = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (b >= p.B) return;  // a one-warp team may leave early
  run_posteriors<K, prefetch_rows(K)>(p, b, 0, xch, nullptr);
}

// Teams of W > 1 warps: one utterance a block.
__global__ void __launch_bounds__(1024) trellis_fb_posteriors_block_kernel(const FBArgs p) {
  __shared__ float xch[2][MAX_WARPS][XCH];
  __shared__ float sh_ll;
  run_posteriors<4, prefetch_rows(4)>(p, blockIdx.x, threadIdx.x >> 5, xch, &sh_ll);
}

FBArgs make_args(const void* log_b, const void* c0, const void* c1, const void* c2,
                 const void* lengths, const void* final_state, void* ll, int B, int T,
                 int S) {
  FBArgs a{};
  a.log_b = (const float*)log_b;
  a.c0 = (const float*)c0;
  a.c1 = (const float*)c1;
  a.c2 = (const float*)c2;
  a.lengths = (const int*)lengths;
  a.final_state = (const int*)final_state;
  a.ll = (float*)ll;
  a.B = B;
  a.T = T;
  a.S = S;
  const int k = S <= 64 ? 2 : 4;
  a.w = (S + 32 * k - 1) / (32 * k);
  return a;
}

}  // namespace

// Largest S the kernels take: MAX_WARPS warps of 32 lanes, 4 states a lane.
extern "C" int cs304_trellis_fb_max_states() { return MAX_WARPS * 32 * 4; }

// log_b (B, T, S), c0/c1/c2 (B, S), lengths (B,), final (B,) -> alpha,
// beta (B, T, S), ll (B,), all contiguous float32 / int32.
extern "C" int cs304_trellis_fb(
    const void* log_b, const void* c0, const void* c1, const void* c2,
    const void* lengths, const void* final_state, void* alpha, void* beta,
    void* ll, int B, int T, int S, void* stream) {
  if (B < 1 || T < 1 || S < 1 || S > cs304_trellis_fb_max_states())
    return (int)cudaErrorInvalidValue;
  FBArgs a = make_args(log_b, c0, c1, c2, lengths, final_state, ll, B, T, S);
  a.alpha = (float*)alpha;
  a.beta = (float*)beta;
  const int teams = 2 * B;
  const int threads = a.w == 1 ? 128 : 32 * a.w;
  const int blocks = a.w == 1 ? (teams + 3) / 4 : teams;
  if (S <= 64) {
    trellis_fb_kernel<2><<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  } else {
    trellis_fb_kernel<4><<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// The Baum-Welch E-step: the same inputs -> gamma (B, T, S), xi (B, 3, S),
// ll (B,), all contiguous float32 / int32.
extern "C" int cs304_trellis_fb_posteriors(
    const void* log_b, const void* c0, const void* c1, const void* c2,
    const void* lengths, const void* final_state, void* gamma, void* xi,
    void* ll, int B, int T, int S, void* stream) {
  if (B < 1 || T < 1 || S < 1 || S > cs304_trellis_fb_max_states())
    return (int)cudaErrorInvalidValue;
  FBArgs a = make_args(log_b, c0, c1, c2, lengths, final_state, ll, B, T, S);
  a.gamma = (float*)gamma;
  a.xi = (float*)xi;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.w > 1) {
    trellis_fb_posteriors_block_kernel<<<B, 32 * a.w, 0, st>>>(a);
  } else if (S <= 64) {
    trellis_fb_posteriors_warp_kernel<2><<<(B + 3) / 4, 128, 0, st>>>(a);
  } else {
    trellis_fb_posteriors_warp_kernel<4><<<(B + 3) / 4, 128, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
