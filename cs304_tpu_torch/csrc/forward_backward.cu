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
// Sparse sums, bitwise the dense ones. A -inf entry of log_a adds nothing
// to an lse whose max m is finite: its term is expf(-inf - m) = +0, s + (+0)
// = s for s >= +0, and -inf never raises the max. So each thread keeps the
// ascending list of its state's finite entries (its column for the
// forward, its row for the backward), found at the launch's start from this
// call's log_a (it changes every Baum-Welch iteration: no host table), and
// sums over that list only: the same adds in the same order as the dense
// sum. The same holds for an xi cell while ll is finite (its terms are
// expf(-inf) = +0 and the cell stays +0); where ll is not finite every cell
// of that sequence takes the dense formula, term by term.
//
// Design. What bounds FBD is the chain of 2 (min(length, T) - 1) dependent
// steps (latency), not bytes or operations; a step is an exchange of the
// state vector, the list's terms, their max, the expfs, the ascending sum
// and one logf. Builds, by S (plan(); ops/cuda/forward_backward.py
// FBD_BUILDS and fb_dense_plan mirror it):
// - S <= 32, warp builds w8 / w16 / w32: a sequence on a group of 8 / 16 /
//   32 lanes of one warp (4 / 2 / 1 sequences a warp), a lane a state, its
//   alpha or beta in a register; a source's value comes by __shfl_sync from
//   its lane. No barrier on the chain. The sequences of a warp walk to the
//   warp's longest row; each keeps its own carry and stop.
// - S <= 64 / 128, block builds b64 / b128: a sequence a block, a thread a
//   state, the vector published to a double-buffered shared array, one
//   barrier a step. (One warp with 2 / 4 states a lane, a __syncwarp a
//   step, took 1.8-3.2x as long at S = 59; kernel_ab.py, PERF.md.)
// - A list's loops are unrolled to its bucket, the least of 1, 2, 3, 4, 6,
//   8, 16, 32 that holds the longest list of the warp or block
//   (by_bucket), and a step has no branch (store_if, select). The first 8
//   entries of a block build's list sit in registers, the rest are walked
//   from a bitmask (dense columns only).
// - Emissions: each thread copies its own log_b elements of the next 8
//   steps into a shared ring by cp.async while the current 8 run, so no
//   global load lies on a step's critical path, the step's loop is
//   unrolled only twice, and T has no limit.
// - Posteriors: forward (alpha to a scratch, rows past the length not
//   written), backward (beta likewise, gamma of the row a step behind, off
//   the chain; +0 on rows past the length), then xi over the backward's
//   row lists: a thread sums its row's finite cells over ascending t,
//   alpha_t, log_b[t+1] and beta_{t+1} staged by cp.async 8 rows ahead,
//   the destination's log_b + beta by shuffle (warp builds) or read from
//   the staged rows (block builds); a chunk's terms are all formed before
//   its ascending adds (formed between the adds, a word call took 15-20%
//   longer).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int MAX_STATES = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr int D = 8;   // emission rows a chunk of the shared ring
constexpr int DT = 8;  // rows a chunk of the posteriors' xi pass
// SKELETON: the forward's chain with the step cut to its exchange (the
// floor a step costs before any arithmetic); kernel_ab.py and chip_smoke.py
// time it.
enum { FORWARD = 0, BACKWARD = 1, POSTERIORS = 2, SKELETON = 3 };

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
  int B, T, S;
};

// A build: the most states it takes, threads a sequence, sequences a
// block. Kept in this order by FBD_BUILDS in ops/cuda/forward_backward.py.
struct Build {
  int max_states, threads, seqs_a_block;
};
enum { W8 = 0, W16, W32, B64, B128, N_BUILDS };
constexpr Build BUILDS[N_BUILDS] = {
    {8, 8, 4}, {16, 16, 2}, {32, 32, 1}, {64, 64, 1}, {128, 128, 1}};

int plan(int S) {
  if (S <= 8) return W8;
  if (S <= 16) return W16;
  if (S <= 32) return W32;
  return S <= 64 ? B64 : B128;
}

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ float a_entry(const float* __restrict__ log_a, int S, int i, int j) {
  return __ldg(log_a + (size_t)i * S + j);
}

// One float copied to shared memory by cp.async; live = false zero-fills
// the slot and reads nothing.
__device__ __forceinline__ void stage_float(float* dst, const float* src, bool live) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Straight-line forms of a conditional store and a select: a predicated
// st.global and a selp, so the compiler neither branches around the store
// of the lanes that hold a state nor sinks logf into a branch taken only
// by finite sums (each a BSSY / BSYNC region a step; without them a step
// took 5-7% longer, kernel_ab.py in turns).
__device__ __forceinline__ void store_if(float* p, float v, bool c) {
  asm volatile("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n @q st.global.f32 [%0], %1;\n}"
               ::"l"(p), "f"(v), "r"((unsigned)c)
               : "memory");
}
__device__ __forceinline__ float select(bool c, float a, float b) {
  float r;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %3, 0;\n selp.f32 %0, %1, %2, q;\n}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"((unsigned)c));
  return r;
}

// A state's entries of log_a that are not -inf, ascending: its column (the
// forward's sources, COLUMN) or its row (the backward's destinations). The
// first R in registers (a[k], idx[k] for k < n; -inf and the state itself
// past n), a bit for each further one in `over` (W words).
template <int R, int W>
struct Sources {
  float a[R];
  int idx[R];
  int n;
  unsigned over[W];
};

template <bool COLUMN, int R, int W>
__device__ __forceinline__ void find_sources(Sources<R, W>& L, const float* __restrict__ log_a,
                                             int S, int s, bool own) {
  unsigned mask[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = w * 32 + i;
      if (own && r < S) {
        const float v = COLUMN ? a_entry(log_a, S, r, s) : a_entry(log_a, S, s, r);
        m |= (unsigned)(v != neg_inf()) << i;
      }
    }
    mask[w] = m;
  }
  L.n = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    int r = -1;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (r < 0 && mask[w] != 0u) {
        r = w * 32 + __ffs(mask[w]) - 1;
        mask[w] &= mask[w] - 1u;
      }
    }
    L.idx[k] = r < 0 ? s : r;
    L.a[k] = r < 0 ? neg_inf() : (COLUMN ? a_entry(log_a, S, r, s) : a_entry(log_a, S, s, r));
    L.n += r >= 0;
  }
#pragma unroll
  for (int w = 0; w < W; ++w) L.over[w] = mask[w];
}

// A list's bucket: KB, the least of 1, 2, 3, 4, 6, 8, 16, 32 (up to R) that
// holds kmax (the longest list of the warp or block), as a compile-time
// constant, so each step's loops over the list unroll with no branch inside
// (a branch around a shuffle or an expf costs the step its overlap).
// f(Bucket<KB>{}).
template <int N>
struct Bucket {
  static constexpr int value = N;
};

__host__ __device__ constexpr int next_bucket(int kb) {
  return kb < 4 ? kb + 1 : kb == 4 ? 6 : kb == 6 ? 8 : 2 * kb;
}

template <int KB, int R, class F>
__device__ __forceinline__ void by_bucket(int kmax, F&& f) {
  if constexpr (KB >= R) {
    f(Bucket<R>{});
  } else {
    if (kmax <= KB)
      f(Bucket<KB>{});
    else
      by_bucket<next_bucket(KB), R>(kmax, f);
  }
}

// lse of KB terms (-inf past a thread's list: its entries there are -inf),
// in the dense sum's order: the max by a tree (exact in any order), every
// expf issued, then the ascending sum from +0 (a -inf term adds expf(-inf)
// = +0: no change). Where the max is not finite the sum is discarded, so
// the terms need no finite stand-in for it.
template <int KB>
__device__ __forceinline__ float lse_terms(const float (&x)[KB]) {
  float mx[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) mx[k] = x[k];
#pragma unroll
  for (int w = 1; w < KB; w *= 2)
#pragma unroll
    for (int k = 0; k + w < KB; k += 2 * w) mx[k] = fmaxf(mx[k], mx[k + w]);
  const float m = mx[0];
  const bool fin = isfinite(m);
  float e[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) e[k] = expf(x[k] - m);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < KB; ++k) s = __fadd_rn(s, e[k]);
  return select(fin, __fadd_rn(logf(s), m), m);
}

// lse of a vector in shared memory, ascending (the likelihood's).
__device__ __forceinline__ float lse_vector(const float* w, int S) {
  float m = neg_inf();
  for (int i = 0; i < S; ++i) m = fmaxf(m, w[i]);
  if (!isfinite(m)) return m;
  float s = 0.f;
  for (int i = 0; i < S; ++i) s = __fadd_rn(s, expf(w[i] - m));
  return __fadd_rn(logf(s), m);
}

// xi[i, j] by the dense formula, term by term over ascending t (alpha, beta
// and log_b from device memory): for a sequence whose ll is not finite, and
// for the cells past a block build's registers.
__device__ float xi_cell(const FBDArgs& p, size_t row0, int n, int i, int j, float ll) {
  const int S = p.S;
  const float a = a_entry(p.log_a, S, i, j);
  const float* al = p.alpha + row0;
  const float* bt = p.beta + row0;
  const float* lb = p.log_b + row0;
  float acc = 0.f;
  for (int t = 0; t + 1 < n; ++t) {
    const size_t q = (size_t)(t + 1) * S + j;
    acc = __fadd_rn(acc, expf(((al[(size_t)t * S + i] + a) + (lb[q] + bt[q])) - ll));
  }
  return acc;
}

// gamma's rows past the length (+0) and one row of xi: the finite cells'
// sums where ll is finite (+0 elsewhere), else every cell by the formula.
template <int KB, int R, int W>
__device__ __forceinline__ void store_tail(const FBDArgs& p, size_t row0, int b, int n, int s,
                                           float ll, const Sources<R, W>& L,
                                           const float (&acc)[KB]) {
  const int S = p.S;
  for (int t = max(n, 0); t < p.T; ++t) p.gamma[row0 + (size_t)t * S + s] = 0.f;
  float* xo = p.xi + (size_t)b * S * S + (size_t)s * S;
  if (isfinite(ll)) {
    for (int c = 0; c < S; ++c) xo[c] = 0.f;
#pragma unroll
    for (int k = 0; k < KB; ++k)
      if (k < L.n) xo[L.idx[k]] = acc[k];
#pragma unroll
    for (int w = 0; w < W; ++w)
      for (unsigned bits = L.over[w]; bits; bits &= bits - 1u) {
        const int c = w * 32 + __ffs(bits) - 1;
        xo[c] = xi_cell(p, row0, n, s, c, ll);
      }
  } else {
    for (int c = 0; c < S; ++c) xo[c] = xi_cell(p, row0, n, s, c, ll);
  }
}

// ---------------------------------------------------------------------------
// Warp builds (S <= G <= 32): 32 / G sequences a warp, a lane a state.

template <int MODE, int G>
__global__ void __launch_bounds__(32) fb_dense_warp(const FBDArgs p) {
  constexpr int R = G;  // a column or row has at most G entries
  // log_b rows ahead of the chain (the posteriors' backward adds alpha's),
  // and the xi pass's rows (alpha_t, log_b[t+1], beta_{t+1}).
  __shared__ float ring[2][MODE == POSTERIORS ? 2 * D : D][32];
  __shared__ float xring[MODE == POSTERIORS ? 2 : 1][DT][3][32];
  const int S = p.S, T = p.T;
  const int lane = threadIdx.x, j = lane % G;
  const int b = blockIdx.x * (32 / G) + lane / G;
  const bool seq = b < p.B;
  const bool own = seq && j < S;
  const int n = seq ? min(p.lengths[b], T) : 0;  // live rows (<= 0 for an empty one)
  const int nw = __reduce_max_sync(FULL, n);     // the warp walks to its longest row
  const size_t row0 = seq ? (size_t)b * T * S : 0;
  const float* lb = p.log_b + row0;
  auto shfl = [](float v, int src) { return __shfl_sync(FULL, v, src, G); };

  float ll = 0.f;
  if constexpr (MODE != BACKWARD) {
    Sources<R, 1> L;
    find_sources<true>(L, p.log_a, S, j, own);
    float* out = p.alpha + row0;
    float x = own ? p.log_init[j] + lb[j] : 0.f;
    if (own) out[j] = x;
    auto chain = [&](auto bucket) {
      constexpr int KB = decltype(bucket)::value;
      auto stage = [&](int c, int t0) {  // log_b rows t0 .. t0 + D - 1
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const int t = t0 + d;
          const bool live = own && t < n;
          stage_float(&ring[c & 1][d][lane], live ? lb + (size_t)t * S + j : p.log_b, live);
        }
        stage_commit();
      };
      stage(0, 1);
      for (int t0 = 1, c = 0; t0 < nw; t0 += D, ++c) {
        stage(c + 1, t0 + D);
        stage_wait<1>();
        const float* er = &ring[c & 1][0][lane];
        const int steps = min(D, nw - t0);
#pragma unroll 2
        for (int d = 0; d < steps; ++d) {
          const int t = t0 + d;
          const float e = er[d * 32];
          float y;
          if constexpr (MODE == SKELETON) {
            y = shfl(x, L.idx[0]) + e;
          } else {
            float terms[KB];
#pragma unroll
            for (int k = 0; k < KB; ++k) {
              terms[k] = shfl(x, L.idx[k]) + L.a[k];
            }
            y = lse_terms(terms) + e;
          }
          x = select(t < n, y, x);  // else the carry
          store_if(out + (size_t)t * S + j, x, own && (MODE != POSTERIORS || t < n));
        }
      }
      stage_wait<0>();
    };
    if constexpr (MODE == SKELETON)
      chain(Bucket<1>{});
    else
      by_bucket<1, R>(__reduce_max_sync(FULL, L.n), chain);
    if (MODE != POSTERIORS && own) {
      for (int t = max(nw, 1); t < T; ++t) out[(size_t)t * S + j] = x;  // the carry
    }
    if constexpr (MODE == SKELETON) return;
    // ll: a max over the group, then every lane sums the group's terms in
    // ascending state order.
    const float w = own ? (p.log_final ? x + p.log_final[j] : x) : neg_inf();
    float m = w;
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o, G));
    const bool fin = isfinite(m);
    const float ms = fin ? m : 0.f;
    const float ex = expf(w - ms);
    float s = 0.f;
    for (int i = 0; i < S; ++i) s = __fadd_rn(s, shfl(ex, i));
    ll = fin ? __fadd_rn(logf(s), ms) : m;
    if (MODE == FORWARD && seq && j == 0) p.ll[b] = ll;
  }

  if constexpr (MODE == BACKWARD || MODE == POSTERIORS) {
    Sources<R, 1> L;
    find_sources<false>(L, p.log_a, S, j, own);
    float* out = p.beta + row0;
    const float* al = p.alpha + row0;
    float* g = p.gamma + row0;
    const float be = own ? (p.log_final ? p.log_final[j] : 0.f) : 0.f;
    if (own) {
      for (int t = max(nw - 1, 0); t < T; ++t)
        if (MODE == BACKWARD || t < n) out[(size_t)t * S + j] = be;
    }
    if constexpr (MODE == POSTERIORS) __syncwarp();  // alpha rows, for the copies below
    by_bucket<1, R>(__reduce_max_sync(FULL, L.n), [&](auto bucket) {
      constexpr int KB = decltype(bucket)::value;
      float y = be;
      // Step t reads log_b[t + 1] (ring[.][d]) and, for gamma's row t + 1,
      // alpha_{t+1} (ring[.][D + d]); chunks walk t downwards.
      auto stage = [&](int c, int t0) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const int t = t0 - d;
          const bool live = own && t >= 0 && t + 1 < n;
          const size_t q = (size_t)(t + 1) * S + j;
          stage_float(&ring[c & 1][d][lane], live ? lb + q : p.log_b, live);
          if constexpr (MODE == POSTERIORS)
            stage_float(&ring[c & 1][D + d][lane], live ? al + q : p.log_b, live);
        }
        stage_commit();
      };
      stage(0, nw - 2);
      for (int t0 = nw - 2, c = 0; t0 >= 0; t0 -= D, ++c) {
        stage(c + 1, t0 - D);
        stage_wait<1>();
        const float* er = &ring[c & 1][0][lane];
        const int steps = min(D, t0 + 1);
#pragma unroll 2
        for (int d = 0; d < steps; ++d) {
          const int t = t0 - d;
          if constexpr (MODE == POSTERIORS) {
            // gamma's row t + 1 from y = beta_{t+1}: off this step's chain
            const float gamma = expf((er[(D + d) * 32] + y) - ll);
            store_if(g + (size_t)(t + 1) * S + j, gamma, own && t + 1 < n);
          }
          const float z = er[d * 32] + y;  // log_b[t+1, j] + beta_{t+1}[j]
          float terms[KB];
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            terms[k] = L.a[k] + shfl(z, L.idx[k]);
          }
          y = select(t + 1 < n, lse_terms(terms), y);  // else beta_end
          store_if(out + (size_t)t * S + j, y, own && (MODE == BACKWARD || t < n));
        }
      }
      stage_wait<0>();

      if constexpr (MODE == POSTERIORS) {
        if (own && n >= 1) g[j] = expf((al[j] + y) - ll);  // gamma's row 0
        __syncwarp();  // the group's beta rows
        // xi over this lane's row, pairs t ascending: alpha_t[j], log_b[t+1,
        // j] and beta_{t+1}[j] staged by cp.async a chunk ahead, the
        // destination's log_b + beta by shuffle. No branch in a chunk: a pair
        // past the row adds nothing (nothing staged, its terms not added).
        const float* bt = p.beta + row0;
        float acc[KB];
#pragma unroll
        for (int k = 0; k < KB; ++k) acc[k] = 0.f;
        auto stage_pairs = [&](int c, int t0) {
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            const int t = t0 + d;
            const bool live = own && t + 1 < n;
            const size_t r = (size_t)t * S + j, q = r + S;
            stage_float(&xring[c & 1][d][0][lane], live ? al + r : p.log_b, live);
            stage_float(&xring[c & 1][d][1][lane], live ? lb + q : p.log_b, live);
            stage_float(&xring[c & 1][d][2][lane], live ? bt + q : p.log_b, live);
          }
          stage_commit();
        };
        stage_pairs(0, 0);
        for (int t0 = 0, c = 0; t0 + 1 < nw; t0 += DT, ++c) {
          stage_pairs(c + 1, t0 + DT);
          stage_wait<1>();
          float term[DT][KB];
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            const float a_t = xring[c & 1][d][0][lane];
            const float z = xring[c & 1][d][1][lane] + xring[c & 1][d][2][lane];
#pragma unroll
            for (int k = 0; k < KB; ++k)
              term[d][k] = expf(((a_t + L.a[k]) + shfl(z, L.idx[k])) - ll);
          }
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            const bool live = t0 + d + 1 < n;
#pragma unroll
            for (int k = 0; k < KB; ++k)
              acc[k] = (live && k < L.n) ? __fadd_rn(acc[k], term[d][k]) : acc[k];
          }
        }
        stage_wait<0>();
        if (own) {
          store_tail(p, row0, b, n, j, ll, L, acc);
          if (j == 0) p.ll[b] = ll;
        }
      }
    });
  }
}

// ---------------------------------------------------------------------------
// Block builds (S <= NT): a sequence a block of NT threads, a thread a
// state, the vector through shared memory.

// lse over a list: its first KB entries' terms x_k = v[idx_k] + a_k (-inf
// past n), then the entries past the registers (`over`, ascending after
// them), in the dense sum's order.
template <bool COLUMN, int KB, int R, int W>
__device__ __forceinline__ float lse_shared(const Sources<R, W>& L, const float* v,
                                            const float* __restrict__ log_a, int S, int s) {
  float x[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    x[k] = v[L.idx[k]] + L.a[k];
  }
  bool more = false;
#pragma unroll
  for (int w = 0; w < W; ++w) more |= L.over[w] != 0u;
  if (!more) return lse_terms(x);
  // A column or row with more than R finite entries (KB = R here).
  float m = neg_inf();
#pragma unroll
  for (int k = 0; k < KB; ++k) m = fmaxf(m, x[k]);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    for (unsigned bits = L.over[w]; bits; bits &= bits - 1u) {
      const int i = w * 32 + __ffs(bits) - 1;
      m = fmaxf(m, v[i] + (COLUMN ? a_entry(log_a, S, i, s) : a_entry(log_a, S, s, i)));
    }
  }
  const bool fin = isfinite(m);
  const float ms = fin ? m : 0.f;
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < KB; ++k) sum = __fadd_rn(sum, expf(x[k] - ms));
#pragma unroll
  for (int w = 0; w < W; ++w) {
    for (unsigned bits = L.over[w]; bits; bits &= bits - 1u) {
      const int i = w * 32 + __ffs(bits) - 1;
      const float xi = v[i] + (COLUMN ? a_entry(log_a, S, i, s) : a_entry(log_a, S, s, i));
      sum = __fadd_rn(sum, expf(xi - ms));
    }
  }
  return select(fin, __fadd_rn(logf(sum), ms), m);
}

// The longest list of the block (R where one is longer), for its bucket.
template <int NT, int R, int W>
__device__ __forceinline__ int block_kmax(const Sources<R, W>& L, int* red) {
  bool more = false;
#pragma unroll
  for (int w = 0; w < W; ++w) more |= L.over[w] != 0u;
  const int k = __reduce_max_sync(FULL, more ? R : L.n);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = k;
  __syncthreads();
  int all = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) all = max(all, red[w]);
  __syncthreads();
  return all;
}

template <int MODE, int NT>
__global__ void __launch_bounds__(NT) fb_dense_block(const FBDArgs p) {
  constexpr int R = 8;              // list entries in registers
  constexpr int W = NT / 32;        // bitmask words
  __shared__ float vbuf[2][NT];     // the published vector, double-buffered
  // emission rows ahead; the posteriors' backward adds alpha's
  __shared__ float ring[2][MODE == POSTERIORS ? 2 * D : D][NT];
  __shared__ float xring[MODE == POSTERIORS ? 2 : 1][DT][3][NT];  // the xi pass's rows
  __shared__ float ll_s;
  __shared__ int red[NT / 32];
  const int S = p.S, T = p.T, s = threadIdx.x, b = blockIdx.x;
  const bool own = s < S;
  const int n = min(p.lengths[b], T);  // block-uniform
  const size_t row0 = (size_t)b * T * S;
  const float* lb = p.log_b + row0;

  float ll = 0.f;
  if constexpr (MODE != BACKWARD) {
    Sources<R, W> L;
    find_sources<true>(L, p.log_a, S, s, own);
    float* out = p.alpha + row0;
    float x = own ? p.log_init[s] + lb[s] : 0.f;
    if (own) out[s] = x;
    auto chain = [&](auto bucket) {
      constexpr int KB = decltype(bucket)::value;
      auto stage = [&](int c, int t0) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const int t = t0 + d;
          const bool live = own && t < n;
          stage_float(&ring[c & 1][d][s], live ? lb + (size_t)t * S + s : p.log_b, live);
        }
        stage_commit();
      };
      stage(0, 1);
      for (int t0 = 1, c = 0; t0 < n; t0 += D, ++c) {
        stage(c + 1, t0 + D);
        stage_wait<1>();
        const float* er = &ring[c & 1][0][s];
        const int steps = min(D, n - t0);
#pragma unroll 2
        for (int d = 0; d < steps; ++d) {
          const int t = t0 + d;
          const float e = er[d * NT];
          float* v = vbuf[t & 1];
          v[s] = x;
          __syncthreads();
          if constexpr (MODE == SKELETON)
            x = v[L.idx[0]] + e;
          else
            x = lse_shared<true, KB>(L, v, p.log_a, S, s) + e;
          store_if(out + (size_t)t * S + s, x, own);
        }
      }
      stage_wait<0>();
    };
    if constexpr (MODE == SKELETON)
      chain(Bucket<1>{});
    else
      by_bucket<1, R>(block_kmax<NT>(L, red), chain);
    if (MODE != POSTERIORS && own) {
      for (int t = max(n, 1); t < T; ++t) out[(size_t)t * S + s] = x;  // the carry
    }
    if constexpr (MODE == SKELETON) return;
    // ll: the last step read vbuf[(n - 1) & 1]; this writes the other half.
    float* w = vbuf[max(n, 1) & 1];
    if (own) w[s] = p.log_final ? x + p.log_final[s] : x;
    __syncthreads();
    if (s == 0) {
      ll_s = lse_vector(w, S);
      if (MODE == FORWARD) p.ll[b] = ll_s;
    }
    __syncthreads();
    ll = ll_s;
  }

  if constexpr (MODE == BACKWARD || MODE == POSTERIORS) {
    Sources<R, W> L;
    find_sources<false>(L, p.log_a, S, s, own);
    float* out = p.beta + row0;
    const float* al = p.alpha + row0;
    float* g = p.gamma + row0;
    float y = own ? (p.log_final ? p.log_final[s] : 0.f) : 0.f;
    if (own) {
      for (int t = max(n - 1, 0); t < T; ++t)
        if (MODE == BACKWARD || t < n) out[(size_t)t * S + s] = y;
    }
    by_bucket<1, R>(block_kmax<NT>(L, red), [&](auto bucket) {
      constexpr int KB = decltype(bucket)::value;
      // Step t reads log_b[t + 1] (ring[.][d]) and, for gamma's row t + 1,
      // alpha_{t+1} (ring[.][D + d]); chunks walk t downwards.
      auto stage = [&](int c, int t0) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const int t = t0 - d;
          const bool live = own && t >= 0;
          const size_t q = (size_t)(t + 1) * S + s;
          stage_float(&ring[c & 1][d][s], live ? lb + q : p.log_b, live);
          if constexpr (MODE == POSTERIORS)
            stage_float(&ring[c & 1][D + d][s], live ? al + q : p.log_b, live);
        }
        stage_commit();
      };
      stage(0, n - 2);
      for (int t0 = n - 2, c = 0; t0 >= 0; t0 -= D, ++c) {
        stage(c + 1, t0 - D);
        stage_wait<1>();
        const float* er = &ring[c & 1][0][s];
        const int steps = min(D, t0 + 1);
#pragma unroll 2
        for (int d = 0; d < steps; ++d) {
          const int t = t0 - d;
          if constexpr (MODE == POSTERIORS) {
            // gamma's row t + 1 from y = beta_{t+1}: off this step's chain
            const float gamma = expf((er[(D + d) * NT] + y) - ll);
            store_if(g + (size_t)(t + 1) * S + s, gamma, own);
          }
          float* v = vbuf[t & 1];
          v[s] = er[d * NT] + y;  // log_b[t+1, s] + beta_{t+1}[s]
          __syncthreads();
          y = lse_shared<false, KB>(L, v, p.log_a, S, s);
          store_if(out + (size_t)t * S + s, y, own);
        }
      }
      stage_wait<0>();

      if constexpr (MODE == POSTERIORS) {
        if (own && n >= 1) g[s] = expf((al[s] + y) - ll);  // gamma's row 0
        __syncthreads();  // every thread's beta rows
        // xi over the own state's row: DT pairs' alpha_t, log_b[t+1] and
        // beta_{t+1} of every state staged by cp.async a chunk ahead (a
        // barrier a chunk); a destination's log_b + beta is added here.
        const float* bt = p.beta + row0;
        float acc[KB];
#pragma unroll
        for (int k = 0; k < KB; ++k) acc[k] = 0.f;
        auto stage_pairs = [&](int c, int t0) {
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            const int t = t0 + d;
            const bool live = own && t + 1 < n;
            const size_t r = (size_t)t * S + s, q = r + S;
            stage_float(&xring[c & 1][d][0][s], live ? al + r : p.log_b, live);
            stage_float(&xring[c & 1][d][1][s], live ? lb + q : p.log_b, live);
            stage_float(&xring[c & 1][d][2][s], live ? bt + q : p.log_b, live);
          }
          stage_commit();
        };
        stage_pairs(0, 0);
        for (int t0 = 0, c = 0; t0 + 1 < n; t0 += DT, ++c) {
          // chunk c landed everywhere, and every thread is done with the
          // half that chunk c + 1 takes
          stage_wait<0>();
          __syncthreads();
          stage_pairs(c + 1, t0 + DT);
          float(*xr)[3][NT] = xring[c & 1];
          float term[DT][KB];
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            const float a_t = xr[d][0][s];
#pragma unroll
            for (int k = 0; k < KB; ++k) {
              const int c2 = L.idx[k];
              term[d][k] = expf(((a_t + L.a[k]) + (xr[d][1][c2] + xr[d][2][c2])) - ll);
            }
          }
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            const bool live = t0 + d + 1 < n;
#pragma unroll
            for (int k = 0; k < KB; ++k)
              acc[k] = (live && k < L.n) ? __fadd_rn(acc[k], term[d][k]) : acc[k];
          }
        }
        stage_wait<0>();
        if (own) store_tail(p, row0, b, n, s, ll, L, acc);
        if (s == 0) p.ll[b] = ll;
      }
    });
  }
}

template <int MODE>
int launch(int build, const FBDArgs& a, cudaStream_t st) {
  const int grid = (a.B + BUILDS[build].seqs_a_block - 1) / BUILDS[build].seqs_a_block;
  switch (build) {
    case W8: fb_dense_warp<MODE, 8><<<grid, 32, 0, st>>>(a); break;
    case W16: fb_dense_warp<MODE, 16><<<grid, 32, 0, st>>>(a); break;
    case W32: fb_dense_warp<MODE, 32><<<grid, 32, 0, st>>>(a); break;
    case B64: fb_dense_block<MODE, 64><<<grid, 64, 0, st>>>(a); break;
    case B128: fb_dense_block<MODE, 128><<<grid, 128, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Largest S the kernel takes.
extern "C" int cs304_fb_dense_max_states() { return MAX_STATES; }

// The build that takes S states (-1 past the range), and a build's shape:
// out[3] = (most states, threads a sequence, sequences a block); returns
// the number of builds.
extern "C" int cs304_fb_dense_plan(int S) {
  return (S < 1 || S > MAX_STATES) ? -1 : plan(S);
}
extern "C" int cs304_fb_dense_build_shape(int build, int* out) {
  if (build < 0 || build >= N_BUILDS) return N_BUILDS;
  out[0] = BUILDS[build].max_states;
  out[1] = BUILDS[build].threads;
  out[2] = BUILDS[build].seqs_a_block;
  return N_BUILDS;
}

// cs304_fb_dense on a given build (any whose most states is >= S); mode 3
// is the skeleton: the forward's chain cut to its exchange, alpha written
// (its values are not FBD's), nothing else.
extern "C" int cs304_fb_dense_on(int build, int mode, const void* log_b, const void* log_a,
                                 const void* log_init, const void* log_final,
                                 const void* lengths, void* alpha, void* beta, void* gamma,
                                 void* xi, void* ll, int B, int T, int S, void* stream) {
  if (build < 0 || build >= N_BUILDS || B < 1 || T < 1 || S < 1 ||
      S > BUILDS[build].max_states)
    return (int)cudaErrorInvalidValue;
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
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case FORWARD:
      if (!alpha || !ll) return (int)cudaErrorInvalidValue;
      return launch<FORWARD>(build, a, st);
    case BACKWARD:
      if (!beta) return (int)cudaErrorInvalidValue;
      return launch<BACKWARD>(build, a, st);
    case POSTERIORS:
      if (!alpha || !beta || !gamma || !xi || !ll) return (int)cudaErrorInvalidValue;
      return launch<POSTERIORS>(build, a, st);
    case SKELETON:
      if (!alpha) return (int)cudaErrorInvalidValue;
      return launch<SKELETON>(build, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// mode 0 forward -> alpha (B, T, S), ll (B,); 1 backward -> beta (B, T, S);
// 2 posteriors -> gamma (B, T, S), xi (B, S, S), ll (B,), with alpha and
// beta (B, T, S) as its scratch. log_final may be null. All contiguous
// float32 / int32 on one device. The build is plan(S).
extern "C" int cs304_fb_dense(int mode, const void* log_b, const void* log_a,
                              const void* log_init, const void* log_final,
                              const void* lengths, void* alpha, void* beta, void* gamma,
                              void* xi, void* ll, int B, int T, int S, void* stream) {
  if (S < 1 || S > MAX_STATES || mode < FORWARD || mode > POSTERIORS)
    return (int)cudaErrorInvalidValue;
  return cs304_fb_dense_on(plan(S), mode, log_b, log_a, log_init, log_final, lengths, alpha,
                           beta, gamma, xi, ll, B, T, S, stream);
}
