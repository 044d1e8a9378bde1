// The posterior and n-best searches of the composite decoder, for Hopper:
// LSUM (the sum-semiring passes), LMAX (the max-plus lattice passes) and
// KBEST (the k-best forward).
//
// They replace lax.scans of the JAX package (it has no Pallas kernel of
// them):
// - LSUM: cs304_tpu/ops/lattice.py:312 _sum_passes_masked (vmapped by :361
//   _sum_passes_batch): a log-sum-exp forward and backward over the
//   composite's dense (S, S) matrix (ops/viterbi.py:329
//   composite_transition_matrix), length-masked.
// - LMAX: cs304_tpu/ops/lattice.py:227 _lattice_passes_impl: the max-plus
//   forward with its first-max argmax and the word-entry-time carry, and
//   the max-plus backward.
// - KBEST: cs304_tpu/ops/nbest.py:27 kbest_composite_forward: K hypotheses
//   a state, each step a stable top K.
// Plain versions, the specification: cs304_tpu_torch/ops/cuda/
// trellis_lattice.py lattice_sum_passes_plain, lattice_max_passes_plain,
// kbest_forward_plain. The composite enters as its O(S) topology table
// (LatticeTopology: pack_coefs' rows diag_ne, sub1, sub2, diag_e, entry,
// exit, diag_init; the exit and entry lists, ascending; per state its
// word, word entry and word exit), never as the (S, S) matrix: a column of
// that matrix is the band (j-2, j-1, j) of a non-entry, or for an entry e
// the penalty from every exit and d[e] = max(penalty if e is an exit,
// diag_e[e]) at (e, e).
//
// LSUM's order. Every log-sum-exp is m + logf(acc): m the max of its terms
// (exact), acc the sum from +0 of expf(term - m), one term at a time in the
// dense matrix's index order, with IEEE expf / logf (no fast math); -inf
// where m is. A forward column j: alpha[j-2] + sub2[j], alpha[j-1] +
// sub1[j], alpha[j] + diag_ne[j]; an entry e: alpha[x] + penalty over the
// exits x ascending, alpha[e] + d[e] at e's own index in place of e's exit
// term (so a single-state word's column takes the pool without its own
// exit term, with no subtraction); then + log_b[t, j]. A backward row j on
// beta_em = log_b[t] + beta: c[j] + beta_em[j] (c = diag_ne, or d at an
// entry), sub1[j+1] + beta_em[j+1], sub2[j+2] + beta_em[j+2], and at an
// exit penalty + beta_em[e] over the entries ascending, all merged in index
// order. beta_entry[t] and log Z: the same over the entries of beta_em[t]
// and the exits of the final alpha. A pool of more than DENSE_POOL_MAX (32)
// members is factorized instead, O(W) a step where the dense order is
// O(W^2) (1001 exits: 0.94 ms a step): one sum P a step of expf(u - mp)
// over the members' dense cells u (alpha[x] + penalty; penalty +
// beta_em[e]) with mp their max, member i into lane i mod 32 from +0, then
// the lanes by the xor butterfly (adjacent pairs), in every warp alike; a
// pool cell is m + logf(((its band's expfs in order) + P * expf(mp - m)) +
// expf(own - m)), the product rounded on its own (no FMA), own the cell's
// own dense term apart from the pool (-inf where it is the pool's own
// term: an exit whose penalty is at least its self-loop), and a
// single-state word whose self-loop beats the penalty sums the other
// members one at a time instead of P. The plain version runs the same
// operations in the same order, so the card differs from it only where
// expf / logf round differently from the CPU's (a few float32 ulps; the
// card check: -inf cells identical, the rest within 1e-5 * max(1, |x|)).
// LMAX and KBEST are max / compare / add only, bitwise their plain
// versions.
//
// Design (a simple first design: right first, fast later).
// - LSUM: a block a row's forward and a block its backward (grid (B, 2)),
//   K = 1 / 2 / 4 / 8 states a thread (S <= 8,192), the carry in shared
//   memory (a double buffer, so ONE __syncthreads a step) and in the
//   owners' registers. A step's block-wide max over the exits (forward) or
//   entries (backward) is reduced beside the cells: each warp's max goes to
//   a parity slot before the barrier and every warp folds the slots after
//   it. Up to 32 members an entry column's (an exit row's) sum walks the
//   exit (entry) list from shared memory in the owning thread, O(W) a pool
//   cell; past it every warp sums the factorized pool at the step's start
//   (W / 32 expf a lane and a butterfly, no second barrier). The backward's beta_entry
//   rows are summed after the loop, a row a thread, from beta_em in device
//   memory.
// - LMAX: one block for the forward and one for the backward of the
//   utterance, the same layout and one barrier a step. The forward's pool
//   is the best exit by (alpha + penalty, lowest index), reduced like
//   LSUM's max; an entry compares it with its own cell (the lowest index
//   wins a tie: the dense column's first max); a column all -inf points at
//   0. A single-state word needs no exclusion here: where its self-loop
//   beats the penalty its own exit term is strictly below its own cell.
//   The entry-time carry is read from the previous step's shared row at
//   the argmax.
// - KBEST: one block, the hypothesis rows (S x K) in shared memory where
//   they fit, else in a device scratch (read through L1 after the step's
//   barrier). A step: (1) each warp merges its lanes' exit rows (each row
//   non-increasing) into its top K by K rounds of a warp argmax on
//   (value desc, flat index asc); (2) warp 0 merges the warps' lists the
//   same way into the pool's top K, then fills the -inf tail with the
//   lowest flat indices whose value is -inf (masked non-exit rows
//   included), as lax.top_k's stable order does; (3) each state merges
//   its candidates: a non-entry the three sorted blocks (s-2, s-1, s), the
//   earlier block on a tie; an entry the finite parts of [pool + penalty,
//   own K self-loops] with the duplicate-prefix masks, the pool on a tie,
//   then the -inf candidates in index order (masked ones included). A row
//   j's pool members are its slots [0, c_j) (a row enters the pool as a
//   prefix, and the -inf fill continues it), so the self-loop mask is
//   slot < c_j. Three barriers a step.
//
// What bounds them on this card: the chain of dependent steps (latency):
// LSUM and LMAX one barrier, a few shared loads and (LSUM) expf / logf
// a step; LSUM's pool cells walk their pool serially (up to 32 members) or
// each warp sums the factorized pool, W / 32 expf a lane a step; KBEST
// 2K rounds of warp argmaxes and three barriers. The bytes (log_b read,
// the passes' rows written once) are far below it.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_STATES = 8192;
constexpr int KBEST_ROWS = 8;  // exit rows a thread holds: 8,192 / 1,024
// LSUM sums a pool of at most this many members in the dense order, O(W) a
// cell; past it the pool is factorized (one shared sum a step).
constexpr int DENSE_POOL_MAX = 32;
constexpr size_t KBEST_SMEM_MAX = 200 * 1024;

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// The topology table (ops/cuda/trellis_lattice.LatticeTopology).
struct Topo {
  const float* coefs;  // (8, S): diag_ne, sub1, sub2, diag_e, entry, exit, diag_init
  const int* ints;     // (3, S): word, word entry (lower), word exit (upper)
  const int* exits;    // (n_exits,) ascending
  const int* entries;  // (n_entries,) ascending
  int S, n_exits, n_entries;
  __device__ __forceinline__ float c(int row, int j) const {
    return __ldg(coefs + (size_t)row * S + j);
  }
  __device__ __forceinline__ int i(int row, int j) const {
    return __ldg(ints + (size_t)row * S + j);
  }
  __device__ __forceinline__ bool is_entry(int j) const { return c(4, j) > 0.f; }
  __device__ __forceinline__ bool is_exit(int j) const { return c(5, j) > 0.f; }
  // d[j]: an entry's own cell of the dense matrix, -inf off the entries.
  __device__ __forceinline__ float own_cell(int j, float pen) const {
    if (!is_entry(j)) return neg_inf();
    return fmaxf(is_exit(j) ? pen : neg_inf(), c(3, j));
  }
};

int states_per_thread(int S) { return S <= 1024 ? 1 : S <= 2048 ? 2 : S <= 4096 ? 4 : 8; }

int block_threads(int S, int k) {
  const int per = (S + k - 1) / k;
  return 32 * ((per + 31) / 32);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// The max of nw warps' partials (every lane of the calling warp gets it).
__device__ __forceinline__ float fold_max(const float* slot, int nw) {
  const int lane = threadIdx.x & 31;
  return warp_max(lane < nw ? slot[lane] : neg_inf());
}

// (value, index) argmax, the larger value first and the lower index on a tie.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// -- LSUM ---------------------------------------------------------------------

struct SumArgs {
  const float* log_b;  // (B, T, S)
  Topo tp;
  const int* lengths;  // (B,)
  float pen;
  float* alphas;       // (B, T, S)
  float* beta_em;      // (B, T, S)
  float* beta_entry;   // (B, T)
  float* log_z;        // (B,)
  int B, T;
};

// The factorized pool's sum, in every lane of the calling warp: member i
// (ascending) added from +0 into lane i mod 32, expf((v + pen) - mp) each
// (the member's dense cell against the pool's max mp; 0 where mp is -inf),
// then the lanes by the xor butterfly (adjacent pairs).
__device__ __forceinline__ float lane_pool_sum(const float* vals, const int* list, int n,
                                               float pen, float mp) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  if (isfinite(mp))
    for (int i = lane; i < n; i += 32) acc = acc + expf((vals[list[i]] + pen) - mp);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) acc = acc + __shfl_xor_sync(FULL, acc, off);
  return acc;
}

// A single-state word's factorized pool without itself: the other members'
// expf((v + pen) - mp), ascending, from +0.
__device__ __forceinline__ float pool_sum_without(const float* vals, const int* list, int n,
                                                  float pen, float mp, int self) {
  float acc = 0.f;
  if (isfinite(mp))
    for (int i = 0; i < n; ++i)
      if (list[i] != self) acc = acc + expf((vals[list[i]] + pen) - mp);
  return acc;
}

// m + logf(acc) of three terms in order, -inf where m is.
__device__ __forceinline__ float lse3_seq(float t0, float t1, float t2) {
  const float m = fmaxf(fmaxf(t0, t1), t2);
  if (!isfinite(m)) return neg_inf();
  return m + logf((expf(t0 - m) + expf(t1 - m)) + expf(t2 - m));
}

template <int K>
__device__ void sum_forward(const SumArgs& a, float* buf, float* wslot, int* list) {
  const Topo& tp = a.tp;
  const int S = tp.S, T = a.T, b = blockIdx.x;
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int nx = tp.n_exits;
  const float pen = a.pen;
  const float* lb = a.log_b + (size_t)b * T * S;
  float* out = a.alphas + (size_t)b * T * S;
  const int len = a.lengths[b];
  for (int i = tid; i < nx; i += nt) list[i] = tp.exits[i];

  // The carry of the thread's states j = tid + k nt, and the next emission
  // row; the coefficients are read through L1 each step.
  float al[K], lbn[K];
  float mx = neg_inf();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = tid + k * nt;
    al[k] = neg_inf();
    lbn[k] = 0.f;
    if (j < S) {
      al[k] = tp.is_entry(j) ? lb[j] + tp.c(6, j) : neg_inf();
      buf[j] = al[k];
      out[j] = al[k];
      if (tp.is_exit(j)) mx = fmaxf(mx, al[k]);
      if (T > 1) lbn[k] = lb[(size_t)S + j];
    }
  }
  mx = warp_max(mx);
  if (lane == 0) wslot[warp] = mx;
  __syncthreads();

  const int tl = min(len, T);
  for (int t = 1; t < tl; ++t) {
    const int cur = (t - 1) & 1, nxt = t & 1;
    const float* ac = buf + cur * S;
    float* an = buf + nxt * S;
    const float amax = fold_max(wslot + cur * 32, nw);
    const float mp = amax + pen;
    const bool factorized = nx > DENSE_POOL_MAX;
    const float pool = factorized ? lane_pool_sum(ac, list, nx, pen, mp) : 0.f;
    mx = neg_inf();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + k * nt;
      if (j >= S) continue;
      const float lbt = lbn[k];
      if (t + 1 < tl) lbn[k] = lb[(size_t)(t + 1) * S + j];
      float v;
      if (!tp.is_entry(j)) {
        const float t2 = (j >= 2 ? ac[j - 2] : neg_inf()) + tp.c(2, j);
        const float t1 = (j >= 1 ? ac[j - 1] : neg_inf()) + tp.c(1, j);
        v = lse3_seq(t2, t1, al[k] + tp.c(0, j));
      } else if (factorized) {
        // The own cell apart, unless it is the pool's own term (an exit
        // whose penalty is at least its self-loop); a single-state word
        // whose self-loop beats the penalty sums the pool without itself.
        const bool ext = tp.is_exit(j), excl = ext && tp.c(3, j) > pen;
        const float own = (ext && !excl) ? neg_inf() : al[k] + tp.own_cell(j, pen);
        const float m = fmaxf(mp, own);
        v = neg_inf();
        if (isfinite(m)) {
          const float pe = excl ? pool_sum_without(ac, list, nx, pen, mp, j) : pool;
          const float part = isfinite(mp) ? __fmul_rn(pe, expf(mp - m)) : 0.f;
          v = m + logf((0.f + part) + expf(own - m));
        }
      } else {
        const float own = al[k] + tp.own_cell(j, pen);
        const float m = fmaxf(mp, own);
        v = neg_inf();
        if (isfinite(m)) {
          const float e_own = expf(own - m);
          float acc = 0.f;
          bool done = false;
          for (int i = 0; i < nx; ++i) {
            const int x = list[i];
            if (!done && j < x) {
              acc = acc + e_own;
              done = true;
            }
            if (x == j) {
              acc = acc + e_own;
              done = true;
            } else {
              acc = acc + expf((ac[x] + pen) - m);
            }
          }
          if (!done) acc = acc + e_own;
          v = m + logf(acc);
        }
      }
      al[k] = v + lbt;
      an[j] = al[k];
      out[(size_t)t * S + j] = al[k];
      if (tp.is_exit(j)) mx = fmaxf(mx, al[k]);
    }
    mx = warp_max(mx);
    if (lane == 0) wslot[nxt * 32 + warp] = mx;
    __syncthreads();
  }
  // Steps at t >= length keep the carry.
  for (int t = max(tl, 1); t < T; ++t) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + k * nt;
      if (j < S) out[(size_t)t * S + j] = al[k];
    }
  }
  if (tid == 0) {
    const int fin = (max(tl, 1) - 1) & 1;
    float amax = neg_inf();
    for (int w = 0; w < nw; ++w) amax = fmaxf(amax, wslot[fin * 32 + w]);
    float z = neg_inf();
    if (isfinite(amax)) {
      float acc = 0.f;
      for (int i = 0; i < nx; ++i) acc = acc + expf(buf[fin * S + list[i]] - amax);
      z = amax + logf(acc);
    }
    a.log_z[b] = z;
  }
}

// A backward row j's band cells: c[j] + beta_em[j] (c = diag_ne, or the
// own cell at an entry), sub1[j+1] + beta_em[j+1], sub2[j+2] + beta_em[j+2].
__device__ __forceinline__ void band_row(const Topo& tp, int j, float pen, float bem,
                                         const float* bb, float& t0, float& t1, float& t2) {
  const int S = tp.S;
  t0 = (tp.is_entry(j) ? tp.own_cell(j, pen) : tp.c(0, j)) + bem;
  t1 = j + 1 < S ? tp.c(1, j + 1) + bb[j + 1] : neg_inf();
  t2 = j + 2 < S ? tp.c(2, j + 2) + bb[j + 2] : neg_inf();
}

template <int K>
__device__ void sum_backward(const SumArgs& a, float* buf, float* wslot, int* list) {
  const Topo& tp = a.tp;
  const int S = tp.S, T = a.T, b = blockIdx.x;
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int ne = tp.n_entries;
  const float pen = a.pen;
  const float* lb = a.log_b + (size_t)b * T * S;
  float* out = a.beta_em + (size_t)b * T * S;
  const int len = a.lengths[b];
  for (int i = tid; i < ne; i += nt) list[i] = tp.entries[i];

  float beta[K], lbn[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = tid + k * nt;
    beta[k] = neg_inf();
    lbn[k] = 0.f;
    if (j < S) {
      beta[k] = tp.is_exit(j) ? 0.f : neg_inf();
      lbn[k] = lb[(size_t)(T - 1) * S + j];
    }
  }
  for (int t = T - 1;; --t) {
    const int par = t & 1;
    float* bb = buf + par * S;
    float bem[K];
    float mx = neg_inf();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + k * nt;
      bem[k] = neg_inf();
      if (j >= S) continue;
      // The exit terminal again at t == length - 1 (not at t = 0).
      const float here = (t >= 1 && t == len - 1) ? (tp.is_exit(j) ? 0.f : neg_inf()) : beta[k];
      bem[k] = lbn[k] + here;
      if (t >= 1) lbn[k] = lb[(size_t)(t - 1) * S + j];
      bb[j] = bem[k];
      out[(size_t)t * S + j] = bem[k];
      if (tp.is_entry(j)) mx = fmaxf(mx, bem[k]);
    }
    if (t == 0) break;
    mx = warp_max(mx);
    if (lane == 0) wslot[par * 32 + warp] = mx;
    __syncthreads();
    const float bmax = fold_max(wslot + par * 32, nw);
    const float mq = bmax + pen;
    const bool factorized = ne > DENSE_POOL_MAX;
    const float pool = factorized ? lane_pool_sum(bb, list, ne, pen, mq) : 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + k * nt;
      if (j >= S) continue;
      float t0, t1, t2;
      band_row(tp, j, pen, bem[k], bb, t0, t1, t2);
      if (!tp.is_exit(j)) {
        beta[k] = lse3_seq(t0, t1, t2);
        continue;
      }
      if (factorized) {
        // The band apart; an entry's own cell is the pool's own term where
        // the penalty is at least its self-loop, else the pool skips it.
        const bool ent = tp.is_entry(j), excl = ent && tp.c(3, j) > pen;
        if (ent && !excl) t0 = neg_inf();
        const float m = fmaxf(fmaxf(fmaxf(t0, t1), t2), mq);
        float v = neg_inf();
        if (isfinite(m)) {
          const float qe = excl ? pool_sum_without(bb, list, ne, pen, mq, j) : pool;
          const float part = isfinite(mq) ? __fmul_rn(qe, expf(mq - m)) : 0.f;
          v = m + logf(((expf(t0 - m) + expf(t1 - m)) + expf(t2 - m)) + part);
        }
        beta[k] = v;
        continue;
      }
      const float m = fmaxf(fmaxf(fmaxf(t0, t1), t2), mq);
      float v = neg_inf();
      if (isfinite(m)) {
        // The band cells merged into the entries' in index order; the
        // entry j itself is t0.
        const float e0 = expf(t0 - m), e1 = expf(t1 - m), e2 = expf(t2 - m);
        float acc = 0.f;
        bool f0 = false, f1 = false, f2 = false;
        for (int i = 0; i < ne; ++i) {
          const int e = list[i];
          if (!f0 && j < e) {
            acc = acc + e0;
            f0 = true;
          }
          if (!f1 && j + 1 < e) {
            acc = acc + e1;
            f1 = true;
          }
          if (!f2 && j + 2 < e) {
            acc = acc + e2;
            f2 = true;
          }
          if (e != j) acc = acc + expf((pen + bb[e]) - m);
        }
        if (!f0) acc = acc + e0;
        if (!f1) acc = acc + e1;
        if (!f2) acc = acc + e2;
        v = m + logf(acc);
      }
      beta[k] = v;
    }
  }
  __syncthreads();  // the beta_em rows in device memory, read back below
  for (int t = tid; t < T; t += nt) {
    const float* row = out + (size_t)t * S;
    float bm = neg_inf();
    for (int i = 0; i < ne; ++i) bm = fmaxf(bm, row[list[i]]);
    float v = neg_inf();
    if (isfinite(bm)) {
      float acc = 0.f;
      for (int i = 0; i < ne; ++i) acc = acc + expf(row[list[i]] - bm);
      v = bm + logf(acc);
    }
    a.beta_entry[(size_t)b * T + t] = v;
  }
}

template <int K>
__global__ void __launch_bounds__(MAX_THREADS) lattice_sum_kernel(SumArgs a) {
  extern __shared__ float smem[];
  float* buf = smem;                       // [2][S]
  float* wslot = smem + 2 * a.tp.S;        // [2][32]
  int* list = (int*)(wslot + 64);          // the pool's members
  if (blockIdx.y == 0) {
    sum_forward<K>(a, buf, wslot, list);
  } else {
    sum_backward<K>(a, buf, wslot, list);
  }
}

// -- LMAX ---------------------------------------------------------------------

struct MaxArgs {
  const float* log_b;  // (T, S)
  Topo tp;
  float pen;
  int len;
  float* alphas;      // (T, S)
  int* ets;           // (T, S)
  float* beta_entry;  // (T,)
  float* score;       // ()
  int T;
};

template <int K>
__device__ void max_forward(const MaxArgs& a, float* smem) {
  const Topo& tp = a.tp;
  const int S = tp.S, T = a.T;
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const float pen = a.pen;
  float* abuf = smem;                // [2][S]
  int* ebuf = (int*)(smem + 2 * S);  // [2][S]
  float* wv = smem + 4 * S;          // [2][32]
  int* wi = (int*)(wv + 64);         // [2][32]
  float* ws = wv + 128;              // [32], the score

  float al[K], lbn[K];
  int et[K];
  float bv = neg_inf();
  int bi = INT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = tid + k * nt;
    al[k] = neg_inf();
    et[k] = 0;
    lbn[k] = 0.f;
    if (j < S) {
      al[k] = tp.is_entry(j) ? a.log_b[j] + tp.c(6, j) : neg_inf();
      abuf[j] = al[k];
      ebuf[j] = 0;
      a.alphas[j] = al[k];
      a.ets[j] = 0;
      if (tp.is_exit(j) && better(al[k] + pen, j, bv, bi)) {
        bv = al[k] + pen;
        bi = j;
      }
      if (T > 1) lbn[k] = a.log_b[(size_t)S + j];
    }
  }
  warp_best(bv, bi);
  if (lane == 0) {
    wv[warp] = bv;
    wi[warp] = bi;
  }
  __syncthreads();

  const int tl = min(a.len, T);
  for (int t = 1; t < tl; ++t) {
    const int cur = (t - 1) & 1, nxt = t & 1;
    const float* ac = abuf + cur * S;
    const int* ec = ebuf + cur * S;
    // The best exit of the previous step: (alpha + penalty, lowest index).
    float pv = lane < nw ? wv[cur * 32 + lane] : neg_inf();
    int pi = lane < nw ? wi[cur * 32 + lane] : INT_MAX;
    warp_best(pv, pi);
    bv = neg_inf();
    bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + k * nt;
      if (j >= S) continue;
      const float lbt = lbn[k];
      if (t + 1 < tl) lbn[k] = a.log_b[(size_t)(t + 1) * S + j];
      float v;
      int p;
      if (!tp.is_entry(j)) {  // predecessors j-2, j-1, j: the first max
        v = neg_inf();
        p = 0;
        if (j >= 2) {
          v = ac[j - 2] + tp.c(2, j);
          p = j - 2;
        }
        if (j >= 1) {
          const float v1 = ac[j - 1] + tp.c(1, j);
          if (v1 > v) {
            v = v1;
            p = j - 1;
          }
        }
        const float v0 = al[k] + tp.c(0, j);
        if (v0 > v) {
          v = v0;
          p = j;
        }
      } else {  // every exit, and the entry's own cell at its index
        v = pv;
        p = pi;
        const float own = al[k] + tp.own_cell(j, pen);
        if (better(own, j, v, p)) {
          v = own;
          p = j;
        }
      }
      if (v == neg_inf()) p = 0;  // an all -inf column: its first index
      const bool new_inst =
          p != j && (tp.i(0, p) != tp.i(0, j) || (p == tp.i(2, j) && j == tp.i(1, j)));
      et[k] = new_inst ? t : ec[p];
      al[k] = v + lbt;
      abuf[nxt * S + j] = al[k];
      ebuf[nxt * S + j] = et[k];
      a.alphas[(size_t)t * S + j] = al[k];
      a.ets[(size_t)t * S + j] = et[k];
      if (tp.is_exit(j) && better(al[k] + pen, j, bv, bi)) {
        bv = al[k] + pen;
        bi = j;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      wv[nxt * 32 + warp] = bv;
      wi[nxt * 32 + warp] = bi;
    }
    __syncthreads();
  }
  float mx = neg_inf();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = tid + k * nt;
    if (j >= S) continue;
    for (int t = max(tl, 1); t < T; ++t) {  // steps at t >= length keep the carry
      a.alphas[(size_t)t * S + j] = al[k];
      a.ets[(size_t)t * S + j] = et[k];
    }
    if (tp.is_exit(j)) mx = fmaxf(mx, al[k]);
  }
  mx = warp_max(mx);
  if (lane == 0) ws[warp] = mx;
  __syncthreads();
  if (tid == 0) {
    float s = neg_inf();
    for (int w = 0; w < nw; ++w) s = fmaxf(s, ws[w]);
    *a.score = s;
  }
}

template <int K>
__device__ void max_backward(const MaxArgs& a, float* smem) {
  const Topo& tp = a.tp;
  const int S = tp.S, T = a.T;
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const float pen = a.pen;
  float* buf = smem;            // [2][S]
  float* wslot = smem + 2 * S;  // [2][32]

  float beta[K], lbn[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = tid + k * nt;
    beta[k] = neg_inf();
    lbn[k] = 0.f;
    if (j < S) {
      beta[k] = tp.is_exit(j) ? 0.f : neg_inf();
      lbn[k] = a.log_b[(size_t)(T - 1) * S + j];
    }
  }
  for (int t = T - 1;; --t) {
    const int par = t & 1;
    float* bb = buf + par * S;
    float bem[K];
    float mx = neg_inf();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + k * nt;
      bem[k] = neg_inf();
      if (j >= S) continue;
      const float here =
          (t >= 1 && t == a.len - 1) ? (tp.is_exit(j) ? 0.f : neg_inf()) : beta[k];
      bem[k] = lbn[k] + here;
      if (t >= 1) lbn[k] = a.log_b[(size_t)(t - 1) * S + j];
      bb[j] = bem[k];
      if (tp.is_entry(j)) mx = fmaxf(mx, bem[k]);
    }
    mx = warp_max(mx);
    if (lane == 0) wslot[par * 32 + warp] = mx;
    __syncthreads();
    const float bq = fold_max(wslot + par * 32, nw);
    if (tid == 0) a.beta_entry[t] = bq;
    if (t == 0) break;
    // An exit's row: the band, and penalty + the best entry (the entry j
    // itself is the band's own cell, never below penalty + beta_em[j]).
    const float mq = bq + pen;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + k * nt;
      if (j >= S) continue;
      float t0, t1, t2;
      band_row(tp, j, pen, bem[k], bb, t0, t1, t2);
      float v = fmaxf(fmaxf(t0, t1), t2);
      if (tp.is_exit(j)) v = fmaxf(v, mq);
      beta[k] = v;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(MAX_THREADS) lattice_max_kernel(MaxArgs a) {
  extern __shared__ float smem[];
  if (blockIdx.x == 0) {
    max_forward<K>(a, smem);
  } else {
    max_backward<K>(a, smem);
  }
}

// -- KBEST --------------------------------------------------------------------

struct KArgs {
  const float* log_b;  // (T, S)
  Topo tp;
  float pen;
  int len, K, T;
  float* alpha;        // (S, K)
  int* bps;            // (T, S, K)
  void* scratch;       // the rows and lists when they do not fit shared memory
};

// Words (4 bytes) of the rows [2][S K], the warps' lists (values and flat
// indices, 32 K each), the pool (K and K) and the warps' counts (32).
size_t kbest_words(int S, int K) {
  return 2 * (size_t)S * K + 64 * (size_t)K + 2 * (size_t)K + 32;
}

__global__ void __launch_bounds__(MAX_THREADS) kbest_kernel(KArgs a) {
  extern __shared__ float smem[];
  const Topo& tp = a.tp;
  const int S = tp.S, K = a.K, T = a.T, nx = tp.n_exits;
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const float pen = a.pen;
  float* base = a.scratch ? (float*)a.scratch : smem;
  float* rows0 = base;
  float* rows1 = base + (size_t)S * K;
  float* wl_v = base + 2 * (size_t)S * K;
  int* wl_f = (int*)(wl_v + 32 * (size_t)K);
  float* pool_v = (float*)(wl_f + 32 * (size_t)K);
  int* pool_f = (int*)(pool_v + K);
  int* wcount = pool_f + K;

  for (int j = tid; j < S; j += nt) {
    const float a0 = tp.is_entry(j) ? a.log_b[j] + tp.c(6, j) : neg_inf();
    for (int r = 0; r < K; ++r) {
      rows0[(size_t)j * K + r] = r == 0 ? a0 : neg_inf();
      a.bps[(size_t)j * K + r] = -1;
    }
  }
  __syncthreads();

  float* cur = rows0;
  float* nxt = rows1;
  for (int t = 1; t < T; ++t) {
    // (1) Each warp's top K of its lanes' exit rows (exit ordinals
    // tid + r nt); a row's head is its next slot while finite.
    int h[KBEST_ROWS];
#pragma unroll
    for (int r = 0; r < KBEST_ROWS; ++r) h[r] = 0;
    float hv = neg_inf();
    int hf = INT_MAX, hr = 0;
    auto head = [&]() {
      hv = neg_inf();
      hf = INT_MAX;
#pragma unroll
      for (int r = 0; r < KBEST_ROWS; ++r) {
        const int i = tid + r * nt;
        if (i < nx && h[r] < K) {
          const int x = tp.exits[i];
          const float v = cur[(size_t)x * K + h[r]];
          if (v != neg_inf() && better(v, x * K + h[r], hv, hf)) {
            hv = v;
            hf = x * K + h[r];
            hr = r;
          }
        }
      }
    };
    head();
    int count = 0;
    for (int q = 0; q < K; ++q) {
      float v = hv;
      int f = hf;
      warp_best(v, f);
      if (v == neg_inf()) break;
      if (f == hf) {
#pragma unroll
        for (int r = 0; r < KBEST_ROWS; ++r)
          if (r == hr) ++h[r];
        head();
      }
      if (lane == 0) {
        wl_v[warp * K + q] = v;
        wl_f[warp * K + q] = f;
      }
      ++count;
    }
    if (lane == 0) wcount[warp] = count;
    __syncthreads();
    // (2) The pool's top K: warp 0 merges the warps' lists, then the -inf
    // tail takes the lowest flat indices whose value is -inf.
    if (warp == 0) {
      const int n = lane < nw ? wcount[lane] : 0;
      int p = 0, nfin = 0;
      for (int q = 0; q < K; ++q) {
        float v = p < n ? wl_v[lane * K + p] : neg_inf();
        int f = p < n ? wl_f[lane * K + p] : INT_MAX;
        const int mine = f;
        warp_best(v, f);
        if (v == neg_inf()) break;
        if (mine == f) ++p;
        if (lane == 0) {
          pool_v[q] = v;
          pool_f[q] = f;
        }
        ++nfin;
      }
      if (lane == 0) {
        int q = nfin;
        for (int s = 0; q < K && s < S; ++s) {
          int f = 0;
          if (tp.is_exit(s))
            while (f < K && cur[(size_t)s * K + f] != neg_inf()) ++f;
          for (int slot = f; slot < K && q < K; ++slot, ++q) {
            pool_v[q] = neg_inf();
            pool_f[q] = s * K + slot;
          }
        }
      }
    }
    __syncthreads();
    // (3) Each state's stable top K.
    const bool live = t < a.len;
    for (int j = tid; j < S; j += nt) {
      const float lbt = a.log_b[(size_t)t * S + j];
      int* bp = a.bps + ((size_t)t * S + j) * K;
      float* an = nxt + (size_t)j * K;
      if (!tp.is_entry(j)) {
        const float* r0 = j >= 2 ? cur + (size_t)(j - 2) * K : nullptr;
        const float* r1 = j >= 1 ? cur + (size_t)(j - 1) * K : nullptr;
        const float* r2 = cur + (size_t)j * K;
        const float k2 = tp.c(2, j), k1 = tp.c(1, j), k0 = tp.c(0, j);
        const int p0 = max(j - 2, 0), p1 = max(j - 1, 0);
        int h0 = 0, h1 = 0, h2 = 0;
        for (int q = 0; q < K; ++q) {  // h0 + h1 + h2 = q < K: no block runs out
          const float v0 = r0 ? r0[h0] + k2 : neg_inf();
          const float v1 = r1 ? r1[h1] + k1 : neg_inf();
          const float v2 = r2[h2] + k0;
          float v = v0;
          int code = p0 * K + h0, blk = 0;
          if (v1 > v) {
            v = v1;
            code = p1 * K + h1;
            blk = 1;
          }
          if (v2 > v) {
            v = v2;
            code = j * K + h2;
            blk = 2;
          }
          h0 += blk == 0;
          h1 += blk == 1;
          h2 += blk == 2;
          bp[q] = code;
          if (live) an[q] = v + lbt;
        }
        continue;
      }
      const float dg = tp.c(3, j);
      const bool both = tp.is_exit(j);
      const bool beats = pen >= dg;
      int cj = 0;  // the pool's members from row j: its slots [0, cj)
      if (both)
        for (int q = 0; q < K; ++q) cj += pool_f[q] / K == j;
      const float* rj = cur + (size_t)j * K;
      auto pool_cand = [&](int i) {
        return (both && !beats && pool_f[i] / K == j) ? neg_inf() : pool_v[i] + pen;
      };
      auto self_cand = [&](int i) {
        return (both && beats && i < cj) ? neg_inf() : rj[i] + dg;
      };
      int ia = 0, ib = 0, q = 0;
      while (ia < K && pool_cand(ia) == neg_inf()) ++ia;
      while (ib < K && self_cand(ib) == neg_inf()) ++ib;
      while (q < K && (ia < K || ib < K)) {
        const bool take_pool = ia < K && (ib >= K || pool_cand(ia) >= self_cand(ib));
        float v;
        if (take_pool) {
          v = pool_cand(ia);
          bp[q] = pool_f[ia];
          for (++ia; ia < K && pool_cand(ia) == neg_inf();) ++ia;
        } else {
          v = self_cand(ib);
          bp[q] = j * K + ib;
          for (++ib; ib < K && self_cand(ib) == neg_inf();) ++ib;
        }
        if (live) an[q] = v + lbt;
        ++q;
      }
      for (int i = 0; i < K && q < K; ++i)
        if (pool_cand(i) == neg_inf()) {
          bp[q] = pool_f[i];
          if (live) an[q] = neg_inf() + lbt;
          ++q;
        }
      for (int i = 0; i < K && q < K; ++i)
        if (self_cand(i) == neg_inf()) {
          bp[q] = j * K + i;
          if (live) an[q] = neg_inf() + lbt;
          ++q;
        }
    }
    __syncthreads();
    if (live) {
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  for (int j = tid; j < S; j += nt)
    for (int r = 0; r < K; ++r) a.alpha[(size_t)j * K + r] = cur[(size_t)j * K + r];
}

Topo make_topo(const void* coefs, const void* ints, const void* exits, const void* entries,
               int S, int n_exits, int n_entries) {
  Topo tp;
  tp.coefs = (const float*)coefs;
  tp.ints = (const int*)ints;
  tp.exits = (const int*)exits;
  tp.entries = (const int*)entries;
  tp.S = S;
  tp.n_exits = n_exits;
  tp.n_entries = n_entries;
  return tp;
}

// Shared memory past 48 KB needs the kernel's opt-in.
template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// LSUM's dense / factorized pool threshold, which the plain version
// (ops/cuda/trellis_lattice.DENSE_POOL_MAX) checks against this library.
extern "C" int cs304_lattice_dense_pool_max() { return DENSE_POOL_MAX; }

// LSUM: log_b (B, T, S), the topology, lengths (B,) -> alphas, beta_em
// (B, T, S), beta_entry (B, T), log_z (B,); contiguous float32 / int32.
extern "C" int cs304_lattice_sum(const void* log_b, const void* coefs, const void* ints,
                                 const void* exits, const void* entries, const void* lengths,
                                 float penalty, void* alphas, void* beta_em, void* beta_entry,
                                 void* log_z, int B, int T, int S, int n_exits, int n_entries,
                                 void* stream) {
  if (B < 1 || T < 1 || S < 1 || S > MAX_STATES || n_exits < 1 || n_entries < 1)
    return (int)cudaErrorInvalidValue;
  SumArgs a;
  a.log_b = (const float*)log_b;
  a.tp = make_topo(coefs, ints, exits, entries, S, n_exits, n_entries);
  a.lengths = (const int*)lengths;
  a.pen = penalty;
  a.alphas = (float*)alphas;
  a.beta_em = (float*)beta_em;
  a.beta_entry = (float*)beta_entry;
  a.log_z = (float*)log_z;
  a.B = B;
  a.T = T;
  const int k = states_per_thread(S);
  const int threads = block_threads(S, k);
  const size_t smem = (2 * (size_t)S + 64) * sizeof(float) +
                      (size_t)(n_exits > n_entries ? n_exits : n_entries) * sizeof(int);
  const dim3 grid(B, 2);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  switch (k) {
    case 1:
      e = allow_smem(lattice_sum_kernel<1>, smem);
      if (e == cudaSuccess) lattice_sum_kernel<1><<<grid, threads, smem, st>>>(a);
      break;
    case 2:
      e = allow_smem(lattice_sum_kernel<2>, smem);
      if (e == cudaSuccess) lattice_sum_kernel<2><<<grid, threads, smem, st>>>(a);
      break;
    case 4:
      e = allow_smem(lattice_sum_kernel<4>, smem);
      if (e == cudaSuccess) lattice_sum_kernel<4><<<grid, threads, smem, st>>>(a);
      break;
    default:
      e = allow_smem(lattice_sum_kernel<8>, smem);
      if (e == cudaSuccess) lattice_sum_kernel<8><<<grid, threads, smem, st>>>(a);
      break;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// LMAX: log_b (T, S), the topology's coefs and ints, the length -> alphas
// (T, S) float32, entry times (T, S) int32, beta_entry (T,), score ().
extern "C" int cs304_lattice_max(const void* log_b, const void* coefs, const void* ints,
                                 float penalty, int length, void* alphas, void* ets,
                                 void* beta_entry, void* score, int T, int S, void* stream) {
  if (T < 1 || S < 1 || S > MAX_STATES) return (int)cudaErrorInvalidValue;
  MaxArgs a;
  a.log_b = (const float*)log_b;
  a.tp = make_topo(coefs, ints, nullptr, nullptr, S, 0, 0);
  a.pen = penalty;
  a.len = length;
  a.alphas = (float*)alphas;
  a.ets = (int*)ets;
  a.beta_entry = (float*)beta_entry;
  a.score = (float*)score;
  a.T = T;
  const int k = states_per_thread(S);
  const int threads = block_threads(S, k);
  // Forward: two float rows, two int rows, (value, index) slots [2][32]
  // and a score slot row; the backward uses less.
  const size_t smem = (4 * (size_t)S + 64 + 64 + 32) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  switch (k) {
    case 1:
      e = allow_smem(lattice_max_kernel<1>, smem);
      if (e == cudaSuccess) lattice_max_kernel<1><<<2, threads, smem, st>>>(a);
      break;
    case 2:
      e = allow_smem(lattice_max_kernel<2>, smem);
      if (e == cudaSuccess) lattice_max_kernel<2><<<2, threads, smem, st>>>(a);
      break;
    case 4:
      e = allow_smem(lattice_max_kernel<4>, smem);
      if (e == cudaSuccess) lattice_max_kernel<4><<<2, threads, smem, st>>>(a);
      break;
    default:
      e = allow_smem(lattice_max_kernel<8>, smem);
      if (e == cudaSuccess) lattice_max_kernel<8><<<2, threads, smem, st>>>(a);
      break;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The device scratch KBEST needs (int32 words): 0 where its rows and lists
// fit shared memory.
extern "C" long long cs304_kbest_scratch_words(int S, int K) {
  const size_t words = kbest_words(S, K);
  return words * 4 <= KBEST_SMEM_MAX ? 0 : (long long)words;
}

// KBEST: log_b (T, S), the topology's coefs and exits, the length, K ->
// alpha (S, K) float32, bps (T, S, K) int32; scratch: cs304_kbest_scratch_words.
extern "C" int cs304_kbest_forward(const void* log_b, const void* coefs, const void* exits,
                                   float penalty, int length, int K, void* alpha, void* bps,
                                   void* scratch, int T, int S, int n_exits, void* stream) {
  if (T < 1 || S < 1 || S > MAX_STATES || K < 1 || n_exits < 1)
    return (int)cudaErrorInvalidValue;
  KArgs a;
  a.log_b = (const float*)log_b;
  a.tp = make_topo(coefs, nullptr, exits, nullptr, S, n_exits, 0);
  a.pen = penalty;
  a.len = length;
  a.K = K;
  a.T = T;
  a.alpha = (float*)alpha;
  a.bps = (int*)bps;
  const size_t words = kbest_words(S, K);
  const bool global = words * 4 > KBEST_SMEM_MAX;
  a.scratch = global ? scratch : nullptr;
  const size_t smem = global ? 0 : words * 4;
  const int threads = S >= MAX_THREADS ? MAX_THREADS : 32 * ((S + 31) / 32);
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = allow_smem(kbest_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kbest_kernel<<<1, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}
