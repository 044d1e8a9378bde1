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
// Design. LSUM, LMAX and KBEST have a team branch (below) and keep their
// first design as the simple branch: where the team branch does not apply,
// and behind simple != 0 (timing beside it, tests).
// - LSUM, team branch: a block a row's forward and a block its backward
//   (grid (B, 2)); band threads (K = 1 / 2 / 4 / 8 states each) beside pool
//   warps, one barrier a step, the carry in a shared double buffer. The band
//   threads hold the non-pool states (forward: the non-entries; backward:
//   the non-exit rows) and their coefficients, loaded once (in shared memory
//   at K = 8: no spill at 1,024 threads); the pool warps hold the pool's
//   cells (entry columns; exit rows), so the two kinds of cell run at once on
//   warps of their own. A dense pool (both lists at most DENSE_POOL_MAX):
//   one pool warp, lane i holding member i and cell i; the step's max is a
//   redux.sync; a cell's terms are shuffled from the members' lanes, their
//   expfs issued independently (unrolled over the bucket 8 / 16 / 32) and
//   added in the dense order. A factorized pool (both lists past it): up to
//   8 pool warps, each folding the step's max (every warp's pool members'
//   max, put in a parity slot beside its cells before the barrier) and
//   summing P in the lane order, then up to 4 cells a lane; at 896 threads
//   at most (72 registers). beta_entry is summed after the loop, a row a
//   thread (in the loop it would lengthen the pool warp's chain).
//   First design (simple): K states a thread, entry and band cells on the
//   same warps, the dense walk serial, every warp summing P.
// - LMAX, team branch: a block the forward and a block the backward of
//   the utterance (past 4 states a band thread a cluster of 2 or 4 CTAs
//   each, the states shared in contiguous spans, the cells at a span's edge
//   and the warps' partials copied into the other CTAs' shared memory, one
//   cluster barrier a step, the pool always folded from the warps' slots),
//   band threads (K = 1 / 2 / 4 states each) beside pool warps, one barrier
//   a step, each role in a loop of its own (its registers only). The
//   forward's band threads hold the non-entries, their coefficients and
//   carry bits (LatticeTopology ints row 3: JAX's new-instance rule for each
//   band pick a step can make, precomputed on the host) loaded once; (alpha,
//   entry time) pairs in the shared rows, so a pick's entry time comes with
//   its alpha in one 8-byte load; a cell is the first max over (j-2, j-1,
//   j), its entry time t or the pick's by the bits (a pool pick other than
//   the entry itself always starts a new instance: lattice_topology checks
//   it). The pool warps hold the entry columns: the best
//   exit of the previous row by keys (the largest value with -0 as +0, the
//   lowest index, the value read back from the winner), one redux where the
//   lanes' indices ascend (a dense pool: lane i reads exit i after the
//   barrier; up to 32 exits) and past 32 exits the fold of each warp's
//   partial, put in a parity slot before the barrier; then each entry's own
//   cell against it (the lowest index wins a tie; an all -inf column points
//   at 0). Step t stores row t - 1's cells (loaded anyway) to alphas / ets
//   first thing: a store just before the barrier lengthens the step by its
//   latency. The backward's band threads hold the non-exit rows, its pool
//   warps the exit rows and the entries'
//   max (beta_entry, kept in a ring of 32 and written every 32 steps), read
//   from the row (dense) or folded from the warps' slots.
//   First design (simple): K states a thread, entries and band on the same
//   warps, every warp re-reducing the previous step's best exit by (value,
//   index) butterflies, the topology read through L1 each step.
// - KBEST, team branch (K in a bucket of 1 / 2 / 4 / 8 / 16 / 32, surplus
//   slots masked; codes pred_state K + pred_slot in the caller's K; keys
//   state KB + slot, so no division by a runtime K in the step): one block,
//   a team of KB lanes a state (lane r slot r), the rows [S][KB] and each
//   row's finite count in shared memory. A step, two barriers: (1) the pool
//   by every thread: each finite value of an exit row is a candidate whose
//   rank is its slot plus the values of the other rows that beat it (value
//   desc, flat index asc: a lower row on a tie), counted by four lanes that
//   binary-search a share of the rows in lock step; ranks below K land in
//   the pool, and one warp fills the -inf tail with the lowest flat indices
//   at -inf (a scan over states); past 32 exit rows (up to 128) a barrier
//   more: first the rows' heads (kept by the merges) are ranked by every
//   thread, and the candidates are those of the K best-headed rows, a row
//   whose head ranks h its first K - h values; (2) every state by ranks, entries and
//   non-entries in one warp-uniform code path (full-warp shuffles of width
//   KB: no collective loops): a non-entry's 3K candidates of blocks (s-2,
//   s-1, s) each count, by six binary searches in lock step over the team's
//   shuffles, the values of the other two sorted blocks that beat it (value
//   desc, block asc, slot asc); an entry's [pool + penalty, own K
//   self-loops] (value desc, the pool first, index asc) count in the
//   other list's unmasked sorted values, and the masks (the duplicate-prefix
//   rule: a row's pool members are its slots [0, c_j)) by the team's
//   ballots; -inf candidates rank after the finite ones in index order.
//   Past K = 32, 128 exit rows or rows beyond shared memory, the first design
//   (simple): a thread a state, K rounds of three-block merges, the pool by
//   2K rounds of warp argmax, three barriers a step.
//
// What bounds them on this card: the chain of dependent steps (latency),
// not bytes (log_b read, the passes' rows written once, far below it).
// LMAX a step: the barrier, the pool warp's best exit (a shared load and
// one or two reduxes, or the slots' fold) and its cells; the band's three
// 8-byte loads and two compares a state, K states a thread.
// LSUM a step: the barrier, a band cell's two shared loads and three expf
// and a logf; a dense pool cell's redux, its members' shuffles and W expf
// issued apart, then W dependent adds (the dense order); a factorized
// pool's W / 32 expf a lane and the butterfly. KBEST a step: two barriers,
// a team's six lock-step binary searches of log2(KB) + 1 shuffles, and the
// pool's candidates' searches (each lane a quarter of the rows, log2(KB) +
// 1 shared loads each); ~30 warps share four schedulers, so the step is
// issue-bound, and a state past the block's teams takes another round.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

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

// lane_pool_sum's sum in the same order (member i into lane i mod 32 from
// +0, then the butterfly), four members' loads and expfs issued together.
__device__ __forceinline__ float lane_pool_sum4(const float* vals, const int* list, int n,
                                               float pen, float mp) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  if (isfinite(mp)) {
    int i = lane;
    for (; i + 96 < n; i += 128) {
      const float u0 = vals[list[i]], u1 = vals[list[i + 32]];
      const float u2 = vals[list[i + 64]], u3 = vals[list[i + 96]];
      const float e0 = expf((u0 + pen) - mp), e1 = expf((u1 + pen) - mp);
      const float e2 = expf((u2 + pen) - mp), e3 = expf((u3 + pen) - mp);
      acc = acc + e0;
      acc = acc + e1;
      acc = acc + e2;
      acc = acc + e3;
    }
    for (; i < n; i += 32) acc = acc + expf((vals[list[i]] + pen) - mp);
  }
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

// -- LSUM, the team branch ----------------------------------------------------

constexpr int SUM_POOL_WARPS_MAX = 8;
constexpr int SUM_CELLS_A_LANE = 4;  // a factorized pool's cells a pool lane at most
// A factorized build's threads at most: 72 registers a thread, not 64.
constexpr int SUM_FACTORIZED_THREADS = 896;

// The max of the warp's values, every lane (redux.sync on order-preserving
// keys: exact, as a max is).
__device__ __forceinline__ float warp_max_redux(float v) {
  const int b = __float_as_int(v);
  const int k = __reduce_max_sync(FULL, b >= 0 ? b : b ^ 0x7fffffff);
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The team branch's launch: band threads [0, band) K states each, then the
// pool warps; the pool is dense (both lists at most DENSE_POOL_MAX members,
// unrolled over the bucket WB) or factorized (both past it, WB = 0, one or
// at most SUM_CELLS_A_LANE cells a pool lane, the build's CPL); else the
// simple branch.
struct SumPlan {
  int team, ks, wb, npw, cpl, band, threads;
  size_t smem;
};

SumPlan sum_plan(int S, int nx, int ne) {
  SumPlan p{};
  const int cells = nx > ne ? nx : ne;
  if (nx <= DENSE_POOL_MAX && ne <= DENSE_POOL_MAX) {
    p.wb = cells <= 8 ? 8 : cells <= 16 ? 16 : 32;
    p.npw = 1;
    p.cpl = 1;
  } else if (nx > DENSE_POOL_MAX && ne > DENSE_POOL_MAX) {
    p.wb = 0;
    p.npw = (cells + 31) / 32 < SUM_POOL_WARPS_MAX ? (cells + 31) / 32 : SUM_POOL_WARPS_MAX;
    p.cpl = (cells + 32 * p.npw - 1) / (32 * p.npw);
  } else {
    return p;  // one list dense, the other not: the simple branch
  }
  if (p.cpl > SUM_CELLS_A_LANE) return p;
  const int limit = p.wb ? MAX_THREADS : SUM_FACTORIZED_THREADS;
  for (int ks = 1; ks <= 8; ks <<= 1) {
    const int band = 32 * (((S + ks - 1) / ks + 31) / 32);
    if (band + 32 * p.npw <= limit) {
      p.team = 1;
      p.ks = ks;
      p.band = band;
      p.threads = band + 32 * p.npw;
      // The rows [2][S], at K = 8 the band's coefficients [3][S] and its
      // beta [S], the warps' max slots [2][32], the members.
      p.smem = (2 * (size_t)S + (ks == 8 ? 4 * (size_t)S : 0) + 64) * sizeof(float) +
               (size_t)cells * sizeof(int);
      return p;
    }
  }
  return p;
}

// A band thread's K states j = tid + k band: its band coefficients in
// registers, or at K = 8 in shared memory (no spill at 1,024 threads; there
// the band's carry stays in shared memory too and its emissions are loaded
// in the step).
template <int KS>
struct BandCoefs {
  float r[KS < 8 ? 3 * KS : 1];
  float* sm;
  int S;
  __device__ __forceinline__ void set(int k, int j, float c0, float c1, float c2) {
    if (KS < 8) {
      r[3 * k] = c0;
      r[3 * k + 1] = c1;
      r[3 * k + 2] = c2;
    } else {
      sm[j] = c0;
      sm[S + j] = c1;
      sm[2 * S + j] = c2;
    }
  }
  __device__ __forceinline__ float get(int k, int j, int which) const {
    if (KS < 8) return r[3 * k + which];
    return sm[which * S + j];
  }
};

template <int KS, int WB, int CPL>
__device__ void sum_team_forward(const SumArgs& a, float* buf, int* list, float* csm,
                                 float* wslot, int nb, int npw, int cpl) {
  const Topo& tp = a.tp;
  const int S = tp.S, T = a.T, b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int nx = tp.n_exits, ne = tp.n_entries;
  const float pen = a.pen;
  const float* lb = a.log_b + (size_t)b * T * S;
  float* out = a.alphas + (size_t)b * T * S;
  const int tl = min(a.lengths[b], T);
  const bool band = tid < nb;
  for (int i = tid; i < nx; i += blockDim.x) list[i] = tp.exits[i];

  // Band: the non-entries among j = tid + k nb, their carry and next
  // emission in va / vb; coefficients (sub2, sub1, diag_ne) loaded once.
  // Pool: lane l's cells, the entries pw 32 + l + c 32 npw, the same in va /
  // vb (one set of registers for either role); at WB > 0 lane i also holds
  // exit i (its member).
  constexpr int NV = KS > CPL ? KS : CPL;
  float va[NV], vb[NV];
  float* al = va;
  float* lbn = vb;
  float* pal = va;
  float* plbn = vb;
  unsigned mine = 0, pool_of = 0;  // the band's states, and those in the pool
  BandCoefs<KS> bc;
  bc.sm = csm;
  bc.S = S;
  int pe[CPL];
  int xm = 0;
  // At K = 8 a factorized pool's carries stay in shared memory too (the
  // alpha rows; emissions loaded in the step): no spill at 896 threads.
  constexpr bool PSM = KS == 8 && !WB;
  if (band) {
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int j = tid + k * nb;
      al[k] = neg_inf();
      lbn[k] = 0.f;
      if (j < S && !tp.is_entry(j)) {
        mine |= 1u << k;
        if (tp.is_exit(j)) pool_of |= 1u << k;
        bc.set(k, j, tp.c(0, j), tp.c(1, j), tp.c(2, j));
        buf[j] = neg_inf();
        out[j] = neg_inf();
        if (KS < 8 && T > 1) lbn[k] = lb[(size_t)S + j];
      }
    }
  } else {
    const int first = ((tid - nb) >> 5) * 32 + lane;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int i = first + c * 32 * npw;
      pe[c] = c < cpl && i < ne ? tp.entries[i] : -1;
      pal[c] = neg_inf();
      plbn[c] = 0.f;
      if (pe[c] >= 0) {
        const int e = pe[c];
        pal[c] = lb[e] + tp.c(6, e);
        buf[e] = pal[c];
        out[e] = pal[c];
        if (!PSM && T > 1) plbn[c] = lb[(size_t)S + e];
      }
    }
    if (WB) xm = lane < nx ? tp.exits[lane] : 0;
  }
  // A dense pool cell's place in the dense order: its own cell replaces
  // exit ppos (own_exit) or goes before it; its dense own cell d[e].
  int ppos = 0;
  bool own_exit = false;
  float d_own = 0.f;
  if (WB && !band && pe[0] >= 0) {
    const int e = pe[0];
    for (int i = 0; i < nx; ++i) ppos += tp.exits[i] < e;
    own_exit = tp.is_exit(e);
    d_own = tp.own_cell(e, pen);
  }
  // A factorized pool's max: each warp's exits' max into a parity slot
  // beside its cells, folded by the pool warps after the barrier.
  const int warp = tid >> 5, nw = blockDim.x >> 5;
  if (!WB) {
    float mx = neg_inf();
    if (!band) {
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (pe[c] >= 0 && tp.is_exit(pe[c])) mx = fmaxf(mx, pal[c]);
    }
    mx = warp_max_redux(mx);
    if (lane == 0) wslot[warp] = mx;
  }
  __syncthreads();

  for (int t = 1; t < tl; ++t) {
    const float* ac = buf + ((t - 1) & 1) * S;
    float* an = buf + (t & 1) * S;
    float mx = neg_inf();
    if (band) {
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        if (!(mine >> k & 1u)) continue;
        const int j = tid + k * nb;
        float lbt;
        if (KS < 8) {
          lbt = lbn[k];
          if (t + 1 < tl) lbn[k] = lb[(size_t)(t + 1) * S + j];
        } else {
          lbt = lb[(size_t)t * S + j];
        }
        const float t2 = (j >= 2 ? ac[j - 2] : neg_inf()) + bc.get(k, j, 2);
        const float t1 = (j >= 1 ? ac[j - 1] : neg_inf()) + bc.get(k, j, 1);
        const float v = lse3_seq(t2, t1, (KS < 8 ? al[k] : ac[j]) + bc.get(k, j, 0)) + lbt;
        if (KS < 8) al[k] = v;
        an[j] = v;
        out[(size_t)t * S + j] = v;
        if (pool_of >> k & 1u) mx = fmaxf(mx, v);
      }
    } else if (WB) {
      // One pool warp: exit i's alpha in lane i, the cell's terms' expfs
      // issued apart, added in the dense index order.
      const float am = lane < nx ? ac[xm] : neg_inf();
      const float mp = warp_max_redux(am) + pen;
      const float own = pal[0] + d_own;
      const float m = fmaxf(mp, own);
      const float e_own = expf(own - m);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < WB; ++i) {
        const float term = expf((__shfl_sync(FULL, am, i) + pen) - m);
        if (i == ppos && !own_exit) acc = acc + e_own;
        if (i < nx) acc = acc + ((i == ppos && own_exit) ? e_own : term);
      }
      if (ppos == WB && !own_exit) acc = acc + e_own;
      if (pe[0] >= 0) {
        const int e = pe[0];
        const float lbt = plbn[0];
        if (t + 1 < tl) plbn[0] = lb[(size_t)(t + 1) * S + e];
        pal[0] = (isfinite(m) ? m + logf(acc) : neg_inf()) + lbt;
        an[e] = pal[0];
        out[(size_t)t * S + e] = pal[0];
      }
    } else {
      // Factorized: each pool warp sums P in the lane order, then its cells.
      const float mp =
          warp_max_redux(lane < nw ? wslot[((t - 1) & 1) * 32 + lane] : neg_inf()) + pen;
      const float pool = lane_pool_sum4(ac, list, nx, pen, mp);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int e = pe[c];
        if (e < 0) continue;
        const bool ext = tp.is_exit(e), excl = ext && tp.c(3, e) > pen;
        const float own = (ext && !excl) ? neg_inf() : (PSM ? ac[e] : pal[c]) + tp.own_cell(e, pen);
        const float m = fmaxf(mp, own);
        float v = neg_inf();
        if (isfinite(m)) {
          const float pe_ = excl ? pool_sum_without(ac, list, nx, pen, mp, e) : pool;
          const float part = isfinite(mp) ? __fmul_rn(pe_, expf(mp - m)) : 0.f;
          v = m + logf((0.f + part) + expf(own - m));
        }
        float lbt;
        if (PSM) {
          lbt = lb[(size_t)t * S + e];
        } else {
          lbt = plbn[c];
          if (t + 1 < tl) plbn[c] = lb[(size_t)(t + 1) * S + e];
        }
        const float al_e = v + lbt;
        if (!PSM) pal[c] = al_e;
        an[e] = al_e;
        out[(size_t)t * S + e] = al_e;
        if (ext) mx = fmaxf(mx, al_e);
      }
    }
    if (!WB) {
      mx = warp_max_redux(mx);
      if (lane == 0) wslot[(t & 1) * 32 + warp] = mx;
    }
    __syncthreads();
  }
  // Steps at t >= length keep the carry.
  for (int t = max(tl, 1); t < T; ++t) {
    if (band) {
      const float* fin = buf + ((max(tl, 1) - 1) & 1) * S;
#pragma unroll
      for (int k = 0; k < KS; ++k)
        if (mine >> k & 1u)
          out[(size_t)t * S + tid + k * nb] = KS < 8 ? al[k] : fin[tid + k * nb];
    } else {
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (pe[c] >= 0)
          out[(size_t)t * S + pe[c]] = PSM ? buf[((max(tl, 1) - 1) & 1) * S + pe[c]] : pal[c];
    }
  }
  if (tid == nb) {
    const float* fin = buf + ((max(tl, 1) - 1) & 1) * S;
    float amax = neg_inf();
    for (int i = 0; i < nx; ++i) amax = fmaxf(amax, fin[list[i]]);
    float z = neg_inf();
    if (isfinite(amax)) {
      float acc = 0.f;
      for (int i = 0; i < nx; ++i) acc = acc + expf(fin[list[i]] - amax);
      z = amax + logf(acc);
    }
    a.log_z[b] = z;
  }
}

template <int KS, int WB, int CPL>
__device__ void sum_team_backward(const SumArgs& a, float* buf, int* list, float* csm,
                                  float* wslot, int nb, int npw, int cpl) {
  float* bsm = csm + 3 * a.tp.S;  // the band's beta at K = 8
  const Topo& tp = a.tp;
  const int S = tp.S, T = a.T, b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int nx = tp.n_exits, ne = tp.n_entries;
  const float pen = a.pen;
  const float* lb = a.log_b + (size_t)b * T * S;
  float* out = a.beta_em + (size_t)b * T * S;
  const int len = a.lengths[b];
  const bool band = tid < nb;
  for (int i = tid; i < ne; i += blockDim.x) list[i] = tp.entries[i];

  // Band: the non-exit rows among j = tid + k nb, their beta and next
  // emission in va / vb; coefficients c[j] (diag_ne, or the own cell at an
  // entry), sub1[j+1], sub2[j+2] loaded once. Pool: lane l's cells, the
  // exits pw 32 + l + c 32 npw, the same in va / vb; at WB > 0 lane i also
  // holds entry i (its member).
  constexpr int NV = KS > CPL ? KS : CPL;
  float va[NV], vb[NV];
  float* beta = va;
  float* lbn = vb;
  float* pbeta = va;
  float* plbn = vb;
  unsigned mine = 0, pool_of = 0;  // the band's states, and those in the pool
  BandCoefs<KS> bc;
  bc.sm = csm;
  bc.S = S;
  int px[CPL];
  int em = 0;
  // At K = 8 a factorized pool's betas stay in shared memory too (the
  // band's beta row; emissions loaded in the step): no spill at 896 threads.
  constexpr bool PSM = KS == 8 && !WB;
  if (band) {
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int j = tid + k * nb;
      beta[k] = neg_inf();
      lbn[k] = 0.f;
      if (j < S && !tp.is_exit(j)) {
        mine |= 1u << k;
        if (tp.is_entry(j)) pool_of |= 1u << k;
        bc.set(k, j, tp.is_entry(j) ? tp.own_cell(j, pen) : tp.c(0, j),
               j + 1 < S ? tp.c(1, j + 1) : 0.f, j + 2 < S ? tp.c(2, j + 2) : 0.f);
        if (KS < 8) lbn[k] = lb[(size_t)(T - 1) * S + j];
        else bsm[j] = neg_inf();
      }
    }
  } else {
    const int first = ((tid - nb) >> 5) * 32 + lane;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int i = first + c * 32 * npw;
      px[c] = c < cpl && i < nx ? tp.exits[i] : -1;
      pbeta[c] = px[c] >= 0 ? 0.f : neg_inf();
      plbn[c] = !PSM && px[c] >= 0 ? lb[(size_t)(T - 1) * S + px[c]] : 0.f;
      if (PSM && px[c] >= 0) bsm[px[c]] = 0.f;
    }
    if (WB) em = lane < ne ? tp.entries[lane] : 0;
  }
  // A dense pool row's place in the dense order: band cell k goes before
  // entry p_k (the entries at or below x + k come first), the entry x itself
  // (skip) is the band's own cell.
  int p0 = 0, p1 = 0, p2 = 0, skip = -1;
  float q0 = 0.f, q1 = 0.f, q2 = 0.f;
  if (WB && !band && px[0] >= 0) {
    const int x = px[0];
    for (int i = 0; i < ne; ++i) {
      const int e = tp.entries[i];
      p0 += e <= x;
      p1 += e <= x + 1;
      p2 += e <= x + 2;
      if (e == x) skip = i;
    }
    q0 = tp.is_entry(x) ? tp.own_cell(x, pen) : tp.c(0, x);
    q1 = x + 1 < S ? tp.c(1, x + 1) : 0.f;
    q2 = x + 2 < S ? tp.c(2, x + 2) : 0.f;
  }

  // A factorized pool's max: each warp's entries' max into a parity slot
  // beside its rows, folded by the pool warps after the barrier.
  const int warp = tid >> 5, nw = blockDim.x >> 5;
  bool px_entry[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) px_entry[c] = !band && px[c] >= 0 && tp.is_entry(px[c]);
  for (int t = T - 1;; --t) {
    float* bb = buf + (t & 1) * S;
    // beta_em = log_b[t] + beta (the exit terminal again at t == length - 1).
    const bool term = t >= 1 && t == len - 1;
    float mx = neg_inf();
    if (band) {
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        if (!(mine >> k & 1u)) continue;
        const int j = tid + k * nb;
        float bem;
        if (KS < 8) {
          bem = lbn[k] + (term ? neg_inf() : beta[k]);
          if (t >= 1) lbn[k] = lb[(size_t)(t - 1) * S + j];
        } else {
          bem = lb[(size_t)t * S + j] + (term ? neg_inf() : bsm[j]);
        }
        bb[j] = bem;
        out[(size_t)t * S + j] = bem;
        if (pool_of >> k & 1u) mx = fmaxf(mx, bem);
      }
    } else {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int x = px[c];
        if (x < 0) continue;
        float bem;
        if (PSM) {
          bem = lb[(size_t)t * S + x] + (term ? 0.f : bsm[x]);
        } else {
          bem = plbn[c] + (term ? 0.f : pbeta[c]);
          if (t >= 1) plbn[c] = lb[(size_t)(t - 1) * S + x];
        }
        bb[x] = bem;
        out[(size_t)t * S + x] = bem;
        if (px_entry[c]) mx = fmaxf(mx, bem);
      }
    }
    if (t == 0) break;
    if (!WB) {
      mx = warp_max_redux(mx);
      if (lane == 0) wslot[(t & 1) * 32 + warp] = mx;
    }
    __syncthreads();
    if (band) {
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        if (!(mine >> k & 1u)) continue;
        const int j = tid + k * nb;
        const float t0 = bc.get(k, j, 0) + bb[j];
        const float t1 = j + 1 < S ? bc.get(k, j, 1) + bb[j + 1] : neg_inf();
        const float t2 = j + 2 < S ? bc.get(k, j, 2) + bb[j + 2] : neg_inf();
        const float v = lse3_seq(t0, t1, t2);
        if (KS < 8) beta[k] = v;
        else bsm[j] = v;
      }
    } else if (WB) {
      // One pool warp: entry i's beta_em in lane i, the row's terms' expfs
      // issued apart, added in the dense index order.
      const float bm = lane < ne ? bb[em] : neg_inf();
      const float mq = warp_max_redux(bm) + pen;
      const int x = px[0];
      const int xs = x < 0 ? 0 : x;
      const float t0 = q0 + bb[xs];
      const float t1 = x >= 0 && x + 1 < S ? q1 + bb[x + 1] : neg_inf();
      const float t2 = x >= 0 && x + 2 < S ? q2 + bb[x + 2] : neg_inf();
      const float m = fmaxf(fmaxf(fmaxf(t0, t1), t2), mq);
      const float e0 = expf(t0 - m), e1 = expf(t1 - m), e2 = expf(t2 - m);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < WB; ++i) {
        const float term_i = expf((pen + __shfl_sync(FULL, bm, i)) - m);
        if (i == p0) acc = acc + e0;
        if (i == p1) acc = acc + e1;
        if (i == p2) acc = acc + e2;
        if (i < ne && i != skip) acc = acc + term_i;
      }
      if (p0 == WB) acc = acc + e0;
      if (p1 == WB) acc = acc + e1;
      if (p2 == WB) acc = acc + e2;
      pbeta[0] = isfinite(m) ? m + logf(acc) : neg_inf();
    } else {
      // Factorized: each pool warp sums Q in the lane order, then its rows.
      const float mq =
          warp_max_redux(lane < nw ? wslot[(t & 1) * 32 + lane] : neg_inf()) + pen;
      const float pool = lane_pool_sum4(bb, list, ne, pen, mq);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int x = px[c];
        if (x < 0) continue;
        float t0, t1, t2;
        band_row(tp, x, pen, bb[x], bb, t0, t1, t2);
        const bool ent = tp.is_entry(x), excl = ent && tp.c(3, x) > pen;
        if (ent && !excl) t0 = neg_inf();
        const float m = fmaxf(fmaxf(fmaxf(t0, t1), t2), mq);
        float v = neg_inf();
        if (isfinite(m)) {
          const float qe = excl ? pool_sum_without(bb, list, ne, pen, mq, x) : pool;
          const float part = isfinite(mq) ? __fmul_rn(qe, expf(mq - m)) : 0.f;
          v = m + logf(((expf(t0 - m) + expf(t1 - m)) + expf(t2 - m)) + part);
        }
        if (PSM) bsm[x] = v;
        else pbeta[c] = v;
      }
    }
  }
  __syncthreads();  // the beta_em rows in device memory, read back below
  for (int t = tid; t < T; t += blockDim.x) {
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

template <int KS, int WB, int CPL>
__global__ void __launch_bounds__(WB ? MAX_THREADS : SUM_FACTORIZED_THREADS)
    lattice_sum_team_kernel(SumArgs a, int nb, int npw, int cpl) {
  extern __shared__ float smem[];
  const int S = a.tp.S;
  float* buf = smem;                                   // [2][S]
  float* csm = smem + 2 * S;                           // [4][S] at K = 8
  float* wslot = csm + (KS == 8 ? 4 * S : 0);          // [2][32], factorized
  int* list = (int*)(wslot + 64);                      // the pool's members
  if (blockIdx.y == 0) {
    sum_team_forward<KS, WB, CPL>(a, buf, list, csm, wslot, nb, npw, cpl);
  } else {
    sum_team_backward<KS, WB, CPL>(a, buf, list, csm, wslot, nb, npw, cpl);
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

// -- LMAX, the team branch ----------------------------------------------------

constexpr int MAX_POOL_WARPS = 8;
// A factorized pool's cells a lane at most; a build holds 1, 2, 4 or 8 in
// registers (the plan's bucket; unused cells are skipped).
constexpr int MAX_CELLS_A_LANE = 8;
// A cluster's CTA runs at most this many threads (72 registers a thread,
// not 64 as at 1,024).
constexpr int CLUSTER_THREADS = 896;
// A state's carry bits (LatticeTopology ints row 3): JAX's new-instance
// rule of the predecessor its forward step picks, j-2, j-1 or state 0 (an
// all -inf column).
constexpr unsigned NEW_SUB2 = 1u, NEW_SUB1 = 2u, NEW_FROM0 = 4u;

// With a dense pool a step is shorter than a read of device memory, so
// the emissions come through a shared ring of EMIT_AHEAD rows, each
// thread's own cells copied that many steps ahead by cp.async (no barrier:
// the thread that copies a cell reads it); else the next step's emissions
// in registers (the ring measured slower there).
constexpr int EMIT_AHEAD = 8;

__device__ __forceinline__ void copy_ahead(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(EMIT_AHEAD - 1));
}

// A cell of the forward's shared rows: alpha and its word entry time, one
// 8-byte load.
struct __align__(8) MaxCell {
  float a;
  int e;
};

// The order-preserving key of a value, -0 as +0 (the two tie).
__device__ __forceinline__ int tie_key(float v) {
  const int b = __float_as_int(v == 0.f ? 0.f : v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// The warp's best (value, index): the largest value, the lowest index on a
// tie, the value read back from the winner (so a -0 survives); index
// INT_MAX marks a lane without one (below every value, -inf included).
__device__ __forceinline__ void warp_best_keyed(float& v, int& i) {
  const int m = __reduce_max_sync(FULL, i == INT_MAX ? INT_MIN : tie_key(v));
  const int bi = __reduce_min_sync(FULL, i != INT_MAX && tie_key(v) == m ? i : INT_MAX);
  v = __shfl_sync(FULL, v, __ffs(__ballot_sync(FULL, i == bi)) - 1);
  i = bi;
}

// warp_best_keyed where the lanes' indices ascend: the first lane at the
// largest key holds the lowest index (one reduction, not two).
__device__ __forceinline__ void warp_best_ordered(float& v, int& i) {
  const int key = i == INT_MAX ? INT_MIN : tie_key(v);
  const int src = __ffs(__ballot_sync(FULL, key == __reduce_max_sync(FULL, key))) - 1;
  v = __shfl_sync(FULL, v, src);
  i = __shfl_sync(FULL, i, src);
}

// The team branch's launch: band threads [0, band) K states each (the
// forward's non-entries, the backward's non-exit rows), then the pool
// warps (the forward's entry columns, the backward's exit rows). A dense
// pool (both lists at most DENSE_POOL_MAX): one pool warp, lane i holding
// entry i, exit i and (as a member) the other list's i-th state, read from
// the shared row after the barrier. Past it: up to MAX_POOL_WARPS pool
// warps, up to MAX_CELLS_A_LANE cells a lane (a build's bucket CPL), and
// every warp holding members puts its partial into a parity slot before
// the barrier. Each role runs a loop of its own (its registers only), one
// barrier a step. Past 4 states a band thread a cluster of C = 2 or 4 CTAs
// a pass shares the states (4 a band thread), one cluster barrier a step;
// its pool is always folded from the slots (a dense pool's one warp too).
struct MaxPlan {
  int team, ks, dense, npw, cpl, band, threads, c;
  size_t smem;
};

// Band threads for sc states at ks states a thread.
int band_threads(int sc, int ks) { return 32 * (((sc + ks - 1) / ks + 31) / 32); }

MaxPlan max_plan(int S, int nx, int ne) {
  MaxPlan p{};
  const int cells = nx > ne ? nx : ne;
  p.dense = nx <= DENSE_POOL_MAX && ne <= DENSE_POOL_MAX;
  p.npw = p.dense ? 1 : min((cells + 31) / 32, MAX_POOL_WARPS);
  const int need = (cells + 32 * p.npw - 1) / (32 * p.npw);
  if (need > MAX_CELLS_A_LANE) return p;
  p.cpl = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
  // A pool lane walks its cells one after another: past twice the first
  // design's states a thread it measured slower than the first design
  // (700 single-state words at 4 cells a lane, 1,100 at 8), which then
  // stays. So a build holds at most 2 KS cells a lane.
  if (p.cpl > 2 * states_per_thread(S)) return p;
  p.c = 1;
  for (int ks = 1; ks <= 4 && !p.ks; ks <<= 1)
    if (band_threads(S, ks) + 32 * p.npw <= MAX_THREADS) p.ks = ks;
  // Past 4 states a band thread, a cluster of 2 or 4 CTAs of 4 states a
  // band thread (each CTA's pool sized for every cell: the plan sees only
  // the counts).
  for (int c = 2; c <= 4 && !p.ks; c <<= 1) {
    if (band_threads((S + c - 1) / c, 4) + 32 * p.npw <= CLUSTER_THREADS) {
      p.c = c;
      p.ks = 4;
      p.dense = 0;
    }
  }
  if (!p.ks) return p;
  p.team = 1;
  p.band = band_threads((S + p.c - 1) / p.c, p.ks);
  p.threads = p.band + 32 * p.npw;
  // The forward's (the backward needs less): the rows [2][S], the slots
  // [2][C][32], the score's [C][32], and with a dense pool the emissions'
  // ring [EMIT_AHEAD][S].
  p.smem = 2 * (size_t)S * sizeof(MaxCell) + 64 * p.c * sizeof(MaxCell) +
           32 * p.c * sizeof(float) + (p.dense ? EMIT_AHEAD : 0) * (size_t)S * sizeof(float);
  return p;
}

// The states a CTA holds, [lo, hi), and its entries' and exits' positions
// in the lists: all of them on one CTA; on a cluster of C CTAs a share of
// sc states each, the cells at a share's edges copied into the neighbour's
// rows (distributed shared memory), the rows indexed by state throughout.
struct Span {
  int lo, hi, rank, sc, e_lo, e_hi, x_lo, x_hi;
};

__device__ __forceinline__ int lower_bound_of(const int* list, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(list + mid) < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <int C>
__device__ __forceinline__ Span span_of(const Topo& tp, int rank) {
  Span sp;
  sp.rank = rank;
  sp.sc = (tp.S + C - 1) / C;
  sp.lo = min(tp.S, rank * sp.sc);
  sp.hi = min(tp.S, sp.lo + sp.sc);
  sp.e_lo = C == 1 ? 0 : lower_bound_of(tp.entries, tp.n_entries, sp.lo);
  sp.e_hi = C == 1 ? tp.n_entries : lower_bound_of(tp.entries, tp.n_entries, sp.hi);
  sp.x_lo = C == 1 ? 0 : lower_bound_of(tp.exits, tp.n_exits, sp.lo);
  sp.x_hi = C == 1 ? tp.n_exits : lower_bound_of(tp.exits, tp.n_exits, sp.hi);
  return sp;
}

// The step's barrier: the block's, or the cluster's.
template <int C>
__device__ __forceinline__ void step_sync() {
  if (C > 1) cg::this_cluster().sync();
  else __syncthreads();
}

// Another CTA's copy of a shared array.
template <typename T>
__device__ __forceinline__ T* at_rank(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

// A warp's partial into parity slot par of every CTA: slot [2][32 C], the
// CTA of rank r's warps at r 32.
template <int C, typename V>
__device__ __forceinline__ void slot_put(V* slot, int par, int warp, int rank, V v) {
  const int lane = threadIdx.x & 31;
  if (C == 1) {
    if (lane == 0) slot[par * 32 + warp] = v;
  } else if (lane < C) {
    at_rank(slot, lane)[(par * C + rank) * 32 + warp] = v;
  }
}

// The forward's band thread: the non-entries j = tid + k nb, their
// coefficients (sub2, sub1, diag_ne) and three carry bits each loaded once,
// the next emission ahead in lbn; the carry lives in the shared rows. Step
// t stores row t - 1's cells, which it loads anyway, to alphas / ets first
// thing: the barrier after the step then finds them done (a store just
// before a barrier lengthens the step by its latency). Returns the max of
// its exits' last alpha (the score's part). On a cluster j = lo + tid + k nb.
template <int KS, bool DENSE, int C>
__device__ __forceinline__ float max_band_forward(const MaxArgs& a, MaxCell* rows,
                                                  MaxCell* slot, float* ring_sm, int nb,
                                                  const Span& sp) {
  static_assert(KS <= 4, "a band thread holds at most 4 states");
  const Topo& tp = a.tp;
  const int S = tp.S, T = a.T, tid = threadIdx.x, warp = tid >> 5;
  const float pen = a.pen, NEG = neg_inf();
  const float* lb = a.log_b;
  const int tl = min(a.len, T);
  constexpr bool RING = DENSE;  // the emissions through the shared ring
  float lbn[RING ? 1 : KS];
  unsigned mine = 0, xmask = 0;  // the thread's states, those that are exits
  unsigned bits = 0;
  BandCoefs<KS> bc;
  const int lo = sp.lo;
  // A cell the next CTA reads (its j - 1, j - 2) goes into its rows too.
  const int edge = C > 1 && sp.rank + 1 < C ? sp.hi - 2 : S;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int j = lo + tid + k * nb;
    if (!RING) lbn[k] = 0.f;
    if (j < sp.hi && !tp.is_entry(j)) {
      mine |= 1u << k;
      if (tp.is_exit(j)) xmask |= 1u << k;
      bc.set(k, j, tp.c(0, j), tp.c(1, j), tp.c(2, j));
      bits |= (unsigned)(tp.i(3, j) & 7) << (3 * k);
      rows[j] = MaxCell{NEG, 0};
      if (C > 1 && j >= edge) at_rank(rows, sp.rank + 1)[j] = MaxCell{NEG, 0};
      if (!RING && T > 1) lbn[k] = lb[(size_t)S + j];
    }
  }
  if (RING) {
    for (int r = 1; r <= EMIT_AHEAD; ++r) {
#pragma unroll
      for (int k = 0; k < KS; ++k)
        if (r < tl && (mine >> k & 1u))
          copy_ahead(ring_sm + (r & (EMIT_AHEAD - 1)) * S + tid + k * nb,
                     lb + (size_t)r * S + tid + k * nb);
      copy_commit();
    }
  }
  // Past a dense pool each warp holding exits puts its best exit of the
  // row into a parity slot (row 0: -inf, the lowest exit); the others'
  // slots hold (-inf, none) throughout.
  const bool has_x = !DENSE && __any_sync(FULL, xmask != 0u);
  if (!DENSE) {
    float bv = NEG;
    int bi = has_x && xmask ? lo + tid + (__ffs(xmask) - 1) * nb : INT_MAX;
    if (has_x) warp_best_keyed(bv, bi);
    slot_put<C>(slot, 0, warp, sp.rank, MaxCell{NEG, bi});
    if (!has_x) slot_put<C>(slot, 1, warp, sp.rank, MaxCell{NEG, INT_MAX});
  }
  step_sync<C>();

  for (int t = 1; t < tl; ++t) {
    const MaxCell* cur = rows + ((t - 1) & 1) * S;
    MaxCell* nxt = rows + (t & 1) * S;
    float bv = NEG;
    int bi = INT_MAX;
    if (RING) copy_wait();
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (!(mine >> k & 1u)) continue;
      const int j = lo + tid + k * nb;
      float* ring = ring_sm + (t & (EMIT_AHEAD - 1)) * S + j;
      const float lbt = RING ? *ring : lbn[k];
      if (!RING && t + 1 < tl) lbn[k] = lb[(size_t)(t + 1) * S + j];
      const MaxCell m0 = cur[j];
      a.alphas[(size_t)(t - 1) * S + j] = m0.a;
      a.ets[(size_t)(t - 1) * S + j] = m0.e;
      const MaxCell m1 = j >= 1 ? cur[j - 1] : MaxCell{NEG, 0};
      const MaxCell m2 = j >= 2 ? cur[j - 2] : MaxCell{NEG, 0};
      const unsigned nb3 = bits >> (3 * k) & 7u;
      // The first max over (j-2, j-1, j) and its entry time: t where the
      // pick starts a new instance, else the pick's own.
      float v = j >= 2 ? m2.a + bc.get(k, j, 2) : NEG;
      int et = (nb3 & NEW_SUB2) ? t : m2.e;
      const float v1 = m1.a + bc.get(k, j, 1);
      if (v1 > v) {
        v = v1;
        et = (nb3 & NEW_SUB1) ? t : m1.e;
      }
      const float v0 = m0.a + bc.get(k, j, 0);
      if (v0 > v) {
        v = v0;
        et = m0.e;
      }
      if (v == NEG)  // an all -inf column: state 0 (on a cluster, rank 0's)
        et = (nb3 & NEW_FROM0) ? t : (C > 1 ? at_rank(cur, 0) : cur)[0].e;
      const float al = v + lbt;
      nxt[j] = MaxCell{al, et};
      if (C > 1 && j >= edge) at_rank(nxt, sp.rank + 1)[j] = MaxCell{al, et};
      // The slot just read takes row t + EMIT_AHEAD (after its use).
      if (RING && t + EMIT_AHEAD < tl) copy_ahead(ring, lb + (size_t)(t + EMIT_AHEAD) * S + j);
      if (!DENSE && (xmask >> k & 1u) && better(al + pen, j, bv, bi)) {
        bv = al + pen;
        bi = j;
      }
    }
    if (RING) copy_commit();
    if (has_x) {
      // One state a lane: the lanes' indices ascend.
      if (KS == 1) warp_best_ordered(bv, bi);
      else warp_best_keyed(bv, bi);
      slot_put<C>(slot, t & 1, warp, sp.rank, MaxCell{bv, bi});
    }
    step_sync<C>();
  }
  // The last live row, and the steps at t >= length, which keep the carry.
  const int te = max(tl, 1);
  const MaxCell* fin = rows + ((te - 1) & 1) * S;
  float mx = NEG;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    if (!(mine >> k & 1u)) continue;
    const int j = lo + tid + k * nb;
    const MaxCell f = fin[j];
    for (int t = te - 1; t < T; ++t) {
      a.alphas[(size_t)t * S + j] = f.a;
      a.ets[(size_t)t * S + j] = f.e;
    }
    if (xmask >> k & 1u) mx = fmaxf(mx, f.a);
  }
  return mx;
}

// The forward's pool lane: the entries pw 32 + l + c 32 npw, each cell's
// own dense cell d[e] and its NEW_FROM0 bit loaded once; in a dense pool
// lane i also holds exit i (its member). Each step: row t - 1's cells
// stored, the previous row's best exit by (alpha + penalty, lowest index),
// then every cell against it.
template <bool DENSE, int CPL, int C>
__device__ __forceinline__ float max_pool_forward(const MaxArgs& a, MaxCell* rows,
                                                  MaxCell* slot, float* ring_sm, int nb, int npw,
                                                  const Span& sp) {
  static_assert(C == 1 || !DENSE, "a cluster's pool folds the warps' slots");
  const Topo& tp = a.tp;
  const int S = tp.S, T = a.T, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5, nx = tp.n_exits;
  const float pen = a.pen, NEG = neg_inf();
  const float* lb = a.log_b;
  const int tl = min(a.len, T);
  constexpr bool RING = DENSE;  // the emissions through the shared ring
  int pe[CPL];
  float pown[CPL], lbn[RING ? 1 : CPL];
  // The lane's cells, those that are exits, those whose all -inf column's
  // pick (state 0) starts a new instance.
  unsigned mine = 0, xmask = 0, from0 = 0;
  const int first = sp.e_lo + ((tid - nb) >> 5) * 32 + lane;
  const int edge = C > 1 && sp.rank + 1 < C ? sp.hi - 2 : S;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int i = first + c * 32 * npw;
    pe[c] = i < sp.e_hi ? tp.entries[i] : 0;
    pown[c] = 0.f;
    if (!RING) lbn[c] = 0.f;
    if (i < sp.e_hi) {
      const int e = pe[c];
      mine |= 1u << c;
      if (tp.is_exit(e)) xmask |= 1u << c;
      if (tp.i(3, e) & NEW_FROM0) from0 |= 1u << c;
      pown[c] = tp.own_cell(e, pen);
      rows[e] = MaxCell{lb[e] + tp.c(6, e), 0};
      if (C > 1 && e >= edge) at_rank(rows, sp.rank + 1)[e] = rows[e];
      if (!RING && T > 1) lbn[c] = lb[(size_t)S + e];
    }
  }
  if (RING) {
    for (int r = 1; r <= EMIT_AHEAD; ++r) {
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (r < tl && (mine >> c & 1u))
          copy_ahead(ring_sm + (r & (EMIT_AHEAD - 1)) * S + pe[c], lb + (size_t)r * S + pe[c]);
      copy_commit();
    }
  }
  const int xm = DENSE && lane < nx ? tp.exits[lane] : -1;
  const bool has_x = !DENSE && __any_sync(FULL, xmask != 0u);
  if (!DENSE) {
    float bv = NEG;
    int bi = INT_MAX;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (!(xmask >> c & 1u)) continue;
      const float u = rows[pe[c]].a + pen;
      if (better(u, pe[c], bv, bi)) {
        bv = u;
        bi = pe[c];
      }
    }
    if (has_x) warp_best_keyed(bv, bi);
    slot_put<C>(slot, 0, warp, sp.rank, MaxCell{bv, bi});
    if (!has_x) slot_put<C>(slot, 1, warp, sp.rank, MaxCell{NEG, INT_MAX});
  }
  step_sync<C>();

  for (int t = 1; t < tl; ++t) {
    const MaxCell* cur = rows + ((t - 1) & 1) * S;
    MaxCell* nxt = rows + (t & 1) * S;
    float pv = NEG;
    int pi = INT_MAX;
    if (DENSE) {
      // Lane i holds exit i: the lanes' indices ascend.
      pv = xm >= 0 ? cur[xm].a + pen : NEG;
      pi = xm >= 0 ? xm : INT_MAX;
    } else if (lane < nw) {
      // Lane w: warp w's slot of every CTA, folded in order.
#pragma unroll
      for (int r = 0; r < C; ++r) {
        const MaxCell s = slot[(((t - 1) & 1) * C + r) * 32 + lane];
        if (better(s.a, s.e, pv, pi) && s.e != INT_MAX) {
          pv = s.a;
          pi = s.e;
        }
      }
    }
    MaxCell me[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (!(mine >> c & 1u)) continue;
      me[c] = cur[pe[c]];
      a.alphas[(size_t)(t - 1) * S + pe[c]] = me[c].a;
      a.ets[(size_t)(t - 1) * S + pe[c]] = me[c].e;
    }
    if (DENSE) warp_best_ordered(pv, pi);
    else warp_best_keyed(pv, pi);
    float bv = NEG;
    int bi = INT_MAX;
    if (RING) copy_wait();
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (!(mine >> c & 1u)) continue;
      const int e = pe[c];
      float* ring = ring_sm + (t & (EMIT_AHEAD - 1)) * S + e;
      const float lbt = RING ? *ring : lbn[c];
      if (!RING && t + 1 < tl) lbn[c] = lb[(size_t)(t + 1) * S + e];
      // Every exit, and the entry's own cell at its index (the lowest index
      // wins a tie: the dense column's first max). A pool pick other than e
      // starts a new instance.
      const float own = me[c].a + pown[c];
      float v;
      int et;
      if (better(own, e, pv, pi)) {
        v = own;
        et = me[c].e;
      } else {
        v = pv;
        et = pi == e ? me[c].e : t;
      }
      if (v == NEG) et = (from0 >> c & 1u) ? t : (C > 1 ? at_rank(cur, 0) : cur)[0].e;
      const float al = v + lbt;
      nxt[e] = MaxCell{al, et};
      if (C > 1 && e >= edge) at_rank(nxt, sp.rank + 1)[e] = MaxCell{al, et};
      if (RING && t + EMIT_AHEAD < tl) copy_ahead(ring, lb + (size_t)(t + EMIT_AHEAD) * S + e);
      if (!DENSE && (xmask >> c & 1u) && better(al + pen, e, bv, bi)) {
        bv = al + pen;
        bi = e;
      }
    }
    if (RING) copy_commit();
    if (has_x) {
      // One cell a lane: the lanes' indices ascend.
      if (CPL == 1) warp_best_ordered(bv, bi);
      else warp_best_keyed(bv, bi);
      slot_put<C>(slot, t & 1, warp, sp.rank, MaxCell{bv, bi});
    }
    step_sync<C>();
  }
  const int te = max(tl, 1);
  const MaxCell* fin = rows + ((te - 1) & 1) * S;
  float mx = NEG;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    if (!(mine >> c & 1u)) continue;
    const MaxCell f = fin[pe[c]];
    for (int t = te - 1; t < T; ++t) {
      a.alphas[(size_t)t * S + pe[c]] = f.a;
      a.ets[(size_t)t * S + pe[c]] = f.e;
    }
    if (xmask >> c & 1u) mx = fmaxf(mx, f.a);
  }
  return mx;
}

// The backward's band thread: the non-exit rows j = tid + k nb, their
// coefficients c[j] (diag_ne, or the own cell at an entry), sub1[j+1],
// sub2[j+2] loaded once; beta and the next emission in registers.
template <int KS, bool DENSE, int C>
__device__ __forceinline__ void max_band_backward(const MaxArgs& a, float* buf, float* slot,
                                                  float* ring_sm, int nb, const Span& sp) {
  static_assert(KS <= 4, "a band thread holds at most 4 states");
  const Topo& tp = a.tp;
  const int S = tp.S, T = a.T, tid = threadIdx.x, warp = tid >> 5;
  const float pen = a.pen, NEG = neg_inf();
  const float* lb = a.log_b;
  constexpr bool RING = DENSE;  // the emissions through the shared ring
  float beta[KS], bem[KS], lbn[RING ? 1 : KS];
  unsigned mine = 0, emask = 0;  // the thread's rows, those that are entries
  BandCoefs<KS> bc;
  const int lo = sp.lo;
  // A row the previous CTA reads (its j + 1, j + 2) goes into its rows too.
  const int edge = C > 1 && sp.rank > 0 ? lo + 2 : 0;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int j = lo + tid + k * nb;
    beta[k] = NEG;
    if (!RING) lbn[k] = 0.f;
    if (j < sp.hi && !tp.is_exit(j)) {
      mine |= 1u << k;
      if (tp.is_entry(j)) emask |= 1u << k;
      bc.set(k, j, tp.is_entry(j) ? tp.own_cell(j, pen) : tp.c(0, j),
             j + 1 < S ? tp.c(1, j + 1) : 0.f, j + 2 < S ? tp.c(2, j + 2) : 0.f);
      if (!RING) lbn[k] = lb[(size_t)(T - 1) * S + j];
    }
  }
  if (RING) {
    for (int r = T - 1; r >= T - EMIT_AHEAD; --r) {
#pragma unroll
      for (int k = 0; k < KS; ++k)
        if (r >= 0 && (mine >> k & 1u))
          copy_ahead(ring_sm + (r & (EMIT_AHEAD - 1)) * S + lo + tid + k * nb,
                     lb + (size_t)r * S + lo + tid + k * nb);
      copy_commit();
    }
  }
  // Past a dense pool each warp holding entries puts their max into a
  // parity slot before the barrier; the others' slots hold -inf throughout.
  const bool has_e = !DENSE && __any_sync(FULL, emask != 0u);
  if (!DENSE && !has_e) {
    slot_put<C>(slot, 0, warp, sp.rank, NEG);
    slot_put<C>(slot, 1, warp, sp.rank, NEG);
  }
  for (int t = T - 1;; --t) {
    float* bb = buf + (t & 1) * S;
    // beta_em = log_b[t] + beta (the exit terminal again at t == length - 1:
    // -inf off the exits).
    const bool term = t >= 1 && t == a.len - 1;
    float mx = NEG;
    if (RING) copy_wait();
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (!(mine >> k & 1u)) continue;
      const int j = lo + tid + k * nb;
      float* ring = ring_sm + (t & (EMIT_AHEAD - 1)) * S + j;
      const float e = (RING ? *ring : lbn[k]) + (term ? NEG : beta[k]);
      if (!RING && t >= 1) lbn[k] = lb[(size_t)(t - 1) * S + j];
      bb[j] = e;
      if (C > 1 && j < edge) at_rank(bb, sp.rank - 1)[j] = e;
      if (RING && t >= EMIT_AHEAD) copy_ahead(ring, lb + (size_t)(t - EMIT_AHEAD) * S + j);
      bem[k] = e;
      if (!DENSE && (emask >> k & 1u)) mx = fmaxf(mx, e);
    }
    if (RING) copy_commit();
    if (has_e) {
      mx = warp_max_redux(mx);
      slot_put<C>(slot, t & 1, warp, sp.rank, mx);
    }
    step_sync<C>();
    if (t == 0) break;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (!(mine >> k & 1u)) continue;
      const int j = lo + tid + k * nb;
      const float t0 = bc.get(k, j, 0) + bem[k];
      const float t1 = j + 1 < S ? bc.get(k, j, 1) + bb[j + 1] : NEG;
      const float t2 = j + 2 < S ? bc.get(k, j, 2) + bb[j + 2] : NEG;
      beta[k] = fmaxf(fmaxf(t0, t1), t2);
    }
  }
}

// The backward's pool lane: the exit rows pw 32 + l + c 32 npw with the
// same coefficients; in a dense pool lane i also holds entry i (its
// member). Each step: the entries' max (beta_entry[t], kept in a ring of
// 32 and written by the first pool warp every 32 steps); penalty + it
// enters every exit row (the entry x itself is the row's own cell, never
// below).
template <bool DENSE, int CPL, int C>
__device__ __forceinline__ void max_pool_backward(const MaxArgs& a, float* buf, float* slot,
                                                  float* bqr, float* ring_sm, int nb, int npw,
                                                  const Span& sp) {
  static_assert(C == 1 || !DENSE, "a cluster's pool folds the warps' slots");
  const Topo& tp = a.tp;
  const int S = tp.S, T = a.T, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5, ne = tp.n_entries;
  const float pen = a.pen, NEG = neg_inf();
  const float* lb = a.log_b;
  constexpr bool RING = DENSE;  // the emissions through the shared ring
  float beta[CPL], lbn[RING ? 1 : CPL], bem[CPL], q0[CPL], q1[CPL], q2[CPL];
  int px[CPL];
  unsigned mine = 0, emask = 0;  // the lane's rows, those that are entries
  const int first = sp.x_lo + ((tid - nb) >> 5) * 32 + lane;
  const int edge = C > 1 && sp.rank > 0 ? sp.lo + 2 : 0;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int i = first + c * 32 * npw;
    px[c] = i < sp.x_hi ? tp.exits[i] : 0;
    beta[c] = 0.f;
    if (!RING) lbn[c] = 0.f;
    q0[c] = q1[c] = q2[c] = 0.f;
    if (i < sp.x_hi) {
      const int x = px[c];
      mine |= 1u << c;
      if (tp.is_entry(x)) emask |= 1u << c;
      q0[c] = tp.is_entry(x) ? tp.own_cell(x, pen) : tp.c(0, x);
      q1[c] = x + 1 < S ? tp.c(1, x + 1) : 0.f;
      q2[c] = x + 2 < S ? tp.c(2, x + 2) : 0.f;
      if (!RING) lbn[c] = lb[(size_t)(T - 1) * S + x];
    }
  }
  if (RING) {
    for (int r = T - 1; r >= T - EMIT_AHEAD; --r) {
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (r >= 0 && (mine >> c & 1u))
          copy_ahead(ring_sm + (r & (EMIT_AHEAD - 1)) * S + px[c], lb + (size_t)r * S + px[c]);
      copy_commit();
    }
  }
  const int em = DENSE && lane < ne ? tp.entries[lane] : -1;
  const bool has_e = !DENSE && __any_sync(FULL, emask != 0u);
  if (!DENSE && !has_e) {
    slot_put<C>(slot, 0, warp, sp.rank, NEG);
    slot_put<C>(slot, 1, warp, sp.rank, NEG);
  }
  for (int t = T - 1;; --t) {
    float* bb = buf + (t & 1) * S;
    // The exit terminal again at t == length - 1: 0.
    const bool term = t >= 1 && t == a.len - 1;
    float mx = NEG;
    if (RING) copy_wait();
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (!(mine >> c & 1u)) continue;
      float* ring = ring_sm + (t & (EMIT_AHEAD - 1)) * S + px[c];
      bem[c] = (RING ? *ring : lbn[c]) + (term ? 0.f : beta[c]);
      if (!RING && t >= 1) lbn[c] = lb[(size_t)(t - 1) * S + px[c]];
      bb[px[c]] = bem[c];
      if (C > 1 && px[c] < edge) at_rank(bb, sp.rank - 1)[px[c]] = bem[c];
      if (RING && t >= EMIT_AHEAD) copy_ahead(ring, lb + (size_t)(t - EMIT_AHEAD) * S + px[c]);
      if (!DENSE && (emask >> c & 1u)) mx = fmaxf(mx, bem[c]);
    }
    if (RING) copy_commit();
    if (has_e) {
      mx = warp_max_redux(mx);
      slot_put<C>(slot, t & 1, warp, sp.rank, mx);
    }
    step_sync<C>();
    float part = NEG;  // lane w: warp w's slot of every CTA
    if (DENSE) {
      part = em >= 0 ? bb[em] : NEG;
    } else if (lane < nw) {
#pragma unroll
      for (int r = 0; r < C; ++r) part = fmaxf(part, slot[((t & 1) * C + r) * 32 + lane]);
    }
    const float bq = warp_max_redux(part);
    // beta_entry: rank 0's.
    if (tid == nb && sp.rank == 0) bqr[t & 31] = bq;
    if ((t & 31) == 0 && tid - nb < 32 && sp.rank == 0) {
      __syncwarp();
      if (t + lane < T) a.beta_entry[t + lane] = bqr[(t + lane) & 31];
    }
    if (t == 0) break;
    const float mq = bq + pen;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (!(mine >> c & 1u)) continue;
      const int x = px[c];
      const float t0 = q0[c] + bem[c];
      const float t1 = x + 1 < S ? q1[c] + bb[x + 1] : NEG;
      const float t2 = x + 2 < S ? q2[c] + bb[x + 2] : NEG;
      beta[c] = fmaxf(fmaxf(fmaxf(t0, t1), t2), mq);
    }
  }
}

template <int KS, bool DENSE, int CPL, int C>
__global__ void __launch_bounds__(C > 1 ? CLUSTER_THREADS : MAX_THREADS)
    lattice_max_team_kernel(MaxArgs a, int nb, int npw) {
  extern __shared__ __align__(16) unsigned char msm[];
  const int S = a.tp.S, nw = blockDim.x >> 5;
  const bool band = (int)threadIdx.x < nb;
  const Span sp = span_of<C>(a.tp, blockIdx.x % C);
  if (C > 1) cg::this_cluster().sync();  // every CTA running before another's stores
  if (blockIdx.x < C) {
    MaxCell* rows = (MaxCell*)msm;              // [2][S] (alpha, entry time)
    MaxCell* slot = rows + 2 * S;               // [2][C][32] (value, index)
    float* ws = (float*)(slot + 64 * C);        // [C][32], the score
    float* ring = ws + 32 * C;                  // [EMIT_AHEAD][S] with a dense pool
    float mx = band ? max_band_forward<KS, DENSE, C>(a, rows, slot, ring, nb, sp)
                    : max_pool_forward<DENSE, CPL, C>(a, rows, slot, ring, nb, npw, sp);
    mx = warp_max(mx);
    if ((threadIdx.x & 31) == 0)
      (C > 1 ? at_rank(ws, 0) : ws)[sp.rank * 32 + (threadIdx.x >> 5)] = mx;
    step_sync<C>();
    if (threadIdx.x == 0 && sp.rank == 0) {
      float s = neg_inf();
      for (int r = 0; r < C; ++r)
        for (int w = 0; w < nw; ++w) s = fmaxf(s, ws[r * 32 + w]);
      *a.score = s;
    }
  } else {
    float* buf = (float*)msm;     // [2][S] beta_em
    float* slot = buf + 2 * S;    // [2][C][32], the entries' max
    float* bqr = slot + 64 * C;   // [32], beta_entry's ring
    float* ring = bqr + 32;       // as the forward's
    if (band) {
      max_band_backward<KS, DENSE, C>(a, buf, slot, ring, nb, sp);
    } else {
      max_pool_backward<DENSE, CPL, C>(a, buf, slot, bqr, ring, nb, npw, sp);
    }
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

// -- KBEST, the team branch ---------------------------------------------------

constexpr int KBEST_BUCKET_MAX = 32;  // K past it: the simple branch
constexpr int KBEST_TEAM_EXITS = 32;  // exit rows ranked directly (two barriers a step)
// Past 32, the heads ranked first (three barriers): O(R^2 / threads) a step,
// faster than the first design at 75 and 101 exit rows, slower at 1,001.
constexpr int KBEST_WIDE_EXITS = 128;
constexpr int KBEST_POOL_LANES = 4;   // lanes that rank one pool candidate

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x >> 1); }

int kbest_bucket(int K) {
  int kb = 1;
  while (kb < K) kb <<= 1;
  return kb <= KBEST_BUCKET_MAX ? kb : 0;
}

// The team branch's shared memory, in 4-byte words: the rows [2][S KB],
// the finite counts [2][S] (bytes), the exit list and the pool (values,
// keys); past 32 exits also each state's exit ordinal (-1 off the exits),
// the exit rows' heads [2][R] and the K best-headed rows.
struct KLayout {
  int rows, fcnt, exits, pool_v, pool_k, ex_ord, heads, rowof, words;
};

__host__ __device__ inline KLayout kbest_layout(int S, int kb, int R) {
  KLayout L;
  int w = 0;
  L.rows = w;
  w += 2 * S * kb;
  L.fcnt = w;
  w += (2 * S + 3) / 4;
  L.exits = w;
  w += R;
  L.pool_v = w;
  w += kb;
  L.pool_k = w;
  w += kb;
  L.ex_ord = L.heads = L.rowof = w;
  if (R > KBEST_TEAM_EXITS) {
    w += S;
    L.heads = w;
    w += 2 * R;
    L.rowof = w;
    w += kb;
  }
  L.words = w;
  return L;
}

// The team branch up to K = 32 and KBEST_WIDE_EXITS exit rows, its rows in
// shared memory; else the simple branch.
struct KPlan {
  int team, kb, threads;
  size_t smem;
};

KPlan kbest_plan(int S, int K, int R) {
  KPlan p{};
  p.kb = kbest_bucket(K);
  if (!p.kb || R > KBEST_WIDE_EXITS) return p;
  p.smem = (size_t)kbest_layout(S, p.kb, R).words * 4;
  if (p.smem > KBEST_SMEM_MAX) return p;
  p.team = 1;
  const long long want = 32 * (((long long)S * p.kb + 31) / 32);
  p.threads = want < MAX_THREADS ? (int)want : MAX_THREADS;
  return p;
}

struct KTeamArgs {
  const float* log_b;  // (T, S)
  Topo tp;
  float pen;
  int len, K, T;
  float* alpha;  // (S, K)
  int* bps;      // (T, S, K)
};

// The team's lanes with pred, as bits from the team's first lane (the whole
// warp votes: the merges are warp-uniform).
template <int KB>
__device__ __forceinline__ unsigned team_bits(int base, bool pred) {
  const unsigned b = __ballot_sync(FULL, pred) >> base;
  return KB == 32 ? b : b & ((1u << KB) - 1u);
}

// N binary searches in lock step over the team's KB lanes (a[n]
// non-increasing across them): lo[n] = #{i : a[n]_i > v[n]} (>= for the n
// set in GE), a prefix. The steps KB/2 .. 1 find it up to KB - 1, one check
// of the last lane (shuffled first) the rest; each step issues the N
// shuffles back to back. A team's surplus lanes (slots past K) hold -inf:
// they never count for >, and for >= only on a -inf query, whose rank
// lands past K either way.
constexpr unsigned TEAM_GE = 0b110100u;

template <int KB, int N>
__device__ __forceinline__ void team_counts(const float (&a)[N], const float (&v)[N],
                                            int (&lo)[N]) {
  float last[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    lo[n] = 0;
    last[n] = __shfl_sync(FULL, a[n], KB - 1, KB);
  }
#pragma unroll
  for (int step = KB / 2; step >= 1; step >>= 1) {
    float x[N];
#pragma unroll
    for (int n = 0; n < N; ++n) x[n] = __shfl_sync(FULL, a[n], lo[n] + step - 1, KB);
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (TEAM_GE >> n & 1u ? x[n] >= v[n] : x[n] > v[n]) lo[n] += step;
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (lo[n] == KB - 1 && (TEAM_GE >> n & 1u ? last[n] >= v[n] : last[n] > v[n])) lo[n] = KB;
}

// The pool's top K of the exit rows (value desc, flat index asc), by every
// thread: each finite (row r, slot m) is a candidate, its rank m plus the
// values of the other rows that beat it (a row before r on a tie), counted by
// KBEST_POOL_LANES lanes, each binary-searching a share of the rows in lock
// step; ranks below K land in the pool.
template <int KB, int NR, bool RANKED>
__device__ void pool_select(const float* rows, const unsigned char* fcnt, const int* exits, int R,
                            int K, float* pool_v, int* pool_k) {
  // NR rows a lane: R <= NR LPC. RANKED: exits[h] has the h-th best head,
  // so its values past slot K - h cannot place.
  constexpr int LPC = KBEST_POOL_LANES, LOG = ilog2(KB);
  const int tid = threadIdx.x, lane = tid & 31, nt = blockDim.x;
  // Trip counts uniform across the block (ptxas then keeps the shuffles
  // plain, with no collective loop).
  const int units = R * KB * LPC, rounds = (units + nt - 1) / nt;
  for (int it = 0; it < rounds; ++it) {
    if ((tid & ~31) + it * nt >= units) break;  // the warp has no candidate left
    const int u = (tid & ~31) + it * nt + lane;
    const int c = u / LPC, sub = u % LPC;
    const int r = c >> LOG, m = c & (KB - 1);
    const int x = r < R ? exits[r] : 0;
    const bool valid = r < R && m < (RANKED ? K - r : K) && m < fcnt[x];
    const float v = valid ? rows[x * KB + m] : neg_inf();
    int hb[NR], lim[NR], lo[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r2 = sub + LPC * i;
      const bool on = valid && r2 < R && r2 != r;
      const int x2 = on ? exits[r2] : 0;
      hb[i] = x2 * KB;
      lim[i] = on ? fcnt[x2] : 0;
      lo[i] = 0;
    }
#pragma unroll
    for (int step = KB; step >= 1; step >>= 1) {
      float y[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int idx = lo[i] + step - 1;
        y[i] = idx < lim[i] ? rows[hb[i] + idx] : neg_inf();
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int idx = lo[i] + step - 1;
        const bool earlier = hb[i] < x * KB;  // the lower state first on a tie
        if (idx < lim[i] && (y[i] > v || (earlier && y[i] == v))) lo[i] += step;
      }
    }
    int q = 0;
#pragma unroll
    for (int i = 0; i < NR; ++i) q += lo[i];
#pragma unroll
    for (int off = 1; off < LPC; off <<= 1) q += __shfl_xor_sync(FULL, q, off);
    q += m;
    if (valid && sub == 0 && q < K) {
      pool_v[q] = v;
      pool_k[q] = x * KB + m;
    }
  }
}

// The pool's -inf tail, positions nfin..K-1, by warp 0: the lowest flat
// indices at -inf (non-exit rows whole, an exit row past its finite
// values), a scan over states in chunks of 32; at once where state 0 is
// not an exit (its K slots are the tail).
template <int KB>
__device__ void pool_tail(const Topo& tp, const unsigned char* fcnt, int K, int nfin,
                          float* pool_v, int* pool_k) {
  const int lane = threadIdx.x & 31;
  int q = nfin;
  if (!tp.is_exit(0)) {
    for (int p = q + lane; p < K; p += 32) {
      pool_v[p] = neg_inf();
      pool_k[p] = p - q;
    }
    return;
  }
  for (int s0 = 0; s0 < tp.S && q < K; s0 += 32) {
    const int s = s0 + lane;
    int c = 0, first = 0;
    if (s < tp.S) {
      first = tp.is_exit(s) ? fcnt[s] : 0;
      c = K - first;
    }
    int inc = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, off);
      if (lane >= off) inc += y;
    }
    for (int p = q + inc - c; p < q + inc && p < K; ++p) {
      pool_v[p] = neg_inf();
      pool_k[p] = s * KB + first + (p - (q + inc - c));
    }
    q = min(q + __shfl_sync(FULL, inc, 31), K);
  }
}

// The finite values of the rows in list[0..n) (n <= 32), up to K, by a warp.
__device__ __forceinline__ int finite_values(const unsigned char* fcnt, const int* list, int n,
                                             int K) {
  const int lane = threadIdx.x & 31;
  int total = lane < n ? fcnt[list[lane]] : 0;
#pragma unroll
  for (int off = 16; off; off >>= 1) total += __shfl_xor_sync(FULL, total, off);
  return total < K ? total : K;
}

// The pool past 32 exit rows, (1) of two phases: the exit rows' heads (kept
// by the merges) ranked against each other by every thread, lower row
// first on a tie; rowof[h] gets the state of the row whose head ranks h < K
// (the rows a top-K value can come from; -1 past the finite heads).
__device__ void rank_heads(const float* heads, const int* exits, int R, int K, int* rowof) {
  for (int u = threadIdx.x; u < R; u += blockDim.x) {
    const float hv = heads[u];
    int rank = 0;
    for (int v = 0; v < R; ++v) {
      const float hw = heads[v];
      rank += hw > hv || (hw == hv && v < u);
    }
    if (hv != neg_inf() && rank < K) rowof[rank] = exits[u];
  }
}

template <int KB>
__global__ void __launch_bounds__(MAX_THREADS) kbest_team_kernel(KTeamArgs a) {
  extern __shared__ float smem[];
  constexpr int LOG = ilog2(KB);
  const Topo& tp = a.tp;
  const int S = tp.S, K = a.K, T = a.T, R = tp.n_exits;
  const int tid = threadIdx.x, lane = tid & 31, nt = blockDim.x;
  const float pen = a.pen;
  const KLayout L = kbest_layout(S, KB, R);
  int* wsm = (int*)smem;
  float* rows = smem + L.rows;
  unsigned char* fc0 = (unsigned char*)(wsm + L.fcnt);
  unsigned char* fc1 = fc0 + S;
  int* exits = wsm + L.exits;
  float* pool_v = smem + L.pool_v;
  int* pool_k = wsm + L.pool_k;
  // Past 32 exit rows: the heads (kept by the merges), ranked first.
  const bool wide = R > KBEST_TEAM_EXITS;
  int* ex_ord = wsm + L.ex_ord;
  float* heads = smem + L.heads;
  int* rowof = wsm + L.rowof;

  for (int j = tid; j < S; j += nt) {
    const float a0 = tp.is_entry(j) ? a.log_b[j] + tp.c(6, j) : neg_inf();
    rows[j * KB] = a0;
    for (int r = 1; r < KB; ++r) rows[j * KB + r] = neg_inf();
    fc0[j] = a0 != neg_inf();
    if (wide) ex_ord[j] = -1;
  }
  for (int i = tid; i < S * K; i += nt) a.bps[i] = -1;
  for (int i = tid; i < R; i += nt) exits[i] = tp.exits[i];
  if (wide && tid < KB) rowof[tid] = -1;
  __syncthreads();
  if (wide) {
    for (int i = tid; i < R; i += nt) {
      ex_ord[exits[i]] = i;
      heads[i] = rows[exits[i] * KB];
    }
    __syncthreads();
  }

  // Team g (KB lanes) merges the states j = g + i NG, lane r its slot r;
  // every team walks the same number of rounds (a block-uniform trip count),
  // idle past S.
  const int ng = nt >> LOG, g = tid >> LOG, r = tid & (KB - 1);
  const int rounds = (S + ng - 1) / ng;  // the same for every team
  const int base = lane & ~(KB - 1);
  const unsigned actm = K >= 32 ? FULL : (1u << K) - 1u;
  const unsigned low = (1u << r) - 1u;
  // The first round's state: its coefficients and flags in registers, its
  // emission loaded a step ahead.
  const int g_s = g < S ? g : 0;
  const float g_c0 = tp.c(0, g_s), g_c1 = tp.c(1, g_s), g_c2 = tp.c(2, g_s), g_c3 = tp.c(3, g_s);
  const bool g_entry = tp.is_entry(g_s), g_exit = tp.is_exit(g_s);
  float lb_next = g < S && T > 1 ? a.log_b[(size_t)S + g] : 0.f;

  float* cur = rows;
  float* nxt = rows + S * KB;
  unsigned char* fcur = fc0;
  unsigned char* fnxt = fc1;
  float* hcur = heads;
  float* hnxt = heads + R;
  for (int t = 1; t < T; ++t) {
    const bool live = t < a.len;
    const float lb_first = lb_next;
    if (g < S && t + 1 < T) lb_next = a.log_b[(size_t)(t + 1) * S + g];
    // (1) The pool, by every thread, over the exit rows (up to 32) or, past
    // them, over the K best-headed rows (ranked first, a barrier more);
    // warp 0 fills its -inf tail.
    const int* plist = exits;
    int prows = R;
    if (wide) {
      rank_heads(hcur, exits, R, K, rowof);
      __syncthreads();
      plist = rowof;
      prows = __popc(__ballot_sync(FULL, lane < K && rowof[lane] >= 0));
    }
    if (prows <= KBEST_POOL_LANES) {
      if (wide) pool_select<KB, 1, true>(cur, fcur, plist, prows, K, pool_v, pool_k);
      else pool_select<KB, 1, false>(cur, fcur, plist, prows, K, pool_v, pool_k);
    } else if (prows <= 2 * KBEST_POOL_LANES) {
      if (wide) pool_select<KB, 2, true>(cur, fcur, plist, prows, K, pool_v, pool_k);
      else pool_select<KB, 2, false>(cur, fcur, plist, prows, K, pool_v, pool_k);
    } else if (prows <= 4 * KBEST_POOL_LANES) {
      if (wide) pool_select<KB, 4, true>(cur, fcur, plist, prows, K, pool_v, pool_k);
      else pool_select<KB, 4, false>(cur, fcur, plist, prows, K, pool_v, pool_k);
    } else {
      if (wide) pool_select<KB, 8, true>(cur, fcur, plist, prows, K, pool_v, pool_k);
      else pool_select<KB, 8, false>(cur, fcur, plist, prows, K, pool_v, pool_k);
    }
    if (tid < 32)
      pool_tail<KB>(tp, fcur, K, finite_values(fcur, plist, prows, K), pool_v, pool_k);
    __syncthreads();
    if (wide && tid < KB) rowof[tid] = -1;  // read above; the next step ranks anew
    // (2) Each state's stable top K by ranks, entries and non-entries in one
    // code path.
    for (int it = 0; it < rounds; ++it) {
      const int j = g + it * ng;
      const bool act = j < S && r < K;
      const int js = j < S ? j : 0;
      const bool first = it == 0;
      const bool entry = first ? g_entry : tp.is_entry(js);
      const float lbt = first ? lb_first : a.log_b[(size_t)t * S + js];
      const float c0 = first ? g_c0 : tp.c(0, js), c1 = first ? g_c1 : tp.c(1, js);
      const float c2 = first ? g_c2 : tp.c(2, js), dg = first ? g_c3 : tp.c(3, js);
      // A non-entry: the 3K candidates of blocks (s-2, s-1, s), value
      // desc, block asc, slot asc. An entry: [pool + penalty, own K
      // self-loops], value desc, the pool first, index asc; a single-state
      // word keeps one copy of a hypothesis reaching it both ways (its pool
      // members are its slots [0, cj)).
      const float own = act ? cur[js * KB + r] : neg_inf();
      const float b0 = act && !entry && j >= 2 ? cur[(js - 2) * KB + r] + c2 : neg_inf();
      const float b1 = act && !entry && j >= 1 ? cur[(js - 1) * KB + r] + c1 : neg_inf();
      const float b2 = act && !entry ? own + c0 : neg_inf();
      const float pv = act && entry ? pool_v[r] : neg_inf();
      const int pk = act && entry ? pool_k[r] : 0;
      const int ps = pk >> LOG, pm = pk & (KB - 1);
      const bool both = entry && (first ? g_exit : tp.is_exit(js)), beats = pen >= dg;
      const float pco = pv + pen;
      const float sco = act && entry ? own + dg : neg_inf();
      const int cj = __popc(team_bits<KB>(base, act && both && ps == j));
      const bool pmask = act && both && !beats && ps == j;
      const bool smask = act && both && beats && r < cj;
      const float pc = pmask ? neg_inf() : pco;
      const float sc = smask ? neg_inf() : sco;
      const unsigned pf = team_bits<KB>(base, act && pc != neg_inf());
      const unsigned sf = team_bits<KB>(base, act && sc != neg_inf());
      const unsigned pmk = team_bits<KB>(base, pmask);
      // Non-entry searches: b1 > b0, b2 > b0, b0 >= b1, b2 > b1, b0 >= b2,
      // b1 >= b2; entry (in slots 0 and 2): self-loops beating pool
      // candidate r (strictly), pool candidates beating self-loop r (on a
      // tie too).
      const float arr[6] = {entry ? sco : b1, b2, entry ? pco : b0, b2, b0, b1};
      const float qv[6] = {entry ? pc : b0, b0, entry ? sc : b1, b1, b2, b2};
      int lo[6];
      team_counts<KB, 6>(arr, qv, lo);
      float nv[3];
      int q[3], code[3];
      if (!entry) {
        q[0] = r + lo[0] + lo[1];
        q[1] = r + lo[2] + lo[3];
        q[2] = r + lo[4] + lo[5];
        code[0] = max(j - 2, 0) * K + r;
        code[1] = max(j - 1, 0) * K + r;
        code[2] = j * K + r;
        nv[0] = b0 + lbt;
        nv[1] = b1 + lbt;
        nv[2] = b2 + lbt;
      } else {
        const int fin = __popc(pf) + __popc(sf);
        const int m0 = both && beats ? cj : 0;
        q[0] = pc != neg_inf() ? __popc(pf & low) + max(lo[0] - m0, 0)
                               : fin + __popc(~pf & actm & low);
        const unsigned below = lo[2] >= 32 ? FULL : (1u << lo[2]) - 1u;
        q[1] = sc != neg_inf() ? lo[2] - __popc(pmk & below) + __popc(sf & low)
                               : fin + (K - __popc(pf)) + __popc(~sf & actm & low);
        q[2] = K;
        code[0] = ps * K + pm;
        code[1] = j * K + r;
        code[2] = 0;
        nv[0] = pc + lbt;
        nv[1] = sc + lbt;
        nv[2] = neg_inf();
      }
      int f = 0;
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        if (!act) q[n] = K;
        if (q[n] < K) a.bps[((size_t)t * S + j) * K + q[n]] = code[n];
        if (live && q[n] < K) nxt[j * KB + q[n]] = nv[n];
        if (wide && live && q[n] == 0 && ex_ord[js] >= 0) hnxt[ex_ord[js]] = nv[n];
        f += __popc(team_bits<KB>(base, q[n] < K && nv[n] != neg_inf()));
      }
      if (live && r == 0 && j < S) fnxt[j] = f;
    }
    __syncthreads();
    if (live) {
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      unsigned char* ftmp = fcur;
      fcur = fnxt;
      fnxt = ftmp;
      float* htmp = hcur;
      hcur = hnxt;
      hnxt = htmp;
    }
  }
  for (int j = tid; j < S; j += nt)
    for (int q = 0; q < K; ++q) a.alpha[(size_t)j * K + q] = cur[j * KB + q];
}

// The serial floor of a team step: a block of the same threads running the
// step's barriers and shared exchanges alone (each thread writes a word,
// the barrier, each reads its neighbour's), `barriers` a step (timing).
__global__ void __launch_bounds__(MAX_THREADS) lattice_skeleton_kernel(int steps, int barriers,
                                                                       float* out) {
  extern __shared__ float sk[];
  const int tid = threadIdx.x, nt = blockDim.x;
  float v = (float)tid;
  for (int t = 0; t < steps; ++t)
    for (int i = 0; i < barriers; ++i) {
      float* row = sk + ((t * barriers + i) & 1) * nt;
      row[tid] = v;
      __syncthreads();
      v += row[tid + 1 < nt ? tid + 1 : 0];
    }
  out[blockIdx.y * gridDim.x * nt + blockIdx.x * nt + tid] = v;
}

// The same floor on a cluster of C CTAs a pass (2 C CTAs): the cluster
// barrier and an exchange through distributed shared memory a step, one
// warp reading the next CTA's row.
__global__ void __launch_bounds__(MAX_THREADS) lattice_cluster_skeleton_kernel(int steps, int c,
                                                                               float* out) {
  extern __shared__ float sk[];
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x, r = (int)cl.block_rank();
  float v = (float)tid;
  cl.sync();
  for (int t = 0; t < steps; ++t) {
    float* row = sk + (t & 1) * nt;
    row[tid] = v;
    cl.sync();
    const float* src = tid < 32 ? cl.map_shared_rank(row, (r + 1) % c) : row;
    v += src[tid + 1 < nt ? tid + 1 : 0];
  }
  cl.sync();
  out[blockIdx.x * nt + tid] = v;
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

// LSUM's plan at a shape: out[0] the branch (0 team, 1 simple), out[1] K
// (states a band thread), out[2] the dense pool's bucket (0: factorized),
// out[3] pool warps, out[4] threads, out[5] the build's cells a pool lane.
extern "C" int cs304_lattice_sum_plan(int S, int n_exits, int n_entries, int* out) {
  const SumPlan p = sum_plan(S, n_exits, n_entries);
  out[0] = p.team ? 0 : 1;
  out[1] = p.team ? p.ks : states_per_thread(S);
  out[2] = p.wb;
  out[3] = p.npw;
  out[4] = p.team ? p.threads : block_threads(S, states_per_thread(S));
  out[5] = p.wb || p.cpl <= 1 ? 1 : SUM_CELLS_A_LANE;
  return 0;
}

template <int KS, int WB, int CPL>
cudaError_t launch_sum_team(const SumArgs& a, const SumPlan& p, cudaStream_t st) {
  const cudaError_t e = allow_smem(lattice_sum_team_kernel<KS, WB, CPL>, p.smem);
  if (e != cudaSuccess) return e;
  lattice_sum_team_kernel<KS, WB, CPL><<<dim3(a.B, 2), p.threads, p.smem, st>>>(a, p.band, p.npw,
                                                                               p.cpl);
  return cudaSuccess;
}

template <int KS>
cudaError_t launch_sum_team_wb(const SumArgs& a, const SumPlan& p, cudaStream_t st) {
  switch (p.wb) {
    case 8:
      return launch_sum_team<KS, 8, 1>(a, p, st);
    case 16:
      return launch_sum_team<KS, 16, 1>(a, p, st);
    case 32:
      return launch_sum_team<KS, 32, 1>(a, p, st);
    default:
      if (p.cpl == 1) return launch_sum_team<KS, 0, 1>(a, p, st);
      return launch_sum_team<KS, 0, SUM_CELLS_A_LANE>(a, p, st);
  }
}

// LSUM: log_b (B, T, S), the topology, lengths (B,) -> alphas, beta_em
// (B, T, S), beta_entry (B, T), log_z (B,); contiguous float32 / int32.
// simple != 0 takes the first design (the simple branch) at any shape.
extern "C" int cs304_lattice_sum(const void* log_b, const void* coefs, const void* ints,
                                 const void* exits, const void* entries, const void* lengths,
                                 float penalty, void* alphas, void* beta_em, void* beta_entry,
                                 void* log_z, int B, int T, int S, int n_exits, int n_entries,
                                 int simple, void* stream) {
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
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  const SumPlan p = sum_plan(S, n_exits, n_entries);
  if (p.team && !simple) {
    switch (p.ks) {
      case 1:
        e = launch_sum_team_wb<1>(a, p, st);
        break;
      case 2:
        e = launch_sum_team_wb<2>(a, p, st);
        break;
      case 4:
        e = launch_sum_team_wb<4>(a, p, st);
        break;
      default:
        e = launch_sum_team_wb<8>(a, p, st);
        break;
    }
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  const int k = states_per_thread(S);
  const int threads = block_threads(S, k);
  const size_t smem = (2 * (size_t)S + 64) * sizeof(float) +
                      (size_t)(n_exits > n_entries ? n_exits : n_entries) * sizeof(int);
  const dim3 grid(B, 2);
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

// The skeleton of `steps` team steps on a (blocks, 2 if pair) grid of
// `threads`: out (blocks * threads * (1 + pair),) float32.
extern "C" int cs304_lattice_skeleton(int blocks, int pair, int threads, int steps, int barriers,
                                      void* out, void* stream) {
  if (blocks < 1 || threads < 1 || threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  lattice_skeleton_kernel<<<dim3(blocks, pair ? 2 : 1), threads, 2 * threads * sizeof(float),
                            (cudaStream_t)stream>>>(steps, barriers, (float*)out);
  return (int)cudaGetLastError();
}

// The cluster skeleton of `steps` steps, `ctas` CTAs a pass of `threads`:
// out (2 ctas threads,) float32.
extern "C" int cs304_lattice_cluster_skeleton(int ctas, int threads, int steps, void* out,
                                              void* stream) {
  if (ctas < 2 || ctas > 8 || threads < 1 || threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(2 * ctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 2 * threads * sizeof(float);
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, lattice_cluster_skeleton_kernel, steps, ctas,
                                           (float*)out);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// LMAX's plan at a shape: out[0] the branch (0 team, 1 simple), out[1] K
// (states a band thread), out[2] 1 where the pool is dense, out[3] pool
// warps, out[4] threads, out[5] the build's cells a pool lane, out[6] the
// CTAs a pass (a cluster past 1).
extern "C" int cs304_lattice_max_plan(int S, int n_exits, int n_entries, int* out) {
  const MaxPlan p = max_plan(S, n_exits, n_entries);
  out[0] = p.team ? 0 : 1;
  out[1] = p.team ? p.ks : states_per_thread(S);
  out[2] = p.dense;
  out[3] = p.npw;
  out[4] = p.team ? p.threads : block_threads(S, states_per_thread(S));
  out[5] = p.team ? p.cpl : 1;
  out[6] = p.team ? p.c : 1;
  return 0;
}

template <int KS, bool DENSE, int CPL, int C>
cudaError_t launch_max_team(const MaxArgs& a, const MaxPlan& p, cudaStream_t st) {
  auto kernel = lattice_max_team_kernel<KS, DENSE, CPL, C>;
  const cudaError_t e = allow_smem(kernel, p.smem);
  if (e != cudaSuccess) return e;
  if (C == 1) {
    kernel<<<2, p.threads, p.smem, st>>>(a, p.band, p.npw);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(2 * C, 1, 1);  // the forward's cluster, then the backward's
  cfg.blockDim = dim3(p.threads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a, p.band, p.npw);
}

// A factorized pool's build: its cells a lane, at most 2 KS (max_plan).
template <int KS, int C>
cudaError_t launch_max_team_cells(const MaxArgs& a, const MaxPlan& p, cudaStream_t st) {
  if (p.cpl == 1) return launch_max_team<KS, false, 1, C>(a, p, st);
  if (p.cpl == 2) return launch_max_team<KS, false, 2, C>(a, p, st);
  if constexpr (KS >= 2) {
    if (p.cpl == 4) return launch_max_team<KS, false, 4, C>(a, p, st);
  }
  if constexpr (KS >= 4) {
    if (p.cpl == 8) return launch_max_team<KS, false, 8, C>(a, p, st);
  }
  return cudaErrorInvalidValue;
}

template <int KS>
cudaError_t launch_max_team_pool(const MaxArgs& a, const MaxPlan& p, cudaStream_t st) {
  if (p.dense) return launch_max_team<KS, true, 1, 1>(a, p, st);
  if constexpr (KS == 4) {  // the cluster builds
    if (p.c == 2) return launch_max_team_cells<4, 2>(a, p, st);
    if (p.c == 4) return launch_max_team_cells<4, 4>(a, p, st);
  }
  return launch_max_team_cells<KS, 1>(a, p, st);
}

// LMAX: log_b (T, S), the topology (coefs, ints with the carry bits, the
// exit and entry lists), the length -> alphas (T, S) float32, entry times
// (T, S) int32, beta_entry (T,), score (). simple != 0 takes the first
// design (the simple branch) at any shape.
extern "C" int cs304_lattice_max(const void* log_b, const void* coefs, const void* ints,
                                 const void* exits, const void* entries, float penalty,
                                 int length, void* alphas, void* ets, void* beta_entry,
                                 void* score, int T, int S, int n_exits, int n_entries,
                                 int simple, void* stream) {
  if (T < 1 || S < 1 || S > MAX_STATES || n_exits < 1 || n_entries < 1)
    return (int)cudaErrorInvalidValue;
  MaxArgs a;
  a.log_b = (const float*)log_b;
  a.tp = make_topo(coefs, ints, exits, entries, S, n_exits, n_entries);
  a.pen = penalty;
  a.len = length;
  a.alphas = (float*)alphas;
  a.ets = (int*)ets;
  a.beta_entry = (float*)beta_entry;
  a.score = (float*)score;
  a.T = T;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  const MaxPlan p = max_plan(S, n_exits, n_entries);
  if (p.team && !simple) {
    switch (p.ks) {
      case 1:
        e = launch_max_team_pool<1>(a, p, st);
        break;
      case 2:
        e = launch_max_team_pool<2>(a, p, st);
        break;
      default:
        e = launch_max_team_pool<4>(a, p, st);
        break;
    }
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  const int k = states_per_thread(S);
  const int threads = block_threads(S, k);
  // Forward: two float rows, two int rows, (value, index) slots [2][32]
  // and a score slot row; the backward uses less.
  const size_t smem = (4 * (size_t)S + 64 + 64 + 32) * sizeof(float);
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

// KBEST's plan at (S, K, exits): out[0] the branch (0 team, 1 simple),
// out[1] the bucket, out[2] threads, out[3] unused (0), out[4] 1 where the
// rows live in the device scratch.
extern "C" int cs304_kbest_plan(int S, int K, int n_exits, int* out) {
  const KPlan p = kbest_plan(S, K, n_exits);
  out[0] = p.team ? 0 : 1;
  out[1] = p.kb;
  out[2] = p.team ? p.threads : (S >= MAX_THREADS ? MAX_THREADS : 32 * ((S + 31) / 32));
  out[3] = 0;
  out[4] = p.team ? 0 : (int)(kbest_words(S, K) * 4 > KBEST_SMEM_MAX);
  return 0;
}

// The device scratch KBEST needs (int32 words): 0 where its rows and lists
// fit shared memory (the team branch keeps its rows there; the simple
// branch's need).
extern "C" long long cs304_kbest_scratch_words(int S, int K) {
  const size_t words = kbest_words(S, K);
  return words * 4 <= KBEST_SMEM_MAX ? 0 : (long long)words;
}

template <int KB>
cudaError_t launch_kbest_team(const KTeamArgs& a, const KPlan& p, cudaStream_t st) {
  const cudaError_t e = allow_smem(kbest_team_kernel<KB>, p.smem);
  if (e != cudaSuccess) return e;
  kbest_team_kernel<KB><<<1, p.threads, p.smem, st>>>(a);
  return cudaSuccess;
}

// KBEST: log_b (T, S), the topology's coefs and exits, the length, K ->
// alpha (S, K) float32, bps (T, S, K) int32; scratch: cs304_kbest_scratch_words.
// simple != 0 takes the first design (the simple branch) at any K.
extern "C" int cs304_kbest_forward(const void* log_b, const void* coefs, const void* exits,
                                   float penalty, int length, int K, void* alpha, void* bps,
                                   void* scratch, int T, int S, int n_exits, int simple,
                                   void* stream) {
  if (T < 1 || S < 1 || S > MAX_STATES || K < 1 || n_exits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const KPlan p = kbest_plan(S, K, n_exits);
  if (p.team && !simple) {
    KTeamArgs a;
    a.log_b = (const float*)log_b;
    a.tp = make_topo(coefs, nullptr, exits, nullptr, S, n_exits, 0);
    a.pen = penalty;
    a.len = length;
    a.K = K;
    a.T = T;
    a.alpha = (float*)alpha;
    a.bps = (int*)bps;
    cudaError_t e = cudaSuccess;
    switch (p.kb) {
      case 1:
        e = launch_kbest_team<1>(a, p, st);
        break;
      case 2:
        e = launch_kbest_team<2>(a, p, st);
        break;
      case 4:
        e = launch_kbest_team<4>(a, p, st);
        break;
      case 8:
        e = launch_kbest_team<8>(a, p, st);
        break;
      case 16:
        e = launch_kbest_team<16>(a, p, st);
        break;
      default:
        e = launch_kbest_team<32>(a, p, st);
        break;
    }
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
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
  const cudaError_t e = allow_smem(kbest_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kbest_kernel<<<1, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}
