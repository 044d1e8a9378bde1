// Constrained composite Viterbi for Hopper: the plane-product trellis of
// counted and grammar decoding (PLANES) and the state-duration lattice
// (DURATION), each a team kernel that walks its own path, with the simple
// first design of each kept for the shapes past the teams.
//
// PLANES replaces the JAX package's lax.scans of
// cs304_tpu/ops/viterbi_counted.py:124 (viterbi_composite_counted) and
// cs304_tpu/ops/grammar.py:237 (viterbi_composite_grammar); DURATION the
// lax.scan of cs304_tpu/ops/viterbi_duration.py:145
// (viterbi_composite_duration). None of them has a Pallas kernel. The
// plain versions are cs304_tpu_torch/ops/grammar.py:
// viterbi_composite_grammar_batch_plain (counted decoding is grammar
// decoding under the chain automaton, ops/viterbi_counted.py:
// chain_grammar; its own plain loop is viterbi_composite_counted_batch_plain)
// and ops/viterbi_duration.py:viterbi_composite_duration_batch_plain. Every
// branch is bitwise its plain version in scores (signs of zero included),
// and in the paths of every utterance whose score is finite: at a -inf
// cell the plain versions' argmax points at index 0 and the kernels'
// somewhere else in range.
//
// What they compute. PLANES: cells (g, j), g a plane of the G-state word
// automaton, j a composite state. A step t (1 <= t < length): each plane's
// best exit (the max of alpha over the exit states, the lowest exit index,
// better()'s order); each (plane g, word w)'s cross move, the best of those
// maxima over the source planes g' with next_state[g', w] == g in ascending
// g' (a strict > keeps the lowest), THEN the penalty -- the max on raw
// alpha, as the plain version takes it; each cell's stay (j-2, j-1, j on
// the word's band, an entry's own self-loop only; the first max in that
// order) against, at an entry, the cross move of its plane and word, the
// exit winning an exact tie (>=), the value fmaxf of the two plus
// log_b[t, j]. The t = 0 seed: an entry j in the plane its word leads to
// from plane 0, log_b[0, j] + a0[j]. The final: the best alpha over the
// accepting planes' exit cells, the lowest packed cell g * S + j.
// DURATION: cells (s, d), d + 1 frames in state s (d saturating at D - 1
// where max_dur is unbounded). A step: each state's best completed slot
// (the max of alpha[s, d] over d + 1 >= min_dur[s], the lowest d); slot 0
// advances (a non-entry j from max(j-2, lower) .. j-1, the sum
// best_completed + log_a[i, j]; an entry from every other exit, the sum
// best_completed + penalty; sums compared, not maxima: a + p == b + p can
// hold where a != b); slots d >= 1 stay (alpha[s, d-1], at D - 1 fmaxf with
// alpha[s, D-1] when unbounded, the saturated stay taken only on a strict
// >, + log_a[s, s] where d + 1 <= max_dur[s]); then + log_b[t, s]. The
// final: the best alpha over exit x, complete d. Steps t >= length leave
// alpha as it is: the kernels stop there.
//
// What bounded the first design (PR 19, the simple branch below:
// trellis_planes_kernel, trellis_duration_kernel): a step was a chain
// through three (two) block barriers of up to 1,024 threads; the emission
// row and the per-cell tables were loaded on that chain; every cell paid an
// integer division, and past ~1,000 cells a thread walked 10-30 cells of
// dependent loads; PLANES' exit search put a warp on a plane whatever the
// plane's exits; an entry that is also an exit scanned every exit; int32
// backpointers for every (step, cell) went to device memory (34 MB at
// B = 64, T = 256, 8 planes) and K2-bt read them back in a second launch;
// one block an utterance left most SMs idle at B = 2.
//
// What bounds the team kernels: the same serial chain of T steps, now one
// barrier and each warp's own chain of dependent instructions a step (~140
// for a one-warp DURATION team, ~210 for a PLANES warp at K = 2; several
// warps a scheduler past ~500 states), far above the bytes and operations
// (PERF.md, PR 20). The design:
//   - Each lane holds K contiguous states (K = 2 at S <= 64, else 4 up to
//     2,048 states for PLANES and 1,024 for DURATION, then 8) of one plane
//     (PLANES) or with their D slots (DURATION) in registers for the whole
//     time loop -- alpha and the coefficients; a lane reads its j-1 / j-2
//     neighbours from its own registers or the previous lane by
//     __shfl_up_sync (a warp's lane 31 through shared memory past one
//     warp). Emission rows come DP steps ahead into registers (time_loop,
//     unrolled by templates). Nothing is divided in the loop, and a cell's
//     moves are selects, not branches.
//   - ONE barrier a step: __syncwarp where an utterance is one warp, the
//     block's where it is one CTA, barrier.cluster where it is a cluster.
//     Before it each warp publishes its best exit and its lane-31
//     boundary. At a non-zero penalty (KEY) the best exit is two
//     redux.syncs over order-preserving keys (the value, then the lowest
//     index holding it): adding the penalty hides the key's -0 / +0
//     folding. At a zero penalty, and for DURATION where an entry is also
//     an exit (the best two exit sums), better()'s butterfly; both are
//     compile-time choices, as a shuffle under a runtime branch compiles to
//     a collective. After the barrier lane l folds plane l's warp partials
//     once and each PLANES entry takes its lowest source plane's by a
//     shuffle (the lowest source a byte in registers, from the routing
//     table before the loop; an entry with more sources, a grammar's merge,
//     reads the rest of its routing row); DURATION's team folds its warps'.
//   - PLANES past one CTA (5003 states: a plane is 20 warps of 8 states)
//     gives an utterance a cluster of up to 8 CTAs, whole planes a CTA; the
//     partials go to every CTA's shared memory through distributed shared
//     memory, as K4's CLUSTER branch does (trellis_dense.cu), and B = 2
//     then spreads over 6 SMs.
//   - DURATION: four one-warp teams a block at S <= 64 (no block
//     barrier); the stay shift and the best completed slot stay inside the
//     lane, computed before the barrier (the saturating slot D - 1 a mask
//     bit: a run-time slot index would put the slots in local memory);
//     past 16 slots a lane at K = 8 (slots_shared) the slots live in shared
//     memory, each thread its own.
//   - One byte a (step, cell) in place of the int32 backpointer, and the
//     walk in the same launch (walk_codes, K2-bt's semantics and quirk;
//     cells g << 16 | j and s << 3 | d, so nothing is divided).
//     PLANES: c in {0, 1, 2} the stay from j - c, 3 | g' << 2 the cross
//     from plane g' (so G <= 64), whose index the step's row of per-plane
//     best exits (int16) holds. DURATION: at d >= 1, 0 the shift, 1 the
//     saturated stay; at d = 0, kind | slot << 3 with kind 1 / 2 the advance
//     from j - kind and its best completed slot, 3 / 4 the step's best /
//     second-best exit cell (two int32 a step). In shared memory where an
//     utterance's fit in WS_SMEM_BUDGET, else in a global scratch, which
//     the walk reads in place or, at narrow rows (*_STAGE_MAX_ROW), stages
//     in tiles by cp.async. No (B, T, cells) tensor reaches device memory
//     and no K2-bt launch follows.
// The size dispatch (planes_plan / duration_plan): PLANES with more than
// 64 planes, more than 32,767 states or more than 8 CTAs of planes, and
// DURATION past 8 slots or 20 warps of 8 states, take the simple branch:
// the first design's forward (alpha double-buffered with the step's tables
// in shared memory up to WS_SMEM_BUDGET, else a global scratch; int32
// backpointers (B, T, cells)) walked by K2-bt (trellis_scanfree.cu) up to
// the widest row it stages (29,048 cells on an H100, which
// cs304_trellis_backtrace_max_states reports), else by the forward's
// thread 0 in global memory with K2-bt's semantics.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
// Dynamic shared memory a block's alpha buffers and step tables may take
// (the card allows 227 KB; the rest covers the static reduction buffers).
constexpr size_t WS_SMEM_BUDGET = 200 * 1024;
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& bv, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, bv, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

// Each warp's best (value, index) into red_*; after the barrier every
// thread folds them (better() is a total order, so the fold's order does
// not matter).
__device__ __forceinline__ void block_best(float& bv, int& bi, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(bv, bi);
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  bv = neg_inf();
  bi = INT_MAX;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
    if (better(red_v[k], red_i[k], bv, bi)) {
      bv = red_v[k];
      bi = red_i[k];
    }
  }
}

// K2-bt's walk (trellis_scanfree.cu:trellis_backtrace_kernel), by one
// thread on rows in global memory: path[t] holds the cell stepped back from
// at t, entries past the length the start cell, path[0] the first cell;
// the quirk sets path[L-1] = path[L-2].
__device__ void walk(const int* bps_b, size_t cells, int T, int length, int start,
                     int quirk, int* p) {
  for (int t = max(length, 1); t < T; ++t) p[t] = start;
  const int hi = min(length, T) - 1;
  const int second = min(max(length - 2, 0), T - 1);
  int state = start;
  int at_second = start;
  for (int t = hi; t >= 1; --t) {
    p[t] = state;
    if (t == second) at_second = state;
    state = bps_b[(size_t)t * cells + state];
  }
  p[0] = state;
  if (second == 0) at_second = state;
  const int last = max(length - 1, 0);
  if (quirk && last < T) p[last] = at_second;
}

struct PlanesArgs {
  const float* log_b;      // (B, T, ld), state j of row t at t * ld + j
  const int* lengths;      // (B,)
  const float* ftab;       // (4, S): c2, c1, c0 (stay from j-2, j-1, j; -inf off the band), a0
  const int* itab;         // (2, S): word (-1 off the entries), seed plane (-1: none)
  const int* exits;        // (n_exit,) ascending
  const int* route_off;    // (G * W + 1,)
  const int* route_src;    // source planes of each (g, w), ascending
  const int* accept;       // (G,)
  float penalty;
  int T, S, ld, G, W, n_exit;
  float* scores;           // (B,)
  int* start;              // (B,) packed start cell of the walk
  int* bps;                // (B, T, G * S)
  int* path;               // (B, T) packed cells, or null (K2-bt walks)
  int quirk;
  float* scratch;          // (B, ws_words) where the tables are not in shared memory
  int ws_words;
  int ws_smem;
};

__global__ void __launch_bounds__(MAX_THREADS) trellis_planes_kernel(const PlanesArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int S = a.S, G = a.G, W = a.W, n_exit = a.n_exit;
  const int cells = G * S, pairs = G * W;
  float* ws = a.ws_smem ? smem : a.scratch + (size_t)b * a.ws_words;
  float* cur = ws;
  float* nxt = ws + cells;
  float* be_val = ws + 2 * cells;
  int* be_idx = (int*)(be_val + G);
  float* cross_val = (float*)(be_idx + G);
  int* cross_cell = (int*)(cross_val + pairs);
  const float* c2 = a.ftab;
  const float* c1 = a.ftab + S;
  const float* c0 = a.ftab + 2 * S;
  const float* a0 = a.ftab + 3 * S;
  const int* word = a.itab;
  const int* seed = a.itab + S;
  const int length = a.lengths[b];
  const float* lb_b = a.log_b + (size_t)b * a.T * a.ld;
  int* bps_b = a.bps + (size_t)b * a.T * cells;

  for (int c = tid; c < cells; c += nt) {
    const int g = c / S, j = c - g * S;
    cur[c] = seed[j] == g ? lb_b[j] + a0[j] : neg_inf();
  }
  __syncthreads();
  const int steps = min(length, a.T);
  for (int t = 1; t < steps; ++t) {
    // A: each plane's best exit.
    for (int g = warp; g < G; g += nw) {
      float bv = neg_inf();
      int bi = INT_MAX;
      for (int k = lane; k < n_exit; k += 32) {
        const int x = a.exits[k];
        const float v = cur[g * S + x];
        if (better(v, x, bv, bi)) {
          bv = v;
          bi = x;
        }
      }
      warp_best(bv, bi);
      if (lane == 0) {
        be_val[g] = bv;
        be_idx[g] = bi == INT_MAX ? 0 : bi;
      }
    }
    __syncthreads();
    // B: each (plane, word) pair's best source plane, then the penalty.
    for (int p = tid; p < pairs; p += nt) {
      float best = neg_inf();
      int src = 0;
      for (int k = a.route_off[p]; k < a.route_off[p + 1]; ++k) {
        const int g2 = a.route_src[k];
        const float v = be_val[g2];
        if (v > best) {
          best = v;
          src = g2;
        }
      }
      cross_val[p] = best + a.penalty;
      cross_cell[p] = src * S + be_idx[src];
    }
    __syncthreads();
    // C: stay against cross, + log_b; one backpointer a cell.
    const float* lb = lb_b + (size_t)t * a.ld;
    int* bp = bps_b + (size_t)t * cells;
    for (int c = tid; c < cells; c += nt) {
      const int g = c / S, j = c - g * S;
      const float* al = cur + g * S;
      float stay = neg_inf();
      int si = j;
      if (j >= 2) {
        const float v = al[j - 2] + c2[j];
        if (v > stay) {
          stay = v;
          si = j - 2;
        }
      }
      if (j >= 1) {
        const float v = al[j - 1] + c1[j];
        if (v > stay) {
          stay = v;
          si = j - 1;
        }
      }
      {
        const float v = al[j] + c0[j];
        if (v > stay) {
          stay = v;
          si = j;
        }
      }
      float m = stay;
      int from = g * S + si;
      const int w = word[j];
      if (w >= 0) {
        const float cross = cross_val[g * W + w];
        if (cross >= stay) from = cross_cell[g * W + w];
        m = fmaxf(stay, cross);
      }
      nxt[c] = m + lb[j];
      bp[c] = from;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // The best accepted exit cell.
  float bv = neg_inf();
  int bi = INT_MAX;
  for (int k = tid; k < G * n_exit; k += nt) {
    const int g = k / n_exit;
    if (!a.accept[g]) continue;
    const int cell = g * S + a.exits[k - g * n_exit];
    const float v = cur[cell];
    if (better(v, cell, bv, bi)) {
      bv = v;
      bi = cell;
    }
  }
  block_best(bv, bi, red_v, red_i);
  if (bi == INT_MAX) bi = 0;
  if (tid == 0) {
    a.scores[b] = bv;
    a.start[b] = bi;
    if (a.path != nullptr) walk(bps_b, cells, a.T, length, bi, a.quirk, a.path + (size_t)b * a.T);
  }
}

struct DurationArgs {
  const float* log_b;      // (B, T, ld)
  const int* lengths;      // (B,)
  const float* ftab;       // (4, S): m2, m1 (advance from j-2, j-1; -inf off the band), diag, a0
  const int* itab;         // (3, S): flags (1 entry, 2 exit, 4 unbounded), min_dur, max_dur
  const int* exits;        // (n_exit,) ascending
  float penalty;
  int T, S, ld, D, n_exit;
  float* scores;
  int* start;
  int* bps;                // (B, T, S * D)
  int* path;
  int quirk;
  float* scratch;
  int ws_words;
  int ws_smem;
};

__global__ void __launch_bounds__(MAX_THREADS) trellis_duration_kernel(const DurationArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int S = a.S, D = a.D, n_exit = a.n_exit;
  const int cells = S * D;
  float* ws = a.ws_smem ? smem : a.scratch + (size_t)b * a.ws_words;
  float* cur = ws;
  float* nxt = ws + cells;
  float* bc_val = ws + 2 * cells;
  int* bc_d = (int*)(bc_val + S);
  const float* m2 = a.ftab;
  const float* m1 = a.ftab + S;
  const float* diag = a.ftab + 2 * S;
  const float* a0 = a.ftab + 3 * S;
  const int* flags = a.itab;
  const int* min_dur = a.itab + S;
  const int* max_dur = a.itab + 2 * S;
  const int length = a.lengths[b];
  const float* lb_b = a.log_b + (size_t)b * a.T * a.ld;
  int* bps_b = a.bps + (size_t)b * a.T * cells;

  for (int c = tid; c < cells; c += nt) {
    const int s = c / D, d = c - s * D;
    cur[c] = d == 0 && (flags[s] & 1) ? lb_b[s] + a0[s] : neg_inf();
  }
  __syncthreads();
  const int steps = min(length, a.T);
  for (int t = 1; t < steps; ++t) {
    // A: each state's best completed slot; each warp's best exit sum.
    float ev = neg_inf();
    int ei = INT_MAX;
    for (int s = tid; s < S; s += nt) {
      float best = neg_inf();
      int bd = 0;
      for (int d = max(min_dur[s] - 1, 0); d < D; ++d) {
        const float v = cur[s * D + d];
        if (v > best) {
          best = v;
          bd = d;
        }
      }
      bc_val[s] = best;
      bc_d[s] = bd;
      if (flags[s] & 2) {
        const float v = best + a.penalty;
        if (better(v, s, ev, ei)) {
          ev = v;
          ei = s;
        }
      }
    }
    warp_best(ev, ei);
    if (lane == 0) {
      red_v[warp] = ev;
      red_i[warp] = ei;
    }
    __syncthreads();
    // C: slot 0 advances, slots >= 1 stay; + log_b.
    const float* lb = lb_b + (size_t)t * a.ld;
    int* bp = bps_b + (size_t)t * cells;
    for (int c = tid; c < cells; c += nt) {
      const int s = c / D, d = c - s * D;
      float v;
      int from;
      if (d == 0) {
        float best = neg_inf();
        int src = 0;
        const int f = flags[s];
        if ((f & 3) == 1) {  // an entry: the best exit sum of all warps
          int xi = INT_MAX;
          for (int k = 0; k < nw; ++k) {
            if (better(red_v[k], red_i[k], best, xi)) {
              best = red_v[k];
              xi = red_i[k];
            }
          }
          src = xi == INT_MAX ? 0 : xi;
        } else if (f & 1) {  // an entry that is an exit: every other exit
          for (int k = 0; k < n_exit; ++k) {
            const int x = a.exits[k];
            if (x == s) continue;
            const float u = bc_val[x] + a.penalty;
            if (u > best) {
              best = u;
              src = x;
            }
          }
        } else {
          if (s >= 2) {
            const float u = bc_val[s - 2] + m2[s];
            if (u > best) {
              best = u;
              src = s - 2;
            }
          }
          if (s >= 1) {
            const float u = bc_val[s - 1] + m1[s];
            if (u > best) {
              best = u;
              src = s - 1;
            }
          }
        }
        v = best;
        from = src * D + bc_d[src];
      } else {
        const float prev = cur[c - 1];
        float sh = prev;
        from = c - 1;
        if (d == D - 1 && (flags[s] & 4)) {
          const float sat = cur[c];
          sh = fmaxf(prev, sat);
          if (sat > prev) from = c;
        }
        v = d + 1 <= max_dur[s] ? sh + diag[s] : neg_inf();
      }
      nxt[c] = v + lb[s];
      bp[c] = from;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // The best complete exit cell.
  float bv = neg_inf();
  int bi = INT_MAX;
  for (int k = tid; k < n_exit * D; k += nt) {
    const int x = a.exits[k / D], d = k % D;
    if (d + 1 < min_dur[x]) continue;
    const int cell = x * D + d;
    const float v = cur[cell];
    if (better(v, cell, bv, bi)) {
      bv = v;
      bi = cell;
    }
  }
  block_best(bv, bi, red_v, red_i);
  if (bi == INT_MAX) bi = 0;
  if (tid == 0) {
    a.scores[b] = bv;
    a.start[b] = bi;
    if (a.path != nullptr) walk(bps_b, cells, a.T, length, bi, a.quirk, a.path + (size_t)b * a.T);
  }
}

// ---------------------------------------------------------------------------
// The team kernels: each lane holds K contiguous states of one plane (PLANES)
// or K states with their D slots (DURATION) in registers for the whole time
// loop; one barrier a step; one byte a (step, cell) walked in the kernel.

constexpr int PLANES_MAX_G = 64;     // a cross code's 6 bits name the source plane
constexpr int CLUSTER_MAX = 8;       // portable cluster size
constexpr int CODE_MAX_STATES = 32767;  // int16 best-exit indices (PLANES)
constexpr int DURATION_MAX_SLOTS = 8;   // D in registers (or shared slots) up to 8

enum Branch { TEAM = 0, CLUSTER = 1, SIMPLE = 2 };

// The widest row of codes (bytes a step) whose walk stages tiles in shared
// memory when the codes are in global memory: timed on an H100 80GB HBM3
// at 700 W, staging won at rows of 1,216 (PLANES) and 3,072 / 4,096 bytes
// (DURATION) and lost at 2,560 and 15,360 (PLANES) and 10,240 (DURATION),
// where the walk read its codes in place at L1 / L2 latency.
constexpr size_t PLANES_STAGE_MAX_ROW = 2048;
constexpr size_t DURATION_STAGE_MAX_ROW = 4096;

// States a lane: 2 (S <= 64), 4 (S <= 2048) or 8, as K2's team kernel.
__host__ __device__ constexpr int lane_states(int S) { return S <= 64 ? 2 : (S <= 2048 ? 4 : 8); }
// DURATION's states a lane: K = 4 only up to 1,024 states (8 warps, so a
// thread may hold its 4 x 8 slots in up to 255 registers), then K = 8.
__host__ __device__ constexpr int duration_lane_states(int S) {
  return S <= 64 ? 2 : (S <= 1024 ? 4 : 8);
}
// A CTA's most warps: 20 at K = 8 (640 threads, so ptxas may give a thread 96
// registers), else 32 (PLANES) / 8 (DURATION's K = 4, above).
__host__ __device__ constexpr int planes_max_warps(int k) { return k == 8 ? 20 : 32; }
__host__ __device__ constexpr int duration_max_warps(int k) {
  return k == 8 ? 20 : (k == 4 ? 8 : 1);
}
// Emission rows a lane holds in flight, K registers each: at >= 0.3 µs a
// step, four rows (two past K = 2) cover a load's latency.
__host__ __device__ constexpr int ahead_rows(int k) { return k == 2 ? 4 : 2; }
// DURATION's slots a state (D rounded up to 2, 4, 6 or 8), and where they live:
// registers up to K * DM = 16 at K = 8 and 32 below; shared memory past it.
__host__ __device__ constexpr int slot_pitch(int d) {
  return d <= 2 ? 2 : (d <= 4 ? 4 : (d <= 6 ? 6 : 8));
}
__host__ __device__ constexpr bool slots_shared(int k, int dm) { return k == 8 && dm >= 4; }
// The exits' reduction: PLANES takes redux keys (KEY) at a non-zero penalty;
// DURATION the best two (TWO) where an entry is also an exit or the penalty
// is zero, else the key path.
constexpr bool planes_key(float penalty) { return penalty != 0.f; }
constexpr bool duration_two(bool entry_exit, float penalty) {
  return entry_exit || penalty == 0.f;
}

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// f(integral_constant<int, D>) for D = 0 .. N-1, unrolled by the compiler
// whatever f's size (the time loops below index registers by D).
template <int D, int N, typename F>
__device__ __forceinline__ void static_for(F& f) {
  if constexpr (D < N) {
    f(std::integral_constant<int, D>{});
    static_for<D + 1, N>(f);
  }
}

// The time loop of a team kernel: step(t, row t's emissions) for t = 1 ..
// steps - 1, the rows DP steps ahead in pf (pf[d] holds rows 1 + d, 1 + d +
// DP, ...), each slot refilled right after its step.
template <int DP, int K, typename Step, typename Fetch>
__device__ __forceinline__ void time_loop(int steps, float (&pf)[DP][K], Step& step,
                                          Fetch& fetch) {
  for (int t0 = 1; t0 < steps; t0 += DP) {
    auto one = [&](auto dc) {
      constexpr int d = decltype(dc)::value;
      const int t = t0 + d;
      if (t < steps) {
        step(t, pf[d]);
        fetch(pf[d]);  // row t + DP
      }
    };
    static_for<0, DP>(one);
  }
}

// Order-preserving keys of floats: unsigned order is float order, -0
// folding into +0 (x + 0.0f), so one redux.sync takes a max.
__device__ __forceinline__ unsigned okey(float x) {
  const unsigned u = __float_as_uint(x + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unkey(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// K bytes (K = 2, 4, 8), byte k from bits 8k of packed, at an aligned dst.
template <int K>
__device__ __forceinline__ void store_codes(unsigned char* dst, unsigned long long packed) {
  if (K == 2) *(unsigned short*)dst = (unsigned short)packed;
  if (K == 4) *(unsigned*)dst = (unsigned)packed;
  if (K == 8) *(unsigned long long*)dst = packed;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The walk of K2-bt's semantics and quirk over one utterance's codes, by the
// nthr threads of its team (thread tt; sync() their barrier): path[t] gets
// state_of(cell) for t >= 1 down from steps - 1, stepping back with
// prev(t, cell, row t's codes); path[0] the first cell's; entries past the
// length the start's; the quirk sets path[L-1] = path[L-2]. Thread 0 walks.
// With stage (codes in global memory, R rows of row bytes of shared memory)
// the team first copies each tile of R rows into it by cp.async, so the
// walk's dependent loads are shared-memory ones; without it the walk reads
// the codes where they are.
template <typename Prev, typename StateOf, typename Sync>
__device__ void walk_codes(int* p, int T, int length, int steps, int start, int quirk,
                           const unsigned char* codes, size_t row, unsigned char* stage, int R,
                           int tt, int nthr, Sync sync, Prev prev, StateOf state_of) {
  const int s0 = state_of(start);
  for (int t = max(length, 1) + tt; t < T; t += nthr) p[t] = s0;
  const int second = min(max(length - 2, 0), T - 1);
  int cell = start;
  int at_second = s0;
  auto visit = [&](int t, const unsigned char* r) {
    const int s = state_of(cell);
    p[t] = s;
    if (t == second) at_second = s;
    cell = prev(t, cell, r);
  };
  if (stage == nullptr) {
    if (tt == 0)
      for (int t = steps - 1; t >= 1; --t) visit(t, codes + (size_t)t * row);
  } else {
    for (int top = steps - 1; top >= 1; top -= R) {
      const int lo = max(top - R + 1, 1);
      // cp.async: every thread's copies in flight at once (a load and a
      // store a chunk held one load in flight a thread and ran slower than
      // the unstaged walk).
      const unsigned char* src = codes + (size_t)lo * row;
      const int n16 = (int)((size_t)(top - lo + 1) * row / 16);
      for (int i = tt; i < n16; i += nthr) cp_async16(stage + 16 * (size_t)i, src + 16 * (size_t)i);
      cp_async_commit();
      cp_async_wait_all();
      sync();
      if (tt == 0)
        for (int t = top; t >= lo; --t) visit(t, stage + (size_t)(t - lo) * row);
      sync();
    }
  }
  if (tt != 0) return;
  const int s = state_of(cell);
  p[0] = s;
  if (second == 0) at_second = s;
  const int last = max(length - 1, 0);
  if (quirk && last < T) p[last] = at_second;
}

// The launch plan of PLANES at (T, S, G), fixed by the shape alone.
struct PlanesPlan {
  int branch;      // TEAM (one CTA an utterance), CLUSTER (c CTAs), SIMPLE (PR-19 kernel)
  int k, wp;       // states a lane, warps a plane
  int pc, c;       // planes a CTA, CTAs an utterance
  int threads;     // 32 * pc * wp
  int sp;          // code bytes a plane a step: 32 * k * wp
  int codes_smem;  // codes and best exits in shared memory (TEAM only)
  int stage_rows;  // else: rows of codes the walk stages at a time (0: none)
  size_t off_red_i, off_bnd, off_flags, off_codes, bex_off;
  size_t utt_bytes;  // an utterance's codes and best exits
  size_t smem;       // dynamic shared memory a CTA
};

PlanesPlan planes_plan(int T, int S, int G) {
  PlanesPlan pl = {};
  pl.k = lane_states(S);
  pl.wp = (S + 32 * pl.k - 1) / (32 * pl.k);
  const int mw = planes_max_warps(pl.k);
  pl.branch = SIMPLE;
  if (G < 1 || G > PLANES_MAX_G || S > CODE_MAX_STATES || pl.wp > mw) return pl;
  pl.c = (G + mw / pl.wp - 1) / (mw / pl.wp);
  if (pl.c > CLUSTER_MAX) return pl;
  pl.pc = (G + pl.c - 1) / pl.c;  // even out the CTAs
  pl.branch = pl.c == 1 ? TEAM : CLUSTER;
  pl.threads = 32 * pl.pc * pl.wp;
  pl.sp = 32 * pl.k * pl.wp;
  const size_t parts = 2 * (size_t)pl.c * pl.pc * pl.wp;  // (parity, plane, warp)
  pl.off_red_i = align16(parts * 4);
  pl.off_bnd = pl.off_red_i + align16(parts * 4);
  pl.off_flags = pl.off_bnd + align16((size_t)2 * (pl.threads / 32) * 8);
  pl.off_codes = pl.off_flags + align16((size_t)S);
  pl.bex_off = align16((size_t)T * G * pl.sp);
  pl.utt_bytes = pl.bex_off + align16((size_t)T * G * 2);
  pl.codes_smem = pl.c == 1 && pl.off_codes + pl.utt_bytes <= WS_SMEM_BUDGET;
  const size_t row = (size_t)G * pl.sp;
  const bool stage = !pl.codes_smem && row <= PLANES_STAGE_MAX_ROW &&
                     pl.off_codes + row <= WS_SMEM_BUDGET;
  pl.stage_rows = stage ? (int)min((size_t)T, (WS_SMEM_BUDGET - pl.off_codes) / row) : 0;
  pl.smem = pl.off_codes + (pl.codes_smem ? pl.utt_bytes : (size_t)pl.stage_rows * row);
  return pl;
}

struct PlanesTeamArgs {
  const float* log_b;
  const int* lengths;
  const float* ftab;   // (4, S): c2, c1, c0, a0
  const int* itab;     // (2, S): word (-1 off the entries), seed plane
  const int* exits;
  const int* route_off;
  const int* route_src;
  const int* accept;
  float penalty;
  int T, S, ld, G, W, n_exit;
  float* scores;
  int* paths;          // (B, T) states
  int quirk;
  unsigned char* codes_g;  // (B, utt_bytes) where the codes are not in shared memory
  PlanesPlan pl;
};

// One utterance on c CTAs (a cluster past one), each CTA pc planes of wp
// warps. A step: each warp's best exit (value, lowest index) and its lane-31
// boundary states go to shared memory (to every CTA's, through distributed
// shared memory, in a cluster); ONE barrier (__syncwarp, the block's, or the
// cluster's); then each lane forms its stay move from its registers and its
// neighbours, and each entry lane its cross move: over its (plane, word)'s
// source planes in ascending order (the lowest a byte in registers; the
// rest, if any, from the routing row), the best exit of each source folded
// from that plane's warps' partials, a strict > keeping the lowest plane;
// the max on raw alpha, the penalty after it; the exit wins a tie. KEY: a
// non-zero penalty (the exits by redux keys).
// The walk: code c in {0, 1, 2} is the stay from j - c, 3 | g' << 2 the
// cross from plane g''s best exit, whose index the step's row of best exits
// (int16 a plane) holds.
template <int K, bool CLUSTERED, bool KEY>
__global__ void __launch_bounds__(32 * planes_max_warps(K), 1)
    planes_team_kernel(const PlanesTeamArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  constexpr int DP = ahead_rows(K);
  // ONE: a plane is one warp (K = 2, S <= 64), no boundary exchange and no
  // fold of a plane's warps.
  constexpr bool ONE = K == 2;
  const float neg = neg_inf();
  const PlanesPlan& pl = a.pl;
  const int C = CLUSTERED ? pl.c : 1;
  const int rank = CLUSTERED ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nw = nt >> 5;
  const int S = a.S, G = a.G, wp = ONE ? 1 : pl.wp, Gp = C * pl.pc;
  const int lp = ONE ? warp : warp / wp, tw = warp - lp * wp;
  const int g = rank * pl.pc + lp;
  const bool real = g < G;
  const int j0 = (tw * 32 + lane) * K;
  float* red_v = (float*)dyn;
  int* red_i = (int*)(dyn + pl.off_red_i);
  float2* bnd = (float2*)(dyn + pl.off_bnd);
  unsigned char* xflag = dyn + pl.off_flags;
  unsigned char* codes = pl.codes_smem ? dyn + pl.off_codes
                                       : a.codes_g + (size_t)b * pl.utt_bytes;
  short* bex = (short*)(codes + pl.bex_off);
  const size_t row = (size_t)G * pl.sp;  // code bytes a step
  // KEY (a non-zero penalty): only the best exit's value feeds the cross
  // move, and -0 against +0 (which an order-preserving key folds) no longer
  // shows after the add; a zero penalty takes better()'s butterfly. A
  // compile-time choice, as every branch a step costs issue slots.

  // The exits as flags, for the prologue.
  for (int i = tid; i < S; i += nt) xflag[i] = 0;
  __syncthreads();
  for (int i = tid; i < a.n_exit; i += nt) xflag[a.exits[i]] = 1;
  __syncthreads();

  const int length = a.lengths[b];
  const int steps = min(max(length, 1), a.T);
  const float* lb_b = a.log_b + (size_t)b * a.T * a.ld;
  float al[K], c2[K], c1[K], c0[K];
  // Each entry's sources, from the routing table before the time loop: its
  // lowest source plane (byte k of g0s), whether it has one (src_m) and
  // whether it has more (multi_m: then the step reads the rest of its
  // routing row, ascending; a grammar's merge, never a count).
  unsigned long long g0s = 0;
  unsigned entry_m = 0, exit_m = 0, in_m = 0, src_m = 0, multi_m = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    al[k] = c2[k] = c1[k] = c0[k] = neg;
    if (real && j < S) {
      in_m |= 1u << k;
      c2[k] = a.ftab[j];
      c1[k] = a.ftab[S + j];
      c0[k] = a.ftab[2 * S + j];
      const int w = a.itab[j];
      if (w >= 0) {
        entry_m |= 1u << k;
        const int p = g * a.W + w;
        const int q0 = a.route_off[p], n = a.route_off[p + 1] - q0;
        if (n > 0) {
          src_m |= 1u << k;
          g0s |= (unsigned long long)a.route_src[q0] << (8 * k);
        }
        if (n > 1) multi_m |= 1u << k;
      }
      if (xflag[j]) exit_m |= 1u << k;
      if (a.itab[S + j] == g) al[k] = lb_b[j] + a.ftab[3 * S + j];
    }
  }
  // Emission rows DP steps ahead (fetch takes rows 1, 2, ... in order).
  float pf[DP][K];
  const float* next_row = lb_b + a.ld + j0;
  int next_r = 1;
  auto fetch = [&](float* dst) {
    if (next_r < steps) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if ((in_m >> k) & 1u) dst[k] = __ldg(next_row + k);
    }
    next_row += a.ld;
    ++next_r;
  };
#pragma unroll
  for (int d = 0; d < DP; ++d) {
#pragma unroll
    for (int k = 0; k < K; ++k) pf[d][k] = 0.f;
    fetch(pf[d]);
  }
  if (CLUSTERED) cg::this_cluster().sync();  // every CTA running before remote stores

  // The key path's two halves: the max by one redux.sync over
  // order-preserving keys, then the lowest exit holding it by a second.
  auto exit_value = [&]() {
    float ve = neg;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((exit_m >> k) & 1u) ve = fmaxf(ve, al[k]);
    return unkey(__reduce_max_sync(FULL, okey(ve)));
  };
  auto exit_index = [&](float bv) {
    unsigned cand = INT_MAX;
#pragma unroll
    for (int k = K - 1; k >= 0; --k)
      if (((exit_m >> k) & 1u) && al[k] == bv) cand = j0 + k;
    return (int)__reduce_min_sync(FULL, cand);
  };
  // This warp's best exit over alpha: (value, lowest index), every lane.
  auto exit_partial = [&](float& bv, int& bi, auto keyed) {
    if constexpr (decltype(keyed)::value) {
      bv = exit_value();
      bi = exit_index(bv);
      return;
    }
    bv = neg;
    bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (((exit_m >> k) & 1u) && better(al[k], j0 + k, bv, bi)) {
        bv = al[k];
        bi = j0 + k;
      }
    }
    warp_best(bv, bi);
  };
  // This warp's partial into slot (parity, g, tw) of every CTA's buffers
  // (the index too unless with_index is false).
  auto publish = [&](int par, float bv, int bi, bool with_index) {
    const int idx = (par * Gp + g) * wp + tw;
    if constexpr (CLUSTERED) {
      if (lane < C) {
        cg::cluster_group cl = cg::this_cluster();
        cl.map_shared_rank(red_v, lane)[idx] = bv;
        if (with_index) cl.map_shared_rank(red_i, lane)[idx] = bi;
      }
    } else if (lane == 0) {
      red_v[idx] = bv;
      if (with_index) red_i[idx] = bi;
    }
  };
  auto sync = [&]() {
    if constexpr (CLUSTERED) {
      cg::this_cluster().sync();
    } else if (nw > 1) {
      __syncthreads();
    } else {
      __syncwarp();
    }
  };
  // Plane g2's best exit at parity par: its warps' partials by better()
  // (a loop the compiler may not unroll: copied into every step of the
  // time loop, an unrolled fold overflowed the instruction cache).
  auto plane_best = [&](int par, int g2, float& v, int& i) {
    const float* rv = red_v + (size_t)(par * Gp + g2) * wp;
    const int* ri = red_i + (size_t)(par * Gp + g2) * wp;
    v = rv[0];
    i = ri[0];
    if constexpr (!ONE) {
#pragma unroll 1
      for (int q = 1; q < wp; ++q) {
        if (better(rv[q], ri[q], v, i)) {
          v = rv[q];
          i = ri[q];
        }
      }
    }
  };

  unsigned char* code_at = codes + row + (size_t)g * pl.sp + j0;  // row t = 1
  short* bex_at = bex + G;  // row t = 1
  auto step = [&](int t, const float* lbv) {
    const int par = t & 1;
    // LATE: one warp a plane at a non-zero penalty, where the exit's index
    // feeds only the walk's row of best exits: it is reduced after the
    // barrier, and only the value is published before it.
    constexpr bool LATE = ONE && KEY;
    float bv;
    int bi = 0;
    if constexpr (LATE) {
      bv = exit_value();
    } else {
      exit_partial(bv, bi, std::integral_constant<bool, KEY>{});
    }
    float u1 = __shfl_up_sync(FULL, al[K - 1], 1);
    float u2 = __shfl_up_sync(FULL, al[K - 2], 1);
    if (!ONE && wp > 1 && lane == 31) bnd[par * nw + warp] = make_float2(al[K - 1], al[K - 2]);
    publish(par, bv, bi, !LATE);
    if (!LATE && (ONE || wp == 1) && lane == 0 && real) bex_at[g] = (short)(bv > neg ? bi : 0);
    sync();
    if constexpr (LATE) {
      bi = exit_index(bv);
      if (lane == 0 && real) bex_at[g] = (short)(bv > neg ? bi : 0);
    }
    if (lane == 0) {
      u1 = u2 = neg;
      if (!ONE && tw > 0) {
        const float2 q = bnd[par * nw + warp - 1];
        u1 = q.x;
        u2 = q.y;
      }
    }
    // Past one warp a plane: lane l folds plane l's (and l + 32's) warp
    // partials once, and each state reads its lowest source plane's by a
    // shuffle (one fold a step, not one a state).
    // The first warp of the utterance stores the step's best exits.
    float pb_lo = neg, pb_hi = neg;
    if constexpr (!ONE) {
      int i_lo = 0, i_hi = 0;
      if (lane < G) plane_best(par, lane, pb_lo, i_lo);
      if (lane + 32 < G) plane_best(par, lane + 32, pb_hi, i_hi);
      if (wp > 1 && rank == 0 && warp == 0) {
        if (lane < G) bex_at[lane] = (short)(pb_lo > neg ? i_lo : 0);
        if (lane + 32 < G) bex_at[lane + 32] = (short)(pb_hi > neg ? i_hi : 0);
      }
    }
    float na[K];
    unsigned long long packed = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float a0 = al[k];
      const float a1 = k >= 1 ? al[k - 1] : u1;
      const float a2 = k >= 2 ? al[k - 2] : (k == 1 ? u1 : u2);
      // The stay: j - 2, j - 1, j, a strict > from -inf (the first max).
      const float v2 = a2 + c2[k];
      const float v1 = a1 + c1[k];
      const float v0 = a0 + c0[k];
      const bool t2 = v2 > neg;
      float stay = t2 ? v2 : neg;
      unsigned code = t2 ? 2u : 0u;
      const bool t1 = v1 > stay;
      stay = t1 ? v1 : stay;
      code = t1 ? 1u : code;
      const bool t0 = v0 > stay;
      stay = t0 ? v0 : stay;
      code = t0 ? 0u : code;
      // The cross move, for every state without a branch (a non-entry's is
      // dropped): the lowest source plane, then any others in ascending
      // order (a strict > keeps the lowest); the max on raw alpha, the
      // penalty after it.
      const int g0 = (int)((g0s >> (8 * k)) & 0xff);
      float best;
      if constexpr (ONE) {
        int i;
        plane_best(par, g0, best, i);
      } else {
        const float lo = __shfl_sync(FULL, pb_lo, g0 & 31);
        const float hi = G > 32 ? __shfl_sync(FULL, pb_hi, g0 & 31) : neg;
        best = g0 < 32 ? lo : hi;
      }
      best = ((src_m >> k) & 1u) ? best : neg;
      int src = g0;
      if ((multi_m >> k) & 1u) {
        const int p = g * a.W + __ldg(a.itab + j0 + k);
        const int q1 = __ldg(a.route_off + p + 1);
#pragma unroll 1
        for (int q = __ldg(a.route_off + p) + 1; q < q1; ++q) {
          const int g2 = __ldg(a.route_src + q);
          float v;
          int i;
          plane_best(par, g2, v, i);
          if (v > best) {
            best = v;
            src = g2;
          }
        }
      }
      const float cross = best + a.penalty;
      const bool entry = (entry_m >> k) & 1u;
      code = entry && cross >= stay ? 3u | ((unsigned)src << 2) : code;
      const float m = entry ? fmaxf(stay, cross) : stay;
      na[k] = ((in_m >> k) & 1u) ? m + lbv[k] : neg;
      packed |= (unsigned long long)code << (8 * k);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) al[k] = na[k];
    if (real) store_codes<K>(code_at, packed);
    code_at += row;
    bex_at += G;
  };

  time_loop(steps, pf, step, fetch);

  // The final: every plane's best exit (better()'s butterfly), then the
  // best accepted exit cell.
  {
    float bv;
    int bi;
    exit_partial(bv, bi, std::false_type{});
    publish(steps & 1, bv, bi, true);
    sync();
  }
  if (rank != 0) return;
  // The best accepted exit cell (thread 0), then the walk by this CTA.
  // Cells are (plane, state) pairs, g << 16 | j.
  int* start_s = (int*)(dyn + pl.off_flags);
  if (tid == 0) {
    float bv = neg;
    int cell = INT_MAX, start = 0;
    for (int g2 = 0; g2 < G; ++g2) {
      if (!a.accept[g2]) continue;
      float v;
      int i;
      plane_best(steps & 1, g2, v, i);
      if (i != INT_MAX && better(v, g2 * S + i, bv, cell)) {
        bv = v;
        cell = g2 * S + i;
        start = g2 << 16 | i;
      }
    }
    a.scores[b] = bv;
    *start_s = start;
  }
  __syncthreads();
  const int start = *start_s;
  walk_codes(
      a.paths + (size_t)b * a.T, a.T, length, steps, start, a.quirk, codes, row,
      pl.stage_rows ? dyn + pl.off_codes : nullptr, pl.stage_rows, tid, nt,
      [&]() { __syncthreads(); },
      [&](int t, int c, const unsigned char* r) {
        const int g2 = c >> 16, j = c & 0xffff;
        const unsigned code = r[(size_t)g2 * pl.sp + j];
        if ((code & 3u) == 3u) {
          const int src = (int)(code >> 2);
          return src << 16 | (int)bex[(size_t)t * G + src];
        }
        return g2 << 16 | max(j - (int)(code & 3u), 0);
      },
      [&](int c) { return c & 0xffff; });
}

// The launch plan of DURATION at (T, S, D).
struct DurationPlan {
  int branch;      // TEAM or SIMPLE
  int k, dm, w;    // states a lane, slot pitch, warps a team
  int u;           // teams (utterances) a block: 4 one-warp teams, else 1
  int row;         // code bytes a step: 32 * w * k * dm
  int codes_smem;
  int stage_rows;  // codes in global memory: rows the walk stages at a time (0: none)
  size_t bex_off, utt_bytes, off_slots, smem;
};

DurationPlan duration_plan(int T, int S, int D) {
  DurationPlan pl = {};
  pl.k = duration_lane_states(S);
  pl.w = (S + 32 * pl.k - 1) / (32 * pl.k);
  pl.branch = SIMPLE;
  if (D < 1 || D > DURATION_MAX_SLOTS || pl.w > duration_max_warps(pl.k)) return pl;
  pl.branch = TEAM;
  pl.dm = slot_pitch(D);
  pl.row = 32 * pl.w * pl.k * pl.dm;
  pl.bex_off = align16((size_t)T * pl.row);
  pl.utt_bytes = pl.bex_off + align16((size_t)T * 8);
  const size_t slots = slots_shared(pl.k, pl.dm) ? (size_t)pl.k * pl.dm * 32 * pl.w * 4 : 0;
  // The most teams a block whose codes fit in shared memory, else the most
  // teams with the codes in the global scratch.
  pl.u = pl.k == 2 ? 4 : 1;
  pl.codes_smem = 0;
  for (int u = pl.u; u >= 1; u >>= 1) {
    if ((size_t)u * pl.utt_bytes + slots <= WS_SMEM_BUDGET) {
      pl.u = u;
      pl.codes_smem = 1;
      break;
    }
  }
  pl.off_slots = pl.codes_smem ? (size_t)pl.u * pl.utt_bytes : 0;
  pl.smem = pl.off_slots + slots;
  // Past the codes' room the walk stages tiles of rows over the slots (dead
  // by then), each team its own.
  const size_t per_team = WS_SMEM_BUDGET / pl.u;
  const bool stage = !pl.codes_smem && (size_t)pl.row <= DURATION_STAGE_MAX_ROW &&
                     (size_t)pl.row <= per_team;
  pl.stage_rows = stage ? (int)min((size_t)T, per_team / pl.row) : 0;
  if (pl.stage_rows) pl.smem = max(pl.smem, (size_t)pl.u * pl.stage_rows * pl.row);
  return pl;
}

struct DurationTeamArgs {
  const float* log_b;
  const int* lengths;
  const float* ftab;   // (4, S): m2, m1, diag, a0
  const int* itab;     // (3, S): flags, min_dur, max_dur
  float penalty;
  int B, T, S, ld, D;
  float* scores;
  int* paths;
  int quirk;
  unsigned char* codes_g;
  DurationPlan pl;
};

// The best two of (value, cell) pairs under better() (no cell twice).
struct Best2 {
  float v1;
  int c1;
  float v2;
  int c2;
};

template <bool TWO>
__device__ __forceinline__ void take(Best2& a, float v, int c) {
  constexpr bool two = TWO;
  if (better(v, c, a.v1, a.c1)) {
    a.v2 = a.v1;
    a.c2 = a.c1;
    a.v1 = v;
    a.c1 = c;
  } else if (two && better(v, c, a.v2, a.c2)) {
    a.v2 = v;
    a.c2 = c;
  }
}

template <bool TWO>
__device__ __forceinline__ void merge(Best2& a, const Best2& o) {
  constexpr bool two = TWO;
  if (better(o.v1, o.c1, a.v1, a.c1)) {
    if (two) {
      if (better(a.v1, a.c1, o.v2, o.c2)) {
        a.v2 = a.v1;
        a.c2 = a.c1;
      } else {
        a.v2 = o.v2;
        a.c2 = o.c2;
      }
    }
    a.v1 = o.v1;
    a.c1 = o.c1;
  } else if (two && better(o.v1, o.c1, a.v2, a.c2)) {
    a.v2 = o.v1;
    a.c2 = o.c1;
  }
}

template <bool TWO>
__device__ __forceinline__ void warp_best2(Best2& a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best2 o;
    o.v1 = __shfl_xor_sync(FULL, a.v1, off);
    o.c1 = __shfl_xor_sync(FULL, a.c1, off);
    o.v2 = o.c2 = 0;
    if constexpr (TWO) {
      o.v2 = __shfl_xor_sync(FULL, a.v2, off);
      o.c2 = __shfl_xor_sync(FULL, a.c2, off);
    }
    merge<TWO>(a, o);
  }
}

// A team of w warps an utterance (four one-warp teams a block at S <= 64,
// no block barrier); each lane K states, each state its D slots (registers,
// or shared memory past slots_shared). A step: first, inside the lane, each
// state's best completed slot (the lowest d holding the max over d + 1 >=
// min_dur), the stay shift of slots >= 1 (saturating at D - 1 where
// unbounded) with the new row's emission added, and the lane's best exit
// sums (TWO: the best two, where an entry is also an exit or the penalty is
// zero; else the max, the key path); then the warp's reduction, the
// neighbours' best completed values by __shfl_up_sync (the lane-31
// boundary and each warp's partial through shared memory under ONE barrier
// past one warp); then slot 0: an entry takes the team's best exit
// sum (an entry that is an exit the second best where the best is its own),
// a non-entry the advance from j - 2, then j - 1, sums compared, a strict >.
// Codes: at d >= 1, 0 the shift from d - 1, 1 the saturated stay; at d = 0,
// kind | slot << 3 with kind 1 / 2 the advance from j - kind (slot its best
// completed slot), 3 / 4 the step's best / second-best exit cell (two int32
// a step).
template <int K, int DM, bool SLOTS_SMEM, bool TWO>
__global__ void __launch_bounds__(32 * (K == 2 ? 4 : duration_max_warps(K)), 1)
    duration_team_kernel(const DurationTeamArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Best2 red[2][32];
  __shared__ float4 bnd[2][32];
  constexpr int DP = ahead_rows(K);
  constexpr int NW = K * DM / 4;  // code words a lane
  // ONE: one-warp teams (K = 2, S <= 64), four a block, no block barrier.
  constexpr bool ONE = K == 2;
  const float neg = neg_inf();
  const DurationPlan& pl = a.pl;
  const int S = a.S, D = a.D, T = a.T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = ONE ? warp : 0;
  const int tw = ONE ? 0 : warp;
  const int nw = ONE ? 1 : pl.w;
  const int nt = 32 * nw;
  const int tt = tw * 32 + lane;
  const int b = blockIdx.x * pl.u + team;
  if (b >= a.B) return;  // only a one-warp team leaves early: no block barrier
  unsigned char* codes = pl.codes_smem ? dyn + (size_t)team * pl.utt_bytes
                                       : a.codes_g + (size_t)b * pl.utt_bytes;
  int* bex = (int*)(codes + pl.bex_off);
  float* slots_s = (float*)(dyn + pl.off_slots);
  const int j0 = tt * K;
  const int length = a.lengths[b];
  const int steps = min(max(length, 1), T);
  const float* lb_b = a.log_b + (size_t)b * T * a.ld;
  // !TWO, the key path (no entry is an exit and the penalty is not zero):
  // the best exit sum by redux.sync over order-preserving keys; at a
  // non-zero penalty a sum is never -0, so the key's folding of -0 into +0
  // never shows. TWO: better()'s butterfly of the best two (an entry that
  // is an exit takes the second where the best is its own).
  constexpr bool KEY = !TWO;

  float sl[SLOTS_SMEM ? 1 : K][SLOTS_SMEM ? 1 : DM] = {};
  auto ld = [&](int k, int d) -> float {
    if constexpr (SLOTS_SMEM) {
      return slots_s[(size_t)(k * DM + d) * nt + tt];
    } else {
      return sl[k][d];
    }
  };
  auto st = [&](int k, int d, float v) {
    if constexpr (SLOTS_SMEM) {
      slots_s[(size_t)(k * DM + d) * nt + tt] = v;
    } else {
      sl[k][d] = v;
    }
  };
  float m2[K], m1[K], dg[K];
  unsigned entry_m = 0, exit_m = 0;
  // Bit d of msk: slot d is complete (d + 1 >= min_dur); bit 8 + d: slot d
  // saturates (d == D - 1, max_dur unbounded); bit 16 + d: slot d may stay
  // (d + 1 <= max_dur). Bits of slots d >= D are 0: such a slot stays -inf.
  unsigned msk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    m2[k] = m1[k] = dg[k] = neg;
    msk[k] = 0;
    float seed = neg;
    if (j < S) {
      m2[k] = a.ftab[j];
      m1[k] = a.ftab[S + j];
      dg[k] = a.ftab[2 * S + j];
      const int f = a.itab[j], lo = a.itab[S + j], hi = a.itab[2 * S + j];
      entry_m |= (unsigned)(f & 1) << k;
      exit_m |= (unsigned)((f >> 1) & 1) << k;
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        if (d < D && d + 1 >= lo) msk[k] |= 1u << d;
        if (d == D - 1 && (f & 4)) msk[k] |= 1u << (8 + d);
        if (d < D && d + 1 <= hi) msk[k] |= 1u << (16 + d);
      }
      if (f & 1) seed = lb_b[j] + a.ftab[3 * S + j];
    }
#pragma unroll
    for (int d = 0; d < DM; ++d) st(k, d, d == 0 ? seed : neg);
  }
  // Emission rows DP steps ahead (fetch takes rows 1, 2, ... in order).
  float pf[DP][K];
  const float* next_row = lb_b + a.ld + j0;
  int next_r = 1;
  auto fetch = [&](float* dst) {
    if (next_r < steps) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j0 + k < S) dst[k] = __ldg(next_row + k);
    }
    next_row += a.ld;
    ++next_r;
  };
#pragma unroll
  for (int d = 0; d < DP; ++d) {
#pragma unroll
    for (int k = 0; k < K; ++k) pf[d][k] = 0.f;
    fetch(pf[d]);
  }
  auto sync = [&]() {
    if constexpr (ONE) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  };
  // The team's best exit sum(s): each warp's, then past one warp the
  // warps' partials through shared memory under the step's one barrier.
  auto team_best = [&](int par, Best2& top, const float (&e)[K], const int (&cell)[K]) {
    if constexpr (KEY) {
      // top.v1: the lane's best exit sum (fmaxf; the lowest cell follows).
      const float v = unkey(__reduce_max_sync(FULL, okey(top.v1)));
      unsigned cand = INT_MAX;
#pragma unroll
      for (int k = K - 1; k >= 0; --k)
        cand = ((exit_m >> k) & 1u) && e[k] == v ? (unsigned)cell[k] : cand;
      top.c1 = (int)__reduce_min_sync(FULL, cand);
      top.v1 = v;
      if constexpr (!ONE) {
        if (lane == 0) red[par][tw] = top;
        sync();
        const Best2 o = lane < nw ? red[par][lane] : Best2{neg, INT_MAX, neg, INT_MAX};
        const float w = unkey(__reduce_max_sync(FULL, okey(o.v1)));
        top.c1 = (int)__reduce_min_sync(FULL, o.v1 == w ? (unsigned)o.c1 : INT_MAX);
        top.v1 = w;
      }
    } else {
      warp_best2<TWO>(top);
      if constexpr (!ONE) {
        if (lane == 0) red[par][tw] = top;
        sync();
        top = lane < nw ? red[par][lane] : Best2{neg, INT_MAX, neg, INT_MAX};
        warp_best2<TWO>(top);
      }
    }
  };

  unsigned char* code_at = codes + pl.row + (size_t)j0 * DM;  // row t = 1
  int* bex_at = bex + 2;
  auto step = [&](int t, const float* lbv) {
    const int par = t & 1;
    float bc[K], e[K];
    int bcd[K], cell[K];
    unsigned cw[NW];
#pragma unroll
    for (int q = 0; q < NW; ++q) cw[q] = 0;
    Best2 top = {neg, INT_MAX, neg, INT_MAX};
    // Inside the lane: the best completed slot, the stays, the exit sums.
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float o[DM];
#pragma unroll
      for (int d = 0; d < DM; ++d) o[d] = ld(k, d);
      bc[k] = neg;
      bcd[k] = 0;
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        const bool take_d = ((msk[k] >> d) & 1u) && o[d] > bc[k];
        bc[k] = take_d ? o[d] : bc[k];
        bcd[k] = take_d ? d : bcd[k];
      }
#pragma unroll
      for (int d = 1; d < DM; ++d) {
        const bool sat = (msk[k] >> (8 + d)) & 1u;
        const float sh = sat ? fmaxf(o[d - 1], o[d]) : o[d - 1];
        const unsigned code = sat && o[d] > o[d - 1] ? 1u : 0u;
        const float v = ((msk[k] >> (16 + d)) & 1u) ? sh + dg[k] : neg;
        st(k, d, v + lbv[k]);
        cw[(k * DM + d) >> 2] |= code << (8 * ((k * DM + d) & 3));
      }
      e[k] = bc[k] + a.penalty;
      cell[k] = (j0 + k) << 3 | bcd[k];
      if constexpr (KEY) {
        top.v1 = ((exit_m >> k) & 1u) ? fmaxf(top.v1, e[k]) : top.v1;
      } else if ((exit_m >> k) & 1u) {
        take<true>(top, e[k], cell[k]);
      }
    }
    float u1 = __shfl_up_sync(FULL, bc[K - 1], 1);
    float u2 = __shfl_up_sync(FULL, bc[K - 2], 1);
    int ud = __shfl_up_sync(FULL, bcd[K - 1] | (bcd[K - 2] << 8), 1);
    if (!ONE && lane == 31)
      bnd[par][tw] = make_float4(bc[K - 1], bc[K - 2],
                                 __int_as_float(bcd[K - 1] | (bcd[K - 2] << 8)), 0.f);
    team_best(par, top, e, cell);
    if (lane == 0) {
      u1 = u2 = neg;
      ud = 0;
      if (!ONE && tw > 0) {
        const float4 q = bnd[par][tw - 1];
        u1 = q.x;
        u2 = q.y;
        ud = __float_as_int(q.z);
      }
    }
    if (tt == 0) {
      bex_at[0] = top.c1 == INT_MAX ? 0 : top.c1;
      if (TWO) bex_at[1] = top.c2 == INT_MAX ? 0 : top.c2;
    }
    bex_at += 2;
    // After the barrier: slot 0.
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = j0 + k;
      float v;
      unsigned code;
      // Both moves, no branch: an entry takes the exit sum, a non-entry
      // the advance.
      const bool own = TWO && ((exit_m >> k) & 1u) && (top.c1 >> 3) == s;
      const float b2 = k >= 2 ? bc[k - 2] : (k == 1 ? u1 : u2);
      const int d2 = k >= 2 ? bcd[k - 2] : (k == 1 ? ud & 0xff : ud >> 8);
      const float b1 = k >= 1 ? bc[k - 1] : u1;
      const int d1 = k >= 1 ? bcd[k - 1] : ud & 0xff;
      const float x2 = b2 + m2[k];
      const float x1 = b1 + m1[k];
      const bool t2 = x2 > neg;
      v = t2 ? x2 : neg;
      code = t2 ? 2u | ((unsigned)d2 << 3) : 0u;
      const bool t1 = x1 > v;
      v = t1 ? x1 : v;
      code = t1 ? 1u | ((unsigned)d1 << 3) : code;
      const bool entry = (entry_m >> k) & 1u;
      v = entry ? (own ? top.v2 : top.v1) : v;
      code = entry ? (own ? 4u : 3u) : code;
      st(k, 0, v + lbv[k]);
      cw[(k * DM) >> 2] |= code << (8 * ((k * DM) & 3));
    }
    unsigned* dst = (unsigned*)code_at;
    if constexpr (NW % 4 == 0) {
#pragma unroll
      for (int q = 0; q < NW; q += 4)
        *(uint4*)(dst + q) = make_uint4(cw[q], cw[q + 1], cw[q + 2], cw[q + 3]);
    } else if constexpr (NW % 2 == 0) {
#pragma unroll
      for (int q = 0; q < NW; q += 2) *(uint2*)(dst + q) = make_uint2(cw[q], cw[q + 1]);
    } else {
#pragma unroll
      for (int q = 0; q < NW; ++q) dst[q] = cw[q];
    }
    code_at += pl.row;
  };

  time_loop(steps, pf, step, fetch);

  // The final: the best complete exit cell (a sync also publishes the codes).
  Best2 fin = {neg, INT_MAX, neg, INT_MAX};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!((exit_m >> k) & 1u)) continue;
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if ((msk[k] >> d) & 1u) take<false>(fin, ld(k, d), (j0 + k) << 3 | d);
  }
  warp_best2<false>(fin);
  if constexpr (!ONE) {
    if (lane == 0) red[steps & 1][tw] = fin;
    __syncthreads();
    fin = lane < nw ? red[steps & 1][lane] : Best2{neg, INT_MAX, neg, INT_MAX};
    warp_best2<false>(fin);
  } else {
    __syncwarp();
  }
  // Cells are (state, slot) pairs, s << 3 | d (D <= 8; the order of s * D + d).
  const int start = fin.c1 == INT_MAX ? 0 : fin.c1;
  if (tt == 0) a.scores[b] = fin.v1;
  walk_codes(
      a.paths + (size_t)b * T, T, length, steps, start, a.quirk, codes, pl.row,
      pl.stage_rows ? dyn + (size_t)team * pl.stage_rows * pl.row : nullptr, pl.stage_rows,
      tt, nt, sync,
      [&](int t, int c, const unsigned char* r) {
        const int s = c >> 3, d = c & 7;
        const unsigned code = r[(size_t)s * DM + d];
        if (d > 0) return code ? c : c - 1;
        const unsigned kind = code & 7u;
        if (kind == 3u || kind == 4u) return bex[2 * t + (int)kind - 3];
        return max(s - (int)kind, 0) << 3 | (int)(code >> 3);
      },
      [&](int c) { return c >> 3; });
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// Threads a block: a warp per 32 cells, 128 to 1024.
int threads_for(long long cells) {
  long long t = (cells + 31) / 32 * 32;
  return (int)(t < 128 ? 128 : (t > MAX_THREADS ? MAX_THREADS : t));
}

size_t planes_ws_words(int S, int G, int W) {
  return 2 * (size_t)G * S + 2 * (size_t)G + 2 * (size_t)G * W;
}

size_t duration_ws_words(int S, int D) { return 2 * (size_t)S * D + 2 * (size_t)S; }

long long scratch_bytes(int B, size_t words) {
  return words * 4 <= WS_SMEM_BUDGET ? 0 : (long long)(words * 4) * B;
}


template <int K, bool CLUSTERED, bool KEY>
int launch_planes(const PlanesTeamArgs& a, int B, cudaStream_t stream) {
  const void* fn = (const void*)planes_team_kernel<K, CLUSTERED, KEY>;
  int err = set_smem(fn, a.pl.smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(B * a.pl.c, 1, 1);
  cfg.blockDim = dim3(a.pl.threads, 1, 1);
  cfg.dynamicSmemBytes = a.pl.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.pl.c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTERED ? 1 : 0;
  err = (int)cudaLaunchKernelEx(&cfg, planes_team_kernel<K, CLUSTERED, KEY>, a);
  return err ? err : (int)cudaGetLastError();
}

template <bool CLUSTERED>
int launch_planes_c(const PlanesTeamArgs& a, int B, cudaStream_t s) {
  const bool key = planes_key(a.penalty);
  switch (a.pl.k) {
    case 2: return key ? launch_planes<2, CLUSTERED, true>(a, B, s)
                       : launch_planes<2, CLUSTERED, false>(a, B, s);
    case 4: return key ? launch_planes<4, CLUSTERED, true>(a, B, s)
                       : launch_planes<4, CLUSTERED, false>(a, B, s);
    default: return key ? launch_planes<8, CLUSTERED, true>(a, B, s)
                        : launch_planes<8, CLUSTERED, false>(a, B, s);
  }
}

template <int K, int DM, bool TWO>
int launch_duration(const DurationTeamArgs& a, cudaStream_t stream) {
  constexpr bool SH = slots_shared(K, DM);
  const void* fn = (const void*)duration_team_kernel<K, DM, SH, TWO>;
  const int err = set_smem(fn, a.pl.smem);
  if (err) return err;
  duration_team_kernel<K, DM, SH, TWO><<<(a.B + a.pl.u - 1) / a.pl.u, 32 * a.pl.w * a.pl.u,
                                         a.pl.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int K, bool TWO>
int launch_duration_k(const DurationTeamArgs& a, cudaStream_t stream) {
  switch (a.pl.dm) {
    case 2: return launch_duration<K, 2, TWO>(a, stream);
    case 4: return launch_duration<K, 4, TWO>(a, stream);
    case 6: return launch_duration<K, 6, TWO>(a, stream);
    default: return launch_duration<K, 8, TWO>(a, stream);
  }
}

}  // namespace

// Bytes of global scratch a launch needs (0: none). The team branches keep
// their codes there where they do not fit in shared memory; the simple
// branch its alpha buffers and step tables.
extern "C" long long cs304_trellis_planes_scratch_bytes(int B, int T, int S, int G, int W,
                                                       int simple) {
  const PlanesPlan pl = planes_plan(T, S, G);
  if (simple || pl.branch == SIMPLE) return scratch_bytes(B, planes_ws_words(S, G, W));
  return pl.codes_smem ? 0 : (long long)pl.utt_bytes * B;
}

extern "C" long long cs304_trellis_duration_scratch_bytes(int B, int T, int S, int D,
                                                         int simple) {
  const DurationPlan pl = duration_plan(T, S, D);
  if (simple || pl.branch == SIMPLE) return scratch_bytes(B, duration_ws_words(S, D));
  return pl.codes_smem ? 0 : (long long)pl.utt_bytes * B;
}

// The plan at a shape: out[0] the branch (0 team, 1 cluster, 2 simple),
// out[1] codes in shared memory, out[2] states a lane, out[3] warps a plane
// (PLANES) or a team (DURATION), out[4] CTAs an utterance (PLANES) or
// utterances a block (DURATION), out[5] threads a block, out[6] rows of
// global codes the walk stages at a time (0: none).
extern "C" int cs304_trellis_planes_plan(int T, int S, int G, int* out) {
  const PlanesPlan pl = planes_plan(T, S, G);
  out[0] = pl.branch;
  out[1] = pl.codes_smem;
  out[2] = pl.k;
  out[3] = pl.wp;
  out[4] = pl.c;
  out[5] = pl.threads;
  out[6] = pl.stage_rows;
  return 0;
}

extern "C" int cs304_trellis_duration_plan(int T, int S, int D, int* out) {
  const DurationPlan pl = duration_plan(T, S, D);
  out[0] = pl.branch;
  out[1] = pl.codes_smem;
  out[2] = pl.k;
  out[3] = pl.w;
  out[4] = pl.u;
  out[5] = 32 * pl.w * pl.u;
  out[6] = pl.stage_rows;
  return 0;
}

// The template arguments of the team kernel a launch at this shape takes
// (the plans' and the exits' reductions' choices): PLANES
// planes_team_kernel<out[0] K, out[1] CLUSTERED, out[2] KEY>; DURATION
// duration_team_kernel<out[0] K, out[1] DM, out[2] SLOTS_SMEM, out[3] TWO>
// (entry_exit: some entry state is also an exit). -1: the simple branch.
extern "C" int cs304_trellis_team_instance(int planes, int T, int S, int depth, float penalty,
                                           int entry_exit, int* out) {
  if (planes) {
    const PlanesPlan pl = planes_plan(T, S, depth);
    if (pl.branch == SIMPLE) return -1;
    out[0] = pl.k;
    out[1] = pl.branch == CLUSTER;
    out[2] = planes_key(penalty);
    out[3] = 0;
    return 0;
  }
  const DurationPlan pl = duration_plan(T, S, depth);
  if (pl.branch == SIMPLE) return -1;
  out[0] = pl.k;
  out[1] = pl.dm;
  out[2] = slots_shared(pl.k, pl.dm);
  out[3] = duration_two(entry_exit != 0, penalty);
  return 0;
}

// The team branches: scores and walked paths (states) in one launch.
extern "C" int cs304_trellis_planes_team(
    const void* log_b, const void* lengths, const void* ftab, const void* itab,
    const void* exits, const void* route_off, const void* route_src, const void* accept,
    float penalty, int B, int T, int S, int ld, int G, int W, int n_exit, void* scores,
    void* paths, int quirk, void* scratch, void* stream) {
  PlanesTeamArgs a;
  a.log_b = (const float*)log_b;
  a.lengths = (const int*)lengths;
  a.ftab = (const float*)ftab;
  a.itab = (const int*)itab;
  a.exits = (const int*)exits;
  a.route_off = (const int*)route_off;
  a.route_src = (const int*)route_src;
  a.accept = (const int*)accept;
  a.penalty = penalty;
  a.T = T;
  a.S = S;
  a.ld = ld;
  a.G = G;
  a.W = W;
  a.n_exit = n_exit;
  a.scores = (float*)scores;
  a.paths = (int*)paths;
  a.quirk = quirk;
  a.codes_g = (unsigned char*)scratch;
  a.pl = planes_plan(T, S, G);
  if (a.pl.branch == SIMPLE || (!a.pl.codes_smem && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return a.pl.branch == CLUSTER ? launch_planes_c<true>(a, B, s)
                                : launch_planes_c<false>(a, B, s);
}

// entry_exit: some entry state is also an exit (duration_two).
extern "C" int cs304_trellis_duration_team(
    const void* log_b, const void* lengths, const void* ftab, const void* itab,
    float penalty, int B, int T, int S, int ld, int D, int entry_exit, void* scores,
    void* paths, int quirk, void* scratch, void* stream) {
  DurationTeamArgs a;
  a.log_b = (const float*)log_b;
  a.lengths = (const int*)lengths;
  a.ftab = (const float*)ftab;
  a.itab = (const int*)itab;
  a.penalty = penalty;
  a.B = B;
  a.T = T;
  a.S = S;
  a.ld = ld;
  a.D = D;
  a.scores = (float*)scores;
  a.paths = (int*)paths;
  a.quirk = quirk;
  a.codes_g = (unsigned char*)scratch;
  a.pl = duration_plan(T, S, D);
  if (a.pl.branch == SIMPLE || (!a.pl.codes_smem && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool two = duration_two(entry_exit != 0, penalty);
  switch (a.pl.k) {
    case 2: return two ? launch_duration_k<2, true>(a, s) : launch_duration_k<2, false>(a, s);
    case 4: return two ? launch_duration_k<4, true>(a, s) : launch_duration_k<4, false>(a, s);
    default: return two ? launch_duration_k<8, true>(a, s) : launch_duration_k<8, false>(a, s);
  }
}


extern "C" int cs304_trellis_planes(
    const void* log_b, const void* lengths, const void* ftab, const void* itab,
    const void* exits, const void* route_off, const void* route_src, const void* accept,
    float penalty, int B, int T, int S, int ld, int G, int W, int n_exit, void* scores,
    void* start, void* bps, void* path, int quirk, void* scratch, void* stream) {
  PlanesArgs a;
  a.log_b = (const float*)log_b;
  a.lengths = (const int*)lengths;
  a.ftab = (const float*)ftab;
  a.itab = (const int*)itab;
  a.exits = (const int*)exits;
  a.route_off = (const int*)route_off;
  a.route_src = (const int*)route_src;
  a.accept = (const int*)accept;
  a.penalty = penalty;
  a.T = T;
  a.S = S;
  a.ld = ld;
  a.G = G;
  a.W = W;
  a.n_exit = n_exit;
  a.scores = (float*)scores;
  a.start = (int*)start;
  a.bps = (int*)bps;
  a.path = (int*)path;
  a.quirk = quirk;
  a.scratch = (float*)scratch;
  const size_t words = planes_ws_words(S, G, W);
  a.ws_words = (int)words;
  a.ws_smem = words * 4 <= WS_SMEM_BUDGET;
  if (!a.ws_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = a.ws_smem ? words * 4 : 0;
  const int err = set_smem((const void*)trellis_planes_kernel, smem);
  if (err) return err;
  trellis_planes_kernel<<<B, threads_for((long long)G * S), smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int cs304_trellis_duration(
    const void* log_b, const void* lengths, const void* ftab, const void* itab,
    const void* exits, float penalty, int B, int T, int S, int ld, int D, int n_exit,
    void* scores, void* start, void* bps, void* path, int quirk, void* scratch,
    void* stream) {
  DurationArgs a;
  a.log_b = (const float*)log_b;
  a.lengths = (const int*)lengths;
  a.ftab = (const float*)ftab;
  a.itab = (const int*)itab;
  a.exits = (const int*)exits;
  a.penalty = penalty;
  a.T = T;
  a.S = S;
  a.ld = ld;
  a.D = D;
  a.n_exit = n_exit;
  a.scores = (float*)scores;
  a.start = (int*)start;
  a.bps = (int*)bps;
  a.path = (int*)path;
  a.quirk = quirk;
  a.scratch = (float*)scratch;
  const size_t words = duration_ws_words(S, D);
  a.ws_words = (int)words;
  a.ws_smem = words * 4 <= WS_SMEM_BUDGET;
  if (!a.ws_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = a.ws_smem ? words * 4 : 0;
  const int err = set_smem((const void*)trellis_duration_kernel, smem);
  if (err) return err;
  trellis_duration_kernel<<<B, threads_for((long long)S * D), smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
