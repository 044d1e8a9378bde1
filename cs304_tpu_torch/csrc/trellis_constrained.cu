// Constrained composite Viterbi for Hopper: the plane-product trellis of
// counted and grammar decoding (PLANES) and the state-duration lattice
// (DURATION), one forward kernel each.
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
// and ops/viterbi_duration.py:viterbi_composite_duration_batch_plain. Both
// kernels are bitwise their plain versions in scores, and in the paths of
// every utterance whose score is finite: at a -inf cell the plain versions'
// argmax points at index 0 and the kernels' somewhere else in range.
//
// PLANES. Cells (g, j), g a plane of the G-state word automaton and j a
// composite state, packed g * S + j. A step t (1 <= t < length):
//   A  each plane's best exit: the max of alpha over the exit states, the
//      lowest exit index holding it (a warp a plane, better()'s order);
//   B  each (destination plane g, word w): the best of those maxima over
//      the source planes g' with next_state[g', w] == g (a host-built table
//      in ascending g'; a strict > keeps the lowest), THEN the penalty
//      added -- the max is taken on raw alpha, as the plain version does;
//   C  each cell: the stay move (j-2, j-1, j on the word's band, an entry's
//      own self-loop only; the first max in that order) against, at an
//      entry, the cross move of its plane and word; the exit wins an exact
//      tie (>=); the value is fmaxf of the two (torch.maximum) plus
//      log_b[t, j]; the backpointer is the packed source cell, int32, into
//      bps (B, T, G * S).
// Three barriers a step. The t = 0 seed: an entry state j in the plane its
// word leads to from plane 0 (seed[j]), log_b[0, j] + a0[j]. The final: the
// best alpha over accepting planes' exit cells, the lowest packed cell.
//
// DURATION. Cells (s, d), d + 1 frames in state s (d saturating at D - 1
// where max_dur is unbounded), packed s * D + d. A step:
//   A  each state's best completed slot: the max of alpha[s, d] over
//      d + 1 >= min_dur[s], the lowest d; and, per warp, the best exit SUM
//      (that max + penalty), the lowest state;
//   C  slot 0 advances: a non-entry j from max(j-2, lower) .. j-1, the sum
//      best_completed + log_a[i, j]; an entry from every exit, the sum
//      best_completed + penalty (the warps' partial bests combined; an
//      entry that is itself an exit scans the other exits). The sums are
//      compared, not the maxima: a + p == b + p can hold where a != b.
//      Slots d >= 1 stay: alpha[s, d-1] (at D - 1 fmaxf with alpha[s, D-1]
//      when unbounded; the backpointer takes D - 1 only on a strict >) +
//      log_a[s, s] where d + 1 <= max_dur[s]; then + log_b[t, s].
// Two barriers a step. The final: the best alpha over exit x, complete d.
//
// State storage: alpha double-buffered, with the step's small tables,
// in dynamic shared memory where they fit in WS_SMEM_BUDGET, else in a
// per-utterance global scratch the wrapper allocates (L2-resident at the
// shapes that need it); the same code runs on either through a generic
// pointer (a barrier orders a block's global writes as it does shared ones).
// Steps t >= length leave alpha as it is: the kernel stops there, and the
// backpointer rows past the length stay unwritten (K2-bt never reads them).
//
// The path. The wrapper walks the backpointers with K2-bt
// (trellis_scanfree.cu), which stages whole rows of cells in shared memory
// and takes rows as wide as its two tile buffers fit in the shared memory
// a block may opt into (29,048 cells on an H100;
// cs304_trellis_backtrace_max_states reports it and the wrapper reads it,
// ops/cuda/trellis_constrained.py:k2bt_max_cells). Past that (5003 states
// with D = 6, for one) the wrapper
// passes `path` and the forward's thread 0 walks the rows in global memory
// itself, with K2-bt's semantics and quirk.
//
// What bounds it on this card: a step depends on the previous one through
// three (two) block barriers and a pass over the cells, so each utterance
// is a latency chain of T steps; the bytes are the live log_b rows read
// once and the int32 backpointers written once (34 MB at B = 64, T = 256,
// 58 states and 8 planes: ~10 us at 3.35 TB/s). One block an utterance
// runs the utterances side by side on the SMs. This is the simple first
// design: no per-warp teams, int32 backpointers in device memory.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

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

}  // namespace

// Bytes of global scratch a launch needs (0: its tables stay in shared
// memory).
extern "C" long long cs304_trellis_planes_scratch_bytes(int B, int S, int G, int W) {
  return scratch_bytes(B, planes_ws_words(S, G, W));
}

extern "C" long long cs304_trellis_duration_scratch_bytes(int B, int S, int D) {
  return scratch_bytes(B, duration_ws_words(S, D));
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
