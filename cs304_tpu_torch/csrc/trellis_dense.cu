// Dense composite Viterbi forward for Hopper: the (S, S) max-plus trellis.
//
// Replaces cs304_tpu/ops/pallas/trellis.py:_forward_kernel
// (viterbi_forward_pallas). Semantics are bitwise those of the plain PyTorch
// version, cs304_tpu_torch/ops/viterbi.py:dense_forward:
//   t = 0:   alpha = alpha0 (given); backpointer row 0 is -1;
//   t >= 1:  new[j] = max_i (alpha[i] + trans[i, j]) + log_b[b, t, j], the
//            argmax the FIRST i attaining the max, the value that i's own (an
//            all -inf column points at 0);
//   steps t >= length keep alpha but still write backpointers.
//
// What bounds it on this card: a step is a (U x S) . (S x S) max-plus product
// for the U utterances that share trans, S * S adds and compares per
// utterance, and the T - 1 steps of an utterance are dependent. Bytes
// (log_b in, backpointers out, 8 per (t, state) cell) bound it on paper; in
// practice the per-step chain does: with one warp a scheduler (B = 512 on
// 132 SMs) a warp's own dependent adds, maxes and selects over the S
// predecessor rows set the pace of a step (PERF.md §6).
//
// The design. A cluster of C CTAs (C = 1 at small S) carries U utterances;
// CTA rank r owns a slice of SW = 32 * K * W destination columns, and in it a
// team of W warps per utterance, each lane K adjacent columns (and, in the
// CLUSTER branch, 2 row warps that split the predecessor rows and merge
// their partial maxima through shared memory under one named barrier).
// Every CTA holds the full alpha row of its U utterances, double-buffered in
// shared memory, read as broadcast float4 loads; new values go into every
// CTA's other buffer (distributed shared memory past one CTA). One sync a
// step: __syncwarp for a one-warp team, a named barrier for a team of W, one
// cluster barrier past one CTA. trans is shared by the block's utterances:
//   BLOCK    (S <= 240): C = 1, all of trans resident in shared memory, rows
//            padded to a multiple of 4 columns so a lane's K columns of a
//            row are one 8- or 16-byte load;
//   CLUSTER  (S <= 512): C = ceil(S / 64) CTAs, each with its 64-column slice
//            of trans resident for the whole run (S x 64 floats);
//   STREAMED (S > 512):  C = ceil(S / SW) <= 8, each CTA's slice read from L2
//            every step in tiles of R rows through a cp.async double buffer
//            shared by the CTA's U utterances (correct, slow).
// The argmax is the first max, the value that row's own (so -0 / +0 keep the
// first index's sign): resident trans is scanned in groups of four rows
// (scan_groups: the first group holding the max, then its first row holding
// it); streamed tiles as four chains (i mod 4, each a first max on a strict
// >), merged by better(), a lexicographic max of (value, -index) that is
// the first max whatever the tree; row warps merge the same way.
// Emission rows come in D steps ahead of use, into registers. Once
// t >= length alpha is frozen, so every later backpointer row equals the
// first frozen one: it is computed once and stored to the rest. A team (or
// every team of a cluster or of a streamed block, which share barriers) runs
// to the last such step of its utterances and no further; every thread of a
// cluster reaches every cluster barrier, and the kernel ends with one, so no
// CTA exits while a peer may still write into its shared memory. The inputs
// never hold +inf, so no candidate is NaN (padding rows meet an alpha of
// -inf and never win), and there is no NaN handling.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr size_t SMEM_LIMIT = 227 * 1024;  // dynamic shared memory per block
constexpr int MAX_STATES = 8192;
constexpr int CLUSTER_MAX = 8;             // portable cluster size
constexpr int SLICE_COLS = 64;             // CLUSTER: 32 lanes x 2 columns
constexpr size_t TILE_BYTES = 32 * 1024;   // STREAMED: one tile buffer
constexpr int CHAINS = 4;
constexpr int ROW_WARPS = 2;               // CLUSTER: row warps of a team
constexpr int D = 4;                       // emission rows in flight
constexpr int MAX_THREADS = 256;           // with one block an SM: 255 registers

enum Branch { BLOCK = 0, CLUSTER = 1, STREAMED = 2 };

struct DenseArgs {
  const float* log_b;
  const float* trans;
  const float* alpha0;
  const int* lengths;
  float* alpha_out;
  int* bp;
  int B, T, S, ld;
  int c, w, u, sw;   // cluster size, warps per team, teams per CTA, slice width
  int s4;            // S rounded up to 4 (alpha rows and trans rows)
  int tstride;       // resident trans: shared-memory row stride
  int r, ntiles;     // streamed: rows per tile, tiles per step
  int pr, rs;        // row warps per team, rows per row warp
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// K consecutive floats of shared memory, 8- or 16-byte aligned.
template <int K>
__device__ __forceinline__ void load_k(float (&v)[K], const float* src) {
  if constexpr (K == 2) {
    const float2 q = *(const float2*)src;
    v[0] = q.x;
    v[1] = q.y;
  } else {
    const float4 q = *(const float4*)src;
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
}

template <int K>
__device__ __forceinline__ void store_k(float* dst, const float (&v)[K]) {
  if constexpr (K == 2) {
    *(float2*)dst = make_float2(v[0], v[1]);
  } else {
    *(float4*)dst = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int K, bool STREAM>
__global__ void __launch_bounds__(MAX_THREADS, 1) trellis_dense_kernel(const DenseArgs p) {
  extern __shared__ __align__(16) float smem[];
  const float neg = -__int_as_float(0x7f800000);
  const int S = p.S, T = p.T, S4 = p.s4, U = p.u;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tsz = p.w * p.pr;                // warps a team
  const int team = warp / tsz;
  const int wt = warp - team * tsz;
  const int tw = wt % p.w;                   // column warp
  const int rp = wt / p.w;                   // row warp: rows [row0, row0 + nrows)
  const int row0 = rp * p.rs;
  const int nrows = max(min(p.rs, S4 - row0), 0);
  const int nthr = blockDim.x;
  const bool clustered = p.c > 1;
  const int rank = clustered ? (int)cg::this_cluster().block_rank() : 0;
  const int group = blockIdx.x / p.c;  // the cluster (or block) index
  const int b = group * U + team;
  const bool real = b < p.B;

  // alpha: [2][U][S4]; the row warps' partial maxima: [2][U][PR][SW]
  // values and indices; then the resident slice or the tile ring.
  const int PR = p.pr;
  const size_t n_cand = PR > 1 ? (size_t)2 * U * PR * p.sw : 0;
  float* alpha_s = smem;
  float* cand_v = smem + (size_t)2 * U * S4;
  int* cand_i = (int*)(cand_v + n_cand);
  float* tr_s = (float*)(cand_i + n_cand);
  auto abuf = [&](int par) { return alpha_s + (size_t)(par * U + team) * S4; };
  const int col0 = rank * p.sw;
  const int ncols = min(p.sw, S - col0);
  const int jl = (tw * 32 + lane) * K;       // first local column of the lane
  const int j0 = col0 + jl;
  const bool owns = jl < ncols;

  // Stage alpha0 (both buffers' padding -inf) and the resident slice.
  for (int e = threadIdx.x; e < U * S4; e += nthr) {
    const int uu = e / S4, i = e - uu * S4;
    const int bu = group * U + uu;
    alpha_s[e] = (i < S && bu < p.B) ? p.alpha0[(size_t)bu * S + i] : neg;
    alpha_s[U * S4 + e] = neg;
  }
  if constexpr (!STREAM) {
    const int stride = p.tstride;
    for (int e = threadIdx.x; e < S4 * stride; e += nthr) {
      const int i = e / stride, c = e - i * stride;
      tr_s[e] = (i < S && c < ncols) ? p.trans[(size_t)i * S + col0 + c] : neg;
    }
  }

  // The steps this team runs: live steps 1..live_end-1, then the first
  // frozen step (if any). Teams that share barriers run to their group's
  // last such step.
  auto stop_of = [&](int bu) {
    if (bu >= p.B) return 1;
    const int live_end = min(max(p.lengths[bu], 1), T);
    return min(live_end + 1, T);
  };
  const bool shared_loop = clustered || STREAM;
  const int length = real ? p.lengths[b] : 0;
  const int live_end = min(max(length, 1), T);
  const int my_stop = stop_of(b);
  int t_stop = my_stop;
  if (shared_loop) {
    t_stop = 1;
    for (int uu = 0; uu < U; ++uu) t_stop = max(t_stop, stop_of(group * U + uu));
  }

  const float* lb_b = p.log_b + (size_t)(real ? b : 0) * T * p.ld;
  int* bp_b = p.bp + (size_t)(real ? b : 0) * T * S;
  float a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    a[k] = (real && owns && j < S) ? p.alpha0[(size_t)b * S + j] : neg;
    if (real && owns && j < S) bp_b[j] = -1;
  }

  float pf[D][K];
  auto fetch = [&](float* dst, int row) {
    if (real && owns && row < live_end) {
      const float* r = lb_b + (size_t)row * p.ld + j0;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j0 + k < S) dst[k] = __ldg(r + k);
    }
  };
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int k = 0; k < K; ++k) pf[d][k] = 0.f;
    fetch(pf[d], 1 + d);
  }

  // STREAMED: the flat sequence of tiles (step-major) through two buffers.
  const int tile_floats = p.r * p.sw;
  const bool vec16 = (S & 3) == 0 && ((uintptr_t)p.trans & 15) == 0;
  auto issue = [&](long long g) {
    if constexpr (STREAM) {
      const int k = (int)(g % p.ntiles);
      const long long step = g / p.ntiles;
      if (step + 1 < t_stop) {
        const int trow = k * p.r;
        const int rows = min(p.r, S - trow);
        float* dst = tr_s + (size_t)(g & 1) * tile_floats;
        const int per_row = vec16 ? (ncols + 3) / 4 : ncols;
        for (int e = threadIdx.x; e < rows * per_row; e += nthr) {
          const int rr = e / per_row, c = e - rr * per_row;
          const float* src = p.trans + (size_t)(trow + rr) * S + col0;
          if (vec16) {
            cp_async16(dst + rr * p.sw + 4 * c, src + 4 * c);
          } else {
            cp_async4(dst + rr * p.sw + c, src + c);
          }
        }
      }
      cp_async_commit();
    }
  };
  long long g = 0;
  if constexpr (STREAM) {
    issue(0);
    issue(1);
  }

  if (clustered) {
    cg::this_cluster().sync();  // every CTA staged and running
  } else {
    __syncthreads();
  }

  int fb[K];
#pragma unroll
  for (int k = 0; k < K; ++k) fb[k] = 0;
  int cur = 0;

  // Streamed tiles: the chains over rows [0, i_end) of `rows` (row i at
  // rows[i * st], alpha at al[i_base + i]). Software-pipelined: the next
  // four rows are loaded while the current ones are compared; the last
  // group reloads itself.
  auto scan_chains = [&](float (&bv)[CHAINS][K], int (&bi)[CHAINS][K], const float* al,
                  const float* rows, int st, int i_end, int i_base) {
    float4 a4 = *(const float4*)(al + i_base);
    float tv[CHAINS][K];
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) load_k<K>(tv[c], rows + (size_t)c * st + jl);
    for (int i = 0; i < i_end; i += CHAINS) {
      const int in = min(i + CHAINS, i_end - CHAINS);
      const float4 a4n = *(const float4*)(al + i_base + in);
      float tvn[CHAINS][K];
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) load_k<K>(tvn[c], rows + (size_t)(in + c) * st + jl);
      const float av[CHAINS] = {a4.x, a4.y, a4.z, a4.w};
      const unsigned ii = (unsigned)(i_base + i);
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          // Selects, not a branch (a branch per cell diverges and
          // reconverges the warp). The chain's offset c is added at the
          // merge.
          const float v = av[c] + tv[c][k];
          const bool take = v > bv[c][k];
          bv[c][k] = take ? v : bv[c][k];
          bi[c][k] = take ? (int)ii : bi[c][k];
        }
      }
      a4 = a4n;
#pragma unroll
      for (int c = 0; c < CHAINS; ++c)
#pragma unroll
        for (int k = 0; k < K; ++k) tv[c][k] = tvn[c][k];
    }
  };

  // Resident trans: the max over rows [0, i_end) of `rows` by groups of
  // four rows. Each group's max is a tree of fmaxf; the running max takes a
  // group only when it is strictly greater, so gg ends at the first group
  // holding the max: two selects a group and column where the chains take
  // a compare and two selects a cell. fmaxf may return either zero of a
  // -0 / +0 tie, but only compares (which hold them equal) read these
  // values; the winner's own value is recomputed. The next group's rows are
  // loaded while this one is compared; the last group reloads itself.
  auto scan_groups = [&](float (&gv)[K], int (&gg)[K], const float* al, const float* rows,
                         int st, int i_end, int i_base) {
    auto load = [&](float4& a4, float (&tv)[CHAINS][K], int i) {
      a4 = *(const float4*)(al + i_base + i);
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) load_k<K>(tv[c], rows + (size_t)(i + c) * st + jl);
    };
    float4 a4;
    float tv[CHAINS][K];
    load(a4, tv, 0);
    for (int i = 0; i < i_end; i += CHAINS) {
      float4 a4n;
      float tvn[CHAINS][K];
      load(a4n, tvn, min(i + CHAINS, i_end - CHAINS));
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float m4 = fmaxf(fmaxf(a4.x + tv[0][k], a4.y + tv[1][k]),
                               fmaxf(a4.z + tv[2][k], a4.w + tv[3][k]));
        const bool take = m4 > gv[k];
        gv[k] = take ? m4 : gv[k];
        gg[k] = take ? i_base + i : gg[k];
      }
      a4 = a4n;
#pragma unroll
      for (int c = 0; c < CHAINS; ++c)
#pragma unroll
        for (int k = 0; k < K; ++k) tv[c][k] = tvn[c][k];
    }
  };

  auto step = [&](int t, const float* lbv) {
    const bool active = real && t < my_stop;
    const bool live = t < live_end;
    const float* al = abuf(cur);
    float na[K];
    int arg[K];
    if constexpr (!STREAM) {
      const float* rows = tr_s + (size_t)row0 * p.tstride;
      float gv[K];
      int gg[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        gv[k] = na[k] = neg;
        gg[k] = arg[k] = row0;
      }
      if (active && owns && nrows > 0) {
        scan_groups(gv, gg, al, rows, p.tstride, nrows, row0);
        // The first row of the first group holding the max that attains it
        // (zeros compare equal, as in the plain version), and that row's own
        // value.
#pragma unroll
        for (int k = 0; k < K; ++k) {
          int idx = gg[k];
#pragma unroll
          for (int r = CHAINS - 1; r >= 0; --r) {
            const int i = gg[k] + r;
            const float v = al[i] + rows[(size_t)(i - row0) * p.tstride + jl + k];
            idx = v == gv[k] ? i : idx;
          }
          arg[k] = idx;
          na[k] = al[idx] + rows[(size_t)(idx - row0) * p.tstride + jl + k];
        }
      }
      if (!active) return;
    } else {
      float bv[CHAINS][K];
      int bi[CHAINS][K];
#pragma unroll
      for (int c = 0; c < CHAINS; ++c)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          bv[c][k] = neg;
          bi[c][k] = row0;
        }
      for (int k = 0; k < p.ntiles; ++k, ++g) {
        cp_async_wait1();
        __syncthreads();
        const int trow0 = k * p.r;
        if (active && owns)
          scan_chains(bv, bi, al, tr_s + (size_t)(g & 1) * tile_floats, p.sw,
               min(p.r, S4 - trow0), trow0);
        __syncthreads();
        issue(g + 2);
      }
      if (!active) return;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float m = bv[0][k];
        int mi = bi[0][k];
#pragma unroll
        for (int c = 1; c < CHAINS; ++c)
          if (better(bv[c][k], bi[c][k] + c, m, mi)) {
            m = bv[c][k];
            mi = bi[c][k] + c;
          }
        arg[k] = mi;
        na[k] = m;
      }
    }
    if (PR > 1) {
      // The row warps' partial maxima, merged by better() in every row warp
      // (one named barrier; the buffers alternate by step).
      const size_t base = (size_t)((t & 1) * U + team) * PR;
      if (owns) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          cand_v[(base + rp) * p.sw + jl + k] = na[k];
          cand_i[(base + rp) * p.sw + jl + k] = arg[k];
        }
      }
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(32 * tsz) : "memory");
      if (owns) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float m = cand_v[base * p.sw + jl + k];
          int mi = cand_i[base * p.sw + jl + k];
          for (int q = 1; q < PR; ++q) {
            const float v = cand_v[(base + q) * p.sw + jl + k];
            const int vi = cand_i[(base + q) * p.sw + jl + k];
            if (better(v, vi, m, mi)) {
              m = v;
              mi = vi;
            }
          }
          na[k] = m;
          arg[k] = mi;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) na[k] = (j0 + k < S) ? (live ? na[k] + lbv[k] : a[k]) : neg;
    if (owns) {
      int* bp_t = bp_b + (size_t)t * S;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (rp == 0 && j0 + k < S) bp_t[j0 + k] = arg[k];
        if (t == live_end) fb[k] = arg[k];
        a[k] = na[k];
      }
      float* dst = abuf(cur ^ 1) + j0;
      if (clustered) {
        cg::cluster_group cl = cg::this_cluster();
        if (rp == 0)
          for (int q = 0; q < p.c; ++q) store_k<K>(cl.map_shared_rank(dst, q), na);
      } else {
        store_k<K>(dst, na);
      }
    }
  };

  auto sync_step = [&]() {
    if (clustered) {
      cg::this_cluster().sync();
    } else if (STREAM) {
      __syncthreads();
    } else if (PR == 1 && p.w > 1) {
      if (real) asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(32 * p.w) : "memory");
    } else {  // a one-warp team
      __syncwarp();
    }
  };

  for (int t0 = 1; t0 < t_stop; t0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int t = t0 + d;
      if (t >= t_stop) break;
      step(t, pf[d]);
      sync_step();
      cur ^= 1;
      fetch(pf[d], t + D);
    }
  }

  if (real && owns && rp == 0) {
    // The frozen rows after the first: the same backpointers.
    for (int t = live_end + 1; t < T; ++t) {
      int* bp_t = bp_b + (size_t)t * S;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j0 + k < S) bp_t[j0 + k] = fb[k];
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (j0 + k < S) p.alpha_out[(size_t)b * S + j0 + k] = a[k];
  }
  if (clustered) cg::this_cluster().sync();  // no peer still writes here
}

// The launch plan, fixed by (B, S) and the card.
struct DensePlan {
  int branch, k, w, c, u, sw, s4, tstride, r, ntiles, pr, rs, ap;
  size_t smem;
};

size_t plan_smem(const DensePlan& pl) {
  const size_t alpha = (size_t)2 * pl.u * pl.s4 * 4;
  const size_t cand = pl.pr > 1 ? (size_t)2 * pl.u * pl.pr * pl.sw * 8 : 0;
  if (pl.branch == STREAMED) return alpha + cand + (size_t)2 * pl.r * pl.sw * 4;
  return alpha + cand + (size_t)pl.s4 * pl.tstride * 4;
}

int plan_threads(const DensePlan& pl) { return 32 * pl.w * pl.pr * pl.u; }

// Split a one-warp-wide team's predecessor rows over `pr` row warps (at
// least a group of four rows each).
void split_rows(DensePlan& pl, int pr) {
  while (pr > 1 && pl.s4 < 4 * pr) pr /= 2;
  pl.pr = pr;
  pl.rs = ((pl.s4 + pr - 1) / pr + 3) & ~3;
}

// The branch and the per-CTA shape at one team per CTA (u = 1).
DensePlan base_plan(int S) {
  DensePlan pl = {};
  pl.s4 = (S + 3) & ~3;
  pl.u = 1;
  pl.k = S <= 64 ? 2 : 4;
  pl.w = (S + 32 * pl.k - 1) / (32 * pl.k);
  pl.sw = 32 * pl.k * pl.w;
  pl.c = 1;
  pl.tstride = pl.s4;
  pl.branch = BLOCK;
  pl.pr = 1;
  pl.rs = pl.s4;
  if (plan_smem(pl) <= SMEM_LIMIT) return pl;
  if (S <= CLUSTER_MAX * SLICE_COLS) {
    pl.branch = CLUSTER;
    pl.k = 2;
    pl.w = 1;
    pl.sw = SLICE_COLS;
    pl.tstride = SLICE_COLS;
    pl.c = (S + SLICE_COLS - 1) / SLICE_COLS;
    split_rows(pl, ROW_WARPS);
    return pl;
  }
  pl.branch = STREAMED;
  pl.k = 4;
  const int per_cta = (S + CLUSTER_MAX - 1) / CLUSTER_MAX;
  pl.w = (per_cta + 127) / 128;
  pl.sw = 128 * pl.w;
  pl.c = (S + pl.sw - 1) / pl.sw;
  pl.r = (int)(TILE_BYTES / ((size_t)pl.sw * 4)) & ~3;
  if (pl.r < 4) pl.r = 4;
  pl.ntiles = (S + pl.r - 1) / pl.r;
  return pl;
}

template <int K, bool STREAM>
const void* kernel_of() {
  return (const void*)trellis_dense_kernel<K, STREAM>;
}

const void* kernel_for(const DensePlan& pl) {
  if (pl.branch == STREAMED) return kernel_of<4, true>();
  return pl.k == 2 ? kernel_of<2, false>() : kernel_of<4, false>();
}

cudaLaunchConfig_t launch_config(const DensePlan& pl, int B, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  const int groups = (B + pl.u - 1) / pl.u;
  cfg.gridDim = dim3(groups * pl.c, 1, 1);
  cfg.blockDim = dim3(plan_threads(pl), 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = pl.c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.c > 1 ? 1 : 0;
  return cfg;
}

// Teams per CTA: the fewest that let every utterance be resident at once on
// this card (blocks per SM for C = 1, active clusters past that), else the
// most that fit.
int choose_u(DensePlan& pl, int B) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const void* fn = kernel_for(pl);
  DensePlan best = pl;
  bool found = false;
  for (int u = 1; u <= 32; u *= 2) {
    DensePlan cand = pl;
    cand.u = u;
    cand.smem = plan_smem(cand);
    if (cand.smem > SMEM_LIMIT || plan_threads(cand) > MAX_THREADS) break;
    if (cand.branch != STREAMED && cand.w * cand.pr > 1 && u > 15) break;  // bar 1..15
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cand.smem);
    if (err != cudaSuccess) return (int)err;
    long long slots = 0;
    if (cand.c == 1) {
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, plan_threads(cand),
                                                          cand.smem);
      if (err != cudaSuccess) return (int)err;
      slots = (long long)per_sm * sms * u;
    } else {
      cudaLaunchAttribute attr;
      cudaLaunchConfig_t cfg = launch_config(cand, B, nullptr, &attr);
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
      if (err != cudaSuccess) return (int)err;
      slots = (long long)clusters * u;
    }
    if (slots == 0) break;
    best = cand;
    found = true;
    if (slots >= B) break;
  }
  if (!found) return (int)cudaErrorInvalidConfiguration;
  pl = best;
  return 0;
}

}  // namespace

// Which branch the kernel takes at S states: 0 BLOCK, 1 CLUSTER, 2 STREAMED.
extern "C" int cs304_trellis_dense_branch(int S) { return base_plan(S).branch; }

// log_b (B, T, ld >= S) f32; trans (S, S) f32 row-major (from, to);
// alpha0 (B, S) f32; lengths (B,) i32 -> alpha (B, S) f32, bp (B, T, S) i32.
extern "C" int cs304_trellis_dense_forward(
    const void* log_b, const void* trans, const void* alpha0,
    const void* lengths, void* alpha, void* bp, int B, int T, int S, int ld,
    void* stream) {
  if (S < 1 || S > MAX_STATES || ld < S || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  // The plan of the last few (device, B, S): choose_u asks the card's
  // occupancy once per shape.
  struct Entry { int dev, b, s; DensePlan pl; };
  static Entry cache[8];
  static int cached = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  DensePlan pl = base_plan(S);
  bool hit = false;
  for (int i = 0; i < cached && i < 8; ++i) {
    if (cache[i].dev == dev && cache[i].b == B && cache[i].s == S) {
      pl = cache[i].pl;
      hit = true;
    }
  }
  if (!hit) {
    const int err = choose_u(pl, B);
    if (err) return err;
    cache[cached % 8] = Entry{dev, B, S, pl};
    ++cached;
  }
  e = cudaFuncSetAttribute(kernel_for(pl), cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  DenseArgs a;
  a.log_b = (const float*)log_b;
  a.trans = (const float*)trans;
  a.alpha0 = (const float*)alpha0;
  a.lengths = (const int*)lengths;
  a.alpha_out = (float*)alpha;
  a.bp = (int*)bp;
  a.B = B;
  a.T = T;
  a.S = S;
  a.ld = ld;
  a.c = pl.c;
  a.w = pl.w;
  a.u = pl.u;
  a.sw = pl.sw;
  a.s4 = pl.s4;
  a.tstride = pl.tstride;
  a.r = pl.r;
  a.ntiles = pl.ntiles;
  a.pr = pl.pr;
  a.rs = pl.rs;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(pl, B, (cudaStream_t)stream, &attr);
  if (pl.branch == STREAMED) {
    e = cudaLaunchKernelEx(&cfg, trellis_dense_kernel<4, true>, a);
  } else if (pl.k == 2) {
    e = cudaLaunchKernelEx(&cfg, trellis_dense_kernel<2, false>, a);
  } else {
    e = cudaLaunchKernelEx(&cfg, trellis_dense_kernel<4, false>, a);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
