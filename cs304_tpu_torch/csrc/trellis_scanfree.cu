// Scan-free composite Viterbi for Hopper: one forward kernel in two modes,
// and the backtrace.
//
// Replaces cs304_tpu/ops/pallas/trellis_scanfree.py:_forward_kernel and
// :_backtrace_kernel. Semantics are bitwise those of the plain PyTorch
// version, cs304_tpu_torch/ops/viterbi.py:viterbi_composite_batch_fast
// (forward_fast + first_max + backtrace_batch):
//   non-entry j:  max over (j-2, j-1, j) banded predecessors, ties resolved
//                 skip-2, then skip-1, then self (all on >=);
//   entry e:      max(best exit + penalty, self-loop), an exit winning an
//                 exact tie; among exits the lowest state index wins, and
//                 when every exit is -inf the index is 0;
//   steps t >= length leave alpha unchanged.
//
// trellis_team_kernel<K, MODE> is the forward. A team of W warps owns one
// utterance; each lane holds K contiguous states (alpha and their
// coefficients) in registers for the whole time loop, and reads a state's
// j-1 / j-2 neighbours from its own registers or from the previous lane by
// __shfl_up_sync. At S <= 128 the team is one warp and a block carries up to
// four utterances (one per warp), and a step has no barrier: at a non-zero
// penalty only the best exit's value feeds the next alpha, and it is one
// __reduce_max_sync over an order-preserving key; the lowest index holding
// it (better()'s winner, needed only by stores) is one __reduce_min_sync off
// the chain. Past one warp, or at a zero penalty, the exit is a butterfly of
// (value, index) pairs over __shfl_xor_sync with better(), a lexicographic
// order, so the winner does not depend on the tree's shape; a team of
// several warps exchanges the lane-31 boundary states and per-warp winners
// through shared memory under one named barrier per step. Emission rows
// come in D steps ahead of use, each lane loading its K values into
// registers, so the load latency leaves the step's chain (a shared-memory
// ring filled by cp.async cost more to issue per step than it hid).
//   MODE BACKPOINTERS (trellis_forward): runs all T - 1 steps
//     and writes alpha (B, S) and int32 backpointers (B, T, S), row 0 = -1.
//   MODE DECODE_SHARED / DECODE_GLOBAL (scanfree_decode): stops at each
//     utterance's length, stores one byte per (step, state) -- code c in
//     {0, 1, 2} meaning
//     max(j - c, 0), or 3 meaning "the step's best exit" -- and one int16
//     best-exit index per step, in shared memory where the block's
//     utterances fit (else in a global scratch the wrapper allocates), then
//     takes the final best exit and walks the codes back into the path with
//     the reference quirk. No backpointer tensor reaches device memory.
//
//   LM (scanfree_decode_lm, stream_advance_lm): a bigram LM's entry update,
//     replacing the flat penalty. The entry of word w takes max over source
//     words v of (alpha[uppers[v]] + pair[v, w]), the lowest v attaining it
//     with its own sum (torch's max over a dim; all -inf -> source 0, so
//     uppers[0]). Each step the team publishes its W exit values to shared
//     memory (the neighbours' exchange syncs them); thread w = tt, tt + 32 *
//     warps, ... finds word w's source (lm_scan) and a second sync
//     publishes the per-word values and source states. Where the plan puts
//     the columns on chip (LmTable) the scan is two passes with no
//     compare-and-select carried from one candidate to the next (a max, then
//     an integer min over keys of the candidates equal to it): a one-warp
//     team at W <= 32 (K = 2, the flagship) keeps each lane's pair column in
//     registers for the whole time loop; a decode mode up to K = 4 stages
//     the (W, W) table and uppers into shared memory once a block by
//     cp.async before the time loop where the plan finds room after the
//     codes (which keep their priority). Otherwise the same two passes read
//     the columns through the read-only cache, but a K = 8 team and the
//     K = 4 stream, which have no on-chip branch, read them one source at
//     a time (a strict > in ascending v: two passes, reading each column
//     twice, were slower there). Code 3 then names a per-(step, word)
//     source: the decode mode stores W int16 source states a step (T * W
//     beside the codes; 4.8 KB an utterance at W = 12, T = 201, the global
//     scratch past the shared budget) and the walk reads the one of its
//     state's word (word_of); the stream mode writes the full source state
//     into the ring. Replaces the
//     JAX package's viterbi_composite_batch_fast with pair_penalty
//     (cs304_tpu/ops/viterbi.py:275) and its pool's banded step with lm
//     (cs304_tpu/ops/streaming_batch.py:97 _banded_coeffs, :201 lax.scan);
//     no Pallas kernel of either exists.
//   BEAM (decode modes only): every state below (the team's max of alpha -
//     beam) is -inf after each step and after alpha0; the codes are those
//     computed from the pruned alpha (JAX ops/viterbi.py:369-380). A
//     one-warp team (and every LM + beam build) prunes after the step, one
//     more redux.sync on the chain: there the exit's and the threshold's
//     redux.syncs did not overlap (ptxas gave them one uniform register,
//     PERF.md). Past one warp the prune is deferred (defer): alpha is
//     carried unpruned, the threshold's key rides the exit's shared write
//     and barrier, and the step masks alpha where it reads it, which is
//     bitwise the prune (see the kernel). LM and BEAM combine.
//
//   MODE STREAM (stream_advance): the serving pool's step, with alpha
//     carried in and out. Row r of log_b (R, C, ld) advances slot
//     slot_ids[r] of the pool's alpha (n_slots, S) IN PLACE by its valid[r]
//     frames from absolute frame t[r]: an absolute frame 0 reseeds the row
//     (entry states, backpointer -1), every other frame is the step above;
//     each frame's backpointer row goes to ring[slot, t + i, :] (n_slots,
//     T_max, S) in int8 or int32 (RingT, following the pool's ring_dtype).
//     A row with valid 0 is skipped. Its plain version is
//     ops/streaming_batch.py:_advance_compact with the banded coefficients
//     (the JAX package's lax.scan, cs304_tpu/ops/streaming_batch.py:201;
//     there is no Pallas kernel of it). Rows must name distinct slots. A
//     launch is at most C = 16-32 steps, so its prologue counts: at K = 2
//     and 8 every load goes out before the row's ids return (the
//     coefficients, rows 0..D, then the slot's alpha). At K = 8 (S > 2048,
//     9-32 warps, one SM each) the per-lane layout made every scalar load
//     and store of a step touch 32 sectors and the team spilled at 64
//     registers: its emission rows come into shared memory whole, by
//     consecutive threads (4-byte cp.async, two steps ahead, three slots),
//     and each lane reads its 8 values as two 16-byte loads; its codes and
//     best exits wait in shared memory and reach the ring once, row by row,
//     by consecutive threads (a chunk whose rows do not fit goes in several
//     launches); its exit is the value path's two-level key (each warp's
//     redux.sync key, one barrier, a redux.sync over the warps), the index
//     a step late; and the build for <= 20 warps is bounded at 640 threads,
//     so ptxas may give it 96 registers (no spill; PERF.md). The composite
//     decode mode with its codes in global memory and the backpointer mode
//     take the same rows and bound at K = 8 (rows_in_smem); the decode mode
//     with shared codes keeps that room for its codes.
//
// The same template, with SENT, is the embedded trainer's sentence trellis
// (K3), replacing cs304_tpu/ops/pallas/trellis_banded.py:
// _forward_banded_kernel and its reuse of the backtrace kernel. Its plain
// version is ops/viterbi.py:banded_sentence_forward (+ backtrace_batch from
// max(n_states - 1, 0), models/train_fused.py:_banded_trellis_batch): the
// non-entry step above with per-utterance coefficient rows (pointers with a
// row stride of S, no packing copy), the value the winner's own; no entry or
// exit state, so a step exchanges only the lane-boundary neighbours; t = 0 is
// state 0 alone, log_b[b,0,0] + (isfinite(c0[b,0]) ? c0[b,0] : 0), or
// log_b[b,0,0] + seed[b] where the backpointer mode is given a seed row
// (lattice rescoring's arc scores, ops/rescore.py). Decode
// mode returns the score alpha[final] and the walked path in one launch
// (sentence_decode); backpointer mode gives alpha and bp (sentence_forward).
// The inputs never hold +inf, so no candidate is NaN and no NaN handling is
// needed.
//
// What bounds it on this card: the steps are sequential, so each utterance's
// forward is a chain of dependent shuffles, adds and compares (latency);
// bytes are the live emission rows read once, plus the backpointers written
// once in backpointer mode. The design keeps the chain on registers and
// warp-wide reductions: no barrier at S <= 128, no load on the chain,
// coefficients loaded once.
//
// trellis_backtrace_kernel is K2-bt (the backtrace of K4): one warp
// per utterance stages the backpointer rows it will walk into shared memory
// in tiles of R time steps, walking backwards (16-byte cp.async inside a
// tile, 4-byte at an unaligned head or tail), with the next (earlier) tile
// in flight while lane 0 walks the current one. The dependent chain then
// runs at shared-memory latency rather than L2 latency; the rows are read
// whole (more bytes than the T elements on the path, none dependent). The
// backpointers are int32 or int8 (the serving pool's ring, walked in place
// through a per-utterance stride: ring[:, :T] of a (B, T_max, S) ring); an
// int8 span's ragged ends are staged from the 4-byte words that hold them.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// Dynamic shared memory a block of the forward may take (the card allows
// 227 KB; the rest covers the static exchange buffers).
constexpr size_t SMEM_BUDGET = 200 * 1024;
// The flat stream mode's K = 8 block: one team, its staged codes, best
// exits and emission rows (the card's 227 KB less the static buffers).
constexpr size_t STREAM_SMEM_BUDGET = 224 * 1024;
// Emission row slots of that block (rows two steps ahead of use).
constexpr int STREAM_ROW_SLOTS = 3;
// K2-bt: tiles in flight, the shared memory they may share, and the most
// time steps a tile holds (at least one, whatever S).
constexpr int BT_TILES = 2;
constexpr size_t BT_BUDGET = 48 * 1024;
constexpr int BT_MAX_ROWS = 32;

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy n 4-byte elements starting at src (4-byte aligned) into dst (16-byte
// aligned shared memory) by threads tid of nthr: element i lands at
// dst[span_offset(src) + i]. Chunks wholly inside the span go as 16-byte
// copies; the (at most two) partial chunks at its ends element by element.
// dst must hold n + 8 elements. (K2-bt stages an int8 span as the 4-byte
// words that hold it.)
__device__ __forceinline__ int span_offset(const void* src) {
  return (int)(((uintptr_t)src >> 2) & 3);
}

__device__ __forceinline__ void copy_span(void* dst, const void* src, int n,
                                          int tid, int nthr) {
  const uintptr_t a = (uintptr_t)src;
  const uintptr_t base = a & ~(uintptr_t)15;
  const uintptr_t end = a + 4 * (uintptr_t)n;
  const int nchunks = (int)((end - base + 15) >> 4);
  char* d = (char*)dst;
  for (int c = tid; c < nchunks; c += nthr) {
    const uintptr_t g = base + 16 * (uintptr_t)c;
    if (g >= a && g + 16 <= end) {
      cp_async16(d + 16 * c, (const void*)g);
    } else {
      for (int e = 0; e < 4; ++e) {
        const uintptr_t ge = g + 4 * e;
        if (ge >= a && ge < end) cp_async4(d + 16 * c + 4 * e, (const void*)ge);
      }
    }
  }
}

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Time steps of emissions a lane holds in flight, K registers each.
__host__ __device__ constexpr int prefetch_rows(int k) { return k == 8 ? 2 : (k == 4 ? 4 : 8); }

// The forward's launch plan, fixed by (T, S, mode, W) alone.
struct Plan {
  int k;             // states per lane: 2 (S <= 64), 4 (S <= 2048) or 8
  int w;             // warps per utterance
  int u;             // utterances per block (1 unless w == 1)
  int row_bytes;     // code bytes per step (32 * w * k)
  int codes_shared;  // decode: codes and best exits in shared memory
  size_t codes_off;  // offset of the LM's exchange in a team's shared bytes
  size_t team_bytes;  // dynamic shared memory per utterance
  int lm_table;      // LM: where the pair table is read (LmTable)
  size_t smem;       // dynamic shared memory per block
};

// Where an LM mode reads its (W, W) pair table: each lane's column in
// registers for the whole launch (K = 2, W <= LM_REG_WORDS), staged with
// uppers in shared memory once a block, or through the read-only cache.
enum LmTable { LM_GLOBAL = 0, LM_SHARED = 1, LM_REGISTERS = 2 };

// The LM's widest vocabulary whose pair columns a K = 2 team keeps in
// registers (one word a lane).
constexpr int LM_REG_WORDS = 32;

// W rounded up to whole float4s: the row pitch of the LM's exit values.
__host__ __device__ constexpr int lm_quads(int lm_words) { return (lm_words + 3) & ~3; }

// The LM's exchange, for the step's parity: exit values (2, Wq) (16-byte
// rows, -inf past W), per-word values and source states (2, W) each.
__host__ __device__ constexpr size_t lm_bytes(int lm_words) {
  return lm_words > 0
             ? (((size_t)lm_quads(lm_words) * 8 + (size_t)lm_words * 16 + 15) & ~(size_t)15)
             : 0;
}

// The LM's block-wide tables in shared memory: pair as Wq rows of W floats
// (rows past W at -inf), then uppers (W ints); each a copy_span destination
// (8 elements of slack).
__host__ __device__ constexpr size_t lm_pair_span(int lm_words) {
  return ((size_t)lm_quads(lm_words) * lm_words * 4 + 32 + 15) & ~(size_t)15;
}
__host__ __device__ constexpr size_t lm_table_bytes(int lm_words) {
  return lm_pair_span(lm_words) + (((size_t)lm_words * 4 + 32 + 15) & ~(size_t)15);
}

// lm_words: 0, or W for the LM modes (W best-exit sources a step). The
// codes are placed first, as without the table. A K = 2 team at W <= 32
// keeps its columns in registers (both modes); otherwise a decode mode's
// table follows the codes where the block's teams leave room for it, up to
// K = 4 (a K = 8 team, 64 registers a thread, keeps the cache-read loop).
// The stream mode never stages it: a launch of 16 frames did not repay the
// staging (PERF.md).
Plan make_plan(int T, int S, bool decode, int lm_words = 0) {
  Plan pl;
  pl.k = S <= 64 ? 2 : (S <= 2048 ? 4 : 8);
  pl.w = (S + 32 * pl.k - 1) / (32 * pl.k);
  pl.row_bytes = 32 * pl.w * pl.k;
  const int nb = lm_words > 0 ? lm_words : 1;
  const size_t codes = align16((size_t)T * pl.row_bytes) + align16((size_t)T * nb * 2);
  pl.codes_shared = decode && codes + lm_bytes(lm_words) <= SMEM_BUDGET;
  pl.codes_off = pl.codes_shared ? codes : 0;
  pl.team_bytes = pl.codes_off + lm_bytes(lm_words);
  pl.u = 1;
  if (pl.w == 1) {
    for (int u = 4; u > 1; u >>= 1) {
      if ((size_t)u * pl.team_bytes <= SMEM_BUDGET) {
        pl.u = u;
        break;
      }
    }
  }
  pl.smem = (size_t)pl.u * pl.team_bytes;
  pl.lm_table = LM_GLOBAL;
  if (lm_words > 0 && pl.k == 2 && lm_words <= LM_REG_WORDS) {
    pl.lm_table = LM_REGISTERS;
  } else if (decode && lm_words > 0 && pl.k <= 4 &&
             pl.smem + lm_table_bytes(lm_words) <= SMEM_BUDGET) {
    pl.lm_table = LM_SHARED;
    pl.smem += lm_table_bytes(lm_words);
  }
  return pl;
}

struct TeamArgs {
  const float* log_b;
  const float* coefs;        // composite topology
  const float* c0;           // sentence topology: (B, S) self, prev, skip
  const float* c1;
  const float* c2;
  const int* final_state;    // sentence decode: (B,) start of the walk
  const float* seed;         // sentence backpointer mode: (B,) t = 0 seed, or null
  const int* lengths;
  float penalty;
  float* alpha_out;          // backpointer mode
  int* bp;                   // backpointer mode
  float* scores;             // decode mode
  int* paths;                // decode mode
  unsigned char* codes_g;    // decode mode, codes not in shared memory
  const int* slot_ids;       // stream mode: (R,) slot of each row
  const int* t_start;        // stream mode: (R,) absolute frame of row 0
  int c_rows, t_off;         // flat stream mode: log_b's C, this launch's first frame
  float* alpha_io;           // stream mode: (n_slots, S), updated in place
  void* ring;                // stream mode: (n_slots, t_max, S) RingT
  const float* pair;         // LM: (W, W) pair[v, w] from word v to word w
  const int* word_of;        // LM: (S,) word of each state
  const int* uppers;         // LM: (W,) exit state of each word
  int n_words;               // LM: W
  float beam;                // BEAM
  int n_slots, t_max;
  int B, T, S, ld, quirk;
  int w, u, row_bytes;
  size_t codes_off, team_bytes;
  int lm_table;
};

// coefs rows (each of length S): 0 diag_ne, 1 sub1, 2 sub2, 3 diag_e,
// 4 is_entry (1/0), 5 is_exit (1/0), 6 diag_init, 7 unused.
// At K = 2 (S <= 64) a block is at most four one-warp teams, at K = 4
// (S <= 2048) a team of up to 16 warps, at K = 8 up to 32.
// MODE: backpointer mode, or decode mode with its codes in shared or in
// global memory (a compile-time choice, so that code loads and stores are
// shared-memory instructions where they can be), or stream mode (the
// serving pool's step; B is then the number of rows, T the chunk length C,
// and lengths the rows' valid frame counts).
// SENT: the sentence topology (K3) instead of the composite one: per-utterance
// c0/c1/c2 rows, no entry or exit state (so no exit reduction at all), t = 0
// seeded at state 0 alone, and the walk started from a given final state.
// RingT: the stream mode's ring element, int8_t or int.
// LM: the bigram entry update (decode and stream modes); BEAM: the prune
// (decode modes). WIDE: a flat stream team of K = 8 past STREAM_K8_WARPS
// warps (team_threads).
enum { BACKPOINTERS = 0, DECODE_SHARED = 1, DECODE_GLOBAL = 2, STREAM = 3 };

// The most warps a flat stream team of K = 8 has in its narrow build, whose
// launch bound lets ptxas give a thread 96 registers (64 at 1024 threads,
// where the team spilled; PERF.md, the stream mode's redesign). 20 warps
// hold 5120 states; a wider team takes the WIDE build.
constexpr int STREAM_K8_WARPS = 20;

// The builds whose K = 8 team reads its emission rows from shared memory
// and whose narrow build holds at most STREAM_K8_WARPS warps: the flat
// stream mode, and the composite decode mode with its codes in global
// memory and the backpointer mode (the decode mode with shared codes keeps
// the room for its codes, and the LM and sentence builds theirs).
template <int K, int MODE, bool SENT, bool LM>
__host__ __device__ constexpr bool rows_in_smem() {
  return K == 8 && !SENT && !LM && MODE != DECODE_SHARED;
}

// A block's most threads: four one-warp teams at K = 2, a team of up to 16
// warps at K = 4 and up to 32 at K = 8 (STREAM_K8_WARPS where narrow).
__host__ __device__ constexpr int team_threads(int k, bool narrow) {
  return k == 2 ? 128 : (k == 4 ? 512 : (narrow ? 32 * STREAM_K8_WARPS : 1024));
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

template <int K, int MODE, bool SENT, typename RingT = int, bool LM = false,
          bool BEAM = false, bool WIDE = false>
__global__ void __launch_bounds__(team_threads(K, rows_in_smem<K, MODE, SENT, LM>() && !WIDE))
    trellis_team_kernel(const TeamArgs p) {
  constexpr bool DECODE = MODE == DECODE_SHARED || MODE == DECODE_GLOBAL;
  constexpr bool STREAMS = MODE == STREAM;
  // FLAT: the stream mode at a flat penalty. FAST_PROLOGUE: its prologue
  // issues every load at once (at K = 4 it slowed each step, PERF.md).
  // STAGED: its K = 8 build, whose codes wait in shared memory and reach
  // the ring once, row by row, and whose exit takes the value path past one
  // warp. ROWS: the K = 8 builds whose emission rows come through shared
  // memory (rows_in_smem).
  constexpr bool FLAT = STREAMS && !LM;
  constexpr bool FAST_PROLOGUE = FLAT && K != 4;
  constexpr bool STAGED = FLAT && K == 8;
  constexpr bool ROWS = rows_in_smem<K, MODE, SENT, LM>();
  // DEFER: the builds whose beam's prune leaves the chain past one warp
  // (defer below). A one-warp team keeps it on the chain: there the two
  // keys' redux.syncs went out one after the other (PERF.md); the LM builds
  // keep theirs everywhere.
  constexpr bool DEFER = BEAM && !LM;
  static_assert(!(STREAMS && SENT), "the stream mode runs the composite topology");
  static_assert(!(SENT && (LM || BEAM)), "LM and BEAM run the composite topology");
  static_assert(!BEAM || DECODE, "the beam is a decode mode");
  static_assert(!WIDE || ROWS, "WIDE is a K = 8 build with its rows in shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_v[2][32];
  __shared__ int red_i[2][32];
  __shared__ float2 bnd[2][32];
  __shared__ unsigned red_m[2][32];

  // The LM decode modes and K = 2 LM streams prefetch two rows: at K = 2,
  // eight rows left ptxas spilling a prefetched register right after its
  // load (a synchronous load a step), and at K = 4 four rows took the
  // registers the scan's loads need in flight; the K = 4 stream, 16 frames
  // a launch, ran faster with four (PERF.md, the LM modes' redesign).
  constexpr int D = (LM && (K == 2 || !STREAMS)) ? 2 : prefetch_rows(K);
  const float neg = -__int_as_float(0x7f800000);
  const int S = p.S, T = p.T;
  const bool one_warp = K == 2 || p.w == 1;
  const bool defer = DEFER && !one_warp;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int team = one_warp ? warp : 0;
  const int tw = one_warp ? 0 : warp;  // warp within the team
  const int nt = 32 * p.w;
  const int tt = tw * 32 + lane;       // thread within the team
  const int b = blockIdx.x * p.u + team;
  const int W = p.n_words;
  // LM_SCAN: the builds with a register or shared branch (LmTable), whose
  // entry update is the two-pass scan (lm_scan), on global columns too. The
  // others (K = 8, 64 registers a thread, and the K = 4 stream) always read
  // global columns and compile only the one-pass loop (PERF.md).
  constexpr bool LM_SCAN = LM && (STREAMS ? K == 2 : K <= 4);
  const int lm_table = LM_SCAN ? p.lm_table : LM_GLOBAL;
  // LM_SHARED: the pair table and uppers, staged once a block while every
  // thread of the block is still here.
  unsigned char* const lm_tab = smem + (size_t)p.u * p.team_bytes;
  const float* const lm_pair_s = (const float*)lm_tab + span_offset(p.pair);
  const int* const lm_up_s = (const int*)(lm_tab + lm_pair_span(W)) + span_offset(p.uppers);
  if (lm_table == LM_SHARED) {
    copy_span(lm_tab, p.pair, W * W, threadIdx.x, blockDim.x);
    copy_span(lm_tab + lm_pair_span(W), p.uppers, W, threadIdx.x, blockDim.x);
    for (int i = W * W + threadIdx.x; i < lm_quads(W) * W; i += blockDim.x)
      ((float*)lm_pair_s)[i] = -__int_as_float(0x7f800000);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  if (b >= p.B) return;  // only a one-warp team leaves early: no block barrier

  // Best-exit sources a step: one, or one a word with the LM.
  const int nb = LM ? W : 1;
  unsigned char* const team_smem = smem + (size_t)team * p.team_bytes;
  unsigned char* codes = nullptr;
  short* bex = nullptr;
  int* sbex = nullptr;  // STAGED: the step's best exit
  if constexpr (MODE == DECODE_SHARED || STAGED) {
    codes = team_smem;
  } else if constexpr (MODE == DECODE_GLOBAL) {
    codes = p.codes_g + (size_t)b * T * p.row_bytes;
    bex = (short*)(p.codes_g + (size_t)p.B * T * p.row_bytes) + (size_t)b * T * nb;
  }
  if constexpr (MODE == DECODE_SHARED) bex = (short*)(codes + align16((size_t)T * p.row_bytes));
  if constexpr (STAGED) sbex = (int*)(codes + align16((size_t)T * p.row_bytes));
  // ROWS: STREAM_ROW_SLOTS emission rows (row_bytes floats each, row r in
  // slot r % STREAM_ROW_SLOTS), copied whole by the team's threads, after
  // the staged codes and exits, or at the start of the block's memory.
  float* const rows_s = (float*)(
      smem + (STAGED ? align16((size_t)T * p.row_bytes) + align16((size_t)T * 4) : 0));
  // The LM's exchange: exit values (2, Wq), per-word values and sources
  // (2, W) each. The exit rows' pads stay -inf (published by the first
  // step's sync); the one-pass loop reads one value at a time, and builds
  // without LM_SCAN keep the pitch W.
  const int Wq = LM_SCAN ? lm_quads(W) : W;
  float* lm_ex = (float*)(team_smem + p.codes_off);
  float* lm_val = lm_ex + 2 * Wq;
  int* lm_src = (int*)(lm_val + 2 * W);
  if constexpr (LM_SCAN) {
    for (int i = W + tt; i < Wq; i += nt) lm_ex[i] = lm_ex[Wq + i] = neg;
  }

  // The flat stream mode may take a chunk in launches of T frames from
  // frame t_off (STAGED, where C rows of codes do not fit in shared memory).
  const float* lb_b =
      p.log_b + ((size_t)b * (FLAT ? p.c_rows : T) + (STAGED ? p.t_off : 0)) * p.ld;
  const int j0 = tt * K;
  int length = 0, steps = 0, first = 1;
  // Stream mode: the row's slot and absolute frame. A padding row (valid 0)
  // leaves, the whole team at once (a team past one warp is the block).
  int slot = 0, t_abs = 0;
  RingT* ring_s = nullptr;
  float a[K], dg[K], s1[K], s2[K];
  int wd[K];  // LM: each state's word
  unsigned entry_m = 0, exit_m = 0;
  // Emission rows come in D steps ahead of use, into registers: pf[d] holds
  // row first + d, first + d + D, ...
  float pf[D][K];
  auto fetch = [&](float* dst, int row) {
    if constexpr (FAST_PROLOGUE) {
      // No branch: a row past the last live one is re-read within C.
      const float* r = lb_b + (size_t)min(row, T - 1) * p.ld + j0;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j0 + k < S) dst[k] = __ldg(r + k);
    } else if (row < steps) {
      const float* r = lb_b + (size_t)row * p.ld + j0;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j0 + k < S) dst[k] = __ldg(r + k);
    }
  };
  // STAGED: row `row` into its slot by consecutive threads (4-byte
  // cp.async, one commit group a row, empty past the last live row).
  auto stage_row = [&](int row) {
    if (row < steps) {
      const float* src = lb_b + (size_t)row * p.ld;
      float* dst = rows_s + (size_t)(row % STREAM_ROW_SLOTS) * p.row_bytes;
      for (int j = tt; j < S; j += nt) cp_async4(dst + j, src + j);
    }
    cp_async_commit();
  };
  if constexpr (FAST_PROLOGUE) {
    // No load waits on another here: the coefficients and rows 0..D
    // (within C, so always in bounds) go out before the row's ids arrive;
    // the carried alpha, which needs the slot, goes out beside them.
    // STAGED reads its rows from shared memory: only row 0 (the seed) here.
    constexpr int PRE = STAGED ? 1 : D + 1;
    float d_init[K], rows[PRE][K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      a[k] = dg[k] = s1[k] = s2[k] = neg;
      d_init[k] = 0.f;
      wd[k] = 0;
      if (j < S) {
        const bool e = p.coefs[4 * S + j] > 0.f;
        entry_m |= (unsigned)e << k;
        exit_m |= (unsigned)(p.coefs[5 * S + j] > 0.f) << k;
        const float d_e = p.coefs[3 * S + j], d_ne = p.coefs[j];
        dg[k] = e ? d_e : d_ne;
        s1[k] = p.coefs[S + j];
        s2[k] = p.coefs[2 * S + j];
        d_init[k] = p.coefs[6 * S + j];
      }
    }
#pragma unroll
    for (int d = 0; d < PRE; ++d) {
      const float* r = lb_b + (size_t)min(d, T - 1) * p.ld + j0;
#pragma unroll
      for (int k = 0; k < K; ++k) rows[d][k] = j0 + k < S ? __ldg(r + k) : 0.f;
    }
    length = p.lengths[b] - p.t_off;
    slot = p.slot_ids[b];
    t_abs = p.t_start[b] + p.t_off;
    if (length <= 0 || slot < 0 || slot >= p.n_slots) return;
    steps = min(length, T);
    // The first live row: 1 (row 0 seeds the row, absolute frame 0), or 0
    // for a row that continues its slot's alpha.
    first = t_abs != 0 ? 0 : 1;
    ring_s = (RingT*)p.ring + (size_t)slot * p.t_max * S;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      if (j < S) {
        const float carried = p.alpha_io[(size_t)slot * S + j];
        a[k] = first == 0 ? carried : (((entry_m >> k) & 1u) ? rows[0][k] + d_init[k] : neg);
        if (first == 1) ring_s[j] = (RingT)-1;
      }
      if constexpr (!STAGED) {
#pragma unroll
        for (int d = 0; d < D; ++d) pf[d][k] = first == 0 ? rows[d][k] : rows[d + 1][k];
      }
    }
    if constexpr (STAGED) {
      stage_row(first);
      stage_row(first + 1);
    }
  } else {
    length = p.lengths[b];
    steps = min(max(length, 1), T);  // rows 1..steps-1 are live
    if constexpr (STREAMS) {
      slot = p.slot_ids[b];
      t_abs = p.t_start[b];
      if (length <= 0 || slot < 0 || slot >= p.n_slots) return;
      ring_s = (RingT*)p.ring + (size_t)slot * p.t_max * S;
    }
    first = (STREAMS && t_abs != 0) ? 0 : 1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      a[k] = neg;
      dg[k] = s1[k] = s2[k] = neg;
      wd[k] = 0;
      if (j < S) {
        if constexpr (LM) wd[k] = p.word_of[j];
        if constexpr (SENT) {
          const size_t r = (size_t)b * S + j;
          dg[k] = p.c0[r];
          s1[k] = p.c1[r];
          s2[k] = p.c2[r];
          // t = 0: state 0 alone, plus the row's seed where one is given,
          // else its self-loop (a non-finite one counting as 0).
          if (j == 0)
            a[k] = lb_b[0] + (p.seed ? p.seed[b] : (isfinite(dg[k]) ? dg[k] : 0.f));
        } else {
          const bool e = p.coefs[4 * S + j] > 0.f;
          entry_m |= (unsigned)e << k;
          exit_m |= (unsigned)(p.coefs[5 * S + j] > 0.f) << k;
          dg[k] = e ? p.coefs[3 * S + j] : p.coefs[j];
          s1[k] = p.coefs[S + j];
          s2[k] = p.coefs[2 * S + j];
          if (first == 0) {
            a[k] = p.alpha_io[(size_t)slot * S + j];
          } else if (e) {
            a[k] = lb_b[j] + p.coefs[6 * S + j];
          }
        }
        if constexpr (STREAMS) {
          if (first == 1) ring_s[j] = (RingT)-1;  // absolute frame 0
        } else if constexpr (!DECODE) {
          p.bp[(size_t)b * T * S + j] = -1;
        }
      }
    }
  }

  // BEAM with the LM: the team's max of m (every thread gets it), by
  // redux.sync over an order-preserving key (-0 folds into +0, which
  // max - beam hides), and states below (max - beam) set to -inf, on the
  // chain after each step.
  auto team_max = [&](int parity, float m) {
    unsigned key = __reduce_max_sync(FULL, okey(m));
    if (!one_warp) {
      if (lane == 0) red_m[parity][tw] = key;
      asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
      key = __reduce_max_sync(FULL, lane < p.w ? red_m[parity][lane] : 0u);
    }
    return unkey(key);
  };
  auto prune = [&](int parity, float (&v)[K]) {
    float m = neg;
#pragma unroll
    for (int k = 0; k < K; ++k) m = fmaxf(m, v[k]);
    const float th = team_max(parity, m) - p.beam;
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = v[k] >= th ? v[k] : neg;
  };
  if constexpr (BEAM) {
    if (!defer) prune(0, a);
  }
  if constexpr (ROWS && !FAST_PROLOGUE) {
    stage_row(first);
    stage_row(first + 1);
  } else if constexpr (!FAST_PROLOGUE) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int k = 0; k < K; ++k) pf[d][k] = 0.f;
      fetch(pf[d], first + d);
    }
  }

  // defer: a[] holds the step's UNPRUNED alpha. The threshold th = (the
  // team's max of a) - beam is reduced beside the exit over the same values
  // (team_best: its key goes through the exit's shared write and barrier,
  // and its redux.sync over the warps' keys runs beside the exit's second
  // butterfly) and applied where a step reads alpha: a source below th
  // reads as -inf. Pruning only replaces
  // values below th by -inf, so masking at use is masking at once, -0 and
  // +0 included (the max's folded sign moves th by nothing a >= compares);
  // and the pruned best exit is the unpruned one where its value is >= th,
  // else every exit is pruned and it is (-inf, 0), the reference's rule.
  // The codes come from the masked values, as the plain version's come
  // from the pruned alpha.
  auto beam_th = [&](unsigned mkey) { return unkey(mkey) - p.beam; };
  auto mask = [&](float v, float th) { return defer ? (v >= th ? v : neg) : v; };
  auto prune_key = [&]() {
    float m = neg;
#pragma unroll
    for (int k = 0; k < K; ++k) m = fmaxf(m, a[k]);
    return __reduce_max_sync(FULL, okey(m));
  };

  // The team's best exit over alpha with better(), every thread getting
  // (value, index), and each lane's j0-1 / j0-2 neighbours u1 / u2. Its sync
  // also publishes the codes stored before it. DEFER: with the threshold
  // (th, from the prune's key in the same exchange) and the pruned exit.
  auto team_best = [&](int parity, float& bv, int& bi, float& u1, float& u2, float& th) {
    bv = neg;
    bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (((exit_m >> k) & 1u) && better(a[k], j0 + k, bv, bi)) {
        bv = a[k];
        bi = j0 + k;
      }
    }
    unsigned mkey = defer ? prune_key() : 0u;
    warp_best(bv, bi);
    u1 = __shfl_up_sync(FULL, a[K - 1], 1);
    u2 = __shfl_up_sync(FULL, a[K - 2], 1);
    if (one_warp) {
      __syncwarp();
      if (lane == 0) u1 = u2 = neg;
    } else {
      if (lane == 31) bnd[parity][tw] = make_float2(a[K - 1], a[K - 2]);
      if (lane == 0) {
        red_v[parity][tw] = bv;
        red_i[parity][tw] = bi;
        if (defer) red_m[parity][tw] = mkey;
      }
      asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
      if (lane == 0) {
        if (tw > 0) {
          const float2 q = bnd[parity][tw - 1];
          u1 = q.x;
          u2 = q.y;
        } else {
          u1 = u2 = neg;
        }
      }
      bv = lane < p.w ? red_v[parity][lane] : neg;
      bi = lane < p.w ? red_i[parity][lane] : INT_MAX;
      if (defer) mkey = __reduce_max_sync(FULL, lane < p.w ? red_m[parity][lane] : 0u);
      warp_best(bv, bi);
    }
    // Every exit at -inf: the reference's first-max runs over all states,
    // which then all tie, so the winner is state 0.
    if (!(bv > neg)) bi = 0;
    if (defer) {
      th = beam_th(mkey);
      u1 = mask(u1, th);
      u2 = mask(u2, th);
      const bool kept = bv >= th;
      bv = kept ? bv : neg;
      bi = kept ? bi : 0;
    }
  };

  // A step at a non-zero penalty: only the best exit's value feeds the next
  // alpha, so it is reduced alone, as the max of order-preserving keys
  // (one redux.sync a warp; past one warp each warp's key, with its lane-31
  // boundary states, through shared memory under one barrier, then one
  // redux.sync over the warps' keys). The max folds -0 into +0, where
  // better() keeps the sign of the lowest index; bv + penalty hides the
  // difference unless the penalty is zero, where the step takes team_best
  // instead. The lowest index holding the max (better()'s winner) only
  // feeds stores: in one warp a redux.min over the lanes equal to it, off
  // the chain (wi); past one warp (STAGED) each warp's least (wi) reaches
  // the others at the NEXT step's barrier (red_i), where prev_bi, the
  // team's least of the step before, is reduced beside the value.
  auto key_exit = [&](int parity, float& bv, int& wi, int& prev_bi, int prev_wi, bool has_prev,
                      float& u1, float& u2) {
    float ve = neg;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((exit_m >> k) & 1u) ve = fmaxf(ve, a[k]);
    unsigned key = __reduce_max_sync(FULL, okey(ve));
    u1 = __shfl_up_sync(FULL, a[K - 1], 1);
    u2 = __shfl_up_sync(FULL, a[K - 2], 1);
    if (one_warp) {
      if (lane == 0) u1 = u2 = neg;
    } else {
      if (lane == 31) bnd[parity][tw] = make_float2(a[K - 1], a[K - 2]);
      if (lane == 0) {
        red_m[parity][tw] = key;
        if (has_prev) red_i[parity ^ 1][tw] = prev_wi;
      }
      asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
      if (lane == 0) {
        const float2 q = tw > 0 ? bnd[parity][tw - 1] : make_float2(neg, neg);
        u1 = q.x;
        u2 = q.y;
      }
      const unsigned pc = lane < p.w && has_prev ? (unsigned)red_i[parity ^ 1][lane] : INT_MAX;
      key = __reduce_max_sync(FULL, lane < p.w ? red_m[parity][lane] : 0u);
      prev_bi = (int)__reduce_min_sync(FULL, pc);
    }
    bv = unkey(key);
    unsigned cand = INT_MAX;
#pragma unroll
    for (int k = K - 1; k >= 0; --k)
      if (((exit_m >> k) & 1u) && a[k] == bv) cand = j0 + k;
    wi = (int)__reduce_min_sync(FULL, cand);
  };

  // The sentence step's only exchange: each lane's j0-1 / j0-2 neighbours
  // (a lane-31 boundary through shared memory and the named barrier past one
  // warp).
  auto neighbours = [&](int parity, float& u1, float& u2) {
    u1 = __shfl_up_sync(FULL, a[K - 1], 1);
    u2 = __shfl_up_sync(FULL, a[K - 2], 1);
    if (one_warp) {
      if (lane == 0) u1 = u2 = neg;
    } else {
      if (lane == 31) bnd[parity][tw] = make_float2(a[K - 1], a[K - 2]);
      asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
      if (lane == 0) {
        const float2 q = tw > 0 ? bnd[parity][tw - 1] : make_float2(neg, neg);
        u1 = q.x;
        u2 = q.y;
      }
    }
  };

  // LM_REGISTERS (K = 2, W <= LM_REG_WORDS: one word a lane, one warp):
  // the lane's column pair[v, tt] (v < 32, -inf past W) in registers for
  // the whole time loop, so a step loads only the exit values.
  constexpr bool LM_REGS = LM_SCAN && K == 2;
  const bool lm_regs = LM_REGS && lm_table == LM_REGISTERS;
  float pcol[LM_REGS ? LM_REG_WORDS : 1];
#pragma unroll
  for (int i = 0; i < (LM_REGS ? LM_REG_WORDS : 1); ++i)
    pcol[i] = lm_regs && i < W && tt < W ? __ldg(p.pair + i * W + tt) : neg;

  // LM: word w's best source, one lane a word, in two passes over its
  // candidates x_v = ex[v] + pair[v, w]: the max m by fmaxf in four
  // independent running maxima, then the lowest v with x_v == m by an
  // integer min over keys 2 v + sign(x_v), so the winner keeps its own sign
  // of zero (m's sign is x_v's unless m is zero). Neither pass carries a
  // compare and select from one candidate to the next: such a chain, its
  // compares sharing the few predicate registers, ran the candidates one
  // after another. This is the lowest v attaining the max with its own sum,
  // and source 0 where every candidate is -inf (their keys are 2 v + 1), as
  // torch's max over a dim. Where no candidate equals m (every real one NaN:
  // fmaxf skips NaN and m stays -inf) the key names no word or a pad, and
  // the source is 0, as the one-pass loop's strict > leaves it. The exit
  // values come four at a time (a broadcast float4; the pads' -inf never
  // win over a real -inf, whose v is lower); pair[v, w] from registers
  // (pcol: a fully unrolled scan of exactly Wq / 4 groups, picked by one
  // switch, since a uniform branch a group cost more than its group), from
  // the shared table's column (rows past W at -inf) or from global memory
  // (the last group's rows past W read as 0, their exit values being -inf).
  auto lm_reduce = [&](auto groups, float& bv, int& bi) {
    float m4[4] = {neg, neg, neg, neg};
    groups([&](int v, float4 e, float p0, float p1, float p2, float p3) {
      m4[0] = fmaxf(m4[0], e.x + p0);
      m4[1] = fmaxf(m4[1], e.y + p1);
      m4[2] = fmaxf(m4[2], e.z + p2);
      m4[3] = fmaxf(m4[3], e.w + p3);
    });
    const float m = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3]));
    auto key = [&](float x, int v) {
      return x == m ? 2u * (unsigned)v + (__float_as_uint(x) >> 31) : ~0u;
    };
    unsigned k4[4] = {~0u, ~0u, ~0u, ~0u};
    groups([&](int v, float4 e, float p0, float p1, float p2, float p3) {
      k4[0] = min(k4[0], key(e.x + p0, v));
      k4[1] = min(k4[1], key(e.y + p1, v + 1));
      k4[2] = min(k4[2], key(e.z + p2, v + 2));
      k4[3] = min(k4[3], key(e.w + p3, v + 3));
    });
    const unsigned k = min(min(k4[0], k4[1]), min(k4[2], k4[3]));
    bi = (k >> 1) < (unsigned)W ? (int)(k >> 1) : 0;
    bv = __uint_as_float((__float_as_uint(m) & 0x7fffffffu) | (k << 31));
  };
  auto lm_scan = [&](const float* ex, int w, float& bv, int& bi) {
    const float4* ex4 = (const float4*)ex;
    if constexpr (LM_REGS) {
      if (lm_regs) {
        auto regs = [&](auto n_groups) {
          constexpr int NQ = decltype(n_groups)::value;
          float4 e[NQ];
#pragma unroll
          for (int q = 0; q < NQ; ++q) e[q] = ex4[q];
          lm_reduce([&](auto f) {
#pragma unroll
            for (int q = 0; q < NQ; ++q)
              f(4 * q, e[q], pcol[4 * q], pcol[4 * q + 1], pcol[4 * q + 2], pcol[4 * q + 3]);
          }, bv, bi);
        };
        static_assert(LM_REG_WORDS == 32, "one case a group count");
        switch (Wq >> 2) {
          case 1: regs(std::integral_constant<int, 1>{}); break;
          case 2: regs(std::integral_constant<int, 2>{}); break;
          case 3: regs(std::integral_constant<int, 3>{}); break;
          case 4: regs(std::integral_constant<int, 4>{}); break;
          case 5: regs(std::integral_constant<int, 5>{}); break;
          case 6: regs(std::integral_constant<int, 6>{}); break;
          case 7: regs(std::integral_constant<int, 7>{}); break;
          default: regs(std::integral_constant<int, 8>{}); break;
        }
        return;
      }
    }
    if (lm_table == LM_SHARED) {
      lm_reduce([&](auto f) {
        const float* c = lm_pair_s + w;
#pragma unroll 4
        for (int v = 0; v < Wq; v += 4, c += 4 * W)
          f(v, ex4[v >> 2], c[0], c[W], c[2 * W], c[3 * W]);
      }, bv, bi);
    } else {
      lm_reduce([&](auto f) {
        const float* c = p.pair + w;
        const int wf = W & ~3;
        int v = 0;
#pragma unroll 4
        for (; v < wf; v += 4, c += 4 * W)
          f(v, ex4[v >> 2], __ldg(c), __ldg(c + W), __ldg(c + 2 * W), __ldg(c + 3 * W));
        if (v < W)
          f(v, ex4[v >> 2], __ldg(c), v + 1 < W ? __ldg(c + W) : 0.f,
            v + 2 < W ? __ldg(c + 2 * W) : 0.f, 0.f);
      }, bv, bi);
    }
  };

  // LM: the per-word entry values and sources of step t, behind the
  // neighbours' exchange (whose sync publishes the exit values); a second
  // sync publishes them. Decode mode stores each word's source state. The
  // builds without LM_SCAN read each column in order, a strict > keeping
  // the lowest v: there the two passes, reading a column twice, were
  // slower (the K = 4 stream) or spilled (K = 8). An LM_SCAN build keeps no
  // such loop beside its scan: with it, ptxas gave the K = 4 LM + beam
  // decode 64 registers and spills, and the K = 2 register branch slowed.
  auto lm_entry = [&](int t, int parity, float& u1, float& u2) {
    float* ex = lm_ex + parity * Wq;
    float* val = lm_val + parity * W;
    int* src = lm_src + parity * W;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((exit_m >> k) & 1u) ex[wd[k]] = a[k];
    if (one_warp) __syncwarp();
    neighbours(parity, u1, u2);
    for (int w = tt; w < W; w += nt) {
      float bv = neg;
      int bi = 0;
      if constexpr (LM_SCAN) {
        lm_scan(ex, w, bv, bi);
      } else {
        for (int v = 0; v < W; ++v) {
          const float c = ex[v] + __ldg(p.pair + (size_t)v * W + w);
          if (c > bv) {
            bv = c;
            bi = v;
          }
        }
      }
      const int st = lm_table == LM_SHARED ? lm_up_s[bi] : __ldg(p.uppers + bi);
      val[w] = bv;
      src[w] = st;
      if constexpr (DECODE) bex[(size_t)t * W + w] = (short)st;
    }
    if (one_warp) {
      __syncwarp();
    } else {
      asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
    }
  };

  // One step: code c in {0, 1, 2} is the predecessor max(j - c, 0), 3 the
  // step's best exit; decode mode stores the codes and the exit's index,
  // backpointer mode the int32 backpointers they stand for, stream mode the
  // same backpointers into the ring at the row's absolute frame (STAGED:
  // the codes and the exit's index into shared memory, where on the value
  // path past one warp a step learns its exit's index at the next step's
  // barrier: wi_prev is this warp's candidate).
  int wi_prev = 0;
  float th = neg;  // DEFER: the threshold of a[]
  auto step = [&](int t, const float* lbv, auto value_only) {
    constexpr bool VALUE = decltype(value_only)::value;
    const bool live = DECODE || STREAMS || t < length;
    const bool late = VALUE && !one_warp;  // the exit's index a step late
    float bv = neg, u1, u2;
    int bi = 0, prev_bi = 0;
    // ROWS: row t has landed (row t + 1 may be in flight); the exit's
    // barrier publishes it to the team.
    if constexpr (ROWS) cp_async_wait<1>();
    if constexpr (SENT) {
      neighbours(t & 1, u1, u2);
    } else if constexpr (LM) {
      lm_entry(t, t & 1, u1, u2);
    } else if constexpr (VALUE) {
      key_exit(t & 1, bv, bi, prev_bi, wi_prev, t > first, u1, u2);
    } else {
      team_best(t & 1, bv, bi, u1, u2, th);
    }
    float row_t[K];
    if constexpr (ROWS) {
      // Row t + 2 into the slot row t - 1 left (read before this barrier);
      // row t from its slot, two 16-byte loads a lane.
      stage_row(t + 2);
      const float4* r = (const float4*)(rows_s + (size_t)(t % STREAM_ROW_SLOTS) * p.row_bytes + j0);
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const float4 x = r[q];
        row_t[4 * q] = x.x;
        row_t[4 * q + 1] = x.y;
        row_t[4 * q + 2] = x.z;
        row_t[4 * q + 3] = x.w;
      }
      lbv = row_t;
    }
    const float c_pen = bv + p.penalty;
    float na[K];
    int code[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      const float a0 = mask(a[k], th);
      const float a1 = k >= 1 ? mask(a[k - 1], th) : u1;
      const float a2 = k >= 2 ? mask(a[k - 2], th) : (k == 1 ? u1 : u2);
      float val;
      if (SENT) {
        // The plain version starts from skip-2 and replaces on a strict >:
        // the same codes as below, and the value is the winner's own (a max
        // could fold -0 into +0).
        const float c0 = a0 + dg[k];
        const float c1 = a1 + s1[k];
        const float c2 = a2 + s2[k];
        const bool one = c1 >= c0;
        const float w12 = one ? c1 : c0;
        const bool two = c2 >= w12;
        val = two ? c2 : w12;
        code[k] = two ? 2 : (one ? 1 : 0);
      } else if ((entry_m >> k) & 1u) {
        const float cp = LM ? lm_val[(t & 1) * W + wd[k]] : c_pen;
        const float c_self = a0 + dg[k];
        val = fmaxf(cp, c_self);
        code[k] = cp >= c_self ? 3 : 0;
      } else {
        const float c0 = a0 + dg[k];
        const float c1 = a1 + s1[k];
        const float c2 = a2 + s2[k];
        const float v12 = fmaxf(c1, c0);
        val = fmaxf(c2, v12);
        code[k] = c2 >= v12 ? 2 : (c1 >= c0 ? 1 : 0);
      }
      na[k] = (live && j < S) ? val + lbv[k] : a0;
    }
    if constexpr (BEAM) {
      if (!defer) prune(t & 1, na);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] = na[k];
    // The value path's index, where it is stored: 0 where every exit is
    // -inf.
    if (VALUE) bi = bv > neg ? bi : 0;
    if constexpr (DECODE || STAGED) {
      unsigned long long packed = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) packed |= (unsigned long long)code[k] << (8 * k);
      unsigned char* c_t = codes + (size_t)t * p.row_bytes + j0;
      if (K == 2) *(unsigned short*)c_t = (unsigned short)packed;
      if (K == 4) *(unsigned*)c_t = (unsigned)packed;
      if (K == 8) *(unsigned long long*)c_t = packed;
      if constexpr (STAGED) {
        if (late) {
          if (tt == 0 && t > first) sbex[t - 1] = prev_bi;
        } else if (tt == 0) {
          sbex[t] = bi;
        }
      } else if (!SENT && !LM && tt == 0) {
        bex[t] = (short)bi;
      }
    } else if constexpr (STREAMS) {
      // One element a state (bytes for the int8 ring: a row of S bytes has
      // no alignment to pack into); the clamp mirrors the plain version's.
      RingT* r_t = ring_s + (size_t)min(t_abs + t, p.t_max - 1) * S;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int src = LM ? lm_src[(t & 1) * W + wd[k]] : bi;
        if (j0 + k < S) r_t[j0 + k] = (RingT)(code[k] == 3 ? src : max(j0 + k - code[k], 0));
      }
    } else {
      int* bp_t = p.bp + ((size_t)b * T + t) * S;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j0 + k < S) bp_t[j0 + k] = code[k] == 3 ? bi : max(j0 + k - code[k], 0);
    }
    if (STAGED && late) wi_prev = bi;
  };

  const int t_end = (DECODE || STREAMS) ? steps : T;
  auto run = [&](auto value_only) {
    if constexpr (ROWS) {
      for (int t = first; t < t_end; ++t) step(t, nullptr, value_only);
      return;
    }
    for (int t0 = first; t0 < t_end; t0 += D) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int t = t0 + d;
        if (t >= t_end) break;
        step(t, pf[d], value_only);
        fetch(pf[d], t + D);
      }
    }
  };
  // The value path: a non-zero penalty, and one warp or STAGED (the other
  // teams past one warp take team_best).
  const bool value_path = !SENT && !LM && p.penalty != 0.f && (one_warp || STAGED);
  if (value_path) {
    run(std::true_type{});
  } else {
    run(std::false_type{});
  }

  if constexpr (STAGED) {
    if (value_path && !one_warp && steps > first) {
      // The last step's exit index, through one more barrier.
      const int last = steps - 1;
      if (lane == 0) red_i[last & 1][tw] = wi_prev;
      asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
      const int bi = (int)__reduce_min_sync(
          FULL, lane < p.w ? (unsigned)red_i[last & 1][lane] : (unsigned)INT_MAX);
      if (tt == 0) sbex[last] = bi;
    }
    // The staged rows into the ring, consecutive threads on consecutive
    // states (one coalesced store an element, where a step's K stores a
    // lane spread over 32 sectors); a clamped row is written in step
    // order, so the last step's stays.
    asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
    for (int t = first; t < steps; ++t) {
      const int bt = sbex[t];
      RingT* r_t = ring_s + (size_t)min(t_abs + t, p.t_max - 1) * S;
      const unsigned char* c_t = codes + (size_t)t * p.row_bytes;
      for (int j = tt; j < S; j += nt) {
        const int c = c_t[j];
        r_t[j] = (RingT)(c == 3 ? bt : max(j - c, 0));
      }
    }
  }

  if constexpr (!DECODE) {
    float* out = STREAMS ? p.alpha_io + (size_t)slot * S : p.alpha_out + (size_t)b * S;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (j0 + k < S) out[j0 + k] = a[k];
    return;
  }

  // Decode epilogue: the walk's start (the final best exit, or the sentence's
  // given final state and its alpha from the lane that owns it) behind a
  // sync that publishes the codes, then the walk. DEFER: the last live
  // step's prune lands here, in team_best's threshold.
  float best_v = neg;
  int best;
  if constexpr (SENT) {
    if (one_warp) {
      __syncwarp();
    } else {
      asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
    }
    best = p.final_state[b];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (j0 + k == best) p.scores[b] = a[k];
  } else {
    float u1, u2;
    team_best(t_end & 1, best_v, best, u1, u2, th);
  }
  int* path = p.paths + (size_t)b * T;
  for (int t = max(length, 1) + tt; t < T; t += nt) path[t] = best;
  if (tt != 0) return;
  if (!SENT) p.scores[b] = best_v;
  const int second = min(max(length - 2, 0), T - 1);
  int state = best;
  int at_second = best;
#pragma unroll 4
  for (int t = steps - 1; t >= 1; --t) {
    path[t] = state;
    if (t == second) at_second = state;
    const int c = codes[(size_t)t * p.row_bytes + state];
    state = c == 3 ? (int)bex[(size_t)t * nb + (LM ? __ldg(p.word_of + state) : 0)]
                   : max(state - c, 0);
  }
  path[0] = state;
  if (second == 0) at_second = state;
  const int last = max(length - 1, 0);
  if (p.quirk && last < T) path[last] = at_second;  // path[L-1] = path[L-2]
}

// BP: int (backpointers of a forward) or int8_t (the serving ring); row t of
// utterance b at bp + b * ustride + t * S. Row 0 (the -1 seed) is never read.
// An int8 span is staged as the 4-byte words that hold it (at most 3 bytes
// either side, inside the words of its own first and last byte); the int32
// path is the same code as before the ring, which the card times as fast.
template <typename BP>
__global__ void trellis_backtrace_kernel(
    const BP* __restrict__ bp, long long ustride, const int* __restrict__ best,
    const int* __restrict__ lengths, int* __restrict__ path,
    int T, int S, int R, int buf_ints, int quirk) {
  extern __shared__ __align__(16) int tiles[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int length = lengths[b];
  const int start = best[b];
  int* p = path + (size_t)b * T;
  // Entries past the length hold the start state (emitted before stepping).
  for (int t = max(length, 1) + lane; t < T; t += 32) p[t] = start;

  const int hi = min(length, T) - 1;  // rows 1..hi are walked
  const int ntiles = hi >= 1 ? (hi + R - 1) / R : 0;
  const BP* bp_b = bp + (size_t)b * ustride;
  // The 4-byte words staging rows lo..top: their first word and count.
  auto words = [&](int lo, int top, const int*& w0, int& n) {
    const uintptr_t src = (uintptr_t)(bp_b + (size_t)lo * S);
    if constexpr (sizeof(BP) == 4) {
      w0 = (const int*)src;
      n = (top - lo + 1) * S;
    } else {
      const uintptr_t end = src + (uintptr_t)(top - lo + 1) * S;
      w0 = (const int*)(src & ~(uintptr_t)3);
      n = (int)((((end + 3) & ~(uintptr_t)3) - (uintptr_t)w0) >> 2);
    }
  };
  auto issue = [&](int k) {
    if (k < ntiles) {
      const int top = hi - k * R;
      const int lo = max(top - R + 1, 1);
      const int* w0;
      int n;
      words(lo, top, w0, n);
      copy_span(tiles + (k % BT_TILES) * buf_ints, w0, n, lane, 32);
    }
    cp_async_commit();
  };
  for (int k = 0; k < BT_TILES; ++k) issue(k);
  const int second = min(max(length - 2, 0), T - 1);
  int state = start;
  int at_second = start;
  for (int k = 0; k < ntiles; ++k) {
    cp_async_wait<BT_TILES - 1>();  // tile k has landed (this lane's copies)
    __syncwarp();
    if (lane == 0) {
      const int top = hi - k * R;
      const int lo = max(top - R + 1, 1);
      const int* w0;
      int n;
      words(lo, top, w0, n);
      const BP* tile = (const BP*)(tiles + (k % BT_TILES) * buf_ints + span_offset(w0));
      if constexpr (sizeof(BP) == 1)
        tile += (uintptr_t)(bp_b + (size_t)lo * S) - (uintptr_t)w0;
      for (int t = top; t >= lo; --t) {
        p[t] = state;
        if (t == second) at_second = state;
        state = (int)tile[(t - lo) * S + state];
      }
    }
    __syncwarp();
    issue(k + BT_TILES);
  }
  cp_async_wait<0>();
  if (lane != 0) return;
  p[0] = state;
  if (second == 0) at_second = state;
  const int last = max(length - 1, 0);
  if (quirk && last < T) p[last] = at_second;  // path[L-1] = path[L-2]
}

// The flat stream mode at K = 8: its shared bytes for T frames (codes,
// best exits, then STREAM_ROW_SLOTS emission rows of row_bytes floats), and
// the most frames a launch whose bytes fit in STREAM_SMEM_BUDGET.
size_t stream_stage_bytes(int T, int row_bytes) {
  return align16((size_t)T * row_bytes) + align16((size_t)T * 4) +
         (size_t)STREAM_ROW_SLOTS * row_bytes * 4;
}
int stream_stage_rows(int row_bytes) {
  int f = 1;
  while (stream_stage_bytes(f + 1, row_bytes) <= STREAM_SMEM_BUDGET) ++f;
  return f;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int K, int MODE, bool SENT, typename RingT = int, bool LM = false,
          bool BEAM = false, bool WIDE = false>
int launch_team(const Plan& pl, TeamArgs a, cudaStream_t stream) {
  a.w = pl.w;
  a.u = pl.u;
  a.row_bytes = pl.row_bytes;
  a.codes_off = pl.codes_off;
  a.team_bytes = pl.team_bytes;
  a.lm_table = pl.lm_table;
  // The row slots of a decode or backpointer build with ROWS (the stream
  // mode's plan counts its own).
  const size_t smem = pl.smem + (rows_in_smem<K, MODE, SENT, LM>() && MODE != STREAM
                                     ? (size_t)STREAM_ROW_SLOTS * pl.row_bytes * 4
                                     : 0);
  const void* fn = (const void*)trellis_team_kernel<K, MODE, SENT, RingT, LM, BEAM, WIDE>;
  const int err = set_smem(fn, smem);
  if (err) return err;
  const int threads = 32 * (pl.w == 1 ? pl.u : pl.w);
  const int blocks = (a.B + pl.u - 1) / pl.u;
  trellis_team_kernel<K, MODE, SENT, RingT, LM, BEAM, WIDE><<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE, bool SENT, typename RingT = int, bool LM = false, bool BEAM = false>
int launch_k(const Plan& pl, TeamArgs a, cudaStream_t stream) {
  if (pl.k == 2) return launch_team<2, MODE, SENT, RingT, LM, BEAM>(pl, a, stream);
  if (pl.k == 4) return launch_team<4, MODE, SENT, RingT, LM, BEAM>(pl, a, stream);
  if constexpr (rows_in_smem<8, MODE, SENT, LM>()) {
    if (pl.w > STREAM_K8_WARPS) return launch_team<8, MODE, SENT, RingT, LM, BEAM, true>(pl, a, stream);
  }
  return launch_team<8, MODE, SENT, RingT, LM, BEAM>(pl, a, stream);
}

template <bool SENT>
int launch_forward(TeamArgs a, bool decode, cudaStream_t stream) {
  const Plan pl = make_plan(a.T, a.S, decode);
  if (!decode) return launch_k<BACKPOINTERS, SENT>(pl, a, stream);
  if (pl.codes_shared) return launch_k<DECODE_SHARED, SENT>(pl, a, stream);
  return launch_k<DECODE_GLOBAL, SENT>(pl, a, stream);
}

// The search decode modes: LM and / or BEAM.
template <bool LM, bool BEAM>
int launch_search(TeamArgs a, cudaStream_t stream) {
  const Plan pl = make_plan(a.T, a.S, true, LM ? a.n_words : 0);
  if (pl.codes_shared) return launch_k<DECODE_SHARED, false, int, LM, BEAM>(pl, a, stream);
  return launch_k<DECODE_GLOBAL, false, int, LM, BEAM>(pl, a, stream);
}

TeamArgs sentence_args(const void* log_b, const void* c0, const void* c1,
                       const void* c2, const void* lengths, int B, int T, int S) {
  TeamArgs a = {};
  a.log_b = (const float*)log_b;
  a.c0 = (const float*)c0;
  a.c1 = (const float*)c1;
  a.c2 = (const float*)c2;
  a.lengths = (const int*)lengths;
  a.B = B;
  a.T = T;
  a.S = S;
  a.ld = S;
  return a;
}

}  // namespace

extern "C" int cs304_trellis_forward(
    const void* log_b, const void* coefs, float penalty, const void* lengths,
    void* alpha, void* bp, int B, int T, int S, int ld, void* stream) {
  TeamArgs a = {};
  a.log_b = (const float*)log_b;
  a.coefs = (const float*)coefs;
  a.lengths = (const int*)lengths;
  a.penalty = penalty;
  a.alpha_out = (float*)alpha;
  a.bp = (int*)bp;
  a.B = B;
  a.T = T;
  a.S = S;
  a.ld = ld;
  return launch_forward<false>(a, false, (cudaStream_t)stream);
}

// Bytes of global scratch a decode mode needs for its codes at this shape
// (W = 0, or the LM's words): 0 where every block's codes fit in shared
// memory.
extern "C" long long cs304_trellis_decode_scratch_bytes(int B, int T, int S, int W) {
  const Plan pl = make_plan(T, S, true, W);
  if (pl.codes_shared) return 0;
  return (long long)B * T * pl.row_bytes + (long long)B * T * (W > 0 ? W : 1) * 2;
}

// Where an LM mode (decode != 0: the decode modes, else the stream mode)
// reads its pair table at this shape: LmTable's LM_GLOBAL, LM_SHARED or
// LM_REGISTERS.
extern "C" int cs304_trellis_lm_table(int T, int S, int W, int decode) {
  return make_plan(T, S, decode != 0, W).lm_table;
}

extern "C" int cs304_trellis_decode(
    const void* log_b, const void* coefs, float penalty, const void* lengths,
    void* scores, void* paths, void* scratch, int B, int T, int S, int ld,
    int quirk, void* stream) {
  TeamArgs a = {};
  a.log_b = (const float*)log_b;
  a.coefs = (const float*)coefs;
  a.lengths = (const int*)lengths;
  a.penalty = penalty;
  a.scores = (float*)scores;
  a.paths = (int*)paths;
  a.codes_g = (unsigned char*)scratch;
  a.B = B;
  a.T = T;
  a.S = S;
  a.ld = ld;
  a.quirk = quirk;
  return launch_forward<false>(a, true, (cudaStream_t)stream);
}

// The search decode modes: as cs304_trellis_decode, with a bigram LM where
// pair is given ((W, W) f32 pair[v, w], word_of (S,) i32, uppers (W,) i32;
// penalty unused) and the beam where has_beam; scratch as
// cs304_trellis_decode_scratch_bytes(B, T, S, pair ? W : 0) says.
extern "C" int cs304_trellis_search_decode(
    const void* log_b, const void* coefs, float penalty, const void* pair,
    const void* word_of, const void* uppers, int W, float beam, int has_beam,
    const void* lengths, void* scores, void* paths, void* scratch, int B, int T, int S,
    int ld, int quirk, void* stream) {
  TeamArgs a = {};
  a.log_b = (const float*)log_b;
  a.coefs = (const float*)coefs;
  a.lengths = (const int*)lengths;
  a.penalty = penalty;
  a.pair = (const float*)pair;
  a.word_of = (const int*)word_of;
  a.uppers = (const int*)uppers;
  a.n_words = pair ? W : 0;
  a.beam = beam;
  a.scores = (float*)scores;
  a.paths = (int*)paths;
  a.codes_g = (unsigned char*)scratch;
  a.B = B;
  a.T = T;
  a.S = S;
  a.ld = ld;
  a.quirk = quirk;
  cudaStream_t st = (cudaStream_t)stream;
  if (pair) return has_beam ? launch_search<true, true>(a, st) : launch_search<true, false>(a, st);
  if (has_beam) return launch_search<false, true>(a, st);
  return (int)cudaErrorInvalidValue;
}

// The sentence topology (K3). log_b (B, T, S) f32; c0/c1/c2 (B, S) f32
// destination-indexed self/prev/skip log transitions; lengths (B,) i32;
// seed (B,) f32 or null: alpha_0[0] = log_b[b, 0, 0] + seed[b] where given,
// else the self-loop rule.
// Backpointer mode -> alpha (B, S) f32, bp (B, T, S) i32 with row 0 = -1.
extern "C" int cs304_trellis_sentence_forward(
    const void* log_b, const void* c0, const void* c1, const void* c2,
    const void* lengths, const void* seed, void* alpha, void* bp, int B, int T, int S,
    void* stream) {
  TeamArgs a = sentence_args(log_b, c0, c1, c2, lengths, B, T, S);
  a.seed = (const float*)seed;
  a.alpha_out = (float*)alpha;
  a.bp = (int*)bp;
  return launch_forward<true>(a, false, (cudaStream_t)stream);
}

// Decode mode: final (B,) i32 in [0, S) -> scores (B,) = alpha[final],
// paths (B, T) i32 walked from final with the reference quirk; scratch as
// cs304_trellis_decode_scratch_bytes(B, T, S, 0) says (null where it is 0).
extern "C" int cs304_trellis_sentence_decode(
    const void* log_b, const void* c0, const void* c1, const void* c2,
    const void* lengths, const void* final_state, void* scores, void* paths,
    void* scratch, int B, int T, int S, void* stream) {
  TeamArgs a = sentence_args(log_b, c0, c1, c2, lengths, B, T, S);
  a.final_state = (const int*)final_state;
  a.scores = (float*)scores;
  a.paths = (int*)paths;
  a.codes_g = (unsigned char*)scratch;
  a.quirk = 1;
  return launch_forward<true>(a, true, (cudaStream_t)stream);
}

// The stream mode. alpha (n_slots, S) f32 and ring (n_slots, t_max, S) of
// ring_bytes (1: int8, 4: int32) elements are updated in place; slot_ids,
// t, valid (R,) i32; log_b (R, C, ld) f32; coefs (8, S) as the other modes.
extern "C" int cs304_trellis_stream(
    void* alpha, void* ring, int ring_bytes, const void* slot_ids, const void* t,
    const void* valid, const void* log_b, const void* coefs, float penalty,
    int R, int C, int S, int ld, int n_slots, int t_max, void* stream) {
  if (ring_bytes != 1 && ring_bytes != 4) return (int)cudaErrorInvalidValue;
  TeamArgs a = {};
  a.log_b = (const float*)log_b;
  a.coefs = (const float*)coefs;
  a.lengths = (const int*)valid;
  a.penalty = penalty;
  a.slot_ids = (const int*)slot_ids;
  a.t_start = (const int*)t;
  a.alpha_io = (float*)alpha;
  a.ring = ring;
  a.n_slots = n_slots;
  a.t_max = t_max;
  a.B = R;
  a.c_rows = C;
  a.S = S;
  a.ld = ld;
  cudaStream_t st = (cudaStream_t)stream;
  const Plan pl = make_plan(C, S, false);
  if (pl.k != 8) {
    a.T = C;
    return ring_bytes == 1 ? launch_k<STREAM, false, int8_t>(pl, a, st)
                           : launch_k<STREAM, false, int>(pl, a, st);
  }
  // K = 8 stages a launch's codes (T rows), best exits and emission rows in
  // shared memory: the chunk in launches of as many frames as fit, in order.
  const int f = stream_stage_rows(pl.row_bytes);
  for (int off = 0; off < C; off += f) {
    a.t_off = off;
    a.T = C - off < f ? C - off : f;
    Plan sp = pl;
    sp.u = 1;
    sp.team_bytes = stream_stage_bytes(a.T, pl.row_bytes);
    sp.smem = sp.team_bytes;
    const bool wide = pl.w > STREAM_K8_WARPS;
    const int err =
        ring_bytes == 1
            ? (wide ? launch_team<8, STREAM, false, int8_t, false, false, true>(sp, a, st)
                    : launch_team<8, STREAM, false, int8_t>(sp, a, st))
            : (wide ? launch_team<8, STREAM, false, int, false, false, true>(sp, a, st)
                    : launch_team<8, STREAM, false, int>(sp, a, st));
    if (err) return err;
  }
  return 0;
}

// The stream mode with a bigram LM: cs304_trellis_stream's arguments with
// pair (W, W) f32, word_of (S,) i32, uppers (W,) i32 for the penalty.
extern "C" int cs304_trellis_stream_lm(
    void* alpha, void* ring, int ring_bytes, const void* slot_ids, const void* t,
    const void* valid, const void* log_b, const void* coefs, const void* pair,
    const void* word_of, const void* uppers, int W, int R, int C, int S, int ld,
    int n_slots, int t_max, void* stream) {
  TeamArgs a = {};
  a.log_b = (const float*)log_b;
  a.coefs = (const float*)coefs;
  a.lengths = (const int*)valid;
  a.slot_ids = (const int*)slot_ids;
  a.t_start = (const int*)t;
  a.alpha_io = (float*)alpha;
  a.ring = ring;
  a.pair = (const float*)pair;
  a.word_of = (const int*)word_of;
  a.uppers = (const int*)uppers;
  a.n_words = W;
  a.n_slots = n_slots;
  a.t_max = t_max;
  a.B = R;
  a.T = C;
  a.S = S;
  a.ld = ld;
  const Plan pl = make_plan(C, S, false, W);
  cudaStream_t st = (cudaStream_t)stream;
  if (ring_bytes == 1) return launch_k<STREAM, false, int8_t, true>(pl, a, st);
  if (ring_bytes == 4) return launch_k<STREAM, false, int, true>(pl, a, st);
  return (int)cudaErrorInvalidValue;
}

// K2-bt. bp holds elem_bytes-byte backpointers (4: int32, 1: int8), row t
// of utterance b at element b * ustride + t * S (ustride = T * S for a
// forward's (B, T, S) output; T_max * S walks ring[:, :T] of a ring in
// place).
// K2-bt's staging at S states of elem_bytes-byte backpointers: R rows a
// tile, buf_ints words a tile buffer, smem bytes of dynamic shared memory.
struct BtPlan {
  int R;
  int buf_ints;
  size_t smem;
};

static BtPlan bt_plan(long long S, int elem_bytes) {
  const size_t row = (size_t)S * elem_bytes;  // bytes a time step
  const size_t buf_cap = BT_BUDGET / BT_TILES;  // bytes a tile buffer
  size_t r = buf_cap > row + 32 ? (buf_cap - 32) / row : 1;
  if (r > BT_MAX_ROWS) r = BT_MAX_ROWS;
  // The tile's words plus 8 (its head offset and an int8 span's ragged ends).
  const size_t buf_ints = ((r * row + 3) / 4 + 8 + 3) & ~(size_t)3;
  return {(int)r, (int)buf_ints, BT_TILES * buf_ints * 4};
}

// The widest row K2-bt walks on the current device: the most states whose
// staging fits the shared memory a block may opt into there -> *out.
extern "C" int cs304_trellis_backtrace_max_states(int elem_bytes, void* out) {
  if (elem_bytes != 1 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  long long lo = 1, hi = INT_MAX;  // bt_plan(lo) fits; find the last S that does
  while (lo < hi) {
    const long long mid = lo + (hi - lo + 1) / 2;
    if (bt_plan(mid, elem_bytes).smem <= (size_t)optin) lo = mid;
    else hi = mid - 1;
  }
  *(int*)out = (int)lo;
  return 0;
}

extern "C" int cs304_trellis_backtrace(
    const void* bp, int elem_bytes, long long ustride, const void* best,
    const void* lengths, void* path, int B, int T, int S, int quirk, void* stream) {
  if (elem_bytes != 1 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const BtPlan plan = bt_plan(S, elem_bytes);
  const int R = plan.R, buf_ints = plan.buf_ints;
  const size_t smem = plan.smem;
  const void* fn = elem_bytes == 1 ? (const void*)trellis_backtrace_kernel<int8_t>
                                   : (const void*)trellis_backtrace_kernel<int>;
  const int err = set_smem(fn, smem);
  if (err) return err;
  if (elem_bytes == 1) {
    trellis_backtrace_kernel<int8_t><<<B, 32, smem, (cudaStream_t)stream>>>(
        (const int8_t*)bp, ustride, (const int*)best, (const int*)lengths, (int*)path,
        T, S, R, buf_ints, quirk);
  } else {
    trellis_backtrace_kernel<int><<<B, 32, smem, (cudaStream_t)stream>>>(
        (const int*)bp, ustride, (const int*)best, (const int*)lengths, (int*)path,
        T, S, R, buf_ints, quirk);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cs304_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
