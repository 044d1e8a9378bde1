// Scan-free composite Viterbi for Hopper: forward trellis + backtrace.
//
// Replaces cs304_tpu/ops/pallas/trellis_scanfree.py:_forward_kernel and
// :_backtrace_kernel. Semantics are bitwise those of the plain PyTorch
// version, cs304_tpu_torch/ops/viterbi.py:viterbi_composite_batch_fast:
//   non-entry j:  max over (j-2, j-1, j) banded predecessors, ties resolved
//                 skip-2, then skip-1, then self (all on >=);
//   entry e:      max(best exit + penalty, self-loop), an exit winning an
//                 exact tie; among exits the lowest state index wins, and
//                 when every exit is -inf the index is 0;
//   steps t >= length leave alpha unchanged but still write backpointers.
//
// What bounds it on this card: the T-1 steps are sequential, and each step
// is O(S) adds and compares plus one block-wide (value, index) reduction, so
// the forward is latency-bound per utterance; the card is filled by running
// one block per utterance (B blocks) rather than by parallelism inside a step.
// Bytes are log_b read once (4 B/cell) and backpointers written once
// (4 B/cell), coalesced over states.
// What the design does about it: the whole time loop runs inside one block
// with alpha double-buffered in shared memory (no per-step launch, no global
// round trip), threads stride over states, and the best-exit reduction is a
// warp shuffle plus one shared-memory pass over at most 32 warp results.
// The backtrace is one thread per utterance walking its backpointers in
// reverse; it reads T ints per utterance and is bound by that dependent
// chain of loads.
#include <cuda_runtime.h>

#include <climits>

namespace {

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// coefs rows (each of length S): 0 diag_ne, 1 sub1, 2 sub2, 3 diag_e,
// 4 is_entry (1/0), 5 is_exit (1/0), 6 diag_init, 7 unused.
__global__ void trellis_forward_kernel(
    const float* __restrict__ log_b, const float* __restrict__ coefs,
    float penalty, const int* __restrict__ lengths,
    float* __restrict__ alpha_out, int* __restrict__ bp,
    int T, int S, int ld) {
  extern __shared__ float smem[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];

  const float neg = -__int_as_float(0x7f800000);
  const float* diag_ne = coefs;
  const float* sub1 = coefs + S;
  const float* sub2 = coefs + 2 * S;
  const float* diag_e = coefs + 3 * S;
  const float* is_entry = coefs + 4 * S;
  const float* is_exit = coefs + 5 * S;
  const float* diag_init = coefs + 6 * S;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int length = lengths[b];
  const size_t lb_base = (size_t)b * T * ld;
  const size_t bp_base = (size_t)b * T * S;

  float* cur = smem;
  float* nxt = smem + S;
  for (int j = tid; j < S; j += nthr) {
    cur[j] = is_entry[j] > 0.f ? log_b[lb_base + j] + diag_init[j] : neg;
    bp[bp_base + j] = -1;
  }
  __syncthreads();

  for (int t = 1; t < T; ++t) {
    float bv = neg;
    int bi = INT_MAX;
    for (int j = tid; j < S; j += nthr) {
      if (is_exit[j] > 0.f && better(cur[j], j, bv, bi)) {
        bv = cur[j];
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    bv = red_v[0];
    bi = red_i[0];
    for (int w = 1; w < nwarps; ++w) {
      if (better(red_v[w], red_i[w], bv, bi)) {
        bv = red_v[w];
        bi = red_i[w];
      }
    }
    // Every exit at -inf: the reference's first-max runs over all states,
    // which then all tie, so the winner is state 0.
    if (!(bv > neg)) bi = 0;

    const bool live = t < length;
    const float c_pen = bv + penalty;
    const float* lb_t = log_b + lb_base + (size_t)t * ld;
    int* bp_t = bp + bp_base + (size_t)t * S;
    for (int j = tid; j < S; j += nthr) {
      const float a0 = cur[j];
      float val;
      int arg;
      if (is_entry[j] > 0.f) {
        const float c_self = a0 + diag_e[j];
        val = fmaxf(c_pen, c_self);
        arg = c_pen >= c_self ? bi : j;
      } else {
        const float a1 = j >= 1 ? cur[j - 1] : neg;
        const float a2 = j >= 2 ? cur[j - 2] : neg;
        const float c0 = a0 + diag_ne[j];
        const float c1 = a1 + sub1[j];
        const float c2 = a2 + sub2[j];
        const float v12 = fmaxf(c1, c0);
        val = fmaxf(c2, v12);
        arg = c2 >= v12 ? max(j - 2, 0) : (c1 >= c0 ? max(j - 1, 0) : j);
      }
      const float na = val + lb_t[j];
      nxt[j] = live ? na : a0;
      bp_t[j] = arg;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int j = tid; j < S; j += nthr) alpha_out[(size_t)b * S + j] = cur[j];
}

__global__ void trellis_backtrace_kernel(
    const int* __restrict__ bp, const int* __restrict__ best,
    const int* __restrict__ lengths, int* __restrict__ path,
    int B, int T, int S, int quirk) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int length = lengths[b];
  const int* bp_b = bp + (size_t)b * T * S;
  int* p = path + (size_t)b * T;
  int state = best[b];
  for (int t = T - 1; t >= 1; --t) {
    p[t] = state;  // emitted before stepping: entries past length hold the start
    if (t <= length - 1) state = bp_b[(size_t)t * S + state];
  }
  p[0] = state;
  if (quirk) {
    // Reference parity: the final frame repeats the one before it.
    const int last = max(length - 1, 0);
    const int second = min(max(length - 2, 0), T - 1);
    if (last < T) p[last] = p[second];
  }
}

}  // namespace

extern "C" int cs304_trellis_forward(
    const void* log_b, const void* coefs, float penalty, const void* lengths,
    void* alpha, void* bp, int B, int T, int S, int ld, void* stream) {
  int threads = ((S + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = 2 * (size_t)S * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        trellis_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  trellis_forward_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)log_b, (const float*)coefs, penalty, (const int*)lengths,
      (float*)alpha, (int*)bp, T, S, ld);
  return (int)cudaGetLastError();
}

extern "C" int cs304_trellis_backtrace(
    const void* bp, const void* best, const void* lengths, void* path,
    int B, int T, int S, int quirk, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  trellis_backtrace_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)bp, (const int*)best, (const int*)lengths, (int*)path,
      B, T, S, quirk);
  return (int)cudaGetLastError();
}

extern "C" const char* cs304_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
