// Dense composite Viterbi forward for Hopper: the (S, S) max-plus trellis.
//
// Replaces cs304_tpu/ops/pallas/trellis.py:_forward_kernel
// (viterbi_forward_pallas). Semantics are bitwise those of the plain PyTorch
// version, cs304_tpu_torch/ops/viterbi.py:dense_forward:
//   t = 0:   alpha = alpha0 (given); backpointer row 0 is -1;
//   t >= 1:  new[j] = max_i (alpha[i] + trans[i, j]) + log_b[b, t, j], the
//            argmax the FIRST i attaining the max (the scan starts at i = 0
//            and replaces only on a strict >, so an all -inf column points
//            at 0);
//   steps t >= length keep alpha but still write backpointers.
//
// What bounds it on this card: each step is S * S dependent compare-adds per
// utterance, against 8 bytes per (t, state) cell of log_b in and
// backpointers out. At the flagship decode (B = 512, T = 201, S = 58) that
// is ~0.69 G compare-adds against ~48 MB, so the bytes bound it (~14 us at
// 3.35 TB/s) on paper; in practice the T - 1 dependent steps of an
// utterance, each an S-long chain of compares per thread, set the time.
// What the design does about it: one block per utterance runs the whole
// time loop with alpha double-buffered in shared memory (one barrier per
// step); each thread owns destination states j, so the scan over i reads
// alpha[i] as a shared-memory broadcast and trans[i, j] at consecutive
// addresses across the warp. trans is staged in shared memory while
// S * S * 4 bytes fit (S <= 230 with the alpha buffers); past that its rows
// are read from L2, and every block reads all of trans every step, so at
// S = 503 the L2-to-SM traffic (1 MB per step per utterance) sets the
// time. The next step's log_b row is loaded before the current step's scan,
// so its latency overlaps the step.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int PER_THREAD = 8;  // 8192 states / 1024 threads
constexpr size_t SMEM_LIMIT = 227 * 1024;

__global__ void __launch_bounds__(MAX_THREADS) trellis_dense_forward_kernel(
    const float* __restrict__ log_b, const float* __restrict__ trans,
    const float* __restrict__ alpha0, const int* __restrict__ lengths,
    float* __restrict__ alpha_out, int* __restrict__ bp, int T, int S, int ld,
    int trans_in_smem) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int length = lengths[b];
  const float* lb = log_b + (size_t)b * T * ld;
  int* bpb = bp + (size_t)b * T * S;

  float* cur = smem;
  float* nxt = smem + S;
  const float* tr = trans;
  if (trans_in_smem) {
    float* ts = smem + 2 * S;
    for (int e = tid; e < S * S; e += nthr) ts[e] = trans[e];
    tr = ts;
  }
  float nlb[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int j = tid + k * nthr;
    nlb[k] = (j < S && T > 1) ? lb[ld + j] : 0.f;
    if (j < S) {
      cur[j] = alpha0[(size_t)b * S + j];
      bpb[j] = -1;
    }
  }
  __syncthreads();

  for (int t = 1; t < T; ++t) {
    const bool live = t < length;
    const bool more = t + 1 < T;
    const float* lb_next = lb + (size_t)(t + 1) * ld;
    int* bp_t = bpb + (size_t)t * S;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int j = tid + k * nthr;
      if (j < S) {
        const float lbv = nlb[k];
        if (more) nlb[k] = lb_next[j];
        float best = cur[0] + tr[j];
        int arg = 0;
        for (int i = 1; i < S; ++i) {
          const float v = cur[i] + tr[(size_t)i * S + j];
          if (v > best) {
            best = v;
            arg = i;
          }
        }
        nxt[j] = live ? best + lbv : cur[j];
        bp_t[j] = arg;
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int j = tid; j < S; j += nthr) alpha_out[(size_t)b * S + j] = cur[j];
}

}  // namespace

// log_b (B, T, ld >= S) f32; trans (S, S) f32 row-major (from, to);
// alpha0 (B, S) f32; lengths (B,) i32 -> alpha (B, S) f32, bp (B, T, S) i32.
extern "C" int cs304_trellis_dense_forward(
    const void* log_b, const void* trans, const void* alpha0,
    const void* lengths, void* alpha, void* bp, int B, int T, int S, int ld,
    void* stream) {
  if (S < 1 || S > MAX_THREADS * PER_THREAD || ld < S || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  int threads = ((S + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const size_t alpha_bytes = 2 * (size_t)S * sizeof(float);
  const size_t trans_bytes = (size_t)S * S * sizeof(float);
  const int trans_in_smem = alpha_bytes + trans_bytes <= SMEM_LIMIT;
  const size_t smem = alpha_bytes + (trans_in_smem ? trans_bytes : 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        trellis_dense_forward_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  trellis_dense_forward_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)log_b, (const float*)trans, (const float*)alpha0,
      (const int*)lengths, (float*)alpha, (int*)bp, T, S, ld, trans_in_smem);
  return (int)cudaGetLastError();
}
