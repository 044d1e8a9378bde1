// Banded sentence trellis for Hopper: the embedded trainer's forward Viterbi.
//
// Replaces cs304_tpu/ops/pallas/trellis_banded.py:_forward_banded_kernel.
// Semantics are bitwise those of the plain PyTorch version,
// cs304_tpu_torch/ops/viterbi.py:banded_sentence_forward (the forward half
// of models/train_fused.py:_banded_trellis_batch):
//   t = 0:   alpha[0] = log_b[b,0,0] + (isfinite(c0[b,0]) ? c0[b,0] : 0),
//            every other state -inf; backpointer row 0 is -1;
//   t >= 1:  cand2 = alpha[j-2] + c2[j], cand1 = alpha[j-1] + c1[j],
//            cand0 = alpha[j] + c0[j] (out-of-range predecessors -inf);
//            start from skip-2 and replace only on a strict >, so skip-2
//            wins ties, then skip-1, and an all -inf column points at
//            max(j-2, 0);
//   steps t >= length leave alpha unchanged but still write backpointers.
// The coefficients are per utterance (each aligns against its own sentence
// topology); there is no entry/exit pool. The backtrace is K2's
// (trellis_scanfree.cu), started from max(n_states - 1, 0).
//
// What bounds it on this card: the T-1 steps of an utterance are dependent,
// and a step is only three adds and two compares per state, so the forward
// is bound by the latency of the step chain (shared-memory reads of the
// previous row, one barrier), not by bytes or arithmetic. Bytes are log_b
// read once and backpointers written once (4 B each per cell), coalesced
// over states; at the training shape (B = 896, T = 160, S = 59) that is
// ~68 MB in all.
// What the design does about it: one block per utterance runs the whole
// time loop (no per-step launch, no global round trip for alpha), with alpha
// double-buffered in shared memory so a step needs a single __syncthreads.
// Threads stride over states and keep their states' c0/c1/c2 in registers
// for the whole run, loaded once; the next step's log_b row is loaded
// before the current step's arithmetic, so its global latency overlaps the
// step instead of lengthening the chain. All B blocks are resident at once
// at the training shape, which is how the card is filled.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int PER_THREAD = 8;  // 8192 states / 1024 threads

__global__ void __launch_bounds__(MAX_THREADS) trellis_banded_forward_kernel(
    const float* __restrict__ log_b, const float* __restrict__ c0,
    const float* __restrict__ c1, const float* __restrict__ c2,
    const int* __restrict__ lengths, float* __restrict__ alpha_out,
    int* __restrict__ bp, int T, int S) {
  extern __shared__ float smem[];
  const float neg = -__int_as_float(0x7f800000);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int length = lengths[b];
  const float* lb = log_b + (size_t)b * T * S;
  int* bpb = bp + (size_t)b * T * S;
  const size_t row = (size_t)b * S;

  float r0[PER_THREAD], r1[PER_THREAD], r2[PER_THREAD], nlb[PER_THREAD];
  float* cur = smem;
  float* nxt = smem + S;
  const float c00 = c0[row];
  const float a00 = isfinite(c00) ? c00 : 0.f;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int j = tid + k * nthr;
    const bool in = j < S;
    r0[k] = in ? c0[row + j] : neg;
    r1[k] = in ? c1[row + j] : neg;
    r2[k] = in ? c2[row + j] : neg;
    nlb[k] = (in && T > 1) ? lb[S + j] : 0.f;
    if (in) {
      cur[j] = j == 0 ? lb[0] + a00 : neg;
      bpb[j] = -1;
    }
  }
  __syncthreads();

  for (int t = 1; t < T; ++t) {
    const bool live = t < length;
    const bool more = t + 1 < T;
    const float* lb_next = lb + (size_t)(t + 1) * S;
    int* bp_t = bpb + (size_t)t * S;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int j = tid + k * nthr;
      if (j < S) {
        const float lbv = nlb[k];
        if (more) nlb[k] = lb_next[j];
        const float a0 = cur[j];
        const float a1 = j >= 1 ? cur[j - 1] : neg;
        const float a2 = j >= 2 ? cur[j - 2] : neg;
        const float cand1 = a1 + r1[k];
        const float cand0 = a0 + r0[k];
        float best = a2 + r2[k];
        int arg = max(j - 2, 0);
        if (cand1 > best) {
          best = cand1;
          arg = max(j - 1, 0);
        }
        if (cand0 > best) {
          best = cand0;
          arg = j;
        }
        nxt[j] = live ? best + lbv : a0;
        bp_t[j] = arg;
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int j = tid; j < S; j += nthr) alpha_out[row + j] = cur[j];
}

}  // namespace

extern "C" int cs304_trellis_banded_forward(
    const void* log_b, const void* c0, const void* c1, const void* c2,
    const void* lengths, void* alpha, void* bp, int B, int T, int S,
    void* stream) {
  if (S < 1 || S > MAX_THREADS * PER_THREAD) return (int)cudaErrorInvalidValue;
  int threads = ((S + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const size_t smem = 2 * (size_t)S * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        trellis_banded_forward_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  trellis_banded_forward_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)log_b, (const float*)c0, (const float*)c1,
      (const float*)c2, (const int*)lengths, (float*)alpha, (int*)bp, T, S);
  return (int)cudaGetLastError();
}
