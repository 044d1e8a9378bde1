// Multi-template dynamic time warping, the column recursion, for Hopper.
//
// Replaces cs304_tpu/ops/dtw.py:dtw_multi_template (a lax.scan over the
// sample's columns; the JAX package has no Pallas kernel of it). Plain
// version: cs304_tpu_torch/ops/dtw.py:dtw_columns_plain:
//   dist (L, H) f32, column-major: row j holds sample frame j's distance to
//   each of the H concatenated template frames; is_first / is_second (H,)
//   u8 mark each word's first and second template row; end_rows (W,) i32.
//   prev = +inf (H rows), prev_min = +inf; for j = 0 .. L-1:
//     boundary = 0 at j = 0, else +inf (a word is entered only at column 0)
//     diag[r]  = is_first[r] ? boundary : prev[r-1]
//     super[r] = is_first[r] ? +inf : is_second[r] ? boundary : prev[r-2]
//     new[r]   = dist[j, r] + min(prev[r], min(diag[r], super[r]))
//     pruning: new[r] = +inf where new[r] > prev_min * (1 + pruning_factor)
//              (f32: the factor's sum first, then the product)
//     prev_min = min over r of new; prev = new
//   out[w] = prev[end_rows[w]].
// Row 0 is always a word's first row and row 1 its second row or the next
// word's first, so the rows r-1 < 0 and r-2 < 0 that the JAX scan reads
// through jnp.roll's wraparound are always masked; the kernel never reads
// them. Every operation is a min, a compare or one f32 add, so the kernel
// is bitwise its plain version.
//
// Design. One CTA of up to 1024 threads takes the sample. Each thread holds
// ROWS contiguous template rows (ROWS = 1, 2, 4 or 8, the least that
// covers H with 1024 threads, so H <= 8192) of the previous column in registers, with its rows'
// is_first / is_second bits as two masks. A column step reads the
// neighbour's two last previous-column values (rows r0-1 and r0-2) and
// every warp's previous-column minimum from shared memory, updates its rows
// in registers, folds its minimum over the warp with shuffles, and
// publishes its two last values and (lane 0) the warp minimum into the
// other half of a double buffer: ONE __syncthreads a column. The next
// column's distances are loaded before the step, off the chain. At the end
// the final column goes to a scratch row of H floats and the CTA gathers
// end_rows from it.
//
// What bounds it on this card: the H * L distances read once (bytes), far
// below the serial floor of L dependent column steps, each one barrier, a
// warp-shuffle reduction and a 32-value shared-memory pass. One CTA keeps
// one SM busy: a batch of samples would take one CTA each.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_ROWS = 8;

template <int ROWS>
__global__ void __launch_bounds__(MAX_THREADS) dtw_kernel(
    const float* __restrict__ dist, const uint8_t* __restrict__ is_first,
    const uint8_t* __restrict__ is_second, const int* __restrict__ end_rows,
    float* __restrict__ col, float* __restrict__ out, int H, int L, int W,
    int pruning, float pruning_factor) {
  __shared__ float s_last[2][MAX_THREADS];   // row r0 + ROWS - 1
  __shared__ float s_last2[2][MAX_THREADS];  // row r0 + ROWS - 2
  __shared__ float s_wmin[2][MAX_THREADS / 32];
  const float INF = __int_as_float(0x7f800000);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int r0 = tid * ROWS;

  unsigned first = 0, second = 0;
  float prev[ROWS], d[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + i;
    if (r < H) {
      first |= (unsigned)(is_first[r] != 0) << i;
      second |= (unsigned)(is_second[r] != 0) << i;
    }
    prev[i] = INF;
    d[i] = r < H ? dist[r] : INF;
  }
  s_last[0][tid] = INF;
  s_last2[0][tid] = INF;
  if (lane == 0) s_wmin[0][warp] = INF;
  const float scale = 1.0f + pruning_factor;

  int buf = 0;
  for (int j = 0; j < L; ++j) {
    __syncthreads();
    float prev_min = INF;
    for (int w = 0; w < n_warps; ++w) prev_min = fminf(prev_min, s_wmin[buf][w]);
    const float p1 = tid >= 1 ? s_last[buf][tid - 1] : INF;  // row r0 - 1
    const float p2 = ROWS >= 2 ? (tid >= 1 ? s_last2[buf][tid - 1] : INF)
                               : (tid >= 2 ? s_last[buf][tid - 2] : INF);  // row r0 - 2
    float dn[ROWS];
    if (j + 1 < L) {
      const float* next = dist + (size_t)(j + 1) * H;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) dn[i] = r0 + i < H ? next[r0 + i] : INF;
    }
    const float boundary = j == 0 ? 0.f : INF;
    const float threshold = prev_min * scale;
    float m = INF;
    // Descending, so prev[i - 1] and prev[i - 2] still hold the previous
    // column when row i is updated in place.
#pragma unroll
    for (int i = ROWS - 1; i >= 0; --i) {
      const float r1 = i >= 1 ? prev[i >= 1 ? i - 1 : 0] : p1;
      const float r2 = i >= 2 ? prev[i >= 2 ? i - 2 : 0] : (i == 1 ? p1 : p2);
      const bool f = (first >> i) & 1u;
      const float diag = f ? boundary : r1;
      const float sup = f ? INF : (((second >> i) & 1u) ? boundary : r2);
      float v = d[i] + fminf(prev[i], fminf(diag, sup));
      if (pruning && v > threshold) v = INF;
      prev[i] = v;
      m = fminf(m, v);
      if (j + 1 < L) d[i] = dn[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(FULL, m, off));
    buf ^= 1;
    s_last[buf][tid] = prev[ROWS - 1];
    s_last2[buf][tid] = ROWS >= 2 ? prev[ROWS >= 2 ? ROWS - 2 : 0] : INF;
    if (lane == 0) s_wmin[buf][warp] = m;
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    if (r0 + i < H) col[r0 + i] = prev[i];
  __syncthreads();
  for (int w = tid; w < W; w += blockDim.x) out[w] = col[end_rows[w]];
}

template <int ROWS>
cudaError_t launch(int threads, const void* dist, const void* is_first,
                   const void* is_second, const void* end_rows, void* col, void* out,
                   int H, int L, int W, int pruning, float pruning_factor,
                   cudaStream_t stream) {
  dtw_kernel<ROWS><<<1, threads, 0, stream>>>(
      (const float*)dist, (const uint8_t*)is_first, (const uint8_t*)is_second,
      (const int*)end_rows, (float*)col, (float*)out, H, L, W, pruning, pruning_factor);
  return cudaGetLastError();
}

// Rows a thread holds for H template rows: the least power of two that
// covers H with MAX_THREADS threads, or 0 past MAX_THREADS * MAX_ROWS.
int rows_a_thread(int H) {
  for (int rows = 1; rows <= MAX_ROWS; rows *= 2)
    if ((long long)rows * MAX_THREADS >= H) return rows;
  return 0;
}

}  // namespace

// dist (L, H) f32, is_first / is_second (H,) u8, end_rows (W,) i32 in
// [0, H); col (H,) f32 scratch; out (W,) f32. 1 <= H <= 8192, L >= 1.
extern "C" int cs304_dtw(const void* dist, const void* is_first, const void* is_second,
                         const void* end_rows, void* col, void* out, int H, int L, int W,
                         int pruning, float pruning_factor, void* stream) {
  const int rows = rows_a_thread(H);
  if (rows == 0 || H < 1 || L < 1 || W < 0) return (int)cudaErrorInvalidValue;
  const int threads = ((H + rows - 1) / rows + 31) / 32 * 32;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
#define CS304_DTW_CASE(R)                                                              \
  case R:                                                                              \
    return (int)launch<R>(threads, dist, is_first, is_second, end_rows, col, out, H, \
                          L, W, pruning, pruning_factor, s);
    CS304_DTW_CASE(1)
    CS304_DTW_CASE(2)
    CS304_DTW_CASE(4)
    CS304_DTW_CASE(8)
#undef CS304_DTW_CASE
  }
  return (int)cudaErrorInvalidValue;
}
