// Quadratic-form Gaussian emissions on Hopper's tensor cores: the "high"
// (3 bf16 passes) and "default" (1 bf16 pass) precision tiers,
//   out[n, s] = cst[s] + A_n . W[:, s]  for s < S, 0 for S <= s < s_pad,
//   "high":    A_hi . W_hi + A_hi . W_lo + A_lo . W_hi,
//   "default": A_hi . W_hi,
// over K rows in groups of four (ops/cuda/emission.split_groups): the folded
// pairs x_i x_j (i <= j) built exactly in float32 on chip and split with
// round-to-nearest-even into hi = bf16(v), lo = bf16(v - float(hi)), against
// W = nhp_sym (the symmetric halves of nhp summed) split the same way; then
// the linear term: at "default" x_d against bf16(lin) in the same pass, at
// "high" at float32 accuracy as the six products of x's and lin's bf16
// thirds (x1 l1 + x1 l2 + x2 l1 + x2 l2 + x3 l1 + x1 l3, what
// Precision.HIGHEST runs on the TPU's MXU), riding the three passes as three
// sets of D rows. The constant is the accumulators' starting value.
//
// Replaces cs304_tpu/ops/pallas/emission.py:_emission_kernel_high (:157) and
// :_emission_kernel_blocked_high (:176) (helpers _split_hi_lo, _dot3), and
// _emission_kernel / _emission_kernel_blocked (:82, :129) at
// Precision.DEFAULT (one bf16 MXU pass, _dot_bf16).
//
// What bounds it on this card: at the main path (N = 512 * 201 frames,
// S = 58) the folded function is 3 x 2 x N x S x 780 = 27.9 GFLOP of bf16
// products at "high" (0.028 ms at 989 TFLOP/s) plus a 0.47 GFLOP float32
// linear term (0.007 ms at 67 TFLOP/s); "default" does one pass and is bound
// by its ~53 MB of frames in and emissions out (0.021 ms at 3.35 TB/s). On
// chip, the A build (two shared-memory reads and a multiply a value, for
// every frame and K row) costs more than the wgmmas it feeds at <= 128
// states, and the frames in and emissions out next.
// What the design does about it: a block holds one or two consumer
// warpgroups and a producer warpgroup and walks (frame group, state tile)
// tasks, a state tile being NB = 64, 128 or 256 states. Each consumer
// warpgroup owns MT 64-frame m-tiles and builds their A fragments in
// registers ONCE for all NB states of the tile: one wgmma m64nNBk16 per pass
// and m-tile covers them, so past 64 states x2 is no longer rebuilt per
// 64-state tile. A thread's four K rows of a step are one group (x_i times
// x_j0 .. x_j0+3): one scalar and one float4 shared-memory read a frame row,
// a quarter of the reads of a pair at a time. B is not resident: the
// producer streams the tile's folded operand (already in wgmma's
// core-matrix layout, 32 K rows = one contiguous chunk) into a shared-memory
// ring, as deep as shared memory holds (up to 16 stages: a copy from L2
// takes about a microsecond, longer than a 64-state stage's wgmmas), with
// bulk copies (cp.async.bulk) that complete on mbarriers; consumers release
// a stage once the wgmmas that read it are done. The producer warpgroup
// gives its registers to the consumers (setmaxnreg), whose 256-state
// accumulators take 128. Builds overlap wgmmas: a step's fragments are
// double-buffered, each step's wgmmas are committed as one group and only
// the step before is waited for (wgmma_wait<1>), so step k + 1's build runs
// under step k's products; the MT m-tiles' accumulators are independent
// chains, issued pass by pass. A task's frames are read with every load of
// a thread in flight at once; the epilogue stores from the accumulators.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WG_ROWS = 64;  // frames per m-tile (wgmma's M)
constexpr int DMAX = 64;     // largest feature dimension
constexpr int SMEM_MAX = 232448;
// A block's shared memory when two share an SM (228 KB, 1 KB reserved each).
constexpr int SMEM_HALF = 115712;
constexpr int KC = 32;       // K rows per ring stage: two wgmma K steps
constexpr int MAX_STAGES = 16;  // ring depth: as many stages as shared memory holds

// Frame-tile row stride (ops/cuda/emission.split_x_stride): >= D + 3 (x,
// then 1 and zeros up to the last group's float4), a multiple of 4 (float4
// reads) and 12 mod 32, so the eight rows of a lane column land on
// distinct banks.
__host__ __device__ constexpr int x_stride(int D) {
  return D + 3 + ((12 - (D + 3)) % 32 + 32) % 32;
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Shared memory of a block: the B ring of `stages` stages (hi, and lo at
// three passes), the ring's full and empty mbarriers, the pair table and
// each warpgroup's MT staged frame tiles.
template <int NB, int MT, int NWG, bool THREE>
struct Smem {
  static constexpr int half = KC * NB * 2;  // bytes of one half of a stage
  static constexpr int stage = half * (THREE ? 2 : 1);
  static constexpr int bars = 2 * MAX_STAGES * 8;
  static __host__ __device__ size_t fixed(int k_pad, int D) {
    return (size_t)bars + round16(k_pad) + (size_t)NWG * MT * WG_ROWS * x_stride(D) * 4;
  }
  // The deepest ring that fits (one consumer warpgroup: two blocks an
  // SM): a stage's bulk copy takes about a microsecond from L2, longer
  // than a 64-state stage's wgmmas.
  static __host__ __device__ int stages(int k_pad, int D) {
    const long room = ((long)(NWG == 1 ? SMEM_HALF : SMEM_MAX) - (long)fixed(k_pad, D)) / stage;
    return room < MAX_STAGES ? (int)room : MAX_STAGES;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A no-swizzle, K-major operand descriptor: 8 x 8 core matrices of 128
// contiguous bytes, the next core matrix along K 16 * n bytes on (leading
// byte offset), the next along the states 128 bytes on (stride byte offset).
__device__ __forceinline__ uint64_t make_desc(const void* smem, int n) {
  return (uint64_t)((smem_u32(smem) >> 4) & 0x3FFF) | ((uint64_t)n << 16) |
         ((uint64_t)8 << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy global -> shared whose bytes complete on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127},"
        " {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// One step's A fragments from the thread's group descriptor (i | j0 << 8 |
// flag << 16, ops/cuda/emission.split_groups): rows r and r + 8 of the
// warp's 16 (x0, x1) times K rows c, c + 1, c + 8, c + 9 of the step, which
// hold the group's values t = 0, 1, 2, 3: x[i] * x[j0 + t], one scalar and
// one float4 read a row; split into bf16 hi and (at three passes) lo. LIN:
// the step may hold the "high" tier's linear groups, whose flag makes the
// value its bf16 rounding (1) or the residual from it (2).
template <bool THREE, bool LIN>
__device__ __forceinline__ void build_a(uint32_t desc, const float* x0, const float* x1,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int i = desc & 0xffu;
  const int j0 = (desc >> 8) & 0xffu;
  const float a[2] = {x0[i], x1[i]};
  const float4 b[2] = {*reinterpret_cast<const float4*>(x0 + j0),
                       *reinterpret_cast<const float4*>(x1 + j0)};
#pragma unroll
  for (int r = 0; r < 4; ++r) {  // register r: row r & 1, values t = (r >> 1) * 2 + {0, 1}
    const int h = r & 1;
    float v0 = a[h] * (r < 2 ? b[h].x : b[h].z);
    float v1 = a[h] * (r < 2 ? b[h].y : b[h].w);
    if (LIN) {
      const uint32_t flag = desc >> 16;
      const float r0 = __bfloat162float(__float2bfloat16_rn(v0));
      const float r1 = __bfloat162float(__float2bfloat16_rn(v1));
      v0 = flag == 1u ? r0 : flag == 2u ? v0 - r0 : v0;
      v1 = flag == 1u ? r1 : flag == 2u ? v1 - r1 : v1;
    }
    const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
    hi[r] = *reinterpret_cast<const uint32_t*>(&hv);
    if (THREE) {
      const float2 hf = __bfloat1622float2(hv);
      const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
      lo[r] = *reinterpret_cast<const uint32_t*>(&l);
    }
  }
}

// The step's fragments of every m-tile; steps that reach the "high" tier's
// linear groups (rows from k_lin on) take the flagged build.
template <int MT, bool THREE>
__device__ __forceinline__ void build_step(bool lin, uint32_t desc, const float* (&x0)[MT],
                                           const float* (&x1)[MT], uint32_t (&hi)[MT][4],
                                           uint32_t (&lo)[MT][4]) {
  if (THREE && lin) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) build_a<THREE, true>(desc, x0[mt], x1[mt], hi[mt], lo[mt]);
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) build_a<THREE, false>(desc, x0[mt], x1[mt], hi[mt], lo[mt]);
  }
}

// Registers a thread of each role: the producer warpgroup gives its
// registers up (setmaxnreg) so the consumers' accumulators fit.
constexpr int PRODUCER_REGS = 24;
__host__ __device__ constexpr int consumer_regs(int nwg) {
  return nwg == 1 ? 232 : nwg == 2 ? 240 : 160;
}

// STAGE: 0 the kernel; timing variants that isolate one stage of it:
// 1 the A build alone (no wgmma), 2 the wgmmas alone on a constant
// fragment (no build), 3 without the "high" tier's linear rows, 4 the
// frames in and the emissions out alone (no K loop).
template <int NB, int MT, int NWG, bool THREE, int STAGE>
__global__ void __launch_bounds__(128 * (NWG + 1), NWG == 1 ? 2 : 1) emission_split_kernel(
    const float* __restrict__ frames, const __nv_bfloat16* __restrict__ w_hi,
    const __nv_bfloat16* __restrict__ w_lo, const int32_t* __restrict__ groups,
    const float* __restrict__ cst, float* __restrict__ out, int M, int D, int S, int s_pad,
    int k_pad, int k_lin, int n_live, int n_tasks) {
  using L = Smem<NB, MT, NWG, THREE>;
  constexpr int R = NB / 2;  // accumulator registers of one m-tile
  extern __shared__ __align__(128) unsigned char smem[];
  const int STAGES = L::stages(k_pad, D);
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)STAGES * L::stage);
  uint64_t* empty = full + MAX_STAGES;
  int32_t* p_groups = reinterpret_cast<int32_t*>(full + 2 * MAX_STAGES);
  float* xs_all = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(p_groups) +
                                           round16(k_pad));
  const int XS = x_stride(D);
  const int tid = threadIdx.x;
  const int nchunks = STAGE == 4 ? 0 : STAGE == 3 ? (k_lin + KC - 1) / KC : k_pad / KC;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < k_pad / 4; e += blockDim.x) p_groups[e] = groups[e];
  __syncthreads();

  if (tid >= 128 * NWG) {  // the producer warpgroup: one thread streams B
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 128 * NWG) {
      uint32_t g = 0;  // chunks issued, over all of the block's tasks
      for (int task = blockIdx.x; task < n_tasks; task += gridDim.x) {
        const size_t base = (size_t)(task % n_live) * k_pad * NB;
        for (int c = 0; c < nchunks; ++c, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(&empty[s], (g / STAGES - 1) & 1);
          mbar_expect_tx(&full[s], L::stage);
          unsigned char* dst = ring + s * L::stage;
          const size_t off = base + (size_t)c * KC * NB;
          bulk_load(dst, w_hi + off, L::half, &full[s]);
          if (THREE) bulk_load(dst + L::half, w_lo + off, L::half, &full[s]);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(consumer_regs(NWG)));
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int warp = wt >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;
  const int c = (lane & 3) * 2;  // the accumulator's first column
  float* xs = xs_all + wg * MT * WG_ROWS * XS;
  const uint32_t* gw = reinterpret_cast<const uint32_t*>(p_groups);
  const int q = lane & 3;  // the lane quad's group of each step
  const float* x0[MT];
  const float* x1[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    x0[mt] = xs + (mt * WG_ROWS + warp * 16 + g8) * XS;
    x1[mt] = x0[mt] + 8 * XS;
  }
  const int dead0 = n_live * NB;  // columns past the live tiles: all zero
  const bool aligned = (reinterpret_cast<uintptr_t>(frames) & 15) == 0;
  uint32_t g = 0;                 // chunks consumed, as the producer counts them

  for (int task = blockIdx.x; task < n_tasks; task += gridDim.x) {
    const int tile = task % n_live;
    const int s0 = tile * NB;
    const int m_base = ((task / n_live) * NWG + wg) * MT * WG_ROWS;

    // The warpgroup's frames, with x[D] = 1 and zeros past it: one
    // contiguous run of MT * 64 * D floats (16-byte aligned when frames
    // is: 64 * D floats a tile), all of a thread's float4 loaded into
    // registers before any is stored, so the whole tile is in flight at
    // once (the accumulators are not live yet).
    bar_sync(1 + wg);  // done with the last task's frames
    {
      constexpr int Q = MT * WG_ROWS * DMAX / 4 / 128;  // float4 a thread at most
      const int rows = min(max(M - m_base, 0), MT * WG_ROWS);
      const int lim = rows * D;
      const float* src = frames + (size_t)m_base * D;
      const int n4 = MT * WG_ROWS * D / 4;
      float4 v[Q];
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        const int q = wt + 128 * u;
        if (aligned && 4 * q + 3 < lim) {
          v[u] = __ldg(reinterpret_cast<const float4*>(src) + q);
        } else {
          float t[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) t[k] = 4 * q + k < lim ? __ldg(src + 4 * q + k) : 0.f;
          v[u] = make_float4(t[0], t[1], t[2], t[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        const int q = wt + 128 * u;
        if (q < n4) {
          const float t[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int e = 4 * q + k;
            const int m = e / D;
            xs[m * XS + e - m * D] = t[k];
          }
        }
      }
      for (int e = wt; e < MT * WG_ROWS * (XS - D); e += 128) {
        const int m = e / (XS - D);
        const int col = D + e - m * (XS - D);
        xs[m * XS + col] = col == D ? 1.f : 0.f;
      }
    }
    bar_sync(1 + wg);

    // Accumulators start at the constant (float32). Element 4j + {0, 1}
    // is row r0, columns 8j + c + {0, 1}; 4j + {2, 3} the same columns of
    // row r0 + 8. Columns at or past s_pad (the last tile's padding) read
    // column s_pad - 2, never stored.
    float acc[MT][R];
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int s = min(s0 + 8 * j + c, s_pad - 2);
      const float2 cv = __ldg(reinterpret_cast<const float2*>(cst + s));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][4 * j] = acc[mt][4 * j + 2] = cv.x;
        acc[mt][4 * j + 1] = acc[mt][4 * j + 3] = cv.y;
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);

    // K in ring chunks of two steps. A step: build its fragments (the
    // other buffer's wgmmas may still run) from pair words read a step
    // ahead, fence, issue every pass of every m-tile as one commit group,
    // then wait for all but this group: the step before is done, so its
    // fragments and, after a chunk's last step, its stage are free.
    uint32_t h[2][MT][4], l[2][MT][4];
    uint32_t sink = 0;
    uint32_t desc = gw[q];  // step 0's group
    if (STAGE == 2) {  // one constant fragment for every step
#pragma unroll
      for (int u = 0; u < 2; ++u) build_step<MT, THREE>(false, desc, x0, x1, h[u], l[u]);
    }
    const int nsteps = nchunks * 2;
    for (int cidx = 0; cidx < nchunks; ++cidx, ++g) {
      const int st = g % STAGES;
      mbar_wait(&full[st], (g / STAGES) & 1);
      const unsigned char* stage = ring + st * L::stage;
      const uint64_t d_hi = make_desc(stage, NB);
      const uint64_t d_lo = make_desc(stage + L::half, NB);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int step = cidx * 2 + u;
        if (STAGE != 2) {
          build_step<MT, THREE>(step * 16 + 16 > k_lin, desc, x0, x1, h[u], l[u]);
          if (step + 1 < nsteps) desc = gw[(step + 1) * 4 + q];
        }
        if (STAGE == 1) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int r = 0; r < 4; ++r) sink ^= h[u][mt][r] ^ (THREE ? l[u][mt][r] : 0u);
        } else {
          wgmma_fence();
          const uint64_t off = (uint64_t)u * 2 * NB;  // one K step, in 16-byte units
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) Wgmma<NB>::mma(acc[mt], h[u][mt], d_hi + off);
          if (THREE) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) Wgmma<NB>::mma(acc[mt], h[u][mt], d_lo + off);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) Wgmma<NB>::mma(acc[mt], l[u][mt], d_hi + off);
          }
          wgmma_commit();
          wgmma_wait<1>();
        }
        // The last chunk's wgmmas are done: release its stage.
        if (u == 0 && cidx > 0 && lane == 0) mbar_arrive(&empty[(g - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    if (lane == 0) mbar_arrive(&empty[(g - 1) % STAGES]);
    if (STAGE == 1 && sink == 0x9e3779b9u) acc[0][0] += 1.f;  // keeps the build

    // Epilogue: zeros past S, float2 stores, nothing at or past s_pad.
    const int r0 = warp * 16 + g8;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m_base + mt * WG_ROWS + r0 + 8 * hh;
        if (m >= M) continue;
        float* row = out + (size_t)m * s_pad;
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          const int s = s0 + 8 * j + c;
          const int a = 4 * j + 2 * hh;
          if (s < s_pad)
            *reinterpret_cast<float2*>(row + s) =
                make_float2(s < S ? acc[mt][a] : 0.f, s + 1 < S ? acc[mt][a + 1] : 0.f);
        }
      }
    if (tile == 0 && dead0 < s_pad) {  // the state tiles past S, once a row
      const int w4 = (s_pad - dead0) / 4;
      for (int e = wt; e < MT * WG_ROWS * w4; e += 128) {
        const int m = m_base + e / w4;
        if (m < M)
          *reinterpret_cast<float4*>(out + (size_t)m * s_pad + dead0 + 4 * (e % w4)) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

template <int NB, int MT, int NWG, bool THREE, int STAGE>
int launch(const void* frames, const void* w_hi, const void* w_lo, const void* groups,
           const void* cst, void* out, int M, int D, int S, int s_pad, int k_pad, int k_lin,
           cudaStream_t stream) {
  using L = Smem<NB, MT, NWG, THREE>;
  const int stages = L::stages(k_pad, D);
  if (stages < 3) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)stages * L::stage + L::fixed(k_pad, D);
  auto kernel = emission_split_kernel<NB, MT, NWG, THREE, STAGE>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 128 * (NWG + 1),
                                                         bytes)) != cudaSuccess)
    return (int)e;
  // Tasks: (group of NWG * MT m-tiles, live state tile), the state tile
  // fastest; as many blocks as run at once, each striding over them.
  const int n_live = (S + NB - 1) / NB;
  const int frame_groups = (M + NWG * MT * WG_ROWS - 1) / (NWG * MT * WG_ROWS);
  const int n_tasks = frame_groups * n_live;
  int grid = (per_sm < 1 ? 1 : per_sm) * sms;
  grid = grid < n_tasks ? grid : n_tasks;
  kernel<<<grid, 128 * (NWG + 1), bytes, stream>>>(
      (const float*)frames, (const __nv_bfloat16*)w_hi, (const __nv_bfloat16*)w_lo,
      (const int32_t*)groups, (const float*)cst, (float*)out, M, D, S, s_pad, k_pad, k_lin,
      n_live, n_tasks);
  return (int)cudaGetLastError();
}

// A state tile's block shape: MT m-tiles of 64 frames a consumer
// warpgroup, NWG consumer warpgroups a block.
template <int NB>
struct Shape;
template <>
struct Shape<64> {
  static constexpr int MT = 4, NWG = 2;
};
template <>
struct Shape<128> {
  static constexpr int MT = 2, NWG = 1;
};
template <>
struct Shape<256> {
  static constexpr int MT = 1, NWG = 2;
};

// The state tile's kernel and each stage variant.
template <int NB>
int dispatch(int passes, int stage, const void* frames, const void* w_hi, const void* w_lo,
             const void* groups, const void* cst, void* out, int M, int D, int S, int s_pad,
             int k_pad, int k_lin, cudaStream_t st) {
  constexpr int MT = Shape<NB>::MT, NWG = Shape<NB>::NWG;
#define CS304_SPLIT(ST)                                                                     \
  if (stage == ST)                                                                          \
    return passes == 3 ? launch<NB, MT, NWG, true, ST>(frames, w_hi, w_lo, groups, cst, out, \
                                                       M, D, S, s_pad, k_pad, k_lin, st)     \
                       : launch<NB, MT, NWG, false, ST>(frames, w_hi, w_lo, groups, cst,     \
                                                        out, M, D, S, s_pad, k_pad, k_lin,   \
                                                        st);
  CS304_SPLIT(0)
  CS304_SPLIT(1)
  CS304_SPLIT(2)
  if (passes == 3 && stage == 3)
    return launch<NB, MT, NWG, true, 3>(frames, w_hi, w_lo, groups, cst, out, M, D, S, s_pad,
                                        k_pad, k_lin, st);
  CS304_SPLIT(4)
#undef CS304_SPLIT
  return (int)cudaErrorInvalidValue;
}

template <int NB>
int ring_stages(int D, int k_pad, bool three) {
  using S = Shape<NB>;
  return three ? Smem<NB, S::MT, S::NWG, true>::stages(k_pad, D)
               : Smem<NB, S::MT, S::NWG, false>::stages(k_pad, D);
}

}  // namespace

// frames (N, D) f32; w_hi, w_lo (cols / n_tile, k_pad * n_tile) bf16 and
// groups (k_pad / 4,) int32 from fold_quad_params (w_lo unused when passes
// == 1; cols = s_pad rounded up to n_tile; k_lin its first linear row:
// the linear term rides the K rows); cst (s_pad,) f32; out (N, s_pad) f32.
// Requires 1 <= D <= 64, S <= s_pad, s_pad a multiple of 64, k_pad of 32,
// k_lin of 4, n_tile in {64, 128, 256}, passes in {1, 3}, the folded
// tensors 16-byte aligned. stage: 0, or a timing variant.
extern "C" int cs304_emission_split(
    const void* frames, const void* w_hi, const void* w_lo, const void* groups,
    const void* cst, void* out, int N, int D, int S, int s_pad, int k_pad, int k_lin,
    int n_tile, int passes, int stage, void* stream) {
  if (D < 1 || D > DMAX || N < 1 || S < 1 || S > s_pad || s_pad % 64 || k_pad % KC ||
      k_lin % 4 || k_lin < 0 || k_lin > k_pad || (passes != 1 && passes != 3) || stage < 0 ||
      stage > 4)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define CS304_TILE(NB)                                                                   \
  if (n_tile == NB)                                                                      \
    return dispatch<NB>(passes, stage, frames, w_hi, w_lo, groups, cst, out, N, D, S, s_pad, \
                        k_pad, k_lin, st);
  CS304_TILE(64)
  CS304_TILE(128)
  CS304_TILE(256)
#undef CS304_TILE
  return (int)cudaErrorInvalidValue;
}

// The B ring's stages a launch at these operands gets (it refuses fewer
// than 3), or -1 for an n_tile or passes it does not take.
extern "C" int cs304_emission_split_stages(int n_tile, int D, int k_pad, int passes) {
  if ((passes != 1 && passes != 3) || D < 1 || D > DMAX || k_pad < 0) return -1;
  if (n_tile == 64) return ring_stages<64>(D, k_pad, passes == 3);
  if (n_tile == 128) return ring_stages<128>(D, k_pad, passes == 3);
  if (n_tile == 256) return ring_stages<256>(D, k_pad, passes == 3);
  return -1;
}
