// MMSE/Wiener frequency interpolation: H_full (B, Nsc) = H_pilot (B, Np) @ W (Np, Nsc),
// complex64 in and out, on the tensor cores in 3xTF32.
//
// Replaces: src/repro/kernels/mmse_interp/mmse_interp.py::mmse_interp_2d (Pallas TPU
// kernel _mmse_interp_kernel, both its forms), reached through ops.py::mmse_interp.
// Called from src/repro_torch/kernels/mmse_interp/ops.py::mmse_interp:
// mmse_interp_gauss_launch for use_gauss=True (the default, as the reference's:
// the slot loop, the host loop and phy/estimators.py::mmse_estimate take it) and
// mmse_interp_launch for use_gauss=False.
//
// What bounds it on the H100: arithmetic.  At the paper's slot (Np = 636, Nsc = 1272)
// and the closed loop's B = 384 rows (32 UEs x 4 antennas x 3 DMRS symbols) the
// product is 1.86 GFLOP in the Gauss form, against 6.5 MB of W (resident in the 50 MB
// L2) and 5.9 MB of H in and out: far above the ridge point.  On the CUDA cores that
// is 27.8 us at 67 TFLOP/s; the earlier form of this kernel, a tiled fp32 SGEMM there,
// took 126 us, slower than torch.matmul's complex GEMM.  In 3xTF32 the cheapest form,
// the Gauss form, is 5.59 GFLOP of TF32 work, bound at 11.3 us by 495 TFLOP/s; the
// 4-multiply form does 7.45 GFLOP, 15.1 us at the same rate.  Both forms are here;
// at 384 rows they take 49.9 and 50.3 us of device time (PERF.md): the staging and
// latency bound this design, not the tensor cores.
//
// Design.
//
// * Tensor cores without TF32's rounding: every operand x is split into
//   hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: round to nearest, ties away), and
//   every product is lo*hi + hi*lo + hi*hi (3xTF32).  The dropped lo*lo term and
//   the rounding of lo are ~2^-22 of each product, so no product is rounded to 10
//   bits and the port's "TF32 off" contract keeps its meaning.
// * The accumulation.  The tensor core adds into its float32 accumulator with
//   truncation, not round-to-nearest, so a running sum over all 2 Np real k slots
//   drifts by up to an ulp per k8 step, one way.  The first form of this kernel, one
//   accumulator over every k-tile, read 2.1e-5 to 3.0e-5 against the plain version
//   at n_prb 106 on the card, ten times the plain version's own error against a
//   complex128 product.  So each k-tile of 16 pilots starts a fresh tensor-core
//   accumulator, takes its lo terms first (small, while the accumulator is small),
//   then its hi*hi terms, and is added to a float32 register sum on the CUDA cores,
//   rounded to nearest, tile after tile: the truncating chain is 12 wgmmas long
//   instead of 480.  tests/test_torch_kernels.py emulates this order, with
//   truncation at each k8 step, against repro at n_prb 106: within MMSE_TOL, at a
//   fifteenth of the one accumulator's error, where a single TF32 pass misses
//   MMSE_TOL.  On the card it reads 4e-7 to 1.3e-6 against a complex128 product
//   from n_prb 24 to 273, at or below the plain float32 version's own 8e-7 to
//   5.9e-6 (PERF.md).
// * The complex product as one real GEMM read from the interleaved layout:
//       [re im] (B x 2Nsc) = [Hr Hi] (B x 2Np) @ [[Wr Wi], [-Wi Wr]] (2Np x 2Nsc)
//   (the 4-multiply form, 12 TF32 GEMM-equivalents).  A k8 step covers four complex
//   pilots: real k slot s < 4 holds Re h[k + s] and slot s + 4 holds Im h[k + s], and
//   the output's real column pair (2n, 2n + 1) is (re, im) of subcarrier n, so each
//   accumulator pair is one complex output.
// * wgmma: one warpgroup per block runs m64n64k8 TF32 wgmma, A (H) from registers in
//   mma.m16n8k8's fragment layout per warp, B (W) from shared memory by descriptor
//   (K-major, 8-row x 16-byte core matrices, no swizzle).  A form of this kernel
//   on mma.sync.m16n8k8, each warp loading its own fragments from shared memory,
//   lost to torch.matmul (PERF.md).
// * Staging: raw complex tiles of H (64 rows x 16 pilots) and W (16 pilots x 32
//   subcarriers) go global -> shared by cp.async (8-byte copies, zero-filled past
//   every ragged edge, so no padded copies) into a 3-stage ring.  H's fragments are
//   loaded from the raw tile (rows padded for conflict-free loads) and split in
//   registers; W's tile is split once per block into hi/lo core matrices, with the
//   -Wi block formed there.  The next tile is staged, into a second B buffer and a
//   second set of A registers, while this tile's 12 wgmmas run.  74 KB of dynamic
//   shared memory a block, set once per kernel and device.
// * The grid: 64 rows x 32 subcarriers a block, 6 x 40 = 240 blocks at 384 rows;
//   up to 64 rows, 16 subcarriers a block (m64n32k8), 80 blocks at the host loop's
//   12.  No split of Np: every output is summed by one warpgroup, pilot group after
//   pilot group in one fixed order, so the result is bitwise the same from run to
//   run and does not depend on B or on the tile width (one UE's rows give the same
//   bits alone or in a batch).
// * The Gauss form (mmse_interp_gauss_kernel, 9 TF32 GEMM-equivalents): three real
//   products p1 = Hr Wr, p2 = Hi Wi, p3 = (Hr + Hi)(Wr + Wi) over three planes of
//   each operand, the sums formed in float32 before the split, each product its own
//   wgmma chain into its own fresh accumulator per k-tile and its own float32 sum;
//   re = p1 - p2, im = (p3 - p1) - p2 at the end.  The same staging, ring, k-tile
//   and block width as the 4-multiply form (N subcarriers a block, one accumulator
//   column each: m64n32k8, and m64n16k8 up to 64 rows): three accumulators and three
//   sums (96 registers at m64n32) beside the double-buffered A fragments of three
//   planes (96) take 244 registers, under the cap without spills, so no narrower
//   tile was needed.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BM = 64;        // rows of H per block: the wgmma M
constexpr int BKC = 16;       // complex pilots per k-tile: four k8 steps
constexpr int KS = 2 * BKC;   // real k slots per k-tile
constexpr int STAGES = 3;     // raw cp.async ring depth
constexpr int THREADS = 128;  // one warpgroup
constexpr int A_STRIDE = BKC + 4;     // float2 per raw H row: conflict-free fragment loads
constexpr int RAW_A = BM * A_STRIDE;  // float2 per stage

// N real output columns (N / 2 complex subcarriers) per block.
template <int N>
struct Tile {
  static constexpr int BNC = N / 2;
  static constexpr int CORE = N * KS;  // floats per hi or lo B tile
  static constexpr int RAW_B = BKC * BNC;
  // B hi/lo, double-buffered, then the raw ring
  static constexpr size_t SMEM = (size_t)4 * CORE * sizeof(float) +
                                 (size_t)STAGES * (RAW_A + RAW_B) * sizeof(float2);
};

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x = hi + lo, both TF32 values
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

// Shared-memory matrix descriptor, no swizzle: start address, LBO = 128 B between
// the two core matrices of a k8 step, SBO = the stride between 8-row groups.
template <int KSL = KS>
__device__ __forceinline__ uint64_t smem_desc(const float* tile) {
  const uint64_t addr = static_cast<unsigned>(__cvta_generic_to_shared(tile));
  constexpr uint64_t lbo = 128 >> 4, sbo = (KSL / 4 * 128) >> 4;
  return ((addr & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32);
}

// Make this thread's shared-memory writes visible to wgmma's operand reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D (64 x N) += A (64 x 8: this thread's fragment, laid out as mma.m16n8k8's A
// for the warp's 16 rows) . B (8 x N, shared memory, by descriptor)
// (scale_d = 0: D = A . B, a fresh accumulator)
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const float (&a)[4],
                                           uint64_t b_desc, int scale_d);
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const float (&a)[4],
                                              uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(b_desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const float (&a)[4],
                                              uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(b_desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const float (&a)[4],
                                              uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(b_desc), "r"(scale_d));
}

// float offset of core-matrix row (row, 4-slot group starting at slot) in a K-major
// tile of KSL k slots
template <int KSL = KS>
__device__ __forceinline__ int core_offset(int row, int slot) {
  return ((row / 8) * (KSL / 4) + slot / 4) * 32 + (row % 8) * 4;
}

// Stage k-tile kt's raw complex tiles into ring stage kt % STAGES: H (BM rows from
// row0 x BKC pilots) and W (BKC pilots x BNC subcarriers from col0), by cp.async,
// zero-filled past every ragged edge; one commit group per tile, empty past the end.
template <int BNC>
__device__ __forceinline__ void load_raw(const float2* __restrict__ h,
                                         const float2* __restrict__ w, float2* raw_a,
                                         float2* raw_b, int kt, int kt_count, int row0,
                                         int col0, int B, int Np, int Nsc) {
  constexpr int RAW_B = BKC * BNC;
  const int tid = threadIdx.x;
  if (kt < kt_count) {
    const int k0 = kt * BKC;
    float2* sa = raw_a + (kt % STAGES) * RAW_A;
#pragma unroll
    for (int i = 0; i < BM * BKC / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BKC, k = e % BKC;
      const bool ok = row0 + r < B && k0 + k < Np;
      cp_async8(sa + r * A_STRIDE + k, ok ? h + (size_t)(row0 + r) * Np + k0 + k : h,
                ok ? 8 : 0);
    }
    float2* sb = raw_b + (kt % STAGES) * RAW_B;
#pragma unroll
    for (int i = 0; i < (RAW_B + THREADS - 1) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      if (RAW_B % THREADS != 0 && e >= RAW_B) break;
      const int k = k0 + e / BNC, n = col0 + e % BNC;
      const bool ok = k < Np && n < Nsc;
      cp_async8(sb + e, ok ? w + (size_t)k * Nsc + n : w, ok ? 8 : 0);
    }
  }
  cp_async_commit();
}

template <int N>
__global__ void __launch_bounds__(THREADS)
mmse_interp_kernel(const float2* __restrict__ h, const float2* __restrict__ w,
                   float2* __restrict__ out, int B, int Np, int Nsc) {
  using T = Tile<N>;
  constexpr int BNC = T::BNC;
  extern __shared__ __align__(128) float smem[];
  float* b_tiles = smem;  // [2 buffers][hi, lo][N real columns][KS], core matrices
  float2* raw_a = reinterpret_cast<float2*>(smem + 4 * T::CORE);  // [STAGES][BM][A_STRIDE]
  float2* raw_b = raw_a + STAGES * RAW_A;                          // [STAGES][BKC][BNC]

  const int tid = threadIdx.x;
  const int warp = tid / 32, g = (tid % 32) / 4, tig = tid % 4;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BNC;
  const int kt_count = (Np + BKC - 1) / BKC;

  auto load_tile = [&](int kt) {
    load_raw<BNC>(h, w, raw_a, raw_b, kt, kt_count, row0, col0, B, Np, Nsc);
  };

  // Tile kt, landed in the ring, as this k-tile's operands.  W becomes the real B
  // operand: real column 2n + c, k slot 8 ks + 4 d + j holds Bbig[(k0 + 4 ks + j, d),
  // (n, c)], that is (Wr, -Wi) for c = 0 and (Wi, Wr) for c = 1, each split once
  // into hi and lo; a task (n, ks) writes the four 16-byte core-matrix rows of its
  // column pair.  H's fragments come straight from the raw tile: slot tig holds
  // Re h[k] and slot tig + 4 holds Im h[k], k = k0 + 4 ks + tig, split here.
  auto stage_in = [&](int kt, float* b_hi, float (&a_hi)[BKC / 4][4],
                      float (&a_lo)[BKC / 4][4]) {
    float* b_lo = b_hi + T::CORE;
    const float2* sb = raw_b + (kt % STAGES) * T::RAW_B;
    if (tid < BNC * (BKC / 4)) {
      const int n = tid % BNC, ks = tid / BNC;
      float4 rh, rl, ih, il;  // Wr, Wi over the task's four pilots
      float* v[4] = {&rh.x, &rl.x, &ih.x, &il.x};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = sb[(ks * 4 + j) * BNC + n];
        split(x.x, v[0][j], v[1][j]);
        split(x.y, v[2][j], v[3][j]);
      }
      const float4 nih = make_float4(-ih.x, -ih.y, -ih.z, -ih.w);
      const float4 nil = make_float4(-il.x, -il.y, -il.z, -il.w);
      const int c0 = core_offset(2 * n, 8 * ks), c1 = core_offset(2 * n + 1, 8 * ks);
      float4* hi = reinterpret_cast<float4*>(b_hi);
      float4* lo = reinterpret_cast<float4*>(b_lo);
      hi[c0 / 4] = rh;       lo[c0 / 4] = rl;         // column 2n, d = 0: Wr
      hi[c0 / 4 + 8] = nih;  lo[c0 / 4 + 8] = nil;    // column 2n, d = 1: -Wi
      hi[c1 / 4] = ih;       lo[c1 / 4] = il;         // column 2n + 1, d = 0: Wi
      hi[c1 / 4 + 8] = rh;   lo[c1 / 4 + 8] = rl;     // column 2n + 1, d = 1: Wr
    }
    const float2* sa = raw_a + (kt % STAGES) * RAW_A + (warp * 16 + g) * A_STRIDE + tig;
#pragma unroll
    for (int ks = 0; ks < BKC / 4; ++ks) {
      const float2 v0 = sa[ks * 4];
      const float2 v1 = sa[8 * A_STRIDE + ks * 4];
      split(v0.x, a_hi[ks][0], a_lo[ks][0]);
      split(v1.x, a_hi[ks][1], a_lo[ks][1]);
      split(v0.y, a_hi[ks][2], a_lo[ks][2]);
      split(v1.y, a_hi[ks][3], a_lo[ks][3]);
    }
    fence_async_smem();
  };

  float acc[N / 2];  // this k-tile's tensor-core accumulator
  float sum[N / 2];  // the k-tiles' float32 sum, rounded to nearest
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = sum[i] = 0.f;

  // one k-tile: its 12 wgmmas, into a fresh accumulator, lo*hi and hi*lo of every
  // k8 step first, then hi*hi, in k order; they run while the next tile is staged
  // into the other buffers, and the accumulator then joins the sum
  auto step = [&](int kt, const float* b_hi, const float (&a_hi)[BKC / 4][4],
                  const float (&a_lo)[BKC / 4][4], float* nb_hi,
                  float (&na_hi)[BKC / 4][4], float (&na_lo)[BKC / 4][4]) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BKC / 4; ++ks) {
      wgmma_tf32<N>(acc, a_lo[ks], smem_desc(b_hi + ks * 64), ks > 0);
      wgmma_tf32<N>(acc, a_hi[ks], smem_desc(b_hi + T::CORE + ks * 64), 1);
    }
#pragma unroll
    for (int ks = 0; ks < BKC / 4; ++ks)
      wgmma_tf32<N>(acc, a_hi[ks], smem_desc(b_hi + ks * 64), 1);
    wgmma_commit();
    if (kt + 1 < kt_count) {
      load_tile(kt + STAGES - 1);  // into the stage tile kt - 1 left
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // tile kt + 1 has landed
      stage_in(kt + 1, nb_hi, na_hi, na_lo);
    }
    wgmma_wait();     // tile kt's wgmmas are done: its buffers are free
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sum[i] += acc[i];
    __syncthreads();  // tile kt + 1's operands are staged
  };

  float a_hi0[BKC / 4][4], a_lo0[BKC / 4][4], a_hi1[BKC / 4][4], a_lo1[BKC / 4][4];
  float* b0 = b_tiles;
  float* b1 = b_tiles + 2 * T::CORE;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_tile(s);
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (kt_count > 0) stage_in(0, b0, a_hi0, a_lo0);
  __syncthreads();
  for (int kt = 0; kt < kt_count; kt += 2) {
    step(kt, b0, a_hi0, a_lo0, b1, a_hi1, a_lo1);
    if (kt + 1 < kt_count) step(kt + 1, b1, a_hi1, a_lo1, b0, a_hi0, a_lo0);
  }

  // accumulator layout: sum[4 j + i] holds row warp * 16 + g (+ 8 for i >= 2), real
  // column 8 j + 2 tig (+ 1 for odd i): complex column 4 j + tig, (re, im)
  const int r = row0 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int n = col0 + 4 * j + tig;
    if (n >= Nsc) continue;
    if (r < B) out[(size_t)r * Nsc + n] = make_float2(sum[4 * j], sum[4 * j + 1]);
    if (r + 8 < B) out[(size_t)(r + 8) * Nsc + n] = make_float2(sum[4 * j + 2], sum[4 * j + 3]);
  }
}

// The Gauss form: three real products over the same k-tile, p1 = Hr Wr, p2 = Hi Wi,
// p3 = (Hr + Hi)(Wr + Wi), each its own m64nNCk8 wgmma chain into its own fresh
// accumulator (NC subcarriers, one real column each), then re = p1 - p2 and
// im = (p3 - p1) - p2 at the end, as the reference kernel writes them.  A k8 step of
// a plane holds eight consecutive pilots (slot s: pilot k0 + 8 ks + s), so a
// 16-pilot k-tile is two k8 steps a plane, six wgmmas a product in the 4-multiply
// form's order (lo*hi and hi*lo of each step, then hi*hi), 18 a tile.  The sums
// Hr + Hi and Wr + Wi are formed in float32 before the hi/lo split.
constexpr int GK = BKC;  // k slots of one plane's k-tile

template <int NC>
struct GaussTile {
  static constexpr int PLANE = NC * GK;  // floats per hi or lo plane tile
  static constexpr int BUF = 6 * PLANE;  // Wr, Wi, Wr + Wi, each hi then lo
  static constexpr int RAW_B = BKC * NC;
  // B planes, double-buffered, then the raw ring
  static constexpr size_t SMEM = (size_t)2 * BUF * sizeof(float) +
                                 (size_t)STAGES * (RAW_A + RAW_B) * sizeof(float2);
};

template <int NC>
__global__ void __launch_bounds__(THREADS)
mmse_interp_gauss_kernel(const float2* __restrict__ h, const float2* __restrict__ w,
                         float2* __restrict__ out, int B, int Np, int Nsc) {
  using T = GaussTile<NC>;
  extern __shared__ __align__(128) float smem[];
  float* b_tiles = smem;  // [2 buffers][6 planes][NC columns][GK], core matrices
  float2* raw_a = reinterpret_cast<float2*>(smem + 2 * T::BUF);  // [STAGES][BM][A_STRIDE]
  float2* raw_b = raw_a + STAGES * RAW_A;                         // [STAGES][BKC][NC]

  const int tid = threadIdx.x;
  const int warp = tid / 32, g = (tid % 32) / 4, tig = tid % 4;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * NC;
  const int kt_count = (Np + BKC - 1) / BKC;
  // per plane (Hr, Hi, Hr + Hi) and k8 step: this thread's A fragment
  using Frag = float[3][GK / 8][4];

  auto load_tile = [&](int kt) {
    load_raw<NC>(h, w, raw_a, raw_b, kt, kt_count, row0, col0, B, Np, Nsc);
  };

  // Tile kt, landed in the ring, as this k-tile's operands: a task (n, q) splits
  // Wr, Wi and Wr + Wi of column n over pilots 4q .. 4q + 3 and writes their six
  // 16-byte core-matrix rows; H's fragments come from the raw tile, split here.
  auto stage_in = [&](int kt, float* b, Frag& a_hi, Frag& a_lo) {
    const float2* sb = raw_b + (kt % STAGES) * T::RAW_B;
    if (tid < NC * (GK / 4)) {
      const int n = tid % NC, q = tid / NC;
      float v[6][4];  // Wr hi, Wr lo, Wi hi, Wi lo, (Wr + Wi) hi, lo
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = sb[(4 * q + j) * NC + n];
        split(x.x, v[0][j], v[1][j]);
        split(x.y, v[2][j], v[3][j]);
        split(x.x + x.y, v[4][j], v[5][j]);
      }
      float4* dst = reinterpret_cast<float4*>(b) + core_offset<GK>(n, 4 * q) / 4;
#pragma unroll
      for (int p = 0; p < 6; ++p)
        dst[p * T::PLANE / 4] = make_float4(v[p][0], v[p][1], v[p][2], v[p][3]);
    }
    // mma.m16n8k8's A: (row g, slot tig), (g + 8, tig), (g, tig + 4), (g + 8, tig + 4)
    const float2* sa = raw_a + (kt % STAGES) * RAW_A + (warp * 16 + g) * A_STRIDE + tig;
#pragma unroll
    for (int ks = 0; ks < GK / 8; ++ks) {
      const float2 x[4] = {sa[8 * ks], sa[8 * A_STRIDE + 8 * ks], sa[8 * ks + 4],
                           sa[8 * A_STRIDE + 8 * ks + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split(x[i].x, a_hi[0][ks][i], a_lo[0][ks][i]);
        split(x[i].y, a_hi[1][ks][i], a_lo[1][ks][i]);
        split(x[i].x + x[i].y, a_hi[2][ks][i], a_lo[2][ks][i]);
      }
    }
    fence_async_smem();
  };

  float acc[3][NC / 2];  // this k-tile's tensor-core accumulators, p1, p2, p3
  float sum[3][NC / 2];  // the k-tiles' float32 sums, rounded to nearest
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[p][i] = sum[p][i] = 0.f;

  auto step = [&](int kt, const float* b, const Frag& a_hi, const Frag& a_lo, float* nb,
                  Frag& na_hi, Frag& na_lo) {
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const float* b_hi = b + 2 * p * T::PLANE;
      const float* b_lo = b_hi + T::PLANE;
#pragma unroll
      for (int ks = 0; ks < GK / 8; ++ks) {
        wgmma_tf32<NC>(acc[p], a_lo[p][ks], smem_desc<GK>(b_hi + ks * 64), ks > 0);
        wgmma_tf32<NC>(acc[p], a_hi[p][ks], smem_desc<GK>(b_lo + ks * 64), 1);
      }
#pragma unroll
      for (int ks = 0; ks < GK / 8; ++ks)
        wgmma_tf32<NC>(acc[p], a_hi[p][ks], smem_desc<GK>(b_hi + ks * 64), 1);
    }
    wgmma_commit();
    if (kt + 1 < kt_count) {
      load_tile(kt + STAGES - 1);
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      stage_in(kt + 1, nb, na_hi, na_lo);
    }
    wgmma_wait();
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) sum[p][i] += acc[p][i];
    __syncthreads();
  };

  Frag a_hi0, a_lo0, a_hi1, a_lo1;
  float* b0 = b_tiles;
  float* b1 = b_tiles + T::BUF;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_tile(s);
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (kt_count > 0) stage_in(0, b0, a_hi0, a_lo0);
  __syncthreads();
  for (int kt = 0; kt < kt_count; kt += 2) {
    step(kt, b0, a_hi0, a_lo0, b1, a_hi1, a_lo1);
    if (kt + 1 < kt_count) step(kt + 1, b1, a_hi1, a_lo1, b0, a_hi0, a_lo0);
  }

  // accumulator layout: sum[p][4 j + i] holds row warp * 16 + g (+ 8 for i >= 2),
  // column 8 j + 2 tig (+ 1 for odd i), one subcarrier each
  const int r = row0 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = col0 + 8 * j + 2 * tig + (i & 1);
      const int row = r + (i >= 2 ? 8 : 0);
      if (n >= Nsc || row >= B) continue;
      const float p1 = sum[0][4 * j + i], p2 = sum[1][4 * j + i], p3 = sum[2][4 * j + i];
      out[(size_t)row * Nsc + n] = make_float2(p1 - p2, p3 - p1 - p2);
    }
  }
}

// one launch of Kernel, COLS subcarriers a block
template <auto Kernel, size_t SMEM, int COLS>
int launch(const void* h, const void* w, void* out, int B, int Np, int Nsc, void* stream) {
  // the dynamic shared memory above 48 KB, allowed once per device (bit d: device d)
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(allowed.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid((Nsc + COLS - 1) / COLS, (B + BM - 1) / BM);
  Kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(h), static_cast<const float2*>(w),
      static_cast<float2*>(out), B, Np, Nsc);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_4m(const void* h, const void* w, void* out, int B, int Np, int Nsc, void* stream) {
  return launch<mmse_interp_kernel<N>, Tile<N>::SMEM, Tile<N>::BNC>(h, w, out, B, Np, Nsc,
                                                                    stream);
}

template <int NC>
int launch_gauss(const void* h, const void* w, void* out, int B, int Np, int Nsc,
                 void* stream) {
  return launch<mmse_interp_gauss_kernel<NC>, GaussTile<NC>::SMEM, NC>(h, w, out, B, Np,
                                                                        Nsc, stream);
}

}  // namespace

extern "C" int mmse_interp_launch(const void* h, const void* w, void* out, int B,
                                  int Np, int Nsc, void* stream) {
  if (B <= 0 || Nsc <= 0) return 0;
  // up to one 64-row tile: 16 subcarriers a block, for twice the blocks
  if (B <= BM) return launch_4m<32>(h, w, out, B, Np, Nsc, stream);
  return launch_4m<64>(h, w, out, B, Np, Nsc, stream);
}

extern "C" int mmse_interp_gauss_launch(const void* h, const void* w, void* out, int B,
                                        int Np, int Nsc, void* stream) {
  if (B <= 0 || Nsc <= 0) return 0;
  // the 4-multiply form's blocks: 16 subcarriers up to one 64-row tile, else 32
  if (B <= BM) return launch_gauss<16>(h, w, out, B, Np, Nsc, stream);
  return launch_gauss<32>(h, w, out, B, Np, Nsc, stream);
}
