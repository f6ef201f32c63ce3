// The fused GATED hot path: gather -> residual-CNN channel estimator -> scatter, in
// one launch: each (compact row, antenna) chain runs on a thread-block cluster spread
// along the subcarrier axis, its 3x3 convolutions as implicit GEMMs on the tensor
// cores (3xTF32 for float32, bf16 operands for bf16).
//
// Replaces: src/repro/kernels/gated_expert/gated_expert.py::gated_expert_fused (Pallas
// TPU kernel, one grid step per compact row), reached through ops.py::gated_expert_apply.
//
// Semantics.  Compact row k names UE idx[k].  When src[idx[k]] >= 0 the row is a
// selected UE: the kernel reads that UE's LS pilot estimate (U, ant, S, Np) complex64,
// runs the estimator -- comb-2 baseline, stem conv, R residual blocks, 2x sub-pixel
// up-projection, head conv -- and writes the (n_sc, S) estimate of every antenna
// straight into the UE's slice of the designated buffer (U, ant, 1, n_sc, S)
// complex64, in place.  Otherwise the row is capacity padding and its UE's bytes are
// left untouched, as are the bytes of every UE that no row names.  Every conv is the
// 3x3 'SAME' cross-correlation over (subcarrier, symbol) of the reference's folded
// GEMMs, computed directly: the folded form's structurally zero tap blocks
// (|w_in - w_out| = 2) are skipped, the rest is the same arithmetic in another order.
// bf16 mode rounds every conv operand to bf16 (round to nearest even) and keeps the
// products, sums, bias and residual adds in fp32, as the plain version does.
//
// What bounds it on the H100: arithmetic.  At the paper's width (32 channels, 4
// residual blocks, Np = 636) one (UE, antenna) chain is 0.28 GFLOP of direct
// convolutions against 30 KB of input and output.  The first form of this kernel ran
// each chain in one 512-thread block with scalar FMAs on the CUDA cores: 11 selected
// UEs x 4 antennas = 44 blocks left 88 of 132 SMs idle, and one SM's share of the
// fp32 rate bounds a chain at 550 us however many rows there are.  This form spreads
// the chain over SMs and moves 98 % of its work (the residual convs and the
// up-projection) to the tensor cores; the float32 contract holds through 3xTF32.
//
// Design.
//
// * A cluster per (row, antenna), along the subcarrier axis: a cluster of CL blocks
//   (CL = ceil(Np / 80), at most 8, the portable size), each block one warpgroup
//   owning P = ceil(Np / CL) subcarriers (2P at the head) through every layer.  At
//   n_prb 106 that is 8 x 80: the phase shape's 44 pairs make 352 blocks, and three
//   fit an SM (3 x 128 threads x 168 registers; 3 x (37 KB dynamic + 16 KB of weights)
//   of shared memory), 396 block slots for 352 blocks, so they run in one wave.
// * Where activations live: design (b), an L2 workspace, with the block's own slice
//   kept in shared memory between layers.  Design (a), every plane of the block's
//   slice on chip, needs S x (P + 2) x 36 floats a plane: at n_prb 106 with CL 8 the
//   two planes h and y are 71 KB a block, two blocks an SM, 264 slots for 352
//   blocks; over all 44 pairs the planes alone are 24 MB of the card's 30 MB of
//   shared memory, which clusters cannot pack into one wave; at n_prb 273 (P 205) a
//   block would need 179 KB.  So each block holds one staged slice (S, P + 2, CP + 4)
//   -- 35 KB at n_prb 106, 89 KB at n_prb 273; CP the channel count padded to 16,
//   32, 48 or 64, position 0 and P + 1 the one-subcarrier halo, zero outside the band -- and a
//   per-(row, antenna) workspace holds h (S, Np, CP), and y (S, Np, CP) that the
//   up-projection reuses as u (S, 2 Np, CP), channel-innermost.  When the slice is
//   at most four 64-row tiles (n_prb 106), each layer's epilogue writes its output
//   over the slice it has finished reading, for the next layer, and to the
//   workspace only what others read: the slice's two edge positions, and h in full
//   (the next residual add reads it); the next layer then fetches only its halo.
//   A wider slice restages from the workspace every layer.  Reads of the workspace
//   go through L2 (cp.async.cg).  Between layers the cluster waits on one barrier
//   (barrier.cluster.arrive.release / wait.acquire), which orders the edge writes
//   before the neighbours' halo reads; a layer never writes the plane its
//   neighbours read for it (h->y, y->h, h->u, u->des), so one barrier a layer is
//   enough.  A padding row's whole cluster returns at once, before any barrier, and
//   no block reads another's shared memory.
// * Implicit GEMMs on the tensor cores for the residual convs and the up-projection
//   (two passes of N = CP, one per sub-pixel phase): per block M = S x P rows (symbol
//   major, so a 64-row tile lies in one or two symbols and skips the symbol taps
//   that fall outside the slot; a row whose tap does reads a row of zeros), N = CP
//   output channels, K = CP input channels x 9 taps.  wgmma m64nCPk8 (tf32) or
//   m64nCPk16 (bf16): A (the staged activations) from registers in mma.m16n8k8's /
//   m16n8k16's fragment layout per warp, B (one tap's weights) from shared memory by
//   descriptor (K-major, 8-row x 16-byte core matrices, no swizzle, LBO 128 B),
//   double-buffered tap by tap with the next tap's weights loaded into registers
//   while this tap's wgmmas run.  Up to four 64-row tiles a pass keep their float32
//   sums in registers; a wider slice runs in groups of four.
// * Wider estimators, up to 64 channels (CP 48 and 64): a tap's accumulator and each
//   tile's sums are 24 or 32 floats a thread, so two tiles a group keep their sums
//   (the n_prb 106 slice's four tiles then restage between layers, as a wider slice
//   does), a block may take 255 registers, and two blocks share an SM.  At CP 64 in
//   float32 two taps' hi and lo tiles would be 64 KB, past the 48 KB of static
//   shared memory, so that weight region holds one tap (32 KB), stored after a
//   barrier that follows the last tap's wgmmas; it stays static (uniform
//   descriptors), and the slice at n_prb 273 still fits beside it (207 KB a block).
// * The wide form, past 64 channels (gated_expert_wide_kernel): nothing a layer holds
//   grows with the width.  Another CP would (a tap's accumulator and each tile's sums
//   in registers, the weight tiles in static shared memory, the staged slice), so the
//   channels are tiled: the planes hold C padded to a multiple of KC = 32,
//   chunk-major (CW / KC, S, len, KC), and each conv runs an outer loop over N-chunks
//   of KC output channels, then 64-row tile groups, then an inner loop over K-chunks
//   of KC input channels, each chunk's slice (S, P + 2, KC + 4) staged in turn from
//   the workspace, then the 9 taps: a block's registers and static shared memory are
//   the CP 32 form's (16 KB of weight tiles, double-buffered), and its slice is the
//   CP 32 slice.  Every layer restages (no slice is kept between layers).  The stem
//   loops over the output chunks, the head stages u with every channel a few
//   positions at a time; their weights (CW floats a row) lie in dynamic shared
//   memory, the one part that grows with the width (76 B a channel, and the head's
//   staged u about 48 B more).  Where that block would not fit the card (past 1,408
//   float32 channels at n_prb 273, 1,440 at n_prb 106), the global-weight variant
//   runs instead (GW): the stem and head read their weights from the packed operands
//   in global memory, where they stay in L2, and the head reads u straight from the
//   workspace, so its shared memory is a K-chunk slice whatever the width.  Every
//   output is summed in the same order as in the staged form.
// * float32 as 3xTF32: each operand x is split into hi = x rounded to TF32 and lo =
//   x - hi, exact, truncated to TF32 (integer operations: cvt.rna.tf32 runs on a
//   quarter-rate pipe); every product is lo*hi + hi*lo + hi*hi, off by under 2^-20 of
//   the product.  The tensor core's accumulator truncates, so each
//   k-tile (one tap: all CP input channels, 4 k8 steps at CP 32) starts a fresh
//   accumulator, takes its lo terms first, then hi*hi, and is added to a float32
//   register sum rounded to nearest, tap after tap (mmse_interp.cu does the same).
//   tests/test_torch_gated_kernels.py emulates this order with a truncating
//   accumulator against repro's unfused reference.  bf16: one wgmma per k16 step
//   (products of bf16 values are exact in float32), the same per-tap accumulators.
// * The stem (2 input channels) and the head (2 output channels) are 1.8 % of the
//   work and would fill a tenth of a tensor-core tile: they run as scalar float32
//   FMAs on the CUDA cores, the stem reading the complex64 LS row, the head adding
//   the comb-2 baseline and writing the complex64 estimate, four lanes an output
//   whose partial sums meet in a fixed butterfly.
//   In the wide form each k-tile is one tap of one K-chunk: a fresh accumulator per
//   (K-chunk, tap), K-chunk by K-chunk and tap by tap into the same register sum.
// * Determinism: every output is summed inside one block, in one order fixed by the
//   shapes (N-chunk, K-chunk, tap, then channel within the k-tile), with no split of K
//   across blocks and no atomics; the block geometry depends on Np and S only, so one
//   UE's estimate is bitwise the same at any capacity and in any row of idx.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 128;     // one warpgroup a block
constexpr int P_TARGET = 80;     // subcarriers a block aims for
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int TAPS = 9;          // 3 subcarrier taps x 3 symbol taps

enum Epilogue { RELU, RESIDUAL, SUBPIXEL };

struct Geometry {
  int cluster, P;
};

Geometry geometry(int np) {
  int cl = (np + P_TARGET - 1) / P_TARGET;
  cl = cl < 1 ? 1 : (cl > MAX_CLUSTER ? MAX_CLUSTER : cl);
  return {cl, (np + cl - 1) / cl};
}

// channels padded to the GEMM's width: 16, 32, 48 or 64
int channel_pad(int C) { return (C + 15) / 16 * 16; }

// 64-row tiles whose sums stay in registers: four up to 32 channels, two above,
// where each tile's sums and its tap accumulator are 24 or 32 floats a thread
template <int CP>
__host__ __device__ constexpr int maxt() { return CP <= 32 ? 4 : 2; }

// the taps whose B tiles the weight region holds at once: two (the next tap's is
// stored while this one's wgmmas run), one for 64 float32 channels, whose two taps'
// hi and lo tiles (64 KB) would pass the 48 KB of static shared memory
template <int CP, bool BF16>
__host__ __device__ constexpr int nbuf() { return CP >= 64 && !BF16 ? 1 : 2; }

// floats per staged row (subcarrier, symbol): the padding makes the A-fragment loads
// conflict-free (rows 4 banks apart)
template <int CP>
__host__ __device__ constexpr int row_stride() { return CP + 4; }

// the weight region: nbuf taps' B tiles (hi and lo for float32), or the stem's or
// head's weights and biases, whichever is larger
template <int CP, bool BF16>
__host__ __device__ constexpr size_t weight_bytes() {
  const size_t b = nbuf<CP, BF16>() * (BF16 ? CP * CP * 2 : 2 * CP * CP * 4);
  const size_t misc = (19 * CP + 4) * 4;
  return ((b > misc ? b : misc) + 127) / 128 * 128;
}

// dynamic shared memory: the staged slice, a row of zeros, the head's LS pilots
template <int CP>
size_t smem_bytes(int S, int P) {
  return ((size_t)S * (P + 2) + 1) * row_stride<CP>() * 4 + (size_t)S * (P + 1) * 8;
}

// The wide form's chunk: KC input or output channels (a K- or N-chunk)
constexpr int KC = 32;
constexpr int WIDEST_CP = 64;  // widths up to this run the CP forms

// the planes' channel count: the CP forms' padding, or whole chunks past WIDEST_CP
int plane_width(int C) { return C <= WIDEST_CP ? channel_pad(C) : (C + KC - 1) / KC * KC; }

// Positions of u the wide head stages at a time, every channel of a position in a
// row of CW + 4 floats: as many as the K-chunk slice's room holds, at most P, at
// least 4 (the room then grows).
__host__ __device__ inline int head_positions(int P, int CW) {
  const int q = (P + 2) * row_stride<KC>() / (CW + 4) - 2;
  const int lo = P < 4 ? P : 4;
  return q > P ? P : (q < lo ? lo : q);
}

// The wide form's slice room in floats: a K-chunk slice or the head's staged u.
__host__ __device__ inline size_t wide_slice_floats(int S, int P, int CW) {
  const size_t k = (size_t)S * (P + 2) * row_stride<KC>();
  const size_t u = (size_t)S * (head_positions(P, CW) + 2) * (CW + 4);
  return k > u ? k : u;
}

// The head's LS pilots (S, P + 1) float2, in floats rounded up to a float4.
__host__ __device__ inline size_t lsm_floats(int S, int P) {
  return ((size_t)S * (P + 1) * 2 + 3) / 4 * 4;
}

// The wide form's dynamic shared memory: the slice room, a row of zeros, the head's
// LS pilots, and the stem's (19, CW) or the head's (9 CW + 1) float2 weights.
size_t wide_smem_bytes(int S, int P, int CW) {
  return (wide_slice_floats(S, P, CW) + row_stride<KC>() + lsm_floats(S, P) + 19 * CW) * 4;
}

// The wide form's global-weight variant (GW), for a block the above would not fit:
// the stem and head read their weights from the packed operands in global memory
// (they stay in L2) and the head reads u from the workspace unstaged, so only a
// K-chunk slice, the row of zeros and the LS pilots stay: the same at every width.
__host__ __device__ inline size_t gw_slice_floats(int S, int P) {
  return (size_t)S * (P + 2) * row_stride<KC>();
}

size_t wide_gw_smem_bytes(int S, int P) {
  return (gw_slice_floats(S, P) + row_stride<KC>() + lsm_floats(S, P)) * 4;
}

// The weight region, static shared memory: its address is a constant, so the wgmma
// descriptors that point into it are uniform constants too.
template <int CP, bool BF16>
__device__ __forceinline__ float* weight_region() {
  __shared__ __align__(128) float w[weight_bytes<CP, BF16>() / 4];
  return w;
}

struct Args {
  const int32_t* idx;
  const int32_t* src;
  const float2* h_ls;
  float2* designated;
  const float* w;
  const float* bias;
  float* workspace;
  int n_ant, S, np, C, R, P;
};

// -- PTX helpers ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// x = hi + lo + r: hi = x rounded to TF32 (10 mantissa bits) to nearest, ties away
// from zero, as cvt.rna.tf32.f32 does for finite x; lo = x - hi (exact) truncated to
// TF32, |r| below 2^-21 |x|.  Four full-rate operations (cvt.rna.tf32 runs on a
// quarter-rate pipe).  Truncating hi as well would save one, but biases every
// product toward zero: a layer then errs twice as much as a float32 convolution.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float operand(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Shared-memory matrix descriptor, K-major, no swizzle, of the tile at shared-window
// address ``saddr``: LBO = 128 B between the two core matrices of a k step, SBO = the
// stride between 8-row (output channel) groups.  Built from 32-bit halves (the high
// one a constant), so a k step's descriptor is the low word plus 16 per 256 B.
template <int SBO>
__device__ __forceinline__ uint64_t smem_desc(uint32_t saddr) {
  const uint32_t lo = ((saddr & 0x3FFFF) >> 4) | ((128 >> 4) << 16);
  return (static_cast<uint64_t>(SBO >> 4) << 32) | lo;
}

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

// D (64 x N) = A (64 x k: registers) . B (k x N: shared memory) + (scale_d ? D : 0)
template <int N>
struct Mma;

template <>
struct Mma<32> {
  __device__ static void tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
  __device__ static void bf16(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};

template <>
struct Mma<16> {
  __device__ static void tf32(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
  __device__ static void bf16(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};

template <>
struct Mma<48> {
  __device__ static void tf32(float (&d)[24], const uint32_t (&a)[4], uint64_t b, int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
  __device__ static void bf16(float (&d)[24], const uint32_t (&a)[4], uint64_t b, int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};

template <>
struct Mma<64> {
  __device__ static void tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
  __device__ static void bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};

// -- the block's view of its chain ---------------------------------------------------

struct Ctx {
  float* xs;     // staged input slice (S, P + 2, CP + 4), position 0 the left halo
  const float* zero;  // a row of zeros past the slice
  float2* lsm;        // the head's LS pilots (S, P + 1), clamped to the band
  float* wsm;    // weight region
  int S, P, np, C, p0, V;  // V: positions of the slice inside the band
};

// Stage positions q0 .. q0 + P + 1 of a workspace plane (S, len, CP) into xs, zero
// outside [0, len).
template <int CP>
__device__ void stage(const Ctx& c, const float* plane, int len, int q0) {
  constexpr int CH = CP / 4, RS = row_stride<CP>();
  const int n = c.S * (c.P + 2) * CH;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int ch = i % CH, r = i / CH, pp = r % (c.P + 2), s = r / (c.P + 2);
    const int q = q0 + pp;
    const bool ok = q >= 0 && q < len;
    cp_async16(c.xs + r * RS + 4 * ch, ok ? plane + ((size_t)s * len + q) * CP + 4 * ch : plane,
               ok ? 16 : 0);
  }
  cp_async_wait_all();
  __syncthreads();
}

// Refresh the two halo positions of the staged slice from a workspace plane (S, np,
// CP): the neighbours' edge outputs.  Positions outside the band stay zero, as the
// first stage left them.
template <int CP>
__device__ void stage_halo(const Ctx& c, const float* plane) {
  constexpr int CH = CP / 4, RS = row_stride<CP>();
  auto fetch = [&](int i) {  // 16 bytes of one side's halo row
    const int ch = i % CH, side = i / CH % 2, s = i / CH / 2;
    const int q = side ? c.p0 + c.P : c.p0 - 1;
    if (q >= 0 && q < c.np)
      cp_async16(c.xs + (s * (c.P + 2) + (side ? c.P + 1 : 0)) * RS + 4 * ch,
                 plane + ((size_t)s * c.np + q) * CP + 4 * ch, 16);
  };
  if constexpr (CP <= 32) {  // up to 8 symbols: one 16-byte piece a thread
    if (threadIdx.x < 2 * c.S * CH) fetch(threadIdx.x);
  } else {
    for (int i = threadIdx.x; i < 2 * c.S * CH; i += THREADS) fetch(i);
  }
  cp_async_wait_all();
  __syncthreads();
}

// The (k = input channel, n = output channel) weight a thread holds in its i-th
// register of a tap: element threadIdx.x + i * THREADS of the CP x CP tile, n fastest.
template <int CP>
__device__ __forceinline__ void tap_element(int i, int& n, int& k) {
  if constexpr (THREADS % CP == 0) {  // n is the thread's own
    n = threadIdx.x % CP;
    k = threadIdx.x / CP + i * (THREADS / CP);
  } else {
    const int e = threadIdx.x + i * THREADS;
    n = e % CP;
    k = e / CP;
  }
}

// One tap's weights, B[k = input channel][n = output channel], from the pack
// (C, 3, 3, coutp); output channel n reads pack column col0 + n.  Zero past C.
template <int CP>
__device__ __forceinline__ void load_tap(float (&wr)[CP * CP / THREADS], const float* wl,
                                         int coutp, int col0, int C, int tap) {
  if constexpr (THREADS % CP == 0) {  // one base pointer: n is the thread's own
    const int n = threadIdx.x % CP;
    const float* w0 = wl + (threadIdx.x / CP * TAPS + tap) * coutp + col0 + n;
#pragma unroll
    for (int i = 0; i < CP * CP / THREADS; ++i) {
      const int k = threadIdx.x / CP + i * (THREADS / CP);
      wr[i] = (n < C && k < C) ? __ldg(w0 + i * (THREADS / CP) * TAPS * coutp) : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < CP * CP / THREADS; ++i) {
      int n, k;
      tap_element<CP>(i, n, k);
      wr[i] = (n < C && k < C) ? __ldg(wl + (k * TAPS + tap) * coutp + col0 + n) : 0.f;
    }
  }
}

// ... into the K-major core-matrix layout wgmma reads: hi and lo planes (tf32), or
// one bf16 plane (the bf16 pack is already rounded, so the conversion is exact)
template <int CP, bool BF16>
__device__ __forceinline__ void store_tap(const float (&wr)[CP * CP / THREADS], void* wb) {
#pragma unroll
  for (int i = 0; i < CP * CP / THREADS; ++i) {
    int n, k;
    tap_element<CP>(i, n, k);  // as load_tap holds them
    if (BF16) {
      const int off = ((n / 8) * (CP / 8) + k / 8) * 64 + (n % 8) * 8 + k % 8;
      static_cast<__nv_bfloat16*>(wb)[off] = __float2bfloat16_rn(wr[i]);
    } else {
      const int off = ((n / 8) * (CP / 4) + k / 4) * 32 + (n % 8) * 4 + k % 4;
      uint32_t hi, lo;
      split(wr[i], hi, lo);
      static_cast<uint32_t*>(wb)[off] = hi;
      static_cast<uint32_t*>(wb)[CP * CP + off] = lo;
    }
  }
}

// One tensor-core conv over the staged slice: out (channels col0 .. col0 + C of the
// pack) = conv(xs) + bias, through the epilogue.  RELU and RESIDUAL write plane
// ``out`` (S, np, CP) at the block's positions; SUBPIXEL writes phase ``phase`` of the
// up-projection into u (S, 2 np, CP) at 2q + phase.
template <int CP, bool BF16>
__device__ void tc_layer(const Ctx& c, const float* wl, const float* bl, int coutp,
                         int col0, Epilogue epi, int phase, float* out, bool keep) {
  constexpr int ND = CP / 2;             // accumulator floats a thread
  constexpr int RS = row_stride<CP>();
  constexpr int MAXT = maxt<CP>();
  constexpr int NBUF = nbuf<CP, BF16>();
  constexpr int WTILE = BF16 ? CP * CP / 2 : 2 * CP * CP;  // a tap's B, in floats
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, tig = threadIdx.x % 4;
  const int rows = c.S * c.P, n_tiles = (rows + 63) / 64;

  for (int g0 = 0; g0 < n_tiles; g0 += MAXT) {
    // this thread's two rows of each tile: staged offset and symbol (a symbol far
    // out of range marks a row past the slice, which reads the zero row)
    int rbase[MAXT][2], rsym[MAXT][2];
    unsigned jmask[MAXT];  // bit j: a row of the tile sees symbol tap j
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      const int tile = g0 + t;
      jmask[t] = 0;
      if (tile < n_tiles) {
        const int s_first = tile * 64 / c.P, s_last = min(tile * 64 + 63, rows - 1) / c.P;
        for (int j = 0; j < 3; ++j)
          if (s_last + j - 1 >= 0 && s_first + j - 1 < c.S) jmask[t] |= 1u << j;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = tile * 64 + warp * 16 + g + 8 * h;
        const bool ok = tile < n_tiles && m < rows;
        const int s = ok ? m / c.P : -8, p = ok ? m % c.P : 0;
        rsym[t][h] = s;
        rbase[t][h] = ok ? (s * (c.P + 2) + p) * RS : 0;
      }
    }
    float sum[MAXT][ND];
#pragma unroll
    for (int t = 0; t < MAXT; ++t)
#pragma unroll
      for (int i = 0; i < ND; ++i) sum[t][i] = 0.f;

    float acc[ND];  // a tap's accumulator; its first wgmma ignores what it holds
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.f;
    float wr[CP * CP / THREADS];
    __syncthreads();  // the last group's wgmmas have read the weight buffers
    load_tap<CP>(wr, wl, coutp, col0, c.C, 0);
#pragma unroll 1
    for (int tap = 0; tap < TAPS; ++tap) {
      const int d = tap / 3, j = tap % 3;
      float* wb = c.wsm + (NBUF == 2 ? tap & 1 : 0) * WTILE;
      if (NBUF == 1 && tap > 0) __syncthreads();  // tap - 1's wgmmas have read wb
      store_tap<CP, BF16>(wr, wb);
      fence_async_smem();
      __syncthreads();  // this tap's B is in place; tap - 1's readers are done
      if (tap + 1 < TAPS) load_tap<CP>(wr, wl, coutp, col0, c.C, tap + 1);
      const int shift = ((j - 1) * (c.P + 2) + d) * RS;
      const uint32_t wb_s =
          static_cast<uint32_t>(__cvta_generic_to_shared(weight_region<CP, BF16>())) +
          (NBUF == 2 ? tap & 1 : 0) * WTILE * 4;
      const uint64_t dhi = smem_desc<(BF16 ? 16 : 32) * CP>(wb_s);
      const uint64_t dlo = smem_desc<32 * CP>(wb_s + CP * CP * 4);
#pragma unroll
      for (int t = 0; t < MAXT; ++t) {
        if (!((jmask[t] >> j) & 1u)) continue;  // uniform across the warpgroup
        // a row whose symbol tap falls outside the slot reads the zero row
        const float* x0 = (unsigned)(rsym[t][0] + j - 1) < (unsigned)c.S
                              ? c.xs + rbase[t][0] + shift : c.zero;
        const float* x1 = (unsigned)(rsym[t][1] + j - 1) < (unsigned)c.S
                              ? c.xs + rbase[t][1] + shift : c.zero;
        if (BF16) {
          uint32_t a[CP / 16][4];
#pragma unroll
          for (int ks = 0; ks < CP / 16; ++ks) {
            const int k = 16 * ks + 2 * tig;
            const float2 v0 = *reinterpret_cast<const float2*>(x0 + k);
            const float2 v1 = *reinterpret_cast<const float2*>(x1 + k);
            const float2 v2 = *reinterpret_cast<const float2*>(x0 + k + 8);
            const float2 v3 = *reinterpret_cast<const float2*>(x1 + k + 8);
            a[ks][0] = bf16x2(v0.x, v0.y);
            a[ks][1] = bf16x2(v1.x, v1.y);
            a[ks][2] = bf16x2(v2.x, v2.y);
            a[ks][3] = bf16x2(v3.x, v3.y);
          }
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < CP / 16; ++ks) Mma<CP>::bf16(acc, a[ks], dhi + 16 * ks, ks > 0);
        } else {
          uint32_t ah[CP / 8][4], al[CP / 8][4];
#pragma unroll
          for (int ks = 0; ks < CP / 8; ++ks) {
            const int k = 8 * ks + tig;
            split(x0[k], ah[ks][0], al[ks][0]);
            split(x1[k], ah[ks][1], al[ks][1]);
            split(x0[k + 4], ah[ks][2], al[ks][2]);
            split(x1[k + 4], ah[ks][3], al[ks][3]);
          }
          // a fresh accumulator for the tap: lo*hi and hi*lo of every k8 step, then
          // hi*hi, in k order (a k8 step's two core matrices are 256 B apart)
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < CP / 8; ++ks) {
            Mma<CP>::tf32(acc, al[ks], dhi + 16 * ks, ks > 0);
            Mma<CP>::tf32(acc, ah[ks], dlo + 16 * ks, 1);
          }
#pragma unroll
          for (int ks = 0; ks < CP / 8; ++ks) Mma<CP>::tf32(acc, ah[ks], dhi + 16 * ks, 1);
        }
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int i = 0; i < ND; ++i) sum[t][i] += acc[i];
      }
    }

    // accumulator layout: element 4 j8 + i is row warp * 16 + g (+ 8 for i >= 2) of
    // the tile, output channel 8 j8 + 2 tig (+ 1 for odd i)
    if (keep) __syncthreads();  // every warp is done reading the slice it now overwrites
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (g0 + t) * 64 + warp * 16 + g + 8 * h;
        if (g0 + t >= n_tiles || m >= rows) continue;
        const int s = m / c.P, p = m % c.P;
        if (p >= c.V) continue;  // past the band: the last block's tail
        const int q = c.p0 + p;
        float2 v[CP / 8];
#pragma unroll
        for (int j8 = 0; j8 < CP / 8; ++j8) {
          const int n = 8 * j8 + 2 * tig;
          v[j8] = make_float2(sum[t][4 * j8 + 2 * h] + (n < c.C ? __ldg(bl + col0 + n) : 0.f),
                              sum[t][4 * j8 + 2 * h + 1] +
                                  (n + 1 < c.C ? __ldg(bl + col0 + n + 1) : 0.f));
        }
        if (epi == SUBPIXEL) {
          // up-projection channel phase * C + n at subcarrier q -> channel n at 2q + phase
          float* dst = out + ((size_t)s * 2 * c.np + 2 * q + phase) * CP + 2 * tig;
#pragma unroll
          for (int j8 = 0; j8 < CP / 8; ++j8) *reinterpret_cast<float2*>(dst + 8 * j8) = v[j8];
          continue;
        }
        float* dst = out + ((size_t)s * c.np + q) * CP + 2 * tig;
        if (epi == RESIDUAL) {  // h + conv(y); h was written by this block at an earlier layer
          float2 r[CP / 8];
#pragma unroll
          for (int j8 = 0; j8 < CP / 8; ++j8) r[j8] = __ldcg(reinterpret_cast<float2*>(dst + 8 * j8));
#pragma unroll
          for (int j8 = 0; j8 < CP / 8; ++j8)
            v[j8] = make_float2(r[j8].x + v[j8].x, r[j8].y + v[j8].y);
        } else {  // RELU; keeps NaN, as torch.relu
#pragma unroll
          for (int j8 = 0; j8 < CP / 8; ++j8)
            v[j8] = make_float2(v[j8].x < 0.f ? 0.f : v[j8].x, v[j8].y < 0.f ? 0.f : v[j8].y);
        }
        if (keep) {  // the next layer's input, in place
          float* x = c.xs + (s * (c.P + 2) + p + 1) * RS + 2 * tig;
#pragma unroll
          for (int j8 = 0; j8 < CP / 8; ++j8) *reinterpret_cast<float2*>(x + 8 * j8) = v[j8];
        }
        // the plane gets what others read: h in full (the next residual add), y in full
        // for a restage, else only at the slice's edges (the neighbours' halo)
        if (!keep || epi == RESIDUAL || p == 0 || p == c.P - 1) {
#pragma unroll
          for (int j8 = 0; j8 < CP / 8; ++j8) *reinterpret_cast<float2*>(dst + 8 * j8) = v[j8];
        }
      }
    }
  }
}

// The stem, on the CUDA cores: h (S, np, CP) = conv(LS (re, im)) + bias at the block's
// positions, channels past C zero.  ``wl`` (2, 3, 3, cp4), ``bl`` (cp4).
template <int CP, bool BF16>
__device__ void stem(const Ctx& c, const float2* __restrict__ ls, const float* wl,
                     const float* bl, float* h) {
  const int cp4 = (c.C + 3) / 4 * 4;
  float* ws = c.wsm;  // (2, 3, 3, CP) then the bias (CP)
  for (int i = threadIdx.x; i < 19 * CP; i += THREADS) {
    const int o = i % CP, r = i / CP;
    ws[i] = o < c.C ? (r < 18 ? wl[r * cp4 + o] : bl[o]) : 0.f;
  }
  __syncthreads();
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  for (int item = threadIdx.x; item < c.S * c.V; item += THREADS) {
    const int s = item / c.V, q = c.p0 + item % c.V;
    float2 z[3][3];  // the 3x3 neighbourhood, zero outside the band and the slot
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int qi = q + d - 1, si = s + j - 1;
        z[d][j] = (qi >= 0 && qi < c.np && si >= 0 && si < c.S) ? ls[(size_t)si * c.np + qi]
                                                                : make_float2(0.f, 0.f);
      }
    float acc[CP];
#pragma unroll
    for (int o = 0; o < CP; ++o) acc[o] = 0.f;
#pragma unroll 1
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float x = operand(ch == 0 ? z[d][j].x : z[d][j].y, BF16);
          const float4* wv = w4 + ((ch * 3 + d) * 3 + j) * (CP / 4);
#pragma unroll
          for (int o4 = 0; o4 < CP / 4; ++o4) {
            const float4 wo = wv[o4];
            acc[4 * o4] = fmaf(wo.x, x, acc[4 * o4]);
            acc[4 * o4 + 1] = fmaf(wo.y, x, acc[4 * o4 + 1]);
            acc[4 * o4 + 2] = fmaf(wo.z, x, acc[4 * o4 + 2]);
            acc[4 * o4 + 3] = fmaf(wo.w, x, acc[4 * o4 + 3]);
          }
        }
    float4* dst = reinterpret_cast<float4*>(h + ((size_t)s * c.np + q) * CP);
#pragma unroll
    for (int o4 = 0; o4 < CP / 4; ++o4) {
      const float4 b = w4[18 * (CP / 4) + o4];
      dst[o4] = make_float4(acc[4 * o4] + b.x, acc[4 * o4 + 1] + b.y, acc[4 * o4 + 2] + b.z,
                            acc[4 * o4 + 3] + b.w);
    }
  }
}

// The head, on the CUDA cores: des (2 np, S) = comb-2 baseline + conv(u) + bias, the
// two output channels as (re, im), at the block's 2V positions.  ``wl`` (C, 3, 3, 4),
// ``bl`` (4); u is staged P + 2 positions at a time.
template <int CP, bool BF16>
__device__ void head(const Ctx& c, const float2* __restrict__ ls, const float* wl,
                     const float* bl, const float* u, float2* __restrict__ des) {
  constexpr int RS = row_stride<CP>();
  float2* wh = reinterpret_cast<float2*>(c.wsm);  // (CP, 3, 3) (w_re, w_im), then bias
  for (int i = threadIdx.x; i < CP * 9 + 1; i += THREADS) {
    const int k = i / 9;
    wh[i] = i == CP * 9 ? make_float2(bl[0], bl[1])
                        : (k < c.C ? make_float2(wl[i * 4], wl[i * 4 + 1]) : make_float2(0.f, 0.f));
  }
  for (int i = threadIdx.x; i < c.S * (c.P + 1); i += THREADS) {
    const int s = i / (c.P + 1), k = min(c.p0 + i % (c.P + 1), c.np - 1);
    c.lsm[i] = ls[(size_t)s * c.np + k];
  }
  // (the weight region was last read by the up-projection's wgmmas, done before the
  // cluster barrier that precedes this call; the first chunk's barrier orders these
  // writes before their readers)
  for (int chunk = 0; chunk * c.P < 2 * c.V; ++chunk) {
    const int q_first = 2 * c.p0 + chunk * c.P;
    __syncthreads();  // the last chunk's readers of xs are done
    stage<CP>(c, u, 2 * c.np, q_first - 1);
    const float2 b = wh[CP * 9];
    // four lanes an output, eight lanes apart: lane ``quad`` sums channel groups quad,
    // quad + 4, ... (a quarter-warp reads one group of eight neighbouring positions);
    // the four partial sums meet in a fixed butterfly, so the order is fixed too
    const int lane = threadIdx.x % 32, quad = lane / 8;
    for (int base = 0; base < c.S * c.P; base += THREADS / 4) {  // uniform trip count
      const int item = base + threadIdx.x / 32 * 8 + lane % 8;
      const int s = item / c.P, qq = item % c.P, q = q_first + qq;
      const bool live = item < c.S * c.P && q < 2 * (c.p0 + c.V);
      // the comb-2 baseline: pilot k at 2k, the mean of pilots k and k + 1 at 2k + 1
      const int k = (q >> 1) - c.p0;  // the pilot, in the block's LS slice
      float2 la = make_float2(0.f, 0.f), lb = la;
      if (live && quad == 0) {
        la = c.lsm[s * (c.P + 1) + k];
        lb = c.lsm[s * (c.P + 1) + k + 1];  // the slice clamps k + 1 to the band
      }
      float re = 0.f, im = 0.f;
      if (live) {
        const int j0 = s == 0 ? 1 : 0, j1 = s == c.S - 1 ? 2 : 3;  // symbol taps in the slot
#pragma unroll
        for (int k4 = quad; k4 < CP / 4; k4 += 4) {
          for (int j = j0; j < j1; ++j) {
            const float* xr = c.xs + ((s + j - 1) * (c.P + 2) + qq) * RS + 4 * k4;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              const float4 x = *reinterpret_cast<const float4*>(xr + d * RS);
              const float xv[4] = {operand(x.x, BF16), operand(x.y, BF16), operand(x.z, BF16),
                                   operand(x.w, BF16)};
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const float2 wv = wh[(4 * k4 + kk) * 9 + d * 3 + j];
                re = fmaf(wv.x, xv[kk], re);
                im = fmaf(wv.y, xv[kk], im);
              }
            }
          }
        }
      }
      re += __shfl_xor_sync(0xffffffffu, re, 8);
      im += __shfl_xor_sync(0xffffffffu, im, 8);
      re += __shfl_xor_sync(0xffffffffu, re, 16);
      im += __shfl_xor_sync(0xffffffffu, im, 16);
      if (!live || quad != 0) continue;
      const float2 base2 = (q & 1) ? make_float2(0.5f * (la.x + lb.x), 0.5f * (la.y + lb.y)) : la;
      des[(size_t)q * c.S + s] = make_float2(base2.x + (re + b.x), base2.y + (im + b.y));
    }
  }
}

// three blocks an SM up to 32 channels (168 registers); two above (255)
template <int CP, bool BF16>
__global__ void __launch_bounds__(THREADS, CP <= 32 ? 3 : 2) gated_expert_kernel(Args a) {
  const int rank = blockIdx.x, row = blockIdx.y, ant = blockIdx.z;
  const int ue = a.idx[row];
  if (a.src[ue] < 0) return;  // capacity padding: the whole cluster returns, no barrier

  extern __shared__ __align__(128) unsigned char smem[];
  Ctx c;
  c.wsm = weight_region<CP, BF16>();
  c.xs = reinterpret_cast<float*>(smem);
  float* zero = c.xs + (size_t)a.S * (a.P + 2) * row_stride<CP>();
  for (int i = threadIdx.x; i < row_stride<CP>(); i += THREADS) zero[i] = 0.f;
  c.zero = zero;  // (the stem's first barrier orders these writes before any reader)
  c.lsm = reinterpret_cast<float2*>(zero + row_stride<CP>());
  c.S = a.S;
  c.P = a.P;
  c.np = a.np;
  c.C = a.C;
  c.p0 = rank * a.P;
  c.V = min(a.P, a.np - c.p0);

  const size_t plane = (size_t)a.S * a.np * CP;
  float* h = a.workspace + ((size_t)row * a.n_ant + ant) * 3 * plane;
  float* y = h + plane;  // (S, np, CP); the up-projection's u (S, 2 np, CP)
  const float2* ls = a.h_ls + ((size_t)ue * a.n_ant + ant) * a.S * a.np;
  float2* des = a.designated + ((size_t)ue * a.n_ant + ant) * (size_t)(2 * a.np) * a.S;

  // the pack, layer by layer: stem, R x (conv1, conv2), up, head; each layer
  // (C_in, 3, 3, C_out padded to 4) then its bias
  const int C = a.C, cp4 = (C + 3) / 4 * 4, cup = (2 * C + 3) / 4 * 4;
  const float* wl = a.w;
  const float* bl = a.bias;
  stem<CP, BF16>(c, ls, wl, bl, h);
  wl += 2 * TAPS * cp4;
  bl += cp4;
  cluster_sync();
  // a slice of at most MAXT tiles keeps each layer's output in place for the next
  // layer, so between layers only the halo is fetched; a wider one restages
  const bool keep = (a.S * a.P + 63) / 64 <= maxt<CP>();
  stage<CP>(c, h, a.np, c.p0 - 1);
  for (int r = 0; r < a.R; ++r) {
    tc_layer<CP, BF16>(c, wl, bl, cp4, 0, RELU, 0, y, keep);
    wl += C * TAPS * cp4;
    bl += cp4;
    cluster_sync();
    if (keep) stage_halo<CP>(c, y);
    else stage<CP>(c, y, a.np, c.p0 - 1);
    tc_layer<CP, BF16>(c, wl, bl, cp4, 0, RESIDUAL, 0, h, keep);
    wl += C * TAPS * cp4;
    bl += cp4;
    cluster_sync();
    if (keep) stage_halo<CP>(c, h);
    else stage<CP>(c, h, a.np, c.p0 - 1);
  }
  tc_layer<CP, BF16>(c, wl, bl, cup, 0, SUBPIXEL, 0, y, false);
  tc_layer<CP, BF16>(c, wl, bl, cup, C, SUBPIXEL, 1, y, false);
  wl += C * TAPS * cup;
  bl += cup;
  cluster_sync();
  head<CP, BF16>(c, ls, wl, bl, y, des);
}

// -- the wide form, past WIDEST_CP channels -------------------------------------------

// One tap's KC x KC block of the pack, B[k][n] = the weight of input channel k0 + k
// for pack column col0 + n, zero from k = kv or n = nv on; ``wl`` points at input
// channel k0.  Held as load_tap<KC> holds a tap (tap_element<KC>), for store_tap<KC>.
__device__ __forceinline__ void load_block(float (&wr)[KC * KC / THREADS], const float* wl,
                                           int coutp, int col0, int kv, int nv, int tap) {
  const int n = threadIdx.x % KC;
  const float* w0 = wl + (threadIdx.x / KC * TAPS + tap) * coutp + col0 + n;
#pragma unroll
  for (int i = 0; i < KC * KC / THREADS; ++i) {
    const int k = threadIdx.x / KC + i * (THREADS / KC);
    wr[i] = (n < nv && k < kv) ? __ldg(w0 + i * (THREADS / KC) * TAPS * coutp) : 0.f;
  }
}

// One tensor-core conv of the wide form: out (pack columns col0 .. col0 + C) =
// conv(in) + bias through the epilogue, over chunk-major planes: ``in`` (CW / KC, S,
// np, KC); ``out`` the same, or u (CW / KC, S, 2 np, KC) for SUBPIXEL.  N-chunk by
// N-chunk, tile group by tile group as tc_layer<KC>, each group's sums taken over the
// K-chunks in turn (each one's slice staged from ``in``), tap by tap within one.
template <bool BF16>
__device__ void tc_layer_wide(const Ctx& c, int CW, const float* in, const float* wl,
                              const float* bl, int coutp, int col0, Epilogue epi,
                              int phase, float* out) {
  constexpr int ND = KC / 2;
  constexpr int RS = row_stride<KC>();
  constexpr int MAXT = maxt<KC>();
  constexpr int WTILE = BF16 ? KC * KC / 2 : 2 * KC * KC;
  static_assert(nbuf<KC, BF16>() == 2, "the wide form double-buffers its taps");
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, tig = threadIdx.x % 4;
  const int rows = c.S * c.P, n_tiles = (rows + 63) / 64;
  const size_t chunk_in = (size_t)c.S * c.np * KC;
  const size_t chunk_out = epi == SUBPIXEL ? 2 * chunk_in : chunk_in;
  const uint32_t w_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(weight_region<KC, BF16>()));

#pragma unroll 1
  for (int n0 = 0; n0 < CW; n0 += KC) {
#pragma unroll 1
    for (int g0 = 0; g0 < n_tiles; g0 += MAXT) {
      int rbase[MAXT][2], rsym[MAXT][2];
      unsigned jmask[MAXT];
#pragma unroll
      for (int t = 0; t < MAXT; ++t) {
        const int tile = g0 + t;
        jmask[t] = 0;
        if (tile < n_tiles) {
          const int s_first = tile * 64 / c.P, s_last = min(tile * 64 + 63, rows - 1) / c.P;
          for (int j = 0; j < 3; ++j)
            if (s_last + j - 1 >= 0 && s_first + j - 1 < c.S) jmask[t] |= 1u << j;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = tile * 64 + warp * 16 + g + 8 * h;
          const bool ok = tile < n_tiles && m < rows;
          const int s = ok ? m / c.P : -8, p = ok ? m % c.P : 0;
          rsym[t][h] = s;
          rbase[t][h] = ok ? (s * (c.P + 2) + p) * RS : 0;
        }
      }
      float sum[MAXT][ND];
#pragma unroll
      for (int t = 0; t < MAXT; ++t)
#pragma unroll
        for (int i = 0; i < ND; ++i) sum[t][i] = 0.f;
      float acc[ND];  // a k-tile's accumulator; its first wgmma ignores what it holds
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] = 0.f;
      float wr[KC * KC / THREADS];

#pragma unroll 1
      for (int k0 = 0; k0 < CW; k0 += KC) {
        __syncthreads();  // the last K-chunk's wgmmas have read the slice and the weights
        stage<KC>(c, in + k0 / KC * chunk_in, c.np, c.p0 - 1);
        const float* wk = wl + (size_t)k0 * TAPS * coutp;
        load_block(wr, wk, coutp, col0 + n0, c.C - k0, c.C - n0, 0);
#pragma unroll 1
        for (int tap = 0; tap < TAPS; ++tap) {
          const int d = tap / 3, j = tap % 3;
          store_tap<KC, BF16>(wr, c.wsm + (tap & 1) * WTILE);
          fence_async_smem();
          __syncthreads();  // this tap's B is in place; tap - 1's readers are done
          if (tap + 1 < TAPS) load_block(wr, wk, coutp, col0 + n0, c.C - k0, c.C - n0, tap + 1);
          const int shift = ((j - 1) * (c.P + 2) + d) * RS;
          const uint32_t wb_s = w_s + (tap & 1) * WTILE * 4;
          const uint64_t dhi = smem_desc<(BF16 ? 16 : 32) * KC>(wb_s);
          const uint64_t dlo = smem_desc<32 * KC>(wb_s + KC * KC * 4);
#pragma unroll
          for (int t = 0; t < MAXT; ++t) {
            if (!((jmask[t] >> j) & 1u)) continue;  // uniform across the warpgroup
            const float* x0 = (unsigned)(rsym[t][0] + j - 1) < (unsigned)c.S
                                  ? c.xs + rbase[t][0] + shift : c.zero;
            const float* x1 = (unsigned)(rsym[t][1] + j - 1) < (unsigned)c.S
                                  ? c.xs + rbase[t][1] + shift : c.zero;
            if (BF16) {
              uint32_t a[KC / 16][4];
#pragma unroll
              for (int ks = 0; ks < KC / 16; ++ks) {
                const int k = 16 * ks + 2 * tig;
                const float2 v0 = *reinterpret_cast<const float2*>(x0 + k);
                const float2 v1 = *reinterpret_cast<const float2*>(x1 + k);
                const float2 v2 = *reinterpret_cast<const float2*>(x0 + k + 8);
                const float2 v3 = *reinterpret_cast<const float2*>(x1 + k + 8);
                a[ks][0] = bf16x2(v0.x, v0.y);
                a[ks][1] = bf16x2(v1.x, v1.y);
                a[ks][2] = bf16x2(v2.x, v2.y);
                a[ks][3] = bf16x2(v3.x, v3.y);
              }
              wgmma_fence();
#pragma unroll
              for (int ks = 0; ks < KC / 16; ++ks) Mma<KC>::bf16(acc, a[ks], dhi + 16 * ks, ks > 0);
            } else {
              uint32_t ah[KC / 8][4], al[KC / 8][4];
#pragma unroll
              for (int ks = 0; ks < KC / 8; ++ks) {
                const int k = 8 * ks + tig;
                split(x0[k], ah[ks][0], al[ks][0]);
                split(x1[k], ah[ks][1], al[ks][1]);
                split(x0[k + 4], ah[ks][2], al[ks][2]);
                split(x1[k + 4], ah[ks][3], al[ks][3]);
              }
              // a fresh accumulator for the k-tile: lo*hi and hi*lo of every k8 step,
              // then hi*hi, in k order
              wgmma_fence();
#pragma unroll
              for (int ks = 0; ks < KC / 8; ++ks) {
                Mma<KC>::tf32(acc, al[ks], dhi + 16 * ks, ks > 0);
                Mma<KC>::tf32(acc, ah[ks], dlo + 16 * ks, 1);
              }
#pragma unroll
              for (int ks = 0; ks < KC / 8; ++ks) Mma<KC>::tf32(acc, ah[ks], dhi + 16 * ks, 1);
            }
            wgmma_commit();
            wgmma_wait();
#pragma unroll
            for (int i = 0; i < ND; ++i) sum[t][i] += acc[i];
          }
        }
      }

      // the epilogue of tc_layer, for output channels n0 .. n0 + KC, into the plane
#pragma unroll
      for (int t = 0; t < MAXT; ++t) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (g0 + t) * 64 + warp * 16 + g + 8 * h;
          if (g0 + t >= n_tiles || m >= rows) continue;
          const int s = m / c.P, p = m % c.P;
          if (p >= c.V) continue;  // past the band: the last block's tail
          const int q = c.p0 + p;
          float2 v[KC / 8];
#pragma unroll
          for (int j8 = 0; j8 < KC / 8; ++j8) {
            const int n = n0 + 8 * j8 + 2 * tig;
            v[j8] = make_float2(sum[t][4 * j8 + 2 * h] + (n < c.C ? __ldg(bl + col0 + n) : 0.f),
                                sum[t][4 * j8 + 2 * h + 1] +
                                    (n + 1 < c.C ? __ldg(bl + col0 + n + 1) : 0.f));
          }
          float* dst = out + n0 / KC * chunk_out + 2 * tig +
                       (epi == SUBPIXEL ? ((size_t)s * 2 * c.np + 2 * q + phase) * KC
                                        : ((size_t)s * c.np + q) * KC);
          if (epi == RESIDUAL) {  // h + conv(y); h was written by this block at an earlier layer
            float2 r[KC / 8];
#pragma unroll
            for (int j8 = 0; j8 < KC / 8; ++j8) r[j8] = __ldcg(reinterpret_cast<float2*>(dst + 8 * j8));
#pragma unroll
            for (int j8 = 0; j8 < KC / 8; ++j8)
              v[j8] = make_float2(r[j8].x + v[j8].x, r[j8].y + v[j8].y);
          } else if (epi == RELU) {  // keeps NaN, as torch.relu
#pragma unroll
            for (int j8 = 0; j8 < KC / 8; ++j8)
              v[j8] = make_float2(v[j8].x < 0.f ? 0.f : v[j8].x, v[j8].y < 0.f ? 0.f : v[j8].y);
          }
#pragma unroll
          for (int j8 = 0; j8 < KC / 8; ++j8) *reinterpret_cast<float2*>(dst + 8 * j8) = v[j8];
        }
      }
    }
  }
}

// The wide form's stem: as stem(), the output channels a chunk of KC at a time into
// the chunk-major h (CW / KC, S, np, KC); ``ws`` (19, CW) in dynamic shared memory.
template <bool BF16, bool GW>
__device__ void stem_wide(const Ctx& c, int CW, float* ws, const float2* __restrict__ ls,
                          const float* wl, const float* bl, float* h) {
  const int cp4 = (c.C + 3) / 4 * 4;
  if constexpr (!GW) {
    for (int i = threadIdx.x; i < 19 * CW; i += THREADS) {
      const int o = i % CW, r = i / CW;
      ws[i] = o < c.C ? (r < 18 ? wl[r * cp4 + o] : bl[o]) : 0.f;
    }
  }
  __syncthreads();
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  const size_t chunk = (size_t)c.S * c.np * KC;
  for (int item = threadIdx.x; item < c.S * c.V; item += THREADS) {
    const int s = item / c.V, q = c.p0 + item % c.V;
    float2 z[3][3];  // the 3x3 neighbourhood, zero outside the band and the slot
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int qi = q + d - 1, si = s + j - 1;
        z[d][j] = (qi >= 0 && qi < c.np && si >= 0 && si < c.S) ? ls[(size_t)si * c.np + qi]
                                                                : make_float2(0.f, 0.f);
      }
#pragma unroll 1
    for (int o0 = 0; o0 < CW; o0 += KC) {
      float acc[KC];
#pragma unroll
      for (int o = 0; o < KC; ++o) acc[o] = 0.f;
#pragma unroll 1
      for (int ch = 0; ch < 2; ++ch)
#pragma unroll
        for (int d = 0; d < 3; ++d)
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float x = operand(ch == 0 ? z[d][j].x : z[d][j].y, BF16);
            const float4* wv = w4 + (((ch * 3 + d) * 3 + j) * CW + o0) / 4;
#pragma unroll
            for (int o4 = 0; o4 < KC / 4; ++o4) {
              float4 wo;
              if constexpr (GW)  // the packed (C, 3, 3, cp4) stem, zero past cp4
                wo = o0 + 4 * o4 < cp4 ? __ldg(reinterpret_cast<const float4*>(
                                             wl + ((ch * 3 + d) * 3 + j) * cp4 + o0) + o4)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
              else
                wo = wv[o4];
              acc[4 * o4] = fmaf(wo.x, x, acc[4 * o4]);
              acc[4 * o4 + 1] = fmaf(wo.y, x, acc[4 * o4 + 1]);
              acc[4 * o4 + 2] = fmaf(wo.z, x, acc[4 * o4 + 2]);
              acc[4 * o4 + 3] = fmaf(wo.w, x, acc[4 * o4 + 3]);
            }
          }
      float4* dst = reinterpret_cast<float4*>(h + o0 / KC * chunk + ((size_t)s * c.np + q) * KC);
#pragma unroll
      for (int o4 = 0; o4 < KC / 4; ++o4) {
        float4 b;
        if constexpr (GW)
          b = o0 + 4 * o4 < cp4 ? __ldg(reinterpret_cast<const float4*>(bl + o0) + o4)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        else
          b = w4[(18 * CW + o0) / 4 + o4];
        dst[o4] = make_float4(acc[4 * o4] + b.x, acc[4 * o4 + 1] + b.y, acc[4 * o4 + 2] + b.z,
                              acc[4 * o4 + 3] + b.w);
      }
    }
  }
}

// The wide form's head: as head(), u read from the chunk-major (CW / KC, S, 2 np, KC)
// and staged with every channel, Q positions (head_positions) at a time, in rows of
// CW + 4 floats; ``wh`` (CW, 3, 3) then the bias, in dynamic shared memory.
template <bool BF16>
__device__ void head_wide(const Ctx& c, int CW, float2* wh, const float2* __restrict__ ls,
                          const float* wl, const float* bl, const float* u,
                          float2* __restrict__ des) {
  const int RS = CW + 4, Q = head_positions(c.P, CW), CH = CW / 4;
  for (int i = threadIdx.x; i < CW * 9 + 1; i += THREADS) {
    const int k = i / 9;
    wh[i] = i == CW * 9 ? make_float2(bl[0], bl[1])
                        : (k < c.C ? make_float2(wl[i * 4], wl[i * 4 + 1]) : make_float2(0.f, 0.f));
  }
  for (int i = threadIdx.x; i < c.S * (c.P + 1); i += THREADS) {
    const int s = i / (c.P + 1), k = min(c.p0 + i % (c.P + 1), c.np - 1);
    c.lsm[i] = ls[(size_t)s * c.np + k];
  }
  const size_t chunk = (size_t)c.S * 2 * c.np * KC;
  for (int part = 0; part * Q < 2 * c.V; ++part) {
    const int q_first = 2 * c.p0 + part * Q;
    __syncthreads();  // the last part's readers of xs are done (the first: wh, lsm written)
    for (int i = threadIdx.x; i < c.S * (Q + 2) * CH; i += THREADS) {
      const int ch = i % CH, r = i / CH, pp = r % (Q + 2), s = r / (Q + 2);
      const int q = q_first - 1 + pp;
      const bool ok = q >= 0 && q < 2 * c.np;
      const float* src = u + ch / (KC / 4) * chunk + ((size_t)s * 2 * c.np + q) * KC +
                         4 * (ch % (KC / 4));
      cp_async16(c.xs + r * RS + 4 * ch, ok ? src : u, ok ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();
    const float2 b = wh[CW * 9];
    // four lanes an output, as head(): lane ``quad`` sums channel groups quad, quad + 4, ...
    const int lane = threadIdx.x % 32, quad = lane / 8;
    for (int base = 0; base < c.S * Q; base += THREADS / 4) {  // uniform trip count
      const int item = base + threadIdx.x / 32 * 8 + lane % 8;
      const int s = item / Q, qq = item % Q, q = q_first + qq;
      const bool live = item < c.S * Q && q < 2 * (c.p0 + c.V);
      const int k = (q >> 1) - c.p0;  // the pilot, in the block's LS slice
      float2 la = make_float2(0.f, 0.f), lb = la;
      if (live && quad == 0) {
        la = c.lsm[s * (c.P + 1) + k];
        lb = c.lsm[s * (c.P + 1) + k + 1];
      }
      float re = 0.f, im = 0.f;
      if (live) {
        const int j0 = s == 0 ? 1 : 0, j1 = s == c.S - 1 ? 2 : 3;
        for (int k4 = quad; k4 < CH; k4 += 4) {
          for (int j = j0; j < j1; ++j) {
            const float* xr = c.xs + ((s + j - 1) * (Q + 2) + qq) * RS + 4 * k4;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              const float4 x = *reinterpret_cast<const float4*>(xr + d * RS);
              const float xv[4] = {operand(x.x, BF16), operand(x.y, BF16), operand(x.z, BF16),
                                   operand(x.w, BF16)};
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const float2 wv = wh[(4 * k4 + kk) * 9 + d * 3 + j];
                re = fmaf(wv.x, xv[kk], re);
                im = fmaf(wv.y, xv[kk], im);
              }
            }
          }
        }
      }
      re += __shfl_xor_sync(0xffffffffu, re, 8);
      im += __shfl_xor_sync(0xffffffffu, im, 8);
      re += __shfl_xor_sync(0xffffffffu, re, 16);
      im += __shfl_xor_sync(0xffffffffu, im, 16);
      if (!live || quad != 0) continue;
      const float2 base2 = (q & 1) ? make_float2(0.5f * (la.x + lb.x), 0.5f * (la.y + lb.y)) : la;
      des[(size_t)q * c.S + s] = make_float2(base2.x + (re + b.x), base2.y + (im + b.y));
    }
  }
}

// The global-weight variant's head: as head_wide, every output summed in the same
// order, but u read straight from the workspace (L2, ld.global.cg: other blocks of the
// cluster wrote it) and the weights from the packed (C, 3, 3, 4) head in global memory.
template <bool BF16>
__device__ void head_wide_global(const Ctx& c, int CW, const float2* __restrict__ ls,
                                 const float* wl, const float* bl, const float* u,
                                 float2* __restrict__ des) {
  const int CH = CW / 4;
  for (int i = threadIdx.x; i < c.S * (c.P + 1); i += THREADS) {
    const int s = i / (c.P + 1), k = min(c.p0 + i % (c.P + 1), c.np - 1);
    c.lsm[i] = ls[(size_t)s * c.np + k];
  }
  __syncthreads();
  const size_t chunk = (size_t)c.S * 2 * c.np * KC;
  const float2 b = make_float2(__ldg(bl), __ldg(bl + 1));
  const int lane = threadIdx.x % 32, quad = lane / 8, n_out = c.S * 2 * c.V;
  for (int base = 0; base < n_out; base += THREADS / 4) {  // uniform trip count
    const int item = base + threadIdx.x / 32 * 8 + lane % 8;
    const bool live = item < n_out;
    const int s = live ? item / (2 * c.V) : 0, q = 2 * c.p0 + (live ? item % (2 * c.V) : 0);
    const int k = (q >> 1) - c.p0;  // the pilot, in the block's LS slice
    float2 la = make_float2(0.f, 0.f), lb = la;
    if (live && quad == 0) {
      la = c.lsm[s * (c.P + 1) + k];
      lb = c.lsm[s * (c.P + 1) + k + 1];
    }
    float re = 0.f, im = 0.f;
    if (live) {
      const int j0 = s == 0 ? 1 : 0, j1 = s == c.S - 1 ? 2 : 3;
      for (int k4 = quad; k4 < CH; k4 += 4) {
        const float* uk = u + k4 / (KC / 4) * chunk + 4 * (k4 % (KC / 4));
        for (int j = j0; j < j1; ++j) {
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const int qi = q + d - 1;
            const float4 x =
                qi >= 0 && qi < 2 * c.np
                    ? __ldcg(reinterpret_cast<const float4*>(
                          uk + ((size_t)(s + j - 1) * 2 * c.np + qi) * KC))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
            const float xv[4] = {operand(x.x, BF16), operand(x.y, BF16), operand(x.z, BF16),
                                 operand(x.w, BF16)};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int kc = 4 * k4 + kk;
              const float2 wv = kc < c.C ? __ldg(reinterpret_cast<const float2*>(
                                               wl + ((size_t)kc * 9 + d * 3 + j) * 4))
                                         : make_float2(0.f, 0.f);
              re = fmaf(wv.x, xv[kk], re);
              im = fmaf(wv.y, xv[kk], im);
            }
          }
        }
      }
    }
    re += __shfl_xor_sync(0xffffffffu, re, 8);
    im += __shfl_xor_sync(0xffffffffu, im, 8);
    re += __shfl_xor_sync(0xffffffffu, re, 16);
    im += __shfl_xor_sync(0xffffffffu, im, 16);
    if (!live || quad != 0) continue;
    const float2 base2 = (q & 1) ? make_float2(0.5f * (la.x + lb.x), 0.5f * (la.y + lb.y)) : la;
    des[(size_t)q * c.S + s] = make_float2(base2.x + (re + b.x), base2.y + (im + b.y));
  }
}

// The wide form: the CP 32 form's block (registers, static weight tiles, three blocks
// an SM) over chunk-major planes of CW = plane_width(C) channels; with GW the
// global-weight variant (wide_gw_smem_bytes).
template <bool BF16, bool GW>
__global__ void __launch_bounds__(THREADS, 3) gated_expert_wide_kernel(Args a) {
  const int rank = blockIdx.x, row = blockIdx.y, ant = blockIdx.z;
  const int ue = a.idx[row];
  if (a.src[ue] < 0) return;  // capacity padding: the whole cluster returns, no barrier

  extern __shared__ __align__(128) unsigned char smem[];
  const int CW = (a.C + KC - 1) / KC * KC;
  Ctx c;
  c.wsm = weight_region<KC, BF16>();
  c.xs = reinterpret_cast<float*>(smem);
  float* zero = c.xs + (GW ? gw_slice_floats(a.S, a.P) : wide_slice_floats(a.S, a.P, CW));
  for (int i = threadIdx.x; i < row_stride<KC>(); i += THREADS) zero[i] = 0.f;
  c.zero = zero;  // (the stem's first barrier orders these writes before any reader)
  c.lsm = reinterpret_cast<float2*>(zero + row_stride<KC>());
  float* misc = zero + row_stride<KC>() + lsm_floats(a.S, a.P);  // stem, then head weights
  c.S = a.S;
  c.P = a.P;
  c.np = a.np;
  c.C = a.C;
  c.p0 = rank * a.P;
  c.V = min(a.P, a.np - c.p0);

  const size_t plane = (size_t)a.S * a.np * CW;
  float* h = a.workspace + ((size_t)row * a.n_ant + ant) * 3 * plane;
  float* y = h + plane;  // chunk-major (CW / KC, S, np, KC); u (CW / KC, S, 2 np, KC)
  const float2* ls = a.h_ls + ((size_t)ue * a.n_ant + ant) * a.S * a.np;
  float2* des = a.designated + ((size_t)ue * a.n_ant + ant) * (size_t)(2 * a.np) * a.S;

  const int C = a.C, cp4 = (C + 3) / 4 * 4, cup = (2 * C + 3) / 4 * 4;
  const float* wl = a.w;
  const float* bl = a.bias;
  stem_wide<BF16, GW>(c, CW, misc, ls, wl, bl, h);
  wl += 2 * TAPS * cp4;
  bl += cp4;
  cluster_sync();
  for (int r = 0; r < a.R; ++r) {
    tc_layer_wide<BF16>(c, CW, h, wl, bl, cp4, 0, RELU, 0, y);
    wl += C * TAPS * cp4;
    bl += cp4;
    cluster_sync();
    tc_layer_wide<BF16>(c, CW, y, wl, bl, cp4, 0, RESIDUAL, 0, h);
    wl += C * TAPS * cp4;
    bl += cp4;
    cluster_sync();
  }
  tc_layer_wide<BF16>(c, CW, h, wl, bl, cup, 0, SUBPIXEL, 0, y);
  tc_layer_wide<BF16>(c, CW, h, wl, bl, cup, C, SUBPIXEL, 1, y);
  wl += C * TAPS * cup;
  bl += cup;
  cluster_sync();
  if constexpr (GW)
    head_wide_global<BF16>(c, CW, ls, wl, bl, y, des);
  else
    head_wide<BF16>(c, CW, reinterpret_cast<float2*>(misc), ls, wl, bl, y, des);
}

// The kernel of a width: the CP form, or the wide form (CP is then KC, the chunk),
// with GW its global-weight variant.
template <int CP, bool BF16, bool WIDE, bool GW = false>
void (*kernel_of())(Args) {
  if constexpr (WIDE) return gated_expert_wide_kernel<BF16, GW>;
  else return gated_expert_kernel<CP, BF16>;
}

// the largest dynamic shared memory a block may take beside the static weight region,
// per device; the kernel's limit is raised to it once per device and instantiation
template <int CP, bool BF16, bool WIDE, bool GW = false>
int prepare(int dev, int* optin) {
  static std::atomic<int> limit[64];
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int lim = limit[dev].load(std::memory_order_acquire);
  if (lim == 0) {
    cudaError_t err = cudaDeviceGetAttribute(&lim, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    lim -= static_cast<int>(weight_bytes<CP, BF16>());
    err = cudaFuncSetAttribute(kernel_of<CP, BF16, WIDE, GW>(),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, lim);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit[dev].store(lim, std::memory_order_release);
  }
  *optin = lim;
  return 0;
}

template <int CP, bool BF16, bool WIDE = false, bool GW = false>
int launch(const Args& a, int capacity, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = prepare<CP, BF16, WIDE, GW>(dev, &optin);
  if (rc != 0) return rc;
  const Geometry geo = geometry(a.np);
  const size_t smem = GW     ? wide_gw_smem_bytes(a.S, geo.P)
                      : WIDE ? wide_smem_bytes(a.S, geo.P, plane_width(a.C))
                             : smem_bytes<CP>(a.S, geo.P);
  if (smem > (size_t)optin) return static_cast<int>(cudaErrorInvalidValue);
  Args args = a;
  args.P = geo.P;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(geo.cluster, capacity, a.n_ant);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel_of<CP, BF16, WIDE, GW>(), args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks a (row, antenna) chain's cluster takes at Np pilots.
extern "C" int gated_expert_cluster_size(int np) { return geometry(np).cluster; }

// Shared memory a block takes, static and dynamic, in bytes (the wrapper checks it
// against the card).
template <int CP>
long long block_smem(int n_sym, int P, int bf16) {
  return smem_bytes<CP>(n_sym, P) + (bf16 ? weight_bytes<CP, true>() : weight_bytes<CP, false>());
}

// ``global_weights`` asks for the wide form's global-weight variant (past WIDEST_CP).
extern "C" long long gated_expert_smem_bytes(int n_sym, int np, int C, int bf16,
                                             int global_weights) {
  const int P = geometry(np).P;
  if (C > WIDEST_CP)
    return (global_weights ? wide_gw_smem_bytes(n_sym, P)
                           : wide_smem_bytes(n_sym, P, plane_width(C))) +
           (bf16 ? weight_bytes<KC, true>() : weight_bytes<KC, false>());
  switch (channel_pad(C)) {
    case 16: return block_smem<16>(n_sym, P, bf16);
    case 32: return block_smem<32>(n_sym, P, bf16);
    case 48: return block_smem<48>(n_sym, P, bf16);
    default: return block_smem<64>(n_sym, P, bf16);
  }
}

// Workspace floats per (compact row, antenna): h, and y that u reuses.
extern "C" long long gated_expert_workspace_floats(int n_sym, int np, int C) {
  return 3LL * n_sym * np * plane_width(C);
}

extern "C" int gated_expert_launch(const void* idx, const void* src, const void* h_ls,
                                   void* designated, const void* w, const void* bias,
                                   void* workspace, int capacity, int n_ant, int n_sym,
                                   int np, int C, int R, int bf16, int global_weights,
                                   void* stream) {
  if (C < 1 || n_sym < 1 || np < 1 || capacity < 1 || (global_weights && C <= WIDEST_CP))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const int32_t*>(idx), static_cast<const int32_t*>(src),
         static_cast<const float2*>(h_ls), static_cast<float2*>(designated),
         static_cast<const float*>(w), static_cast<const float*>(bias),
         static_cast<float*>(workspace), n_ant, n_sym, np, C, R, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > WIDEST_CP && global_weights)
    return bf16 ? launch<KC, true, true, true>(a, capacity, st)
                : launch<KC, false, true, true>(a, capacity, st);
  if (C > WIDEST_CP)
    return bf16 ? launch<KC, true, true>(a, capacity, st) : launch<KC, false, true>(a, capacity, st);
  switch (channel_pad(C)) {
    case 16: return bf16 ? launch<16, true>(a, capacity, st) : launch<16, false>(a, capacity, st);
    case 32: return bf16 ? launch<32, true>(a, capacity, st) : launch<32, false>(a, capacity, st);
    case 48: return bf16 ? launch<48, true>(a, capacity, st) : launch<48, false>(a, capacity, st);
    default: return bf16 ? launch<64, true>(a, capacity, st) : launch<64, false>(a, capacity, st);
  }
}
