// MMSE/Wiener frequency interpolation: H_full (B, Nsc) = H_pilot (B, Np) @ W (Np, Nsc),
// complex64 in and out, IEEE fp32 arithmetic on the CUDA cores.
//
// Replaces: src/repro/kernels/mmse_interp/mmse_interp.py::mmse_interp_2d (Pallas TPU
// kernel _mmse_interp_kernel), reached through ops.py::mmse_interp.
//
// What bounds it on the H100: arithmetic.  At the paper's slot (B = U x 4 antennas x
// 3 DMRS symbols, Np = 636, Nsc = 1272) the Gauss form costs 3 real GEMMs,
// 6 * B * Np * Nsc flops, against B*Np + Np*Nsc + B*Nsc complex values moved: about
// 150 flops per byte at U = 32, far above the fp32 ridge point (~20 flops/byte), so
// the kernel is bound by the fp32 FMA rate, not by HBM.  TF32 tensor cores would be
// faster but round operands to a 10-bit mantissa, which the float32 contract of the
// expert forbids.
//
// Design: a classic shared-memory tiled SGEMM that computes both planes in one pass
// with the Gauss 3-multiply form the reference uses:
//     p1 = Hr Wr,  p2 = Hi Wi,  p3 = (Hr + Hi)(Wr + Wi);  re = p1 - p2,  im = p3 - p1 - p2
// A 64 x 64 output tile per 256-thread block, K-steps of 16.  The loader reads the
// interleaved complex inputs directly (one float2 per complex value, neighbouring
// threads on neighbouring addresses), forms Hr+Hi and Wr+Wi while staging, and masks
// the ragged edges itself, so the wrapper makes no padded or de-interleaved copies.
// Each thread keeps a 4 x 4 micro-tile of three accumulators in registers.  wgmma and
// TMA staging are later work; this is the simple, exact-fp32 version.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // rows of H per block
constexpr int BN = 64;   // subcarriers per block
constexpr int BK = 16;   // pilots per K-step
constexpr int TPB = 256; // threads per block (16 x 16)

__global__ void __launch_bounds__(TPB)
mmse_interp_kernel(const float2* __restrict__ h, const float2* __restrict__ w,
                   float2* __restrict__ out, int B, int Np, int Nsc) {
  __shared__ float hr_s[BK][BM], hi_s[BK][BM], hs_s[BK][BM];
  __shared__ float wr_s[BK][BN], wi_s[BK][BN], ws_s[BK][BN];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float p1[4][4] = {}, p2[4][4] = {}, p3[4][4] = {};

  for (int k0 = 0; k0 < Np; k0 += BK) {
    // stage H[row0:row0+BM, k0:k0+BK] (k fastest across threads) ...
#pragma unroll
    for (int i = 0; i < (BM * BK) / TPB; ++i) {
      const int e = threadIdx.x + i * TPB;
      const int r = e / BK, k = e % BK;
      const int gr = row0 + r, gk = k0 + k;
      float2 v = make_float2(0.f, 0.f);
      if (gr < B && gk < Np) v = h[(size_t)gr * Np + gk];
      hr_s[k][r] = v.x;
      hi_s[k][r] = v.y;
      hs_s[k][r] = v.x + v.y;
    }
    // ... and W[k0:k0+BK, col0:col0+BN] (columns fastest across threads)
#pragma unroll
    for (int i = 0; i < (BK * BN) / TPB; ++i) {
      const int e = threadIdx.x + i * TPB;
      const int k = e / BN, c = e % BN;
      const int gk = k0 + k, gc = col0 + c;
      float2 v = make_float2(0.f, 0.f);
      if (gk < Np && gc < Nsc) v = w[(size_t)gk * Nsc + gc];
      wr_s[k][c] = v.x;
      wi_s[k][c] = v.y;
      ws_s[k][c] = v.x + v.y;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float ar[4], ai[4], as[4], br[4], bi[4], bs[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ar[i] = hr_s[k][ty + 16 * i];
        ai[i] = hi_s[k][ty + 16 * i];
        as[i] = hs_s[k][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        br[j] = wr_s[k][tx + 16 * j];
        bi[j] = wi_s[k][tx + 16 * j];
        bs[j] = ws_s[k][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p1[i][j] = fmaf(ar[i], br[j], p1[i][j]);
          p2[i][j] = fmaf(ai[i], bi[j], p2[i][j]);
          p3[i][j] = fmaf(as[i], bs[j], p3[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc >= Nsc) continue;
      out[(size_t)gr * Nsc + gc] =
          make_float2(p1[i][j] - p2[i][j], p3[i][j] - p1[i][j] - p2[i][j]);
    }
  }
}

}  // namespace

extern "C" int mmse_interp_launch(const void* h, const void* w, void* out, int B,
                                  int Np, int Nsc, void* stream) {
  dim3 grid((Nsc + BN - 1) / BN, (B + BM - 1) / BM);
  mmse_interp_kernel<<<grid, TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(h), static_cast<const float2*>(w),
      static_cast<float2*>(out), B, Np, Nsc);
  return static_cast<int>(cudaGetLastError());
}
