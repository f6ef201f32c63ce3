// The fused GATED hot path: gather -> residual-CNN channel estimator -> scatter, in
// one kernel, IEEE fp32 arithmetic on the CUDA cores (bf16 operands optional).
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
// GEMMs, computed directly: the folded form's two structurally zero tap blocks
// (|w_in - w_out| = 2) are skipped, the rest is the same arithmetic in another order.
// bf16 mode rounds every conv operand to bf16 (round to nearest even) and keeps the
// products, sums, bias and residual adds in fp32, as the plain version does.
//
// What bounds it on the H100: arithmetic.  At the paper's width (32 channels, 4
// residual blocks, Np = 636) one UE costs about 1.1 GFLOP as direct convolutions
// (1.43 GFLOP in the folded form) against 122 KB of input and output, so fp32 FMA
// throughput is the limit.  TF32 tensor cores would round operands to a 10-bit
// mantissa, which the estimator's float32 contract forbids.
//
// Design: one 512-thread block per (compact row, antenna) -- the GEMM columns of
// different antennas never mix.  The 2R + 3 layers run in sequence inside the block;
// activations live in a per-block workspace in device memory (L2-resident at the main
// path's size) that the wrapper allocates: h (C, S, Np), and y (C, S, Np) that the
// up-projection reuses as u (C, S, 2 Np).  Per layer the block stages the layer's
// weights in shared memory as (C_in, 3, 3, C_out) and walks the subcarrier axis in
// tiles of 128: it stages the tile's input for every channel and symbol, with a
// one-subcarrier halo on each side (zero outside the band), and each warp computes 4
// output channels x S symbols x 2 subcarriers per lane from registers.  Each output
// is summed in one fixed order (input channel, subcarrier tap, symbol tap), whatever
// the capacity or the row's position, so one UE's estimate is bitwise the same at any
// K.  A tiled form that keeps activations in shared memory with growing halos, and
// wgmma, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPB = 512;
constexpr int NWARP = TPB / 32;
constexpr int SUB = 64;             // subcarriers per warp task (2 per lane)
constexpr int TILE = 128;           // subcarriers per staged tile
constexpr int HALO = TILE + 2;      // staged row: one halo subcarrier each side
constexpr int OB = 4;               // output channels per warp task
constexpr int KH = 3, KW = 3;       // (subcarrier, symbol) taps

enum Epilogue { STORE, RELU, RESIDUAL, SUBPIXEL, HEAD };

// The largest layer's weights (the up-projection's) plus one staged input tile.
long long gated_expert_smem_floats(int n_sym, int C) {
  const long long cp2 = (2LL * C + OB - 1) / OB * OB;
  return (long long)C * KH * KW * cp2 + (long long)C * n_sym * HALO;
}

__device__ __forceinline__ float operand(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// One 3x3 'SAME' conv layer over (cin, S, L) -> (cout, S, L), run by the whole block.
// ``in`` is a workspace activation, or null for the stem, which reads the UE's complex
// LS row ``ls`` (S, L) as two channels (real, imaginary).  ``w`` is (cin, 3, 3,
// cout_p), ``b`` (cout_p), with cout_p the channel count rounded up to OB.
template <int S, bool BF16>
__device__ void conv_layer(const float* in, const float2* __restrict__ ls, int cin,
                           int cout, int L, const float* __restrict__ w,
                           const float* __restrict__ b, Epilogue epi, float* out,
                           float2* __restrict__ des, float* smem) {
  const int cout_p = (cout + OB - 1) / OB * OB;
  const int n_ob = cout_p / OB;
  float* ws = smem;                              // (cin, 3, 3, cout_p)
  float* xs = smem + cin * KH * KW * cout_p;     // (cin, S, HALO)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  __syncthreads();  // the previous layer's readers of smem are done
  for (int i = threadIdx.x; i < cin * KH * KW * cout_p; i += TPB)
    ws[i] = w[i];  // bf16 engines pack weights already rounded

  for (int t0 = 0; t0 < L; t0 += TILE) {
    __syncthreads();  // the previous tile's readers of xs are done
    for (int i = threadIdx.x; i < cin * S * HALO; i += TPB) {
      const int q = i % HALO, cs = i / HALO;
      const int p = t0 - 1 + q;
      float v = 0.f;
      if (p >= 0 && p < L) {
        if (in != nullptr) {
          v = in[(size_t)cs * L + p];
        } else {
          const float2 z = ls[(size_t)(cs % S) * L + p];
          v = (cs / S == 0) ? z.x : z.y;
        }
      }
      xs[i] = operand(v, BF16);
    }
    __syncthreads();

    for (int task = warp; task < n_ob * (TILE / SUB); task += NWARP) {
      const int ob = task % n_ob, sub = task / n_ob;
      const int pl = sub * SUB + lane;  // local subcarriers pl and pl + 32
      float acc[OB][S][2];
#pragma unroll
      for (int o = 0; o < OB; ++o)
#pragma unroll
        for (int s = 0; s < S; ++s) acc[o][s][0] = acc[o][s][1] = 0.f;

      for (int c = 0; c < cin; ++c) {
        float xa[S][KH], xb[S][KH];
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int d = 0; d < KH; ++d) {
            xa[s][d] = xs[(c * S + s) * HALO + pl + d];
            xb[s][d] = xs[(c * S + s) * HALO + pl + 32 + d];
          }
        const float4* wc =
            reinterpret_cast<const float4*>(ws + c * KH * KW * cout_p) + ob;
#pragma unroll
        for (int d = 0; d < KH; ++d)
#pragma unroll
          for (int j = 0; j < KW; ++j) {
            const float4 wv = wc[(d * KW + j) * n_ob];
            const float wo[OB] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int so = 0; so < S; ++so) {
              const int si = so + j - 1;  // symbol tap; outside [0, S) is padding
              if (si < 0 || si >= S) continue;
#pragma unroll
              for (int o = 0; o < OB; ++o) {
                acc[o][so][0] = fmaf(wo[o], xa[si][d], acc[o][so][0]);
                acc[o][so][1] = fmaf(wo[o], xb[si][d], acc[o][so][1]);
              }
            }
          }
      }

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = t0 + pl + 32 * half;
        if (p >= L) continue;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (epi == HEAD) {
            // out = comb-2 baseline + head correction, written as one complex value
            const int k = p >> 1;
            const float2 a = ls[(size_t)s * (L / 2) + k];
            float2 base = a;
            if (p & 1) {
              const float2 n = ls[(size_t)s * (L / 2) + min(k + 1, L / 2 - 1)];
              base = make_float2(0.5f * (a.x + n.x), 0.5f * (a.y + n.y));
            }
            des[(size_t)p * S + s] = make_float2(base.x + (acc[0][s][half] + b[0]),
                                                 base.y + (acc[1][s][half] + b[1]));
            continue;
          }
#pragma unroll
          for (int o = 0; o < OB; ++o) {
            const int oc = ob * OB + o;
            if (oc >= cout) continue;
            const float v = acc[o][s][half] + b[oc];
            if (epi == SUBPIXEL) {
              // up-projection channel r * C + c at subcarrier p -> channel c at 2p + r
              const int C = cout / 2, r = oc / C, ch = oc % C;
              out[((size_t)ch * S + s) * (2 * L) + 2 * p + r] = v;
            } else {
              float* dst = out + ((size_t)oc * S + s) * L + p;
              if (epi == RELU) *dst = v < 0.f ? 0.f : v;  // keeps NaN, as torch.relu
              else if (epi == RESIDUAL) *dst = *dst + v;
              else *dst = v;
            }
          }
        }
      }
    }
  }
}

template <int S, bool BF16>
__global__ void __launch_bounds__(TPB, 1)
gated_expert_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ src,
                    const float2* __restrict__ h_ls, float2* __restrict__ designated,
                    const float* __restrict__ w, const float* __restrict__ bias,
                    float* workspace, int n_ant, int np, int C, int R) {
  const int row = blockIdx.x, ant = blockIdx.y;
  const int u = idx[row];
  if (src[u] < 0) return;  // capacity padding: the UE keeps its buffer

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const size_t act = (size_t)C * S * np;
  float* h = workspace + ((size_t)row * n_ant + ant) * 3 * act;
  float* y = h + act;  // (C, S, Np); the up-projection's (C, S, 2 Np) output
  const float2* ls = h_ls + ((size_t)u * n_ant + ant) * S * np;
  float2* des = designated + ((size_t)u * n_ant + ant) * (size_t)(2 * np) * S;

  // packed operands, layer by layer: stem, R x (conv1, conv2), up, head; each
  // layer's output channels padded to a multiple of OB
  const int cp = (C + OB - 1) / OB * OB, cp2 = (2 * C + OB - 1) / OB * OB;
  const float* wl = w;
  const float* bl = bias;
  conv_layer<S, BF16>(nullptr, ls, 2, C, np, wl, bl, STORE, h, des, smem);
  wl += 2 * KH * KW * cp; bl += cp;
  for (int r = 0; r < R; ++r) {
    conv_layer<S, BF16>(h, ls, C, C, np, wl, bl, RELU, y, des, smem);
    wl += C * KH * KW * cp; bl += cp;
    conv_layer<S, BF16>(y, ls, C, C, np, wl, bl, RESIDUAL, h, des, smem);
    wl += C * KH * KW * cp; bl += cp;
  }
  conv_layer<S, BF16>(h, ls, C, 2 * C, np, wl, bl, SUBPIXEL, y, des, smem);
  wl += C * KH * KW * cp2; bl += cp2;
  conv_layer<S, BF16>(y, ls, C, 2, 2 * np, wl, bl, HEAD, nullptr, des, smem);
}

template <int S, bool BF16>
int launch(const void* idx, const void* src, const void* h_ls, void* designated,
           const void* w, const void* bias, void* workspace, int capacity, int n_ant,
           int np, int C, int R, cudaStream_t stream) {
  const size_t smem = (size_t)gated_expert_smem_floats(S, C) * sizeof(float);
  auto kernel = gated_expert_kernel<S, BF16>;
  static size_t granted = 0;  // the opt-in above 48 KB, once per size
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  kernel<<<dim3(capacity, n_ant), TPB, smem, stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(src),
      static_cast<const float2*>(h_ls), static_cast<float2*>(designated),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(workspace), n_ant, np, C, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the kernel asks for, in bytes (the wrapper checks it against the card).
extern "C" long long gated_expert_smem_bytes(int n_sym, int C) {
  return gated_expert_smem_floats(n_sym, C) * 4;
}

// Workspace floats per (compact row, antenna): h, y and u.
extern "C" long long gated_expert_workspace_floats(int n_sym, int np, int C) {
  return 3LL * C * n_sym * np;
}

extern "C" int gated_expert_launch(const void* idx, const void* src, const void* h_ls,
                                   void* designated, const void* w, const void* bias,
                                   void* workspace, int capacity, int n_ant, int n_sym,
                                   int np, int C, int R, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GATED_CASE(S_)                                                                \
  case S_:                                                                            \
    return bf16 ? launch<S_, true>(idx, src, h_ls, designated, w, bias, workspace,    \
                                   capacity, n_ant, np, C, R, st)                     \
                : launch<S_, false>(idx, src, h_ls, designated, w, bias, workspace,   \
                                    capacity, n_ant, np, C, R, st);
  switch (n_sym) {
    GATED_CASE(1)
    GATED_CASE(2)
    GATED_CASE(3)
    GATED_CASE(4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GATED_CASE
}
