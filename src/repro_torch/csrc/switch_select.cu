// Per-UE zero-gap switch into the designated buffer, in place, and its
// compaction-gated counterpart, the un-compaction scatter.
//
// Replaces: src/repro/kernels/switch_select/switch_select.py::switch_select_batched_2d
// (Pallas TPU kernel _switch_kernel_batched), reached through
// ops.py::switch_select_batched_leaf / switch_select; and
// switch_select.py::switch_gather_batched_2d (kernel _gather_kernel_batched),
// reached through ops.py::switch_gather_batched_leaf / switch_scatter.
//
// Semantics (paper 3.2): downstream always reads the designated buffer.  UE u with
// modes[u] == 0 keeps it (the designated expert is active); modes[u] == k + 1 makes it
// a copy of alternative k's slice for that UE.  The GATED bank runs its designated
// expert on a dense capacity-K sub-batch instead, and the scatter puts it back: UE u
// takes compact row src[u] when src[u] >= 0 and keeps its (fail-safe) buffer otherwise.
//
// What bounds them on the H100: bytes, and at the slot's size really launch latency.
// A copied UE moves its payload twice (read the alternative, write the designated
// slice): at n_prb = 106 that is 2 x 122,112 B per switched UE, some 2.3 us for 32
// UEs at 3.35 TB/s, below the few microseconds a launch costs.
//
// Design: grid (UE, chunk).  Every block reads its UE's mode (or compact row) and
// returns at once when the UE keeps its buffer -- the paper's true no-op path, which
// the Pallas output pipeline could not express (it always rewrites one tile).  A
// copying block moves 16-byte float4 vectors, neighbouring threads on neighbouring
// addresses, with a scalar tail for payloads that are not a multiple of four floats.
// Complex payloads arrive as float pairs.  The switch makes one launch per
// alternative (the bank of the main path has exactly one); the scatter one in all.
// The scatter clamps src[u] to the last compact row, as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPB = 256;
constexpr int VEC_PER_BLOCK = 4 * TPB;  // float4 per block-chunk

// Copy one UE's payload; every block of the UE's grid row takes its chunks.
__device__ __forceinline__ void copy_payload(const float* __restrict__ src,
                                             float* __restrict__ dst, long long per_ue) {
  const long long n_vec = per_ue / 4;
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (aligned) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (long long i = (long long)blockIdx.y * VEC_PER_BLOCK + threadIdx.x;
         i < n_vec; i += (long long)gridDim.y * VEC_PER_BLOCK) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long v = i + j * TPB;
        if (v < n_vec) d4[v] = s4[v];
      }
    }
  }
  // scalar path: the tail after the float4 body, or everything when unaligned
  const long long start = aligned ? n_vec * 4 : 0;
  for (long long i = start + (long long)blockIdx.y * TPB + threadIdx.x; i < per_ue;
       i += (long long)gridDim.y * TPB)
    dst[i] = src[i];
}

__global__ void __launch_bounds__(TPB)
switch_select_kernel(const int32_t* __restrict__ modes, const float* __restrict__ alt,
                     float* __restrict__ designated, long long per_ue, int want) {
  const int u = blockIdx.x;
  if (modes[u] != want) return;  // no-op path: this UE keeps its buffer
  copy_payload(alt + (size_t)u * per_ue, designated + (size_t)u * per_ue, per_ue);
}

__global__ void __launch_bounds__(TPB)
switch_gather_kernel(const int32_t* __restrict__ src, const float* __restrict__ compact,
                     float* __restrict__ designated, long long per_ue, int capacity) {
  const int u = blockIdx.x;
  const int row = src[u];
  if (row < 0) return;  // no-op path: this UE keeps its fail-safe buffer
  copy_payload(compact + (size_t)min(row, capacity - 1) * per_ue,
               designated + (size_t)u * per_ue, per_ue);
}

dim3 copy_grid(int n_ues, long long per_ue) {
  long long chunks = (per_ue / 4 + VEC_PER_BLOCK - 1) / VEC_PER_BLOCK;
  if (chunks < 1) chunks = 1;
  if (chunks > 65535) chunks = 65535;
  return dim3(n_ues, (unsigned)chunks);
}

}  // namespace

extern "C" int switch_select_launch(const void* modes, const void* alt,
                                    void* designated, int n_ues, long long per_ue,
                                    int want, void* stream) {
  switch_select_kernel<<<copy_grid(n_ues, per_ue), TPB, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(modes), static_cast<const float*>(alt),
      static_cast<float*>(designated), per_ue, want);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int switch_gather_launch(const void* src, const void* compact,
                                    void* designated, int n_ues, long long per_ue,
                                    int capacity, void* stream) {
  switch_gather_kernel<<<copy_grid(n_ues, per_ue), TPB, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const float*>(compact),
      static_cast<float*>(designated), per_ue, capacity);
  return static_cast<int>(cudaGetLastError());
}
