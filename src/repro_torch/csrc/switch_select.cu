// The zero-gap switch into the designated buffer, in place: the scalar switch of
// the single-UE host loop, the per-UE switch of the batched engine, and the
// per-UE switch's compaction-gated counterpart, the un-compaction scatter.
//
// Replaces: src/repro/kernels/switch_select/switch_select.py::switch_select_2d
// (Pallas TPU kernel _switch_kernel), reached through ops.py::switch_select_leaf;
// switch_select.py::switch_select_batched_2d (kernel _switch_kernel_batched),
// reached through ops.py::switch_select_batched_leaf / switch_select; and
// switch_select.py::switch_gather_batched_2d (kernel _gather_kernel_batched),
// reached through ops.py::switch_gather_batched_leaf / switch_scatter.
//
// Semantics (paper 3.2): downstream always reads the designated buffer.  Mode 0
// keeps it (the designated expert is active); mode k + 1 makes it a copy of
// alternative k -- for the whole tensor (scalar switch) or for one UE's slice
// (per-UE switch).  The GATED bank runs its designated expert on a dense
// capacity-K sub-batch instead, and the scatter puts it back: UE u takes compact
// row src[u] when src[u] >= 0 and keeps its (fail-safe) buffer otherwise.
//
// What bounds them on the H100: bytes, and at the slot's size really launch
// latency.  A copy moves its payload twice (read the alternative, write the
// designated buffer): at n_prb = 106 one UE's estimate is 122,112 B, so the scalar
// copy is bound at 2 x 122,112 B / 3.35 TB/s = 0.07 us and a 32-UE switch at about
// 2.3 us, both far below the few microseconds a launch costs.
//
// Design: every block reads the mode (or its UE's mode, or compact row) and
// returns at once when the buffer is kept -- the paper's true no-op path, which
// the Pallas output pipeline could not express (it always rewrites one tile).  A
// copying block moves 16-byte float4 vectors, neighbouring threads on
// neighbouring addresses, with a scalar tail for payloads that are not a multiple
// of four floats; there is no padding.  Complex payloads arrive as float pairs.
// The batched kernels run a grid (UE, chunk) whose chunks each take 4 vectors a
// thread.  The scalar kernel runs one grid row whose chunks take one vector a
// thread, so one 122 KB leaf spreads over 30 blocks; its mode comes by value
// (the host loop knows it as an int, and uploading it would stall the host on
// the queue) or from an int32 on the card.  A mode that names no alternative
// keeps the buffer.  The switches make one launch per alternative (the banks of
// the main paths have exactly one); the scatter one in all.  The scatter clamps
// src[u] to the last compact row, as the plain version does.
//
// The lean launch path (kernels/switch_select/ops.py, kernels/build.py): at the
// host loop's size the scalar switch's call time is all host work, so its
// wrapper does only what the kernel needs.  Complex payloads go in as their own
// data_ptr() with twice their numel() floats (no view_as_real), the stream is the
// raw handle from torch._C._cuda_getCurrentRawStream (no torch.cuda.Stream
// object), the ctypes entry points are typed once, and each tensor's dtype,
// device, shape, contiguity and lazy conjugate/negative bits are checked once,
// cheapest first.  The per-UE switch and the scatter launch through the same
// path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPB = 256;
constexpr int UNROLL_BATCHED = 4;  // float4 per thread and block-chunk, per-UE grids
constexpr int UNROLL_SCALAR = 1;   // float4 per thread and block-chunk, scalar grid

// Copy one payload; every block of the grid row takes its chunks of UNROLL * TPB
// float4 vectors, and the scalar tail goes TPB floats a chunk.
template <int UNROLL>
__device__ __forceinline__ void copy_payload(const float* __restrict__ src,
                                             float* __restrict__ dst, long long per_ue) {
  constexpr int VEC_PER_BLOCK = UNROLL * TPB;
  const long long n_vec = per_ue / 4;
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (aligned) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (long long i = (long long)blockIdx.y * VEC_PER_BLOCK + threadIdx.x;
         i < n_vec; i += (long long)gridDim.y * VEC_PER_BLOCK) {
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
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
  copy_payload<UNROLL_BATCHED>(alt + (size_t)u * per_ue, designated + (size_t)u * per_ue,
                               per_ue);
}

__global__ void __launch_bounds__(TPB)
switch_select_scalar_kernel(const int32_t* __restrict__ mode_ptr, int mode_value,
                            const float* __restrict__ alt, float* __restrict__ designated,
                            long long n, int want) {
  const int mode = mode_ptr != nullptr ? *mode_ptr : mode_value;
  if (mode != want) return;  // no-op path: the designated buffer stays as it is
  copy_payload<UNROLL_SCALAR>(alt, designated, n);
}

__global__ void __launch_bounds__(TPB)
switch_gather_kernel(const int32_t* __restrict__ src, const float* __restrict__ compact,
                     float* __restrict__ designated, long long per_ue, int capacity) {
  const int u = blockIdx.x;
  const int row = src[u];
  if (row < 0) return;  // no-op path: this UE keeps its fail-safe buffer
  copy_payload<UNROLL_BATCHED>(compact + (size_t)min(row, capacity - 1) * per_ue,
                               designated + (size_t)u * per_ue, per_ue);
}

dim3 copy_grid(int n_ues, long long per_ue, int unroll) {
  const long long vec_per_block = (long long)unroll * TPB;
  long long chunks = (per_ue / 4 + vec_per_block - 1) / vec_per_block;
  if (chunks < 1) chunks = 1;
  if (chunks > 65535) chunks = 65535;
  return dim3(n_ues, (unsigned)chunks);
}

}  // namespace

extern "C" int switch_select_launch(const void* modes, const void* alt,
                                    void* designated, int n_ues, long long per_ue,
                                    int want, void* stream) {
  switch_select_kernel<<<copy_grid(n_ues, per_ue, UNROLL_BATCHED), TPB, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(modes), static_cast<const float*>(alt),
      static_cast<float*>(designated), per_ue, want);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int switch_gather_launch(const void* src, const void* compact,
                                    void* designated, int n_ues, long long per_ue,
                                    int capacity, void* stream) {
  switch_gather_kernel<<<copy_grid(n_ues, per_ue, UNROLL_BATCHED), TPB, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const float*>(compact),
      static_cast<float*>(designated), per_ue, capacity);
  return static_cast<int>(cudaGetLastError());
}

// mode_ptr: an int32 on the card, or null to take mode_value.
extern "C" int switch_select_scalar_launch(const void* mode_ptr, int mode_value,
                                           const void* alt, void* designated, long long n,
                                           int want, void* stream) {
  switch_select_scalar_kernel<<<copy_grid(1, n, UNROLL_SCALAR), TPB, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mode_ptr), mode_value, static_cast<const float*>(alt),
      static_cast<float*>(designated), n, want);
  return static_cast<int>(cudaGetLastError());
}
