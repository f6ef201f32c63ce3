// The zero-gap switch into the designated buffer: the scalar switch of the
// single-UE host loop (in place), and, out of place, the per-UE switch of the
// batched engine and its compaction-gated counterpart, the un-compaction scatter.
//
// Replaces: src/repro/kernels/switch_select/switch_select.py::switch_select_2d
// (Pallas TPU kernel _switch_kernel), reached through ops.py::switch_select_leaf;
// switch_select.py::switch_select_batched_2d (kernel _switch_kernel_batched),
// reached through ops.py::switch_select_batched_leaf / switch_select; and
// switch_select.py::switch_gather_batched_2d (kernel _gather_kernel_batched),
// reached through ops.py::switch_gather_batched_leaf / switch_scatter.
//
// Called from src/repro_torch/kernels/switch_select/ops.py, the same names:
// switch_select_scalar_launch by switch_select_leaf and switch_select (scalar
// mode), switch_select_launch by switch_select_batched_leaf and switch_select
// (per-UE modes), switch_gather_launch by switch_gather_batched_leaf and
// switch_scatter.  A pytree of outputs is switched one launch a leaf, as the
// reference maps one pallas_call over the leaves.
//
// Semantics (paper 3.2): downstream always reads the designated buffer.  Mode 0
// keeps it (the designated expert is active); mode k + 1 makes it a copy of
// alternative k -- for the whole tensor (scalar switch) or for one UE's slice
// (per-UE switch).  The GATED bank runs its designated expert on a dense
// capacity-K sub-batch instead, and the scatter puts it back: UE u takes compact
// row src[u] when src[u] >= 0 and keeps its (fail-safe) buffer otherwise.
//
// Element types: the reference's switch takes any real dtype (and complex as
// float pairs), so these kernels only move bytes.  Every entry point takes byte
// counts, which the wrappers make from 2-, 4- or 8-byte elements (bfloat16 /
// float16, float32 / int32, float64 / int64 / complex64), so every count is even
// and every pointer 2-byte aligned: a copy moves 16-byte vectors where every
// pointer is 16-byte aligned (and, per UE, a row is whole vectors), and 2-byte
// words for the rest, the same bits at any element size; it never reads past a
// row's last byte.  An odd byte count is refused.
//
// What bounds them on the H100: bytes, and at the slot's size really launch
// latency.  A copy moves its payload twice (read, write): at n_prb = 106 one UE's
// estimate is 122,112 B, so the scalar copy is bound at 2 x 122,112 B / 3.35 TB/s
// = 0.07 us; the per-UE switch and the scatter write every UE of a fresh output,
// 2 x 3.9 MB at 32 UEs, 2.33 us.  The LM decoder's (8, 49,152) bf16 logits are
// 786 KB, 0.47 us.  All are far below the few microseconds a launch and its
// wrapper cost.
//
// Design of the per-UE switch and the scatter: one launch, out of place.  The
// output is a fresh tensor the wrapper allocates; UE u's slice is a copy of the
// row its mode (or compact row) names, the designated one included, so no input
// is written and the expert outputs stay what they were, as in the reference.
// The experts come in a by-value table of up to MAX_EXPERTS pointers, so every
// alternative goes in the same launch.  The grid is a grid-stride loop over the
// whole output, sized to fill the SMs once (2,048 threads an SM), neighbouring
// threads on neighbouring addresses, 16 bytes a thread on the vector path; each
// element finds its UE with one 32-bit division (64-bit past 2^31 elements).  A
// mode that names no expert keeps the designated row; the scatter clamps src[u]
// to the last compact row, as the plain version does.
//
// The scalar switch stays in place: every block reads the mode and returns at once
// when the buffer is kept -- the paper's true no-op path, which the Pallas output
// pipeline could not express (it always rewrites one tile).  A copying block
// moves 16-byte vectors and then the tail at the element's width; one grid row
// whose chunks take one vector a thread, so one 122 KB leaf spreads over 30
// blocks.  Its mode comes by value (the host loop knows it as an int, and
// uploading it would stall the host on the queue) or from an int32 on the card;
// one launch per alternative.
//
// The lean launch path (kernels/switch_select/ops.py, kernels/build.py): at these
// sizes a call's time is host work, so each wrapper does only what its kernel
// needs.  Tensors go in as their own data_ptr() and numel() * element_size()
// bytes (a complex64 leaf needs no view_as_real),
// the stream is the raw handle from torch._C._cuda_getCurrentRawStream, the
// ctypes entry points are typed once, the per-UE switch validates a signature
// (experts, shape, dtype, device) once, and a fresh output skips deterministic
// mode's NaN fill (the kernel writes all of it).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TPB = 256;
constexpr int BLOCKS_PER_SM = 2048 / TPB;  // a full SM's threads
constexpr int MAX_EXPERTS = 8;             // the per-UE switch's by-value table

// -- the scalar switch, in place -------------------------------------------------

// Copy bytes [start, n_bytes) as T-wide elements, one grid row's chunks of TPB.
template <typename T>
__device__ __forceinline__ void copy_elements(const char* __restrict__ src,
                                              char* __restrict__ dst, long long start,
                                              long long n_bytes) {
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  const long long n = n_bytes / (long long)sizeof(T);
  for (long long i = start / (long long)sizeof(T) + (long long)blockIdx.y * TPB + threadIdx.x;
       i < n; i += (long long)gridDim.y * TPB)
    d[i] = s[i];
}

// Copy one payload of n_bytes (even): 16-byte vectors when both pointers are
// 16-byte aligned, then the tail (or everything, unaligned) in 2-byte words.
__device__ __forceinline__ void copy_payload(const char* __restrict__ src,
                                             char* __restrict__ dst, long long n_bytes) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  long long start = 0;
  if (aligned) {
    start = n_bytes / 16 * 16;
    copy_elements<uint4>(src, dst, 0, start);
  }
  copy_elements<uint16_t>(src, dst, start, n_bytes);
}

__global__ void __launch_bounds__(TPB)
switch_select_scalar_kernel(const int32_t* __restrict__ mode_ptr, int mode_value,
                            const char* __restrict__ alt, char* __restrict__ designated,
                            long long n_bytes, int want) {
  const int mode = mode_ptr != nullptr ? *mode_ptr : mode_value;
  if (mode != want) return;  // no-op path: the designated buffer stays as it is
  copy_payload(alt, designated, n_bytes);
}

// -- the per-UE switch and the scatter, out of place -------------------------------

struct ExpertTable {
  const char* p[MAX_EXPERTS];
};

// UE u's row under the per-UE switch: expert modes[u]'s, the designated one for a
// mode that names no expert.  The table is picked by compares, not an index, so it
// stays in the parameter bank.
struct SelectRows {
  const int32_t* modes;
  ExpertTable ex;
  int n_experts;
  __device__ __forceinline__ const char* operator()(long long u, long long row_bytes) const {
    const int m = __ldg(modes + u);
    const char* p = ex.p[0];
#pragma unroll
    for (int k = 1; k < MAX_EXPERTS; ++k)
      if (k < n_experts && m == k) p = ex.p[k];
    return p + u * row_bytes;
  }
};

// UE u's row under the scatter: compact row src[u] (clamped), or its fail-safe row.
struct GatherRows {
  const int32_t* src;
  const char* compact;
  const char* designated;
  int capacity;
  __device__ __forceinline__ const char* operator()(long long u, long long row_bytes) const {
    const int r = __ldg(src + u);
    return r < 0 ? designated + u * row_bytes
                 : compact + (long long)min(r, capacity - 1) * row_bytes;
  }
};

// out (n_ues, row_bytes) = each UE's row, V-wide words (uint4 or uint16_t),
// I-typed word indices.
template <class Rows, class V, typename I>
__global__ void __launch_bounds__(TPB)
copy_rows_kernel(Rows rows, V* __restrict__ out, I per_ue_v, I total_v, long long row_bytes) {
  for (I i = (I)blockIdx.x * TPB + threadIdx.x; i < total_v; i += (I)gridDim.x * TPB) {
    const I u = i / per_ue_v;
    out[i] = reinterpret_cast<const V*>(rows((long long)u, row_bytes))[i - u * per_ue_v];
  }
}

// SMs of the current device, read once per device
int sm_count(int* n) {
  static std::atomic<int> cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int sms = cached[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached[dev].store(sms, std::memory_order_relaxed);
  }
  *n = sms;
  return 0;
}

template <class Rows, class V>
void launch_rows(const Rows& rows, void* out, long long n_ues, long long row_bytes, int sms,
                 cudaStream_t stream) {
  const long long per_v = row_bytes / (long long)sizeof(V), total = per_v * n_ues;
  long long blocks = (total + TPB - 1) / TPB;
  if (blocks > (long long)sms * BLOCKS_PER_SM) blocks = (long long)sms * BLOCKS_PER_SM;
  if (total < (1LL << 31))
    copy_rows_kernel<Rows, V, uint32_t><<<(unsigned)blocks, TPB, 0, stream>>>(
        rows, static_cast<V*>(out), (uint32_t)per_v, (uint32_t)total, row_bytes);
  else
    copy_rows_kernel<Rows, V, uint64_t><<<(unsigned)blocks, TPB, 0, stream>>>(
        rows, static_cast<V*>(out), (uint64_t)per_v, (uint64_t)total, row_bytes);
}

// 16-byte vectors when every pointer is 16-byte aligned and a UE's row is whole
// vectors; else 2-byte words
template <class Rows>
int copy_rows(const Rows& rows, const void* const* ptrs, int n_ptrs, void* out, int n_ues,
              long long row_bytes, cudaStream_t stream) {
  if (row_bytes % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_ues <= 0 || row_bytes <= 0) return 0;
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  uintptr_t bits = reinterpret_cast<uintptr_t>(out);
  for (int k = 0; k < n_ptrs; ++k) bits |= reinterpret_cast<uintptr_t>(ptrs[k]);
  if ((bits & 15) == 0 && row_bytes % 16 == 0)
    launch_rows<Rows, uint4>(rows, out, n_ues, row_bytes, sms, stream);
  else
    launch_rows<Rows, uint16_t>(rows, out, n_ues, row_bytes, sms, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The per-UE switch: out[u] = experts[modes[u]][u], for 2 <= n_experts <= MAX_EXPERTS
// expert tensors (n_ues rows of row_bytes) listed designated first in the host array
// ``experts``.
extern "C" int switch_select_launch(const void* modes, const void* const* experts,
                                    int n_experts, void* out, int n_ues, long long row_bytes,
                                    void* stream) {
  if (n_experts < 1 || n_experts > MAX_EXPERTS) return static_cast<int>(cudaErrorInvalidValue);
  SelectRows rows{static_cast<const int32_t*>(modes), {}, n_experts};
  for (int k = 0; k < MAX_EXPERTS; ++k)
    rows.ex.p[k] = static_cast<const char*>(experts[k < n_experts ? k : 0]);
  return copy_rows(rows, experts, n_experts, out, n_ues, row_bytes,
                   static_cast<cudaStream_t>(stream));
}

// The scatter: out[u] = src[u] >= 0 ? compact[min(src[u], capacity - 1)] : designated[u].
extern "C" int switch_gather_launch(const void* src, const void* compact,
                                    const void* designated, void* out, int n_ues,
                                    long long row_bytes, int capacity, void* stream) {
  if (capacity < 1) return static_cast<int>(cudaErrorInvalidValue);
  GatherRows rows{static_cast<const int32_t*>(src), static_cast<const char*>(compact),
                  static_cast<const char*>(designated), capacity};
  const void* ptrs[2] = {compact, designated};
  return copy_rows(rows, ptrs, 2, out, n_ues, row_bytes, static_cast<cudaStream_t>(stream));
}

// mode_ptr: an int32 on the card, or null to take mode_value; n_bytes even.
extern "C" int switch_select_scalar_launch(const void* mode_ptr, int mode_value,
                                           const void* alt, void* designated,
                                           long long n_bytes, int want, void* stream) {
  if (n_bytes % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  long long chunks = (n_bytes / 16 + TPB - 1) / TPB;
  chunks = chunks < 1 ? 1 : (chunks > 65535 ? 65535 : chunks);
  switch_select_scalar_kernel<<<dim3(1, (unsigned)chunks), TPB, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mode_ptr), mode_value, static_cast<const char*>(alt),
      static_cast<char*>(designated), n_bytes, want);
  return static_cast<int>(cudaGetLastError());
}
