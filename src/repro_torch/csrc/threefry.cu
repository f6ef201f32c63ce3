// The threefry2x32 generator of repro_torch.random on the card: every public draw
// (split, fold_in, bits, uniform, normal, bernoulli) in one launch that hashes,
// converts and writes its final dtype.
//
// Replaces no TPU kernel: the reference draws through jax.random, which XLA lowers
// to fused integer code.  The port's plain form (random.py, kept for CPU tensors
// and as this kernel's oracle) runs the hash as torch int64 passes, 20 rounds and
// 5 key injections each masked back to 32 bits: about 170 memory-bound elementwise
// launches a hash, 45 more for a normal's float conversion and erf_inv.  Here the
// whole chain stays in uint32 registers.
//
// Called from src/repro_torch/random.py: threefry_keys_launch by split and fold_in,
// threefry_draw_launch by bits, uniform, normal and bernoulli.
//
// Semantics (jax.random with jax_threefry_partitionable): a key is two 32-bit words
// held in int64 (the low 32 bits are read).  split(key, num)'s key i hashes the
// counter (0, i); fold_in(key, data) hashes (0, data mod 2^32); both write each
// new key's two words as an int64 pair.  A draw of n elements per key hashes the
// counter (idx >> 32, idx mod 2^32) of the flat index idx = offset + j and keeps
// the XOR of the two output words, so a draw in chunks (offset) gives the bits of
// one draw.  The float steps follow the plain form's torch operations on the card
// one rounding each, in its order (__fmul_rn / __fadd_rn / __fsub_rn, which nvcc's
// default --fmad=true may not contract; log1pf and sqrtf with no fast math), so the
// card's plain form and this kernel give the same bits:
//   uniform: f = bits_as_float((b >> 9) | 0x3F800000) - 1; u = f * (hi - lo) + lo;
//            maximum(lo, u), hi - lo one float32 subtraction;
//   normal:  u on [nextafter(-1, 0), 1), then XLA's erf_inv polynomial
//            (w = -log1p(-u * u); w < 5 ? w - 2.5 : sqrt(w) - 3; Horner
//            p = c + p * w; p * u; +-inf where |u| == 1), times sqrt(2) in float32;
//   bernoulli: the [0, 1) uniform < p.
//
// What bounds it on the H100: instruction issue.  The hash needs 73 32-bit integer
// operations a word (20 funnel-shift rotations, 20 adds, 20 xors, 12 key additions
// and the output xor): 2.18 ps a word at the SMs' full issue (33.45 T thread-
// instructions a second: 4 warp-instructions a cycle on 132 SMs at 1.98 GHz).  The
// compiled code issues about 85-90 instructions a word, the counter's 64-bit steps
// besides, over the ALU and FMA pipes; the bernoulli draw reaches about half of the
// bound.  The store is 1 to 8 bytes a word, 0.3-2.4 ps at 3.35 TB/s; a normal adds
// ~40 float operations on the float pipe.  Design: a grid-stride loop over groups of V consecutive output
// elements (2 int64, 4 float32 or 16 bools: one 16-byte store), each thread finding
// its first (key, counter) with one division and stepping both by carries after
// that; a key's schedule (k0 ^ k1 ^ 0x1BD11BDA and the injections' + i) is built
// once per key a thread meets.  split and fold_in are small (a key per UE): one
// thread per new key, with the key and the data read through broadcast strides of
// up to MAX_DIMS axes, so fold_in takes a (U, 2) key with a scalar and a (2,) key
// with an (n,) vector in the same launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TPB = 256;
constexpr int BLOCKS_PER_SM = 4;
constexpr int MAX_DIMS = 8;

enum Mode { BITS = 0, UNIFORM = 1, NORMAL = 2, BERNOULLI = 3 };

// the key schedule: the three words, and the second word's five injections
// (word + i), built once per key
struct Key {
  uint32_t k0, k1, k2, i1, i2, i3, i4, i5;
};

__device__ __forceinline__ Key make_key(long long w0, long long w1) {
  Key k;
  k.k0 = (uint32_t)w0;
  k.k1 = (uint32_t)w1;
  k.k2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  k.i1 = k.k2 + 1u;
  k.i2 = k.k0 + 2u;
  k.i3 = k.k1 + 3u;
  k.i4 = k.k2 + 4u;
  k.i5 = k.k0 + 5u;
  return k;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r) \
  a += b;           \
  b = rotl(b, r) ^ a;

// threefry2x32, 20 rounds, on the counter (x0, x1)
__device__ __forceinline__ void hash(const Key& k, uint32_t x0, uint32_t x1, uint32_t& o0,
                                     uint32_t& o1) {
  uint32_t a = x0 + k.k0, b = x1 + k.k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  a += k.k1; b += k.i1;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  a += k.k2; b += k.i2;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  a += k.k0; b += k.i3;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  a += k.k1; b += k.i4;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  a += k.k2; b += k.i5;
  o0 = a;
  o1 = b;
}

#undef TF_ROUND

// XLA's float32 erf_inv coefficients (random.py's _ERFINV_LT5 / _ERFINV_GE5 rounded
// to float32), in the order the Horner recurrence consumes them
__constant__ float ERFINV_LT5[9] = {
    0x1.e2cb1p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f, -0x1.26b582p-18f, 0x1.ca65b6p-13f,
    -0x1.48a81p-10f, -0x1.11c9dep-8f, 0x1.f91ec6p-3f, 0x1.805c5ep+0f};
__constant__ float ERFINV_GE5[9] = {
    -0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f, -0x1.e17bcep-9f, 0x1.7824f6p-8f,
    -0x1.f38baep-8f, 0x1.354afcp-7f, 0x1.006db6p+0f, 0x1.6a9efcp+1f};
// float32(sqrt(2)), random.py's _SQRT2_F32
constexpr float SQRT2_F32 = 0x1.6a09e6p+0f;

// torch.maximum(lo, u): NaN propagates
__device__ __forceinline__ float maximum(float lo, float u) {
  if (lo != lo) return lo;
  if (u != u) return u;
  return fmaxf(lo, u);
}

__device__ __forceinline__ float uniform_of(uint32_t bits, float lo, float span) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return maximum(lo, __fadd_rn(__fmul_rn(f, span), lo));
}

__device__ __forceinline__ float erf_inv(float x) {
  float w = -log1pf(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  float p = lt ? ERFINV_LT5[0] : ERFINV_GE5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i)
    p = __fadd_rn(lt ? ERFINV_LT5[i] : ERFINV_GE5[i], __fmul_rn(p, w));
  const float out = __fmul_rn(p, x);
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000)) : out;
}

template <int MODE>
struct Out;
template <>
struct Out<BITS> {
  typedef long long T;
  static constexpr int V = 2;
};
template <>
struct Out<UNIFORM> {
  typedef float T;
  static constexpr int V = 4;
};
template <>
struct Out<NORMAL> {
  typedef float T;
  static constexpr int V = 4;
};
template <>
struct Out<BERNOULLI> {
  typedef uint8_t T;
  static constexpr int V = 16;
};

struct Draw {
  const long long* key;  // key k's words at key[k * key_stride], + word_stride
  long long key_stride, word_stride;
  long long n;  // elements per key
  unsigned long long offset;
  long long total;  // keys x n
  float lo, hi, p;
};

template <int MODE>
__device__ __forceinline__ typename Out<MODE>::T convert(uint32_t bits, const Draw& d,
                                                         float span) {
  if constexpr (MODE == BITS) {
    return (long long)bits;
  } else if constexpr (MODE == UNIFORM) {
    return uniform_of(bits, d.lo, span);
  } else if constexpr (MODE == NORMAL) {
    return __fmul_rn(SQRT2_F32, erf_inv(uniform_of(bits, d.lo, span)));
  } else {
    return (uint8_t)(uniform_of(bits, d.lo, span) < d.p ? 1 : 0);
  }
}

// one 16-byte store of a group
template <int MODE>
__device__ __forceinline__ void store16(typename Out<MODE>::T* out,
                                        const typename Out<MODE>::T (&v)[Out<MODE>::V]) {
  if constexpr (MODE == BITS) {
    *reinterpret_cast<longlong2*>(out) = make_longlong2(v[0], v[1]);
  } else if constexpr (MODE == BERNOULLI) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)v[4 * i] | ((uint32_t)v[4 * i + 1] << 8) |
             ((uint32_t)v[4 * i + 2] << 16) | ((uint32_t)v[4 * i + 3] << 24);
    *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ Key load_key(const Draw& d, long long k) {
  const long long* w = d.key + k * d.key_stride;
  return make_key(w[0], w[d.word_stride]);
}

template <int MODE>
__global__ void __launch_bounds__(TPB, BLOCKS_PER_SM)
draw_kernel(const Draw d, typename Out<MODE>::T* __restrict__ out) {
  typedef typename Out<MODE>::T T;
  constexpr int V = Out<MODE>::V;
  long long e = ((long long)blockIdx.x * TPB + threadIdx.x) * V;
  if (e >= d.total) return;
  // the element stride of the grid, as whole keys and a remainder
  const long long stride = (long long)gridDim.x * TPB * V;
  const long long s_keys = stride / d.n, s_rem = stride % d.n;
  long long kg = e / d.n, jg = e % d.n;  // the group's first element: key, index
  const float span = __fsub_rn(d.hi, d.lo);
  const bool aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (; e < d.total; e += stride) {
    long long k = kg, j = jg;
    Key key = load_key(d, k);
    T vals[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const unsigned long long idx = d.offset + (unsigned long long)j;
      uint32_t b0, b1;
      hash(key, (uint32_t)(idx >> 32), (uint32_t)idx, b0, b1);
      vals[v] = convert<MODE>(b0 ^ b1, d, span);
      if (++j == d.n) {
        j = 0;
        ++k;
        if (v + 1 < V && e + v + 1 < d.total) key = load_key(d, k);
      }
    }
    if (aligned && e + V <= d.total) {
      store16<MODE>(out + e, vals);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (e + v < d.total) out[e + v] = vals[v];
    }
    kg += s_keys;
    jg += s_rem;
    if (jg >= d.n) {
      jg -= d.n;
      ++kg;
    }
  }
}

// split / fold_in: output element m of the broadcast shape `size` takes its key at
// sum(idx_i * key_stride[i]) and its data at sum(idx_i * data_stride[i]) (data_mode
// 1), the scalar (0) or its index along the last axis (2: split's counter)
struct Keys {
  const long long* key;
  long long word_stride;
  const long long* data;
  long long scalar;
  int data_mode, ndim;
  long long total;
  long long size[MAX_DIMS], key_stride[MAX_DIMS], data_stride[MAX_DIMS];
};

__global__ void __launch_bounds__(TPB) keys_kernel(const Keys a, long long* __restrict__ out) {
  const long long step = (long long)gridDim.x * TPB;
  for (long long m = (long long)blockIdx.x * TPB + threadIdx.x; m < a.total; m += step) {
    long long rem = m, ko = 0, dof = 0, last = 0;
#pragma unroll
    for (int i = MAX_DIMS - 1; i >= 0; --i) {
      if (i >= a.ndim) continue;
      const long long idx = rem % a.size[i];
      rem /= a.size[i];
      ko += idx * a.key_stride[i];
      dof += idx * a.data_stride[i];
      if (i == a.ndim - 1) last = idx;
    }
    const uint32_t x1 = a.data_mode == 0   ? (uint32_t)a.scalar
                        : a.data_mode == 1 ? (uint32_t)a.data[dof]
                                           : (uint32_t)last;
    uint32_t b0, b1;
    hash(make_key(a.key[ko], a.key[ko + a.word_stride]), 0u, x1, b0, b1);
    reinterpret_cast<longlong2*>(out)[m] = make_longlong2((long long)b0, (long long)b1);
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

unsigned grid_for(long long items, int sms) {
  long long blocks = (items + TPB - 1) / TPB;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  return (unsigned)(blocks > cap ? cap : blocks);
}

template <int MODE>
void launch_draw(const Draw& d, void* out, int sms, cudaStream_t stream) {
  constexpr int V = Out<MODE>::V;
  draw_kernel<MODE><<<grid_for((d.total + V - 1) / V, sms), TPB, 0, stream>>>(
      d, static_cast<typename Out<MODE>::T*>(out));
}

}  // namespace

// mode: 0 bits (int64 out), 1 uniform on [lo, hi) (float32), 2 normal (float32; lo
// and hi are the normal's uniform bounds), 3 bernoulli (bool, uniform < p).
extern "C" int threefry_draw_launch(const void* key, long long key_stride,
                                    long long word_stride, long long n,
                                    unsigned long long offset, long long total, void* out,
                                    int mode, float lo, float hi, float p, void* stream) {
  if (n < 1 || total < 1 || total % n != 0) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  const Draw d{static_cast<const long long*>(key), key_stride, word_stride, n, offset, total,
               lo, hi, p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case BITS: launch_draw<BITS>(d, out, sms, s); break;
    case UNIFORM: launch_draw<UNIFORM>(d, out, sms, s); break;
    case NORMAL: launch_draw<NORMAL>(d, out, sms, s); break;
    case BERNOULLI: launch_draw<BERNOULLI>(d, out, sms, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dims: the host's (size, key_stride, data_stride) of each of ndim axes, in that
// order, ndim <= MAX_DIMS; out: (prod(size), 2) int64, 16-byte aligned
extern "C" int threefry_keys_launch(const void* key, long long word_stride, const void* data,
                                    long long scalar, int data_mode, int ndim,
                                    const long long* dims, long long total, void* out,
                                    void* stream) {
  if (ndim < 0 || ndim > MAX_DIMS || total < 1 || data_mode < 0 || data_mode > 2 ||
      (data_mode == 1 && data == nullptr) || (data_mode == 2 && ndim < 1) ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  Keys a{};
  a.key = static_cast<const long long*>(key);
  a.word_stride = word_stride;
  a.data = static_cast<const long long*>(data);
  a.scalar = scalar;
  a.data_mode = data_mode;
  a.ndim = ndim;
  a.total = total;
  for (int i = 0; i < ndim; ++i) {
    a.size[i] = dims[3 * i];
    a.key_stride[i] = dims[3 * i + 1];
    a.data_stride[i] = dims[3 * i + 2];
  }
  keys_kernel<<<grid_for(total, sms), TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
