// Decision-tree policy inference (one thread per UE row walks the tree), and the
// closed loop's whole decision phase for a tree policy fused around that walk.
//
// Replaces: src/repro/kernels/tree_infer/tree_infer.py::tree_infer_2d (Pallas TPU
// kernel _tree_kernel), reached through ops.py::tree_infer from
// core/closed_loop.py::policy_infer.
//
// The TPU kernel rewrites the complete binary tree as dense algebra (X @ T one-hot
// gather, threshold compare, leaf-count matmuls) because pointer chasing starves its
// vector units.  On the H100 a walk is the natural form: each thread reads
// x[row, feature[node]] for `depth` levels straight from the level-order tables
// (children of n are 2n+1 / 2n+2, go right if x > threshold) and writes the leaf
// value.  It needs no packed operands, is exact, and cannot meet the TF32 hazard of
// a one-hot matmul (which would round KPMs to a 10-bit mantissa).  It follows the
// literal walk tree_infer_ref, the repository's oracle.  One difference from the
// dense TPU form: for an infinite feature the dense form's inf * 0 turns every
// projection into NaN and goes all-left; the walk compares the feature itself.
//
// What bounds it on the H100: launch latency.  Reading a (U, F) float32 matrix and
// writing U leaf values is a few kilobytes for the paper's 10 KPMs.  In the batched
// closed loop the walk was one launch among about 85 small eager operations a
// decision slot (the KPM ring push, the window mean's 8 steps of 8 operations, the
// hysteresis register, the slot boundary), and the slot loop is bound by the host's
// launches.  So policy_step_launch does that whole phase in one launch, for every UE,
// with the fault ladder and the streaming mask folded in (each mask is a nullable
// (U,) byte pointer; with every pointer null and the TTL off the launch computes what
// it computed before the ladder joined it):
//
//   1. telemetry: push the slot's KPM vector into the UE's ring (idx, count int64:
//      the same modulo and the same 2^30 clamp as the ring's plain version), unless
//      telemetry_valid is 0 or the lane is detached (active 0): then buf, idx and
//      count are copied through and the mean below is over the old ring;
//   2. the window mean over the newest min(window, count) entries, newest first,
//      as ring_window_mean's float32 operations in the same order: acc = acc +
//      buf * valid, n_valid = n_valid + valid, then acc / max(n_valid, 1), written
//      with __fmul_rn / __fadd_rn / __fdiv_rn so that nvcc's default --fmad=true
//      cannot contract them (the device loop must equal its host replay bit for bit);
//   3. the walk on that mean, where a decision is due (decide) and heard
//      (decision_valid); the hysteresis streak and the register commit; a hold slot
//      or a lost decision freezes register and streak and reports the held register.
//      With decision_valid given, a heard decision resets the decision age;
//   4. the slot boundary: with the TTL on (ttl > 0) a UE whose age has reached it
//      (checked before the age advances) is forced to the default mode, register
//      and active mode both, and every age advances; the register becomes the
//      active mode and n_switches counts the change;
//   5. the circuit breaker, where trip is given: the slot's trip enters the UE's
//      trip ring at slot_idx % breaker_window; a UE not in quarantine whose ring
//      holds breaker_trips trips enters it for breaker_cooldown slots with its ring
//      cleared, else the countdown falls to max(q - 1, 0);
//   6. a detached lane (active 0) keeps every state leaf as it was, rings included,
//      and reports 0 as its raw decision and register.
//
// It writes a new state (the ring copied, with the new entry where one was pushed)
// and leaves its inputs as they were, so an earlier state stays valid.  A block
// takes UPB UEs: its threads take (UE, feature) pairs for steps 1-2, the means meet
// in shared memory, and one thread per UE does steps 3-6.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPB = 128;
constexpr int UPB = 8;  // UEs a block of the policy step: 80 (UE, KPM) pairs at F = 10

__device__ __forceinline__ int walk(const float* xr, const int32_t* __restrict__ feature,
                                    const float* __restrict__ threshold, int depth) {
  int node = 0;
  for (int level = 0; level < depth; ++level) {
    const bool right = xr[feature[node]] > threshold[node];
    node = 2 * node + 1 + (right ? 1 : 0);
  }
  return node - ((1 << depth) - 1);
}

__global__ void __launch_bounds__(TPB)
tree_infer_kernel(const float* __restrict__ x, const int32_t* __restrict__ feature,
                  const float* __restrict__ threshold,
                  const float* __restrict__ leaf_values, float* __restrict__ out,
                  int rows, int n_features, int depth) {
  const int r = blockIdx.x * TPB + threadIdx.x;
  if (r >= rows) return;
  out[r] = leaf_values[walk(x + (size_t)r * n_features, feature, threshold, depth)];
}

// The state, as the port's DeviceSwitchState holds it: the ring (U, cap, F) float32
// with idx and count (U,) int64; active, pending, streak, n_switches and the decision
// age (U,) int32; the breaker's trip ring (U, W) int32 and quarantine (U,) int32.
struct State {
  float* buf;
  long long* idx;
  long long* count;
  int32_t* active;
  int32_t* pending;
  int32_t* streak;
  int32_t* n_switches;
  int32_t* age;
  int32_t* trip_ring;
  int32_t* quarantine;
};

// The slot's (U,) byte masks, each null when the slot has none.
struct Masks {
  const uint8_t* telemetry_valid;
  const uint8_t* decision_valid;
  const uint8_t* trip;
  const uint8_t* active;
};

struct Tree {
  const int32_t* feature;
  const float* threshold;
  const float* leaves;
  int depth;
};

struct Ladder {
  int slot_idx, ttl, default_mode, trips, window, cooldown;
};

__device__ __forceinline__ bool on(const uint8_t* mask, int u) {
  return mask == nullptr || mask[u] != 0;
}

__global__ void __launch_bounds__(TPB)
policy_step_kernel(State in, const float* __restrict__ kpm, Tree tree, Masks m, Ladder lad,
                   State out, int32_t* __restrict__ raw_out, int32_t* __restrict__ reg_out,
                   int n_ues, int cap, int n_feat, int window, int hysteresis, int decide) {
  extern __shared__ float mean[];  // (UPB, n_feat)
  const int u0 = blockIdx.x * UPB;
  for (int i = threadIdx.x; i < UPB * n_feat; i += TPB) {
    const int ul = i / n_feat, f = i % n_feat, u = u0 + ul;
    if (u >= n_ues) break;  // i grows with u: every later pair is past the batch too
    const bool push = on(m.telemetry_valid, u) && on(m.active, u);
    // ring positions in int32: a state's idx lies in [0, cap), so the one 64-bit
    // floor-modulo here gives the same positions as the plain version's every slot
    const int at = static_cast<int>((in.idx[u] % cap + cap) % cap);
    const int end = push ? (at + 1 == cap ? 0 : at + 1) : at;  // the next write position
    const long long count = push ? min(in.count[u] + 1, 1LL << 30) : in.count[u];
    const float v = kpm[(size_t)u * n_feat + f];
    const float* src = in.buf + (size_t)u * cap * n_feat + f;
    float* dst = out.buf + (size_t)u * cap * n_feat + f;
    for (int w = 0; w < cap; ++w)
      dst[(size_t)w * n_feat] = push && w == at ? v : src[(size_t)w * n_feat];
    float acc = 0.f, n_valid = 0.f;
    for (int off = 1; off <= window; ++off) {  // newest first, fixed order
      const float valid = off <= count ? 1.f : 0.f;
      const int pos = end - off < 0 ? end - off + cap : end - off;
      const float x = push && pos == at ? v : src[(size_t)pos * n_feat];
      acc = __fadd_rn(acc, __fmul_rn(x, valid));
      n_valid = __fadd_rn(n_valid, valid);
    }
    mean[ul * n_feat + f] = __fdiv_rn(acc, fmaxf(n_valid, 1.f));
    if (f == 0) {
      out.idx[u] = push ? end : in.idx[u];
      out.count[u] = count;
    }
  }
  __syncthreads();
  const int u = u0 + threadIdx.x;
  if (threadIdx.x >= UPB || u >= n_ues) return;
  const int32_t* ring_in = in.trip_ring + (size_t)u * lad.window;
  int32_t* ring_out = out.trip_ring + (size_t)u * lad.window;
  const int32_t pending = in.pending[u];
  int32_t age = in.age[u], quar = in.quarantine[u];
  if (!on(m.active, u)) {  // detached: the whole state as it was, raw and register 0
    raw_out[u] = 0;
    if (reg_out != nullptr) reg_out[u] = 0;
    out.pending[u] = pending;
    out.streak[u] = in.streak[u];
    out.active[u] = in.active[u];
    out.n_switches[u] = in.n_switches[u];
    out.age[u] = age;
    out.quarantine[u] = quar;
    for (int w = 0; w < lad.window; ++w) ring_out[w] = ring_in[w];
    return;
  }
  int32_t raw = pending, next = pending, streak = in.streak[u];
  if (decide && on(m.decision_valid, u)) {
    raw = static_cast<int32_t>(
        tree.leaves[walk(mean + threadIdx.x * n_feat, tree.feature, tree.threshold, tree.depth)]);
    streak = raw == pending ? 0 : streak + 1;
    if (streak >= hysteresis) {
      next = raw;
      streak = 0;
    }
    if (m.decision_valid != nullptr) age = 0;
  }
  raw_out[u] = raw;
  if (reg_out != nullptr) reg_out[u] = next;
  if (lad.ttl > 0) {
    if (age >= lad.ttl) next = lad.default_mode;
    age = age + 1;
  }
  out.pending[u] = next;
  out.streak[u] = streak;
  out.active[u] = next;
  out.n_switches[u] = in.n_switches[u] + (next != in.active[u] ? 1 : 0);
  out.age[u] = age;
  if (m.trip == nullptr) {
    out.quarantine[u] = quar;
    for (int w = 0; w < lad.window; ++w) ring_out[w] = ring_in[w];
    return;
  }
  const int at = lad.slot_idx % lad.window;
  int count = 0;
  for (int w = 0; w < lad.window; ++w) count += w == at ? (m.trip[u] != 0) : ring_in[w];
  const bool newly = quar <= 0 && count >= lad.trips;
  for (int w = 0; w < lad.window; ++w)
    ring_out[w] = newly ? 0 : (w == at ? (m.trip[u] != 0) : ring_in[w]);
  out.quarantine[u] = newly ? lad.cooldown : max(quar - 1, 0);
}

}  // namespace

extern "C" int tree_infer_launch(const void* x, const void* feature,
                                 const void* threshold, const void* leaf_values,
                                 void* out, int rows, int n_features, int depth,
                                 void* stream) {
  const int blocks = (rows + TPB - 1) / TPB;
  tree_infer_kernel<<<blocks > 0 ? blocks : 1, TPB, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(feature),
      static_cast<const float*>(threshold), static_cast<const float*>(leaf_values),
      static_cast<float*>(out), rows, n_features, depth);
  return static_cast<int>(cudaGetLastError());
}

// One decision slot of a tree policy for every UE.  ``state_in`` and ``state_out``
// are host arrays of the ten state pointers in State's order, ``masks`` the four
// nullable mask pointers in Masks' order, ``reg`` (nullable) receives the register as
// the decision left it, before the boundary.  ``window`` is already
// min(window_slots, cap); ``ttl`` 0 is off; ``breaker_window`` is the trip ring's width.
extern "C" int policy_step_launch(const void* const* state_in, const void* kpm,
                                  const void* feature, const void* threshold,
                                  const void* leaves, const void* const* masks,
                                  const void* const* state_out, void* raw, void* reg,
                                  int n_ues, int cap, int n_feat, int window, int depth,
                                  int hysteresis, int decide, int slot_idx, int ttl,
                                  int default_mode, int breaker_trips, int breaker_window,
                                  int breaker_cooldown, void* stream) {
  if (n_ues < 1 || cap < 1 || n_feat < 1 || window < 1 || window > cap || slot_idx < 0 ||
      ttl < 0 || breaker_window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto state = [](const void* const* p) {
    return State{(float*)p[0], (long long*)p[1], (long long*)p[2], (int32_t*)p[3],
                 (int32_t*)p[4], (int32_t*)p[5], (int32_t*)p[6], (int32_t*)p[7],
                 (int32_t*)p[8], (int32_t*)p[9]};
  };
  const Masks m{static_cast<const uint8_t*>(masks[0]), static_cast<const uint8_t*>(masks[1]),
                static_cast<const uint8_t*>(masks[2]), static_cast<const uint8_t*>(masks[3])};
  const Tree tree{static_cast<const int32_t*>(feature), static_cast<const float*>(threshold),
                  static_cast<const float*>(leaves), depth};
  const Ladder lad{slot_idx, ttl, default_mode, breaker_trips, breaker_window, breaker_cooldown};
  policy_step_kernel<<<(n_ues + UPB - 1) / UPB, TPB, (size_t)UPB * n_feat * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      state(state_in), static_cast<const float*>(kpm), tree, m, lad, state(state_out),
      static_cast<int32_t*>(raw), static_cast<int32_t*>(reg), n_ues, cap, n_feat, window,
      hysteresis, decide);
  return static_cast<int>(cudaGetLastError());
}
