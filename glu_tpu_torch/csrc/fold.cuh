// Operators, identities and block-wide folds and scans shared by the reduce
// (K5, reduce.cu) and exclusive-scan (K4, scan.cu) kernels.
//
// Every kernel is a template on (OP, T): OP one of glu_tpu_torch's
// ReduceOperator values, T one of int32_t, uint32_t, float, double (the
// base types of the 12 DataTypes). uint32_t wraps and compares as unsigned
// natively, so the TPU's u32 -> i32 isomorphisms are not needed; int32_t
// sums and products are taken in uint32_t, where wrapping is defined.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace glu {

enum Op { kSum = 0, kMul = 1, kMin = 2, kMax = 3 };
enum DType { kInt32 = 0, kUint32 = 1, kFloat32 = 2, kFloat64 = 3 };

constexpr int kFoldThreads = 256;
constexpr int kFoldItems = 16;
constexpr int kFoldTile = kFoldThreads * kFoldItems;  // 4096 elements per tile
constexpr int kFoldWarps = kFoldThreads / 32;

// VEC values of T loaded or stored as one access (16 bytes for VEC = 16 / sizeof(T)).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T>
__device__ __forceinline__ bool is_nan(T v) {
  return v != v;  // false for every integer
}

template <typename T>
__device__ __forceinline__ T add(T a, T b) {
  return a + b;
}
template <>
__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
template <typename T>
__device__ __forceinline__ T mul(T a, T b) {
  return a * b;
}
template <>
__device__ __forceinline__ int32_t mul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

// a op b. min and max propagate NaN, as jnp.minimum / jnp.maximum and
// torch.minimum / torch.maximum do (fminf / fmaxf would drop it).
template <int OP, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (OP == kSum) {
    return add(a, b);
  } else if constexpr (OP == kMul) {
    return mul(a, b);
  } else {
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    if constexpr (OP == kMin) {
      return b < a ? b : a;
    } else {
      return a < b ? b : a;
    }
  }
}

template <typename T>
__device__ __forceinline__ T highest();
template <>
__device__ __forceinline__ int32_t highest() { return INT32_MAX; }
template <>
__device__ __forceinline__ uint32_t highest() { return UINT32_MAX; }
template <>
__device__ __forceinline__ float highest() { return __int_as_float(0x7f800000); }  // +inf
template <>
__device__ __forceinline__ double highest() { return __longlong_as_double(0x7ff0000000000000LL); }

template <typename T>
__device__ __forceinline__ T lowest();
template <>
__device__ __forceinline__ int32_t lowest() { return INT32_MIN; }
template <>
__device__ __forceinline__ uint32_t lowest() { return 0u; }
template <>
__device__ __forceinline__ float lowest() { return __int_as_float(0xff800000); }  // -inf
template <>
__device__ __forceinline__ double lowest() { return __longlong_as_double(0xfff0000000000000LL); }

template <int OP, typename T>
__device__ __forceinline__ T identity() {
  if constexpr (OP == kSum) return T(0);
  else if constexpr (OP == kMul) return T(1);
  else if constexpr (OP == kMin) return highest<T>();
  else return lowest<T>();
}

// How a thread's VEC lanes meet the C components of an (N, C) stream read
// as flat elements: lane e of thread t holds flat element (t * VEC + e) plus a
// multiple of kFoldThreads * VEC, which is a multiple of C, so its component
// (t * VEC + e) % C is the same in every load. The lanes fold into kSlots =
// min(C, VEC) accumulators, lane e into slot e % kSlots; slot s of thread t
// holds component (t * VEC + s) % C, and threads t and t + kStride hold the
// same components.
template <int C, int VEC>
struct Lanes {
  static_assert(C == 1 || C == 2 || C == 4, "components: 1, 2 or 4");
  static constexpr int kSlots = C < VEC ? C : VEC;
  static constexpr int kStride = C / kSlots;
  static __device__ __forceinline__ int component(int t, int s) { return (t * VEC + s) % C; }
};

// Fold of each component over the block, in a fixed order: a warp's shuffle
// tree with offsets 16 .. kStride (which keep components apart), then warp 0
// folds the warps' values of each component, lower warps on the left.
// total[c] is valid in thread 0. warp_vals holds C * kFoldWarps values; the
// caller syncs before warp_vals is written again.
template <int OP, int C, int VEC, typename T>
__device__ __forceinline__ void block_fold(T (&acc)[Lanes<C, VEC>::kSlots], T* warp_vals, T (&total)[C]) {
  using L = Lanes<C, VEC>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < L::kSlots; ++s) {
#pragma unroll
    for (int o = 16; o >= L::kStride; o >>= 1) {
      const T other = __shfl_down_sync(0xffffffffu, acc[s], o);
      if (lane + o < 32) acc[s] = combine<OP>(acc[s], other);
    }
  }
  if (lane < L::kStride) {
#pragma unroll
    for (int s = 0; s < L::kSlots; ++s) warp_vals[L::component(lane, s) * kFoldWarps + warp] = acc[s];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      T v = lane < kFoldWarps ? warp_vals[c * kFoldWarps + lane] : identity<OP, T>();
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const T other = __shfl_down_sync(0xffffffffu, v, o);
        if (lane + o < 32) v = combine<OP>(v, other);
      }
      total[c] = v;
    }
  }
}

// Exclusive scan of one value per thread over a block of WARPS warps, in
// thread order: thread t gets op(v_0 .. v_{t-1}), thread 0 the identity;
// *total gets the fold of all. warp_vals holds WARPS + 1 values. Ends with a
// barrier, so the caller may reuse warp_vals at once.
template <int OP, int WARPS, typename T>
__device__ T block_exclusive_scan(T v, T* warp_vals, T* total) {
  static_assert(WARPS >= 1 && WARPS <= 32, "one warp scans the warp totals");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T left = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc = combine<OP>(left, inc);
  }
  T exc = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) exc = identity<OP, T>();
  if (lane == 31) warp_vals[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const T w = lane < WARPS ? warp_vals[lane] : identity<OP, T>();
    T s = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T left = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s = combine<OP>(left, s);
    }
    T before = __shfl_up_sync(0xffffffffu, s, 1);
    if (lane == 0) before = identity<OP, T>();
    if (lane < WARPS) warp_vals[lane] = before;
    if (lane == WARPS - 1) warp_vals[WARPS] = s;
  }
  __syncthreads();
  *total = warp_vals[WARPS];
  const T result = combine<OP>(warp_vals[warp], exc);
  __syncthreads();
  return result;
}

// Calls f(std::integral_constant<int, OP>, T()) for the runtime (dtype, op).
template <typename T, typename F>
cudaError_t with_op(int op, F&& f) {
  switch (op) {
    case kSum: return f(std::integral_constant<int, kSum>(), T());
    case kMul: return f(std::integral_constant<int, kMul>(), T());
    case kMin: return f(std::integral_constant<int, kMin>(), T());
    case kMax: return f(std::integral_constant<int, kMax>(), T());
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_dtype_op(int dtype, int op, F&& f) {
  switch (dtype) {
    case kInt32: return with_op<int32_t>(op, f);
    case kUint32: return with_op<uint32_t>(op, f);
    case kFloat32: return with_op<float>(op, f);
    case kFloat64: return with_op<double>(op, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace glu
