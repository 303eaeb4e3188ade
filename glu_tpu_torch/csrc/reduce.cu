// K5, the reduce: a hand-written Hopper (sm_90a) fold of every row of a
// (parts, len) row-major tensor (glu_tpu_torch/ops/_cuda_reduce.py).
//
// Replaces glu_tpu/ops/_pallas_reduce.py::_pallas_reduce_flat (body
// _reduce_kernel), which walks 2048 x 128 tiles in one sequential grid into
// an (8, 128) accumulator. Here CTAs run in parallel and in no order, so a
// reduce is two launches of fold_tiles_kernel: per-CTA partials, then the
// fold of each row's partials. No atomics: mul has none, and a fixed order
// keeps float results the same from run to run.
//
// Bound by device-memory bytes: each input word is read once, at 3.35 TB/s
// 0.320 ms for 2^28 u32. So every load is coalesced, 16 bytes a thread
// where the rows are 16-byte aligned, with a tile's loads issued together
// before they are folded, and enough CTAs (the host asks for about 1056) are
// resident to keep the loads in flight.
//
// Plain C interface for ctypes; every entry returns a cudaError_t.

#include "fold.cuh"

namespace {

using namespace glu;

// CTA blockIdx.x = p * ctas + c folds tiles c, c + ctas, c + 2 ctas, ... of
// row p of x and writes its partial to out[blockIdx.x], i.e. out[p][c]. A
// full tile is read with VEC-wide loads (VEC > 1 only when every row starts
// on a 16-byte boundary); the ragged last tile of a row is masked item by
// item, so no padded copy of the input is made.
template <int OP, typename T, int VEC>
__global__ void __launch_bounds__(kFoldThreads)
    fold_tiles_kernel(const T* __restrict__ x, long long len, int ctas, T* __restrict__ out) {
  __shared__ T warp_vals[kFoldWarps];
  const int t = threadIdx.x;
  const long long p = blockIdx.x / ctas;
  const long long c = blockIdx.x % ctas;
  const T* row = x + p * len;
  const long long tiles = (len + kFoldTile - 1) / kFoldTile;
  T acc = identity<OP, T>();
  for (long long j = c; j < tiles; j += ctas) {
    const long long base = j * kFoldTile;
    const T* tile = row + base;
    const int tile_n = static_cast<int>(len - base < kFoldTile ? len - base : kFoldTile);
    if (VEC > 1 && tile_n == kFoldTile) {
      constexpr int kLoads = kFoldTile / (kFoldThreads * VEC);
      const Vec<T, VEC>* vt = reinterpret_cast<const Vec<T, VEC>*>(tile);
      Vec<T, VEC> v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) v[k] = vt[k * kFoldThreads + t];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc = combine<OP>(acc, v[k].v[e]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kFoldItems; ++k) {
        const int i = k * kFoldThreads + t;
        if (i < tile_n) acc = combine<OP>(acc, tile[i]);
      }
    }
  }
  acc = block_fold<OP>(acc, warp_vals);
  if (t == 0) out[blockIdx.x] = acc;
}

template <int OP, typename T>
cudaError_t launch_fold(const T* x, int parts, long long len, int ctas, T* out, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && (len * static_cast<long long>(sizeof(T))) % 16 == 0;
  const unsigned grid = static_cast<unsigned>(static_cast<long long>(parts) * ctas);
  if (aligned) {
    fold_tiles_kernel<OP, T, kVec><<<grid, kFoldThreads, 0, stream>>>(x, len, ctas, out);
  } else {
    fold_tiles_kernel<OP, T, 1><<<grid, kFoldThreads, 0, stream>>>(x, len, ctas, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int glu_fold_tile() { return kFoldTile; }

// out[p][c] = fold of tiles c, c + ctas, ... of row p of the (parts, len)
// input x; with ctas == 1, out[p] = fold of row p. dtype and op are the
// DType and Op codes of fold.cuh.
int glu_reduce_pass(const void* x, int parts, long long len, int ctas, int dtype, int op, void* out,
                    void* stream) {
  if (x == nullptr || out == nullptr || parts < 1 || len < 1 || ctas < 1 ||
      static_cast<long long>(parts) * ctas > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return with_dtype_op(dtype, op, [&](auto op_c, auto t_c) {
    using T = decltype(t_c);
    return launch_fold<decltype(op_c)::value, T>(static_cast<const T*>(x), parts, len, ctas,
                                                 static_cast<T*>(out), static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
