// K5, the reduce: a hand-written Hopper (sm_90a) fold of every row of a
// (parts, len, comps) row-major tensor to (parts, comps), in one launch
// (glu_tpu_torch/ops/_cuda_reduce.py).
//
// Replaces glu_tpu/ops/_pallas_reduce.py::_pallas_reduce_flat (body
// _reduce_kernel), which walks 2048 x 128 tiles in one sequential grid into
// an (8, 128) accumulator, and pallas_reduce's vmap of it over a transposed
// copy of an (N, C) vector stream. Here CTAs run in parallel and in no order:
// `ctas` CTAs share a row, each folds its tiles into C partials, and the
// last CTA of the row to finish folds the row's partials (the
// threadFenceReduction pattern of the CUDA programming guide). The last CTA
// folds them in CTA order whichever CTA it is, so float results are the same
// from run to run; no atomics touch the values (mul has none).
//
// Bound by device-memory bytes: each input word is read once, at 3.35 TB/s
// 0.320 ms for 2^28 u32. So every load is coalesced, 16 bytes a thread
// where the rows are 16-byte aligned, with a tile's loads issued together
// before they are folded, and enough CTAs (the host asks for about 1056) are
// resident to keep the loads in flight. An (N, C) stream is read where it
// lies, with no transposed copy: a tile is kFoldTile flat elements, a whole
// number of vectors, and each lane of a thread meets one component
// (fold.cuh, Lanes). The only other traffic is one partial per CTA and one
// ticket per row, in a scratch buffer the wrapper zeroes once: the last CTA
// sets its row's ticket back to 0, so no launch needs a fill before it.
//
// Plain C interface for ctypes; every entry returns a cudaError_t.

#include "fold.cuh"

namespace {

using namespace glu;

// CTA blockIdx.x = p * ctas + k folds tiles k, k + ctas, k + 2 ctas, ... of
// row p of x (len flat elements, C components). A full tile is read with
// VEC-wide loads (VEC > 1 only when every row starts on a 16-byte boundary);
// the ragged last tile of a row is masked item by item in the same lanes, so
// no padded copy of the input is made. With ctas == 1 the CTA writes
// out[p][0..C) itself; else it writes partials[p][k][0..C), draws a ticket
// from tickets[p], and the CTA that draws ctas - 1 folds the row's partials
// into out[p] and sets tickets[p] back to 0.
template <int OP, typename T, int VEC, int C>
__global__ void __launch_bounds__(kFoldThreads)
    reduce_onepass_kernel(const T* __restrict__ x, long long len, int ctas, unsigned* __restrict__ tickets,
                          T* __restrict__ partials, T* __restrict__ out) {
  using L = Lanes<C, VEC>;
  __shared__ T warp_vals[C * kFoldWarps];
  __shared__ bool last;
  const int t = threadIdx.x;
  const long long p = blockIdx.x / ctas;
  const int k0 = static_cast<int>(blockIdx.x % ctas);
  const T* row = x + p * len;
  const long long tiles = (len + kFoldTile - 1) / kFoldTile;
  constexpr int kLoads = kFoldTile / (kFoldThreads * VEC);
  T acc[L::kSlots];
#pragma unroll
  for (int s = 0; s < L::kSlots; ++s) acc[s] = identity<OP, T>();
  for (long long j = k0; j < tiles; j += ctas) {
    const long long base = j * kFoldTile;
    const T* tile = row + base;
    const int tile_n = static_cast<int>(len - base < kFoldTile ? len - base : kFoldTile);
    if (VEC > 1 && tile_n == kFoldTile) {
      const Vec<T, VEC>* vt = reinterpret_cast<const Vec<T, VEC>*>(tile);
      Vec<T, VEC> v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) v[k] = vt[k * kFoldThreads + t];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e % L::kSlots] = combine<OP>(acc[e % L::kSlots], v[k].v[e]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int i = (k * kFoldThreads + t) * VEC + e;
          if (i < tile_n) acc[e % L::kSlots] = combine<OP>(acc[e % L::kSlots], tile[i]);
        }
      }
    }
  }
  T total[C];
  block_fold<OP, C, VEC>(acc, warp_vals, total);
  if (ctas == 1) {
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) out[p * C + c] = total[c];
    }
    return;
  }
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) partials[static_cast<long long>(blockIdx.x) * C + c] = total[c];
    __threadfence();  // the partials are visible device-wide before the ticket is drawn
    last = atomicAdd(tickets + p, 1u) == static_cast<unsigned>(ctas - 1);
    if (last) __threadfence();  // and the others' partials before they are read
  }
  __syncthreads();
  if (!last) return;
  // The row's partials, in CTA order: thread t folds CTAs t, t + kFoldThreads,
  // ..., then the block tree; read through L2 (__ldcg), never a stale L1.
  const T* mine = partials + p * ctas * C;
  T part[C];
#pragma unroll
  for (int c = 0; c < C; ++c) part[c] = identity<OP, T>();
  for (int i = t; i < ctas; i += kFoldThreads) {
#pragma unroll
    for (int c = 0; c < C; ++c) part[c] = combine<OP>(part[c], __ldcg(mine + static_cast<long long>(i) * C + c));
  }
  block_fold<OP, C, C>(part, warp_vals, total);
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[p * C + c] = total[c];
    tickets[p] = 0;
  }
}

template <int OP, typename T, int C>
cudaError_t launch_reduce(const T* x, int parts, long long len, int ctas, unsigned* tickets, T* partials, T* out,
                          cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       (parts == 1 || (len * static_cast<long long>(sizeof(T))) % 16 == 0);
  const unsigned grid = static_cast<unsigned>(static_cast<long long>(parts) * ctas);
  if (aligned) {
    reduce_onepass_kernel<OP, T, kVec, C><<<grid, kFoldThreads, 0, stream>>>(x, len, ctas, tickets, partials, out);
  } else {
    reduce_onepass_kernel<OP, T, 1, C><<<grid, kFoldThreads, 0, stream>>>(x, len, ctas, tickets, partials, out);
  }
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, C>()) for the runtime component count.
template <typename F>
cudaError_t with_components(int comps, F&& f) {
  switch (comps) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int glu_fold_tile() { return kFoldTile; }

// out[p][0..comps) = fold of row p of the (parts, len, comps) input x, each
// component on its own, under op, in one launch of parts * ctas CTAs. With
// ctas > 1, tickets holds parts zeroed unsigned words and partials room for
// parts * ctas * comps values; the kernel leaves every ticket at 0. dtype and
// op are the DType and Op codes of fold.cuh.
int glu_reduce(const void* x, int parts, long long len, int comps, int ctas, int dtype, int op, void* tickets,
               void* partials, void* out, void* stream) {
  if (x == nullptr || out == nullptr || parts < 1 || len < 1 || ctas < 1 ||
      static_cast<long long>(parts) * ctas > 0x7fffffffLL || (ctas > 1 && (tickets == nullptr || partials == nullptr)))
    return cudaErrorInvalidValue;
  return with_components(comps, [&](auto c_c) {
    return with_dtype_op(dtype, op, [&](auto op_c, auto t_c) {
      using T = decltype(t_c);
      return launch_reduce<decltype(op_c)::value, T, decltype(c_c)::value>(
          static_cast<const T*>(x), parts, len * comps, ctas, static_cast<unsigned*>(tickets),
          static_cast<T*>(partials), static_cast<T*>(out), static_cast<cudaStream_t>(stream));
    });
  });
}

}  // extern "C"
