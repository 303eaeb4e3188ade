// K4, the exclusive scan: a hand-written Hopper (sm_90a) reduce-then-scan
// of every row of a (parts, len) row-major tensor
// (glu_tpu_torch/ops/_cuda_scan.py).
//
// Replaces glu_tpu/ops/_pallas_scan.py::pallas_exclusive_scan (body
// _scan_kernel), which chains a carry through SMEM over a sequential grid of
// 2048 x 128 tiles and resets it at each partition. CTAs run in no order
// here, so each tile's carry-in comes from a first pass:
//   1. glu_reduce_pass (reduce.cu), one CTA per tile: the tile aggregates;
//   2. glu_scan_pass without carries: one CTA per row scans the row's tile
//      aggregates in order from the identity, which gives the carry-ins;
//   3. glu_scan_pass with the carry-ins: one CTA per tile.
// A row of at most one tile takes step 2 alone, on the input.
//
// Bound by device-memory bytes: the scan must read each word once and write
// it once, 2.15 GB for 2^28 u32, 0.641 ms at 3.35 TB/s; this design reads
// the input twice (steps 1 and 3), 0.961 ms. Loads and stores are
// coalesced and staged through shared memory, where each thread scans its
// 16 consecutive items; the operator's exclusive scan is written directly,
// for every operator, with no `inclusive - x` and no one-slot shift.
//
// Plain C interface for ctypes; every entry returns a cudaError_t.

#include "fold.cuh"

namespace {

using namespace glu;

// One word of padding after every 32, so that threads reading their 16
// consecutive items (stride 16) fall on different banks.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }
constexpr int kTileBuf = padded(kFoldTile);

// Exclusive scan of one tile of tile_n <= kFoldTile items from `in` to
// `out`, seeded with `carry`. Returns, in every thread, carry op (fold of
// the tile). Items past tile_n are neither read nor written: they enter the
// scan as the identity. Ends with a barrier, so buf may be reused at once.
template <int OP, typename T>
__device__ T scan_tile(const T* __restrict__ in, T* __restrict__ out, int tile_n, T carry, T* buf,
                       T* warp_vals) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kFoldItems; ++k) {  // striped, coalesced loads
    const int i = k * kFoldThreads + t;
    buf[padded(i)] = i < tile_n ? in[i] : identity<OP, T>();
  }
  __syncthreads();
  const int first = t * kFoldItems;  // this thread's consecutive items
  T items[kFoldItems];
  T own = identity<OP, T>();
#pragma unroll
  for (int j = 0; j < kFoldItems; ++j) {
    items[j] = buf[padded(first + j)];
    own = combine<OP>(own, items[j]);
  }
  T total;
  T run = combine<OP>(carry, block_exclusive_scan<OP>(own, warp_vals, &total));
#pragma unroll
  for (int j = 0; j < kFoldItems; ++j) {
    buf[padded(first + j)] = run;
    run = combine<OP>(run, items[j]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kFoldItems; ++k) {  // striped, coalesced stores
    const int i = k * kFoldThreads + t;
    if (i < tile_n) out[i] = buf[padded(i)];
  }
  __syncthreads();
  return combine<OP>(carry, total);
}

// With carries == nullptr: CTA p scans all of row p, tile after tile, the
// carry running from the identity. Otherwise: CTA p * tiles + j scans tile j
// of row p, seeded with carries[p * tiles + j].
template <int OP, typename T>
__global__ void __launch_bounds__(kFoldThreads)
    scan_tiles_kernel(const T* __restrict__ x, T* __restrict__ y, long long len, int tiles,
                      const T* __restrict__ carries) {
  __shared__ T buf[kTileBuf];
  __shared__ T warp_vals[kFoldWarps + 1];
  if (carries == nullptr) {
    const long long row = static_cast<long long>(blockIdx.x) * len;
    T carry = identity<OP, T>();
    for (long long base = 0; base < len; base += kFoldTile) {
      const int tile_n = static_cast<int>(len - base < kFoldTile ? len - base : kFoldTile);
      carry = scan_tile<OP>(x + row + base, y + row + base, tile_n, carry, buf, warp_vals);
    }
  } else {
    const long long p = blockIdx.x / tiles;
    const long long base = (blockIdx.x % tiles) * static_cast<long long>(kFoldTile);
    const int tile_n = static_cast<int>(len - base < kFoldTile ? len - base : kFoldTile);
    scan_tile<OP>(x + p * len + base, y + p * len + base, tile_n, carries[blockIdx.x], buf, warp_vals);
  }
}

template <int OP, typename T>
cudaError_t launch_scan(const T* x, T* y, int parts, long long len, const T* carries,
                        cudaStream_t stream) {
  const long long tiles = (len + kFoldTile - 1) / kFoldTile;
  const long long grid = carries == nullptr ? parts : parts * tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  scan_tiles_kernel<OP, T><<<static_cast<unsigned>(grid), kFoldThreads, 0, stream>>>(
      x, y, len, static_cast<int>(tiles), carries);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = exclusive scan of each row of the (parts, len) input x under op,
// seeded per row with the identity (carries == nullptr), or per tile with
// carries[p][j] (carries given). dtype and op are the codes of fold.cuh.
int glu_scan_pass(const void* x, void* y, int parts, long long len, int dtype, int op,
                  const void* carries, void* stream) {
  if (x == nullptr || y == nullptr || parts < 1 || len < 1) return cudaErrorInvalidValue;
  return with_dtype_op(dtype, op, [&](auto op_c, auto t_c) {
    using T = decltype(t_c);
    return launch_scan<decltype(op_c)::value, T>(static_cast<const T*>(x), static_cast<T*>(y), parts,
                                                 len, static_cast<const T*>(carries),
                                                 static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
