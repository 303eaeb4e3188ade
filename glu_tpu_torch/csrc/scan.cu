// K4, the exclusive scan: a hand-written Hopper (sm_90a) single-pass scan of
// every row of a (parts, len) row-major tensor (glu_tpu_torch/ops/_cuda_scan.py).
//
// Replaces glu_tpu/ops/_pallas_scan.py::pallas_exclusive_scan (body
// _scan_kernel), which chains a carry through SMEM over a sequential grid of
// 2048 x 128 tiles and resets it at each partition. CTAs run in no order
// here, so each tile finds its carry-in by a decoupled look-back over the
// tiles before it in its row (Merrill & Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016). One launch, one CTA per
// tile of kScanTile elements:
//  (a) the CTA takes the next tile id from a counter, (row, j) =
//      divmod(id, tiles), so every tile it waits on in (d) belongs to a CTA
//      that is already running;
//  (b) it loads the tile once, coalesced (16 bytes a thread where the rows
//      are 16-byte aligned and the tile is full, masked item by item at a
//      ragged end), through a padded shared-memory transpose that gives each
//      thread kScanItems consecutive items;
//  (c) a serial fold per thread and a block scan give the tile's aggregate,
//      which is published at once; tile 0 of a row publishes it as its
//      inclusive value, and its carry-in is the identity: the reset at each
//      partition, so no look-back crosses into an earlier row;
//  (d) one warp looks back, 32 tiles at a time, for the nearest earlier
//      tile that has published its inclusive value, keeping the aggregates
//      it walks past, while the other warps write the tile's local
//      exclusive scan to shared memory; it publishes inclusive = carry op
//      aggregate;
//  (e) every item is written as carry op (its local exclusive value).
//
// Float results are the same from run to run: the look-back folds what it
// read left to right, carry = inc[k] op agg[k+1] op ... op agg[j-1], so by
// induction every inclusive value is the sequential fold agg[0] op ... op
// agg[j], whichever tile the look-back happens to stop at. The walk past
// a window that holds no inclusive value is what keeps the tiles flowing:
// waiting instead for one of the 32 tiles before it to turn inclusive
// limits the card to about 32 tiles per round trip to L2 (PERF.md).
//
// Bound by device-memory bytes: each word read once and written once, 2.15
// GB for 2^28 u32, 0.641 ms at 3.35 TB/s. The design adds 8 bytes of status
// a tile for 4-byte types (24 for float64), zeroed by the caller.
//
// Plain C interface for ctypes; every entry returns a cudaError_t.

#include <cstring>

#include "fold.cuh"
#include "lookback.cuh"

namespace {

using namespace glu;

constexpr int kScanThreads = 256;
constexpr int kScanItems = 32;
constexpr int kScanTile = kScanThreads * kScanItems;  // 8192 elements per tile (PERF.md: 4096 was slower)
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kWindow = 32;  // tiles a look-back reads at once, one a lane
constexpr int kWindows = 8;  // windows a look-back walks down before it waits

// One word of padding after every 32, so that threads reading their
// kScanItems consecutive items fall on different banks.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }
constexpr int kTileBuf = padded(kScanTile);

// The status of every tile of one scan: a flag, 0 until the tile publishes,
// then kStatusAggregate or kStatusInclusive, and the value that goes with
// it. After the tiles' status, one word holds the tile counter.
template <typename T, bool PACKED = sizeof(T) == 4>
struct TileStatus;

// 4-byte T: one 64-bit word a tile, [flag | the value's bits], stored and
// loaded as one relaxed atomic.
template <typename T>
struct TileStatus<T, true> {
  static constexpr int kWordsPerTile = 1;
  unsigned long long* words;

  __device__ TileStatus(unsigned long long* status, long long) : words(status) {}

  __device__ void publish(long long k, unsigned long long flag, T v) const {
    uint32_t bits;
    memcpy(&bits, &v, sizeof bits);
    publish_status(words + k, status_word(flag, bits));
  }

  // The flag of tile k; when it is not 0, *v gets the value.
  __device__ unsigned long long read(long long k, T* v) const {
    const unsigned long long word = read_status(words + k);
    const uint32_t bits = static_cast<uint32_t>(word);
    memcpy(v, &bits, sizeof bits);
    return word & ~0xffffffffull;
  }
};

// 8-byte T (float64): the value does not fit beside the flag. agg[k] and
// inc[k] are written once each, before the flag that names them is stored
// with release semantics, and read after it is loaded with acquire
// semantics, so a reader gets the value its flag stands for.
template <typename T>
struct TileStatus<T, false> {
  static constexpr int kWordsPerTile = 3;
  unsigned long long* flags;
  T* agg;
  T* inc;

  __device__ TileStatus(unsigned long long* status, long long tiles)
      : flags(status), agg(reinterpret_cast<T*>(status + tiles)), inc(reinterpret_cast<T*>(status + 2 * tiles)) {}

  __device__ void publish(long long k, unsigned long long flag, T v) const {
    (flag == kStatusInclusive ? inc : agg)[k] = v;
    publish_flag(flags + k, flag);
  }

  __device__ unsigned long long read(long long k, T* v) const {
    const unsigned long long flag = read_flag(flags + k);
    if (flag != 0) *v = __ldcg((flag == kStatusInclusive ? inc : agg) + k);
    return flag;
  }
};

// The carry-in of tile j >= 1 of the row whose tile 0 has status index
// `row`: inc[k] op agg[k+1] op ... op agg[j-1], folded left to right, where
// k is the highest tile below j that has published its inclusive value.
// The warp reads windows of 32 tiles, lane l tile top-32+l, from top = j
// down: a window in which every tile has published its aggregate and none
// its inclusive value goes to `passed` and the walk moves one window down;
// otherwise the window is read again, until one of its tiles is inclusive
// and every tile above that one has published its aggregate. Holding only
// kWindows - 1 windows, a walk that reaches that depth waits there instead.
// Tile 0 is inclusive from its start and every tile below j belongs to a
// running CTA, so the wait ends; kLookbackSpinLimit reads trap, so a fault
// shows as a CUDA error and not as a hung card. Run by one whole warp; the
// carry is in every lane.
template <int OP, typename T, typename Status>
__device__ T look_back(const Status& status, long long row, int j, T (*passed)[kWindow]) {
  const int lane = threadIdx.x & 31;
  int top = j, held = 0;
  T v = identity<OP, T>();
  unsigned inclusive;
  for (long long spins = 0;; ) {
    const int k = top - kWindow + lane;
    const unsigned long long flag = k >= 0 ? status.read(row + k, &v) : kStatusAggregate;
    inclusive = __ballot_sync(0xffffffffu, flag == kStatusInclusive);
    const unsigned ready = __ballot_sync(0xffffffffu, flag != 0);
    if (inclusive) {
      const unsigned from = ~0u << (31 - __clz(inclusive));  // the highest inclusive lane and those above it
      if ((ready & from) == from) break;
    } else if (ready == ~0u && held < kWindows - 1) {
      passed[held++][lane] = v;
      top -= kWindow;
      continue;
    }
    if (++spins == kLookbackSpinLimit) __trap();
  }
  __syncwarp();
  const int first = 31 - __clz(inclusive);
  T carry = __shfl_sync(0xffffffffu, v, first);
  for (int l = first + 1; l < kWindow; ++l) carry = combine<OP>(carry, __shfl_sync(0xffffffffu, v, l));
  for (int w = held - 1; w >= 0; --w) {
    for (int l = 0; l < kWindow; ++l) carry = combine<OP>(carry, passed[w][l]);
  }
  return carry;
}

// One CTA per tile of the (parts, len) input x: y = its exclusive scan
// under OP, row by row. status holds TileStatus<T> of parts * tiles tiles
// and the tile counter, all zero at launch. VEC > 1 only when x, y and every
// row start on a 16-byte boundary.
template <int OP, typename T, int VEC>
__global__ void __launch_bounds__(kScanThreads)
    scan_onepass_kernel(const T* __restrict__ x, T* __restrict__ y, long long len, int tiles,
                        unsigned long long* status_words) {
  extern __shared__ __align__(16) unsigned char scan_smem[];
  T* buf = reinterpret_cast<T*>(scan_smem);  // [kTileBuf]
  __shared__ T warp_vals[kScanWarps + 1];
  __shared__ T passed[kWindows][kWindow];  // the aggregates a look-back walked past (kWindows - 1 used)
  __shared__ T s_carry;
  __shared__ int s_id;
  using Status = TileStatus<T>;
  const long long all_tiles = gridDim.x;
  const Status status(status_words, all_tiles);
  const int t = threadIdx.x;

  // (a)
  if (t == 0) {
    unsigned* counter = reinterpret_cast<unsigned*>(status_words + Status::kWordsPerTile * all_tiles);
    s_id = static_cast<int>(atomicAdd(counter, 1u));
  }
  __syncthreads();
  const int id = s_id;
  const int j = id % tiles;
  const long long row = id - j;
  const long long start = static_cast<long long>(j) * kScanTile;
  const int tile_n = static_cast<int>(min(static_cast<long long>(kScanTile), len - start));
  const long long offset = static_cast<long long>(id / tiles) * len + start;
  const bool vec = VEC > 1 && tile_n == kScanTile;

  // (b) striped, coalesced loads
  if (vec) {
    constexpr int kLoads = kScanTile / (kScanThreads * VEC);
    const Vec<T, VEC>* in = reinterpret_cast<const Vec<T, VEC>*>(x + offset);
    Vec<T, VEC> v[kLoads];
#pragma unroll
    for (int c = 0; c < kLoads; ++c) v[c] = in[c * kScanThreads + t];
#pragma unroll
    for (int c = 0; c < kLoads; ++c) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) buf[padded((c * kScanThreads + t) * VEC + e)] = v[c].v[e];
    }
  } else {
#pragma unroll
    for (int c = 0; c < kScanItems; ++c) {
      const int i = c * kScanThreads + t;
      buf[padded(i)] = i < tile_n ? x[offset + i] : identity<OP, T>();
    }
  }
  __syncthreads();

  // (c) this thread's consecutive items
  const int first = t * kScanItems;
  T items[kScanItems];
  T own = identity<OP, T>();
#pragma unroll
  for (int c = 0; c < kScanItems; ++c) {
    items[c] = buf[padded(first + c)];
    own = combine<OP>(own, items[c]);
  }
  T aggregate;
  T run = block_exclusive_scan<OP, kScanWarps>(own, warp_vals, &aggregate);
  if (t == 0) status.publish(row + j, j == 0 ? kStatusInclusive : kStatusAggregate, aggregate);

  // (d)
  if (t < 32) {
    const T carry = j == 0 ? identity<OP, T>() : look_back<OP, T>(status, row, j, passed);
    if (t == 0) {
      s_carry = carry;
      if (j > 0) status.publish(row + j, kStatusInclusive, combine<OP>(carry, aggregate));
    }
  }
#pragma unroll
  for (int c = 0; c < kScanItems; ++c) {
    buf[padded(first + c)] = run;
    run = combine<OP>(run, items[c]);
  }
  __syncthreads();

  // (e) striped, coalesced stores
  const T carry = s_carry;
  if (vec) {
    constexpr int kStores = kScanTile / (kScanThreads * VEC);
    Vec<T, VEC>* out = reinterpret_cast<Vec<T, VEC>*>(y + offset);
#pragma unroll
    for (int c = 0; c < kStores; ++c) {
      Vec<T, VEC> v;
#pragma unroll
      for (int e = 0; e < VEC; ++e) v.v[e] = combine<OP>(carry, buf[padded((c * kScanThreads + t) * VEC + e)]);
      out[c * kScanThreads + t] = v;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kScanItems; ++c) {
      const int i = c * kScanThreads + t;
      if (i < tile_n) y[offset + i] = combine<OP>(carry, buf[padded(i)]);
    }
  }
}

template <int OP, typename T, int VEC>
cudaError_t launch_onepass(const T* x, T* y, long long len, long long grid, int tiles,
                           unsigned long long* status, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(T) * kTileBuf;
  if constexpr (kSmem > 48 * 1024) {  // a tile larger than static shared memory allows
    const cudaError_t err = cudaFuncSetAttribute(scan_onepass_kernel<OP, T, VEC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
  }
  scan_onepass_kernel<OP, T, VEC><<<static_cast<unsigned>(grid), kScanThreads, kSmem, stream>>>(
      x, y, len, tiles, status);
  return cudaGetLastError();
}

template <int OP, typename T>
cudaError_t launch_scan(const T* x, T* y, int parts, long long len, unsigned long long* status,
                        cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long tiles = (len + kScanTile - 1) / kScanTile;
  const long long grid = parts * tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       (len * static_cast<long long>(sizeof(T))) % 16 == 0;
  if (aligned) return launch_onepass<OP, T, kVec>(x, y, len, grid, static_cast<int>(tiles), status, stream);
  return launch_onepass<OP, T, 1>(x, y, len, grid, static_cast<int>(tiles), status, stream);
}

}  // namespace

extern "C" {

int glu_scan_tile() { return kScanTile; }

// y = exclusive scan of each row of the (parts, len) input x under op,
// seeded per row with the identity. status: zeroed 64-bit words, one per
// tile (three for float64) and one more for the tile counter, tiles =
// parts * ceil(len / glu_scan_tile()). dtype and op are the codes of
// fold.cuh.
int glu_scan_pass(const void* x, void* y, int parts, long long len, int dtype, int op, void* status,
                  void* stream) {
  if (x == nullptr || y == nullptr || status == nullptr || parts < 1 || len < 1) return cudaErrorInvalidValue;
  return with_dtype_op(dtype, op, [&](auto op_c, auto t_c) {
    using T = decltype(t_c);
    return launch_scan<decltype(op_c)::value, T>(static_cast<const T*>(x), static_cast<T*>(y), parts, len,
                                                 static_cast<unsigned long long*>(status),
                                                 static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
