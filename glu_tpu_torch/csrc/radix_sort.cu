// Hand-written Hopper (sm_90a) kernels of the stable LSD radix sort of u32
// keys carrying u32 payload streams (glu_tpu_torch/ops/_cuda_sort.py).
//
// Per pass of 1-6 key bits the engine runs group_tiles (K1), two exclusive
// cumsums over the [tile][bin] counts in plain torch, and scatter_runs (K2).
// An input that fits one CTA's shared memory takes sort_single_tile (K3),
// which runs every pass in one launch.
//
// Bit positions (LSB-first) and stream pointers travel by value, so one
// compiled kernel serves every pass and every payload count. Words are
// uint32_t here; the Python side carries them as int32 bit patterns.
//
// Plain C interface for ctypes (no PyTorch headers, so nvcc takes seconds):
// every entry returns a cudaError_t, cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStreams = 8;       // keys + up to 7 payload streams
constexpr int kMaxPassBits = 6;      // K1/K2 group 1-6 key bits per pass
constexpr int kMaxBins = 1 << kMaxPassBits;
constexpr int kMaxPositions = 32;

constexpr int kTileThreads = 256;
constexpr int kTileItems = 16;
constexpr int kTile = kTileThreads * kTileItems;  // 4096 elements per K1/K2 tile

constexpr int kSingleThreads = 512;
constexpr int kSingleItems = 32;
constexpr int kSingleMax = kSingleThreads * kSingleItems;  // 16384: K3's limit
constexpr int kSinglePassBits = 4;
constexpr int kSingleBins = 1 << kSinglePassBits;

struct BitPositions {
  int bit[kMaxPositions];
  int count;
};

struct Streams {
  const uint32_t* in[kMaxStreams];
  uint32_t* out[kMaxStreams];
  int count;
};

// One word of padding after every 32 shared-memory words, so that threads
// reading their blocked items (stride ITEMS) fall on different banks.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }

__device__ __forceinline__ uint32_t digit_of(uint32_t key, const int* bit, int nbits) {
  uint32_t d = 0;
  for (int j = 0; j < nbits; ++j) d |= ((key >> bit[j]) & 1u) << j;
  return d;
}

// Copies the by-value launch arguments that are indexed at run time into
// shared memory (static indices only, so nothing spills to local memory).
__device__ __forceinline__ void stage_args(const Streams& s, const BitPositions& pos,
                                           const uint32_t** s_in, uint32_t** s_out,
                                           int* s_bit) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kMaxStreams; ++j) {
      s_in[j] = s.in[j];
      s_out[j] = s.out[j];
    }
#pragma unroll
    for (int j = 0; j < kMaxPositions; ++j) s_bit[j] = pos.bit[j];
  }
  __syncthreads();
}

// Exclusive sum of one int per thread over the block; *total gets the sum of
// all. warp_sums holds THREADS/32 + 1 ints. Ends with a barrier, so the
// caller may reuse warp_sums at once.
template <int THREADS>
__device__ int block_exclusive_sum(int value, int* warp_sums, int* total) {
  constexpr int kWarps = THREADS / 32;
  static_assert(THREADS % 32 == 0 && kWarps <= 32, "block scan shape");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = value;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_sums[lane] : 0;
    int sum = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, sum, o);
      if (lane >= o) sum += y;
    }
    if (lane < kWarps) warp_sums[lane] = sum - w;
    if (lane == 31) warp_sums[kWarps] = sum;
  }
  __syncthreads();
  *total = warp_sums[kWarps];
  const int result = warp_sums[warp] + x - value;
  __syncthreads();
  return result;
}

// Stable rank, by digit, of this thread's ITEMS blocked items: tile positions
// threadIdx.x * ITEMS + j, of which the first `nvalid` are real.
//
// Each thread counts its own items in its own column of counters[bin][thread]
// in item order. No atomics take part, so equal digits keep their input
// order. One block-wide exclusive sum over the [bin][thread] table then gives
// each (bin, thread) its first rank: every item of a lower bin plus the items
// of this bin held by lower threads. bin_start[d] receives the first rank of
// bin d and bin_start[bins] the number of real items.
template <int THREADS, int ITEMS>
__device__ void rank_blocked(const uint32_t (&digit)[ITEMS], int nvalid, int bins,
                             int* counters, int* warp_sums, int* bin_start,
                             int (&rank)[ITEMS]) {
  const int t = threadIdx.x;
  for (int i = t; i < bins * THREADS; i += THREADS) counters[i] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (j < nvalid) {
      int* c = counters + digit[j] * THREADS + t;
      rank[j] = *c;
      *c = rank[j] + 1;
    }
  }
  __syncthreads();
  // thread t scans the contiguous run [t * bins, (t + 1) * bins) of the table
  int* mine = counters + t * bins;
  int sum = 0;
  for (int k = 0; k < bins; ++k) sum += mine[k];
  int total;
  int run = block_exclusive_sum<THREADS>(sum, warp_sums, &total);
  for (int k = 0; k < bins; ++k) {
    const int c = mine[k];
    mine[k] = run;
    run += c;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (j < nvalid) rank[j] += counters[digit[j] * THREADS + t];
  }
  for (int d = t; d < bins; d += THREADS) bin_start[d] = counters[d * THREADS];
  if (t == 0) bin_start[bins] = total;
  __syncthreads();
}

// K1. Replaces glu_tpu/ops/_pallas_sort.py::_group_pass (the 1-bit splits of
// _split_round and the histogram of _counts_row).
//
// One CTA per tile of kTile elements: it groups the tile stably by the digit
// of the key bits at pos, for every stream, and writes the tile's row of
// counts[tile][bin]. Bound by device-memory bytes: each stream is read once
// and written once (the keys are read twice; the second read comes from L2).
// So the tile is loaded with coalesced striped reads, ranked in shared memory,
// permuted in shared memory, and stored with coalesced striped writes. The
// ragged last tile is masked: only its real elements are counted and moved.
__global__ void __launch_bounds__(kTileThreads)
    group_tiles_kernel(Streams s, int n, BitPositions pos, int* counts) {
  extern __shared__ int smem[];
  __shared__ const uint32_t* s_in[kMaxStreams];
  __shared__ uint32_t* s_out[kMaxStreams];
  __shared__ int s_bit[kMaxPositions];
  __shared__ int warp_sums[kTileThreads / 32 + 1];
  __shared__ int bin_start[kMaxBins + 1];
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem);                   // padded(kTile) words
  uint16_t* dest = reinterpret_cast<uint16_t*>(buf + padded(kTile));   // kTile in-tile ranks
  int* counters = reinterpret_cast<int*>(dest + kTile);                 // bins * kTileThreads
  stage_args(s, pos, s_in, s_out, s_bit);

  const int t = threadIdx.x;
  const int nbits = pos.count;
  const int bins = 1 << nbits;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int tile_n = static_cast<int>(min(static_cast<long long>(kTile), n - base));

  const uint32_t* keys = s_in[0] + base;
  for (int i = t; i < tile_n; i += kTileThreads) buf[padded(i)] = keys[i];
  __syncthreads();

  const int first = t * kTileItems;
  const int nvalid = max(0, min(kTileItems, tile_n - first));
  uint32_t digit[kTileItems];
  int rank[kTileItems];
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    digit[j] = j < nvalid ? digit_of(buf[padded(first + j)], s_bit, nbits) : 0u;
    rank[j] = 0;
  }
  rank_blocked<kTileThreads, kTileItems>(digit, nvalid, bins, counters, warp_sums, bin_start,
                                         rank);
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    if (j < nvalid) dest[first + j] = static_cast<uint16_t>(rank[j]);
  }
  for (int d = t; d < bins; d += kTileThreads)
    counts[static_cast<long long>(blockIdx.x) * bins + d] = bin_start[d + 1] - bin_start[d];
  __syncthreads();

  for (int st = 0; st < s.count; ++st) {
    const uint32_t* in = s_in[st] + base;
    uint32_t* out = s_out[st] + base;
    for (int i = t; i < tile_n; i += kTileThreads) buf[padded(dest[i])] = in[i];
    __syncthreads();
    for (int i = t; i < tile_n; i += kTileThreads) out[i] = buf[padded(i)];
    __syncthreads();
  }
}

// K2. Replaces glu_tpu/ops/_pallas_sort.py::_splice_streams (the run splicer
// of _splice_kernel_factory) together with the run placement of
// _run_descriptors.
//
// One CTA per tile of K1's output. offsets[tile][d] is where the tile's run
// of digit d starts in the output (the digit's base plus the same digit's
// counts in earlier tiles). The element at in-tile position i with digit d
// goes to offsets[tile][d] + i - (first in-tile position of digit d). Bound
// by device-memory bytes: one read and one write per word. Reads are striped
// and coalesced; each run is contiguous in both buffers, so the writes of a
// warp fall on few segments as well.
__global__ void __launch_bounds__(kTileThreads)
    scatter_runs_kernel(Streams s, int n, BitPositions pos, const int* counts,
                        const int* offsets) {
  __shared__ const uint32_t* s_in[kMaxStreams];
  __shared__ uint32_t* s_out[kMaxStreams];
  __shared__ int s_bit[kMaxPositions];
  __shared__ int shift[kMaxBins];  // offsets[tile][d] minus the in-tile start of d
  stage_args(s, pos, s_in, s_out, s_bit);

  const int t = threadIdx.x;
  const int nbits = pos.count;
  const int bins = 1 << nbits;
  const long long row = static_cast<long long>(blockIdx.x) * bins;
  if (t == 0) {
    int run = 0;
    for (int d = 0; d < bins; ++d) {
      shift[d] = offsets[row + d] - run;
      run += counts[row + d];
    }
  }
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int tile_n = static_cast<int>(min(static_cast<long long>(kTile), n - base));
  const uint32_t* keys = s_in[0] + base;
  uint32_t key[kTileItems];
  int dst[kTileItems];
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const int i = j * kTileThreads + t;
    if (i < tile_n) {
      key[j] = keys[i];
      dst[j] = shift[digit_of(key[j], s_bit, nbits)] + i;
    } else {
      key[j] = 0u;
      dst[j] = 0;
    }
  }
  uint32_t* out_keys = s_out[0];
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    if (j * kTileThreads + t < tile_n) out_keys[dst[j]] = key[j];
  }
  for (int st = 1; st < s.count; ++st) {
    const uint32_t* in = s_in[st] + base;
    uint32_t* out = s_out[st];
#pragma unroll
    for (int j = 0; j < kTileItems; ++j) {
      const int i = j * kTileThreads + t;
      if (i < tile_n) out[dst[j]] = in[i];
    }
  }
}

// K3. Replaces glu_tpu/ops/_pallas_sort.py::_single_block_sort.
//
// One CTA sorts all of an input of at most kSingleMax elements: the keys and
// a u16 source index stay in shared memory through every 4-bit pass (the same
// rank as K1), and the payload streams are gathered once at the end by that
// index. So the device memory sees one read and one write per word, whatever
// the number of passes; what bounds the kernel is the single SM it runs on.
// Carrying the index instead of the payloads keeps the shared-memory need at
// 6 bytes per element for any payload count: 16384 elements take 134,144
// bytes of the 232,448 a block may have.
__global__ void __launch_bounds__(kSingleThreads)
    sort_single_tile_kernel(Streams s, int n, BitPositions pos) {
  extern __shared__ int smem[];
  __shared__ const uint32_t* s_in[kMaxStreams];
  __shared__ uint32_t* s_out[kMaxStreams];
  __shared__ int s_bit[kMaxPositions];
  __shared__ int warp_sums[kSingleThreads / 32 + 1];
  __shared__ int bin_start[kSingleBins + 1];
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);                          // padded(kSingleMax)
  uint16_t* index = reinterpret_cast<uint16_t*>(keys + padded(kSingleMax));   // padded(kSingleMax)
  int* counters = reinterpret_cast<int*>(index + padded(kSingleMax));          // kSingleBins * threads
  stage_args(s, pos, s_in, s_out, s_bit);

  const int t = threadIdx.x;
  for (int i = t; i < n; i += kSingleThreads) {
    keys[padded(i)] = s_in[0][i];
    index[padded(i)] = static_cast<uint16_t>(i);
  }
  __syncthreads();

  const int first = t * kSingleItems;
  const int nvalid = max(0, min(kSingleItems, n - first));
  for (int p0 = 0; p0 < pos.count; p0 += kSinglePassBits) {
    const int nbits = min(kSinglePassBits, pos.count - p0);
    uint32_t key[kSingleItems];
    uint32_t digit[kSingleItems];
    int rank[kSingleItems];
#pragma unroll
    for (int j = 0; j < kSingleItems; ++j) {
      key[j] = j < nvalid ? keys[padded(first + j)] : 0u;
      digit[j] = j < nvalid ? digit_of(key[j], s_bit + p0, nbits) : 0u;
      rank[j] = 0;
    }
    rank_blocked<kSingleThreads, kSingleItems>(digit, nvalid, 1 << nbits, counters, warp_sums,
                                               bin_start, rank);
    uint16_t src[kSingleItems];
#pragma unroll
    for (int j = 0; j < kSingleItems; ++j) src[j] = j < nvalid ? index[padded(first + j)] : 0;
    __syncthreads();  // every index entry is read before any is overwritten
#pragma unroll
    for (int j = 0; j < kSingleItems; ++j) {
      if (j < nvalid) {
        keys[padded(rank[j])] = key[j];
        index[padded(rank[j])] = src[j];
      }
    }
    __syncthreads();
  }

  for (int i = t; i < n; i += kSingleThreads) s_out[0][i] = keys[padded(i)];
  for (int st = 1; st < s.count; ++st) {
    const uint32_t* in = s_in[st];
    uint32_t* out = s_out[st];
    for (int i = t; i < n; i += kSingleThreads) out[i] = in[index[padded(i)]];
  }
}

constexpr int kGroupTilesFixedSmem = padded(kTile) * 4 + kTile * 2;
constexpr int kSingleTileSmem =
    padded(kSingleMax) * 4 + padded(kSingleMax) * 2 + kSingleBins * kSingleThreads * 4;

bool fill_streams(Streams* s, const void* const* in, void* const* out, int count) {
  if (in == nullptr || out == nullptr || count < 1 || count > kMaxStreams) return false;
  for (int i = 0; i < kMaxStreams; ++i) {
    s->in[i] = i < count ? static_cast<const uint32_t*>(in[i]) : nullptr;
    s->out[i] = i < count ? static_cast<uint32_t*>(out[i]) : nullptr;
    if (i < count && (s->in[i] == nullptr || s->out[i] == nullptr)) return false;
  }
  s->count = count;
  return true;
}

bool fill_positions(BitPositions* p, const int* bits, int count, int max_count) {
  if (bits == nullptr || count < 1 || count > max_count) return false;
  for (int i = 0; i < kMaxPositions; ++i) {
    const int b = i < count ? bits[i] : 0;
    if (b < 0 || b > 31) return false;
    p->bit[i] = b;
  }
  p->count = count;
  return true;
}

int num_tiles(int n) { return static_cast<int>((static_cast<long long>(n) + kTile - 1) / kTile); }

}  // namespace

extern "C" {

int glu_sort_tile() { return kTile; }
int glu_sort_single_tile_max() { return kSingleMax; }
int glu_sort_max_streams() { return kMaxStreams; }
const char* glu_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int glu_group_tiles(const void* const* in, void* const* out, int nstreams, int n,
                    const int* bits, int nbits, int* counts, void* stream) {
  Streams s;
  BitPositions pos;
  if (n < 1 || counts == nullptr || !fill_streams(&s, in, out, nstreams) ||
      !fill_positions(&pos, bits, nbits, kMaxPassBits))
    return cudaErrorInvalidValue;
  const int smem = kGroupTilesFixedSmem + (1 << nbits) * kTileThreads * 4;
  cudaError_t err = cudaFuncSetAttribute(group_tiles_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  group_tiles_kernel<<<num_tiles(n), kTileThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      s, n, pos, counts);
  return cudaGetLastError();
}

int glu_scatter_runs(const void* const* in, void* const* out, int nstreams, int n,
                     const int* bits, int nbits, const int* counts, const int* offsets,
                     void* stream) {
  Streams s;
  BitPositions pos;
  if (n < 1 || counts == nullptr || offsets == nullptr || !fill_streams(&s, in, out, nstreams) ||
      !fill_positions(&pos, bits, nbits, kMaxPassBits))
    return cudaErrorInvalidValue;
  scatter_runs_kernel<<<num_tiles(n), kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, n, pos, counts, offsets);
  return cudaGetLastError();
}

int glu_sort_single_tile(const void* const* in, void* const* out, int nstreams, int n,
                         const int* bits, int nbits, void* stream) {
  Streams s;
  BitPositions pos;
  if (n < 1 || n > kSingleMax || !fill_streams(&s, in, out, nstreams) ||
      !fill_positions(&pos, bits, nbits, kMaxPositions))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sort_single_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSingleTileSmem);
  if (err != cudaSuccess) return err;
  sort_single_tile_kernel<<<1, kSingleThreads, kSingleTileSmem,
                            static_cast<cudaStream_t>(stream)>>>(s, n, pos);
  return cudaGetLastError();
}

}  // extern "C"
