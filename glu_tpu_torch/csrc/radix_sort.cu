// Hand-written Hopper (sm_90a) kernels of the stable LSD radix sort of u32
// keys carrying u32 payload streams (glu_tpu_torch/ops/_cuda_sort.py).
//
// A sort runs digit_histograms once, which counts the digit of every pass in
// one read of the keys, then one onesweep_pass per digit of 1-8 key bits:
// each tile is ranked, finds its place through a decoupled look-back over
// the tiles before it, and writes every stream to its final place, so each
// word is read once and written once per pass (Adinets & Merrill,
// "Onesweep", 2022). An input that fits one CTA's shared memory takes
// sort_single_tile (K3), which runs every pass in one launch.
//
// Bit positions (LSB-first) and stream pointers travel by value, so one
// compiled kernel serves every pass and every payload count. Words are
// uint32_t here; the Python side carries them as int32 bit patterns.
//
// Plain C interface for ctypes (no PyTorch headers, so nvcc takes seconds):
// every entry returns a cudaError_t, cudaGetLastError() after its launch.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

using namespace glu;

constexpr int kMaxStreams = 8;       // keys + up to 7 payload streams
constexpr int kMaxPassBits = 8;      // a onesweep pass takes 1-8 key bits
constexpr int kMaxBins = 1 << kMaxPassBits;
constexpr int kMaxPasses = 4;        // 32 key bits in passes of 8
constexpr int kMaxPositions = 32;

// 6144 elements per onesweep tile: 2 CTAs per SM with one payload stream,
// 1 with seven (the shared memory holds every stream's tile). Larger tiles
// write longer runs of one digit, so fewer and fuller sectors; the variants
// that tools/onesweep_variants.py times are in PERF.md.
constexpr int kTileThreads = 384;
constexpr int kTileItems = 16;
constexpr int kTileCtasPerSm = 2;                 // __launch_bounds__ occupancy target
constexpr int kTile = kTileThreads * kTileItems;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kWarpItems = kTile / kTileWarps;    // each warp ranks a contiguous run of 512
static_assert(kTileThreads >= kMaxBins, "one thread per digit in the look-back");

constexpr int kHistThreads = 1024;

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

// The digit of one pass: key bits bit[0..nbits) (LSB-first). When they are
// contiguous, shift is the lowest of them and one shift and mask take the
// digit; otherwise shift is -1.
struct Digit {
  int bit[kMaxPassBits];
  int nbits;
  int shift;

  __device__ __forceinline__ uint32_t of(uint32_t key) const {
    if (shift >= 0) return (key >> shift) & ((1u << nbits) - 1u);
    uint32_t d = 0;
#pragma unroll
    for (int j = 0; j < kMaxPassBits; ++j) {
      if (j < nbits) d |= ((key >> bit[j]) & 1u) << j;
    }
    return d;
  }
};

struct PassDigits {
  Digit pass[kMaxPasses];
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

// The counts half of K1 (glu_tpu/ops/_pallas_sort.py::_counts_row, one row
// per block there), for every pass of the sort at once.
//
// hist[p][d] (int32, zeroed by the caller) receives the number of keys whose
// digit of pass p is d. Bound by device-memory bytes: one read of the keys,
// 1.07 GB at 2^28. Two CTAs of 1024 threads per SM read 16 bytes a thread in
// a grid-stride loop; each CTA counts in shared memory with shared atomics
// and adds its counts to hist with one global atomic per non-zero bin.
// Integer adds are exact in any order, so the result is deterministic.
__global__ void __launch_bounds__(kHistThreads)
    digit_histograms_kernel(const uint32_t* __restrict__ keys, int n, PassDigits plan,
                            int* hist) {
  __shared__ int counts[kMaxPasses * kMaxBins];
  const int t = threadIdx.x;
  for (int i = t; i < kMaxPasses * kMaxBins; i += kHistThreads) counts[i] = 0;
  __syncthreads();

  auto count = [&](uint32_t key) {
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      if (p < plan.count) atomicAdd(&counts[p * kMaxBins + plan.pass[p].of(key)], 1);
    }
  };
  const long long stride = static_cast<long long>(gridDim.x) * kHistThreads;
  const bool aligned = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  const long long nvec = aligned ? n / 4 : 0;  // 16-byte vectors, then single words
  const uint4* vec = reinterpret_cast<const uint4*>(keys);
  for (long long i = static_cast<long long>(blockIdx.x) * kHistThreads + t; i < nvec; i += stride) {
    const uint4 q = vec[i];
    count(q.x);
    count(q.y);
    count(q.z);
    count(q.w);
  }
  for (long long j = nvec * 4 + static_cast<long long>(blockIdx.x) * kHistThreads + t; j < n;
       j += stride)
    count(keys[j]);
  __syncthreads();
  for (int k = t; k < plan.count * kMaxBins; k += kHistThreads) {
    if (counts[k]) atomicAdd(&hist[k], counts[k]);
  }
}

// The lanes of the warp whose digit equals d (d < 2^nbits; 0 for the
// kMaxBins that marks a lane past the ragged end): one ballot per digit bit.
__device__ __forceinline__ unsigned match_digit(uint32_t d, int nbits) {
  unsigned peers = __ballot_sync(0xffffffffu, d < kMaxBins);
  for (int b = 0; b < nbits; ++b) {
    const unsigned bit = __ballot_sync(0xffffffffu, (d >> b) & 1u);
    peers &= (d >> b) & 1u ? bit : ~bit;
  }
  return d < kMaxBins ? peers : 0u;
}

// Starts the copy of one stream's tile (tile_n <= kTile words at `in`) into
// buf, in input order: 16 bytes a copy where `in` is 16-byte aligned, 4 at the
// ragged end or where it is not.
__device__ __forceinline__ void stage_tile_async(const uint32_t* in, uint32_t* buf, int tile_n) {
  const bool vec = (reinterpret_cast<uintptr_t>(in) & 15) == 0;
  for (int c = threadIdx.x; c < kTile / 4; c += kTileThreads) {
    const int i = 4 * c;
    if (vec && i + 4 <= tile_n) {
      cp_async16(buf + i, in + i);
    } else {
      for (int e = i; e < min(i + 4, tile_n); ++e) cp_async4(buf + e, in + e);
    }
  }
}

// K1 + K2 fused. Replaces glu_tpu/ops/_pallas_sort.py::_group_pass (the
// stable grouping of _split_round) and ::_splice_streams, with the run
// placement of _run_descriptors.
//
// One stable pass over the digit of 1-8 key bits for the keys and every
// payload stream. digit_base[d] is where digit d starts in the output (an
// exclusive sum of digit_histograms' counts). status holds one 64-bit word
// per (tile, bin) and, after them, the tile counter; all zero at launch.
// Each CTA:
//  (a) takes the next tile from the counter, so that every tile it waits on
//      in (c) belongs to a CTA that is already running;
//  (e) starts cp.async copies of every stream's tile into shared memory, in
//      input order; the payloads fly while (b) and (c) run;
//  (b) counts the tile's digits per warp (shared atomics), then publishes
//      the tile's count of each digit at once, so that later tiles can look
//      back past it while it ranks; a scan over (digit, warp) gives each
//      warp the first in-tile rank of each digit. Each warp then ranks its
//      contiguous run of items in order, 32 at a time: ballots over the
//      digit's bits find the lanes that share it (cheaper here than
//      __match_any_sync), and the lowest of them advances the warp's running
//      rank of that digit by their number. The order is (digit, warp, item,
//      lane), which is input order within a digit, so the pass is stable;
//  (c) walks back over earlier tiles (decoupled look-back, one thread per
//      digit) for the number of equal digits before this tile, then
//      publishes its inclusive count;
//  (d) writes, for every stream, the element of in-tile rank r with digit d
//      to digit_base[d] + (equal digits in earlier tiles) + r - (first
//      in-tile rank of d), gathering from shared memory in rank order, so
//      that a warp's stores fall on few contiguous runs;
//  (f) masks the ragged last tile: only its tile_n elements are moved.
// Bound by device-memory bytes: each word read once and written once, plus
// the status words. What holds it back is the latency of one tile's chain of
// steps, so the steps that wait on device memory (the tile counter, the
// copies, the look-back) start as early as they can.
__global__ void __launch_bounds__(kTileThreads, kTileCtasPerSm)
    onesweep_pass_kernel(Streams s, int n, Digit digit, const int* __restrict__ digit_base,
                         unsigned long long* status) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* stage = smem;                                                   // [s.count][kTile]
  uint16_t* source = reinterpret_cast<uint16_t*>(stage + s.count * kTile);  // [kTile]: input position of rank r
  int* warp_runs = reinterpret_cast<int*>(source + kTile);                  // [kTileWarps][kMaxBins]
  __shared__ const uint32_t* s_in[kMaxStreams];
  __shared__ uint32_t* s_out[kMaxStreams];
  __shared__ int shift[kMaxBins];  // output position minus in-tile rank, per digit
  __shared__ int warp_sums[kTileThreads / 32 + 1];
  __shared__ int s_tile;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int bins = 1 << digit.nbits;
  const bool owns_digit = t < bins;  // thread t counts, publishes and looks back for digit t
  const int tiles = static_cast<int>((static_cast<long long>(n) + kTile - 1) / kTile);
  // (a)
  if (t == 0) {
    s_tile = static_cast<int>(atomicAdd(reinterpret_cast<unsigned int*>(status + static_cast<long long>(tiles) * kMaxBins), 1u));
#pragma unroll
    for (int j = 0; j < kMaxStreams; ++j) {
      s_in[j] = s.in[j];
      s_out[j] = s.out[j];
    }
  }
  const int base_d = owns_digit ? digit_base[t] : 0;
  for (int i = t; i < kTileWarps * kMaxBins; i += kTileThreads) warp_runs[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const long long base = static_cast<long long>(tile) * kTile;
  const int tile_n = static_cast<int>(min(static_cast<long long>(kTile), n - base));

  // (e) group 0: the keys; group 1: the payloads
  stage_tile_async(s_in[0] + base, stage, tile_n);
  cp_async_commit();
  for (int st = 1; st < s.count; ++st) stage_tile_async(s_in[st] + base, stage + st * kTile, tile_n);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // (b) items first + 32 j + lane of this warp, j = 0..kTileItems-1
  const int first = warp * kWarpItems;
  int* runs = warp_runs + warp * kMaxBins;
  uint32_t dig[kTileItems];
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const int i = first + 32 * j + lane;
    dig[j] = i < tile_n ? digit.of(stage[i]) : kMaxBins;  // the ragged end: a digit of its own
    if (i < tile_n) atomicAdd(&runs[dig[j]], 1);
  }
  __syncthreads();
  int count = 0;  // this tile's items of digit t; each warp's count becomes its start among them
  if (owns_digit) {
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      const int c = warp_runs[w * kMaxBins + t];
      warp_runs[w * kMaxBins + t] = count;
      count += c;
    }
  }
  unsigned long long* word = status + static_cast<long long>(tile) * kMaxBins + t;
  if (owns_digit) publish_status(word, status_word(tile == 0 ? kStatusInclusive : kStatusAggregate, count));
  int tile_count;
  const int start = block_exclusive_sum<kTileThreads>(count, warp_sums, &tile_count);
  if (owns_digit) {
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) warp_runs[w * kMaxBins + t] += start;
  }
  __syncthreads();
  // The rows of 32 items are independent until the running ranks: every
  // row's peer mask first, then the leaders' adds, then the ranks.
  unsigned peers[kTileItems];
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) peers[j] = match_digit(dig[j], digit.nbits);
  int run[kTileItems];
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    run[j] = 0;
    if (peers[j] && lane == __ffs(peers[j]) - 1) run[j] = atomicAdd(&runs[dig[j]], __popc(peers[j]));
    __syncwarp();  // orders the adds of successive rows, made by different leader lanes
  }
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const int leader = peers[j] ? __ffs(peers[j]) - 1 : lane;
    const int rank = __shfl_sync(0xffffffffu, run[j], leader) + __popc(peers[j] & ((1u << lane) - 1u));
    if (peers[j]) source[rank] = static_cast<uint16_t>(first + 32 * j + lane);
  }

  // (c)
  if (owns_digit) {
    int before = 0;
    if (tile > 0) {
      before = static_cast<int>(look_back(status + t, kMaxBins, tile));
      publish_status(word, status_word(kStatusInclusive, before + count));
    }
    shift[t] = base_d + before - start;
  }
  cp_async_wait<0>();
  __syncthreads();

  // (d) ranks t + kTileThreads k, k = 0..kTileItems-1
  int from[kTileItems];
  int dst[kTileItems];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const int r = kTileThreads * k + t;
    if (r < tile_n) {
      from[k] = source[r];
      const uint32_t key = stage[from[k]];
      dst[k] = shift[digit.of(key)] + r;
      s_out[0][dst[k]] = key;
    }
  }
  for (int st = 1; st < s.count; ++st) {
    const uint32_t* buf = stage + st * kTile;
    uint32_t* out = s_out[st];
#pragma unroll
    for (int k = 0; k < kTileItems; ++k) {
      if (kTileThreads * k + t < tile_n) out[dst[k]] = buf[from[k]];
    }
  }
}

// K3. Replaces glu_tpu/ops/_pallas_sort.py::_single_block_sort.
//
// One CTA sorts all of an input of at most kSingleMax elements: the keys and
// a u16 source index stay in shared memory through every 4-bit pass (a
// blocked rank with per-thread counter columns), and the payload streams are
// gathered once at the end by that index. So the device memory sees one read
// and one write per word, whatever the number of passes; what bounds the
// kernel is the single SM it runs on. Carrying the index instead of the
// payloads keeps the shared-memory need at 6 bytes per element for any
// payload count: 16384 elements take 134,144 bytes of the 232,448 a block
// may have.
__global__ void __launch_bounds__(kSingleThreads)
    sort_single_tile_kernel(Streams s, int n, BitPositions pos) {
  extern __shared__ int smem_single[];
  __shared__ const uint32_t* s_in[kMaxStreams];
  __shared__ uint32_t* s_out[kMaxStreams];
  __shared__ int s_bit[kMaxPositions];
  __shared__ int warp_sums[kSingleThreads / 32 + 1];
  __shared__ int bin_start[kSingleBins + 1];
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem_single);                   // padded(kSingleMax)
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

constexpr int onesweep_smem(int nstreams) {
  return nstreams * kTile * 4 + kTile * 2 + kTileWarps * kMaxBins * 4;
}
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

bool fill_digit(Digit* d, const int* bits, int nbits) {
  if (bits == nullptr || nbits < 1 || nbits > kMaxPassBits) return false;
  d->nbits = nbits;
  d->shift = bits[0];
  for (int j = 0; j < kMaxPassBits; ++j) {
    const int b = j < nbits ? bits[j] : 0;
    if (b < 0 || b > 31) return false;
    if (j < nbits && b != bits[0] + j) d->shift = -1;
    d->bit[j] = b;
  }
  return true;
}

int num_tiles(int n) { return static_cast<int>((static_cast<long long>(n) + kTile - 1) / kTile); }

}  // namespace

extern "C" {

int glu_sort_tile() { return kTile; }
int glu_sort_single_tile_max() { return kSingleMax; }
int glu_sort_max_streams() { return kMaxStreams; }
int glu_sort_bins() { return kMaxBins; }
const char* glu_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// bits: the passes' key bits one after another, nbits[p] of them for pass p.
int glu_digit_histograms(const void* keys, int n, const int* bits, const int* nbits, int npasses,
                         int* hist, void* stream) {
  PassDigits plan;
  if (keys == nullptr || n < 1 || hist == nullptr || nbits == nullptr || npasses < 1 ||
      npasses > kMaxPasses)
    return cudaErrorInvalidValue;
  plan.count = npasses;
  for (int p = 0, at = 0; p < kMaxPasses; ++p) {
    if (p < npasses) {
      if (!fill_digit(&plan.pass[p], bits + at, nbits[p])) return cudaErrorInvalidValue;
      at += nbits[p];
    } else {
      plan.pass[p] = plan.pass[0];
    }
  }
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long per_cta = static_cast<long long>(kHistThreads) * 4;
  const int ctas = static_cast<int>(
      std::max(1LL, std::min(static_cast<long long>(sms) * (2048 / kHistThreads), (n + per_cta - 1) / per_cta)));
  digit_histograms_kernel<<<ctas, kHistThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), n, plan, hist);
  return cudaGetLastError();
}

// status: num_tiles(n) * kMaxBins + 1 zeroed 64-bit words.
int glu_onesweep_pass(const void* const* in, void* const* out, int nstreams, int n,
                      const int* bits, int nbits, const int* digit_base, void* status,
                      void* stream) {
  Streams s;
  Digit digit;
  if (n < 1 || digit_base == nullptr || status == nullptr || !fill_streams(&s, in, out, nstreams) ||
      !fill_digit(&digit, bits, nbits))
    return cudaErrorInvalidValue;
  const int smem = onesweep_smem(nstreams);
  cudaError_t err = cudaFuncSetAttribute(onesweep_pass_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  onesweep_pass_kernel<<<num_tiles(n), kTileThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      s, n, digit, digit_base, static_cast<unsigned long long*>(status));
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
