// Hand-written Hopper (sm_90a) kernels of the stable LSD radix sort of u32
// keys carrying u32 payload streams (glu_tpu_torch/ops/_cuda_sort.py).
//
// A sort runs digit_histograms once, which counts the digit of every pass in
// one read of the keys (its last CTA turning the counts into each digit's
// start), then one onesweep_pass per digit of 1-8 key bits:
// each tile is ranked, finds its place through a decoupled look-back over
// the tiles before it, and writes every stream to its final place, so each
// word is read once and written once per pass (Adinets & Merrill,
// "Onesweep", 2022). An input of up to 65,536 elements takes
// sort_single_tile (K3), which runs every pass in one launch: one CTA, or a
// thread-block cluster whose CTAs share their shared memory.
//
// Bit positions (LSB-first) and stream pointers travel by value, so one
// compiled kernel serves every pass and every payload count. Words are
// uint32_t here; the Python side carries them as int32 bit patterns.
//
// Plain C interface for ctypes (no PyTorch headers, so nvcc takes seconds):
// every entry returns a cudaError_t, cudaGetLastError() after its launch.
// glu_onesweep_sort runs a whole multi-tile sort (the histogram and every
// pass) in one call, so that the host pays one call a sort, not one a pass.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

using namespace glu;
namespace cg = cooperative_groups;

constexpr int kMaxStreams = 8;       // keys + up to 7 payload streams
constexpr int kMaxPassBits = 8;      // a onesweep pass takes 1-8 key bits
constexpr int kMaxBins = 1 << kMaxPassBits;
constexpr int kMaxPasses = 4;        // 32 key bits in passes of 8

// 6144 elements per onesweep tile, 2 CTAs an SM. The shared memory, which
// holds every stream's tile, has room for 3 with up to one payload stream
// (about 75,960 bytes a CTA, of the SM's 233,472), 2 with two, 1 with three
// to seven (glu_onesweep_ctas_per_sm). 3 would need at most 56 registers a
// thread (65,536 / (3 x 384), in steps of 8), which the kernel fits with no
// spill when it ranks 4 rows and stores 4 ranks at a time; but on the H100 a
// two-stream pass then runs 10-12% slower: with 1.5 times the tiles in
// flight, the scattered stores and the look-back each cost 2.5-3 times as
// much (PERF.md). A thread stores kStoreItems ranks at a time, so that
// nothing spills. Larger tiles write longer runs of one digit, so fewer and
// fuller sectors; the variants that tools/onesweep_variants.py times are in
// PERF.md.
constexpr int kTileThreads = 384;
constexpr int kTileItems = 16;
constexpr int kTileCtasPerSm = 2;                 // __launch_bounds__ occupancy target
constexpr int kStoreItems = 8;                    // ranks a thread moves at once in step (d)
constexpr int kTile = kTileThreads * kTileItems;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kWarpItems = kTile / kTileWarps;    // each warp ranks a contiguous run of 512
static_assert(kTileThreads >= kMaxBins, "one thread per digit in the look-back");
static_assert(kTileItems % kStoreItems == 0, "a thread's ranks in whole chunks");

constexpr int kHistThreads = 1024;

// K3: CTAs of 1024 threads, each holding a slice of at most kSliceMax
// elements, 16 items a thread. A CTA of a cluster holds its slice's keys
// and their u16 source index twice each (12 bytes an element) and every
// warp's 256 running counts: 229,376 bytes, where the 232,448 bytes a block
// may take end. A cluster has up to kMaxCluster CTAs (the portable cluster
// size), so K3 takes up to kSingleMax elements: the JAX engine's
// single-block limit, _FUSE_MAX_R x LANES.
constexpr int kSingleThreads = 1024;
constexpr int kSliceMax = 16384;
constexpr int kMaxCluster = 8;
constexpr int kSingleMax = 65536;  // K3's limit
constexpr int kSingleWarps = kSingleThreads / 32;
constexpr int kSingleItems = kSliceMax / kSingleThreads;
constexpr int kRankRows = 2;  // rows of 32 items ranked at once
static_assert(kSingleThreads >= kMaxBins, "one thread per digit in the scan");
static_assert(kSliceMax % (kSingleThreads * kRankRows) == 0, "a slice in whole chunks of rows");
static_assert(kSingleMax <= kMaxCluster * kSliceMax, "K3's limit fits a cluster");
static_assert(kSingleMax <= 65536, "u16 source index");

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

// The counts half of K1 (glu_tpu/ops/_pallas_sort.py::_counts_row, one row
// per block there), for every pass of the sort at once.
//
// hist[p][d] (int32, zeroed by the caller) receives the number of keys whose
// digit of pass p is d. Bound by device-memory bytes: one read of the keys,
// 1.07 GB at 2^28. Two CTAs of 1024 threads per SM read 16 bytes a thread in
// a grid-stride loop; each CTA counts in shared memory with shared atomics
// and adds its counts to hist with one global atomic per non-zero bin.
// Integer adds are exact in any order, so the result is deterministic.
// Where bases is given, the last CTA to finish (counted in *ctas_done, zero
// at launch) writes bases[p][d], the exclusive sum of hist[p] up to d: where
// digit d starts in pass p's output (the cumsum that the TPU engine ran in
// XLA between its kernels).
__global__ void __launch_bounds__(kHistThreads)
    digit_histograms_kernel(const uint32_t* __restrict__ keys, int n, PassDigits plan,
                            int* hist, int* bases, unsigned int* ctas_done) {
  __shared__ int counts[kMaxPasses * kMaxBins];
  __shared__ int warp_sums[kHistThreads / 32 + 1];
  __shared__ bool last;
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
  if (bases == nullptr) return;
  __threadfence();  // this CTA's adds, before its count of finished CTAs
  __syncthreads();
  if (t == 0) last = atomicAdd(ctas_done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int p = 0; p < plan.count; ++p) {
    const int c = t < kMaxBins ? __ldcg(hist + p * kMaxBins + t) : 0;  // from L2, where the adds landed
    int total;
    const int start = block_exclusive_sum<kHistThreads>(c, warp_sums, &total);
    if (t < kMaxBins) bases[p * kMaxBins + t] = start;
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

// The stable ranker of both sort kernels: ROWS rows of 32 digits of one
// warp (d < 2^nbits, or kMaxBins for a lane past the ragged end), ranked row
// by row in order. runs[d] holds the warp's next rank of digit d. The rows
// are independent until the running ranks: every row's peer mask first, then
// the leaders' adds (the lowest lane of each group of peers advances runs[d]
// by their number), then the ranks. place(j, rank) is called for every lane
// of row j that has a digit; lanes of one row that share a digit rank in
// lane order, so the order is (row, lane): input order.
template <int ROWS, typename Place>
__device__ __forceinline__ void rank_rows(const uint32_t (&dig)[ROWS], int nbits, int* runs, Place place) {
  const int lane = threadIdx.x & 31;
  unsigned peers[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) peers[j] = match_digit(dig[j], nbits);
  int run[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    run[j] = 0;
    if (peers[j] && lane == __ffs(peers[j]) - 1) run[j] = atomicAdd(&runs[dig[j]], __popc(peers[j]));
    __syncwarp();  // orders the adds of successive rows, made by different leader lanes
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int leader = peers[j] ? __ffs(peers[j]) - 1 : lane;
    const int rank = __shfl_sync(0xffffffffu, run[j], leader) + __popc(peers[j] & ((1u << lane) - 1u));
    if (peers[j]) place(j, rank);
  }
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
//      that a warp's stores fall on few contiguous runs; a thread finds the
//      source and place of kStoreItems ranks, then moves them in every
//      stream;
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
  rank_rows(dig, digit.nbits, runs,
            [&](int j, int rank) { source[rank] = static_cast<uint16_t>(first + 32 * j + lane); });

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

  // (d) ranks t + kTileThreads (c + k), kStoreItems of them at a time: each
  // rank's source and place, found with its key, serve every stream
#pragma unroll
  for (int c = 0; c < kTileItems; c += kStoreItems) {
    int from[kStoreItems];
    int dst[kStoreItems];
#pragma unroll
    for (int k = 0; k < kStoreItems; ++k) {
      const int r = kTileThreads * (c + k) + t;
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
      for (int k = 0; k < kStoreItems; ++k) {
        if (kTileThreads * (c + k) + t < tile_n) out[dst[k]] = buf[from[k]];
      }
    }
  }
}

// Copies n words from device memory to buf in shared memory, in order: 16
// bytes a load where `in` is 16-byte aligned, then single words.
__device__ __forceinline__ void load_words(const uint32_t* in, uint32_t* buf, int n) {
  const bool vec = (reinterpret_cast<uintptr_t>(in) & 15) == 0;
  for (int c = threadIdx.x; 4 * c < n; c += blockDim.x) {
    const int i = 4 * c;
    if (vec && i + 4 <= n) {
      *reinterpret_cast<uint4*>(buf + i) = *reinterpret_cast<const uint4*>(in + i);
    } else {
      for (int e = i; e < min(i + 4, n); ++e) buf[e] = in[e];
    }
  }
}

// K3. Replaces glu_tpu/ops/_pallas_sort.py::_single_block_sort.
//
// One launch sorts all of an input of at most kSingleMax elements, one
// stable pass per Digit of plan (1-4 passes of 1-8 key bits: a 32-bit sort
// is 4 passes). The keys and a u16 source index stay in shared memory
// through every pass, and the payload streams are gathered by that index
// once at the end, so device memory sees one read and one write of each word
// and the shared memory need does not depend on the payload count.
//
// What bounds it on this card is not device bytes (65,536 pairs move 1 MB,
// 0.3 microseconds at 3.35 TB/s) but latency: each pass's chain of steps,
// most of it in the ranking of step (c), where each row of 32 waits on the
// leaders' adds of the row before it (after nine ballots). So the design
// shortens the chain: passes of 8 bits (4 for 32 bits, not 8 of 4 bits),
// the onesweep kernel's ballot ranker (rank_rows: no per-thread counter
// table to scan), and 32 warps a CTA, each ranking only its own rows, so
// that a warp's chain is about slice / 1024 rows; a small sort takes few
// warps. A small input runs on one CTA; a larger one on a cluster of CTAs
// (CLUSTER; faster on the H100 from about 6,000 elements, and the only way
// past one SM's shared memory), CTA r holding the contiguous slice
// [r * slice, r * slice + slice) of the input and of the output, which
// shortens each CTA's chain as well. The cluster's CTAs exchange their
// elements through distributed shared memory, where a store costs far more
// than in a CTA's own, and most when a warp's 32 stores fall apart: so each
// CTA ranks into its own shared memory as one CTA does, then copies its
// elements out in rank order, where a warp's stores fall on few runs of
// consecutive places in one other CTA. A gather of 4-byte words from device
// memory costs one SM a sector a word, so each payload stream is copied
// whole into the keys' buffers once the keys are written out, gathered
// there and written in order. Each pass:
//  (a) every warp takes the contiguous run of items first + 32 j + lane of
//      its CTA's slice, holds its keys in registers and counts their digits
//      into its own row of warp_runs with shared atomics;
//  (b) a scan over (digit, warp), digit-major, gives each warp its first
//      rank of each digit in its CTA; in a cluster each CTA also publishes
//      its count of each digit in cta_counts;
//  (c) the warp ranks its rows in order, kRankRows at a time, and writes
//      each key (from its registers) and its source index (from the index
//      buffer it read) to its rank, in the CTA's own staged buffers. The
//      order is (digit, warp, row, lane), input order within a digit, so
//      the pass is stable. One CTA alone rewrites its keys in place (every
//      key was read in (a)) and alternates its two index buffers: that is
//      the pass. In a cluster:
//  (d) after a cluster barrier (every CTA's counts published and its
//      elements staged, so every CTA's buffers 0 are free), each CTA reads
//      every CTA's counts: a digit's count over the cluster, and in the
//      CTAs before it; a scan over the digits gives each digit's start in
//      the cluster's order (digit, CTA, warp, row, lane), still stable, and
//      so the shift from a digit's rank in the CTA to its rank in the
//      cluster;
//  (e) each CTA copies its staged keys and indices, in rank order, to their
//      ranks: into buffers 0 of the CTA whose slice holds each, and a
//      cluster barrier ends the pass.
// The index is the element's position in the whole input (a u16: at most
// 65,536 elements). A cluster's last barrier comes after its last read of
// another CTA's shared memory, so that no CTA exits while it is read.
template <bool CLUSTER>
__global__ void __launch_bounds__(kSingleThreads)
    sort_single_tile_kernel(Streams s, int n, int slice, PassDigits plan) {
  constexpr int kKeyBuffers = CLUSTER ? 2 : 1;
  extern __shared__ __align__(16) uint32_t smem_single[];
  uint32_t* keys = smem_single;                                                   // [kKeyBuffers][kSliceMax]
  uint16_t* index = reinterpret_cast<uint16_t*>(keys + kKeyBuffers * kSliceMax);  // [2][kSliceMax]
  int* warp_runs = reinterpret_cast<int*>(index + 2 * kSliceMax);                 // [kSingleWarps][kMaxBins]
  __shared__ const uint32_t* s_in[kMaxStreams];
  __shared__ uint32_t* s_out[kMaxStreams];
  __shared__ Digit s_digit[kMaxPasses];
  __shared__ int warp_sums[kSingleWarps + 1];
  // a cluster's: this CTA's count of each digit in the pass, the shift from
  // a digit's rank in the CTA to its rank in the cluster, and every CTA's
  // buffers 0 and counts as this CTA addresses them
  __shared__ int cta_counts[kMaxBins];
  __shared__ int shift[kMaxBins];
  __shared__ uint32_t* s_keys[kMaxCluster];
  __shared__ uint16_t* s_index[kMaxCluster];
  __shared__ const int* s_counts[kMaxCluster];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int cta = 0, ctas = 1;
  if constexpr (CLUSTER) {
    cta = static_cast<int>(cg::this_cluster().block_rank());
    ctas = static_cast<int>(cg::this_cluster().num_blocks());
  }
  auto cluster_sync = [] {
    if constexpr (CLUSTER) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  };
  const int lo = cta * slice;                  // this CTA's slice of the input and the output
  const int mine = max(0, min(slice, n - lo));  // its elements: the last CTA's may be fewer, or none
  if (t == 0) {  // the launch arguments indexed at run time, with static indices
#pragma unroll
    for (int j = 0; j < kMaxStreams; ++j) {
      s_in[j] = s.in[j];
      s_out[j] = s.out[j];
    }
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) s_digit[p] = plan.pass[p];
    if constexpr (CLUSTER) {
      for (int c = 0; c < ctas; ++c) {
        s_keys[c] = cg::this_cluster().map_shared_rank(keys, c);
        s_index[c] = cg::this_cluster().map_shared_rank(index, c);
        s_counts[c] = cg::this_cluster().map_shared_rank(cta_counts, c);
      }
    }
  }
  for (int i = t; i < kSingleWarps * kMaxBins; i += kSingleThreads) warp_runs[i] = 0;
  load_words(s.in[0] + lo, keys, mine);
  for (int i = t; i < mine; i += kSingleThreads) index[i] = static_cast<uint16_t>(lo + i);
  __syncthreads();

  // rows of 32 items per warp, in whole chunks of kRankRows, so that no warp
  // ranks an empty row and a small sort takes few warps
  const int rows = (slice + kSingleThreads * kRankRows - 1) / (kSingleThreads * kRankRows) * kRankRows;
  const int first = warp * rows * 32;
  int* runs = warp_runs + warp * kMaxBins;
  uint32_t* staged = keys + (CLUSTER ? kSliceMax : 0);  // the keys in rank order in the CTA (one CTA: in place)
  for (int p = 0; p < plan.count; ++p) {
    const Digit digit = s_digit[p];
    const uint16_t* src = index + (CLUSTER ? 0 : (p & 1) * kSliceMax);
    uint16_t* dst = index + (CLUSTER ? kSliceMax : ((p + 1) & 1) * kSliceMax);
    // (a)
    uint32_t key[kSingleItems];
#pragma unroll
    for (int j = 0; j < kSingleItems; ++j) {
      const int i = first + 32 * j + lane;
      key[j] = 0;
      if (j < rows && i < mine) {
        key[j] = keys[i];
        atomicAdd(&runs[digit.of(key[j])], 1);
      }
    }
    __syncthreads();
    // (b) thread t < bins sums digit t over the warps, then places each warp
    const bool owns_digit = t < (1 << digit.nbits);
    int count = 0;
    if (owns_digit) {
#pragma unroll 8
      for (int w = 0; w < kSingleWarps; ++w) count += warp_runs[w * kMaxBins + t];
      if constexpr (CLUSTER) cta_counts[t] = count;
    }
    int total;
    const int start = block_exclusive_sum<kSingleThreads>(count, warp_sums, &total);
    if (owns_digit) {
      int run = start;
#pragma unroll 8
      for (int w = 0; w < kSingleWarps; ++w) {
        const int c = warp_runs[w * kMaxBins + t];
        warp_runs[w * kMaxBins + t] = run;
        run += c;
      }
    }
    __syncthreads();
    // (c)
#pragma unroll
    for (int c = 0; c < kSingleItems; c += kRankRows) {
      if (c < rows) {
        uint32_t dig[kRankRows];
#pragma unroll
        for (int j = 0; j < kRankRows; ++j) {
          const int i = first + 32 * (c + j) + lane;
          dig[j] = c + j < rows && i < mine ? digit.of(key[c + j]) : kMaxBins;
        }
        rank_rows(dig, digit.nbits, runs, [&](int j, int rank) {
          staged[rank] = key[c + j];
          dst[rank] = src[first + 32 * (c + j) + lane];
        });
      }
    }
    for (int d = lane; d < kMaxBins; d += 32) runs[d] = 0;  // after rank_rows' last __syncwarp
    if constexpr (CLUSTER) {
      cg::this_cluster().sync();
      // (d) the counts of every CTA, their loads all in flight at once
      int counts[kMaxCluster];
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) counts[c] = owns_digit && c < ctas ? s_counts[c][t] : 0;
      int all = 0, before = 0;
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) {
        all += counts[c];
        before += c < cta ? counts[c] : 0;
      }
      const int cluster_start = block_exclusive_sum<kSingleThreads>(all, warp_sums, &total);
      if (owns_digit) shift[t] = cluster_start + before - start;
      __syncthreads();
      // (e)
      for (int q = t; q < mine; q += kSingleThreads) {
        const uint32_t k = staged[q];
        const int rank = q + shift[digit.of(k)];
        const int owner = rank / slice;
        const int at = rank - owner * slice;
        s_keys[owner][at] = k;
        s_index[owner][at] = dst[q];
      }
    }
    cluster_sync();
  }

  // the output slice's keys and source indices: buffers 0 in a cluster
  const uint16_t* order = index + (CLUSTER ? 0 : (plan.count & 1) * kSliceMax);
  for (int i = t; i < mine; i += kSingleThreads) s_out[0][lo + i] = keys[i];
  for (int st = 1; st < s.count; ++st) {  // each payload through the keys' buffers 0
    cluster_sync();  // every read of the buffers (this CTA's, and the gathers of the stream before) done
    load_words(s_in[st] + lo, keys, mine);
    cluster_sync();
    uint32_t* out = s_out[st] + lo;
    for (int i = t; i < mine; i += kSingleThreads) {
      const int from = order[i];
      if constexpr (CLUSTER) {
        const int owner = from / slice;
        out[i] = s_keys[owner][from - owner * slice];
      } else {
        out[i] = keys[from];
      }
    }
  }
  if constexpr (CLUSTER) {
    if (s.count > 1) cg::this_cluster().sync();  // the gathers' reads of the other CTAs
  }
}

constexpr int onesweep_smem(int nstreams) {
  return nstreams * kTile * 4 + kTile * 2 + kTileWarps * kMaxBins * 4;
}
constexpr int kSingleTileSmem = 2 * kSliceMax * 4 + 2 * kSliceMax * 2 + kSingleWarps * kMaxBins * 4;  // both forms

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

// bits: the passes' key bits one after another, nbits[p] of them for pass p.
bool fill_plan(PassDigits* plan, const int* bits, const int* nbits, int npasses) {
  if (nbits == nullptr || npasses < 1 || npasses > kMaxPasses) return false;
  plan->count = npasses;
  for (int p = 0, at = 0; p < kMaxPasses; ++p) {
    if (p < npasses) {
      if (!fill_digit(&plan->pass[p], bits + at, nbits[p])) return false;
      at += nbits[p];
    } else {
      plan->pass[p] = plan->pass[0];
    }
  }
  return true;
}

// Lets `kernel` take `bytes` of dynamic shared memory, and with max_carveout
// asks for the largest shared-memory carveout of L1, so that CUDA never
// picks one that holds fewer CTAs than the shared memory allows: once per
// device and process (a bit of `done` per device), not on every launch.
cudaError_t allow_smem(const void* kernel, int bytes, std::atomic<unsigned long long>* done,
                       bool max_carveout = false) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (done->load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && max_carveout)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done->fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <bool CLUSTER>
cudaError_t allow_single_tile_smem() {
  static std::atomic<unsigned long long> done{0};
  return allow_smem(reinterpret_cast<const void*>(sort_single_tile_kernel<CLUSTER>), kSingleTileSmem, &done);
}

// K3's launch on a cluster of ctas CTAs (2..kMaxCluster) in one row: the
// configuration of the launch and of cudaOccupancyMaxActiveClusters.
struct ClusterLaunch {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attribute[1];

  ClusterLaunch(int ctas, cudaStream_t stream) {
    config.gridDim = dim3(ctas);
    config.blockDim = dim3(kSingleThreads);
    config.dynamicSmemBytes = kSingleTileSmem;
    config.stream = stream;
    attribute[0].id = cudaLaunchAttributeClusterDimension;
    attribute[0].val.clusterDim.x = ctas;
    attribute[0].val.clusterDim.y = 1;
    attribute[0].val.clusterDim.z = 1;
    config.attrs = attribute;
    config.numAttrs = 1;
  }
};

// The slice of each CTA of K3 on ctas CTAs: n split evenly, rounded up to
// whole 16-byte vectors (the last CTA takes what is left); n itself on one.
int single_tile_slice(int n, int ctas) { return ctas == 1 ? n : ((n + ctas - 1) / ctas + 3) / 4 * 4; }

// The most any onesweep launch takes (kMaxStreams streams), from the largest
// carveout; a launch with fewer streams asks for less.
cudaError_t allow_onesweep_smem() {
  static std::atomic<unsigned long long> done{0};
  return allow_smem(reinterpret_cast<const void*>(onesweep_pass_kernel), onesweep_smem(kMaxStreams), &done, true);
}

int num_tiles(int n) { return static_cast<int>((static_cast<long long>(n) + kTile - 1) / kTile); }

// One digit_histograms launch: a grid of up to two CTAs per SM, each
// taking whole 16-byte vectors of 4 keys a thread.
cudaError_t launch_histograms(const void* keys, int n, const PassDigits& plan, int* hist, int* bases,
                              unsigned int* ctas_done, cudaStream_t stream) {
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long per_cta = static_cast<long long>(kHistThreads) * 4;
  const int ctas = static_cast<int>(
      std::max(1LL, std::min(static_cast<long long>(sms) * (2048 / kHistThreads), (n + per_cta - 1) / per_cta)));
  digit_histograms_kernel<<<ctas, kHistThreads, 0, stream>>>(
      static_cast<const uint32_t*>(keys), n, plan, hist, bases, ctas_done);
  return cudaGetLastError();
}

// glu_onesweep_sort's work buffer, in int32 words: hist and bases
// ([kMaxPasses][kMaxBins] each), the histogram's count of finished CTAs,
// then, from a 256-byte boundary, the status words of the passes: a region
// for every pass (num_tiles(n) * kMaxBins + 1 64-bit words, each region
// from a 256-byte boundary, as a fresh allocation's are: a warp's look-back
// reads 32 adjacent words), all zeroed at once, where they take at most
// kSeparateStatusBytes, else one region zeroed before each pass. One
// zeroing instead of one a pass spares the host a call a pass where the
// sort is small and the host's calls are most of its time; a region a pass
// would hold 358 MB at 2^28 pairs.
constexpr long long kWorkHead = (2LL * kMaxPasses * kMaxBins + 1 + 63) / 64 * 64;
constexpr long long kSeparateStatusBytes = 64LL << 20;

// 64-bit words from one status region to the next
long long status_words(int n) { return (static_cast<long long>(num_tiles(n)) * kMaxBins + 1 + 31) / 32 * 32; }

int status_regions(int n, int npasses) {
  return npasses * status_words(n) * 8 <= kSeparateStatusBytes ? npasses : 1;
}

}  // namespace

extern "C" {

int glu_sort_tile() { return kTile; }
int glu_sort_single_tile_max() { return kSingleMax; }
int glu_sort_slice_max() { return kSliceMax; }
int glu_sort_max_cluster() { return kMaxCluster; }
int glu_sort_max_streams() { return kMaxStreams; }
int glu_sort_bins() { return kMaxBins; }
const char* glu_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// bits, nbits, npasses: the passes, as fill_plan takes them.
int glu_digit_histograms(const void* keys, int n, const int* bits, const int* nbits, int npasses,
                         int* hist, void* stream) {
  PassDigits plan;
  if (keys == nullptr || n < 1 || hist == nullptr || !fill_plan(&plan, bits, nbits, npasses))
    return cudaErrorInvalidValue;
  return launch_histograms(keys, n, plan, hist, nullptr, nullptr, static_cast<cudaStream_t>(stream));
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
  const cudaError_t err = allow_onesweep_smem();
  if (err != cudaSuccess) return err;
  onesweep_pass_kernel<<<num_tiles(n), kTileThreads, onesweep_smem(nstreams), static_cast<cudaStream_t>(stream)>>>(
      s, n, digit, digit_base, static_cast<unsigned long long*>(status));
  return cudaGetLastError();
}

// How many CTAs of a onesweep pass over nstreams streams an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after the attributes that
// every launch sets), or minus the CUDA error that stopped the query.
int glu_onesweep_ctas_per_sm(int nstreams) {
  if (nstreams < 1 || nstreams > kMaxStreams) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_onesweep_smem();
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, onesweep_pass_kernel, kTileThreads,
                                                        onesweep_smem(nstreams));
  cudaGetLastError();
  return err != cudaSuccess ? -static_cast<int>(err) : ctas;
}

// The int32 words of the work buffer that glu_onesweep_sort takes for n
// elements in npasses passes (under 2^28 for any n below 2^31); the buffer
// starts at a 256-byte boundary.
int glu_onesweep_sort_work_words(int n, int npasses) {
  if (n < 1 || npasses < 1 || npasses > kMaxPasses) return -1;
  return static_cast<int>(kWorkHead + 2 * status_regions(n, npasses) * status_words(n));
}

// A whole multi-tile sort in one call: digit_histograms, whose last CTA
// writes every pass's digit starts, then one onesweep_pass per pass of plan
// (bits, nbits, npasses as fill_plan takes them). Pass p reads `in` (p = 0)
// or the pass before's output, and writes `out` when npasses - 1 - p is
// even, else `tmp`, so that the last pass writes `out`; tmp (nstreams
// buffers of n words) is read only when npasses > 1. work:
// glu_onesweep_sort_work_words(n, npasses) int32 words from a 256-byte
// boundary. The inputs are not written.
int glu_onesweep_sort(const void* const* in, void* const* out, void* const* tmp, int nstreams, int n,
                      const int* bits, const int* nbits, int npasses, void* work, void* stream) {
  PassDigits plan;
  Streams check;
  if (n < 1 || work == nullptr || !fill_plan(&plan, bits, nbits, npasses) ||
      !fill_streams(&check, in, out, nstreams) || (npasses > 1 && !fill_streams(&check, in, tmp, nstreams)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* hist = static_cast<int*>(work);
  int* bases = hist + kMaxPasses * kMaxBins;
  unsigned int* ctas_done = reinterpret_cast<unsigned int*>(bases + kMaxPasses * kMaxBins);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(hist + kWorkHead);
  const int regions = status_regions(n, npasses);
  const size_t region_bytes = static_cast<size_t>(status_words(n)) * sizeof(unsigned long long);
  // the head, and every region where there is one a pass
  cudaError_t err = cudaMemsetAsync(work, 0, kWorkHead * sizeof(int) + (regions > 1 ? regions * region_bytes : 0), st);
  if (err == cudaSuccess) err = launch_histograms(in[0], n, plan, hist, bases, ctas_done, st);
  if (err == cudaSuccess) err = allow_onesweep_smem();
  const void* const* src = in;
  for (int p = 0; p < npasses && err == cudaSuccess; ++p) {
    void* const* dst = (npasses - 1 - p) % 2 == 0 ? out : tmp;
    unsigned long long* pass_status = status + (regions > 1 ? p * status_words(n) : 0);
    if (regions == 1) {
      err = cudaMemsetAsync(pass_status, 0, region_bytes, st);
      if (err != cudaSuccess) break;
    }
    Streams pass;
    fill_streams(&pass, src, dst, nstreams);
    onesweep_pass_kernel<<<num_tiles(n), kTileThreads, onesweep_smem(nstreams), st>>>(
        pass, n, plan.pass[p], bases + p * kMaxBins, pass_status);
    err = cudaGetLastError();
    src = const_cast<const void* const*>(dst);
  }
  return err;
}

// K3 on ctas CTAs (1..kMaxCluster; each CTA's slice, single_tile_slice(n,
// ctas), at most kSliceMax): one CTA, or a cluster of ctas CTAs. bits,
// nbits, npasses: the passes, as fill_plan takes them.
int glu_sort_single_tile(const void* const* in, void* const* out, int nstreams, int n,
                         const int* bits, const int* nbits, int npasses, int ctas, void* stream) {
  Streams s;
  PassDigits plan;
  if (n < 1 || n > kSingleMax || ctas < 1 || ctas > kMaxCluster || single_tile_slice(n, ctas) > kSliceMax ||
      !fill_streams(&s, in, out, nstreams) || !fill_plan(&plan, bits, nbits, npasses))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ctas == 1) {
    const cudaError_t err = allow_single_tile_smem<false>();
    if (err != cudaSuccess) return err;
    sort_single_tile_kernel<false><<<1, kSingleThreads, kSingleTileSmem, st>>>(s, n, n, plan);
    return cudaGetLastError();
  }
  cudaError_t err = allow_single_tile_smem<true>();
  if (err != cudaSuccess) return err;
  ClusterLaunch launch(ctas, st);
  err = cudaLaunchKernelEx(&launch.config, sort_single_tile_kernel<true>, s, n, single_tile_slice(n, ctas), plan);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// K3 on one (key, value) pair of streams: glu_sort_single_tile with the
// four pointers given one by one, so that a caller passes plain integers
// and builds no arrays of pointers.
int glu_sort_pairs_single_tile(const void* keys_in, const void* values_in, void* keys_out, void* values_out, int n,
                               const int* bits, const int* nbits, int npasses, int ctas, void* stream) {
  const void* const in[2] = {keys_in, values_in};
  void* const out[2] = {keys_out, values_out};
  return glu_sort_single_tile(in, out, 2, n, bits, nbits, npasses, ctas, stream);
}

// How many clusters of ctas CTAs of K3 the device can hold at once
// (cudaOccupancyMaxActiveClusters; 0: such a launch is refused), or minus
// the CUDA error that stopped the query.
int glu_sort_single_tile_clusters(int ctas) {
  if (ctas < 2 || ctas > kMaxCluster) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_single_tile_smem<true>();
  int clusters = 0;
  if (err == cudaSuccess) {
    ClusterLaunch launch(ctas, nullptr);
    err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(sort_single_tile_kernel<true>),
                                         &launch.config);
  }
  cudaGetLastError();
  return err != cudaSuccess ? -static_cast<int>(err) : clusters;
}

}  // extern "C"
