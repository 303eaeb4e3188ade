// KB, the bucket stage of the distributed sort: a hand-written Hopper
// (sm_90a) pass that gives each element of a rank's shard its destination
// rank (glu_tpu_torch/parallel/_cuda_bucket.py).
//
// Replaces glu_tpu/parallel/dist_sort.py::_bucket_of and _bucket_of64, which
// are not pallas_calls: they unroll the D - 1 splitter comparisons so that
// XLA fuses them into one elementwise pass over the shard. out[i] is the
// count of splitters j with (s_hi[j], s_lo[j], s_idx[j]) <= (hi[i], lo[i],
// base + i) in lexicographic order, the words compared unsigned and the
// global index as a 64-bit integer (the u32 form has no lo word). The
// splitters are quantiles of one sorted sample, so they come in
// non-decreasing lexicographic order, and the count is the length of the
// prefix of splitters <= the element: a binary search of ceil(log2 D) fixed
// steps (binary lifting), the same in every lane of a warp.
//
// Bound by device-memory bytes: each key word read once and each bucket id
// written once, 8 bytes an element for u32 keys (0.160 ms for 2^26 at 3.35
// TB/s) and 12 for 64-bit keys. So the kernel streams: a grid of 8 CTAs of
// 256 threads an SM strides over the shard, each thread with kUnroll
// 16-byte loads of 4 keys in flight, and writes 4 ids with one 16-byte store
// where the output shares the keys' alignment. A shard may be a slice of a
// larger tensor, aligned to 4 bytes only: the elements before the keys' first
// 16-byte boundary and the ragged tail are taken one by one. Up to
// kSmemSplitters splitters are staged in shared memory once a CTA; more are
// searched where they lie, through L1. No atomics, no scratch.
//
// Plain C interface for ctypes; every entry returns a cudaError_t.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBucketThreads = 256;
constexpr int kCtasPerSm = 2048 / kBucketThreads;
constexpr int kSmemSplitters = 2048;  // at most 32 KB of splitters (64-bit form): no opt-in needed
constexpr int kUnroll = 2;

// D - 1 splitters in non-decreasing lexicographic order; lo is unused in the
// u32 form (WORDS == 1).
struct Splitters {
  const uint32_t* hi;
  const uint32_t* lo;
  const long long* idx;
  int m;
};

// splitter j <= (hi, lo, gidx)
template <int WORDS>
__device__ __forceinline__ bool splitter_le(const Splitters& s, int j, uint32_t hi, uint32_t lo, long long gidx) {
  const uint32_t sh = s.hi[j];
  if (sh != hi) return sh < hi;
  if constexpr (WORDS == 2) {
    const uint32_t sl = s.lo[j];
    if (sl != lo) return sl < lo;
  }
  return s.idx[j] <= gidx;
}

// The number of splitters <= (hi, lo, gidx): the longest prefix of the
// sorted splitters that is <= it, found in steps of top, top / 2, ..., 1
// (top: the largest power of two <= m).
template <int WORDS>
__device__ __forceinline__ int count_le(const Splitters& s, int top, uint32_t hi, uint32_t lo, long long gidx) {
  int pos = 0;
  for (int step = top; step > 0; step >>= 1) {
    const int next = pos + step;
    if (next <= s.m && splitter_le<WORDS>(s, next - 1, hi, lo, gidx)) pos = next;
  }
  return pos;
}

// Elements [head, head + 4 * groups) as groups of 4 (their keys on 16-byte
// boundaries), the rest one by one. vec_out: out + head is on a 16-byte
// boundary too.
template <int WORDS>
__global__ void __launch_bounds__(kBucketThreads)
    bucket_kernel(const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo, long long n, long long base,
                  Splitters s, long long head, long long groups, bool vec_out, int* __restrict__ out) {
  extern __shared__ long long staged[];  // idx[m], hi[m], lo[m] when m <= kSmemSplitters
  if (s.m <= kSmemSplitters) {
    long long* idx = staged;
    uint32_t* shi = reinterpret_cast<uint32_t*>(idx + s.m);
    uint32_t* slo = shi + s.m;
    for (int j = threadIdx.x; j < s.m; j += kBucketThreads) {
      idx[j] = s.idx[j];
      shi[j] = s.hi[j];
      if constexpr (WORDS == 2) slo[j] = s.lo[j];
    }
    __syncthreads();
    s.idx = idx;
    s.hi = shi;
    s.lo = slo;
  }
  const int top = s.m > 0 ? 1 << (31 - __clz(s.m)) : 0;
  const long long stride = static_cast<long long>(gridDim.x) * kBucketThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kBucketThreads + threadIdx.x;

  const uint4* vhi = reinterpret_cast<const uint4*>(hi + head);
  const uint4* vlo = reinterpret_cast<const uint4*>(lo + head);
  for (long long g0 = t; g0 < groups; g0 += kUnroll * stride) {
    uint4 kh[kUnroll], kl[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load issued before any search
      const long long g = g0 + u * stride;
      if (g < groups) {
        kh[u] = __ldcs(vhi + g);
        if constexpr (WORDS == 2) kl[u] = __ldcs(vlo + g);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long g = g0 + u * stride;
      if (g >= groups) break;
      const long long i = head + 4 * g;
      const long long gi = base + i;
      uint4 l = make_uint4(0, 0, 0, 0);
      if constexpr (WORDS == 2) l = kl[u];
      int4 r;
      r.x = count_le<WORDS>(s, top, kh[u].x, l.x, gi);
      r.y = count_le<WORDS>(s, top, kh[u].y, l.y, gi + 1);
      r.z = count_le<WORDS>(s, top, kh[u].z, l.z, gi + 2);
      r.w = count_le<WORDS>(s, top, kh[u].w, l.w, gi + 3);
      if (vec_out) {
        __stcs(reinterpret_cast<int4*>(out + i), r);
      } else {
        out[i] = r.x;
        out[i + 1] = r.y;
        out[i + 2] = r.z;
        out[i + 3] = r.w;
      }
    }
  }
  const long long tail = head + 4 * groups;  // the scalar head [0, head) and tail [tail, n)
  for (long long k = t; k < head + (n - tail); k += stride) {
    const long long i = k < head ? k : tail + (k - head);
    out[i] = count_le<WORDS>(s, top, hi[i], WORDS == 2 ? lo[i] : 0u, base + i);
  }
}

template <int WORDS>
cudaError_t launch_bucket(const uint32_t* hi, const uint32_t* lo, long long n, long long base, Splitters s,
                          int* out, cudaStream_t stream) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(hi);
  long long head = static_cast<long long>((16 - at % 16) % 16 / 4);
  if (WORDS == 2 && (reinterpret_cast<uintptr_t>(lo) - at) % 16 != 0) head = n;  // no common 16-byte boundary
  head = std::min(head, n);
  const long long groups = (n - head) / 4;
  const bool vec_out = reinterpret_cast<uintptr_t>(out + head) % 16 == 0;
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long work = std::max((groups + kUnroll - 1) / kUnroll, n - 4 * groups);  // a thread's items
  const int ctas = static_cast<int>(std::max(
      1LL, std::min(static_cast<long long>(sms) * kCtasPerSm, (work + kBucketThreads - 1) / kBucketThreads)));
  const size_t smem = s.m <= kSmemSplitters ? static_cast<size_t>(s.m) * (8 + 4 * WORDS) : 0;
  bucket_kernel<WORDS><<<ctas, kBucketThreads, smem, stream>>>(hi, lo, n, base, s, head, groups, vec_out, out);
  return cudaGetLastError();
}

bool valid(const void* keys, long long n, long long base, const void* s_idx, int m, const void* out) {
  return n >= 1 && base >= 0 && base <= 0x7fffffffffffffffLL - n && m >= 0 && keys != nullptr && out != nullptr &&
         (m == 0 || s_idx != nullptr) && reinterpret_cast<uintptr_t>(keys) % 4 == 0;
}

}  // namespace

extern "C" {

int glu_bucket_smem_splitters() { return kSmemSplitters; }

// out[i] = the number of the m splitters (s_keys[j], s_idx[j]) <= (keys[i],
// base + i), for the n u32 keys; the splitters in non-decreasing
// lexicographic order. out: n int32.
int glu_bucket_of(const void* keys, long long n, long long base, const void* s_keys, const void* s_idx, int m,
                  void* out, void* stream) {
  if (!valid(keys, n, base, s_idx, m, out) || (m > 0 && s_keys == nullptr)) return cudaErrorInvalidValue;
  const Splitters s{static_cast<const uint32_t*>(s_keys), nullptr, static_cast<const long long*>(s_idx), m};
  return launch_bucket<1>(static_cast<const uint32_t*>(keys), nullptr, n, base, s, static_cast<int*>(out),
                          static_cast<cudaStream_t>(stream));
}

// The same for 64-bit keys given as (hi, lo) u32 words and splitters
// (s_hi[j], s_lo[j], s_idx[j]).
int glu_bucket_of64(const void* hi, const void* lo, long long n, long long base, const void* s_hi, const void* s_lo,
                    const void* s_idx, int m, void* out, void* stream) {
  if (!valid(hi, n, base, s_idx, m, out) || lo == nullptr || reinterpret_cast<uintptr_t>(lo) % 4 != 0 ||
      (m > 0 && (s_hi == nullptr || s_lo == nullptr)))
    return cudaErrorInvalidValue;
  const Splitters s{static_cast<const uint32_t*>(s_hi), static_cast<const uint32_t*>(s_lo),
                    static_cast<const long long*>(s_idx), m};
  return launch_bucket<2>(static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo), n, base, s,
                          static_cast<int*>(out), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
