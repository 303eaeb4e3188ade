// Device-side building blocks of single-pass kernels on Hopper (sm_90a):
// the status words of a decoupled look-back, and cp.async copies from device
// memory into shared memory.
//
// A status word is 64 bits: a flag in the high half and a count in the low
// half, so that one atomic store publishes both and a count can reach 2^32 - 1
// (the sort takes n < 2^31). The word is 0 until its tile publishes.
//
// Stores and loads of status words are relaxed atomics at device scope: a
// reader uses nothing but the one word it loaded, which holds the flag and
// the count together, so no other memory has to be ordered with it. Release
// stores and acquire loads would be correct too, and slower (PERF.md).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace glu {

constexpr unsigned long long kStatusAggregate = 1ull << 32;  // the tile's own count
constexpr unsigned long long kStatusInclusive = 2ull << 32;  // the count of this and every earlier tile
// A look-back that waits this many times on one status word reports a fault
// (a trap) instead of holding the card forever.
constexpr long long kLookbackSpinLimit = 1ll << 26;

__device__ __forceinline__ unsigned long long status_word(unsigned long long flag, uint32_t count) {
  return flag | count;
}

__device__ __forceinline__ void publish_status(unsigned long long* word, unsigned long long value) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(value) : "memory");
}

__device__ __forceinline__ unsigned long long read_status(const unsigned long long* word) {
  unsigned long long value;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(value) : "l"(word) : "memory");
  return value;
}

// Sum of the counts that tiles 0..tile-1 published in the column of status
// words that starts at `column` (stride `stride` words per tile): walks back
// from tile-1, adding aggregates, until it meets an inclusive count.
__device__ __forceinline__ uint32_t look_back(const unsigned long long* column, int stride, int tile) {
  uint32_t sum = 0;
  for (int p = tile - 1; p >= 0; --p) {
    const unsigned long long* word = column + static_cast<long long>(p) * stride;
    unsigned long long value = read_status(word);
    for (long long spins = 0; value == 0; value = read_status(word)) {
      if (++spins == kLookbackSpinLimit) __trap();
    }
    sum += static_cast<uint32_t>(value);
    if ((value & ~0xffffffffull) == kStatusInclusive) break;
  }
  return sum;
}

// cp.async: 16 bytes (both addresses 16-byte aligned) or 4 bytes from device
// memory into shared memory, in flight until cp_async_wait.
__device__ __forceinline__ void cp_async16(void* smem, const void* global) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(global) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* global) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(global) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Waits until at most PENDING of this thread's committed groups are in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

}  // namespace glu
