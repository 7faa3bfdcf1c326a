// Asynchronous 4- and 16-byte copies from global to shared memory
// (cp.async, sm_80 and later), shared by K2 (fire_compact.cu) and the
// tile walk of K1 and K3 (tile_insert.cuh): no register holds the words,
// and every copy a thread issues is in flight at once until it waits.

#pragma once

#include <cstdint>

namespace tw {

__device__ __forceinline__ void copy_async(int32_t* to,
                                           const int32_t* from) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(to));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(from)
               : "memory");
}

// The same for 16 bytes, both addresses 16-byte aligned; it bypasses L1
// (cp.async.cg).
__device__ __forceinline__ void copy_async16(int32_t* to,
                                             const int32_t* from) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(to));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(from)
               : "memory");
}

// Wait for this thread's asynchronous copies.
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace tw
