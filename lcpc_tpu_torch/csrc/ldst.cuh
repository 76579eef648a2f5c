// How a body shared between kernels reads global memory.  A standalone
// kernel reads its inputs through the read-only data cache (LoadNc) or as
// the compiler picks (LoadPlain); a persistent kernel whose earlier phase
// wrote the data (commit_small.cu) must read it coherently, at L2 (LoadCg):
// a non-coherent load may see a line its SM cached before the write.

#pragma once

#include <cuda_runtime.h>

namespace lcpc {

struct LoadNc {
  template <class T>
  static __device__ __forceinline__ T ld(const T* p) { return __ldg(p); }
};

struct LoadCg {
  template <class T>
  static __device__ __forceinline__ T ld(const T* p) { return __ldcg(p); }
};

struct LoadPlain {
  template <class T>
  static __device__ __forceinline__ T ld(const T* p) { return *p; }
};

}  // namespace lcpc
