// Stand-in for <cuda_runtime.h> that lets g++ compile the port's kernels
// (tsxcount_tpu_torch/csrc) for the CPU and run them: every CUDA thread is a
// std::thread, blocks run one after another, __shared__ becomes a function
// static (shared by the threads of the running block), __syncthreads is a
// std::barrier over the block and __shfl_up_sync one over the warp.  Only
// what those kernels use is provided.  It checks the kernels' logic, not
// their speed, and it cannot tell __host__ from __device__ code: nvcc on the
// card stays the judge of what compiles.  Used by tools/cuda_emu/emulate.py.
#pragma once

#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return cudaSuccess;
}

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static

using std::max;
using std::min;

namespace emu {
struct Block {
  std::barrier<>* block_bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  std::vector<std::vector<int64_t>> warp_buf;
};
inline Block* current = nullptr;

// Runs body() once per (block, thread) of the grid; blocks in order.
inline void launch(dim3 g, dim3 b, std::function<void()> body) {
  gridDim = g;
  blockDim = b;
  const unsigned warps = (b.x + 31) / 32;
  for (unsigned bx = 0; bx < g.x; ++bx) {
    std::barrier<> bar(b.x);
    Block blk{&bar, {}, std::vector<std::vector<int64_t>>(
                            warps, std::vector<int64_t>(32))};
    for (unsigned w = 0; w < warps; ++w) {
      blk.warp_bars.emplace_back(new std::barrier<>(32));
    }
    current = &blk;
    std::vector<std::thread> threads;
    for (unsigned tx = 0; tx < b.x; ++tx) {
      threads.emplace_back([&, bx, tx] {
        blockIdx = dim3(bx);
        threadIdx = dim3(tx);
        body();
      });
    }
    for (auto& t : threads) t.join();
  }
}
}  // namespace emu

inline void __syncthreads() { emu::current->block_bar->arrive_and_wait(); }

template <class T>
T __shfl_up_sync(unsigned, T v, int d) {
  const unsigned lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  auto& buf = emu::current->warp_buf[w];
  int64_t raw = 0;
  memcpy(&raw, &v, sizeof(T));
  buf[lane] = raw;
  emu::current->warp_bars[w]->arrive_and_wait();
  T r = v;
  if (static_cast<int>(lane) >= d) memcpy(&r, &buf[lane - d], sizeof(T));
  emu::current->warp_bars[w]->arrive_and_wait();
  return r;
}
