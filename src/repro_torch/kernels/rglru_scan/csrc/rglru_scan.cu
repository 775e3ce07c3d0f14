// RG-LRU linear-recurrence scan for Hopper (sm_90a), fp32 in and out:
//   s_t = a_t ⊙ s_{t-1} + b_t,  s_{-1} = 0,  a, b, s: (B, S, W) contiguous.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan/kernel.py
// (rglru_scan_pallas, body _rglru_kernel). The TPU kernel tiles (time,
// width) into VMEM blocks and carries the state across a sequential time
// grid axis in VMEM scratch; GPU blocks run in no order, so nothing can be
// carried between them. Here the carry lives in a register instead:
//   * one thread owns one (b, w) lane and walks the whole time axis, so the
//     only serial dependency is the register `s` and no block ever waits on
//     another;
//   * neighbouring threads own neighbouring w, so every load and store of a
//     time step is coalesced across the warp (128-byte lines per warp);
//   * the time loop is unrolled by UNROLL: a chunk's loads of a_t and b_t do
//     not depend on s, so all 2·UNROLL of them are issued before the chunk's
//     dependent multiply-adds, hiding memory latency behind the chain;
//   * ragged S (a tail shorter than UNROLL) and ragged W (threads past W)
//     are handled in-kernel, so the wrapper makes no padding copies.
//
// What bounds it on an H100: 12 bytes move per element (a and b read, s
// written once) against two flops, so the bytes bound it: 3·B·S·W·4 B at
// 3.35 TB/s. At the served prefill (B=2, W=4096) there are only 8192 lanes,
// 128 blocks of 64 threads: about one block per SM and two warps per SM,
// so latency, not bandwidth, is the expected limit. A chunked parallel scan
// (prefix products over time chunks) would fill the card; it is not needed
// for a first, right kernel.
//
// Numerics: the multiply and the add round separately (__fmul_rn,
// __fadd_rn, no fused multiply-add), as the plain PyTorch loop does, so the
// kernel and the plain version agree exactly on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 64;  // lanes (w) per block
constexpr int UNROLL = 8;     // time steps whose loads are issued together

__global__ void __launch_bounds__(NTHREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ s,
                  int S, int W) {
  const int w = blockIdx.x * NTHREADS + threadIdx.x;
  if (w >= W) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * W + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* sp = s + base;
  float h = 0.f;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t off = static_cast<size_t>(t + u) * W;
      av[u] = __ldg(ap + off);
      bv[u] = __ldg(bp + off);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      sp[static_cast<size_t>(t + u) * W] = h;
    }
  }
  for (; t < S; ++t) {
    const size_t off = static_cast<size_t>(t) * W;
    h = __fadd_rn(__fmul_rn(__ldg(ap + off), h), __ldg(bp + off));
    sp[off] = h;
  }
}

}  // namespace

// Plain C entry for ctypes. a, b, s: (B, S, W) contiguous fp32. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int rglru_scan_fwd_f32(const void* a, const void* b, void* s, int B, int S, int W,
                                  void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid((W + NTHREADS - 1) / NTHREADS, B);
  rglru_scan_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(s), S, W);
  return cudaGetLastError();
}
