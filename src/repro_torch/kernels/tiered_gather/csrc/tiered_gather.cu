// Residency-masked row gather and gather-matmul for Hopper (sm_90a): the
// on-demand data plane of the two-tier tables.
//
// Replaces the Pallas TPU kernels repro/kernels/tiered_gather/kernel.py
// tiered_gather_pallas (_tiered_gather_kernel) and
// tiered_gather_matmul_pallas (_tiered_gather_matmul_kernel). A row i is
// "ok" when 0 <= ids[i] < V and group_mask[ids[i] / group_size] > 0; an ok
// row is gathered (and multiplied), any other row is written as exact zeros
// and flagged miss[i] = 1. An id outside [0, V) is never dereferenced.
//
// tiered_gather: a bytes copy, bound by bytes (the ok rows read once, every
// output row written once). One warp per output row, 16-byte vectors where
// the row's bytes allow it (else 4- or 2-byte words), so any 2- or 4-byte
// dtype goes through the same code. The TPU version turns each row into a
// pipelined DMA chosen by a scalar-prefetched index map; on the GPU a warp
// simply loads its own id.
//
// tiered_gather_matmul: out[i] = table[ids[i]] @ w for ok rows, in bf16
// with fp32 accumulation. At Mixtral's widths (D 6144, F 16384) the weight
// alone is 201 MB, so the call is bound by w's bytes when few rows hit and
// by the tensor cores' operations when many do (512 hits: 103 GFLOP, 104
// µs at the card's peak, against 60 µs to read w). The TPU version elides
// the DMA of cold rows with a cummax fetch-id scheme and gates the
// multiply with pl.when. Here a one-block pass first orders the rows, hits
// first and misses after (each in their original order), and the product
// then runs over the packed hits only: a cold row is never loaded or
// multiplied, and row slices past the hits only write zeros. The host
// never learns the number of hits; the grid is sized from N.
// The product is Hopper's warp-specialised GEMM: a block owns 128 packed
// rows × 256 columns and has three warpgroups. The producer warpgroup
// (setmaxnreg 40) fills a 4-stage ring of 64-deep k slices (48 KB each) on
// mbarriers: one thread loads w's (64 × 256) tile by 2-D TMA, four boxes
// of 64 columns with the 128-byte swizzle; A's rows are a gather, which
// TMA cannot do in one box, so the warpgroup's 128 threads copy the hit
// rows' 16-byte chunks with cp.async into the same swizzled layout and
// count them on the stage's barrier (one 1-row TMA box per row measured
// slower). Rows past the hits are neither loaded nor stored. The two
// consumer warpgroups (setmaxnreg 232) each run wgmma m64n256k16 on 64
// rows, A K-major and w MN-major through the descriptor's transpose bit,
// with 128 fp32 accumulators a thread and one k slice's products in
// flight while the next slice's barrier is awaited; a warpgroup with no
// hit row returns at once. The blocks of one column strip are launched
// next to each other (blockIdx.x runs over the row slices), so w's tiles
// come from L2 after the first read. (Clusters of 2 or 4 row slices
// sharing w's tiles by TMA multicast measured 1.8x and 3.6x slower:
// PERF.md.) The host counts the two passes as one launch.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

__device__ __forceinline__ bool row_ok(int idx, const int* mask, int V, int group_size) {
  return idx >= 0 && idx < V && mask[idx / group_size] > 0;
}

template <typename T>
__global__ void gather_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                              const int* __restrict__ mask, T* __restrict__ out, int* __restrict__ miss,
                              int N, int V, int row_words, int group_size) {
  const int i = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= N) return;
  const int idx = ids[i];
  const bool ok = row_ok(idx, mask, V, group_size);
  T* dst = out + static_cast<size_t>(i) * row_words;
  if (ok) {
    const T* src = table + static_cast<size_t>(idx) * row_words;
#pragma unroll 4
    for (int c = lane; c < row_words; c += 32) dst[c] = src[c];
  } else {
    const T zero{};
#pragma unroll 4
    for (int c = lane; c < row_words; c += 32) dst[c] = zero;
  }
  if (lane == 0) miss[i] = ok ? 0 : 1;
}

constexpr int GATHER_THREADS = 256;  // 8 rows per block

template <typename T>
cudaError_t launch_gather(const void* table, const int* ids, const int* mask, void* out, int* miss, int N,
                          int V, int row_bytes, int group_size, cudaStream_t stream) {
  const int rows_per_block = GATHER_THREADS / 32;
  gather_kernel<T><<<(N + rows_per_block - 1) / rows_per_block, GATHER_THREADS, 0, stream>>>(
      static_cast<const T*>(table), ids, mask, static_cast<T*>(out), miss, N, V,
      row_bytes / static_cast<int>(sizeof(T)), group_size);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- gather-matmul

constexpr int PACK_THREADS = 1024;
constexpr int GM_BM = 128;                            // packed rows a block: two consumer warpgroups of 64
constexpr int GM_BN = 256;                            // columns a block: one wgmma m64n256 a k16 step
constexpr int GM_BK = 64;                             // k of a stage: one 128-byte swizzle row of A
constexpr int GM_STAGES = 4;
constexpr int GM_THREADS = 3 * 128;                   // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int GM_A_BYTES = GM_BM * GM_BK * 2;         // 16 KB: 128 rows of 128 bytes
constexpr int GM_B_BYTES = GM_BK * GM_BN * 2;         // 32 KB: 4 boxes of 64 k rows × 64 columns
constexpr int GM_A_OFF = 0;
constexpr int GM_B_OFF = GM_STAGES * GM_A_BYTES;
constexpr int GM_BAR_OFF = GM_B_OFF + GM_STAGES * GM_B_BYTES;  // full[STAGES], empty[STAGES]
constexpr int GM_SMEM = GM_BAR_OFF + 16 * GM_STAGES + 1024;     // room to align the base to 1024

// One block orders the rows: hits first (order[p], their table rows in
// src[p], p < n_ok), then misses, each in their original order; writes the
// miss mask and n_ok.
__global__ void __launch_bounds__(PACK_THREADS)
pack_rows_kernel(const int* __restrict__ ids, const int* __restrict__ mask, int* __restrict__ order,
                 int* __restrict__ src, int* __restrict__ miss, int* __restrict__ n_ok_out, int N, int V,
                 int group_size) {
  __shared__ int s_ok[PACK_THREADS / 32], s_miss[PACK_THREADS / 32];
  __shared__ int s_total;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int count = 0;
  for (int i = tid; i < N; i += PACK_THREADS) count += row_ok(ids[i], mask, V, group_size);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(0xffffffffu, count, off);
  if (lane == 0) s_ok[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < PACK_THREADS / 32; ++w) total += s_ok[w];
    s_total = total;
    *n_ok_out = total;
  }
  __syncthreads();
  int ok_base = 0, miss_base = s_total;
  for (int c0 = 0; c0 < N; c0 += PACK_THREADS) {
    const int i = c0 + tid;
    const int idx = i < N ? ids[i] : -1;
    const bool ok = i < N && row_ok(idx, mask, V, group_size);
    const bool ms = i < N && !ok;
    const unsigned bo = __ballot_sync(0xffffffffu, ok), bm = __ballot_sync(0xffffffffu, ms);
    __syncthreads();  // the previous chunk's readers of s_ok / s_miss are done
    if (lane == 0) {
      s_ok[warp] = __popc(bo);
      s_miss[warp] = __popc(bm);
    }
    __syncthreads();
    int before_ok = 0, before_miss = 0, chunk_ok = 0, chunk_miss = 0;
    for (int w = 0; w < PACK_THREADS / 32; ++w) {
      if (w < warp) {
        before_ok += s_ok[w];
        before_miss += s_miss[w];
      }
      chunk_ok += s_ok[w];
      chunk_miss += s_miss[w];
    }
    const unsigned below = (1u << lane) - 1u;
    if (ok) {
      const int p = ok_base + before_ok + __popc(bo & below);
      order[p] = i;
      src[p] = idx;
    } else if (ms) {
      order[miss_base + before_miss + __popc(bm & below)] = i;
    }
    if (i < N) miss[i] = ok ? 0 : 1;
    ok_base += chunk_ok;
    miss_base += chunk_miss;
  }
}

// Block (x, y) owns packed rows [x·BM, x·BM + BM) and columns [y·BN, y·BN + BN):
// its hit rows are multiplied, its miss rows written as zeros. tm_w: w (D, F)
// as a 2-D map, box (64 columns, 64 k rows).
__global__ void __launch_bounds__(GM_THREADS, 1)
gather_matmul_kernel(const __grid_constant__ CUtensorMap tm_w, const __nv_bfloat16* __restrict__ table,
                     const int* __restrict__ order, const int* __restrict__ src, const int* __restrict__ n_ok_ptr,
                     __nv_bfloat16* __restrict__ out, int N, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int sSrc[GM_BM], sDst[GM_BM];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sA = base + GM_A_OFF, sB = base + GM_B_OFF;
  auto full = [&](int s) { return base + GM_BAR_OFF + 8u * s; };
  auto empty = [&](int s) { return base + GM_BAR_OFF + 8u * (GM_STAGES + s); };

  const int n_ok = *n_ok_ptr;
  const int p0 = blockIdx.x * GM_BM, n0 = blockIdx.y * GM_BN;
  const int tid = threadIdx.x;
  const int rows = min(GM_BM, n_ok - p0);  // hit rows of this slice
  const int live_wgs = rows > 64 ? 2 : 1;  // consumer warpgroups with hit rows
  for (int r = tid; r < GM_BM; r += GM_THREADS) {
    const int p = p0 + r;
    sSrc[r] = p < n_ok ? src[p] : 0;
    sDst[r] = p < N ? order[p] : 0;
  }
  if (tid == 0 && rows > 0) {
    for (int s = 0; s < GM_STAGES; ++s) {
      mbar_init(full(s), 128 + 1);        // each producer thread's copies (cp.async), thread 0's expect_tx
      mbar_init(empty(s), 4 * live_wgs);  // lane 0 of each live consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // miss rows of this slice: exact zeros (F % 8 == 0, so 16-byte stores)
  for (int c = tid; c < GM_BM * (GM_BN / 8); c += GM_THREADS) {
    const int r = c / (GM_BN / 8), col = n0 + (c % (GM_BN / 8)) * 8, p = p0 + r;
    if (p >= n_ok && p < N && col < F)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(sDst[r]) * F + col) = make_uint4(0, 0, 0, 0);
  }
  if (rows <= 0) return;  // block-uniform

  const int KT = (D + GM_BK - 1) / GM_BK;
  // warp-uniform by construction, so what derives from it stays in uniform registers
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 2) {
    // ---- producer: w's tile by TMA, A's hit rows gathered ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int t = tid - 256;
    const int j = t % 8;  // thread t: 16-byte chunk j of rows t / 8, t / 8 + 16, ...
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % GM_STAGES, k0 = kt * GM_BK, k = k0 + 8 * j;
      if (kt >= GM_STAGES) mbar_wait(empty(s), ((kt / GM_STAGES) - 1) & 1);
      if (t == 0) {
        mbar_expect_tx(full(s), GM_B_BYTES);
#pragma unroll
        for (int c = 0; c < GM_BN / 64; ++c)
          tma_load_2d(sB + s * GM_B_BYTES + c * GM_BK * 128, &tm_w, full(s), n0 + 64 * c, k0);
      }
      const uint32_t a_s = sA + s * GM_A_BYTES;
#pragma unroll
      for (int i = 0; i < GM_BM / 16; ++i) {
        const int r = i * 16 + t / 8;
        if (r < rows) {  // chunks past D zero-filled; rows past the hits neither loaded nor stored
          const bool in = k < D;
          const __nv_bfloat16* g = in ? table + static_cast<size_t>(sSrc[r]) * D + k : table;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a_s + r * 128 + ((j ^ (r & 7)) << 4)),
                       "l"(g), "r"(in ? 16 : 0));
        }
      }
      cp_async_mbar_arrive(full(s));
    }
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    if (wg >= live_wgs) return;  // no hit row in this warpgroup's 64
    const int lane = tid % 32, warp = (tid % 128) / 32;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % GM_STAGES;
      mbar_wait(full(s), (kt / GM_STAGES) & 1);
      // the gathered rows came through the generic proxy (cp.async); wgmma reads through the async one
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < GM_BK / 16; ++kc) {
        const uint64_t da = desc_sw128(sA + s * GM_A_BYTES + wg * 64 * 128 + kc * 32, 16, 1024);
        const uint64_t db = desc_sw128(sB + s * GM_B_BYTES + kc * 2048, GM_BK * 128, 1024);
        wgmma_ss_tb(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done: free its stage
      if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % GM_STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // rows back to their output rows, bf16 pairs: accumulator j·4 + e holds
    // row warp·16 + lane / 4 (+ 8 for e >= 2), column 8·j + 2·(lane % 4) + (e & 1)
    const int r0 = wg * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
    __nv_bfloat16* o0 = out + static_cast<size_t>(sDst[r0]) * F;
    __nv_bfloat16* o1 = out + static_cast<size_t>(sDst[r1]) * F;
#pragma unroll
    for (int j = 0; j < GM_BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col < F) {
        if (r0 < rows) *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
        if (r1 < rows) *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

}  // namespace

// Plain C entries for ctypes; ids (N,) and group_mask (G,) int32 with
// G >= ceil(V / group_size); miss (N,) int32. Return the cudaError_t of
// the launch (0 = launched).

// table, out: (V, ·) and (N, ·) rows of row_bytes bytes (a multiple of 2).
extern "C" int tiered_gather(const void* table, const int* ids, const int* group_mask, void* out, int* miss,
                             int N, int V, int row_bytes, int group_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || V <= 0 || row_bytes <= 0 || row_bytes % 2 || group_size <= 0) return cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return launch_gather<uint4>(table, ids, group_mask, out, miss, N, V, row_bytes, group_size, s);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return launch_gather<uint32_t>(table, ids, group_mask, out, miss, N, V, row_bytes, group_size, s);
  return launch_gather<uint16_t>(table, ids, group_mask, out, miss, N, V, row_bytes, group_size, s);
}

// table (V, D), w (D, F), out (N, F): bf16, contiguous, 16-byte aligned,
// D and F multiples of 8; work: 2·N + 1 int32 of scratch.
extern "C" int tiered_gather_matmul_bf16(const void* table, const void* w, const int* ids, const int* group_mask,
                                         void* out, int* miss, int* work, int N, int V, int D, int F,
                                         int group_size, void* stream) {
  if (N <= 0 || V <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8 || group_size <= 0 || (F + GM_BN - 1) / GM_BN > 65535)
    return cudaErrorInvalidValue;
  if (encode_fn() == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_w;
  if (!make_rows_map(&tm_w, w, D, F, GM_BK)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int *order = work, *src = work + N, *n_ok = work + 2 * static_cast<size_t>(N);
  pack_rows_kernel<<<1, PACK_THREADS, 0, s>>>(ids, group_mask, order, src, miss, n_ok, N, V, group_size);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static cudaError_t opted =
      cudaFuncSetAttribute(gather_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GM_SMEM);
  if (opted != cudaSuccess) return opted;
  dim3 grid((N + GM_BM - 1) / GM_BM, (F + GM_BN - 1) / GM_BN);
  gather_matmul_kernel<<<grid, GM_THREADS, GM_SMEM, s>>>(tm_w, static_cast<const __nv_bfloat16*>(table), order, src,
                                                          n_ok, static_cast<__nv_bfloat16*>(out), N, D, F);
  return cudaGetLastError();
}
