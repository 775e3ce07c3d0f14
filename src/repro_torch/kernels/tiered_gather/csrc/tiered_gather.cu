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
// alone is 201 MB, so a few hundred rows make it operation-bound and the
// product runs on the tensor cores (mma.sync m16n8k16, ldmatrix fragments).
// The TPU version elides the DMA of cold rows with a cummax fetch-id scheme
// and gates the multiply with pl.when. Here a one-block pass first orders
// the rows, hits first and misses after (each in their original order), and
// the product then runs over the packed hits only: a cold row is never
// loaded or multiplied, and the row slices past the hits only write zeros,
// so half the groups resident means half the tiles and half the reads of w.
// Tiles of 128 rows × 128 columns × 32, 8 warps of 64 × 32, a four-stage
// cp.async ring; the blocks of one column strip are launched next to each
// other (blockIdx.x runs over the row slices), so w's tiles come from L2
// after the first read. The host counts the two passes as one launch.

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
constexpr int BM = 128, BN = 128, BKK = 32, STAGES = 4, GM_THREADS = 256;
constexpr int LDA = BKK + 8;  // padded smem rows: conflict-free ldmatrix
constexpr int LDB = BN + 8;
constexpr int GM_SMEM = STAGES * (BM * LDA + BKK * LDB) * 2;

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
// its hit rows are multiplied, its miss rows written as zeros.
__global__ void __launch_bounds__(GM_THREADS, 2)
gather_matmul_kernel(const __nv_bfloat16* __restrict__ table, const __nv_bfloat16* __restrict__ w,
                     const int* __restrict__ order, const int* __restrict__ src, const int* __restrict__ n_ok_ptr,
                     __nv_bfloat16* __restrict__ out, int N, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [STAGES][BM][LDA]
  __nv_bfloat16* sB = sA + STAGES * BM * LDA;                        // [STAGES][BKK][LDB]
  __shared__ int sSrc[BM], sDst[BM];

  const int n_ok = *n_ok_ptr;
  const int p0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp / 4, wn = warp % 4;  // 2 × 4 warps, 64 rows × 32 columns each

  for (int r = tid; r < BM; r += GM_THREADS) {
    const int p = p0 + r;
    sSrc[r] = p < n_ok ? src[p] : 0;
    sDst[r] = p < N ? order[p] : 0;
  }
  __syncthreads();

  // miss rows of this slice: exact zeros (F % 8 == 0, so 16-byte stores)
  for (int c = tid; c < BM * (BN / 8); c += GM_THREADS) {
    const int r = c / (BN / 8), col = n0 + (c % (BN / 8)) * 8, p = p0 + r;
    if (p >= n_ok && p < N && col < F)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(sDst[r]) * F + col) = make_uint4(0, 0, 0, 0);
  }
  const int rows = min(BM, n_ok - p0);  // hit rows of this slice
  if (rows <= 0) return;

  auto load_stage = [&](int kt, int stage) {
    const int k0 = kt * BKK;
    __nv_bfloat16* a_s = sA + stage * BM * LDA;
    __nv_bfloat16* b_s = sB + stage * BKK * LDB;
    // A: the hit rows' k-slice; rows past the hits are zero-filled, not read
    for (int c = tid; c < BM * (BKK / 8); c += GM_THREADS) {
      const int r = c / (BKK / 8), col = (c % (BKK / 8)) * 8;
      const bool live = r < rows && k0 + col < D;
      const __nv_bfloat16* p = live ? table + static_cast<size_t>(sSrc[r]) * D + k0 + col : table;
      cp_async16(a_s + r * LDA + col, p, live ? 16 : 0);
    }
    // B: w's (BKK × BN) tile
    for (int c = tid; c < BKK * (BN / 8); c += GM_THREADS) {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const bool live = k0 + r < D && n0 + col < F;
      const __nv_bfloat16* p = live ? w + static_cast<size_t>(k0 + r) * F + n0 + col : w;
      cp_async16(b_s + r * LDB + col, p, live ? 16 : 0);
    }
  };

  // m16 tiles of this warp's 64 rows that hold hits (warp-uniform)
  const int mtiles = min(4, max(0, (rows - wm * 64 + 15) / 16));
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int KT = (D + BKK - 1) / BKK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  const int lrow = lane % 8, lmat = lane / 8;  // ldmatrix: this lane's row within its 8×8 matrix
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed for everyone; stage (kt - 1) % STAGES is free
    if (kt + STAGES - 1 < KT) load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    if (mtiles == 0) continue;
    const __nv_bfloat16* a_s = sA + (kt % STAGES) * BM * LDA + wm * 64 * LDA;
    const __nv_bfloat16* b_s = sB + (kt % STAGES) * BKK * LDB + wn * 32;
#pragma unroll
    for (int kk = 0; kk < BKK / 16; ++kk) {
      // B fragments of the warp's four n8 tiles: matrices (k 0-7 | 8-15) × (n tile 2j | 2j+1)
      uint32_t bf[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, b_s + (kk * 16 + (lmat & 1) * 8 + lrow) * LDB + (2 * j + (lmat >> 1)) * 8);
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < mtiles) {
          // A fragment: matrices (rows 0-7 | 8-15) × (k 0-7 | 8-15)
          uint32_t a[4];
          ldmatrix_x4(a, a_s + (mt * 16 + (lmat & 1) * 8 + lrow) * LDA + kk * 16 + (lmat >> 1) * 8);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_16x8x16(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // hit rows back to their output rows, bf16 pairs
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    if (mt >= mtiles) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + t4 * 2;
      if (col >= F) continue;
      const int r0 = wm * 64 + mt * 16 + g, r1 = r0 + 8;
      if (r0 < rows)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(sDst[r0]) * F + col) =
            pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      if (r1 < rows)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(sDst[r1]) * F + col) =
            pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
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
  if (N <= 0 || V <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8 || group_size <= 0 || (F + BN - 1) / BN > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static cudaError_t opted =
      cudaFuncSetAttribute(gather_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GM_SMEM);
  if (opted != cudaSuccess) return opted;
  int *order = work, *src = work + N, *n_ok = work + 2 * static_cast<size_t>(N);
  pack_rows_kernel<<<1, PACK_THREADS, 0, s>>>(ids, group_mask, order, src, miss, n_ok, N, V, group_size);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((N + BM - 1) / BM, (F + BN - 1) / BN);
  gather_matmul_kernel<<<grid, GM_THREADS, GM_SMEM, s>>>(static_cast<const __nv_bfloat16*>(table),
                                                         static_cast<const __nv_bfloat16*>(w), order, src, n_ok,
                                                         static_cast<__nv_bfloat16*>(out), N, D, F);
  return cudaGetLastError();
}
