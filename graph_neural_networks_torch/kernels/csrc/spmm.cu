// Hopper (sm_90a) kernels for the graph shift y = x @ S, in true FP32.
//
// Three kernels, each the counterpart of one Pallas kernel of the JAX
// package (graph_neural_networks_tpu/ops/spmm.py):
//
//   band_matmul_kernel    <- spmm.py:band_matmul (_make_band_kernel)
//   bcsr_matmul_kernel    <- spmm.py:bcsr_matmul (_make_bcsr_kernel)
//   band_register_kernel  <- spmm.py:band_shift_register (_make_fused_kernel)
//
// What bounds them on an H100: the JAX default for f32 signals is true f32
// (Precision.HIGHEST), so the products run as FP32 FMAs on the CUDA cores,
// not on TF32 tensor cores. A band shift of an (R, N) signal executes
// 2 R N (2w+1) bs flops against 4 (2 R N + nb (2w+1) bs^2) bytes; at the
// serving shapes (R = 32 .. 2048, bs = 128, w = 1) that is 12 .. 90 flops a
// byte, above the ~20 flop/byte ridge of FP32 FMA (67 TFLOP/s over
// 3.35 TB/s) for the large R, so the big shifts are bound by FP32
// operations and the small ones by bytes and by launching too few blocks.
//
// The design answer in this first version is a plain shared-memory tiled
// FP32 product: a BM x 64 output tile per block, 16-deep steps staged in
// shared memory, a TM x 4 micro-tile of FMAs per thread. Ragged edges (rows
// past R, x columns past N) are masked in the loads, so the wrapper never
// copies x into a padded buffer. No wgmma/TMA: those need TF32 or lower,
// which would change the numbers the JAX reference produces.
//
// Every launcher has a plain C interface and returns the cudaError_t of the
// launch; the Python wrappers raise if it is not cudaSuccess.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kBN = 64;   // output columns per block; block_size % kBN == 0
constexpr int kBK = 16;   // depth of one shared-memory step
constexpr int kTN = 4;    // output columns per thread (one float4)
constexpr int kPad = 4;   // As row padding: spreads the transposed stores over banks

// band_matmul / bcsr_matmul tile: 64 x 64 outputs, 4 x 4 per thread.
constexpr int kBM = 64;
constexpr int kTM = 4;
// band_register tile: 8 x 64 outputs, 1 x 4 per thread, so that the few
// rows the fused register serves (R <= 512) still spread over many blocks.
constexpr int kRegBM = 8;
constexpr int kRegTM = 1;
// Blocks of one cluster share a row tile and split its columns; the cluster
// barrier is what orders tap k-1's writes before tap k's reads.
constexpr int kCluster = 8;

template <int BM, int TM>
__host__ __device__ constexpr int threads_of() {
  return (BM / TM) * (kBN / kTN);
}
constexpr int kThreads = threads_of<kBM, kTM>();
constexpr int kRegThreads = threads_of<kRegBM, kRegTM>();

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// acc += X[r0 : r0+BM, xc0 : xc0+depth] @ B[0 : depth, 0 : kBN]
// X is row-major (ldx) with valid rows < R and valid columns < N (the rest
// read as zero). B points at the tile's first column, row-major (ldb).
// depth is a multiple of kBK. Every thread of the block must call this.
// X is read through L2 (ld.global.cg): in band_register_kernel it is a tap
// that other blocks of the cluster wrote, which must not come from L1.
template <int BM, int TM>
__device__ __forceinline__ void tile_mac(float (&acc)[TM][kTN],
                                         const float* __restrict__ x,
                                         int64_t ldx, int R, int N, int r0,
                                         int xc0, const float* __restrict__ b,
                                         int64_t ldb, int depth, float* As,
                                         float* Bs) {
  constexpr int T = threads_of<BM, TM>();
  constexpr int LDA = BM + kPad;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  for (int k0 = 0; k0 < depth; k0 += kBK) {
    for (int e = tid; e < BM * kBK; e += T) {
      const int r = e / kBK, c = e % kBK;
      const int gr = r0 + r, gc = xc0 + k0 + c;
      As[c * LDA + r] =
          (gr < R && gc < N) ? __ldcg(x + (int64_t)gr * ldx + gc) : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += T) {
      const int r = e / kBN, c = e % kBN;
      Bs[r * kBN + c] = b[(int64_t)(k0 + r) * ldb + c];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k * LDA + ty * TM + i];
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k * kBN + tx * kTN]);
      const float bb[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <int BM, int TM>
__device__ __forceinline__ void tile_store(const float (&acc)[TM][kTN],
                                           float* __restrict__ y, int64_t ldy,
                                           int R, int n_cols, int r0, int c0) {
  const int tx = threadIdx.x % (kBN / kTN);
  const int ty = threadIdx.x / (kBN / kTN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = r0 + ty * TM + i;
    if (gr >= R) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gc = c0 + tx * kTN + j;
      if (gc < n_cols) y[(int64_t)gr * ldy + gc] = acc[i][j];
    }
  }
}

// One band shift of a BM-row tile into output columns [c0, c0+kBN): the sum
// over the 2w+1 window blocks of the block-banded S. Windows that fall off
// the matrix are skipped (the JAX kernel clamps them onto zero slab rows).
template <int BM, int TM>
__device__ __forceinline__ void band_tile(float (&acc)[TM][kTN],
                                          const float* __restrict__ x, int R,
                                          int N, int r0, int c0,
                                          const float* __restrict__ s_band,
                                          int nb, int w, int bs, float* As,
                                          float* Bs) {
  const int W = 2 * w + 1;
  const int j = c0 / bs, lc = c0 % bs;
  for (int t = 0; t < W; ++t) {
    const int i = j + t - w;
    if (i < 0 || i >= nb) continue;
    const float* b = s_band + ((int64_t)j * W + t) * bs * bs + lc;
    tile_mac<BM, TM>(acc, x, N, R, N, r0, i * bs, b, bs, bs, As, Bs);
  }
}

// y (R, n_cols) = x (R, N) @ S, S as the slab (nb, (2w+1) bs, bs).
// Grid (n_cols / 64, R / 64): one block per (output column tile, row tile).
__global__ void __launch_bounds__(kThreads)
band_matmul_kernel(const float* __restrict__ x,
                   const float* __restrict__ s_band, float* __restrict__ y,
                   int R, int N, int n_cols, int nb, int w, int bs) {
  __shared__ __align__(16) float As[kBK * (kBM + kPad)];
  __shared__ __align__(16) float Bs[kBK * kBN];
  const int c0 = blockIdx.x * kBN;
  const int r0 = blockIdx.y * kBM;
  float acc[kTM][kTN] = {};
  band_tile<kBM, kTM>(acc, x, R, N, r0, c0, s_band, nb, w, bs, As, Bs);
  tile_store<kBM, kTM>(acc, y, n_cols, R, n_cols, r0, c0);
}

// y (R, n_cols) = x (R, N) @ S, S as nonzero (bs, bs) blocks sorted by
// block column; col_start[j] .. col_start[j+1] is column j's segment. The
// x tile of each block is chosen by block_row (data-dependent). An empty
// segment writes zeros. x may sit on its own block grid (N != n_cols).
__global__ void __launch_bounds__(kThreads)
bcsr_matmul_kernel(const float* __restrict__ x,
                   const float* __restrict__ blocks,
                   const int* __restrict__ block_row,
                   const int* __restrict__ col_start, float* __restrict__ y,
                   int R, int N, int n_cols, int bs) {
  __shared__ __align__(16) float As[kBK * (kBM + kPad)];
  __shared__ __align__(16) float Bs[kBK * kBN];
  const int c0 = blockIdx.x * kBN;
  const int r0 = blockIdx.y * kBM;
  const int j = c0 / bs, lc = c0 % bs;
  const int k1 = col_start[j + 1];
  float acc[kTM][kTN] = {};
  for (int k = col_start[j]; k < k1; ++k) {
    const float* b = blocks + (int64_t)k * bs * bs + lc;
    tile_mac<kBM, kTM>(acc, x, N, R, N, r0, block_row[k] * bs, b, bs, bs, As,
                       Bs);
  }
  tile_store<kBM, kTM>(acc, y, n_cols, R, n_cols, r0, c0);
}

// out (K, R, N) = [x, x S, ..., x S^(K-1)] in one launch.
//
// The TPU kernel keeps a whole row stripe in 12+ MiB of VMEM and walks its
// grid in order. A Hopper block has at most 227 KB of shared memory and
// blocks run in no order, so here a cluster of kCluster blocks owns a
// kRegBM-row tile across all N columns: each block computes its share of
// the column tiles of tap k, writes them to out[k], and after a cluster
// barrier every block reads tap k back (from L2) as the input of tap k+1.
// No grid-wide sync is needed, and the stripe never has to fit on chip.
// Limits: any R and N; block_size % 64 == 0; 4.6 KB of static shared
// memory a block.
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kRegThreads)
band_register_kernel(const float* __restrict__ x,
                     const float* __restrict__ s_band, float* out, int R,
                     int N, int nb, int w, int bs, int K) {
  constexpr int T = kRegThreads;
  __shared__ __align__(16) float As[kBK * (kRegBM + kPad)];
  __shared__ __align__(16) float Bs[kBK * kBN];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int r0 = (blockIdx.x / kCluster) * kRegBM;
  const int64_t plane = (int64_t)R * N;

  // tap 0 is x itself
  const int rows = min(kRegBM, R - r0);
  for (int64_t e = (int64_t)rank * T + threadIdx.x; e < (int64_t)rows * N;
       e += (int64_t)kCluster * T) {
    const int64_t off = (int64_t)r0 * N + e;
    out[off] = x[off];
  }

  const int n_tiles = cdiv(N, kBN);
  for (int k = 1; k < K; ++k) {
    const float* src = x;
    if (k >= 2) {
      // tap k-1 is complete in every block of the cluster before any reads it
      __threadfence();
      cluster.sync();
      src = out + (k - 1) * plane;
    }
    float* dst = out + k * plane;
    for (int ct = rank; ct < n_tiles; ct += kCluster) {
      float acc[kRegTM][kTN] = {};
      band_tile<kRegBM, kRegTM>(acc, src, R, N, r0, ct * kBN, s_band, nb, w,
                                bs, As, Bs);
      tile_store<kRegBM, kRegTM>(acc, dst, N, R, N, r0, ct * kBN);
    }
  }
}

}  // namespace

extern "C" {

const char* gnt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

cudaError_t gnt_band_matmul(const float* x, const float* s_band, float* y,
                            int R, int N, int n_cols, int nb, int w, int bs,
                            cudaStream_t stream) {
  if (bs % kBN != 0 || R <= 0 || n_cols <= 0) return cudaErrorInvalidValue;
  const dim3 grid(cdiv(n_cols, kBN), cdiv(R, kBM));
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  band_matmul_kernel<<<grid, kThreads, 0, stream>>>(
      x, s_band, y, R, N, n_cols, nb, w, bs);
  return cudaGetLastError();
}

cudaError_t gnt_bcsr_matmul(const float* x, const float* blocks,
                            const int* block_row, const int* col_start,
                            float* y, int R, int N, int n_cols, int bs,
                            cudaStream_t stream) {
  if (bs % kBN != 0 || R <= 0 || n_cols <= 0) return cudaErrorInvalidValue;
  const dim3 grid(cdiv(n_cols, kBN), cdiv(R, kBM));
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  bcsr_matmul_kernel<<<grid, kThreads, 0, stream>>>(
      x, blocks, block_row, col_start, y, R, N, n_cols, bs);
  return cudaGetLastError();
}

cudaError_t gnt_band_register(const float* x, const float* s_band,
                              float* out, int R, int N, int nb, int w, int bs,
                              int K, cudaStream_t stream) {
  if (bs % kBN != 0 || R <= 0 || N <= 0 || K < 1) return cudaErrorInvalidValue;
  const dim3 grid(kCluster * cdiv(R, kRegBM));
  band_register_kernel<<<grid, kRegThreads, 0, stream>>>(
      x, s_band, out, R, N, nb, w, bs, K);
  return cudaGetLastError();
}

}  // extern "C"
