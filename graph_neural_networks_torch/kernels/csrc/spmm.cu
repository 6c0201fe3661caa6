// Hopper (sm_90a) kernels for the graph shift y = x @ S: an f32 and a bf16
// instance of each.
//
// Three kernels, each the counterpart of one Pallas kernel of the JAX
// package (graph_neural_networks_tpu/ops/spmm.py); band_matmul and
// bcsr_matmul run one mainloop on two block layouts:
//
//   f32:  bcsr_matmul_kernel<BandBlocks>, bcsr_narrow_kernel<., BandBlocks>
//   bf16: bcsr_mma_kernel<., BandBlocks<bf16>>
//                         <- spmm.py:band_matmul (_make_band_kernel)
//   f32:  bcsr_matmul_kernel<BcsrBlocks>, bcsr_narrow_kernel<., BcsrBlocks>
//   bf16: bcsr_mma_kernel<., BcsrBlocks<bf16>>
//                         <- spmm.py:bcsr_matmul (_make_bcsr_kernel)
//   f32:  band_register_kernel; bf16: band_register_mma_kernel
//                         <- spmm.py:band_shift_register (_make_fused_kernel)
//
// The f32 instances: the JAX default for f32 signals is true f32
// (Precision.HIGHEST), so their products run as FP32 FMAs on the CUDA
// cores, not on TF32 tensor cores (which would change the numbers the JAX
// reference produces). A band shift of an (R, N) signal executes
// 2 R N (2w+1) bs flops against 4 (2 R N + nb (2w+1) bs^2) bytes; at the
// serving shapes (R = 32 .. 2048, bs = 128, w = 1) that is 12 .. 90 flops a
// byte, above the ~20 flop/byte ridge of FP32 FMA (67 TFLOP/s over
// 3.35 TB/s) for the large R, so the big f32 shifts are bound by FP32
// operations. The register at few rows (R = 32) does 0.4 GFLOP in four
// dependent taps: it is bound by latency and by how many SMs it keeps busy.
//
// The bf16 instances read bf16 x and S, accumulate in f32 and round y (each
// tap of the register) to bf16 once, where the JAX kernels round
// (ops/spmm.py:144 and :617; the register's io-dtype zbuf, :423-425). A
// product of two bf16 values is exact in f32, so a tensor-core product with
// an f32 accumulator computes the same function as f32 FMAs, its sums in
// another order. Half the bytes of f32 and 989 TFLOP/s of bf16 products
// put the ridge at ~295 flops a byte: the bf16 shift at R = 2048 (N = 4096,
// w = 1) moves 36.7 MB against 6.4 GFLOP, so it is bound by bytes
// (0.011 ms), but only on tensor cores: at the FP32 FMA rate its products
// alone take 0.094 ms. So the bf16 instances keep bf16 in shared memory,
// staged by 16-byte cp.async in a ring of stages (copies overlap the
// products), and run the products as mma.sync.m16n8k16 (bf16 in, f32
// accumulators): A fragments from x's row-major tile by ldmatrix, B
// fragments from S's row-major (k, n) block by ldmatrix.trans. Every staged
// row is padded by 16 bytes to an odd number of 16-byte units, so the 8 rows
// an ldmatrix reads fall on distinct banks. mma.sync runs at a fraction of
// the wgmma rate: on an H100 (chip_smoke.py's bf16_timing) the mainloop at
// R = 2048 (N = 4096, w = 1) takes 0.038 ms, 3.5x its byte bound and half
// the bf16 cuBLAS product's time, its products at ~170 TFLOP/s; wgmma and
// TMA are untried.
//
// band_matmul and bcsr_matmul: y = x @ S over the blocks of each output
// block column. The band slab is a BCSR in disguise: column j's segment
// is the window blocks t that fall inside the matrix, block t at
// s_band[j, t bs : (t+1) bs], x block column j + t - w (BandBlocks); the
// BCSR segment is col_start[j] .. col_start[j+1], built once with the
// layout (BcsrBlocks). At R = 2048 rows (N = 4096, w = 1: 94 blocks) either
// does 6.3 GFLOP against 8.4 MB of blocks and 67 MB of x and y in f32: bound
// by FP32 operations (0.094 ms); at R = 32 by the bytes of the blocks it
// must stream (6.2 MB, 2 us), and in practice by how many SMs the few
// rows keep busy. The f32 instances, two tiles picked by R:
//  * above 64 rows, 128 x 64 outputs a block, 256 threads, an 8 x 4
//    register tile a thread (4 + 8 16-byte shared loads for 128 FMAs: x
//    read 4 k at a time along its rows, no transpose), 64-deep K-steps
//    double buffered by cp.async, one barrier a step, 2 blocks an SM;
//  * at most 64 rows, BM x 16 outputs a block (BM = 16, 32, 64, the
//    fewest that hold R, so no half-masked row tile), n_cols / 16 blocks
//    (256 at N = 4096, filling the 132 SMs at any R), 64-deep K-steps in 4
//    cp.async stages, the block's threads split over the depth of each
//    step (4 x 4 tiles), their partial tiles added in a fixed order at the
//    end: deterministic, and each S block streams once.
// x rows go by 16-byte copies when N % 4 == 0, else by 4-byte ones (zero
// filled past R and N either way), so the wrappers never copy x into a
// padded buffer; the blocks by 16-byte copies. The bf16 instance
// (bcsr_mma_kernel) keeps the two tile shapes on tensor cores:
//  * above 64 rows, 128 x 128 outputs a block (one whole block column of
//    S when bs % 128 == 0, so each x window is read from L2 once for every
//    128 output columns, not every 64), 8 warps of 64 x 32, 3 stages of
//    64-deep K-steps (35 KB each), 2 blocks an SM; 128 x 64 (4 stages)
//    when bs is an odd multiple of 64 or the 128-column tiles would leave
//    SMs idle (see launch_mma);
//  * at most 64 rows, BM x 16 (BM = 16, 32, 64: the m16 tile of mma.sync
//    holds R = 16, 32, 64 exactly), 4 warps, each one k16 slice of every
//    64-deep step, 4 stages; the warps' partial tiles added in warp order.
// x rows go by 16-byte copies (8 bf16) when N % 8 == 0 and x is 16-byte
// aligned, else element by element; past R and N they read as zero.
//
// band_register_kernel (f32): one cooperative launch of persistent blocks.
// Each block owns a 32-column panel of the output, keeps that panel's
// (2w+1) bs rows of the band slab resident in shared memory for all K-1
// taps, stages the previous tap's window with cp.async (double buffered),
// and a grid-wide barrier orders the taps (see the kernel).
// band_register_mma_kernel (bf16): the same launch, taps and resident
// panel, the panel in bf16 and 64 columns wide above 64 rows where it fits
// (two blocks an SM at w = 1, bs = 128), else 32; the previous tap's
// slices staged by 16-byte cp.async in a ring that runs ahead across the
// block's items, and the products on tensor cores as above. At many rows
// a tap takes about what one block-mainloop call takes (R = 2048, N =
// 4096, w = 1 on an H100: 4 taps 0.17-0.18 ms, one mainloop call 0.038):
// both run their products at ~150-170 TFLOP/s, the mma.sync rate these
// tiles reach with a barrier every 64-deep step. Its fallback panel (32
// columns, 2 stages) takes less shared memory than the f32 kernel's, so it
// runs every layout the f32 kernel runs.
//
// Every launcher has a plain C interface and returns the cudaError_t of the
// launch; the Python wrappers raise if it is not cudaSuccess.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kBN = 64;   // block_size % kBN == 0: no tile straddles a block
constexpr int kTN = 4;    // output columns per thread (one float4)

// band_register: a block owns a kPanel-column output panel and walks row
// tiles under it, 128 threads, each TM rows x kTN columns of the tile
// (rows ty + 16 i). Two tiles, chosen by R: at most kRegWideRows rows,
// 32-row tiles (TM = 2) staged in 64-deep slices, so that few rows still
// spread over many blocks; above it 128-row tiles (TM = 8) staged in
// 32-deep slices, 32 FMAs a thread for each 3 shared-memory loads.
constexpr int kPanel = 32;
constexpr int kRegThreads = 128;
constexpr int kRegRowThreads = kRegThreads / (kPanel / kTN);  // 16
constexpr int kRegWideRows = 64;
constexpr int kNarrowTM = 2, kNarrowKD = 64;
constexpr int kWideTM = 8, kWideKD = 32;
constexpr int kAPad = 4;  // staged rows: KD + 4 floats, so a warp's float4
                          // reads of 4 consecutive rows hit distinct banks
// Shared memory a block may use on sm_90 (227 KB).
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// band_matmul and bcsr_matmul: one pipelined mainloop on two block layouts
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  // every group but the newest kPending has landed
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The io type of the f32 instances below (T = float), and bf16 for the
// bf16 instances (the tensor-core section).
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }

// two floats rounded (to nearest even) to bf16 as one word, a at the lower
// address
__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// 4 consecutive floats at p (16-byte aligned)
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Stage 4 consecutive floats at src (or 4 zeros, nothing read, when
// !valid) at dst (16-byte aligned shared memory): one 16-byte cp.async,
// landed at the next cp_async_wait.
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       bool valid) {
  cp_async16(dst, src, valid);
}

// Stage one float likewise (a 4-byte cp.async).
__device__ __forceinline__ void stage1(float* dst, const float* src,
                                       bool valid) {
  cp_async4(dst, src, valid);
}

// Stage rows [r0, r0 + BM) x columns [xc, xc + KD) of x (R, N) into As
// (BM rows of lda floats); rows past R and columns past N read as zero.
// vec: 4 elements a copy (N % 4 == 0, x 16-byte aligned), else one.
template <int BM, int KD, int NT, class T>
__device__ __forceinline__ void stage_x(float* As, int lda,
                                        const T* __restrict__ x, int R,
                                        int N, int r0, int xc, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < BM * KD / 4; e += NT) {
      const int r = e / (KD / 4), c = 4 * (e % (KD / 4));
      const bool ok = r0 + r < R && xc + c < N;
      stage4(As + r * lda + c, ok ? x + (int64_t)(r0 + r) * N + xc + c : x,
             ok);
    }
  } else {
    for (int e = threadIdx.x; e < BM * KD; e += NT) {
      const int r = e / KD, c = e % KD;
      const bool ok = r0 + r < R && xc + c < N;
      stage1(As + r * lda + c, ok ? x + (int64_t)(r0 + r) * N + xc + c : x,
             ok);
    }
  }
}

// Stage rows [kd, kd + KD) x columns [lc, lc + BN) of one (bs, bs) block
// of S into Bs (KD rows of BN floats), 4 elements a copy.
template <int KD, int BN, int NT, class T>
__device__ __forceinline__ void stage_s(float* Bs, const T* __restrict__ blk,
                                        int bs, int kd, int lc) {
  for (int e = threadIdx.x; e < KD * BN / 4; e += NT) {
    const int r = e / (BN / 4), c = 4 * (e % (BN / 4));
    stage4(Bs + r * BN + c, blk + (int64_t)(kd + r) * bs + lc + c, true);
  }
}

// acc[i][t] += sum over k < KD of A[i * a_row + k] * B[k * ldb + t] for a
// thread's TM rows and 4 columns, k in order, 4 k a step: TM + 4 16-byte
// shared loads for 16 TM FMAs.
template <int TM, int KD>
__device__ __forceinline__ void mac_rows(float (&acc)[TM][4], const float* A,
                                         int a_row, const float* B,
                                         int ldb) {
#pragma unroll
  for (int kk = 0; kk < KD; kk += 4) {
    float4 b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      b[q] = *reinterpret_cast<const float4*>(B + (kk + q) * ldb);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(A + i * a_row + kk);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][0] = fmaf(av[q], b[q].x, acc[i][0]);
        acc[i][1] = fmaf(av[q], b[q].y, acc[i][1]);
        acc[i][2] = fmaf(av[q], b[q].z, acc[i][2]);
        acc[i][3] = fmaf(av[q], b[q].w, acc[i][3]);
      }
    }
  }
}

// The wide tile: 128 x 64 outputs a block, 256 threads, thread (ty, tx) =
// (tid / 16, tid % 16) owns rows ty + 16 i (i < 8) and columns 4 tx + t;
// K-steps of 64, double buffered by cp.async (2 blocks an SM; fewer
// barriers than 32-deep steps in 3 stages, which ran 5-6% slower on an
// H100).
constexpr int kCsrBM = 128, kCsrBN = 64, kCsrBK = 64, kCsrStages = 2;
constexpr int kCsrThreads = 256;
constexpr int kCsrLDA = kCsrBK + 4;  // As row stride: the rows a warp
                                     // reads at once on distinct banks
constexpr int kCsrStage = kCsrBM * kCsrLDA + kCsrBK * kCsrBN;  // floats

// The narrow tiles (R <= 64): BM x 16 outputs a block (BM = 16, 32, 64),
// 256 threads in 64 / BM k-groups, each thread a 4 x 4 register tile of
// rows rg + (BM / 4) i over its group's 16 BM / 64 rows of each 64-deep
// K-step, 4 cp.async stages; the groups' partial tiles are added in group
// order at the end (deterministic).
constexpr int kNarBN = 16, kNarKD = 64, kNarStages = 4;
constexpr int kNarLDA = kNarKD + 4;
constexpr int kNarMaxRows = 64;

__host__ __device__ constexpr int nar_stage(int BM) {
  return BM * kNarLDA + kNarKD * kNarBN;
}

size_t bcsr_smem_bytes(int BM) {
  return sizeof(float) * (BM > kNarMaxRows
                              ? (size_t)kCsrStages * kCsrStage
                              : (size_t)kNarStages * nar_stage(BM));
}

// The block layouts the two mainloops walk: output block column j sums
// the blocks kb of its segment first(j) .. first(j) + count(j), block kb
// at block(j, kb) (bs x bs, row-major), multiplying x's block column
// x_block(j, kb).
//  * BcsrBlocks: the nonzero blocks sorted by block column; the segment
//    is col_start[j] .. col_start[j+1] (built once with the layout), the x
//    block column is block_row[kb] (data-dependent).
//  * BandBlocks: the band slab (nb, (2w+1) bs, bs), a BCSR in disguise:
//    block t of column j is the slab's rows t bs .. (t+1) bs of j, x block
//    column j + t - w; the segment is the t that keep that inside the
//    matrix, max(0, w - j) .. min(2w+1, nb + w - j), computed, not read.
// T: the io type of the blocks (that of x and y): float for
// bcsr_matmul_kernel and bcsr_narrow_kernel, bf16 for bcsr_mma_kernel.
template <class T>
struct BcsrBlocks {
  using io = T;
  const T* blocks;
  const int* block_row;
  const int* col_start;
  int bs;
  __device__ int first(int j) const { return col_start[j]; }
  __device__ int count(int j) const { return col_start[j + 1] - col_start[j]; }
  __host__ __device__ const T* block(int, int kb) const {
    return blocks + (int64_t)kb * bs * bs;
  }
  __device__ int x_block(int, int kb) const { return block_row[kb]; }
};

template <class T>
struct BandBlocks {
  using io = T;
  const T* s_band;
  int nb, w, bs;
  __device__ int first(int j) const { return max(0, w - j); }
  __device__ int count(int j) const {
    return max(0, min(2 * w + 1, nb + w - j) - first(j));
  }
  __host__ __device__ const T* block(int j, int t) const {
    return s_band + ((int64_t)j * (2 * w + 1) + t) * bs * bs;
  }
  __device__ int x_block(int j, int t) const { return j + t - w; }
};

// y (R, n_cols) = x (R, N) @ S over the blocks of each output block column
// (Blocks: BcsrBlocks<T> or BandBlocks<T>, T the io type of x, S and y).
// An empty segment writes zeros. x may
// sit on its own block grid (N != n_cols); its columns past N read as
// zero. vec_x: x rows staged by 16-byte copies (N % 4 == 0, x aligned);
// vec_y: 16-byte stores (n_cols % 4 == 0, y aligned).
// Grid (n_cols / 64, R / 128), dynamic shared memory bcsr_smem_bytes(128).
template <class Blocks, class T = typename Blocks::io>
__global__ void __launch_bounds__(kCsrThreads, 2)
bcsr_matmul_kernel(const T* __restrict__ x, const Blocks blk,
                   T* __restrict__ y, int R, int N, int n_cols, int bs,
                   int vec_x, int vec_y) {
  extern __shared__ __align__(16) float smem[];
  const int c0 = blockIdx.x * kCsrBN;
  const int r0 = blockIdx.y * kCsrBM;
  const int j = c0 / bs, lc = c0 % bs;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int seg0 = blk.first(j);
  const int per_block = bs / kCsrBK;
  const int n_steps = blk.count(j) * per_block;
  // K-step s: block seg0 + s / per_block, depth (s % per_block) * kCsrBK
  auto stage = [&](int s) {
    float* As = smem + (s % kCsrStages) * kCsrStage;
    const int kb = seg0 + s / per_block, kd = (s % per_block) * kCsrBK;
    stage_x<kCsrBM, kCsrBK, kCsrThreads>(As, kCsrLDA, x, R, N, r0,
                                         blk.x_block(j, kb) * bs + kd, vec_x);
    stage_s<kCsrBK, kCsrBN, kCsrThreads>(As + kCsrBM * kCsrLDA,
                                         blk.block(j, kb), bs, kd, lc);
  };
  float acc[8][4] = {};
#pragma unroll
  for (int s = 0; s < kCsrStages - 1; ++s) {
    if (s < n_steps) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kCsrStages - 2>();
    // step s has landed for every thread, and every thread is done with
    // step s - 1, whose buffer the next stage refills
    __syncthreads();
    if (s + kCsrStages - 1 < n_steps) stage(s + kCsrStages - 1);
    cp_async_commit();
    const float* As = smem + (s % kCsrStages) * kCsrStage;
    mac_rows<8, kCsrBK>(acc, As + ty * kCsrLDA, 16 * kCsrLDA,
                        As + kCsrBM * kCsrLDA + 4 * tx, kCsrBN);
  }
  const int gc = c0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = r0 + ty + 16 * i;
    if (gr >= R) continue;
    T* d = y + (int64_t)gr * n_cols + gc;
    if (vec_y && gc + 4 <= n_cols) {
      store4(d, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (gc + t < n_cols) d[t] = from_f32<T>(acc[i][t]);
    }
  }
}

// bcsr_matmul_kernel's function for R <= BM <= 64 rows: BM x 16 output
// tiles, so that few rows still make n_cols / 16 blocks (256 at N = 4096),
// and each S block streams once, in 64-byte rows of 16 columns. Grid
// (n_cols / 16, R / BM), dynamic shared memory bcsr_smem_bytes(BM).
// At least 2 blocks an SM (at most 128 registers a thread).
template <int BM, class Blocks, class T = typename Blocks::io>
__global__ void __launch_bounds__(kCsrThreads, 2)
bcsr_narrow_kernel(const T* __restrict__ x, const Blocks blk,
                   T* __restrict__ y, int R, int N, int n_cols, int bs,
                   int vec_x) {
  constexpr int kRG = BM / 4;                       // row groups
  constexpr int kGroups = kCsrThreads / (kRG * 4);  // k-groups
  constexpr int kSub = kNarKD / kGroups;            // a group's depth a step
  constexpr int kStage = nar_stage(BM);
  extern __shared__ __align__(16) float smem[];
  const int c0 = blockIdx.x * kNarBN;
  const int r0 = blockIdx.y * BM;
  const int j = c0 / bs, lc = c0 % bs;
  const int tid = threadIdx.x;
  const int cg = tid % 4, rg = (tid / 4) % kRG, kg = tid / (4 * kRG);
  const int seg0 = blk.first(j);
  const int per_block = bs / kNarKD;
  const int n_steps = blk.count(j) * per_block;
  auto stage = [&](int s) {
    float* As = smem + (s % kNarStages) * kStage;
    const int kb = seg0 + s / per_block, kd = (s % per_block) * kNarKD;
    stage_x<BM, kNarKD, kCsrThreads>(As, kNarLDA, x, R, N, r0,
                                     blk.x_block(j, kb) * bs + kd, vec_x);
    stage_s<kNarKD, kNarBN, kCsrThreads>(As + BM * kNarLDA, blk.block(j, kb),
                                         bs, kd, lc);
  };
  float acc[4][4] = {};
#pragma unroll
  for (int s = 0; s < kNarStages - 1; ++s) {
    if (s < n_steps) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kNarStages - 2>();
    __syncthreads();
    if (s + kNarStages - 1 < n_steps) stage(s + kNarStages - 1);
    cp_async_commit();
    const float* As = smem + (s % kNarStages) * kStage;
    mac_rows<4, kSub>(acc, As + rg * kNarLDA + kg * kSub, kRG * kNarLDA,
                      As + BM * kNarLDA + kg * kSub * kNarBN + 4 * cg,
                      kNarBN);
  }
  // the k-groups' partial tiles, added in group order
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the stages
  float* red = smem;  // [kg][row][column]
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(red + (kg * BM + rg + kRG * i) * kNarBN +
                               4 * cg) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  for (int e = tid; e < BM * kNarBN; e += kCsrThreads) {
    const int r = e / kNarBN, c = e % kNarBN;
    float sum = red[e];
    for (int g = 1; g < kGroups; ++g) sum += red[g * BM * kNarBN + e];
    if (r0 + r < R && c0 + c < n_cols)
      y[(int64_t)(r0 + r) * n_cols + c0 + c] = from_f32<T>(sum);
  }
}

// ---------------------------------------------------------------------------
// band_register_kernel
// ---------------------------------------------------------------------------

// Shared memory of one band_register block: the slab panel and two staged
// slices of TM * 16 rows x KD columns.
size_t register_smem_bytes(int w, int bs, int TM, int KD) {
  return sizeof(float) * ((size_t)(2 * w + 1) * bs * kPanel +
                          2 * (size_t)kRegRowThreads * TM * (KD + kAPad));
}

// Stage rows [r0, r0 + BM) x columns [c0, c0 + KD) of the tap z (R, N)
// into As (BM, KD + kAPad); rows past R and columns past N read as zero.
// kVec: 4 elements a copy (16-byte cp.async for f32; N % 4 == 0, aligned
// pointers), else element-wise ld.global.cg. z is a tap other blocks wrote
// in this launch: every form reads it from L2, never from a stale L1 line.
template <int BM, int KD, bool kVec, class T>
__device__ __forceinline__ void stage_slice(float* As,
                                            const T* __restrict__ z,
                                            int R, int N, int r0, int c0) {
  constexpr int lda = KD + kAPad;
  if (kVec) {
    for (int e = threadIdx.x; e < BM * KD / 4; e += kRegThreads) {
      const int r = e / (KD / 4), c = (e % (KD / 4)) * 4;
      const bool valid = r0 + r < R && c0 + c < N;
      stage4(As + r * lda + c,
             valid ? z + (int64_t)(r0 + r) * N + c0 + c : z, valid);
    }
  } else {
    for (int e = threadIdx.x; e < BM * KD; e += kRegThreads) {
      const int r = e / KD, c = e % KD;
      As[r * lda + c] =
          r0 + r < R && c0 + c < N
              ? to_f32(__ldcg(z + (int64_t)(r0 + r) * N + c0 + c))
              : 0.f;
    }
  }
}

// out (K, R, N) = [x, x S, ..., x S^(K-1)] in one launch.
//
// The TPU kernel keeps a whole row stripe in VMEM and walks its grid in
// order. Here the work of a tap is split into items (a kPanel-column panel
// of the output, a BM-row tile); the items are cut panel-major into
// gridDim.x contiguous runs, one a block, so a block meets one or two
// panels. A panel's output needs only the 2w+1 window blocks around its
// block column j: the block loads those (2w+1) bs x kPanel entries of the
// slab into shared memory once and keeps them for every tap (it reloads
// only when its run crosses into the next panel; the run is walked forward
// on odd taps and backward on even ones, so the panel loaded last in one
// tap is the first one used in the next). Per item it stages the previous
// tap's window, KD columns at a time, double buffered with cp.async, and
// accumulates a TM x 4 register tile over it in window order. Tap k reads
// tap k-1, which every block wrote: one grid-wide barrier between taps
// (K-2 in all), so the launch must be cooperative. Window blocks off the
// matrix are skipped. Tap 0 is a copy of x.
template <int TM, int KD, bool kVec, class T>
__global__ void __launch_bounds__(kRegThreads)
band_register_kernel(const T* __restrict__ x, const T* __restrict__ s_band,
                     T* out, int R, int N, int nb, int w, int bs, int K) {
  constexpr int BM = kRegRowThreads * TM;
  constexpr int lda = KD + kAPad;
  extern __shared__ __align__(16) float smem[];
  const int W = 2 * w + 1;
  float* Sp = smem;                                // (W bs, kPanel)
  float* As = smem + (size_t)W * bs * kPanel;      // 2 x (BM, lda)
  const int tid = threadIdx.x;
  const int tx = tid % (kPanel / kTN);
  const int ty = tid / (kPanel / kTN);
  const int64_t plane = (int64_t)R * N;

  // tap 0 is x itself
  const int64_t stride = (int64_t)gridDim.x * kRegThreads;
  if (kVec) {
    // 4 elements a copy
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t e = (int64_t)blockIdx.x * kRegThreads + tid; e < plane / 4;
         e += stride)
      o4[e] = x4[e];
  } else {
    for (int64_t e = (int64_t)blockIdx.x * kRegThreads + tid; e < plane;
         e += stride)
      out[e] = x[e];
  }

  const int n_rt = cdiv(R, BM);
  const int64_t items = (int64_t)cdiv(N, kPanel) * n_rt;
  const int64_t i0 = items * blockIdx.x / gridDim.x;
  const int64_t i1 = items * (blockIdx.x + 1) / gridDim.x;
  const int per_block = bs / KD;  // slices of one window block
  int loaded = -1;  // the panel whose slab columns sit in Sp
  for (int k = 1; k < K; ++k) {
    if (k >= 2) cg::this_grid().sync();  // tap k-1 complete everywhere
    const T* src = k == 1 ? x : out + (k - 1) * plane;
    T* dst = out + k * plane;
    for (int64_t n = 0; n < i1 - i0; ++n) {
      const int64_t it = k % 2 ? i0 + n : i1 - 1 - n;
      const int p = (int)(it / n_rt);
      const int r0 = (int)(it % n_rt) * BM;
      const int c0 = p * kPanel;
      const int j = c0 / bs, lc = c0 % bs;
      const int t_lo = max(0, w - j), t_hi = min(W - 1, nb - 1 - j + w);
      if (p != loaded) {
        // the panel's slab rows; joins the first slice's group
        const T* sj = s_band + (int64_t)j * W * bs * bs + lc;
        const int rows = (t_hi - t_lo + 1) * bs;
        for (int e = tid; e < rows * (kPanel / 4); e += kRegThreads) {
          const int r = t_lo * bs + e / (kPanel / 4);
          const int c = (e % (kPanel / 4)) * 4;
          if (kVec) {
            stage4(Sp + r * kPanel + c, sj + (int64_t)r * bs + c, true);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              Sp[r * kPanel + c + q] = to_f32(sj[(int64_t)r * bs + c + q]);
          }
        }
        loaded = p;
      }
      // slice s: window block t_lo + s / per_block, depth offset
      // (s % per_block) * KD; the matching slab rows start at t bs + that
      const int n_slices = (t_hi - t_lo + 1) * per_block;
      const int xc0 = (j + t_lo - w) * bs;  // x column of slice 0
      float acc[TM][kTN] = {};
      stage_slice<BM, KD, kVec, T>(As, src, R, N, r0, xc0);
      cp_async_commit();
      for (int sl = 0; sl < n_slices; ++sl) {
        float* A = As + (sl & 1) * BM * lda;
        if (sl + 1 < n_slices)
          stage_slice<BM, KD, kVec, T>(As + ((sl + 1) & 1) * BM * lda, src,
                                       R, N, r0, xc0 + (sl + 1) * KD);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const float* B =
            Sp + ((int64_t)t_lo * bs + sl * KD) * kPanel + tx * kTN;
        const float* a0 = A + ty * lda;
#pragma unroll
        for (int kk = 0; kk < KD; kk += 4) {
          float4 a[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            a[i] = *reinterpret_cast<const float4*>(
                a0 + i * kRegRowThreads * lda + kk);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 b =
                *reinterpret_cast<const float4*>(B + (kk + q) * kPanel);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float av = q == 0 ? a[i].x
                               : q == 1 ? a[i].y
                               : q == 2 ? a[i].z
                                        : a[i].w;
              acc[i][0] = fmaf(av, b.x, acc[i][0]);
              acc[i][1] = fmaf(av, b.y, acc[i][1]);
              acc[i][2] = fmaf(av, b.z, acc[i][2]);
              acc[i][3] = fmaf(av, b.w, acc[i][3]);
            }
          }
        }
        __syncthreads();  // A is restaged two slices later
      }
      const int gc = c0 + tx * kTN;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int gr = r0 + ty + i * kRegRowThreads;
        if (gr >= R) continue;
        T* y = dst + (int64_t)gr * N + gc;
        if (kVec && gc + kTN <= N) {
          store4(y, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
          for (int q = 0; q < kTN; ++q)
            if (gc + q < N) y[q] = from_f32<T>(acc[i][q]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 instances: the same three functions on tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaKD = 64;   // a K-step's depth (bs % 64 == 0)
constexpr int kMmaPad = 8;   // bf16 after each staged row: row strides of an
                             // odd number of 16-byte units, so the 8 rows
                             // of an ldmatrix fall on distinct banks
constexpr int kMmaLDA = kMmaKD + kMmaPad;  // a staged x row, in bf16

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; register i holds matrix i, each lane two
// elements of a row (.trans: of a column).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16,
// column-major): each bf16 product exact, summed in f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's products over one k16 slice: acc[mi][ni], the 16 x 8 output
// tile at rows 16 mi and columns 8 ni of the warp's tile, += A (16 rows x
// k16; As at the warp's first row and the slice's first column, row stride
// kMmaLDA) times B (k16 x 8 columns; Bs at the slice's first row and the
// warp's first column, row stride LDB). A by ldmatrix (lanes 0-15 rows 0-15
// at k 0, lanes 16-31 at k 8: the a0..a3 of mma.m16n8k16), B by
// ldmatrix.trans of the row-major (k, n) tile (lanes 0-15 k 0-15 at n 0,
// lanes 16-31 at n 8: b0, b1 of two n8 tiles).
template <int MT, int NT8, int LDB>
__device__ __forceinline__ void mma_k16(float (&acc)[MT][NT8][4],
                                        const bf16* As, const bf16* Bs,
                                        int lane) {
  const int lr = lane % 16, lk = (lane / 16) * 8;
  unsigned a[MT][4], b[NT8 / 2][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
    ldsm_x4(a[mi], As + (mi * 16 + lr) * kMmaLDA + lk);
#pragma unroll
  for (int nj = 0; nj < NT8 / 2; ++nj)
    ldsm_x4_trans(b[nj], Bs + lr * LDB + nj * 16 + lk);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT8; ++ni)
      mma_bf16(acc[mi][ni], a[mi], b[ni / 2][2 * (ni % 2)],
               b[ni / 2][2 * (ni % 2) + 1]);
}

// Stage rows [r0, r0 + BM) x columns [xc, xc + 64) of x (R, N), bf16, into
// As (row stride kMmaLDA); rows past R and columns past N read as zero.
// vec: 8 elements a 16-byte cp.async.cg (N % 8 == 0, x 16-byte aligned),
// else one element a load through L2. The register's taps are written by
// other blocks of the launch: every form reads them from L2, never from a
// stale L1 line.
template <int BM, int NT>
__device__ __forceinline__ void stage_x_mma(bf16* As, const bf16* __restrict__ x,
                                            int R, int N, int r0, int xc,
                                            bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < BM * (kMmaKD / 8); e += NT) {
      const int r = e / (kMmaKD / 8), c = 8 * (e % (kMmaKD / 8));
      const bool ok = r0 + r < R && xc + c < N;
      cp_async16(As + r * kMmaLDA + c,
                 ok ? x + (int64_t)(r0 + r) * N + xc + c : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < BM * kMmaKD; e += NT) {
      const int r = e / kMmaKD, c = e % kMmaKD;
      As[r * kMmaLDA + c] =
          r0 + r < R && xc + c < N
              ? __ldcg(x + (int64_t)(r0 + r) * N + xc + c)
              : __ushort_as_bfloat16((unsigned short)0);
    }
  }
}

// Stage rows [kd, kd + 64) x columns [lc, lc + BN) of one (bs, bs) bf16
// block of S into Bs (row stride BN + kMmaPad), 8 elements a copy.
template <int BN, int NT>
__device__ __forceinline__ void stage_s_mma(bf16* Bs,
                                            const bf16* __restrict__ blk,
                                            int bs, int kd, int lc) {
  for (int e = threadIdx.x; e < kMmaKD * (BN / 8); e += NT) {
    const int r = e / (BN / 8), c = 8 * (e % (BN / 8));
    cp_async16(Bs + r * (BN + kMmaPad) + c,
               blk + (int64_t)(kd + r) * bs + lc + c, true);
  }
}

// y[row, col], y[row, col + 1] (col even, row < rows of y) rounded from f32
// to bf16: one 4-byte store (pair: ld even, y 4-byte aligned), else each
// of the two that lies inside [0, ld).
__device__ __forceinline__ void store_pair(bf16* y, int64_t ld, int row,
                                           int col, float a, float b,
                                           bool pair) {
  bf16* d = y + row * ld + col;
  if (pair) {
    if (col < ld) *reinterpret_cast<unsigned*>(d) = bf16_pair(a, b);
  } else {
    if (col < ld) d[0] = __float2bfloat16_rn(a);
    if (col + 1 < ld) d[1] = __float2bfloat16_rn(b);
  }
}

// One tile of the bf16 block mainloop: BM x BN outputs a block, warps WM x
// WN over the tile and WK over the four k16 slices of each 64-deep K-step
// (WK > 1: the warps' partial tiles added in warp order at the end), a
// ring of STAGES K-steps.
template <int BM, int BN, int WM, int WN, int WK, int STAGES, int MIN_BLOCKS>
struct MmaTile {
  static constexpr int kBM = BM, kBN = BN, kWM = WM, kWN = WN, kWK = WK;
  static constexpr int kStages = STAGES, kMinBlocks = MIN_BLOCKS;
  static constexpr int kThreads = 32 * WM * WN * WK;
  static constexpr int kLDB = BN + kMmaPad;
  static constexpr int kStage = BM * kMmaLDA + kMmaKD * kLDB;  // bf16
  static constexpr int kMT = BM / WM / 16, kNT8 = BN / WN / 8;
  static constexpr size_t kRing = sizeof(bf16) * (size_t)STAGES * kStage;
  static constexpr size_t kRed = WK > 1 ? sizeof(float) * (size_t)WK * BM * BN
                                        : 0;
  static constexpr size_t kSmem = kRing > kRed ? kRing : kRed;
};
// above kNarMaxRows rows: a whole 128-column block column of S (bs % 128
// == 0) or 64 columns (launch_mma picks); at most kNarMaxRows rows,
// BM x 16
using MmaWide = MmaTile<128, 128, 2, 4, 1, 3, 2>;
using MmaWide64 = MmaTile<128, 64, 4, 2, 1, 4, 2>;
template <int BM>
using MmaNarrow = MmaTile<BM, 16, 1, 1, 4, 4, 1>;

// y (R, n_cols) = x (R, N) @ S in bf16 over the blocks of each output block
// column (Blocks: BcsrBlocks<bf16> or BandBlocks<bf16>), f32 accumulators,
// y rounded once. An empty segment writes zeros; x's columns past N read
// as zero. vec_x: x staged by 16-byte copies (N % 8 == 0, x aligned);
// vec_y: 4-byte stores of two outputs (n_cols even, y 4-byte aligned).
// Grid (n_cols / BN, R / BM), dynamic shared memory Tile::kSmem.
template <class Tile, class Blocks>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
bcsr_mma_kernel(const bf16* __restrict__ x, const Blocks blk,
                bf16* __restrict__ y, int R, int N, int n_cols, int bs,
                int vec_x, int vec_y) {
  constexpr int BM = Tile::kBM, BN = Tile::kBN, WK = Tile::kWK;
  constexpr int NT = Tile::kThreads, STAGES = Tile::kStages;
  constexpr int MT = Tile::kMT, NT8 = Tile::kNT8, LDB = Tile::kLDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int c0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int j = c0 / bs, lc = c0 % bs;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wk = warp / (Tile::kWM * Tile::kWN);
  const int wm = warp / Tile::kWN % Tile::kWM, wn = warp % Tile::kWN;
  const int seg0 = blk.first(j);
  const int per_block = bs / kMmaKD;
  const int n_steps = blk.count(j) * per_block;
  // K-step s: block seg0 + s / per_block, depth (s % per_block) * 64
  auto stage = [&](int s) {
    bf16* As = smem + (s % STAGES) * Tile::kStage;
    const int kb = seg0 + s / per_block, kd = (s % per_block) * kMmaKD;
    stage_x_mma<BM, NT>(As, x, R, N, r0, blk.x_block(j, kb) * bs + kd,
                        vec_x);
    stage_s_mma<BN, NT>(As + BM * kMmaLDA, blk.block(j, kb), bs, kd, lc);
  };
  float acc[MT][NT8][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<STAGES - 2>();
    // step s has landed for every thread, and every thread is done with
    // step s - 1, whose buffer the next stage refills
    __syncthreads();
    if (s + STAGES - 1 < n_steps) stage(s + STAGES - 1);
    cp_async_commit();
    const bf16* As = smem + (s % STAGES) * Tile::kStage;
#pragma unroll
    for (int q = 0; q < kMmaKD / 16 / WK; ++q) {
      const int kk = 16 * (wk + q * WK);
      mma_k16<MT, NT8, LDB>(acc, As + wm * MT * 16 * kMmaLDA + kk,
                            As + BM * kMmaLDA + kk * LDB + wn * NT8 * 8,
                            lane);
    }
  }
  const int g = lane / 4, t = lane % 4;
  if constexpr (WK == 1) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT8; ++ni) {
        const int row = r0 + (wm * MT + mi) * 16 + g;
        const int col = c0 + (wn * NT8 + ni) * 8 + 2 * t;
        if (row < R)
          store_pair(y, n_cols, row, col, acc[mi][ni][0], acc[mi][ni][1],
                     vec_y);
        if (row + 8 < R)
          store_pair(y, n_cols, row + 8, col, acc[mi][ni][2], acc[mi][ni][3],
                     vec_y);
      }
  } else {
    // the warps' partial tiles, added in warp order
    cp_async_wait<0>();
    __syncthreads();  // every thread is done with the stages
    float* red = reinterpret_cast<float*>(smem_raw);  // [wk][row][column]
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT8; ++ni) {
        float* d = red + (wk * BM + (wm * MT + mi) * 16 + g) * BN +
                   (wn * NT8 + ni) * 8 + 2 * t;
        d[0] = acc[mi][ni][0];
        d[1] = acc[mi][ni][1];
        d[8 * BN] = acc[mi][ni][2];
        d[8 * BN + 1] = acc[mi][ni][3];
      }
    __syncthreads();
    for (int e = threadIdx.x; e < BM * BN; e += NT) {
      const int r = e / BN, c = e % BN;
      float sum = red[e];
#pragma unroll
      for (int q = 1; q < WK; ++q) sum += red[q * BM * BN + e];
      if (r0 + r < R && c0 + c < n_cols)
        y[(int64_t)(r0 + r) * n_cols + c0 + c] = __float2bfloat16_rn(sum);
    }
  }
}

// The bf16 register's tiles: BM-row items under a PW-column slab panel,
// warps WM x WN over the item, a ring of STAGES 64-deep slices of the
// previous tap.
template <int BM, int PW, int WM, int WN, int STAGES>
struct RegTile {
  static constexpr int kBM = BM, kPW = PW, kWM = WM, kWN = WN;
  static constexpr int kStages = STAGES;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kLDP = PW + kMmaPad;
  static constexpr int kMT = BM / WM / 16, kNT8 = PW / WN / 8;
  // shared memory: the (2w+1) bs x PW panel and the ring
  static size_t smem(int w, int bs) {
    return sizeof(bf16) * ((size_t)(2 * w + 1) * bs * kLDP +
                           (size_t)STAGES * BM * kMmaLDA);
  }
};
// at most kRegWideRows rows: 32-row items under 32-column panels, so that
// few rows still spread over many blocks; above, 128-row items under a
// 64-column panel where it fits, else a 32-column one (the fallback: it
// fits wherever the f32 kernel's wide tile fits). A 128-column panel reads
// each window of the previous tap from L2 half as often, but holds one
// block an SM: on an H100 it ran 6% slower at R = 2048 and 29% at R = 256
// than the 64-column one at two blocks an SM (a 16-warp block 7% and 37%;
// experiments/torch_bf16_tiles.py).
using RegNarrow = RegTile<32, 32, 2, 2, 4>;
using RegWide = RegTile<128, 64, 4, 2, 3>;
using RegWide32 = RegTile<128, 32, 4, 2, 2>;

// out (K, R, N) = [x, x S, ..., x S^(K-1)] in bf16 in one launch: the work
// of band_register_kernel (items, runs, the resident panel, the grid
// barrier between taps, the walk that alternates direction) on tensor
// cores. Each tap is written in bf16 before the next reads it (the JAX
// kernel's io-dtype zbuf). The block's slices of a tap are one stream, in
// item order, staged STAGES - 1 ahead of their use, so the ring runs on
// across the block's items; a new panel is loaded when the stream's user
// reaches its first item (after the barrier that ends the last use of the
// old one). kVec: N % 8 == 0 and 16-byte aligned pointers (16-byte copies
// of x, the panel and the slices; 4-byte stores of two outputs), else
// element-wise.
template <class Tile, bool kVec>
__global__ void __launch_bounds__(Tile::kThreads, 1)
band_register_mma_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ s_band, bf16* out, int R,
                         int N, int nb, int w, int bs, int K) {
  constexpr int BM = Tile::kBM, PW = Tile::kPW, NT = Tile::kThreads;
  constexpr int LDP = Tile::kLDP, MT = Tile::kMT, NT8 = Tile::kNT8;
  constexpr int STAGES = Tile::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = 2 * w + 1;
  bf16* Sp = reinterpret_cast<bf16*>(smem_raw);   // (W bs, LDP)
  bf16* ring = Sp + (size_t)W * bs * LDP;         // STAGES x (BM, kMmaLDA)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / Tile::kWN, wn = warp % Tile::kWN;
  const int64_t plane = (int64_t)R * N;

  // tap 0 is x itself
  const int64_t stride = (int64_t)gridDim.x * NT;
  if (kVec) {
    // 8 elements a copy
    const uint4* x8 = reinterpret_cast<const uint4*>(x);
    uint4* o8 = reinterpret_cast<uint4*>(out);
    for (int64_t e = (int64_t)blockIdx.x * NT + tid; e < plane / 8;
         e += stride)
      o8[e] = x8[e];
  } else {
    for (int64_t e = (int64_t)blockIdx.x * NT + tid; e < plane; e += stride)
      out[e] = x[e];
  }

  const int n_rt = cdiv(R, BM);
  const int64_t items = (int64_t)cdiv(N, PW) * n_rt;
  const int64_t i0 = items * blockIdx.x / gridDim.x;
  const int64_t i1 = items * (blockIdx.x + 1) / gridDim.x;
  const int64_t n_items = i1 - i0;
  const int per_block = bs / kMmaKD;  // slices of one window block
  int loaded = -1;  // the panel whose slab columns sit in Sp
  for (int k = 1; k < K; ++k) {
    if (k >= 2) cg::this_grid().sync();  // tap k-1 complete everywhere
    const bf16* src = k == 1 ? x : out + (k - 1) * plane;
    bf16* dst = out + k * plane;
    // item n of the run: rows r0.., panel p (block column j), window blocks
    // t_lo .. t_hi inside the matrix
    auto at = [&](int64_t n, int& p, int& r0, int& j, int& t_lo,
                  int& t_hi) {
      const int64_t it = k % 2 ? i0 + n : i1 - 1 - n;
      p = (int)(it / n_rt);
      r0 = (int)(it % n_rt) * BM;
      j = p * PW / bs;
      t_lo = max(0, w - j);
      t_hi = min(W - 1, nb - 1 - j + w);
    };
    // the stream's next slice to stage: slice psl of item pn, whose rows
    // start at pr0 and whose x columns at pxc; pns slices in that item
    int64_t pn = 0;
    int psl = 0, pr0 = 0, pxc = 0, pns = 0, slot = 0;
    auto fetch = [&]() {
      if (pn < n_items) {
        int p, j, t_lo, t_hi;
        at(pn, p, pr0, j, t_lo, t_hi);
        pxc = (j + t_lo - w) * bs;
        pns = (t_hi - t_lo + 1) * per_block;
      }
    };
    auto issue = [&]() {
      if (pn < n_items) {
        stage_x_mma<BM, NT>(ring + (slot % STAGES) * BM * kMmaLDA, src, R, N,
                            pr0, pxc + psl * kMmaKD, kVec);
        if (++psl == pns) {
          psl = 0;
          ++pn;
          fetch();
        }
      }
      ++slot;
      cp_async_commit();
    };
    fetch();
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue();
    int use = 0;  // the ring slot of the slice in use
    for (int64_t n = 0; n < n_items; ++n) {
      int p, r0, j, t_lo, t_hi;
      at(n, p, r0, j, t_lo, t_hi);
      const int n_slices = (t_hi - t_lo + 1) * per_block;
      float acc[MT][NT8][4] = {};
      for (int sl = 0; sl < n_slices; ++sl, ++use) {
        cp_async_wait<STAGES - 2>();
        // slice `use` has landed for every thread, and every thread is done
        // with slice use - 1 (whose slot the next issue refills) and with
        // the panel
        __syncthreads();
        issue();
        if (p != loaded) {
          // the panel's slab rows (only at sl == 0)
          const int lc = p * PW % bs;
          const bf16* sj = s_band + (int64_t)j * W * bs * bs + lc;
          const int rows = (t_hi - t_lo + 1) * bs;
          if (kVec) {
            for (int e = tid; e < rows * (PW / 8); e += NT) {
              const int r = t_lo * bs + e / (PW / 8), c = 8 * (e % (PW / 8));
              cp_async16(Sp + r * LDP + c, sj + (int64_t)r * bs + c, true);
            }
          } else {
            for (int e = tid; e < rows * PW; e += NT) {
              const int r = t_lo * bs + e / PW, c = e % PW;
              Sp[r * LDP + c] = sj[(int64_t)r * bs + c];
            }
          }
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          loaded = p;
        }
        const bf16* A =
            ring + (use % STAGES) * BM * kMmaLDA + wm * MT * 16 * kMmaLDA;
        const bf16* B =
            Sp + (t_lo * bs + sl * kMmaKD) * LDP + wn * NT8 * 8;
#pragma unroll
        for (int kk = 0; kk < kMmaKD; kk += 16)
          mma_k16<MT, NT8, LDP>(acc, A + kk, B + kk * LDP, lane);
      }
      const int g = lane / 4, t = lane % 4;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT8; ++ni) {
          const int row = r0 + (wm * MT + mi) * 16 + g;
          const int col = p * PW + (wn * NT8 + ni) * 8 + 2 * t;
          if (row < R)
            store_pair(dst, N, row, col, acc[mi][ni][0], acc[mi][ni][1],
                       kVec);
          if (row + 8 < R)
            store_pair(dst, N, row + 8, col, acc[mi][ni][2], acc[mi][ni][3],
                       kVec);
        }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The wide tile above kNarMaxRows rows, else the narrow one of the fewest
// rows (16, 32 or 64) that holds R: a dispatch on the shape. The blocks
// (S) are staged by 16-byte copies, so they must be 16-byte aligned.
template <class Blocks, class T = typename Blocks::io>
cudaError_t launch_mainloop(const T* x, const Blocks& blk, T* y, int R,
                            int N, int n_cols, int bs, cudaStream_t stream) {
  if (bs % kNarKD != 0 || R <= 0 || n_cols <= 0 || N < 0)
    return cudaErrorInvalidValue;
  if (!aligned16(blk.block(0, 0))) return cudaErrorMisalignedAddress;
  const int vec_x = N % 4 == 0 && aligned16(x);
  const int vec_y = n_cols % 4 == 0 && aligned16(y);
  const int BM = R > kNarMaxRows ? kCsrBM : R > 32 ? 64 : R > 16 ? 32 : 16;
  const void* fn = BM == kCsrBM ? (const void*)bcsr_matmul_kernel<Blocks>
                   : BM == 64   ? (const void*)bcsr_narrow_kernel<64, Blocks>
                   : BM == 32   ? (const void*)bcsr_narrow_kernel<32, Blocks>
                                : (const void*)bcsr_narrow_kernel<16, Blocks>;
  const size_t smem = bcsr_smem_bytes(BM);
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(n_cols, BM == kCsrBM ? kCsrBN : kNarBN), cdiv(R, BM));
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  if (BM == kCsrBM)
    bcsr_matmul_kernel<Blocks><<<grid, kCsrThreads, smem, stream>>>(
        x, blk, y, R, N, n_cols, bs, vec_x, vec_y);
  else if (BM == 64)
    bcsr_narrow_kernel<64, Blocks><<<grid, kCsrThreads, smem, stream>>>(
        x, blk, y, R, N, n_cols, bs, vec_x);
  else if (BM == 32)
    bcsr_narrow_kernel<32, Blocks><<<grid, kCsrThreads, smem, stream>>>(
        x, blk, y, R, N, n_cols, bs, vec_x);
  else
    bcsr_narrow_kernel<16, Blocks><<<grid, kCsrThreads, smem, stream>>>(
        x, blk, y, R, N, n_cols, bs, vec_x);
  return cudaGetLastError();
}

template <int TM, int KD, class T>
const void* register_kernel(bool vec) {
  return vec ? (const void*)band_register_kernel<TM, KD, true, T>
             : (const void*)band_register_kernel<TM, KD, false, T>;
}

// The file's kernels by name (gnt_spmm_kernel): the f32 instances, then
// the bf16 ones (each name ends in ", bf16>"); each with the dynamic shared
// memory a block of it takes on a layout of bandwidth w and block size bs
// (gnt_spmm_smem_bytes).
struct NamedKernel {
  const char* name;
  const void* fn;
  size_t (*smem)(int w, int bs);
};
#define GNT_REGISTER(TM, KD, V)                                          \
  {"band_register_kernel<" #TM ", " #KD ", " #V ">",                     \
   (const void*)band_register_kernel<TM, KD, V, float>,                  \
   [](int w, int bs) { return register_smem_bytes(w, bs, TM, KD); }}
#define GNT_NARROW(BM, B)                                                \
  {"bcsr_narrow_kernel<" #BM ", " #B ">",                                \
   (const void*)bcsr_narrow_kernel<BM, B<float>>,                        \
   [](int, int) { return bcsr_smem_bytes(BM); }}
#define GNT_MAINLOOP(B)                                                  \
  {"bcsr_matmul_kernel<" #B ">", (const void*)bcsr_matmul_kernel<B<float>>, \
   [](int, int) { return bcsr_smem_bytes(kCsrBM); }},                    \
  GNT_NARROW(16, B), GNT_NARROW(32, B), GNT_NARROW(64, B)
#define GNT_MMA(TILE, NAME, B)                                           \
  {"bcsr_mma_kernel<" NAME ", " #B ", bf16>",                            \
   (const void*)bcsr_mma_kernel<TILE, B<bf16>>,                          \
   [](int, int) { return TILE::kSmem; }}
#define GNT_MMA_ALL(B)                                                   \
  GNT_MMA(MmaWide, "128 x 128", B), GNT_MMA(MmaWide64, "128 x 64", B),   \
  GNT_MMA(MmaNarrow<16>, "16 x 16", B),                                  \
  GNT_MMA(MmaNarrow<32>, "32 x 16", B),                                  \
  GNT_MMA(MmaNarrow<64>, "64 x 16", B)
#define GNT_REGISTER_MMA(TILE, NAME, V)                                  \
  {"band_register_mma_kernel<" NAME ", " #V ", bf16>",                   \
   (const void*)band_register_mma_kernel<TILE, V>,                       \
   [](int w, int bs) { return TILE::smem(w, bs); }}
const NamedKernel kKernels[] = {
    GNT_MAINLOOP(BcsrBlocks),
    GNT_MAINLOOP(BandBlocks),
    GNT_REGISTER(kNarrowTM, kNarrowKD, true),
    GNT_REGISTER(kNarrowTM, kNarrowKD, false),
    GNT_REGISTER(kWideTM, kWideKD, true),
    GNT_REGISTER(kWideTM, kWideKD, false),
    GNT_MMA_ALL(BcsrBlocks),
    GNT_MMA_ALL(BandBlocks),
    GNT_REGISTER_MMA(RegNarrow, "32 x 32", true),
    GNT_REGISTER_MMA(RegNarrow, "32 x 32", false),
    GNT_REGISTER_MMA(RegWide, "128 x 64", true),
    GNT_REGISTER_MMA(RegWide, "128 x 64", false),
    GNT_REGISTER_MMA(RegWide32, "128 x 32", true),
    GNT_REGISTER_MMA(RegWide32, "128 x 32", false),
};
#undef GNT_NARROW
#undef GNT_REGISTER
#undef GNT_MMA_ALL
#undef GNT_MMA
#undef GNT_REGISTER_MMA
#undef GNT_MAINLOOP

cudaError_t launch_band_matmul(const float* x, const float* s_band, float* y,
                               int R, int N, int n_cols, int nb, int w,
                               int bs, cudaStream_t stream) {
  if (w < 0 || nb != cdiv(n_cols, bs)) return cudaErrorInvalidValue;
  return launch_mainloop(x, BandBlocks<float>{s_band, nb, w, bs}, y, R, N,
                         n_cols, bs, stream);
}

// A cooperative launch of as many blocks as there are items, at most as
// many as the card holds at once (the occupancy query, after the shared
// memory opt-in); refused launches are returned, never worked around.
cudaError_t launch_register(const float* x, const float* s_band, float* out,
                            int R, int N, int nb, int w, int bs, int K,
                            cudaStream_t stream) {
  if (bs % kBN != 0 || R <= 0 || N <= 0 || K < 1 || w < 0)
    return cudaErrorInvalidValue;
  // the wide tile (whose slices are the larger) must fit whatever R is, so
  // that whether a layout runs never depends on R; ops/spmm.py:
  // register_fits is the same rule
  if (register_smem_bytes(w, bs, kWideTM, kWideKD) > kMaxSmem)
    return cudaErrorInvalidValue;
  const bool vec = N % 4 == 0 && aligned16(x) && aligned16(s_band) &&
                   aligned16(out);
  const bool wide = R > kRegWideRows;
  const int BM = kRegRowThreads * (wide ? kWideTM : kNarrowTM);
  const size_t smem = wide ? register_smem_bytes(w, bs, kWideTM, kWideKD)
                           : register_smem_bytes(w, bs, kNarrowTM, kNarrowKD);
  const void* fn = wide ? register_kernel<kWideTM, kWideKD, float>(vec)
                        : register_kernel<kNarrowTM, kNarrowKD, float>(vec);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      kRegThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t items = (int64_t)cdiv(N, kPanel) * cdiv(R, BM);
  const int grid = (int)(items < (int64_t)per_sm * sms
                             ? items : (int64_t)per_sm * sms);
  void* args[] = {(void*)&x, (void*)&s_band, (void*)&out, (void*)&R,
                  (void*)&N, (void*)&nb, (void*)&w, (void*)&bs, (void*)&K};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kRegThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The bf16 mainloop: the wide tile above kNarMaxRows rows, else the narrow
// one of the fewest rows (16, 32 or 64) that holds R. The wide tile is 128
// columns (one whole block column of S: each x window is read from L2 once
// for every 128 output columns) when bs % 128 == 0 and that makes at least
// one block for every two SMs, else 64 columns, twice the blocks: on an
// H100 at N = 4096 the 128-column tile took 19% less time at R = 2048 and
// 25% more at R = 256, where its 64 blocks left half the SMs idle
// (experiments/torch_bf16_tiles.py). It takes
// every shape the f32 launcher takes and refuses the same ones with the
// same errors; x goes by 16-byte copies when N % 8 == 0 and x is aligned,
// else element by element.
template <class Tile, class Blocks>
cudaError_t run_mma(const bf16* x, const Blocks& blk, bf16* y, int R, int N,
                    int n_cols, int bs, int vec_x, int vec_y,
                    cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)bcsr_mma_kernel<Tile, Blocks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(n_cols, Tile::kBN), cdiv(R, Tile::kBM));
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  bcsr_mma_kernel<Tile, Blocks><<<grid, Tile::kThreads, Tile::kSmem,
                                  stream>>>(x, blk, y, R, N, n_cols, bs,
                                            vec_x, vec_y);
  return cudaGetLastError();
}

template <class Blocks>
cudaError_t launch_mma(const bf16* x, const Blocks& blk, bf16* y, int R,
                       int N, int n_cols, int bs, cudaStream_t stream) {
  if (bs % kMmaKD != 0 || R <= 0 || n_cols <= 0 || N < 0)
    return cudaErrorInvalidValue;
  if (!aligned16(blk.block(0, 0))) return cudaErrorMisalignedAddress;
  const int vec_x = N % 8 == 0 && aligned16(x);
  const int vec_y = n_cols % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 4 == 0;
  if (R > kNarMaxRows) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int64_t blocks128 =
        (int64_t)cdiv(n_cols, MmaWide::kBN) * cdiv(R, MmaWide::kBM);
    return bs % MmaWide::kBN == 0 && 2 * blocks128 >= sms
               ? run_mma<MmaWide>(x, blk, y, R, N, n_cols, bs, vec_x, vec_y,
                                  stream)
               : run_mma<MmaWide64>(x, blk, y, R, N, n_cols, bs, vec_x,
                                    vec_y, stream);
  }
  if (R > 32)
    return run_mma<MmaNarrow<64>>(x, blk, y, R, N, n_cols, bs, vec_x, vec_y,
                                  stream);
  if (R > 16)
    return run_mma<MmaNarrow<32>>(x, blk, y, R, N, n_cols, bs, vec_x, vec_y,
                                  stream);
  return run_mma<MmaNarrow<16>>(x, blk, y, R, N, n_cols, bs, vec_x, vec_y,
                                stream);
}

// The bf16 register: a cooperative launch as the f32 one, of the tile the
// row count and the panel's fit pick. The fallback tile must fit whatever
// R is (ops/spmm.py: register_fits for bf16 is the same rule); it fits
// every layout the f32 kernel takes.
template <class Tile>
cudaError_t run_register_mma(const bf16* x, const bf16* s_band, bf16* out,
                             int R, int N, int nb, int w, int bs, int K,
                             bool vec, cudaStream_t stream) {
  const size_t smem = Tile::smem(w, bs);
  const void* fn = vec ? (const void*)band_register_mma_kernel<Tile, true>
                       : (const void*)band_register_mma_kernel<Tile, false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      Tile::kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t items =
      (int64_t)cdiv(N, Tile::kPW) * cdiv(R, Tile::kBM);
  const int grid = (int)(items < (int64_t)per_sm * sms
                             ? items : (int64_t)per_sm * sms);
  void* args[] = {(void*)&x, (void*)&s_band, (void*)&out, (void*)&R,
                  (void*)&N, (void*)&nb, (void*)&w, (void*)&bs, (void*)&K};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(Tile::kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_register(const bf16* x, const bf16* s_band, bf16* out,
                            int R, int N, int nb, int w, int bs, int K,
                            cudaStream_t stream) {
  if (bs % kBN != 0 || R <= 0 || N <= 0 || K < 1 || w < 0)
    return cudaErrorInvalidValue;
  if (RegWide32::smem(w, bs) > kMaxSmem) return cudaErrorInvalidValue;
  const bool vec = N % 8 == 0 && aligned16(x) && aligned16(s_band) &&
                   aligned16(out);
  if (R <= kRegWideRows)
    return run_register_mma<RegNarrow>(x, s_band, out, R, N, nb, w, bs, K,
                                       vec, stream);
  if (RegWide::smem(w, bs) <= kMaxSmem)
    return run_register_mma<RegWide>(x, s_band, out, R, N, nb, w, bs, K, vec,
                                     stream);
  return run_register_mma<RegWide32>(x, s_band, out, R, N, nb, w, bs, K, vec,
                                     stream);
}

}  // namespace

extern "C" {

const char* gnt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Kernel i of this file and its name, or null past the last. Each source
// has such a table (gnt_attention_kernel, gnt_gridwin_kernel).
const void* gnt_spmm_kernel(int i, const char** name) {
  if (i < 0 || i >= (int)(sizeof(kKernels) / sizeof(kKernels[0])))
    return nullptr;
  *name = kKernels[i].name;
  return kKernels[i].fn;
}

// The dynamic shared memory of kernel i of gnt_spmm_kernel's table a block
// takes on a layout of bandwidth w and block size bs, or -1 past the last.
int gnt_spmm_smem_bytes(int i, int w, int bs) {
  if (i < 0 || i >= (int)(sizeof(kKernels) / sizeof(kKernels[0]))) return -1;
  return (int)kKernels[i].smem(w, bs);
}

// numRegs, localSizeBytes, sharedSizeBytes and maxThreadsPerBlock of a
// kernel of the library (from a gnt_*_kernel table), from
// cudaFuncGetAttributes.
cudaError_t gnt_kernel_attributes(const void* fn, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = fa.maxThreadsPerBlock;
  return cudaSuccess;
}

// y = x @ S on the BCSR blocks; the _bf16 entries take bf16 x, S and y.
cudaError_t gnt_bcsr_matmul(const float* x, const float* blocks,
                            const int* block_row, const int* col_start,
                            float* y, int R, int N, int n_cols, int bs,
                            cudaStream_t stream) {
  return launch_mainloop(
      x, BcsrBlocks<float>{blocks, block_row, col_start, bs}, y, R, N,
      n_cols, bs, stream);
}

cudaError_t gnt_bcsr_matmul_bf16(const bf16* x, const bf16* blocks,
                                 const int* block_row, const int* col_start,
                                 bf16* y, int R, int N, int n_cols, int bs,
                                 cudaStream_t stream) {
  return launch_mma(x, BcsrBlocks<bf16>{blocks, block_row, col_start, bs},
                    y, R, N, n_cols, bs, stream);
}

// y = x @ S on the band slab s_band (nb, (2w+1) bs, bs), nb = n_cols / bs
// rounded up.
cudaError_t gnt_band_matmul(const float* x, const float* s_band, float* y,
                            int R, int N, int n_cols, int nb, int w, int bs,
                            cudaStream_t stream) {
  return launch_band_matmul(x, s_band, y, R, N, n_cols, nb, w, bs, stream);
}

cudaError_t gnt_band_matmul_bf16(const bf16* x, const bf16* s_band, bf16* y,
                                 int R, int N, int n_cols, int nb, int w,
                                 int bs, cudaStream_t stream) {
  if (w < 0 || nb != cdiv(n_cols, bs)) return cudaErrorInvalidValue;
  return launch_mma(x, BandBlocks<bf16>{s_band, nb, w, bs}, y, R, N, n_cols,
                    bs, stream);
}

// out (K, R, N) = [x, x S, ..., x S^(K-1)] in one cooperative launch.
cudaError_t gnt_band_register(const float* x, const float* s_band,
                              float* out, int R, int N, int nb, int w, int bs,
                              int K, cudaStream_t stream) {
  return launch_register(x, s_band, out, R, N, nb, w, bs, K, stream);
}

cudaError_t gnt_band_register_bf16(const bf16* x, const bf16* s_band,
                                   bf16* out, int R, int N, int nb, int w,
                                   int bs, int K, cudaStream_t stream) {
  return launch_register(x, s_band, out, R, N, nb, w, bs, K, stream);
}

}  // extern "C"
