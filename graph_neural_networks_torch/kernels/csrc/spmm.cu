// Hopper (sm_90a) kernels for the graph shift y = x @ S, in true FP32.
//
// Each kernel has an instance for f32 io and one for bf16 io (template
// parameter T, float or __nv_bfloat16): the bf16 instance reads bf16 x and
// S, converts each element to f32 as it stages it into shared memory (the
// tiles in shared memory and every FMA stay f32; a product of two bf16
// values is exact in f32), and rounds to bf16 once, where it writes y (the
// JAX kernels' f32 accumulator, ops/spmm.py:144 and :617). The register
// kernel writes every tap in the io type before the next tap reads it, as
// the JAX kernel's io-dtype zbuf does (ops/spmm.py:423-425). The bf16
// staging is a plain load through L2 (8 bytes for 4 elements, 2 for one)
// stored converted, not a cp.async: cp.async copies bytes and cannot
// widen. So the bf16 instances do not overlap the next stage's loads with
// the current stage's FMAs; a tensor-core mainloop for them is a later
// redesign.
//
// Three kernels, each the counterpart of one Pallas kernel of the JAX
// package (graph_neural_networks_tpu/ops/spmm.py); band_matmul and
// bcsr_matmul run one mainloop on two block layouts:
//
//   bcsr_matmul_kernel<BandBlocks>, bcsr_narrow_kernel<., BandBlocks>
//                         <- spmm.py:band_matmul (_make_band_kernel)
//   bcsr_matmul_kernel<BcsrBlocks>, bcsr_narrow_kernel<., BcsrBlocks>
//                         <- spmm.py:bcsr_matmul (_make_bcsr_kernel)
//   band_register_kernel  <- spmm.py:band_shift_register (_make_fused_kernel)
//
// What bounds them on an H100: the JAX default for f32 signals is true f32
// (Precision.HIGHEST), so the products run as FP32 FMAs on the CUDA cores,
// not on TF32 tensor cores (no wgmma: it needs TF32 or lower, which would
// change the numbers the JAX reference produces). A band shift of an
// (R, N) signal executes 2 R N (2w+1) bs flops against
// 4 (2 R N + nb (2w+1) bs^2) bytes; at the serving shapes (R = 32 .. 2048,
// bs = 128, w = 1) that is 12 .. 90 flops a byte, above the ~20 flop/byte
// ridge of FP32 FMA (67 TFLOP/s over 3.35 TB/s) for the large R, so the
// big shifts are bound by FP32 operations. The register at few rows
// (R = 32) does 0.4 GFLOP in four dependent taps: it is bound by latency
// and by how many SMs it keeps busy.
//
// band_matmul and bcsr_matmul: y = x @ S over the blocks of each output
// block column. The band slab is a BCSR in disguise: column j's segment
// is the window blocks t that fall inside the matrix, block t at
// s_band[j, t bs : (t+1) bs], x block column j + t - w (BandBlocks); the
// BCSR segment is col_start[j] .. col_start[j+1], built once with the
// layout (BcsrBlocks). At R = 2048 rows (N = 4096, w = 1: 94 blocks) either
// does 6.3 GFLOP against 8.4 MB of blocks and 67 MB of x and y: bound by
// FP32 operations (0.094 ms); at R = 32 by the bytes of the blocks it
// must stream (6.2 MB, 2 us), and in practice by how many SMs the few
// rows keep busy. Two tiles, picked by R:
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
// padded buffer; the blocks by 16-byte copies.
//
// band_register_kernel: one cooperative launch of persistent blocks. Each
// block owns a 32-column panel of the output, keeps that panel's
// (2w+1) bs rows of the band slab resident in shared memory for all K-1
// taps, stages the previous tap's window with cp.async (double buffered),
// and a grid-wide barrier orders the taps (see the kernel).
//
// Every launcher has a plain C interface and returns the cudaError_t of the
// launch; the Python wrappers raise if it is not cudaSuccess.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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

// The io types: f32, or bf16 converted to f32 when staged and rounded
// (round to nearest even) when written.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// The low and high bf16 of a 32-bit word as floats, and two floats rounded
// to bf16 as one word (a at the lower address): whole-register moves, so
// nothing goes through local memory.
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(u & 0xffffu)));
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(u >> 16)));
}
__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// 4 consecutive bf16 (8 bytes, 8-byte aligned) read through L2, as floats
__device__ __forceinline__ float4 load4_cg(const bf16* p) {
  const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}

// 4 consecutive elements of the io type at p from 4 floats (16-byte
// aligned for f32, 8-byte for bf16)
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(a, b), bf16_pair(c, d));
}

// Stage 4 consecutive elements at src (or 4 zeros, nothing read, when
// !valid) as floats at dst (16-byte aligned shared memory). f32: one
// 16-byte cp.async, landed at the next cp_async_wait; bf16: an 8-byte load
// through L2, converted and stored at once.
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       bool valid) {
  cp_async16(dst, src, valid);
}
__device__ __forceinline__ void stage4(float* dst, const bf16* src,
                                       bool valid) {
  *reinterpret_cast<float4*>(dst) =
      valid ? load4_cg(src) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Stage one element likewise (f32: a 4-byte cp.async).
__device__ __forceinline__ void stage1(float* dst, const float* src,
                                       bool valid) {
  cp_async4(dst, src, valid);
}
__device__ __forceinline__ void stage1(float* dst, const bf16* src,
                                       bool valid) {
  *dst = valid ? __bfloat162float(__ldcg(src)) : 0.f;
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
// T: the io type of the blocks (that of x and y).
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
// At least 2 blocks an SM (at most 128 registers a thread): what the f32
// instances use; without it the bf16 instance at BM = 64 was given 64
// registers and spilled.
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
// matrix are skipped. Tap 0 is a copy of x. With bf16 io (T) the slab
// panel and the staged slices are converted to f32 in shared memory, and
// each tap is written in bf16: the next tap reads the rounded values.
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
    // 4 elements a copy: 16 bytes of f32, 8 of bf16
    using V4 = typename std::conditional<sizeof(T) == 4, float4, uint2>::type;
    const V4* x4 = reinterpret_cast<const V4*>(x);
    V4* o4 = reinterpret_cast<V4*>(out);
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

// The file's kernels by name (gnt_spmm_kernel); the f32 instances keep
// their names, the bf16 ones end in ", bf16>".
struct NamedKernel {
  const char* name;
  const void* fn;
};
#define GNT_REGISTER(TM, KD, V, T, SUFFIX)                      \
  {"band_register_kernel<" #TM ", " #KD ", " #V SUFFIX ">",     \
   (const void*)band_register_kernel<TM, KD, V, T>}
#define GNT_MAINLOOP(B, T, SUFFIX)                                         \
  {"bcsr_matmul_kernel<" #B SUFFIX ">",                                    \
   (const void*)bcsr_matmul_kernel<B<T>>},                                 \
  {"bcsr_narrow_kernel<16, " #B SUFFIX ">",                                \
   (const void*)bcsr_narrow_kernel<16, B<T>>},                             \
  {"bcsr_narrow_kernel<32, " #B SUFFIX ">",                                \
   (const void*)bcsr_narrow_kernel<32, B<T>>},                             \
  {"bcsr_narrow_kernel<64, " #B SUFFIX ">",                                \
   (const void*)bcsr_narrow_kernel<64, B<T>>}
const NamedKernel kKernels[] = {
    GNT_MAINLOOP(BcsrBlocks, float, ""),
    GNT_MAINLOOP(BandBlocks, float, ""),
    GNT_REGISTER(kNarrowTM, kNarrowKD, true, float, ""),
    GNT_REGISTER(kNarrowTM, kNarrowKD, false, float, ""),
    GNT_REGISTER(kWideTM, kWideKD, true, float, ""),
    GNT_REGISTER(kWideTM, kWideKD, false, float, ""),
    GNT_MAINLOOP(BcsrBlocks, bf16, ", bf16"),
    GNT_MAINLOOP(BandBlocks, bf16, ", bf16"),
    GNT_REGISTER(kNarrowTM, kNarrowKD, true, bf16, ", bf16"),
    GNT_REGISTER(kNarrowTM, kNarrowKD, false, bf16, ", bf16"),
    GNT_REGISTER(kWideTM, kWideKD, true, bf16, ", bf16"),
    GNT_REGISTER(kWideTM, kWideKD, false, bf16, ", bf16"),
};
#undef GNT_REGISTER
#undef GNT_MAINLOOP

template <class T>
cudaError_t launch_band_matmul(const T* x, const T* s_band, T* y, int R,
                               int N, int n_cols, int nb, int w, int bs,
                               cudaStream_t stream) {
  if (w < 0 || nb != cdiv(n_cols, bs)) return cudaErrorInvalidValue;
  return launch_mainloop(x, BandBlocks<T>{s_band, nb, w, bs}, y, R, N,
                         n_cols, bs, stream);
}

// A cooperative launch of as many blocks as there are items, at most as
// many as the card holds at once (the occupancy query, after the shared
// memory opt-in); refused launches are returned, never worked around.
template <class T>
cudaError_t launch_register(const T* x, const T* s_band, T* out, int R,
                            int N, int nb, int w, int bs, int K,
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
  const void* fn = wide ? register_kernel<kWideTM, kWideKD, T>(vec)
                        : register_kernel<kNarrowTM, kNarrowKD, T>(vec);
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
  return launch_mainloop(
      x, BcsrBlocks<bf16>{blocks, block_row, col_start, bs}, y, R, N,
      n_cols, bs, stream);
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
  return launch_band_matmul(x, s_band, y, R, N, n_cols, nb, w, bs, stream);
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
