// Hopper (sm_90a) kernels for flash banded graph attention, in true FP32.
//
// Two kernels, the counterparts of two Pallas kernels of the JAX package
// (graph_neural_networks_tpu/ops/attention_flash.py):
//
//   attn_stats_kernel  <- attention_flash.py:_stats_call (_make_stats_kernel)
//   attn_apply_kernel  <- attention_flash.py:_apply_call (_make_apply_kernel)
//
// The math (orientation of the reference GAT, graphML.py:713/807): for a
// signal row q, the score of the pair (row i, column j) is
//   e = LeakyReLU(a2[q, i] + a1[q, j]),  masked as e*m - (1-m)*1e12
// with m the 0/1 support of S+I. Stats normalise each ROW i over its column
// window (mask_row layout); apply produces each output COLUMN block j from
// the rows of its window (mask_col / slab_col layout):
//   alpha = exp(e - rowmax[i]) / max(rowsum[i], 1e-30) * m
//   y[q, f, j] = sum_i v[q, f, i] * alpha * (S[i, j] if with_s)
// alpha never exists in device memory. Both kernels compute the score with
// one device function (masked_score), with every rounding step spelled out
// (__fadd_rn & co.), so the apply kernel recomputes bit for bit the scores
// the stats kernel reduced. Window blocks that fall off the matrix are
// skipped: the JAX kernels clamp them onto zero-mask tiles, whose entries
// are -1e12 and add exactly 0 to every sum.
//
// What bounds them on an H100, at the served shape (Q = B*P = 16 signal
// rows, Np = 16384, ibs = 128, W = 2w+1 = 5, F = 32; Q*nb*W*ibs^2 = 1.7e8
// scores a call, of which 22% lie on the S+I support). A masked score adds
// exactly 0 to every max, sum and product, so the function itself needs
// only the support's exps and FMAs and is bound by its bytes (46 MB for
// stats, 155 MB for apply). These kernels compute every score of every
// window tile, and for that work they are bound by operations:
//  * stats: one expf a score (1.7e8; the SFU computes 16 exp2 a clock on
//    each of 132 SMs) against a 42 MB mask, so the special-function units
//    bound it before bytes. Design: one warp a row,
//    lanes across the window's columns (coalesced), two passes (max, then
//    the exp-sum) with warp shuffles; the row's mask is staged in shared
//    memory once and reused for every q, so the mask is read from memory
//    once per call, not Q times.
//  * apply: an FP32 product of 2*F flops a score (1.1e10 flops, 0.16 ms at
//    67 TFLOP/s) against ~155 MB of v, y, mask and slab (0.05 ms), so FP32
//    operations bound it. Design: one block per (q, 64-column tile),
//    q fastest in the grid; a 32-row step stages alpha*S (computed once,
//    used for all F rows) and the v chunk in shared memory, then each
//    thread runs a 4 x 4 micro-tile of FMAs. The mask and slab tiles are
//    shared by all Q rows: the blocks of one column tile run side by side,
//    so after the first the tiles come from L2 (50 MB), not from memory.
//    The scores cost ~30 instructions each (expf, an IEEE division) against
//    F = 32 FMAs, so this simple design stays well above the FMA bound.
// No TF32 wgmma and no --use_fast_math: the tolerances assume true f32.
//
// Every launcher has a plain C interface and returns the cudaError_t of the
// launch; the Python wrappers raise if it is not cudaSuccess.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kInfinite = 1e12f;  // the reference's additive -inf

// stats: rows a block, one warp each
constexpr int kStatsWarps = 8;
constexpr int kStatsThreads = 32 * kStatsWarps;

// apply: a block computes y[q, f0 : f0+kFT, c0 : c0+kCT], kP window rows a
// step, a kTF x kTC micro-tile a thread
constexpr int kCT = 64;  // ibs % kCT == 0
constexpr int kFT = 32;
constexpr int kP = 32;
constexpr int kTF = 4;
constexpr int kTC = 4;
constexpr int kApplyThreads = (kFT / kTF) * (kCT / kTC);
constexpr int kLDV = kFT + 4;  // Vs row stride: float4-aligned, fewer conflicts

__device__ __forceinline__ float masked_score(float a2, float a1, float m,
                                              float slope) {
  const float pre = __fadd_rn(a2, a1);
  const float e = pre >= 0.f ? pre : __fmul_rn(pre, slope);
  return __fsub_rn(__fmul_rn(e, m), __fmul_rn(__fsub_rn(1.f, m), kInfinite));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rowmax/rowsum (Q, Np) of the masked scores of every row over its column
// window. a1, a2 (Q, Np); mask_row (nb, W, ibs, ibs): mask_row[i, k, p, c]
// is the support at (row i*ibs+p, column (i+k-w)*ibs+c).
// Grid: Np / kStatsWarps blocks; dynamic shared memory kStatsWarps*W*ibs
// floats.
__global__ void __launch_bounds__(kStatsThreads)
attn_stats_kernel(const float* __restrict__ a1, const float* __restrict__ a2,
                  const float* __restrict__ mask_row,
                  float* __restrict__ rowmax, float* __restrict__ rowsum,
                  int Q, int Np, int nb, int w, int ibs, float slope) {
  extern __shared__ float mask_s[];
  const int W = 2 * w + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kStatsWarps + warp;
  const int i = row / ibs, p = row % ibs;
  const int k0 = max(0, w - i), k1 = min(W, nb + w - i);
  float* m_row = mask_s + warp * W * ibs;
  for (int k = k0; k < k1; ++k) {
    const float* src = mask_row + (((int64_t)i * W + k) * ibs + p) * ibs;
    for (int c = lane; c < ibs; c += 32) m_row[k * ibs + c] = src[c];
  }
  __syncwarp();
  for (int q = 0; q < Q; ++q) {
    const float* a1q = a1 + (int64_t)q * Np;
    const float a2v = a2[(int64_t)q * Np + row];
    float mx = -INFINITY;
    for (int k = k0; k < k1; ++k) {
      const float* a1k = a1q + (int64_t)(i + k - w) * ibs;
      for (int c = lane; c < ibs; c += 32)
        mx = fmaxf(mx, masked_score(a2v, a1k[c], m_row[k * ibs + c], slope));
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int k = k0; k < k1; ++k) {
      const float* a1k = a1q + (int64_t)(i + k - w) * ibs;
      for (int c = lane; c < ibs; c += 32)
        sum += expf(__fsub_rn(
            masked_score(a2v, a1k[c], m_row[k * ibs + c], slope), mx));
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      rowmax[(int64_t)q * Np + row] = mx;
      rowsum[(int64_t)q * Np + row] = sum;
    }
  }
}

// y (Q, F, Np) = v @ (alpha * S) on the band. v (Q, F, Np); a1, a2,
// rowmax, rowsum (Q, Np); slab_col, mask_col (nb, W, ibs, ibs):
// slab_col[j, k, p, c] = S[row (j+k-w)*ibs+p, column j*ibs+c].
// Grid: Q * (Np / kCT) blocks, q fastest.
__global__ void __launch_bounds__(kApplyThreads)
attn_apply_kernel(const float* __restrict__ a1, const float* __restrict__ a2,
                  const float* __restrict__ v,
                  const float* __restrict__ rowmax,
                  const float* __restrict__ rowsum,
                  const float* __restrict__ slab_col,
                  const float* __restrict__ mask_col, float* __restrict__ y,
                  int Q, int F, int Np, int nb, int w, int ibs, int with_s,
                  float slope) {
  __shared__ __align__(16) float Cs[kP * kCT];   // alpha (* S), [p][c]
  __shared__ __align__(16) float Vs[kP * kLDV];  // v chunk, [p][f]
  __shared__ float a1_s[kCT];
  __shared__ float a2_s[kP], mx_s[kP], sm_s[kP];
  const int W = 2 * w + 1;
  const int q = blockIdx.x % Q;
  const int c0 = (blockIdx.x / Q) * kCT;
  const int j = c0 / ibs, lc0 = c0 % ibs;
  const int tid = threadIdx.x;
  const int tx = tid % (kCT / kTC), ty = tid / (kCT / kTC);
  const int64_t qn = (int64_t)q * Np;
  const int k0 = max(0, w - j), k1 = min(W, nb + w - j);
  if (tid < kCT) a1_s[tid] = a1[qn + c0 + tid];

  for (int f0 = 0; f0 < F; f0 += kFT) {
    float acc[kTF][kTC] = {};
    for (int k = k0; k < k1; ++k) {
      const int r_blk = (j + k - w) * ibs;  // first row of the window block
      const int64_t tile = ((int64_t)j * W + k) * ibs * ibs + lc0;
      for (int p0 = 0; p0 < ibs; p0 += kP) {
        __syncthreads();  // the previous step's readers are done
        if (tid < kP) {
          const int64_t r = qn + r_blk + p0 + tid;
          a2_s[tid] = a2[r];
          mx_s[tid] = rowmax[r];
          sm_s[tid] = fmaxf(rowsum[r], 1e-30f);
        }
        for (int e = tid; e < kFT * kP; e += kApplyThreads) {
          const int f = e / kP, p = e % kP;
          Vs[p * kLDV + f] =
              f0 + f < F ? v[((int64_t)q * F + f0 + f) * Np + r_blk + p0 + p]
                         : 0.f;
        }
        __syncthreads();
        for (int e = tid; e < kP * kCT; e += kApplyThreads) {
          const int p = e / kCT, c = e % kCT;
          const int64_t off = tile + (int64_t)(p0 + p) * ibs + c;
          const float m = mask_col[off];
          const float s = masked_score(a2_s[p], a1_s[c], m, slope);
          float al = __fmul_rn(
              __fdiv_rn(expf(__fsub_rn(s, mx_s[p])), sm_s[p]), m);
          if (with_s) al = __fmul_rn(al, slab_col[off]);
          Cs[p * kCT + c] = al;
        }
        __syncthreads();
#pragma unroll 8
        for (int p = 0; p < kP; ++p) {
          const float4 av =
              *reinterpret_cast<const float4*>(&Vs[p * kLDV + ty * kTF]);
          const float4 bv =
              *reinterpret_cast<const float4*>(&Cs[p * kCT + tx * kTC]);
          const float a[kTF] = {av.x, av.y, av.z, av.w};
          const float b[kTC] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int u = 0; u < kTF; ++u)
#pragma unroll
            for (int t = 0; t < kTC; ++t) acc[u][t] = fmaf(a[u], b[t], acc[u][t]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kTF; ++u) {
      const int f = f0 + ty * kTF + u;
      if (f < F)
        *reinterpret_cast<float4*>(y + ((int64_t)q * F + f) * Np + c0 +
                                   tx * kTC) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    }
  }
}

}  // namespace

extern "C" {

cudaError_t gnt_attn_stats(const float* a1, const float* a2,
                           const float* mask_row, float* rowmax,
                           float* rowsum, int Q, int Np, int nb, int w,
                           int ibs, float slope, cudaStream_t stream) {
  if (Q <= 0 || ibs % kStatsWarps != 0 || Np != nb * ibs || w < 0)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kStatsWarps * (2 * w + 1) * ibs;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  attn_stats_kernel<<<Np / kStatsWarps, kStatsThreads, smem, stream>>>(
      a1, a2, mask_row, rowmax, rowsum, Q, Np, nb, w, ibs, slope);
  return cudaGetLastError();
}

cudaError_t gnt_attn_apply(const float* a1, const float* a2, const float* v,
                           const float* rowmax, const float* rowsum,
                           const float* slab_col, const float* mask_col,
                           float* y, int Q, int F, int Np, int nb, int w,
                           int ibs, int with_s, float slope,
                           cudaStream_t stream) {
  if (Q <= 0 || F <= 0 || ibs % kCT != 0 || Np != nb * ibs || w < 0)
    return cudaErrorInvalidValue;
  const long long blocks = (long long)Q * (Np / kCT);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  attn_apply_kernel<<<(unsigned)blocks, kApplyThreads, 0, stream>>>(
      a1, a2, v, rowmax, rowsum, slab_col, mask_col, y, Q, F, Np, nb, w, ibs,
      with_s, slope);
  return cudaGetLastError();
}

}  // extern "C"
