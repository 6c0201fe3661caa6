// Hopper (sm_90a) kernels for flash banded graph attention, in true FP32.
//
// Three kernels, the counterparts of six Pallas calls of the JAX package
// (graph_neural_networks_tpu/ops/attention_flash.py):
//
//   attn_stats_kernel<false> <- attention_flash.py:_stats_call
//   attn_apply_kernel<false> <- attention_flash.py:_apply_call
//   attn_bwd_kernel<false>   <- attention_flash.py:_bwd_call
//   attn_stats_kernel<true>  <- attention_flash.py:_stats_ext_call
//   attn_apply_kernel<true>  <- attention_flash.py:_apply_ext_call
//   attn_bwd_kernel<true>    <- attention_flash.py:_bwd_ext_call
//
// The JAX package runs one kernel body (_make_stats_kernel,
// _make_apply_kernel, _make_bwd_kernel) for a global call and its ext
// call; only the index maps differ. Here the template parameter kExt picks
// the window addressing the same way:
//  * global (kExt = false): the operands are whole (Q, Np) rows; window
//    block k of block i is block i + k - w, and blocks off the matrix are
//    skipped.
//  * ext (kExt = true): the shard-local step of the node-sharded attention
//    (parallel/attention.py). The operands read through the window (a1 in
//    stats; a2, rowmax, rowsum and v in apply) are halo-extended: w extra
//    blocks a side, row length Np + 2*w*ibs, where Np is the shard's own
//    width. Window block k of own block i is ext block i + k, and all W
//    blocks are walked: past the global ends the halos are zero-filled
//    and the mask is 0 (the -1e12 entries add exactly 0; a fully masked
//    padded row sums W*ibs ones, as the JAX ext kernel does). The other
//    operands (a2 in stats; a1 and y in apply) keep the shard's own Np.
//    In bwd, g and a1 are read through the window (halo-extended); a2, v,
//    the stats and the outputs are the shard's own rows, and the da1
//    partials of window block k belong to ext column block i + k.
//    S in the row layout: the global bwd reads the shard-free column slab
//    at a mirrored index, slab_row[i, k] = slab_col[i + k - w, 2w - k].
//    For a shard's first and last w row blocks that index leaves the
//    shard's own column slab (their windows reach the neighbours'
//    columns), so the ext bwd reads a halo-extended column slab
//    (nb + 2w blocks, the neighbours' w edge blocks a side, zeros past
//    the global ends) at slab_col_ext[i + k, 2w - k]: 12.5% more than the
//    own slab at the served shape, where the JAX package keeps a second,
//    row-layout slab (_row_slabs) as large as the first.
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
//  * bwd: the flash backward of apply (the VJP of y in a1, a2 and v; S is
//    structure). Per row: recompute alpha, dalpha = (v^T dy) (* S), the
//    softmax VJP's row product delta = sum alpha * dalpha, then
//    de = alpha (dalpha - delta) and dpre = de * m * LeakyReLU'(pre), and
//    from those da2 = sum over columns of dpre, the da1 window partials =
//    sum over the row block's rows of dpre, dv = dy . coeff^T. On the S+I
//    support only (3.7e7 scores at the served shape) it needs one exp and
//    ~4F + 20 flops a score (2F for v^T dy, 2F for dv) against ~190 MB
//    (g, v, a1, a2, stats, mask, slab in; da2, partials, dv out), so FP32
//    operations bound it (~0.08 ms); over the dense window tiles it runs
//    it is 4.5x that. Design: one block per (q, row block i), q fastest in
//    the grid (the Q blocks of a row block share its mask and slab tiles
//    through L2); the block walks its ibs rows in tiles of kBRT = 16 rows
//    and each window tile in chunks of kBCC = 64 columns. Pass 1 forms
//    v^T dy for the 16 x 64 chunk as a shared-memory GEMM over F, turns
//    it into dalpha, keeps dalpha for the tile's whole window in shared
//    memory (W * 16 * ibs floats, 40 KB at w = 2) and sums delta; pass 2
//    recomputes alpha (cheaper than keeping it), forms dpre and the
//    coefficients, sums da1 partials per column in a fixed order, and
//    accumulates dv with a second small GEMM. The Pallas kernel keeps
//    alpha, dalpha, pre and m for a whole 128-row block (1.3 MB at w = 2);
//    a Hopper block has 227 KB, hence the row tiles. No cross-block sum:
//    the da1 partials (Q, nb, W, ibs) are folded outside, as in the JAX
//    package, so the result is deterministic without atomics. S in the
//    row-window layout is the column-layout slab at a mirrored index,
//    slab_row[i, k] = slab_col[i + k - w, 2w - k], read in place.
//  * stats, apply and bwd, ext: the same designs on one shard's own rows
//    or columns (Np = 4096 of 16384 at the served shape sharded 4 ways),
//    so the same bounds per shard, plus the 2*w*ibs halo columns the
//    window reaches into. Only the strides, the window's first block and
//    (bwd) the slab's row index differ. The ext bwd walks all W window
//    blocks; past the global ends they add exact zeros (zero halos, zero
//    mask and slab), so each shard's da2 and dv equal the global kernel's
//    rows bit for bit.
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

// bwd: a block owns one row block; kBRT rows a tile, kBCC columns a chunk,
// kBFT features a GEMM step. Thread (tp, tc): row tp of the tile, columns
// 4*tc .. 4*tc+3 of the chunk.
constexpr int kBRT = 16;
constexpr int kBCC = 64;  // ibs % kBCC == 0
constexpr int kBFT = 32;
constexpr int kBwdThreads = 256;
constexpr int kBU = kBRT * kBCC / kBwdThreads;  // chunk columns a thread: 4
constexpr int kLDC = kBCC + 1;                  // Cs row stride, no conflicts

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
// window. a1 (Q, Np), or (Q, Np + 2*w*ibs) halo-extended when kExt; a2
// (Q, Np); mask_row (nb, W, ibs, ibs): mask_row[i, k, p, c] is the support
// at (row i*ibs+p, column (i+k-w)*ibs+c) of the global matrix.
// Grid: Np / kStatsWarps blocks; dynamic shared memory kStatsWarps*W*ibs
// floats.
template <bool kExt>
__global__ void __launch_bounds__(kStatsThreads)
attn_stats_kernel(const float* __restrict__ a1, const float* __restrict__ a2,
                  const float* __restrict__ mask_row,
                  float* __restrict__ rowmax, float* __restrict__ rowsum,
                  int Q, int Np, int nb, int w, int ibs, float slope) {
  extern __shared__ float mask_s[];
  const int W = 2 * w + 1;
  const int a1_len = kExt ? Np + 2 * w * ibs : Np;  // a1's row length
  const int lag = kExt ? 0 : w;  // a1 block of window block k: i + k - lag
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kStatsWarps + warp;
  const int i = row / ibs, p = row % ibs;
  const int k0 = kExt ? 0 : max(0, w - i);
  const int k1 = kExt ? W : min(W, nb + w - i);
  float* m_row = mask_s + warp * W * ibs;
  for (int k = k0; k < k1; ++k) {
    const float* src = mask_row + (((int64_t)i * W + k) * ibs + p) * ibs;
    for (int c = lane; c < ibs; c += 32) m_row[k * ibs + c] = src[c];
  }
  __syncwarp();
  for (int q = 0; q < Q; ++q) {
    const float* a1q = a1 + (int64_t)q * a1_len;
    const float a2v = a2[(int64_t)q * Np + row];
    float mx = -INFINITY;
    for (int k = k0; k < k1; ++k) {
      const float* a1k = a1q + (int64_t)(i + k - lag) * ibs;
      for (int c = lane; c < ibs; c += 32)
        mx = fmaxf(mx, masked_score(a2v, a1k[c], m_row[k * ibs + c], slope));
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int k = k0; k < k1; ++k) {
      const float* a1k = a1q + (int64_t)(i + k - lag) * ibs;
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

// y (Q, F, Np) = v @ (alpha * S) on the band. a1 (Q, Np); v (Q, F, Np)
// and a2, rowmax, rowsum (Q, Np), or with rows of Np + 2*w*ibs
// (halo-extended) when kExt; slab_col, mask_col (nb, W, ibs, ibs):
// slab_col[j, k, p, c] = S[row (j+k-w)*ibs+p, column j*ibs+c].
// Grid: Q * (Np / kCT) blocks, q fastest.
template <bool kExt>
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
  const int rows_len = kExt ? Np + 2 * w * ibs : Np;  // a2/stats/v rows
  const int lag = kExt ? 0 : w;  // row block of window block k: j + k - lag
  const int q = blockIdx.x % Q;
  const int c0 = (blockIdx.x / Q) * kCT;
  const int j = c0 / ibs, lc0 = c0 % ibs;
  const int tid = threadIdx.x;
  const int tx = tid % (kCT / kTC), ty = tid / (kCT / kTC);
  const int64_t qn = (int64_t)q * Np;
  const int64_t qr = (int64_t)q * rows_len;
  const int k0 = kExt ? 0 : max(0, w - j);
  const int k1 = kExt ? W : min(W, nb + w - j);
  if (tid < kCT) a1_s[tid] = a1[qn + c0 + tid];

  for (int f0 = 0; f0 < F; f0 += kFT) {
    float acc[kTF][kTC] = {};
    for (int k = k0; k < k1; ++k) {
      const int r_blk = (j + k - lag) * ibs;  // first row of the window block
      const int64_t tile = ((int64_t)j * W + k) * ibs * ibs + lc0;
      for (int p0 = 0; p0 < ibs; p0 += kP) {
        __syncthreads();  // the previous step's readers are done
        if (tid < kP) {
          const int64_t r = qr + r_blk + p0 + tid;
          a2_s[tid] = a2[r];
          mx_s[tid] = rowmax[r];
          sm_s[tid] = fmaxf(rowsum[r], 1e-30f);
        }
        for (int e = tid; e < kFT * kP; e += kApplyThreads) {
          const int f = e / kP, p = e % kP;
          Vs[p * kLDV + f] =
              f0 + f < F
                  ? v[((int64_t)q * F + f0 + f) * rows_len + r_blk + p0 + p]
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

constexpr int kLDY = kBCC + 4;  // DYs row stride: float4-aligned, fewer conflicts

// Static shared memory of attn_bwd_kernel, in bytes (the launcher adds the
// dynamic part, bwd_dynamic_floats).
constexpr size_t kBwdStaticBytes =
    sizeof(float) * (kBFT * kBRT + kBFT * kLDY + kBRT * kLDC + kBRT * kBCC +
                     kBCC);

// The backward of apply for one (q, row block i). g, v (Q, F, Np) are the
// cotangent dy and the signals; a1, a2, rowmax, rowsum (Q, Np); slab_col
// and mask_row as in the other two kernels. Outputs: da2 (Q, Np), da1p
// (Q, nb, W, ibs) with da1p[q, i, k, c] = sum over the rows of block i of
// dpre at column (i+k-w)*ibs + c (0 where that block is off the matrix),
// dv (Q, F, Np).
// kExt: the shard's own rows i; the operands read through the window, g
// and a1, are halo-extended (rows of Np + 2*w*ibs) and slab_col is the
// halo-extended column slab (nb + 2w, W, ibs, ibs): window block k is ext
// column block i + k for every k, and da1p[q, i, k] belongs to it.
// Grid: Q * nb blocks, q fastest; dynamic shared memory
// bwd_dynamic_floats(W, ibs, F) floats.
template <bool kExt>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_kernel(const float* __restrict__ g, const float* __restrict__ a1,
                const float* __restrict__ a2, const float* __restrict__ v,
                const float* __restrict__ rowmax,
                const float* __restrict__ rowsum,
                const float* __restrict__ slab_col,
                const float* __restrict__ mask_row, float* __restrict__ da2,
                float* __restrict__ da1p, float* __restrict__ dv, int Q,
                int F, int Np, int nb, int w, int ibs, int with_s,
                float slope) {
  __shared__ __align__(16) float Vs[kBFT * kBRT];   // v chunk, [f][p]
  __shared__ __align__(16) float DYs[kBFT * kLDY];  // dy chunk, [f][c]
  __shared__ float Cs[kBRT * kLDC];                 // alpha (* S), [p][c]
  __shared__ float Ds[kBRT * kBCC];                 // dpre, [p][c]
  __shared__ float a1_s[kBCC];
  extern __shared__ float dyn[];
  const int W = 2 * w + 1;
  float* Dal = dyn;                         // dalpha, [k][p][c] over ibs cols
  float* da1_acc = Dal + W * kBRT * ibs;    // [k][c]
  float* DVs = da1_acc + W * ibs;           // dv of the row tile, [f][p]

  const int q = blockIdx.x % Q;
  const int i = blockIdx.x / Q;
  const int tid = threadIdx.x;
  const int tp = tid / (kBCC / kBU);        // score phase: row of the tile
  const int tcol = (tid % (kBCC / kBU)) * kBU;
  const int gp = tid % kBRT;                // dv GEMM: row, feature pair
  const int gf = 2 * (tid / kBRT);
  const int cols_len = kExt ? Np + 2 * w * ibs : Np;  // g's and a1's rows
  const int lag = kExt ? 0 : w;  // column block of window block k: i + k - lag
  const int64_t qn = (int64_t)q * Np;
  const int64_t qc = (int64_t)q * cols_len;
  const int k0 = kExt ? 0 : max(0, w - i);
  const int k1 = kExt ? W : min(W, nb + w - i);

  for (int e = tid; e < W * ibs; e += kBwdThreads) da1_acc[e] = 0.f;
  for (int e = tid; e < F * kBRT; e += kBwdThreads) DVs[e] = 0.f;

  for (int t = 0; t < ibs; t += kBRT) {
    const int r0 = i * ibs + t;  // first row of the tile
    const float a2v = a2[qn + r0 + tp];
    const float mxv = rowmax[qn + r0 + tp];
    const float smv = fmaxf(rowsum[qn + r0 + tp], 1e-30f);

    // pass 1: dalpha for the tile's whole window, and delta
    float delta = 0.f;
    for (int k = k0; k < k1; ++k) {
      const int col0 = (i + k - lag) * ibs;
      const int64_t mtile = (((int64_t)i * W + k) * ibs + t) * ibs;
      const int64_t stile =
          (((int64_t)(i + k - lag) * W + (2 * w - k)) * ibs + t) * ibs;
      for (int cc = 0; cc < ibs; cc += kBCC) {
        float acc[kBU] = {};
        for (int f0 = 0; f0 < F; f0 += kBFT) {
          __syncthreads();  // the previous step's readers are done
          if (f0 == 0 && tid < kBCC) a1_s[tid] = a1[qc + col0 + cc + tid];
          for (int e = tid; e < kBFT * kBRT; e += kBwdThreads) {
            const int f = e / kBRT, p = e % kBRT;
            Vs[e] = f0 + f < F ? v[((int64_t)q * F + f0 + f) * Np + r0 + p]
                               : 0.f;
          }
          for (int e = tid; e < kBFT * kBCC; e += kBwdThreads) {
            const int f = e / kBCC, c = e % kBCC;
            DYs[f * kLDY + c] =
                f0 + f < F
                    ? g[((int64_t)q * F + f0 + f) * cols_len + col0 + cc + c]
                    : 0.f;
          }
          __syncthreads();
#pragma unroll 8
          for (int f = 0; f < kBFT; ++f) {
            const float vv = Vs[f * kBRT + tp];
            const float4 d =
                *reinterpret_cast<const float4*>(&DYs[f * kLDY + tcol]);
            acc[0] = fmaf(vv, d.x, acc[0]);
            acc[1] = fmaf(vv, d.y, acc[1]);
            acc[2] = fmaf(vv, d.z, acc[2]);
            acc[3] = fmaf(vv, d.w, acc[3]);
          }
        }
#pragma unroll
        for (int u = 0; u < kBU; ++u) {
          const int c = cc + tcol + u;
          const float m = mask_row[mtile + (int64_t)tp * ibs + c];
          const float s = masked_score(a2v, a1_s[tcol + u], m, slope);
          const float al =
              __fmul_rn(__fdiv_rn(expf(__fsub_rn(s, mxv)), smv), m);
          const float dal =
              with_s ? __fmul_rn(acc[u], slab_col[stile + (int64_t)tp * ibs + c])
                     : acc[u];
          Dal[(k * kBRT + tp) * ibs + c] = dal;
          delta = fmaf(al, dal, delta);
        }
      }
    }
    // the 16 threads of row tp are one half-warp
#pragma unroll
    for (int o = kBCC / kBU / 2; o > 0; o >>= 1)
      delta += __shfl_xor_sync(0xffffffffu, delta, o);

    // pass 2: dpre, the da1 partials, da2 and dv
    float da2_part = 0.f;
    for (int k = k0; k < k1; ++k) {
      const int col0 = (i + k - lag) * ibs;
      const int64_t mtile = (((int64_t)i * W + k) * ibs + t) * ibs;
      const int64_t stile =
          (((int64_t)(i + k - lag) * W + (2 * w - k)) * ibs + t) * ibs;
      for (int cc = 0; cc < ibs; cc += kBCC) {
        __syncthreads();  // the previous chunk's readers are done
        if (tid < kBCC) a1_s[tid] = a1[qc + col0 + cc + tid];
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kBU; ++u) {
          const int c = cc + tcol + u;
          const float m = mask_row[mtile + (int64_t)tp * ibs + c];
          const float a1v = a1_s[tcol + u];
          const float s = masked_score(a2v, a1v, m, slope);
          const float al =
              __fmul_rn(__fdiv_rn(expf(__fsub_rn(s, mxv)), smv), m);
          const float dal = Dal[(k * kBRT + tp) * ibs + c];
          const float de = al * (dal - delta);
          const float dpre = de * m * (__fadd_rn(a2v, a1v) > 0.f ? 1.f : slope);
          da2_part += dpre;
          Ds[tp * kBCC + tcol + u] = dpre;
          Cs[tp * kLDC + tcol + u] =
              with_s ? __fmul_rn(al, slab_col[stile + (int64_t)tp * ibs + c])
                     : al;
        }
        __syncthreads();
        if (tid < kBCC) {  // column sums over the tile's rows, fixed order
          float s = 0.f;
#pragma unroll
          for (int p = 0; p < kBRT; ++p) s += Ds[p * kBCC + tid];
          da1_acc[k * ibs + cc + tid] += s;
        }
        for (int f0 = 0; f0 < F; f0 += kBFT) {
          if (f0 > 0) __syncthreads();
          for (int e = tid; e < kBFT * kBCC; e += kBwdThreads) {
            const int f = e / kBCC, c = e % kBCC;
            DYs[f * kLDY + c] =
                f0 + f < F
                    ? g[((int64_t)q * F + f0 + f) * cols_len + col0 + cc + c]
                    : 0.f;
          }
          __syncthreads();
          float d0 = 0.f, d1 = 0.f;
#pragma unroll 8
          for (int c = 0; c < kBCC; ++c) {
            const float cv = Cs[gp * kLDC + c];
            d0 = fmaf(DYs[gf * kLDY + c], cv, d0);
            d1 = fmaf(DYs[(gf + 1) * kLDY + c], cv, d1);
          }
          if (f0 + gf < F) DVs[(f0 + gf) * kBRT + gp] += d0;
          if (f0 + gf + 1 < F) DVs[(f0 + gf + 1) * kBRT + gp] += d1;
        }
      }
    }
#pragma unroll
    for (int o = kBCC / kBU / 2; o > 0; o >>= 1)
      da2_part += __shfl_xor_sync(0xffffffffu, da2_part, o);
    if (tid % (kBCC / kBU) == 0) da2[qn + r0 + tp] = da2_part;
    __syncthreads();  // DVs complete
    for (int e = tid; e < F * kBRT; e += kBwdThreads) {
      const int f = e / kBRT, p = e % kBRT;
      dv[((int64_t)q * F + f) * Np + r0 + p] = DVs[e];
      DVs[e] = 0.f;  // each thread clears what it wrote out
    }
  }
  __syncthreads();  // da1_acc complete
  for (int e = tid; e < W * ibs; e += kBwdThreads) {
    const int k = e / ibs;
    da1p[((int64_t)q * nb + i) * W * ibs + e] =
        k >= k0 && k < k1 ? da1_acc[e] : 0.f;
  }
}

size_t bwd_dynamic_floats(int W, int ibs, int F) {
  return (size_t)W * kBRT * ibs + (size_t)W * ibs + (size_t)F * kBRT;
}

template <bool kExt>
cudaError_t launch_bwd(const float* g, const float* a1, const float* a2,
                       const float* v, const float* rowmax,
                       const float* rowsum, const float* slab_col,
                       const float* mask_row, float* da2, float* da1p,
                       float* dv, int Q, int F, int Np, int nb, int w,
                       int ibs, int with_s, float slope,
                       cudaStream_t stream) {
  if (Q <= 0 || F <= 0 || ibs % kBCC != 0 || Np != nb * ibs || w < 0 ||
      (kExt && w > nb))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)Q * nb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * bwd_dynamic_floats(2 * w + 1, ibs, F);
  if (smem + kBwdStaticBytes > 227 * 1024) return cudaErrorInvalidValue;
  if (smem + kBwdStaticBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_kernel<kExt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  attn_bwd_kernel<kExt><<<(unsigned)blocks, kBwdThreads, smem, stream>>>(
      g, a1, a2, v, rowmax, rowsum, slab_col, mask_row, da2, da1p, dv, Q, F,
      Np, nb, w, ibs, with_s, slope);
  return cudaGetLastError();
}

template <bool kExt>
cudaError_t launch_stats(const float* a1, const float* a2,
                         const float* mask_row, float* rowmax, float* rowsum,
                         int Q, int Np, int nb, int w, int ibs, float slope,
                         cudaStream_t stream) {
  if (Q <= 0 || ibs % kStatsWarps != 0 || Np != nb * ibs || w < 0 ||
      (kExt && w > nb))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kStatsWarps * (2 * w + 1) * ibs;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_stats_kernel<kExt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  attn_stats_kernel<kExt><<<Np / kStatsWarps, kStatsThreads, smem, stream>>>(
      a1, a2, mask_row, rowmax, rowsum, Q, Np, nb, w, ibs, slope);
  return cudaGetLastError();
}

template <bool kExt>
cudaError_t launch_apply(const float* a1, const float* a2, const float* v,
                         const float* rowmax, const float* rowsum,
                         const float* slab_col, const float* mask_col,
                         float* y, int Q, int F, int Np, int nb, int w,
                         int ibs, int with_s, float slope,
                         cudaStream_t stream) {
  if (Q <= 0 || F <= 0 || ibs % kCT != 0 || Np != nb * ibs || w < 0 ||
      (kExt && w > nb))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)Q * (Np / kCT);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  attn_apply_kernel<kExt><<<(unsigned)blocks, kApplyThreads, 0, stream>>>(
      a1, a2, v, rowmax, rowsum, slab_col, mask_col, y, Q, F, Np, nb, w, ibs,
      with_s, slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

cudaError_t gnt_attn_stats(const float* a1, const float* a2,
                           const float* mask_row, float* rowmax,
                           float* rowsum, int Q, int Np, int nb, int w,
                           int ibs, float slope, cudaStream_t stream) {
  return launch_stats<false>(a1, a2, mask_row, rowmax, rowsum, Q, Np, nb, w,
                             ibs, slope, stream);
}

// a1_ext (Q, Np + 2*w*ibs); a2 (Q, Np) the shard's own rows; nb = Np / ibs
// the shard's own blocks (the ring needs w <= nb).
cudaError_t gnt_attn_stats_ext(const float* a1_ext, const float* a2,
                               const float* mask_row, float* rowmax,
                               float* rowsum, int Q, int Np, int nb, int w,
                               int ibs, float slope, cudaStream_t stream) {
  return launch_stats<true>(a1_ext, a2, mask_row, rowmax, rowsum, Q, Np, nb,
                            w, ibs, slope, stream);
}

cudaError_t gnt_attn_apply(const float* a1, const float* a2, const float* v,
                           const float* rowmax, const float* rowsum,
                           const float* slab_col, const float* mask_col,
                           float* y, int Q, int F, int Np, int nb, int w,
                           int ibs, int with_s, float slope,
                           cudaStream_t stream) {
  return launch_apply<false>(a1, a2, v, rowmax, rowsum, slab_col, mask_col,
                             y, Q, F, Np, nb, w, ibs, with_s, slope, stream);
}

// a1 (Q, Np) the shard's own columns; a2_ext, mx_ext, sm_ext
// (Q, Np + 2*w*ibs) and v_ext (Q, F, Np + 2*w*ibs) halo-extended rows;
// y (Q, F, Np).
cudaError_t gnt_attn_apply_ext(const float* a1, const float* a2_ext,
                               const float* v_ext, const float* mx_ext,
                               const float* sm_ext, const float* slab_col,
                               const float* mask_col, float* y, int Q, int F,
                               int Np, int nb, int w, int ibs, int with_s,
                               float slope, cudaStream_t stream) {
  return launch_apply<true>(a1, a2_ext, v_ext, mx_ext, sm_ext, slab_col,
                            mask_col, y, Q, F, Np, nb, w, ibs, with_s, slope,
                            stream);
}

cudaError_t gnt_attn_bwd(const float* g, const float* a1, const float* a2,
                         const float* v, const float* rowmax,
                         const float* rowsum, const float* slab_col,
                         const float* mask_row, float* da2, float* da1p,
                         float* dv, int Q, int F, int Np, int nb, int w,
                         int ibs, int with_s, float slope,
                         cudaStream_t stream) {
  return launch_bwd<false>(g, a1, a2, v, rowmax, rowsum, slab_col, mask_row,
                           da2, da1p, dv, Q, F, Np, nb, w, ibs, with_s, slope,
                           stream);
}

// g_ext (Q, F, Np + 2*w*ibs) and a1_ext (Q, Np + 2*w*ibs) halo-extended;
// a2, rowmax, rowsum (Q, Np) and v (Q, F, Np) the shard's own rows;
// slab_col_ext (nb + 2w, W, ibs, ibs) the halo-extended column slab;
// mask_row (nb, W, ibs, ibs). da2 (Q, Np), da1p (Q, nb, W, ibs) in ext
// column coordinates (block i + k), dv (Q, F, Np).
cudaError_t gnt_attn_bwd_ext(const float* g_ext, const float* a1_ext,
                             const float* a2, const float* v,
                             const float* rowmax, const float* rowsum,
                             const float* slab_col_ext,
                             const float* mask_row, float* da2, float* da1p,
                             float* dv, int Q, int F, int Np, int nb, int w,
                             int ibs, int with_s, float slope,
                             cudaStream_t stream) {
  return launch_bwd<true>(g_ext, a1_ext, a2, v, rowmax, rowsum, slab_col_ext,
                          mask_row, da2, da1p, dv, Q, F, Np, nb, w, ibs,
                          with_s, slope, stream);
}

}  // extern "C"
