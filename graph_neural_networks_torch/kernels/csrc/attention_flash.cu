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
//    structure). Per row: alpha, dalpha = (v^T dy) (* S), the softmax
//    VJP's row product delta = sum alpha * dalpha, de = alpha (dalpha -
//    delta), dpre = de * m * LeakyReLU'(pre); then da2 = the row sums of
//    dpre, the da1 window partials = its column sums over the row block,
//    dv = dy . coeff^T with coeff = alpha (* S). On the S+I support only
//    (3.7e7 scores at the served shape) it needs one exp and ~4F + 20
//    flops a score against ~190 MB, so FP32 operations bound it
//    (0.081 ms); over the dense window tiles (1.7e8 scores) 0.37 ms. What
//    keeps a simple design far from that: small row tiles reload dy and v
//    for the whole window once a tile, thin register tiles make shared
//    memory (not the FMAs) the limit, a dalpha buffer of the window takes
//    the shared memory that would hold more blocks, and a division a
//    score. Design: one block per (q, row block i), q fastest in the
//    grid (the Q blocks of a row block share its mask and slab tiles
//    through L2), 128 rows a tile (ibs = 128: the whole block; two 64-row
//    halves), the window in chunks of 64 columns, two passes:
//      A. alpha (* S) of the chunk into shared memory (Ct), then dv +=
//         dy . Ct^T as a 32 x 128 product of 4 x 4 register tiles (two
//         16-byte shared loads for 16 FMAs); dv stays in shared memory
//         for the whole window. Since dalpha = S (v^T dy), delta = sum_f
//         v dv, so no dalpha is kept: after the window dv is final and
//         delta costs F FMAs a row.
//      B. v^T dy as 8 x 4 register tiles (v of the tile resident in
//         shared memory, 3 loads for 32 FMAs), then dalpha, de, dpre; da2
//         sums along a thread's rows, the da1 partials down the columns
//         (a half-warp's shuffles, one writer a column, fixed order).
//    Two FP32 products a score (v^T dy once, dv once), not three; dy
//    chunks staged by cp.async one chunk ahead (transposed in A,
//    as it lies in B), one barrier a chunk in B and two in A. Pass A's
//    mask reads mark which 64 x 64 sub-chunks have support (a ballot
//    each), and pass B skips the others (the window tiles k = 0 and 2w of
//    the served graph lie half outside its band: 10% of the window), as
//    does A's dv product; a skipped sub-chunk adds exact zeros. alpha
//    multiplies by one reciprocal of rowsum a row (the plain versions
//    likewise). 2 blocks an SM (128 registers, ~90 KB of shared memory at
//    F = 32, w = 2), no spill. The da1 partials (Q, nb, W, ibs) are folded
//    outside, as in the JAX package, so the result is deterministic
//    without atomics. S in the row-window layout is the column-layout
//    slab at a mirrored index, slab_row[i, k] = slab_col[i + k - w,
//    2w - k], read in place.
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
#include <initializer_list>

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

// bwd: a block owns the row block i of one signal row q and walks it in
// row tiles of kBR rows (two halves of kBH), each window tile in chunks of
// kBC columns. Score mapping: thread (ty, tx) = (lane % 16, 2 warp +
// lane / 16) owns the rows h kBH + 4 ty + u (h < 2, u < 4) and the
// columns 4 tx + t (t < 4) of a chunk. dv mapping: warp (wf, wp) =
// (warp / 4, warp % 4) and lane (fi, pi) = (lane % 4, lane / 4) own the
// features 16 wf + 4 fi + j and the rows 32 wp + 4 pi + t (j, t < 4) of a
// 32-feature slice.
constexpr int kBR = 128;
constexpr int kBH = 64;
constexpr int kBC = 64;  // ibs % kBC == 0
constexpr int kBwdThreads = 256;
constexpr int kLDT = kBR + 4;  // Ct row stride: float4-aligned
// Shared memory a block may use on sm_90 (227 KB).
constexpr size_t kMaxSmem = 232448;

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// alpha = exp(s - rowmax) * (1 / rowsum) * m of a score, with m the 0/1
// support: for m = 1 the masked score s is the LeakyReLU score itself, for
// m = 0 alpha is 0, so this is bit for bit exp(masked_score - rowmax) *
// rinv * m without the masking arithmetic or a division (the rows'
// reciprocals are taken once).
__device__ __forceinline__ float alpha(float a2, float a1, float m,
                                       float mx, float rinv, float slope) {
  const float pre = __fadd_rn(a2, a1);
  const float e = pre >= 0.f ? pre : __fmul_rn(pre, slope);
  return m != 0.f ? __fmul_rn(expf(__fsub_rn(e, mx)), rinv) : 0.f;
}

// Dynamic shared memory of attn_bwd_kernel, offsets in 4-byte words.
struct BwdLayout {
  int FP;   // F rounded up to the 32-feature slices of the dv product
  int LDF;  // row stride of a transposed g chunk [c][f]
  int nch;  // chunks of a window at most
  size_t vs, dvs, gb, ct, rs, a1s, da1, live, list, words;
};

__host__ __device__ inline BwdLayout bwd_layout(int F, int W, int ibs) {
  BwdLayout L;
  L.FP = (F + 31) / 32 * 32;
  L.LDF = L.FP + 4;
  L.nch = W * (ibs / kBC);
  L.vs = 0;                                    // v of the tile, [f][r]
  L.dvs = L.vs + (size_t)F * kBR;              // dv of the tile, [f][r]
  L.gb = L.dvs + (size_t)L.FP * kBR;           // 2 g chunks
  L.ct = L.gb + 2 * (size_t)kBC * L.LDF;       // coefficients, [c][r]
  L.rs = L.ct + (size_t)kBC * kLDT;            // a2, rowmax, 1/rowsum, delta
  L.a1s = L.rs + 4 * kBR;                      // 2 a1 chunks
  L.da1 = L.a1s + 2 * kBC;                     // da1 partials, [k][c]
  L.live = L.da1 + (size_t)W * ibs;            // support bits of each chunk
  L.list = L.live + L.nch;                     // chunks with support, count
  L.words = L.list + L.nch + 1;
  return L;
}

// dco[h][u][t] = sum_f v[f, row] g[f, column] of the thread's rows and
// columns, for the halves kH0, kH1 only.
template <bool kH0, bool kH1>
__device__ __forceinline__ void bwd_dco(float (&acc)[2][4][4],
                                        const float* Vs, const float* gs,
                                        int F, int ty, int tx) {
#pragma unroll 4
  for (int f = 0; f < F; ++f) {
    const float4 gv = *reinterpret_cast<const float4*>(gs + f * kBC + 4 * tx);
    const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if ((h == 0 && !kH0) || (h == 1 && !kH1)) continue;
      const float4 av =
          *reinterpret_cast<const float4*>(Vs + f * kBR + h * kBH + 4 * ty);
      const float aa[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          acc[h][u][t] = fmaf(aa[u], gg[t], acc[h][u][t]);
    }
  }
}

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
// bwd_layout(F, W, ibs).words words. g, a1 and v 16-byte aligned.
//
// Per row tile, two passes over the window's chunks:
//  A: alpha (* S) of the chunk into Ct, then dv += g . Ct^T (a 4 x 4
//     register tile a thread over the chunk's 64 columns). After the
//     window, delta = sum_f v dv for each row (the softmax VJP's
//     sum_c alpha dalpha, since dalpha = S (v^T g)), and dv is final.
//     The chunk's mask marks which of its 64-row halves have support.
//  B: over the chunks with support only: v^T g (an 8 x 4 register tile a
//     thread), dalpha, de, dpre; da2 sums along the rows, the da1
//     partials down the columns.
template <bool kExt>
__global__ void __launch_bounds__(kBwdThreads, 2)
attn_bwd_kernel(const float* __restrict__ g, const float* __restrict__ a1,
                const float* __restrict__ a2, const float* __restrict__ v,
                const float* __restrict__ rowmax,
                const float* __restrict__ rowsum,
                const float* __restrict__ slab_col,
                const float* __restrict__ mask_row, float* __restrict__ da2,
                float* __restrict__ da1p, float* __restrict__ dv, int Q,
                int F, int Np, int nb, int w, int ibs, int with_s,
                float slope) {
  extern __shared__ __align__(16) float smem[];
  const int W = 2 * w + 1;
  const BwdLayout L = bwd_layout(F, W, ibs);
  float* Vs = smem + L.vs;
  float* DVs = smem + L.dvs;
  float* Gb = smem + L.gb;  // a chunk [c][LDF] in pass A, [f][kBC] in B
  float* Ct = smem + L.ct;
  float* a2s = smem + L.rs;
  float* mxs = a2s + kBR;
  float* rvs = mxs + kBR;
  float* dls = rvs + kBR;
  float* a1s = smem + L.a1s;
  float* da1s = smem + L.da1;
  int* live = reinterpret_cast<int*>(smem + L.live);
  int* list = reinterpret_cast<int*>(smem + L.list);

  const int q = blockIdx.x % Q;
  const int i = blockIdx.x / Q;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty = lane % 16, tx = 2 * warp + lane / 16;
  const int fq = (warp / 4) * 16 + (lane % 4) * 4;  // dv product: features
  const int pr = (warp % 4) * 32 + (lane / 4) * 4;  // and rows, half hv
  const int hv = (warp % 4) / 2;
  const int cols_len = kExt ? Np + 2 * w * ibs : Np;  // g's and a1's rows
  const int lag = kExt ? 0 : w;  // column block of window block k: i + k - lag
  const int64_t qn = (int64_t)q * Np;
  const int64_t qc = (int64_t)q * cols_len;
  const int64_t gq = (int64_t)q * F * cols_len;
  const int k0 = kExt ? 0 : max(0, w - i);
  const int k1 = kExt ? W : min(W, nb + w - i);
  const int ncc = ibs / kBC;
  const int nch = (k1 - k0) * ncc;  // chunk ci: tile k0 + ci / ncc
  const int pad = L.FP - F;         // zero features of a transposed chunk
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // first column, in g's and a1's rows, of chunk ci
  auto col_of = [&](int ci) {
    return (int64_t)(i + k0 + ci / ncc - lag) * ibs + (ci % ncc) * kBC;
  };
  auto stage_a1 = [&](int b, int64_t c0) {
    if (tid < kBC / 4)
      cp_async16(a1s + b * kBC + 4 * tid, a1 + qc + c0 + 4 * tid);
  };
  // pass A: chunk ci of g transposed, [c][f]
  auto stage_t = [&](int b, int ci) {
    const int64_t c0 = col_of(ci);
    float* gt = Gb + (size_t)b * kBC * L.LDF;
    for (int e = tid; e < F * kBC; e += kBwdThreads) {
      const int f = e / kBC, c = e % kBC;
      cp_async4(gt + c * L.LDF + f, g + gq + (int64_t)f * cols_len + c0 + c);
    }
    stage_a1(b, c0);
  };
  // pass B: chunk ci of g as it lies, [f][c]
  auto stage_f = [&](int b, int ci) {
    const int64_t c0 = col_of(ci);
    float* gs = Gb + (size_t)b * kBC * L.LDF;
    for (int e = tid; e < F * (kBC / 4); e += kBwdThreads) {
      const int f = e / (kBC / 4), c = 4 * (e % (kBC / 4));
      cp_async16(gs + f * kBC + c, g + gq + (int64_t)f * cols_len + c0 + c);
    }
    stage_a1(b, c0);
  };

  for (int e = tid; e < W * ibs; e += kBwdThreads) da1s[e] = 0.f;

  for (int t0 = 0; t0 < ibs; t0 += kBR) {
    const int rows = min(kBR, ibs - t0);
    const int halves = rows > kBH ? 3 : 1;  // the tile's halves in range
    const int64_t r0 = (int64_t)i * ibs + t0;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < F * (kBR / 4); e += kBwdThreads) {
      const int f = e / (kBR / 4), r = 4 * (e % (kBR / 4));
      float* dst = Vs + f * kBR + r;
      if (r < rows)
        cp_async16(dst, v + ((int64_t)q * F + f) * Np + r0 + r);
      else
        *reinterpret_cast<float4*>(dst) = zero4;
    }
    cp_commit();
    for (int e = tid; e < L.FP * kBR; e += kBwdThreads) DVs[e] = 0.f;
    for (int r = tid; r < kBR; r += kBwdThreads) {
      const bool in = r < rows;
      a2s[r] = in ? a2[qn + r0 + r] : 0.f;
      mxs[r] = in ? rowmax[qn + r0 + r] : 0.f;
      rvs[r] = in ? __fdiv_rn(1.f, fmaxf(rowsum[qn + r0 + r], 1e-30f)) : 0.f;
    }
    for (int e = tid; e < nch; e += kBwdThreads) live[e] = 0;
    for (int e = tid; e < 2 * kBC * pad; e += kBwdThreads) {
      const int b = e / (kBC * pad), c = e / pad % kBC, f = F + e % pad;
      Gb[(size_t)b * kBC * L.LDF + c * L.LDF + f] = 0.f;
    }
    __syncthreads();

    // pass A: the coefficients, dv, and which chunk halves have support
    stage_t(0, 0);
    cp_commit();
    for (int ci = 0; ci < nch; ++ci) {
      const int b = ci & 1;
      cp_wait<0>();
      // chunk ci has landed for every thread, and every thread is done
      // with chunk ci - 1 (its buffer and Ct)
      __syncthreads();
      if (ci + 1 < nch) stage_t(b ^ 1, ci + 1);
      cp_commit();
      const int k = k0 + ci / ncc, cc = (ci % ncc) * kBC;
      const int64_t mt = (((int64_t)i * W + k) * ibs + t0) * ibs + cc + 4 * tx;
      const int64_t st =
          (((int64_t)(i + k - lag) * W + (2 * w - k)) * ibs + t0) * ibs + cc +
          4 * tx;
      const float4 a1v = *reinterpret_cast<const float4*>(a1s + b * kBC + 4 * tx);
      const float a1t[4] = {a1v.x, a1v.y, a1v.z, a1v.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!((halves >> h) & 1)) continue;
        const int rb = h * kBH + 4 * ty;  // the thread's first row
        const float4 a2v = *reinterpret_cast<const float4*>(a2s + rb);
        const float4 mxv = *reinterpret_cast<const float4*>(mxs + rb);
        const float4 rvv = *reinterpret_cast<const float4*>(rvs + rb);
        const float a2u[4] = {a2v.x, a2v.y, a2v.z, a2v.w};
        const float mxu[4] = {mxv.x, mxv.y, mxv.z, mxv.w};
        const float rvu[4] = {rvv.x, rvv.y, rvv.z, rvv.w};
        float cf[4][4];
        bool nz = false;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 m4 = ldg4(mask_row + mt + (int64_t)(rb + u) * ibs);
          const float4 s4 = with_s ? ldg4(slab_col + st + (int64_t)(rb + u) * ibs)
                                   : zero4;
          const float mm[4] = {m4.x, m4.y, m4.z, m4.w};
          const float ss[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float al = alpha(a2u[u], a1t[t], mm[t], mxu[u], rvu[u],
                                   slope);
            cf[u][t] = with_s ? __fmul_rn(al, ss[t]) : al;
            nz |= mm[t] != 0.f;
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t)
          *reinterpret_cast<float4*>(Ct + (4 * tx + t) * kLDT + rb) =
              make_float4(cf[0][t], cf[1][t], cf[2][t], cf[3][t]);
        if (__ballot_sync(0xffffffffu, nz) && lane == 0)
          atomicOr(live + ci, 1 << h);
      }
      __syncthreads();  // Ct and the support bits are complete
      if ((live[ci] >> hv) & 1) {
        const float* gt = Gb + (size_t)b * kBC * L.LDF;
        for (int f0 = 0; f0 < L.FP; f0 += 32) {
          float acc[4][4] = {};
#pragma unroll 8
          for (int c = 0; c < kBC; ++c) {
            const float4 gv =
                *reinterpret_cast<const float4*>(gt + c * L.LDF + f0 + fq);
            const float4 cv = *reinterpret_cast<const float4*>(Ct + c * kLDT + pr);
            const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
            const float cc4[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int t = 0; t < 4; ++t)
                acc[j][t] = fmaf(gg[j], cc4[t], acc[j][t]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float4* d = reinterpret_cast<float4*>(DVs + (f0 + fq + j) * kBR + pr);
            const float4 o = *d;
            *d = make_float4(o.x + acc[j][0], o.y + acc[j][1], o.z + acc[j][2],
                             o.w + acc[j][3]);
          }
        }
      }
    }
    __syncthreads();
    // delta = sum_f v dv of each row; dv is final
    if (tid < kBR) {
      float d = 0.f;
      for (int f = 0; f < F; ++f)
        d = fmaf(Vs[f * kBR + tid], DVs[f * kBR + tid], d);
      dls[tid] = d;
    }
    for (int e = tid; e < F * kBR; e += kBwdThreads) {
      const int f = e / kBR, r = e % kBR;
      if (r < rows) dv[((int64_t)q * F + f) * Np + r0 + r] = DVs[e];
    }
    if (tid == 0) {
      int n = 0;
      for (int ci = 0; ci < nch; ++ci)
        if (live[ci]) list[n++] = ci;
      list[nch] = n;
    }
    __syncthreads();

    // pass B: dpre on the chunks with support; da2 and the da1 partials
    const int n_live = list[nch];
    float da2p[2][4] = {};
    if (n_live > 0) stage_f(0, list[0]);
    cp_commit();
    for (int li = 0; li < n_live; ++li) {
      const int b = li & 1, ci = list[li], lv = live[ci];
      cp_wait<0>();
      __syncthreads();  // chunk li has landed; li - 1's buffer is free
      if (li + 1 < n_live) stage_f(b ^ 1, list[li + 1]);
      cp_commit();
      const int k = k0 + ci / ncc, cc = (ci % ncc) * kBC;
      const int64_t mt = (((int64_t)i * W + k) * ibs + t0) * ibs + cc + 4 * tx;
      const int64_t st =
          (((int64_t)(i + k - lag) * W + (2 * w - k)) * ibs + t0) * ibs + cc +
          4 * tx;
      const float* gs = Gb + (size_t)b * kBC * L.LDF;
      float acc[2][4][4] = {};
      if (lv == 3)
        bwd_dco<true, true>(acc, Vs, gs, F, ty, tx);
      else if (lv == 1)
        bwd_dco<true, false>(acc, Vs, gs, F, ty, tx);
      else
        bwd_dco<false, true>(acc, Vs, gs, F, ty, tx);
      const float4 a1v = *reinterpret_cast<const float4*>(a1s + b * kBC + 4 * tx);
      const float a1t[4] = {a1v.x, a1v.y, a1v.z, a1v.w};
      float csum[4] = {0.f, 0.f, 0.f, 0.f};  // dpre down the columns
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!((lv >> h) & 1)) continue;
        const int rb = h * kBH + 4 * ty;
        const float4 a2v = *reinterpret_cast<const float4*>(a2s + rb);
        const float4 mxv = *reinterpret_cast<const float4*>(mxs + rb);
        const float4 rvv = *reinterpret_cast<const float4*>(rvs + rb);
        const float4 dlv = *reinterpret_cast<const float4*>(dls + rb);
        const float a2u[4] = {a2v.x, a2v.y, a2v.z, a2v.w};
        const float mxu[4] = {mxv.x, mxv.y, mxv.z, mxv.w};
        const float rvu[4] = {rvv.x, rvv.y, rvv.z, rvv.w};
        const float dlu[4] = {dlv.x, dlv.y, dlv.z, dlv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 m4 = ldg4(mask_row + mt + (int64_t)(rb + u) * ibs);
          const float4 s4 = with_s ? ldg4(slab_col + st + (int64_t)(rb + u) * ibs)
                                   : zero4;
          const float mm[4] = {m4.x, m4.y, m4.z, m4.w};
          const float ss[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float al = alpha(a2u[u], a1t[t], mm[t], mxu[u], rvu[u],
                                   slope);
            const float dal =
                with_s ? __fmul_rn(acc[h][u][t], ss[t]) : acc[h][u][t];
            const float de = __fmul_rn(al, __fsub_rn(dal, dlu[u]));
            // de * m: de is 0 where m is
            const float dpre = __fmul_rn(
                de, __fadd_rn(a2u[u], a1t[t]) > 0.f ? 1.f : slope);
            da2p[h][u] = __fadd_rn(da2p[h][u], dpre);
            csum[t] = __fadd_rn(csum[t], dpre);
          }
        }
      }
      // the half-warp's 16 ty hold the chunk's rows of its 4 columns
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int o = 1; o < 16; o <<= 1)
          csum[t] += __shfl_xor_sync(0xffffffffu, csum[t], o);
      if (ty == 0)
#pragma unroll
        for (int t = 0; t < 4; ++t) da1s[k * ibs + cc + 4 * tx + t] += csum[t];
    }
    // da2 of each row: the warp's two tx, then the 8 warps in order (Ct
    // is free in pass B)
    float* red = Ct;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float x =
            da2p[h][u] + __shfl_xor_sync(0xffffffffu, da2p[h][u], 16);
        if (lane < 16) red[warp * kBR + h * kBH + 4 * ty + u] = x;
      }
    __syncthreads();
    if (tid < rows) {
      float s = 0.f;
#pragma unroll
      for (int wv = 0; wv < kBwdThreads / 32; ++wv) s += red[wv * kBR + tid];
      da2[qn + r0 + tid] = s;
    }
  }
  __syncthreads();  // da1s complete
  for (int e = tid; e < W * ibs; e += kBwdThreads) {
    const int k = e / ibs;
    da1p[((int64_t)q * nb + i) * W * ibs + e] =
        k >= k0 && k < k1 ? da1s[e] : 0.f;
  }
}

size_t bwd_smem_bytes(int F, int W, int ibs) {
  return sizeof(float) * bwd_layout(F, W, ibs).words;
}

template <bool kExt>
cudaError_t launch_bwd(const float* g, const float* a1, const float* a2,
                       const float* v, const float* rowmax,
                       const float* rowsum, const float* slab_col,
                       const float* mask_row, float* da2, float* da1p,
                       float* dv, int Q, int F, int Np, int nb, int w,
                       int ibs, int with_s, float slope,
                       cudaStream_t stream) {
  if (Q <= 0 || F <= 0 || ibs % kBC != 0 || Np != nb * ibs || w < 0 ||
      (kExt && w > nb))
    return cudaErrorInvalidValue;
  for (const float* p : {g, a1, v, slab_col, mask_row})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  const long long blocks = (long long)Q * nb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = bwd_smem_bytes(F, 2 * w + 1, ibs);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_kernel<kExt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
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

// The file's kernels by name (gnt_attention_kernel).
struct NamedKernel {
  const char* name;
  const void* fn;
};
const NamedKernel kKernels[] = {
    {"attn_stats_kernel<false>", (const void*)attn_stats_kernel<false>},
    {"attn_stats_kernel<true>", (const void*)attn_stats_kernel<true>},
    {"attn_apply_kernel<false>", (const void*)attn_apply_kernel<false>},
    {"attn_apply_kernel<true>", (const void*)attn_apply_kernel<true>},
    {"attn_bwd_kernel<false>", (const void*)attn_bwd_kernel<false>},
    {"attn_bwd_kernel<true>", (const void*)attn_bwd_kernel<true>},
};

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

// Kernel i of this file and its name, or null past the last.
const void* gnt_attention_kernel(int i, const char** name) {
  if (i < 0 || i >= (int)(sizeof(kKernels) / sizeof(kKernels[0])))
    return nullptr;
  *name = kKernels[i].name;
  return kKernels[i].fn;
}

// The dynamic shared memory attn_bwd_kernel takes at (F, W, ibs), in
// bytes: what launch_bwd asks for, and refuses above kMaxSmem.
int gnt_attn_bwd_smem_bytes(int F, int W, int ibs) {
  return (int)bwd_smem_bytes(F, W, ibs);
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
