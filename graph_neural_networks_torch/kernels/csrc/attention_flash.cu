// Hopper (sm_90a) kernels for flash banded graph attention, in true FP32,
// and their bf16-io kernels. Which kernel each dtype runs:
//
//          f32                          bf16
//   stats  attn_stats_kernel<kExt>      attn_stats_bf16_kernel<kExt>
//   apply  attn_apply_kernel<kExt, G>   attn_apply_mma_kernel<kExt, G>
//   bwd    attn_bwd_kernel<kExt>        attn_bwd_mma_kernel<kExt, NF>
//
// In bf16, a1, a2, v, g, the mask and the slab are read in bf16 and every
// score, exp and sum stays f32 (the JAX kernels' .astype(float32),
// ops/attention_flash.py:95-99, :118-138, :142-197); the stats, da2 and the
// da1 partials are written in f32, y and dv in bf16, rounded once.
//
// The bf16 stats, attn_stats_bf16_kernel (kernels 7 and 10 in bf16, global
// and ext from one template): a block stages its rows' mask across the
// window by 16-byte cp.async and the a1 window of its signal rows by
// 16-byte loads, in bf16, transposed so that the lanes reading one position
// for consecutive signal rows hit consecutive halves of words; each warp
// compacts its rows' support lists from shared memory in place, then walks
// a list with its lanes over the signal rows (a serial max and exp-sum a
// lane, one xor tree over the lanes that split the list), where the f32
// kernel runs 4 signal rows at a time over lanes on the entries, each pass
// ending in a 5-level shuffle tree.
//
// The apply has a bf16 kernel of its own, attn_apply_mma_kernel (kernels 8
// and 11 in bf16, global and ext from one template, as the f32 ones): the
// chunk's v, slab and entry lists stay bf16 / int16 in shared memory (16-byte
// cp.async), alpha (* S) is computed in f32 on the support and split into
// bf16 hi + lo, and y = v . coeff runs as mma.sync.m16n8k16 with f32
// accumulators.
//
// The bf16 backward, attn_bwd_mma_kernel (kernels 9 and 12 in bf16, global
// and ext from one template): a block serves two signal rows of a row
// block in 64-row tiles, so each window chunk's mask and slab are staged
// once for both (16-byte cp.async, a ring of three chunks, two ahead), g
// and a1 for each; both products run on tensor cores, mma.sync.m16n8k16
// with f32 accumulators. v^T g takes bf16 from memory, so it is JAX's f32
// dot up to the order of the sum; the dv product's coefficient alpha (* S)
// is f32, computed in registers in the A fragment's layout and split into
// bf16 hi + lo, two mma into one accumulator (2^-16 of the coefficient,
// where one bf16 rounding would be 2^-9). Each warp owns 16 rows of one
// signal row, so dv^T and da2 stay in its registers; only the da1 column
// sums cross warps, in a fixed order, without atomics.
//
// Six kernels, the counterparts of six Pallas calls of the JAX package
// (graph_neural_networks_tpu/ops/attention_flash.py); apply in instances
// for G = 4, 2, 1 (attn_apply_kernel<kExt, G>, attn_apply_mma_kernel<kExt,
// G>), the bf16 backward for F <= 16 NF, NF = 1 .. 4:
//
//   attn_stats_kernel<false>              <- attention_flash.py:_stats_call
//   attn_stats_bf16_kernel<false> (bf16)  <- attention_flash.py:_stats_call
//   attn_apply_kernel<false>              <- attention_flash.py:_apply_call
//   attn_apply_mma_kernel<false> (bf16)   <- attention_flash.py:_apply_call
//   attn_bwd_kernel<false>                <- attention_flash.py:_bwd_call
//   attn_bwd_mma_kernel<false, NF> (bf16) <- attention_flash.py:_bwd_call
//   attn_stats_kernel<true>               <- ..._stats_ext_call
//   attn_stats_bf16_kernel<true> (bf16)   <- ..._stats_ext_call
//   attn_apply_kernel<true>               <- ..._apply_ext_call
//   attn_apply_mma_kernel<true> (bf16)    <- ..._apply_ext_call
//   attn_bwd_kernel<true>                 <- ..._bwd_ext_call
//   attn_bwd_mma_kernel<true, NF> (bf16)  <- ..._bwd_ext_call
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
//    and the mask is 0 (the -1e12 entries add exactly 0; a row without
//    support sums W*ibs ones, in both instances, as the JAX kernels do).
//    The other operands (a2 in stats; a1 and y in apply) keep the
//    shard's own Np.
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
//   alpha = exp(e - rowmax[i]) * (1 / max(rowsum[i], 1e-30)) * m
//   y[q, f, j] = sum_i v[q, f, i] * alpha * (S[i, j] if with_s)
// (one reciprocal a row; the plain versions likewise). alpha never exists
// in device memory. The scores are computed with every rounding step
// spelled out (__fadd_rn & co.): leaky_score, the masked score at m = 1 bit
// for bit, in stats and in alpha() (apply and bwd), so apply and bwd
// recompute exactly the scores the stats kernel reduced. Window blocks
// that fall off the matrix are skipped: the JAX kernels clamp them onto
// zero-mask tiles, whose entries are -1e12 and add exactly 0 to every
// sum (a row without support is the exception stats spells out).
//
// What bounds them on an H100, at the served shape (Q = B*P = 16 signal
// rows, Np = 16384, ibs = 128, W = 2w+1 = 5, F = 32; Q*nb*W*ibs^2 = 1.7e8
// scores a call, of which 22% lie on the S+I support). A masked score adds
// exactly 0 to every max, sum and product, so the function itself needs
// only the support's exps and FMAs and is bound by its bytes (46 MB for
// stats, 155 MB for apply). Over every score of every window tile they
// would be bound by operations (stats: one expf a score, 1.7e8 against
// the SFU's 16 exp2 a clock on each of 132 SMs); so each runs its scores
// on the support only:
//  * stats: bound by the 42 MB mask it must read (0.014 ms); on the
//    support 3.7e7 scores, each a max step and an expf. Design: a warp
//    compacts its row's support once a call, from the mask it reads
//    (ballot and popc over 32 columns a load, int16 window positions in
//    shared memory, W*ibs <= 32767), then runs two passes over that list
//    only for each signal row: the max of the LeakyReLU scores, then the
//    exp-sum in a fixed lane order, 4 signal rows at a time for one list
//    read. A block (8 warps, RW = 4, 2 or 1 rows each, all in one row
//    block) stages its rows' a1 window for QB signal rows once by
//    cp.async, so a1 is read from L2 once a block, not once a (q, row).
//    The launcher picks QB (all Q if the stage and the lists fit 57 KB,
//    4 blocks an SM; else fewer, each group reading the mask again) and
//    RW (the most rows that keep the grid at 90% of what the card holds
//    at once): at the served shape QB = 16, 51 KB, RW = 4 for
//    Np = 16384 and 1 for a 4096-row shard. In bf16 the same bytes halve
//    (23.9 MB: 0.007 ms); what bounds attn_stats_bf16_kernel is its
//    instruction stream, the serial exp-sum over the support (3.7e7
//    scores of a compare, an add, a multiply and an expf each).
//  * apply: on the support, 0.05 ms of bytes (v, y, mask and slab, 155 MB);
//    over the dense window tiles an FP32 product of 2*F flops a score
//    (1.1e10 flops, 0.16 ms at 67 TFLOP/s). Design: a block owns a
//    64-column tile for a group of G signal rows (G = 4, 2 or 1, picked by
//    the launcher so that a pass covers F and the grid fills the card) and
//    walks the window in 32-row chunks, staged by cp.async one chunk ahead
//    (the slab sub-tile and the support's entry list once for all G rows,
//    the rows' v chunk), so the support and slab come from L2 once per
//    group, not once per q; alpha = exp(s - rowmax) * (1 / rowsum), one
//    reciprocal a row. Each chunk: the scores of the support only, a
//    warp's lanes on the entries of its rows (the lists are built once
//    per band structure, ops/attention_flash.py:support_lists; a score on
//    each dense mask tile ran slower), into a coefficient tile; then,
//    unless the chunk has no support (a __syncthreads_or), the G products
//    y += v . coeff in 8 x 4 register tiles over the dense tile.
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
//    2w - k], read in place. In bf16 (attn_bwd_mma_kernel) the products
//    run on tensor cores and what bounds the kernel is the scores of the
//    dense window tiles, computed twice (alpha in each pass: about half
//    its time, by the diagnostics of
//    experiments/torch_attn_bf16_variants.py); restaging the mask and
//    slab once a signal row (the form it replaced) cost it 6%.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr float kInfinite = 1e12f;  // the reference's additive -inf

// stats: 8 warps a block, each RW rows (RW = 4, 2 or 1, picked by the
// launcher), for QB signal rows staged at once; a warp reduces kStatsQV
// signal rows at a time.
constexpr int kStatsWarps = 8;
constexpr int kStatsThreads = 32 * kStatsWarps;
constexpr int kStatsQV = 4;

// apply: a block computes y[q, :, c0 : c0+kCT] for a group of G signal
// rows q (G = 4, 2 or 1, picked by the launcher), the window in chunks of
// kAP rows; kApplyRows = G * FP rows of v staged a chunk (FP features a
// pass), kAF of them a thread.
constexpr int kCT = 64;  // ibs % kCT == 0
constexpr int kAP = 32;  // ibs % kAP == 0
constexpr int kApplyThreads = 256;
constexpr int kApplyRows = 128;
constexpr int kAF = 8;
constexpr int kLDV = kAP + 4;  // staged v row stride: float4-aligned; a
                               // warp's two feature rows on distinct banks

// Dynamic shared memory of attn_apply_kernel<., G>, offsets in words:
// two staged chunks of the support's entry list (at most kAP * kCT int16),
// slab and v, the coefficients Cs, two chunks of the rows' a2, rowmax and
// 1 / rowsum, and a1 of the block's columns; the chunks' entry offsets
// follow past words (apply_smem_bytes).
struct ApplyLayout {
  int ents, slab, vs, cs, rows, a1, words;
};

__host__ __device__ constexpr ApplyLayout apply_layout(int G) {
  return ApplyLayout{0,
                     kAP * kCT,
                     3 * kAP * kCT,
                     3 * kAP * kCT + 2 * kApplyRows * kLDV,
                     3 * kAP * kCT + 2 * kApplyRows * kLDV + G * kAP * kCT,
                     3 * kAP * kCT + 2 * kApplyRows * kLDV + G * kAP * kCT +
                         6 * G * kAP,
                     3 * kAP * kCT + 2 * kApplyRows * kLDV + G * kAP * kCT +
                         6 * G * kAP + G * kCT};
}

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

// The LeakyReLU score of (row, column) on the support, every rounding
// step spelled out: the masked score e * m - (1 - m) * 1e12 at m = 1,
// which is e bit for bit.
__device__ __forceinline__ float leaky_score(float a2, float a1, float slope) {
  const float pre = __fadd_rn(a2, a1);
  return pre >= 0.f ? pre : __fmul_rn(pre, slope);
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

// 16 bytes, or (valid false) 16 zeros with nothing read
__device__ __forceinline__ void cp_async16z(float* dst, const float* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
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

// The io types of the stats and apply kernels: f32, or bf16 converted to
// f32 when read and rounded (to nearest even) when written.
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

// 4 consecutive bf16 (8 bytes, 8-byte aligned), read-only, as floats
__device__ __forceinline__ float4 ldg4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
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

// Stage 4 consecutive elements at src as floats at dst (16-byte aligned
// shared memory); z: 4 zeros, nothing read, when !valid. f32: a 16-byte
// cp.async, landed at the next cp_wait; bf16: an 8-byte load, converted
// and stored at once. stage1: one f32 element, a 4-byte cp.async.
__device__ __forceinline__ void stage4(float* dst, const float* src) {
  cp_async16(dst, src);
}
__device__ __forceinline__ void stage4(float* dst, const bf16* src) {
  *reinterpret_cast<float4*>(dst) = ldg4(src);
}
__device__ __forceinline__ void stage4z(float* dst, const float* src,
                                        bool valid) {
  cp_async16z(dst, src, valid);
}
__device__ __forceinline__ void stage4z(float* dst, const bf16* src,
                                        bool valid) {
  *reinterpret_cast<float4*>(dst) =
      valid ? ldg4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void stage1(float* dst, const float* src) {
  cp_async4(dst, src);
}

// rowmax and rowsum of one row for NQ signal rows, from the row's support
// list ent[0 .. n) (window positions k * ibs + c, ascending) and the rows'
// a1 windows staged at a1s + j * WI. Lane l takes the entries l, l + 32,
// ...; the warp tree adds the lanes' sums in a fixed order, so the result
// depends on the list alone, not on the window's addressing.
template <int NQ>
__device__ __forceinline__ void stats_rows(const float* a1s, int WI,
                                           const int16_t* ent, int n,
                                           int lane, const float (&a2)[NQ],
                                           float slope, float (&mx)[NQ],
                                           float (&sum)[NQ]) {
  float m[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) m[j] = -INFINITY;
  for (int t = lane; t < n; t += 32) {
    const int c = ent[t];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      m[j] = fmaxf(m[j], leaky_score(a2[j], a1s[j * WI + c], slope));
  }
#pragma unroll
  for (int j = 0; j < NQ; ++j) mx[j] = warp_max(m[j]);
#pragma unroll
  for (int j = 0; j < NQ; ++j) sum[j] = 0.f;
  for (int t = lane; t < n; t += 32) {
    const int c = ent[t];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      sum[j] = __fadd_rn(sum[j], expf(__fsub_rn(
                   leaky_score(a2[j], a1s[j * WI + c], slope), mx[j])));
  }
#pragma unroll
  for (int j = 0; j < NQ; ++j) sum[j] = warp_sum(sum[j]);
}

// rowmax/rowsum (Q, Np) of the masked scores of every row over its column
// window. a1 (Q, Np), or (Q, Np + 2*w*ibs) halo-extended when kExt; a2
// (Q, Np); mask_row (nb, W, ibs, ibs): mask_row[i, k, p, c] is the support
// at (row i*ibs+p, column (i+k-w)*ibs+c) of the global matrix.
//
// A block serves 8 * rw rows of one row block i for the signal rows
// q0 .. q0 + qb (grid: Np / (8 rw) row groups x ceil(Q / qb) signal
// groups, the signal group fastest, so the blocks that read one row's mask
// run side by side). It stages the a1 window of block i for its qb signal
// rows in shared memory with cp.async (vec: 16-byte copies; else 4-byte
// ones), while each warp compacts the support of its first row: it reads
// the row's mask across the window, 32 columns a load, ballots m != 0 and
// writes the support's window positions in ascending order (popc
// prefixes) into its list in shared memory. Then for each signal row two
// passes over the list only: the max, then the exp-sum. A masked score is
// -1e12 and adds exactly 0 to the sum, so only the order of the support's
// terms differs from the dense form. A row without support (every score
// -1e12) gets rowmax -1e12 and rowsum W * ibs, as the JAX kernels give
// it: they clamp the off-matrix window blocks onto zero-mask tiles. Both
// instances build the same list for a row (ext window block k is global
// window block k; the global instance leaves out the blocks past the
// matrix, whose mask is 0), so they give a row the same bits.
// Dynamic shared memory: qb * W * ibs floats of a1, then 8 lists of
// W * ibs int16 (stats_plan). The bf16 stats are attn_stats_bf16_kernel.
template <bool kExt>
__global__ void __launch_bounds__(kStatsThreads)
attn_stats_kernel(const float* __restrict__ a1, const float* __restrict__ a2,
                  const float* __restrict__ mask_row,
                  float* __restrict__ rowmax, float* __restrict__ rowsum,
                  int Q, int Np, int nb, int w, int ibs, float slope, int rw,
                  int qb, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int W = 2 * w + 1, WI = W * ibs;
  const int a1_len = kExt ? Np + 2 * w * ibs : Np;  // a1's row length
  const int lag = kExt ? 0 : w;  // a1 block of window block k: i + k - lag
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_qg = (Q + qb - 1) / qb;
  const int q0 = (blockIdx.x % n_qg) * qb, nq = min(qb, Q - q0);
  const int row0 = (blockIdx.x / n_qg) * kStatsWarps * rw;
  const int i = row0 / ibs;  // ibs % (8 rw) == 0: one row block a block
  const int k0 = kExt ? 0 : max(0, w - i);
  const int k1 = kExt ? W : min(W, nb + w - i);
  float* a1s = smem;
  int16_t* ent = reinterpret_cast<int16_t*>(smem + (size_t)qb * WI) +
                 warp * WI;

  // a1[q0 + qq, window blocks k0 .. k1) -> a1s[qq * WI + k * ibs + c]
  const int span = (k1 - k0) * ibs;
  const float* a1w =
      a1 + (int64_t)q0 * a1_len + (int64_t)(i + k0 - lag) * ibs;
  if (vec) {
    for (int e = 4 * tid; e < nq * span; e += 4 * kStatsThreads) {
      const int qq = e / span, c = e % span;
      stage4(a1s + qq * WI + k0 * ibs + c, a1w + (int64_t)qq * a1_len + c);
    }
  } else {
    for (int e = tid; e < nq * span; e += kStatsThreads) {
      const int qq = e / span, c = e % span;
      stage1(a1s + qq * WI + k0 * ibs + c, a1w + (int64_t)qq * a1_len + c);
    }
  }
  cp_commit();

  const unsigned below = (1u << lane) - 1u;
  for (int r = 0; r < rw; ++r) {
    const int row = row0 + warp * rw + r, p = row % ibs;
    int n = 0;
    for (int k = k0; k < k1; ++k) {
      const float* src = mask_row + (((int64_t)i * W + k) * ibs + p) * ibs;
      for (int c0 = 0; c0 < ibs; c0 += 128) {  // ibs % 32 == 0
        float m[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          m[u] = c0 + 32 * u < ibs ? to_f32(__ldg(src + c0 + 32 * u + lane))
                                   : 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned b = __ballot_sync(0xffffffffu, m[u] != 0.f);
          if (m[u] != 0.f)
            ent[n + __popc(b & below)] =
                (int16_t)(k * ibs + c0 + 32 * u + lane);
          n += __popc(b);
        }
      }
    }
    __syncwarp();
    if (r == 0) {
      cp_wait<0>();
      __syncthreads();  // a1s complete
    }
    if (n == 0) {
      for (int qq = lane; qq < nq; qq += 32) {
        rowmax[(int64_t)(q0 + qq) * Np + row] = -kInfinite;
        rowsum[(int64_t)(q0 + qq) * Np + row] = (float)WI;
      }
    } else {
      int qq = 0;
      for (; qq + kStatsQV <= nq; qq += kStatsQV) {
        float a2v[kStatsQV], mx[kStatsQV], sm[kStatsQV];
#pragma unroll
        for (int j = 0; j < kStatsQV; ++j)
          a2v[j] = to_f32(a2[(int64_t)(q0 + qq + j) * Np + row]);
        stats_rows<kStatsQV>(a1s + qq * WI, WI, ent, n, lane, a2v, slope, mx,
                             sm);
        if (lane == 0)
#pragma unroll
          for (int j = 0; j < kStatsQV; ++j) {
            rowmax[(int64_t)(q0 + qq + j) * Np + row] = mx[j];
            rowsum[(int64_t)(q0 + qq + j) * Np + row] = sm[j];
          }
      }
      for (; qq < nq; ++qq) {
        const float a2v[1] = {to_f32(a2[(int64_t)(q0 + qq) * Np + row])};
        float mx[1], sm[1];
        stats_rows<1>(a1s + qq * WI, WI, ent, n, lane, a2v, slope, mx, sm);
        if (lane == 0) {
          rowmax[(int64_t)(q0 + qq) * Np + row] = mx[0];
          rowsum[(int64_t)(q0 + qq) * Np + row] = sm[0];
        }
      }
    }
    __syncwarp();  // the list is rebuilt for the next row
  }
}

// alpha = exp(s - rowmax) * (1 / rowsum) * m of a score, with m the 0/1
// support: for m = 1 the masked score s is the LeakyReLU score itself, for
// m = 0 alpha is 0, so this is bit for bit exp(s - rowmax) * rinv * m
// without the masking arithmetic or a division (the rows' reciprocals are
// taken once); s is the score the stats kernel reduced.
__device__ __forceinline__ float alpha(float a2, float a1, float m,
                                       float mx, float rinv, float slope) {
  return m != 0.f
             ? __fmul_rn(expf(__fsub_rn(leaky_score(a2, a1, slope), mx)), rinv)
             : 0.f;
}

// y (Q, F, Np) = v @ (alpha * S) on the band. a1 (Q, Np); v (Q, F, Np)
// and a2, rowmax, rowsum (Q, Np), or with rows of Np + 2*w*ibs
// (halo-extended) when kExt; slab_col (nb, W, ibs, ibs):
// slab_col[j, k, p, c] = S[row (j+k-w)*ibs+p, column j*ibs+c]; the S+I
// support of the same layout as entry lists (sup_entries, sup_offs:
// ops/attention_flash.py:SupportLists).
//
// A block owns the kCT output columns from c0 for a group of G signal rows
// q0 .. q0 + G - 1 (slots; the slots past Q are idle), and walks the
// window in chunks of kAP rows, staged by cp.async one chunk ahead: the
// chunk's slab sub-tile and its list of support entries once for all G
// rows, the G rows' v chunk ([s][f][p], FP = 128 / G features a pass),
// and their a2, rowmax and 1 / rowsum (loaded into registers a chunk
// ahead; one reciprocal a row). Per chunk:
//  * the coefficients alpha (* S) into Cs ([s][p][c]), exp only on the
//    support: each warp zeroes its 4 G rows of its slot's Cs and fills in
//    the support entries of those rows from the chunk's list (p * 64 + c,
//    in the rows' order; sup_offs gives each 4-row group's first entry),
//    a lane an entry, so the warps run only the support's scores;
//  * if any coefficient of the chunk is on the support (__syncthreads_or),
//    y += v . Cs: thread (slot, fg, cg) = (tid / TPS, tid / 16 % (FP / 8),
//    tid % 16) holds features fg + (FP / 8) i (i < 8) x columns 4 cg + t,
//    4 + 4 16-byte shared loads for 64 FMAs.
// Two barriers a chunk. Grid (Np / kCT) * ceil(Q / G) blocks, the G-row
// groups of one column tile adjacent (they read the same lists and slab
// tiles); dynamic shared memory apply_smem_bytes(G, W, ibs). v,
// sup_entries, slab_col and y 16-byte aligned. T: the io type of a1, a2,
// v, the slab and y (the stats are f32; the staged tiles are f32). The
// library instantiates it for f32 only; bf16 runs attn_apply_mma_kernel
// (T = bf16 is the FMA form that kernel replaced, which
// experiments/torch_apply_bf16_variants.py times against it).
template <bool kExt, int G, class T = float>
__global__ void __launch_bounds__(kApplyThreads, 2)
attn_apply_kernel(const T* __restrict__ a1, const T* __restrict__ a2,
                  const T* __restrict__ v,
                  const float* __restrict__ rowmax,
                  const float* __restrict__ rowsum,
                  const T* __restrict__ slab_col,
                  const int16_t* __restrict__ sup_entries,
                  const int* __restrict__ sup_offs, T* __restrict__ y,
                  int Q, int F, int Np, int nb, int w, int ibs, int with_s,
                  float slope) {
  constexpr int FP = kApplyRows / G;  // features a pass
  constexpr int NFG = FP / kAF;       // feature groups
  constexpr int TPS = kApplyThreads / G;  // threads a slot
  constexpr int GPW = G;  // 4-row groups a warp (8 a slot)
  constexpr ApplyLayout L = apply_layout(G);
  extern __shared__ __align__(16) float smem[];
  float* const Cs = smem + L.cs;
  float* const a1s = smem + L.a1;
  int* const offs = reinterpret_cast<int*>(smem + L.words);
  const int W = 2 * w + 1;
  const int rows_len = kExt ? Np + 2 * w * ibs : Np;  // a2/stats/v rows
  const int lag = kExt ? 0 : w;  // row block of window block k: j + k - lag
  const int n_groups = (Q + G - 1) / G;
  const int q0 = (blockIdx.x % n_groups) * G;
  const int nq = min(G, Q - q0);  // slots in use
  const int c0 = (blockIdx.x / n_groups) * kCT;
  const int j = c0 / ibs, lc0 = c0 % ibs;
  const int tid = threadIdx.x;
  const int slot = tid / TPS;  // the same in both phases: warp-uniform
  const int u = tid % TPS;                               // scores
  const int cg = tid % 16, fg = (tid / 16) % NFG;        // product
  const int k0 = kExt ? 0 : max(0, w - j);
  const int k1 = kExt ? W : min(W, nb + w - j);
  const int cpb = ibs / kAP;  // chunks a window block
  const int nch = (k1 - k0) * cpb;

  // first row, in v's and the stats' rows, and slab offset of chunk ci
  auto row_of = [&](int ci) {
    return (int64_t)(j + k0 + ci / cpb - lag) * ibs + (ci % cpb) * kAP;
  };
  auto tile_of = [&](int ci) {
    return (((int64_t)j * W + k0 + ci / cpb) * ibs + (ci % cpb) * kAP) * ibs +
           lc0;
  };
  auto stage = [&](int b, int ci, int f0) {
    const int64_t mt = tile_of(ci), r0 = row_of(ci);
    float* es = smem + L.ents + b * kAP * kCT / 2;
    float* ss = smem + L.slab + b * kAP * kCT;
    const int* o = offs + ci * 9;  // the chunk's entries, padded to 16 bytes
    for (int e = tid; e < (o[8] - o[0] + 7) / 8; e += kApplyThreads)
      cp_async16(es + 4 * e,
                 reinterpret_cast<const float*>(sup_entries + o[0]) + 4 * e);
    if (with_s) {
#pragma unroll 1
      for (int e = tid; e < kAP * kCT / 4; e += kApplyThreads) {
        const int p = e / (kCT / 4), c = 4 * (e % (kCT / 4));
        stage4(ss + p * kCT + c, slab_col + mt + (int64_t)p * ibs + c);
      }
    }
    float* vs = smem + L.vs + b * kApplyRows * kLDV;
#pragma unroll 1
    for (int e = tid; e < kApplyRows * kAP / 4; e += kApplyThreads) {
      const int row = e / (kAP / 4), p = 4 * (e % (kAP / 4));
      const int s = row / FP, f = f0 + row % FP;
      const bool ok = s < nq && f < F;
      stage4z(vs + row * kLDV + p,
              ok ? v + ((int64_t)(q0 + s) * F + f) * rows_len + r0 + p : v,
              ok);
    }
  };
  // a2, rowmax and 1 / rowsum of chunk ci's rows: one row a thread of the
  // first G * kAP, loaded into registers after the chunk's first barrier
  // and stored, the reciprocal taken, after its product
  const bool has_row = tid < G * kAP && tid / kAP < nq;
  float ra2 = 0.f, rmx = 0.f, rsm = 0.f;
  auto load_rows = [&](int ci) {
    if (has_row) {
      const int64_t r =
          (int64_t)(q0 + tid / kAP) * rows_len + row_of(ci) + tid % kAP;
      ra2 = to_f32(a2[r]);
      rmx = rowmax[r];
      rsm = rowsum[r];
    }
  };
  auto store_rows = [&](int b) {
    if (tid < G * kAP) {
      float* rs = smem + L.rows + b * 3 * G * kAP;
      rs[tid] = ra2;
      rs[G * kAP + tid] = rmx;
      rs[2 * G * kAP + tid] = __fdiv_rn(1.f, fmaxf(rsm, 1e-30f));
    }
  };

  for (int e = tid; e < G * kCT; e += kApplyThreads)
    a1s[e] = e / kCT < nq
                 ? to_f32(a1[(int64_t)(q0 + e / kCT) * Np + c0 + e % kCT])
                 : 0.f;
  {  // the 4-row groups' entry offsets of the block's chunks
    const int64_t first =
        (((int64_t)j * (ibs / kCT) + lc0 / kCT) * W + k0) * cpb;
    for (int e = tid; e < nch * 9; e += kApplyThreads)
      offs[e] = sup_offs[first * 9 + e];
  }
  for (int f0 = 0; f0 < F; f0 += FP) {
    float acc[kAF][4] = {};
    __syncthreads();  // the previous pass's readers are done
    stage(0, 0, f0);
    cp_commit();
    load_rows(0);
    store_rows(0);
    for (int ci = 0; ci < nch; ++ci) {
      const int b = ci & 1;
      cp_wait<0>();
      // chunk ci has landed for every thread; every thread is done with
      // chunk ci - 1 (Cs and the other buffers)
      __syncthreads();
      if (ci + 1 < nch) {
        stage(b ^ 1, ci + 1, f0);
        load_rows(ci + 1);
      }
      cp_commit();
      // the slot's coefficients alpha (* S) of the chunk
      bool nz = false;
      if (slot < nq) {
        const int16_t* es =
            reinterpret_cast<const int16_t*>(smem + L.ents + b * kAP * kCT / 2);
        const float* ss = smem + L.slab + b * kAP * kCT;
        const float* rs = smem + L.rows + b * 3 * G * kAP + slot * kAP;
        const int lane = tid % 32, g0 = (u / 32) * GPW;
        float4* cz =
            reinterpret_cast<float4*>(Cs + (slot * kAP + 4 * g0) * kCT);
        for (int e = lane; e < GPW * kCT; e += 32)
          cz[e] = make_float4(0.f, 0.f, 0.f, 0.f);
        __syncwarp();
        const int* o = offs + ci * 9;
        const float* a1r = a1s + slot * kCT;
        const int e1 = o[g0 + GPW] - o[0];
        nz = o[g0] < o[g0 + GPW];
        for (int e = o[g0] - o[0] + lane; e < e1; e += 32) {
          const int idx = es[e], p = idx / kCT, c = idx % kCT;
          const float al = alpha(rs[p], a1r[c], 1.f, rs[G * kAP + p],
                                 rs[2 * G * kAP + p], slope);
          Cs[(slot * kAP + p) * kCT + c] =
              with_s ? __fmul_rn(al, ss[p * kCT + c]) : al;
        }
      }
      // a chunk with no support adds exact zeros: skip its product
      const int live = __syncthreads_or(nz);
      if (live && slot < nq) {
        const float* vr = smem + L.vs + b * kApplyRows * kLDV +
                          (slot * FP + fg) * kLDV;
        const float* cr = Cs + slot * kAP * kCT + 4 * cg;
        // the thread's features in two halves, so that the four rows of
        // coefficients and half the features' v are live at once
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll 2
          for (int p = 0; p < kAP; p += 4) {
            float4 c[4];
#pragma unroll
            for (int t = 0; t < 4; ++t)
              c[t] = *reinterpret_cast<const float4*>(cr + (p + t) * kCT);
#pragma unroll
            for (int i = h * kAF / 2; i < (h + 1) * kAF / 2; ++i) {
              const float4 a =
                  *reinterpret_cast<const float4*>(vr + i * NFG * kLDV + p);
              const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                acc[i][0] = fmaf(av[t], c[t].x, acc[i][0]);
                acc[i][1] = fmaf(av[t], c[t].y, acc[i][1]);
                acc[i][2] = fmaf(av[t], c[t].z, acc[i][2]);
                acc[i][3] = fmaf(av[t], c[t].w, acc[i][3]);
              }
            }
          }
        }
      }
      if (ci + 1 < nch) store_rows(b ^ 1);
    }
    if (slot < nq) {
#pragma unroll
      for (int i = 0; i < kAF; ++i) {
        const int f = f0 + fg + NFG * i;
        if (f < F)
          store4(y + ((int64_t)(q0 + slot) * F + f) * Np + c0 + 4 * cg,
                 acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
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

// ---------------------------------------------------------------------------
// attn_bwd_mma_kernel: kernels 9 and 12 in bf16, on tensor cores
// ---------------------------------------------------------------------------

// The bf16 backward keeps bf16 in shared memory: a window chunk's mask,
// slab, g and a1 (16-byte cp.async, a ring of kBwdMmaStages chunks), the
// tile's v. Its two products run as mma.sync.m16n8k16 (bf16 in, f32
// accumulators). A block serves kBwdG signal rows of one row block in
// 64-row tiles; each of its warps owns 16 rows of the tile for one signal
// row, so dv^T (16 rows x F) and the rows' da2 stay in the warp's
// registers over the whole window, and only the da1 column sums cross
// warps.
constexpr int kMmaPad = 8;             // bf16 after each staged row: row
                                       // strides of an odd number of
                                       // 16-byte units, so the 8 rows of an
                                       // ldmatrix fall on distinct banks
constexpr int kLDC = kBC + kMmaPad;    // a staged chunk row (mask, slab, g)
constexpr int kLDRb = kBH + kMmaPad;   // a staged v or dv row (64-row tile)
constexpr int kSliceWarps = kBH / 16;  // warps (16-row slices) a signal row
constexpr int kBwdG = 2;               // signal rows (slots) a block
constexpr int kBwdMmaMaxNF = 4;        // F <= 64: dv^T in registers
constexpr int kBwdMmaStages = 3;       // chunks staged ahead: 2

// Dynamic shared memory of attn_bwd_mma_kernel, offsets in bytes.
struct BwdMmaLayout {
  int FP;    // F rounded up to the k16 step of v^T g
  int nch;   // chunks of a window at most
  size_t vs, dvo, stage, stage_bytes, red, da1, live, list, bytes;
};

__host__ __device__ inline BwdMmaLayout bwd_mma_layout(int F, int W,
                                                       int ibs) {
  constexpr int G = kBwdG;
  BwdMmaLayout L;
  L.FP = (F + 15) / 16 * 16;
  L.nch = W * (ibs / kBC);
  const size_t tile = 2 * (size_t)G * L.FP * kLDRb;  // [slot][f][r]
  L.vs = 0;                                        // v of the tile
  L.dvo = L.vs + tile;                             // dv of the tile
  L.stage = L.dvo + tile;                          // the chunk ring:
  L.stage_bytes = 2 * (2 * (size_t)kBH * kLDC      //   mask and slab [r][c]
                       + (size_t)G * L.FP * kLDC   //   g [slot][f][c]
                       + (size_t)G * kBC);         //   a1 [slot][c]
  L.red = L.stage + kBwdMmaStages * L.stage_bytes;  // 2 x the warps' da1
  L.da1 = L.red + sizeof(float) * 2 * kSliceWarps * G * kBC;  // column sums
  L.live = L.da1 + sizeof(float) * (size_t)G * W * ibs;  // da1 partials
  L.list = L.live + sizeof(int) * (size_t)L.nch;   // warps with support
  L.bytes = L.list + sizeof(int) * ((size_t)L.nch + 1);
  return L;
}

__device__ __forceinline__ void cp_async16b(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; register i holds matrix i, each lane two
// elements of a row (.trans: of a column).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same from a 32-bit shared-memory address.
__device__ __forceinline__ void ldsm_x4_at(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans_at(unsigned (&r)[4],
                                                 unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

// Two f32 values as the bf16 pairs hi and lo with hi + lo within 2^-16 of
// their magnitude (a before b in each word): the coefficient of the dv
// product, split so that two bf16 products carry its f32 value.
__device__ __forceinline__ void split_pair(float a, float b, unsigned& hi,
                                           unsigned& lo) {
  const bf16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
  hi = (unsigned)__bfloat16_as_ushort(ha) |
       ((unsigned)__bfloat16_as_ushort(hb) << 16);
  lo = bf16_pair(__fsub_rn(a, __bfloat162float(ha)),
                 __fsub_rn(b, __bfloat162float(hb)));
}

__device__ __forceinline__ unsigned ld_pair(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// attn_bwd_kernel's function on bf16 g, a1, a2, v, slab_col and mask_row
// (f32 rowmax, rowsum; f32 da2 and da1p; dv in bf16, rounded once), every
// score, exp and sum in f32, as the JAX kernel computes it on bf16
// operands (_make_bwd_kernel's .astype(float32)); the products on tensor
// cores. A block serves the kBwdG = 2 signal rows q0, q0 + 1 (slots; one
// past Q idles) of row block i, in tiles of kBH = 64 rows, and walks the
// window in chunks of kBC columns: each chunk's mask and slab are staged
// once for both slots, g and a1 for each, in a ring of kBwdMmaStages
// (16-byte cp.async two chunks ahead, one barrier a chunk). Warp (slot,
// slice) = (warp / 4, warp % 4) owns rows 16 slice .. + 15 of the tile
// for its slot's signal row; in its m16n8 fragments lane (gr, tq) =
// (lane / 4, lane % 4) holds rows gr and gr + 8 and the column (or
// feature) pairs 8 n + 2 tq. Two passes a tile:
//  A: the chunk's coefficients alpha (* S), computed in registers where
//     mma.sync's A fragment wants them (the accumulator layout of two n8
//     tiles is the A layout of one k16 slice), split into bf16 hi + lo,
//     and dv^T += coeff . g^T: the slot's g [f][c] chunk is the B operand
//     by plain ldmatrix, two mma.sync a product (hi, lo) into one f32
//     accumulator, so the coefficient's rounding stays below 2^-16 where
//     one bf16 rounding would be 2^-9. A k16 slice without support in the
//     warp's rows skips its products; a warp marks the chunks where it
//     found support. After the window,
//     delta = sum_f v dv^T of each row (a quad's shuffles), and dv is
//     rounded to bf16 and written through shared memory.
//  B: over the chunks where some warp found support, for those warps:
//     v^T g (A from the slot's v [f][r] tile by ldmatrix.trans, B from its
//     g chunk by ldmatrix.trans) into 16 x 64 f32 fragments, then dalpha,
//     de, dpre; da2 sums along the thread's rows, the da1 partials
//     down the columns (shuffles over the 8 row groups, then each slot's 4
//     slices in order, one chunk later, through shared memory):
//     deterministic, no atomics.
// A warp's arithmetic depends on its own rows alone (the chunks and
// slices it skips too), so each shard of the ext instance gives the global
// one's rows. Two slots a block: the mask and slab come from L2 once for
// two signal rows; four (16 warps, one block an SM) ran slower.
// NF = FP / 16 (F <= 16 NF). Grid ceil(Q / 2) * nb, the slot pairs of a
// row block adjacent; 256 threads; dynamic shared memory
// bwd_mma_layout(F, W, ibs).bytes; g, a1, v, slab_col, mask_row and dv
// 16-byte aligned. Two blocks an SM under 128 registers up to F = 32; one
// from NF = 3 (their dv^T fragments spill under 128).
template <bool kExt, int NF>
__global__ void __launch_bounds__(kBwdThreads, NF <= 2 ? 2 : 1)
attn_bwd_mma_kernel(const bf16* __restrict__ g, const bf16* __restrict__ a1,
                    const bf16* __restrict__ a2, const bf16* __restrict__ v,
                    const float* __restrict__ rowmax,
                    const float* __restrict__ rowsum,
                    const bf16* __restrict__ slab_col,
                    const bf16* __restrict__ mask_row,
                    float* __restrict__ da2, float* __restrict__ da1p,
                    bf16* __restrict__ dv, int Q, int F, int Np, int nb,
                    int w, int ibs, int with_s, float slope) {
  constexpr int FP = 16 * NF;
  constexpr int G = kBwdG;
  constexpr int kWarps = kSliceWarps * G;
  static_assert(32 * kWarps == kBwdThreads, "a warp a 16-row slice a slot");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = 2 * w + 1;
  const BwdMmaLayout L = bwd_mma_layout(F, W, ibs);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + L.vs);
  bf16* DVo = reinterpret_cast<bf16*>(smem_raw + L.dvo);
  float* red = reinterpret_cast<float*>(smem_raw + L.red);
  float* da1s = reinterpret_cast<float*>(smem_raw + L.da1);
  int* live = reinterpret_cast<int*>(smem_raw + L.live);
  int* list = reinterpret_cast<int*>(smem_raw + L.list);
  // stage b: mask [kBH][kLDC], slab [kBH][kLDC], g [G][FP][kLDC], a1 [G][kBC]
  auto Ms = [&](int b) {
    return reinterpret_cast<bf16*>(smem_raw + L.stage + b * L.stage_bytes);
  };
  auto Ss = [&](int b) { return Ms(b) + kBH * kLDC; };
  auto Gs = [&](int b) { return Ms(b) + 2 * kBH * kLDC; };
  auto A1s = [&](int b) { return Ms(b) + (2 * kBH + G * FP) * kLDC; };

  const int n_groups = (Q + G - 1) / G;
  const int q0 = (blockIdx.x % n_groups) * G;
  const int nq = min(G, Q - q0);  // slots in use
  const int i = blockIdx.x / n_groups;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int slot = warp / kSliceWarps;
  const int m0 = 16 * (warp % kSliceWarps);  // the warp's first row of a tile
  const bool mine = slot < nq;  // the warp's signal row exists
  const int gr = lane / 4, tq = lane % 4;
  const int cols_len = kExt ? Np + 2 * w * ibs : Np;  // g's and a1's rows
  const int lag = kExt ? 0 : w;  // column block of window block k: i + k - lag
  const int64_t qn = (int64_t)(q0 + slot) * Np;
  const int k0 = kExt ? 0 : max(0, w - i);
  const int k1 = kExt ? W : min(W, nb + w - i);
  const int ncc = ibs / kBC;
  const int nch = (k1 - k0) * ncc;  // chunk ci: tile k0 + ci / ncc
  const bf16 zero = __ushort_as_bfloat16((unsigned short)0);

  // chunk ci of the window for the tile's rows t0 .. t0 + kBH into stage
  // b: the mask and (with_s) the slab once, g's F rows and a1 of each slot
  auto stage = [&](int b, int ci, int t0) {
    const int k = k0 + ci / ncc, cc = (ci % ncc) * kBC;
    const int64_t c0 =
        (int64_t)(i + k - lag) * ibs + cc;  // first column in g and a1
    const bf16* mt = mask_row + (((int64_t)i * W + k) * ibs + t0) * ibs + cc;
    const bf16* st =
        slab_col +
        (((int64_t)(i + k - lag) * W + (2 * w - k)) * ibs + t0) * ibs + cc;
    bf16* ms = Ms(b);
    bf16* ss = Ss(b);
    bf16* gs = Gs(b);
    for (int e = tid; e < kBH * (kBC / 8); e += kBwdThreads) {
      const int r = e / (kBC / 8), c = 8 * (e % (kBC / 8));
      cp_async16b(ms + r * kLDC + c, mt + (int64_t)r * ibs + c);
      if (with_s) cp_async16b(ss + r * kLDC + c, st + (int64_t)r * ibs + c);
    }
    for (int s = 0; s < nq; ++s)
      for (int e = tid; e < F * (kBC / 8); e += kBwdThreads) {
        const int f = e / (kBC / 8), c = 8 * (e % (kBC / 8));
        cp_async16b(gs + (s * FP + f) * kLDC + c,
                    g + ((int64_t)(q0 + s) * F + f) * cols_len + c0 + c);
      }
    if (tid < nq * (kBC / 8)) {
      const int s = tid / (kBC / 8), c = 8 * (tid % (kBC / 8));
      cp_async16b(A1s(b) + s * kBC + c,
                  a1 + (int64_t)(q0 + s) * cols_len + c0 + c);
    }
  };
  // each slot's da1 column sums of a chunk (red buffer par): its 4 slices
  // in order; thread tid < nq * kBC
  auto fold = [&](int par, int ci) {
    const int s = tid / kBC, c = tid % kBC;
    const int k = k0 + ci / ncc, cc = (ci % ncc) * kBC;
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < kSliceWarps; ++m)
      sum += red[(par * kWarps + s * kSliceWarps + m) * kBC + c];
    da1s[s * W * ibs + k * ibs + cc + c] += sum;
  };

  // the padded features of v and of g are never staged: zeros
  for (int e = tid; e < G * (FP - F) * kLDRb; e += kBwdThreads) {
    const int s = e / ((FP - F) * kLDRb);
    Vs[(s * FP + F) * kLDRb + e % ((FP - F) * kLDRb)] = zero;
  }
  for (int e = tid; e < kBwdMmaStages * G * (FP - F) * kLDC;
       e += kBwdThreads) {
    const int b = e / (G * (FP - F) * kLDC), r = e % (G * (FP - F) * kLDC);
    const int s = r / ((FP - F) * kLDC);
    Gs(b)[(s * FP + F) * kLDC + r % ((FP - F) * kLDC)] = zero;
  }
  for (int e = tid; e < G * W * ibs; e += kBwdThreads) da1s[e] = 0.f;

  for (int t0 = 0; t0 < ibs; t0 += kBH) {
    const int64_t r0 = (int64_t)i * ibs + t0;
    __syncthreads();  // the previous tile's readers are done
    for (int s = 0; s < nq; ++s)
      for (int e = tid; e < F * (kBH / 8); e += kBwdThreads) {
        const int f = e / (kBH / 8), r = 8 * (e % (kBH / 8));
        cp_async16b(Vs + (s * FP + f) * kLDRb + r,
                    v + ((int64_t)(q0 + s) * F + f) * Np + r0 + r);
      }
    cp_commit();
    for (int e = tid; e < nch; e += kBwdThreads) live[e] = 0;
    // the thread's rows gr and gr + 8: a2, rowmax, 1 / rowsum
    float ra2[2] = {0.f, 0.f}, rmx[2] = {0.f, 0.f}, rrv[2] = {0.f, 0.f};
    if (mine) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = qn + r0 + m0 + gr + 8 * h;
        ra2[h] = __bfloat162float(a2[r]);
        rmx[h] = rowmax[r];
        rrv[h] = __fdiv_rn(1.f, fmaxf(rowsum[r], 1e-30f));
      }
    }
    const bf16* vs = Vs + slot * FP * kLDRb;

    // pass A: the coefficients, dv^T, and which warps found support
    float dva[2 * NF][4];
#pragma unroll
    for (int n = 0; n < 2 * NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dva[n][e] = 0.f;
    stage(0, 0, t0);
    cp_commit();
    if (nch > 1) stage(1, 1, t0);
    cp_commit();
    for (int ci = 0; ci < nch; ++ci) {
      const int b = ci % kBwdMmaStages;
      cp_wait<1>();
      // chunk ci (and v) landed for every thread, and every thread is
      // done with chunk ci - 1's stage
      __syncthreads();
      if (ci + 2 < nch) stage((ci + 2) % kBwdMmaStages, ci + 2, t0);
      cp_commit();
      if (!mine) continue;
      const bf16* ms = Ms(b) + (m0 + gr) * kLDC + 2 * tq;
      const bf16* ss = Ss(b) + (m0 + gr) * kLDC + 2 * tq;
      const bf16* gs = Gs(b) + slot * FP * kLDC;
      const bf16* a1c = A1s(b) + slot * kBC + 2 * tq;
      bool found = false;
#pragma unroll
      for (int s = 0; s < kBC / 16; ++s) {
        unsigned ahi[4], alo[4];
        bool nz = false;
#pragma unroll
        for (int p = 0; p < 2; ++p) {  // columns 16 s + 8 p + 2 tq, + 1
          const int c = 16 * s + 8 * p;
          const unsigned a1p = ld_pair(a1c + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows gr + 8 h
            const unsigned mm = ld_pair(ms + 8 * h * kLDC + c);
            const unsigned sv = with_s ? ld_pair(ss + 8 * h * kLDC + c) : 0u;
            float cf[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float m = j ? bf16_hi(mm) : bf16_lo(mm);
              const float al = alpha(ra2[h], j ? bf16_hi(a1p) : bf16_lo(a1p),
                                     m, rmx[h], rrv[h], slope);
              cf[j] = with_s ? __fmul_rn(al, j ? bf16_hi(sv) : bf16_lo(sv))
                             : al;
              nz |= m != 0.f;
            }
            // A fragment register h + 2 p: rows gr + 8 h, k 8 p + 2 tq
            split_pair(cf[0], cf[1], ahi[h + 2 * p], alo[h + 2 * p]);
          }
        }
        if (!__any_sync(0xffffffffu, nz)) continue;  // adds exact zeros
        found = true;
#pragma unroll
        for (int nj = 0; nj < NF; ++nj) {
          // B of the features 16 nj .. + 16 (n) at k 16 s .. + 16: g's rows
          // as stored ([n][k]); matrices (n 0-7, k 0-7), (n 0-7, k 8-15),
          // (n 8-15, k 0-7), (n 8-15, k 8-15)
          unsigned bb[4];
          ldsm_x4(bb, gs + (16 * nj + lane % 8 + 8 * (lane / 16)) * kLDC +
                          16 * s + 8 * ((lane / 8) % 2));
          mma_bf16(dva[2 * nj], ahi, bb[0], bb[1]);
          mma_bf16(dva[2 * nj], alo, bb[0], bb[1]);
          mma_bf16(dva[2 * nj + 1], ahi, bb[2], bb[3]);
          mma_bf16(dva[2 * nj + 1], alo, bb[2], bb[3]);
        }
      }
      if (found && lane == 0) atomicOr(live + ci, 1 << warp);
    }
    // delta = sum_f v dv of each row (the quad's 4 feature groups in a
    // fixed tree); dv rounded to bf16 into DVo
    float dl[2] = {0.f, 0.f};
    if (mine) {
      bf16* dvo = DVo + slot * FP * kLDRb;
#pragma unroll
      for (int n = 0; n < 2 * NF; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int r = m0 + gr + 8 * h, f = 8 * n + 2 * tq + j;
            const float d = dva[n][2 * h + j];
            dl[h] = fmaf(__bfloat162float(vs[f * kLDRb + r]), d, dl[h]);
            dvo[f * kLDRb + r] = __float2bfloat16_rn(d);
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dl[h] += __shfl_xor_sync(0xffffffffu, dl[h], 1);
        dl[h] += __shfl_xor_sync(0xffffffffu, dl[h], 2);
      }
    }
    __syncthreads();  // DVo and the support bits complete
    for (int s = 0; s < nq; ++s)
      for (int e = tid; e < F * (kBH / 8); e += kBwdThreads) {
        const int f = e / (kBH / 8), r = 8 * (e % (kBH / 8));
        *reinterpret_cast<uint4*>(dv + ((int64_t)(q0 + s) * F + f) * Np +
                                  r0 + r) =
            *reinterpret_cast<const uint4*>(DVo + (s * FP + f) * kLDRb + r);
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
    float d2[2] = {0.f, 0.f};
    if (n_live > 0) stage(0, list[0], t0);
    cp_commit();
    if (n_live > 1) stage(1, list[1], t0);
    cp_commit();
    for (int li = 0; li < n_live; ++li) {
      const int b = li % kBwdMmaStages, ci = list[li];
      cp_wait<1>();
      // chunk li landed; li - 1's stage is free and its column sums are
      // complete
      __syncthreads();
      if (li > 0 && tid < nq * kBC) fold((li - 1) & 1, list[li - 1]);
      if (li + 2 < n_live)
        stage((li + 2) % kBwdMmaStages, list[li + 2], t0);
      cp_commit();
      float* rd = red + ((li & 1) * kWarps + warp) * kBC + 2 * tq;
      if (!(mine && ((live[ci] >> warp) & 1))) {
        if (lane < 4)
#pragma unroll
          for (int n = 0; n < kBC / 8; ++n)
            *reinterpret_cast<float2*>(rd + 8 * n) = make_float2(0.f, 0.f);
        continue;
      }
      const bf16* gs = Gs(b) + slot * FP * kLDC;
      const bf16* a1c = A1s(b) + slot * kBC + 2 * tq;
      const bf16* ms = Ms(b) + (m0 + gr) * kLDC + 2 * tq;
      const bf16* ss = Ss(b) + (m0 + gr) * kLDC + 2 * tq;
      // the chunk in two halves of kBC / 2 columns (half the accumulators
      // live at a time)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        constexpr int kN = kBC / 16;  // n8 tiles a half
        float acc[kN][4];
#pragma unroll
        for (int n = 0; n < kN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
        for (int kf = 0; kf < NF; ++kf) {
          // A = v^T (rows m0 .. + 16, features 16 kf .. + 16) from v's
          // [f][r] tile: matrices (m 0-7, k 0-7), (m 8-15, k 0-7),
          // (m 0-7, k 8-15), (m 8-15, k 8-15), each stored k-major
          unsigned a[4];
          ldsm_x4_trans(a, vs + (16 * kf + lane % 8 + 8 * (lane / 16)) *
                                    kLDRb +
                               m0 + 8 * ((lane / 8) % 2));
#pragma unroll
          for (int nj = 0; nj < kN / 2; ++nj) {
            // B = g (features 16 kf .. + 16, columns 16 nj .. + 16 of the
            // half) from its row-major [k][n] chunk
            unsigned bb[4];
            ldsm_x4_trans(bb, gs + (16 * kf + lane % 16) * kLDC +
                                  kBC / 2 * half + 16 * nj + 8 * (lane / 16));
            mma_bf16(acc[2 * nj], a, bb[0], bb[1]);
            mma_bf16(acc[2 * nj + 1], a, bb[2], bb[3]);
          }
        }
        float cs[kN][2];  // dpre down the columns kBC/2 half + 8 n + 2 tq + j
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const int c = kBC / 2 * half + 8 * n;
          const unsigned a1p = ld_pair(a1c + c);
          cs[n][0] = cs[n][1] = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned mm = ld_pair(ms + 8 * h * kLDC + c);
            const unsigned sv =
                with_s ? ld_pair(ss + 8 * h * kLDC + c) : 0u;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float a1v = j ? bf16_hi(a1p) : bf16_lo(a1p);
              const float al =
                  alpha(ra2[h], a1v, j ? bf16_hi(mm) : bf16_lo(mm), rmx[h],
                        rrv[h], slope);
              const float dco = acc[n][2 * h + j];
              const float dal =
                  with_s ? __fmul_rn(dco, j ? bf16_hi(sv) : bf16_lo(sv))
                         : dco;
              const float de = __fmul_rn(al, __fsub_rn(dal, dl[h]));
              // de * m: de is 0 where m is
              const float dpre =
                  __fmul_rn(de, __fadd_rn(ra2[h], a1v) > 0.f ? 1.f : slope);
              d2[h] = __fadd_rn(d2[h], dpre);
              cs[n][j] = __fadd_rn(cs[n][j], dpre);
            }
          }
        }
        // the 8 row groups of each column (lanes tq, tq + 4, ...)
#pragma unroll
        for (int n = 0; n < kN; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int o = 4; o < 32; o <<= 1)
              cs[n][j] += __shfl_xor_sync(0xffffffffu, cs[n][j], o);
        if (lane < 4)
#pragma unroll
          for (int n = 0; n < kN; ++n)
            *reinterpret_cast<float2*>(rd + kBC / 2 * half + 8 * n) =
                make_float2(cs[n][0], cs[n][1]);
      }
    }
    __syncthreads();  // the last chunk's column sums are complete
    if (n_live > 0 && tid < nq * kBC)
      fold((n_live - 1) & 1, list[n_live - 1]);
    // da2 of each row: the quad's 4 column groups
    if (mine) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        d2[h] += __shfl_xor_sync(0xffffffffu, d2[h], 1);
        d2[h] += __shfl_xor_sync(0xffffffffu, d2[h], 2);
        if (tq == 0) da2[qn + r0 + m0 + gr + 8 * h] = d2[h];
      }
    }
  }
  __syncthreads();  // da1s complete
  for (int e = tid; e < nq * W * ibs; e += kBwdThreads) {
    const int s = e / (W * ibs), ee = e % (W * ibs), k = ee / ibs;
    da1p[((int64_t)(q0 + s) * nb + i) * W * ibs + ee] =
        k >= k0 && k < k1 ? da1s[s * W * ibs + ee] : 0.f;
  }
}

size_t bwd_mma_smem_bytes(int F, int W, int ibs) {
  return bwd_mma_layout(F, W, ibs).bytes;
}

template <bool kExt, int NF>
cudaError_t launch_bwd_mma_nf(const bf16* g, const bf16* a1, const bf16* a2,
                              const bf16* v, const float* rowmax,
                              const float* rowsum, const bf16* slab_col,
                              const bf16* mask_row, float* da2, float* da1p,
                              bf16* dv, int Q, int F, int Np, int nb, int w,
                              int ibs, int with_s, float slope, size_t smem,
                              unsigned blocks, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_mma_kernel<kExt, NF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_bwd_mma_kernel<kExt, NF><<<blocks, kBwdThreads, smem, stream>>>(
      g, a1, a2, v, rowmax, rowsum, slab_col, mask_row, da2, da1p, dv, Q, F,
      Np, nb, w, ibs, with_s, slope);
  return cudaGetLastError();
}

// The bf16 backward: attn_bwd_mma_kernel<kExt, ceil(F / 16)>; refuses
// what launch_bwd refuses, and F above 16 * kBwdMmaMaxNF.
template <bool kExt>
cudaError_t launch_bwd(const bf16* g, const bf16* a1, const bf16* a2,
                       const bf16* v, const float* rowmax,
                       const float* rowsum, const bf16* slab_col,
                       const bf16* mask_row, float* da2, float* da1p,
                       bf16* dv, int Q, int F, int Np, int nb, int w,
                       int ibs, int with_s, float slope,
                       cudaStream_t stream) {
  if (Q <= 0 || F <= 0 || F > 16 * kBwdMmaMaxNF || ibs % kBC != 0 ||
      ibs % kBH != 0 || Np != nb * ibs || w < 0 || (kExt && w > nb))
    return cudaErrorInvalidValue;
  for (const void* p : {(const void*)g, (const void*)a1, (const void*)v,
                        (const void*)slab_col, (const void*)mask_row,
                        (const void*)dv})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  const long long blocks = (long long)((Q + kBwdG - 1) / kBwdG) * nb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = bwd_mma_smem_bytes(F, 2 * w + 1, ibs);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const unsigned nblk = (unsigned)blocks;
  switch ((F + 15) / 16) {
    case 1:
      return launch_bwd_mma_nf<kExt, 1>(g, a1, a2, v, rowmax, rowsum,
                                        slab_col, mask_row, da2, da1p, dv, Q,
                                        F, Np, nb, w, ibs, with_s, slope,
                                        smem, nblk, stream);
    case 2:
      return launch_bwd_mma_nf<kExt, 2>(g, a1, a2, v, rowmax, rowsum,
                                        slab_col, mask_row, da2, da1p, dv, Q,
                                        F, Np, nb, w, ibs, with_s, slope,
                                        smem, nblk, stream);
    case 3:
      return launch_bwd_mma_nf<kExt, 3>(g, a1, a2, v, rowmax, rowsum,
                                        slab_col, mask_row, da2, da1p, dv, Q,
                                        F, Np, nb, w, ibs, with_s, slope,
                                        smem, nblk, stream);
    default:
      return launch_bwd_mma_nf<kExt, 4>(g, a1, a2, v, rowmax, rowsum,
                                        slab_col, mask_row, da2, da1p, dv, Q,
                                        F, Np, nb, w, ibs, with_s, slope,
                                        smem, nblk, stream);
  }
}

// ---------------------------------------------------------------------------
// attn_stats_bf16_kernel: kernels 7 and 10 on bf16 operands
// ---------------------------------------------------------------------------

// Dynamic shared memory of attn_stats_bf16_kernel for qb signal rows, rb
// rows and a window of WI = W * ibs positions, offsets in bytes: a1's
// window transposed, bf16 [position][qs] (qs: qb rounded up to a whole
// word); the rows' mask, bf16 [r][WI], compacted in place into their
// support lists; a2 of the block, f32 [q][r]; rowmax and rowsum, f32
// [q][r] each.
struct StatsBf16Layout {
  int qs;
  size_t a1, ms, a2, out, bytes;
};

__host__ __device__ inline StatsBf16Layout stats_bf16_layout(int qb, int rb,
                                                             int WI) {
  StatsBf16Layout L;
  L.qs = (qb + 1) / 2 * 2;
  L.a1 = 0;
  L.ms = ((size_t)WI * L.qs * 2 + 15) / 16 * 16;
  L.a2 = L.ms + (size_t)rb * WI * 2;
  L.out = L.a2 + sizeof(float) * (size_t)qb * rb;
  L.bytes = L.out + 2 * sizeof(float) * (size_t)qb * rb;
  return L;
}

// A bf16 value from its bits, exactly
__device__ __forceinline__ float bf16_bits(unsigned short u) {
  return __uint_as_float((unsigned)u << 16);
}

// attn_stats_kernel's function on bf16 a1, a2 and mask_row (f32 rowmax
// and rowsum), every score, exp and sum in f32. A block serves rb rows of
// one row block for the signal rows q0 .. q0 + qb - 1 (grid: Np / rb row
// groups x ceil(Q / qb) signal groups, the signal group fastest). In one
// round trip it stages the rows' mask across the window by 16-byte
// cp.async, the a1 window of its signal rows by 16-byte loads stored
// transposed ([position][q]: the lanes that read one position for
// consecutive signal rows read consecutive halves of words, no bank
// conflict) and a2. Each warp compacts the support of its rows from
// shared memory in place (ballot and popc over 32 positions a step; the
// list, ascending window positions, overwrites the row's mask behind the
// read), then walks the list with lane (h, q) = (lane / QL, lane % QL),
// QL the power of 2 from qb up, on signal row q over the entries h,
// h + H, ... (H = 32 / QL): a serial max, the max over the H lanes (a xor
// tree over h), then a serial exp-sum and its fixed xor tree. At slope >= 0
// the max walks the a1 values alone (the score is monotone in a1). A masked
// score is -1e12 and adds exactly 0 to the sum, so only the order of the
// support's terms differs from the dense form. rowmax and rowsum go out
// through shared memory in coalesced rows. A row without support gets
// rowmax -1e12 and rowsum W * ibs. The list and H depend on the row's
// support and on (Q, W * ibs) alone, so the global and ext instances give
// a row the same bits (ext window block k is global window block k; the
// global instance leaves out the blocks past the matrix, whose mask is 0).
// vec: a1 and mask_row 16-byte aligned (else element copies). Dynamic
// shared memory stats_bf16_layout(qb, rb, W * ibs).bytes.
template <bool kExt>
__global__ void __launch_bounds__(kStatsThreads, 4)
attn_stats_bf16_kernel(const bf16* __restrict__ a1,
                       const bf16* __restrict__ a2,
                       const bf16* __restrict__ mask_row,
                       float* __restrict__ rowmax,
                       float* __restrict__ rowsum, int Q, int Np, int nb,
                       int w, int ibs, float slope, int rb, int qb,
                       int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = 2 * w + 1, WI = W * ibs;
  const StatsBf16Layout L = stats_bf16_layout(qb, rb, WI);
  unsigned short* a1t = reinterpret_cast<unsigned short*>(smem_raw + L.a1);
  unsigned short* ms = reinterpret_cast<unsigned short*>(smem_raw + L.ms);
  float* a2s = reinterpret_cast<float*>(smem_raw + L.a2);
  float* mxs = reinterpret_cast<float*>(smem_raw + L.out);
  float* sms = mxs + qb * rb;
  const unsigned short* a1b = reinterpret_cast<const unsigned short*>(a1);
  const unsigned short* mb = reinterpret_cast<const unsigned short*>(mask_row);
  const int a1_len = kExt ? Np + 2 * w * ibs : Np;  // a1's row length
  const int lag = kExt ? 0 : w;  // a1 block of window block k: i + k - lag
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_qg = (Q + qb - 1) / qb;
  const int q0 = (blockIdx.x % n_qg) * qb, nq = min(qb, Q - q0);
  const int row0 = (blockIdx.x / n_qg) * rb;
  const int i = row0 / ibs, p0 = row0 % ibs;  // ibs % rb == 0
  const int k0 = kExt ? 0 : max(0, w - i);
  const int k1 = kExt ? W : min(W, nb + w - i);
  const int first = k0 * ibs, span = (k1 - k0) * ibs;
  // mask element (row p0 + r, window position first + c)
  auto mask_at = [&](int r, int c) {
    return (((int64_t)i * W + k0 + c / ibs) * ibs + p0 + r) * ibs + c % ibs;
  };

  // the rows' mask across the window -> ms[r * WI + position]
  if (vec) {
    for (int e = tid; e < rb * (span / 8); e += kStatsThreads) {
      const int r = e / (span / 8), c = 8 * (e % (span / 8));
      cp_async16b(ms + r * WI + first + c, mask_row + mask_at(r, c));
    }
  } else {
    for (int e = tid; e < rb * span; e += kStatsThreads)
      ms[e / span * WI + first + e % span] = mb[mask_at(e / span, e % span)];
  }
  cp_commit();
  for (int e = tid; e < nq * rb; e += kStatsThreads)
    a2s[e] = __bfloat162float(a2[(int64_t)(q0 + e / rb) * Np + row0 + e % rb]);
  // a1[q0 + qq, window] -> a1t[position * qs + qq], consecutive threads on
  // consecutive signal rows (8 positions a thread, all loads first)
  const int64_t a1w = (int64_t)q0 * a1_len + (int64_t)(i + k0 - lag) * ibs;
  if (vec) {
    const int n8 = nq * (span / 8);
    for (int e0 = tid; e0 < n8; e0 += 4 * kStatsThreads) {
      uint4 u[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = e0 + j * kStatsThreads;
        if (e < n8)
          u[j] = __ldg(reinterpret_cast<const uint4*>(
              a1b + a1w + (int64_t)(e % nq) * a1_len + 8 * (e / nq)));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = e0 + j * kStatsThreads;
        if (e < n8) {
          unsigned short* dst = a1t + (first + 8 * (e / nq)) * L.qs + e % nq;
          const unsigned words[4] = {u[j].x, u[j].y, u[j].z, u[j].w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            dst[2 * t * L.qs] = (unsigned short)(words[t] & 0xffffu);
            dst[(2 * t + 1) * L.qs] = (unsigned short)(words[t] >> 16);
          }
        }
      }
    }
  } else {
    for (int e = tid; e < nq * span; e += kStatsThreads)
      a1t[(first + e / nq) * L.qs + e % nq] =
          a1b[a1w + (int64_t)(e % nq) * a1_len + e / nq];
  }
  cp_wait<0>();
  __syncthreads();  // mask, a1 and a2 staged

  int ql = 1;
  while (ql < qb) ql *= 2;
  const int H = 32 / ql, h = lane / ql, qq = lane % ql;
  const bool on = qq < nq;
  const int qr = on ? qq : 0;  // the idle lanes read a staged signal row
  const unsigned below = (1u << lane) - 1u;
  for (int r = warp; r < rb; r += kStatsWarps) {
    unsigned short* row = ms + r * WI;
    int n = 0;
    for (int c0 = first; c0 < first + span; c0 += 32) {  // span % 32 == 0
      const unsigned short u = row[c0 + lane];
      const bool nz = (u & 0x7fffu) != 0;  // m != 0 (not +0 or -0)
      const unsigned b = __ballot_sync(0xffffffffu, nz);
      // entry n + j is at most position c0 + lane: behind every read
      if (nz) row[n + __popc(b & below)] = (unsigned short)(c0 + lane);
      n += __popc(b);
    }
    __syncwarp();  // the list is complete
    float mx = -kInfinite, sm = (float)WI;
    if (n > 0) {
      const float a2v = a2s[qr * rb + r];
      float m = -INFINITY;
      if (slope >= 0.f) {
        // the score is monotone in a1 (a rounded add, then a rounded
        // product by slope >= 0 below 0): the largest a1 gives the max,
        // bit for bit
#pragma unroll 4
        for (int t = h; t < n; t += H)
          m = fmaxf(m, bf16_bits(a1t[row[t] * L.qs + qr]));
        for (int o = ql; o < 32; o <<= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        m = leaky_score(a2v, m, slope);
      } else {
#pragma unroll 4
        for (int t = h; t < n; t += H)
          m = fmaxf(m, leaky_score(a2v, bf16_bits(a1t[row[t] * L.qs + qr]),
                                   slope));
        for (int o = ql; o < 32; o <<= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      }
      float s = 0.f;
#pragma unroll 4
      for (int t = h; t < n; t += H)
        s = __fadd_rn(s, expf(__fsub_rn(
                             leaky_score(a2v,
                                         bf16_bits(a1t[row[t] * L.qs + qr]),
                                         slope),
                             m)));
      for (int o = ql; o < 32; o <<= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      mx = m;
      sm = s;
    }
    if (h == 0 && on) {
      mxs[qq * rb + r] = mx;
      sms[qq * rb + r] = sm;
    }
  }
  __syncthreads();
  for (int e = tid; e < nq * rb; e += kStatsThreads) {
    const int64_t o = (int64_t)(q0 + e / rb) * Np + row0 + e % rb;
    rowmax[o] = mxs[e];
    rowsum[o] = sms[e];
  }
}

// ---------------------------------------------------------------------------
// attn_apply_mma_kernel: kernels 8 and 11 in bf16, on tensor cores
// ---------------------------------------------------------------------------

// 16 bytes, or (valid false) 16 zeros with nothing read
__device__ __forceinline__ void cp_async16bz(void* dst, const void* src,
                                             bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

constexpr int kApplyWarps = kApplyThreads / 32;
constexpr int kLDVb = kAP + kMmaPad;  // a staged v row (bf16)
constexpr int kLDCb = kCT + kMmaPad;  // a coefficient row (bf16)

// Dynamic shared memory of attn_apply_mma_kernel<., G>, offsets in bytes:
// two staged chunks of the support's entry list (at most kAP * kCT int16),
// of the slab (bf16 [p][c]) and of the G rows' v (bf16 [s f][p]); each
// slot's coefficients as bf16 hi and lo tiles [p][c]; two chunks of the
// rows' a2, rowmax and 1 / rowsum (f32); a1 of the block's columns (f32).
// The chunks' entry offsets follow past bytes (apply_mma_smem_bytes).
struct ApplyMmaLayout {
  int ents, slab, vs, coef, rows, a1, bytes;
};

__host__ __device__ constexpr ApplyMmaLayout apply_mma_layout(int G) {
  return ApplyMmaLayout{
      0,
      2 * 2 * kAP * kCT,
      4 * 2 * kAP * kCT,
      4 * 2 * kAP * kCT + 2 * 2 * kApplyRows * kLDVb,
      4 * 2 * kAP * kCT + 2 * 2 * kApplyRows * kLDVb + G * 2 * 2 * kAP * kLDCb,
      4 * 2 * kAP * kCT + 2 * 2 * kApplyRows * kLDVb + G * 2 * 2 * kAP * kLDCb +
          4 * 2 * 3 * G * kAP,
      4 * 2 * kAP * kCT + 2 * 2 * kApplyRows * kLDVb + G * 2 * 2 * kAP * kLDCb +
          4 * 2 * 3 * G * kAP + 4 * G * kCT};
}

// attn_apply_kernel's function on bf16 a1, a2, v and slab_col (f32 rowmax
// and rowsum; y in bf16, rounded once), every score, exp and coefficient
// in f32, as the JAX kernel computes it on bf16 operands
// (_make_apply_kernel's .astype(float32), ops/attention_flash.py:118-138),
// the product on tensor cores. The same grid, chunks, slots, support entry
// lists, row reciprocals and skipped chunks as attn_apply_kernel; the
// chunk's slab, v and entry lists stay bf16 / int16 in shared memory
// (16-byte cp.async one chunk ahead, v's features past F zero-filled, so
// F needs no padding in memory). Per chunk:
//  * the coefficients alpha (* S) in f32 on the support only, a warp's
//    lanes on the entries of its 4 G rows, each split into bf16 hi + lo
//    (hi + lo within 2^-16 of the f32 value, where one bf16 rounding would
//    be 2^-9) into the slot's two coefficient tiles, zeroed first;
//  * unless the chunk has no support (__syncthreads_or), y^T += v . coeff
//    as mma.sync.m16n8k16 (bf16 in, f32 accumulators), hi and lo into one
//    accumulator: warp (slot, mt) = (warp / WPS, warp % WPS) owns features
//    16 mt .. + 16 of its slot's pass and all kCT columns (8 n8 tiles, 32
//    accumulators a lane), A = v's [f][p] rows by ldmatrix, B = the
//    coefficient tiles' [p][c] rows by ldmatrix.trans.
// A pass covers FP = 128 / G features (WPS = 8 / G m16 tiles a slot); the
// warps whose tile lies past F only stage and score. y is written as bf16
// pairs from the accumulators. v, sup_entries, slab_col and y 16-byte
// aligned; dynamic shared memory apply_mma_smem_bytes(G, W, ibs).
template <bool kExt, int G>
__global__ void __launch_bounds__(kApplyThreads, 2)
attn_apply_mma_kernel(const bf16* __restrict__ a1, const bf16* __restrict__ a2,
                      const bf16* __restrict__ v,
                      const float* __restrict__ rowmax,
                      const float* __restrict__ rowsum,
                      const bf16* __restrict__ slab_col,
                      const int16_t* __restrict__ sup_entries,
                      const int* __restrict__ sup_offs, bf16* __restrict__ y,
                      int Q, int F, int Np, int nb, int w, int ibs, int with_s,
                      float slope) {
  constexpr int FP = kApplyRows / G;        // features a pass
  constexpr int WPS = kApplyWarps / G;      // warps (m16 tiles) a slot
  constexpr int GPW = G;                    // 4-row groups a warp
  constexpr ApplyMmaLayout L = apply_mma_layout(G);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const a1s = reinterpret_cast<float*>(smem_raw + L.a1);
  int* const offs = reinterpret_cast<int*>(smem_raw + L.bytes);
  const int W = 2 * w + 1;
  const int rows_len = kExt ? Np + 2 * w * ibs : Np;  // a2/stats/v rows
  const int lag = kExt ? 0 : w;  // row block of window block k: j + k - lag
  const int n_groups = (Q + G - 1) / G;
  const int q0 = (blockIdx.x % n_groups) * G;
  const int nq = min(G, Q - q0);  // slots in use
  const int c0 = (blockIdx.x / n_groups) * kCT;
  const int j = c0 / ibs, lc0 = c0 % ibs;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int slot = warp / WPS, mt = warp % WPS;
  const int gr = lane / 4, tq = lane % 4;
  const int k0 = kExt ? 0 : max(0, w - j);
  const int k1 = kExt ? W : min(W, nb + w - j);
  const int cpb = ibs / kAP;  // chunks a window block
  const int nch = (k1 - k0) * cpb;
  bf16* const chi =
      reinterpret_cast<bf16*>(smem_raw + L.coef) + slot * 2 * kAP * kLDCb;
  bf16* const clo = chi + kAP * kLDCb;
  // the product's ldmatrix addresses (32-bit shared): v's stages, and
  // this lane's row of the slot's hi tile (lo follows it)
  const unsigned vs_u32 = smem_u32(smem_raw + L.vs);
  const unsigned coef_u32 =
      smem_u32(chi) + 2u * ((lane % 16) * kLDCb + 8 * (lane / 16));

  // first row, in v's and the stats' rows, and slab offset of chunk ci
  auto row_of = [&](int ci) {
    return (int64_t)(j + k0 + ci / cpb - lag) * ibs + (ci % cpb) * kAP;
  };
  auto tile_of = [&](int ci) {
    return (((int64_t)j * W + k0 + ci / cpb) * ibs + (ci % cpb) * kAP) * ibs +
           lc0;
  };
  auto stage = [&](int b, int ci, int f0) {
    const int64_t st = tile_of(ci), r0 = row_of(ci);
    int16_t* es = reinterpret_cast<int16_t*>(smem_raw + L.ents) +
                  b * kAP * kCT;
    const int* o = offs + ci * 9;  // the chunk's entries, padded to 16 bytes
    for (int e = tid; e < (o[8] - o[0] + 7) / 8; e += kApplyThreads)
      cp_async16b(es + 8 * e, sup_entries + o[0] + 8 * e);
    if (with_s) {
      bf16* ss = reinterpret_cast<bf16*>(smem_raw + L.slab) + b * kAP * kCT;
      for (int e = tid; e < kAP * kCT / 8; e += kApplyThreads) {
        const int p = e / (kCT / 8), c = 8 * (e % (kCT / 8));
        cp_async16b(ss + p * kCT + c, slab_col + st + (int64_t)p * ibs + c);
      }
    }
    bf16* vs = reinterpret_cast<bf16*>(smem_raw + L.vs) +
               b * kApplyRows * kLDVb;
    for (int e = tid; e < kApplyRows * kAP / 8; e += kApplyThreads) {
      const int row = e / (kAP / 8), p = 8 * (e % (kAP / 8));
      const int s = row / FP, f = f0 + row % FP;
      const bool ok = s < nq && f < F;
      cp_async16bz(vs + row * kLDVb + p,
                   ok ? v + ((int64_t)(q0 + s) * F + f) * rows_len + r0 + p
                      : v,
                   ok);
    }
  };
  // a2, rowmax and 1 / rowsum of chunk ci's rows: one row a thread of the
  // first G * kAP, loaded into registers after the chunk's first barrier
  // and stored, the reciprocal taken, after its product
  const bool has_row = tid < G * kAP && tid / kAP < nq;
  float ra2 = 0.f, rmx = 0.f, rsm = 0.f;
  auto load_rows = [&](int ci) {
    if (has_row) {
      const int64_t r =
          (int64_t)(q0 + tid / kAP) * rows_len + row_of(ci) + tid % kAP;
      ra2 = __bfloat162float(a2[r]);
      rmx = rowmax[r];
      rsm = rowsum[r];
    }
  };
  auto store_rows = [&](int b) {
    if (tid < G * kAP) {
      float* rs = reinterpret_cast<float*>(smem_raw + L.rows) + b * 3 * G * kAP;
      rs[tid] = ra2;
      rs[G * kAP + tid] = rmx;
      rs[2 * G * kAP + tid] = __fdiv_rn(1.f, fmaxf(rsm, 1e-30f));
    }
  };

  for (int e = tid; e < G * kCT; e += kApplyThreads)
    a1s[e] = e / kCT < nq
                 ? __bfloat162float(a1[(int64_t)(q0 + e / kCT) * Np + c0 +
                                       e % kCT])
                 : 0.f;
  {  // the 4-row groups' entry offsets of the block's chunks
    const int64_t first =
        (((int64_t)j * (ibs / kCT) + lc0 / kCT) * W + k0) * cpb;
    for (int e = tid; e < nch * 9; e += kApplyThreads)
      offs[e] = sup_offs[first * 9 + e];
  }
  for (int f0 = 0; f0 < F; f0 += FP) {
    // this warp's m16 tile holds features of a slot in use
    const bool mine = slot < nq && f0 + 16 * mt < F;
    float acc[kCT / 8][4];
#pragma unroll
    for (int n = 0; n < kCT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    __syncthreads();  // the previous pass's readers are done
    stage(0, 0, f0);
    cp_commit();
    load_rows(0);
    store_rows(0);
    for (int ci = 0; ci < nch; ++ci) {
      const int b = ci & 1;
      cp_wait<0>();
      // chunk ci has landed for every thread; every thread is done with
      // chunk ci - 1 (the coefficient tiles and the other buffers)
      __syncthreads();
      if (ci + 1 < nch) {
        stage(b ^ 1, ci + 1, f0);
        load_rows(ci + 1);
      }
      cp_commit();
      // the slot's coefficients alpha (* S) of the chunk, as bf16 hi + lo
      bool nz = false;
      if (slot < nq) {
        const int16_t* es =
            reinterpret_cast<const int16_t*>(smem_raw + L.ents) +
            b * kAP * kCT;
        const bf16* ss =
            reinterpret_cast<const bf16*>(smem_raw + L.slab) + b * kAP * kCT;
        const float* rs = reinterpret_cast<const float*>(smem_raw + L.rows) +
                          b * 3 * G * kAP + slot * kAP;
        const int g0 = mt * GPW;
        uint4* zh = reinterpret_cast<uint4*>(chi + 4 * g0 * kLDCb);
        uint4* zl = reinterpret_cast<uint4*>(clo + 4 * g0 * kLDCb);
        for (int e = lane; e < 4 * GPW * kLDCb / 8; e += 32) {
          zh[e] = make_uint4(0u, 0u, 0u, 0u);
          zl[e] = make_uint4(0u, 0u, 0u, 0u);
        }
        __syncwarp();
        const int* o = offs + ci * 9;
        const float* a1r = a1s + slot * kCT;
        const int e1 = o[g0 + GPW] - o[0];
        nz = o[g0] < o[g0 + GPW];
        for (int e = o[g0] - o[0] + lane; e < e1; e += 32) {
          const int idx = es[e], p = idx / kCT, c = idx % kCT;
          const float al = alpha(rs[p], a1r[c], 1.f, rs[G * kAP + p],
                                 rs[2 * G * kAP + p], slope);
          const float cf =
              with_s ? __fmul_rn(al, __bfloat162float(ss[p * kCT + c])) : al;
          const bf16 h = __float2bfloat16_rn(cf);
          chi[p * kLDCb + c] = h;
          clo[p * kLDCb + c] =
              __float2bfloat16_rn(__fsub_rn(cf, __bfloat162float(h)));
        }
      }
      // a chunk with no support adds exact zeros: skip its product
      const int live = __syncthreads_or(nz);
      if (live && mine) {
        // shared-memory addresses of this lane's ldmatrix rows: v's
        // [f][p] rows (A: matrices (m 0-7, k 0-7), (m 8-15, k 0-7),
        // (m 0-7, k 8-15), (m 8-15, k 8-15)) and the coefficient tiles'
        // row-major [k][n] rows (B, transposed); one B fragment live at a
        // time, hi then lo
        const unsigned va =
            vs_u32 + 2u * (b * kApplyRows * kLDVb +
                           (slot * FP + 16 * mt + lane % 16) * kLDVb +
                           8 * (lane / 16));
#pragma unroll
        for (int ks = 0; ks < kAP / 16; ++ks) {
          unsigned a[4];
          ldsm_x4_at(a, va + 2u * 16 * ks);
#pragma unroll
          for (int nj = 0; nj < kCT / 16; ++nj) {
            const unsigned ca = coef_u32 + 2u * ((16 * ks) * kLDCb + 16 * nj);
            unsigned bb[4];
            ldsm_x4_trans_at(bb, ca);
            mma_bf16(acc[2 * nj], a, bb[0], bb[1]);
            mma_bf16(acc[2 * nj + 1], a, bb[2], bb[3]);
            ldsm_x4_trans_at(bb, ca + 2u * kAP * kLDCb);
            mma_bf16(acc[2 * nj], a, bb[0], bb[1]);
            mma_bf16(acc[2 * nj + 1], a, bb[2], bb[3]);
          }
        }
      }
      if (ci + 1 < nch) store_rows(b ^ 1);
    }
    if (mine) {
      // rows gr and gr + 8 of the tile (features), columns 8 n + 2 tq, + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = f0 + 16 * mt + gr + 8 * h;
        if (f < F) {
          bf16* yr = y + ((int64_t)(q0 + slot) * F + f) * Np + c0 + 2 * tq;
#pragma unroll
          for (int n = 0; n < kCT / 8; ++n)
            *reinterpret_cast<unsigned*>(yr + 8 * n) =
                bf16_pair(acc[n][2 * h], acc[n][2 * h + 1]);
        }
      }
    }
  }
}

size_t apply_mma_smem_bytes(int G, int W, int ibs) {
  return apply_mma_layout(G).bytes + sizeof(int) * (size_t)W * (ibs / kAP) * 9;
}

// stats: the signal rows a block stages (qb), the rows a warp serves (rw)
// and the dynamic shared memory, for (Q, Np, W, ibs). qb: all Q if their a1
// windows and the 8 support lists fit a quarter of a block's shared
// memory (so 4 blocks an SM), else as many as fit, at least 1, balanced
// over the groups (each group reads the mask again, mostly from L2). rw:
// 4, 2 or 1 rows a warp, the most that keeps the grid at 90% of the
// blocks the card holds at once (more rows a block stage a1 fewer times).
struct StatsPlan {
  int rw, qb;
  size_t smem;
};

template <bool kExt>
cudaError_t stats_plan(int Q, int Np, int W, int ibs, StatsPlan* plan) {
  const size_t lists = sizeof(int16_t) * kStatsWarps * W * ibs;
  const size_t per_q = sizeof(float) * W * ibs;
  if (W * ibs > 32767 || lists + per_q > kMaxSmem)
    return cudaErrorInvalidValue;  // int16 positions; one signal row fits
  const size_t budget = kMaxSmem / 4;
  int qb = budget > lists + per_q ? (int)((budget - lists) / per_q) : 1;
  qb = qb < Q ? qb : Q;
  const int n_qg = (Q + qb - 1) / qb;
  qb = (Q + n_qg - 1) / n_qg;
  plan->qb = qb;
  plan->smem = sizeof(float) * (size_t)qb * W * ibs + lists;
  cudaError_t err = cudaFuncSetAttribute(
      attn_stats_kernel<kExt>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan->smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, attn_stats_kernel<kExt>, kStatsThreads, plan->smem);
  if (err != cudaSuccess) return err;
  plan->rw = 4;
  while (plan->rw > 1 && (long long)Np / (kStatsWarps * plan->rw) * n_qg *
                                 10 <
                             9LL * per_sm * sms)
    plan->rw /= 2;
  return cudaSuccess;
}

template <bool kExt>
cudaError_t launch_stats(const float* a1, const float* a2,
                         const float* mask_row,
                         float* rowmax, float* rowsum,
                         int Q, int Np, int nb, int w, int ibs, float slope,
                         cudaStream_t stream) {
  // ibs % 32 == 0: a block's 8 rw rows lie in one row block
  if (Q <= 0 || ibs % (kStatsWarps * 4) != 0 || Np != nb * ibs || w < 0 ||
      (kExt && w > nb))
    return cudaErrorInvalidValue;
  StatsPlan plan;
  const cudaError_t err =
      stats_plan<kExt>(Q, Np, 2 * w + 1, ibs, &plan);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)Np / (kStatsWarps * plan.rw) *
                           ((Q + plan.qb - 1) / plan.qb);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int vec = reinterpret_cast<uintptr_t>(a1) % 16 == 0;
  attn_stats_kernel<kExt><<<(unsigned)blocks, kStatsThreads, plan.smem,
                               stream>>>(a1, a2, mask_row, rowmax, rowsum,
                                         Q, Np, nb, w, ibs, slope, plan.rw,
                                         plan.qb, vec);
  return cudaGetLastError();
}

// attn_stats_bf16_kernel's signal rows a block (qb), rows a block (rb) and
// dynamic shared memory, for (Q, Np, W, ibs). qb: all Q up to 32 (the
// lanes of a warp), else balanced groups of at most 32, fewer while the
// layout at 8 rows would not fit a block (each group reads the mask
// again); it depends on (Q, W * ibs) alone, so the global and ext calls
// split a row's list over the lanes alike. rb: 16 or 8 rows, the most that
// fits and keeps the grid at 90% of the blocks the card holds at once
// (more rows a block stage the a1 window fewer times; 32 ran slower).
struct StatsBf16Plan {
  int qb, rb;
  size_t smem;
};

template <bool kExt>
cudaError_t stats_bf16_plan(int Q, int Np, int W, int ibs,
                            StatsBf16Plan* plan) {
  const int WI = W * ibs;
  if (WI > 32767) return cudaErrorInvalidValue;  // as the f32 kernel's lists
  int n_qg = (Q + 31) / 32, qb = (Q + n_qg - 1) / n_qg;
  while (stats_bf16_layout(qb, kStatsWarps, WI).bytes > kMaxSmem) {
    if (qb == 1) return cudaErrorInvalidValue;  // one signal row fits not
    ++n_qg;
    qb = (Q + n_qg - 1) / n_qg;
  }
  plan->qb = qb;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  for (int rb = 16; rb >= kStatsWarps; rb /= 2) {
    const size_t smem = stats_bf16_layout(qb, rb, WI).bytes;
    if (smem > kMaxSmem) continue;
    err = cudaFuncSetAttribute(attn_stats_bf16_kernel<kExt>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, attn_stats_bf16_kernel<kExt>, kStatsThreads, smem);
    if (err != cudaSuccess) return err;
    plan->rb = rb;
    plan->smem = smem;
    if ((long long)Np / rb * n_qg * 10 >= 9LL * per_sm * sms) break;
  }
  return cudaSuccess;
}

template <bool kExt>
cudaError_t launch_stats_bf16(const bf16* a1, const bf16* a2,
                              const bf16* mask_row, float* rowmax,
                              float* rowsum, int Q, int Np, int nb, int w,
                              int ibs, float slope, cudaStream_t stream) {
  // ibs % 32 == 0: a block's rb rows lie in one row block, a window's
  // positions come in whole ballots
  if (Q <= 0 || ibs % 32 != 0 || Np != nb * ibs || w < 0 ||
      (kExt && w > nb))
    return cudaErrorInvalidValue;
  StatsBf16Plan plan;
  const cudaError_t err =
      stats_bf16_plan<kExt>(Q, Np, 2 * w + 1, ibs, &plan);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)(Np / plan.rb) * ((Q + plan.qb - 1) / plan.qb);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int vec = reinterpret_cast<uintptr_t>(a1) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(mask_row) % 16 == 0;
  attn_stats_bf16_kernel<kExt><<<(unsigned)blocks, kStatsThreads, plan.smem,
                                 stream>>>(a1, a2, mask_row, rowmax, rowsum,
                                           Q, Np, nb, w, ibs, slope, plan.rb,
                                           plan.qb, vec);
  return cudaGetLastError();
}

// apply_layout's words and the block's entry offsets: 9 ints a chunk of
// its window.
size_t apply_smem_bytes(int G, int W, int ibs) {
  return sizeof(float) * (apply_layout(G).words + (size_t)W * (ibs / kAP) * 9);
}

// G, the signal rows a block of attn_apply_kernel serves: a pass covers
// kApplyRows / G >= F features if it can (G = 4 to F = 32, 2 to 64), no
// wider than Q needs, and narrower while the blocks would fill less than
// 90% of what the card holds at once (2 an SM).
int apply_group(int Q, int F, int Np) {
  int G = F > 2 * kApplyRows / 4 ? 1 : F > kApplyRows / 4 ? 2 : 4;
  while (G > 1 && G / 2 >= Q) G /= 2;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  const long long tiles = Np / kCT;
  while (G > 1 && tiles * ((Q + G - 1) / G) * 10 < 2LL * sms * 9) G /= 2;
  return G;
}

template <class T>
struct ApplyArgs {
  const T *a1, *a2, *v;
  const float *rowmax, *rowsum;
  const T* slab_col;
  const int16_t* sup_entries;
  const int* sup_offs;
  T* y;
  int Q, F, Np, nb, w, ibs, with_s;
  float slope;
};

// f32: attn_apply_kernel<kExt, G>; bf16: attn_apply_mma_kernel<kExt, G>.
template <bool kExt, int G, class T>
cudaError_t launch_apply_g(const ApplyArgs<T>& A, cudaStream_t stream) {
  const long long blocks = (long long)(A.Np / kCT) * ((A.Q + G - 1) / G);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int W = 2 * A.w + 1;
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = apply_mma_smem_bytes(G, W, A.ibs);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        attn_apply_mma_kernel<kExt, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attn_apply_mma_kernel<kExt, G><<<(unsigned)blocks, kApplyThreads, smem,
                                     stream>>>(
        A.a1, A.a2, A.v, A.rowmax, A.rowsum, A.slab_col, A.sup_entries,
        A.sup_offs, A.y, A.Q, A.F, A.Np, A.nb, A.w, A.ibs, A.with_s, A.slope);
  } else {
    const size_t smem = apply_smem_bytes(G, W, A.ibs);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        attn_apply_kernel<kExt, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attn_apply_kernel<kExt, G><<<(unsigned)blocks, kApplyThreads, smem,
                                 stream>>>(
        A.a1, A.a2, A.v, A.rowmax, A.rowsum, A.slab_col, A.sup_entries,
        A.sup_offs, A.y, A.Q, A.F, A.Np, A.nb, A.w, A.ibs, A.with_s, A.slope);
  }
  return cudaGetLastError();
}

// sup_entries, sup_offs: the entry lists of the support
// (ops/attention_flash.py:support_lists).
template <bool kExt, class T>
cudaError_t launch_apply(const ApplyArgs<T>& A, cudaStream_t stream) {
  if (A.Q <= 0 || A.F <= 0 || A.ibs % kCT != 0 || A.ibs % kAP != 0 ||
      A.Np != A.nb * A.ibs || A.w < 0 || (kExt && A.w > A.nb) ||
      A.sup_entries == nullptr || A.sup_offs == nullptr)
    return cudaErrorInvalidValue;
  for (const void* p :
       {(const void*)A.v, (const void*)A.sup_entries, (const void*)A.y})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  if (A.with_s && reinterpret_cast<uintptr_t>(A.slab_col) % 16 != 0)
    return cudaErrorMisalignedAddress;
  switch (apply_group(A.Q, A.F, A.Np)) {
    case 4: return launch_apply_g<kExt, 4, T>(A, stream);
    case 2: return launch_apply_g<kExt, 2, T>(A, stream);
    case 1: return launch_apply_g<kExt, 1, T>(A, stream);
    default: return cudaErrorInvalidDevice;  // the SM count was not read
  }
}

// The file's kernels by name (gnt_attention_kernel).
struct NamedKernel {
  const char* name;
  const void* fn;
};
const NamedKernel kKernels[] = {
    {"attn_stats_kernel<false>", (const void*)attn_stats_kernel<false>},
    {"attn_stats_kernel<true>", (const void*)attn_stats_kernel<true>},
    {"attn_apply_kernel<false, 4>", (const void*)attn_apply_kernel<false, 4>},
    {"attn_apply_kernel<false, 2>", (const void*)attn_apply_kernel<false, 2>},
    {"attn_apply_kernel<false, 1>", (const void*)attn_apply_kernel<false, 1>},
    {"attn_apply_kernel<true, 4>", (const void*)attn_apply_kernel<true, 4>},
    {"attn_apply_kernel<true, 2>", (const void*)attn_apply_kernel<true, 2>},
    {"attn_apply_kernel<true, 1>", (const void*)attn_apply_kernel<true, 1>},
    {"attn_bwd_kernel<false>", (const void*)attn_bwd_kernel<false>},
    {"attn_bwd_kernel<true>", (const void*)attn_bwd_kernel<true>},
    {"attn_stats_bf16_kernel<false>",
     (const void*)attn_stats_bf16_kernel<false>},
    {"attn_stats_bf16_kernel<true>",
     (const void*)attn_stats_bf16_kernel<true>},
    {"attn_apply_mma_kernel<false, 4, bf16>",
     (const void*)attn_apply_mma_kernel<false, 4>},
    {"attn_apply_mma_kernel<false, 2, bf16>",
     (const void*)attn_apply_mma_kernel<false, 2>},
    {"attn_apply_mma_kernel<false, 1, bf16>",
     (const void*)attn_apply_mma_kernel<false, 1>},
    {"attn_apply_mma_kernel<true, 4, bf16>",
     (const void*)attn_apply_mma_kernel<true, 4>},
    {"attn_apply_mma_kernel<true, 2, bf16>",
     (const void*)attn_apply_mma_kernel<true, 2>},
    {"attn_apply_mma_kernel<true, 1, bf16>",
     (const void*)attn_apply_mma_kernel<true, 1>},
    {"attn_bwd_mma_kernel<false, 1, bf16>",
     (const void*)attn_bwd_mma_kernel<false, 1>},
    {"attn_bwd_mma_kernel<false, 2, bf16>",
     (const void*)attn_bwd_mma_kernel<false, 2>},
    {"attn_bwd_mma_kernel<false, 3, bf16>",
     (const void*)attn_bwd_mma_kernel<false, 3>},
    {"attn_bwd_mma_kernel<false, 4, bf16>",
     (const void*)attn_bwd_mma_kernel<false, 4>},
    {"attn_bwd_mma_kernel<true, 1, bf16>",
     (const void*)attn_bwd_mma_kernel<true, 1>},
    {"attn_bwd_mma_kernel<true, 2, bf16>",
     (const void*)attn_bwd_mma_kernel<true, 2>},
    {"attn_bwd_mma_kernel<true, 3, bf16>",
     (const void*)attn_bwd_mma_kernel<true, 3>},
    {"attn_bwd_mma_kernel<true, 4, bf16>",
     (const void*)attn_bwd_mma_kernel<true, 4>},
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

// bf16 a1, a2 and mask_row; f32 rowmax and rowsum.
cudaError_t gnt_attn_stats_bf16(const bf16* a1, const bf16* a2,
                                const bf16* mask_row, float* rowmax,
                                float* rowsum, int Q, int Np, int nb, int w,
                                int ibs, float slope, cudaStream_t stream) {
  return launch_stats_bf16<false>(a1, a2, mask_row, rowmax, rowsum, Q, Np,
                                  nb, w, ibs, slope, stream);
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

// bf16 a1_ext, a2 and mask_row; f32 rowmax and rowsum.
cudaError_t gnt_attn_stats_ext_bf16(const bf16* a1_ext, const bf16* a2,
                                    const bf16* mask_row, float* rowmax,
                                    float* rowsum, int Q, int Np, int nb,
                                    int w, int ibs, float slope,
                                    cudaStream_t stream) {
  return launch_stats_bf16<true>(a1_ext, a2, mask_row, rowmax, rowsum, Q, Np,
                                 nb, w, ibs, slope, stream);
}

// sup_entries, sup_offs: the entry lists of the support (the scores run
// on the support only).
cudaError_t gnt_attn_apply(const float* a1, const float* a2, const float* v,
                           const float* rowmax, const float* rowsum,
                           const float* slab_col, const int16_t* sup_entries,
                           const int* sup_offs, float* y, int Q, int F,
                           int Np, int nb, int w, int ibs, int with_s,
                           float slope, cudaStream_t stream) {
  return launch_apply<false, float>({a1, a2, v, rowmax, rowsum, slab_col,
                                     sup_entries, sup_offs, y, Q, F, Np, nb,
                                     w, ibs, with_s, slope},
                                    stream);
}

// bf16 a1, a2, v, slab_col and y; f32 rowmax and rowsum.
cudaError_t gnt_attn_apply_bf16(const bf16* a1, const bf16* a2, const bf16* v,
                                const float* rowmax, const float* rowsum,
                                const bf16* slab_col,
                                const int16_t* sup_entries,
                                const int* sup_offs, bf16* y, int Q, int F,
                                int Np, int nb, int w, int ibs, int with_s,
                                float slope, cudaStream_t stream) {
  return launch_apply<false, bf16>({a1, a2, v, rowmax, rowsum, slab_col,
                                    sup_entries, sup_offs, y, Q, F, Np, nb, w,
                                    ibs, with_s, slope},
                                   stream);
}

// a1 (Q, Np) the shard's own columns; a2_ext, mx_ext, sm_ext
// (Q, Np + 2*w*ibs) and v_ext (Q, F, Np + 2*w*ibs) halo-extended rows;
// y (Q, F, Np).
cudaError_t gnt_attn_apply_ext(const float* a1, const float* a2_ext,
                               const float* v_ext, const float* mx_ext,
                               const float* sm_ext, const float* slab_col,
                               const int16_t* sup_entries,
                               const int* sup_offs, float* y, int Q, int F,
                               int Np, int nb, int w, int ibs, int with_s,
                               float slope, cudaStream_t stream) {
  return launch_apply<true, float>({a1, a2_ext, v_ext, mx_ext, sm_ext,
                                    slab_col, sup_entries, sup_offs, y, Q, F,
                                    Np, nb, w, ibs, with_s, slope},
                                   stream);
}

// bf16 a1, a2_ext, v_ext, slab_col and y; f32 mx_ext and sm_ext.
cudaError_t gnt_attn_apply_ext_bf16(const bf16* a1, const bf16* a2_ext,
                                    const bf16* v_ext, const float* mx_ext,
                                    const float* sm_ext,
                                    const bf16* slab_col,
                                    const int16_t* sup_entries,
                                    const int* sup_offs, bf16* y, int Q,
                                    int F, int Np, int nb, int w, int ibs,
                                    int with_s, float slope,
                                    cudaStream_t stream) {
  return launch_apply<true, bf16>({a1, a2_ext, v_ext, mx_ext, sm_ext,
                                   slab_col, sup_entries, sup_offs, y, Q, F,
                                   Np, nb, w, ibs, with_s, slope},
                                  stream);
}

// Kernel i of this file and its name, or null past the last.
const void* gnt_attention_kernel(int i, const char** name) {
  if (i < 0 || i >= (int)(sizeof(kKernels) / sizeof(kKernels[0])))
    return nullptr;
  *name = kKernels[i].name;
  return kKernels[i].fn;
}

// The signal rows a block of attn_apply_kernel serves at (Q, F, Np): the
// instance <., G> the launchers pick; -1 if the device cannot be read.
int gnt_attn_apply_group(int Q, int F, int Np) {
  return apply_group(Q, F, Np);
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

// bf16 g, a1, a2, v, slab_col and mask_row; f32 rowmax, rowsum, da2 and
// da1p; bf16 dv. F at most 64 (attn_bwd_mma_kernel keeps dv^T in
// registers).
cudaError_t gnt_attn_bwd_bf16(const bf16* g, const bf16* a1, const bf16* a2,
                              const bf16* v, const float* rowmax,
                              const float* rowsum, const bf16* slab_col,
                              const bf16* mask_row, float* da2, float* da1p,
                              bf16* dv, int Q, int F, int Np, int nb, int w,
                              int ibs, int with_s, float slope,
                              cudaStream_t stream) {
  return launch_bwd<false>(g, a1, a2, v, rowmax, rowsum, slab_col, mask_row,
                           da2, da1p, dv, Q, F, Np, nb, w, ibs, with_s, slope,
                           stream);
}

// The dynamic shared memory attn_bwd_mma_kernel takes at (F, W, ibs), in
// bytes: what the bf16 launch_bwd asks for, and refuses above kMaxSmem.
int gnt_attn_bwd_smem_bytes_bf16(int F, int W, int ibs) {
  return (int)bwd_mma_smem_bytes(F, W, ibs);
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

// bf16 g_ext, a1_ext, a2, v, slab_col_ext and mask_row; f32 rowmax, rowsum,
// da2 and da1p; bf16 dv. F at most 64 (attn_bwd_mma_kernel<true, NF>).
cudaError_t gnt_attn_bwd_ext_bf16(const bf16* g_ext, const bf16* a1_ext,
                                  const bf16* a2, const bf16* v,
                                  const float* rowmax, const float* rowsum,
                                  const bf16* slab_col_ext,
                                  const bf16* mask_row, float* da2,
                                  float* da1p, bf16* dv, int Q, int F,
                                  int Np, int nb, int w, int ibs, int with_s,
                                  float slope, cudaStream_t stream) {
  return launch_bwd<true>(g_ext, a1_ext, a2, v, rowmax, rowsum, slab_col_ext,
                          mask_row, da2, da1p, dv, Q, F, Np, nb, w, ibs,
                          with_s, slope, stream);
}

}  // extern "C"
