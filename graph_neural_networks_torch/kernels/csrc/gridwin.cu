// Hopper (sm_90a) kernels for the cell-grid swarm environment, in FP32.
//
// Three kernels, each the counterpart of one Pallas kernel of the JAX
// package (graph_neural_networks_tpu/ops/gridwin.py):
//
//   grid_window_kernel      <- gridwin.py:grid_window (_make_kernel)
//   table_build_kernel      <- gridwin.py:table_build (_make_build_kernel)
//   table_transpose_kernel  <- gridwin.py:table_transpose (_make_xpose_kernel)
//
// The cell table is (cells, W) f32, feature-blocked: row h holds
// [px*C | py*C | vx*C | vy*C | valid*C | id*C | v*C | pay*C x P | 0 pad],
// lane f*C + c is feature f of the cell's c-th member.
//
// What bounds them on an H100: all three move bytes and do a few flops a
// byte, so device-memory traffic bounds them by their operands' size. The
// TPU kernels needed the candidate rows gathered into one (n_win, rows,
// W) operand first, because a Pallas kernel could not gather; here a warp
// reads each of its agent's n_win cell rows straight from the table by
// slot, so the gathered operand (3.8 GB at 262144 agents and W = 896) is
// never written or read.
//
// grid_window does not reach that bound: a warp serves one agent, and at
// flock_n262k an agent's 128 candidate lanes hold ~58 agents of which
// ~10 are neighbours, so almost every load instruction of a warp serves
// one to a few lanes. The rows in use (18,299 occupied cells of 65,536,
// 64 MB) mostly stay in the 50 MB L2, so the time goes to issuing and
// waiting for those loads, and to the number of warps an SM keeps in
// flight to hide them. The design: one pass over the candidates, the id
// and position loaded only behind a set valid lane, a neighbour's
// velocity, v and payload lanes all loaded at once; the state sums in
// registers and the payload sums as per-lane partials in shared memory,
// updated four at a time with 16-byte accesses, so a thread needs 40
// registers whatever n_pay is and an SM holds 48 warps; the sums added up
// by one lane each in the xor tree's order (tree_sum) instead of a
// 5-shuffle warp_sum each. Visiting the agents in the table build's cell
// order was measured slower than agent order on the card (the operands'
// gather and the scattered output rows cost more than the rows' locality
// gains), and so was serving a chunk's neighbours with the whole warp,
// one loaded term a lane; the warps walk the agents in order.
// table_transpose is a pure relayout, one streaming read and one
// streaming write: persistent blocks stage runs of whole cells (whose
// member rows are one contiguous span) into shared memory with cp.async
// and write the cells' rows back as coalesced stores, the next run's copy
// in flight while this one is written (see the kernel).
//
// Numbers: the distance mask and the state terms spell out their roundings
// (__fmul_rn, __fadd_rn, __fdiv_rn) so nvcc contracts nothing into an FMA;
// the plain PyTorch versions (ops/gridwin.py) do the same separate IEEE
// operations and sum in this kernel's order (per lane over the chunks,
// then the xor-shuffle tree), so the two agree bit for bit.
//
// Every launcher has a plain C interface and returns the cudaError_t of the
// launch; the Python wrappers raise if it is not cudaSuccess.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kWarps = 8;  // cells a block (the table builds)
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunks = 32;  // n_win * C <= 32 * kMaxChunks candidates
constexpr int kMaxWin = 32;     // n_win <= 32: one lane a window's slot
// grid_window: agents (warps) a block, and the blocks an SM should hold
// (40 registers a thread)
constexpr int kWinWarps = 4;
constexpr int kWinBlocks = 12;
constexpr float kZeroTol = 1e-9f;

// A grid_window lane's row of partial sums in shared memory: n_val floats
// rounded up to 4k with k odd, so that 8 lanes' 16-byte accesses at the
// same offset hit 32 distinct banks.
__host__ __device__ inline int acc_ld(int n_val) {
  const int k = (n_val + 3) / 4;
  return 4 * (k | 1);
}

// Shared floats of a grid_window warp's partial sums: 32 lanes' rows.
__host__ __device__ inline int acc_floats(int n_val) {
  return 32 * acc_ld(n_val);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The 32 lane partials x[0], x[ld], .. x[31 ld] of a value summed in
// warp_sum's order: the xor tree's pairs (offsets 16 .. 1) of lane 0, so
// bit for bit what warp_sum gives (every lane of the tree holds the same
// sums).
__device__ __forceinline__ float tree_sum(const float* x, int ld) {
  float y[16];
#pragma unroll
  for (int l = 0; l < 16; ++l) y[l] = x[l * ld] + x[(l + 16) * ld];
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
#pragma unroll
    for (int l = 0; l < o; ++l) y[l] = y[l] + y[l + o];
  return y[0];
}

// One warp an agent row r of R. Candidate j = w*C + c (window w of n_win,
// member slot c of C) is lane j % 32 of chunk j / 32, in the JAX lane
// order, so the first-d_max selection takes the same ids as the Pallas
// kernel.
//
// table (cells, W); own (R, 5) [px, py, vx, vy, id]; slots (R, n_win) the
// table row of each window; keep (R, n_win) 0 for a window that repeats an
// earlier one of the same agent (the modular map aliased them).
// out (R, OW): [idx (d_max, float ids) | val (d_max, 0/1) | st (6) | wv |
// cnt | wpay (n_pay)], OW = 2 d_max + 8 + n_pay; wv_only: out (R, 1) = wv.
//
// One pass over the chunks. A lane loads its candidate's valid lane, then
// the id and position of a valid one, and a masked candidate's velocity,
// v and payload lanes all at once. The state sums stay in registers; the
// payload partials go to the lane's row of the warp's shared memory, 4 at
// a time (16-byte accesses), so the registers do not grow with n_pay.
// Lane u then adds output sum u's 32 partials in the xor tree's order
// (tree_sum). Dynamic shared memory: kWinWarps acc_floats(8 + n_pay)
// floats.
__global__ void __launch_bounds__(32 * kWinWarps, kWinBlocks)
grid_window_kernel(const float* __restrict__ table,
                   const float* __restrict__ own,
                   const int* __restrict__ slots,
                   const unsigned char* __restrict__ keep,
                   float* __restrict__ out, int R, int W, int n_win, int C,
                   float r2, int need_exp, int d_max, int wv_only,
                   int n_pay) {
  extern __shared__ __align__(16) float acc_s[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWinWarps + warp;
  if (r >= R) return;  // whole warps leave together
  const int n_val = wv_only ? 0 : 8 + n_pay;  // output sums
  const int ld = acc_ld(n_val);
  float* acc = acc_s + warp * acc_floats(n_val);  // [lane][sum]
  float* mine = acc + lane * ld;
  const float* o = own + (int64_t)r * 5;
  const float opx = o[0], opy = o[1], ovx = o[2], ovy = o[3], oid = o[4];
  const int M = n_win * C;
  const int n_chunks = (M + 31) / 32;
  const int OW = wv_only ? 1 : 2 * d_max + 8 + n_pay;
  float* orow = out + (int64_t)r * OW;
  // lane w < n_win holds window w's table row and keep flag
  int my_slot = 0, my_keep = 0;
  if (lane < n_win) {
    my_slot = slots[(int64_t)r * n_win + lane];
    my_keep = keep[(int64_t)r * n_win + lane];
  }
  for (int u = 8; u < n_val; u += 4)
    *reinterpret_cast<float4*>(mine + u) = make_float4(0.f, 0.f, 0.f, 0.f);

  // st[0..5] the state sums, st[6] wv, st[7] the count
  float st[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) st[u] = 0.f;
  int total = 0;  // masked candidates in earlier chunks: the rank base
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int j = ch * 32 + lane;
    const int slot = __shfl_sync(0xffffffffu, my_slot, j / C);
    const int kp = __shfl_sync(0xffffffffu, my_keep, j / C);
    const float* rc = table + (int64_t)slot * W + j % C;  // the lane's
    bool m = false;
    float dpx = 0.f, dpy = 0.f, d2 = 0.f, cid = 0.f;
    if (j < M && kp && rc[4 * C] > 0.f) {
      cid = rc[5 * C];
      dpx = __fsub_rn(opx, rc[0]);
      dpy = __fsub_rn(opy, rc[C]);
      d2 = __fadd_rn(__fmul_rn(dpx, dpx), __fmul_rn(dpy, dpy));
      m = d2 <= r2 && cid != oid;
      if (need_exp) m = m && expf(-d2) > kZeroTol;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, m);
    if (m) {
      st[6] = __fadd_rn(st[6], rc[6 * C]);
      if (!wv_only) {
        st[7] = __fadd_rn(st[7], 1.f);
        const float inv = d2 > kZeroTol ? __fdiv_rn(1.f, d2) : 0.f;
        const float px_inv = __fmul_rn(dpx, inv), py_inv = __fmul_rn(dpy, inv);
        st[0] = __fadd_rn(st[0], __fsub_rn(ovx, rc[2 * C]));
        st[1] = __fadd_rn(st[1], __fsub_rn(ovy, rc[3 * C]));
        st[2] = __fadd_rn(st[2], __fmul_rn(px_inv, inv));
        st[3] = __fadd_rn(st[3], __fmul_rn(py_inv, inv));
        st[4] = __fadd_rn(st[4], px_inv);
        st[5] = __fadd_rn(st[5], py_inv);
#pragma unroll 1
        for (int p = 0; p < n_pay; p += 4) {
          float x[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            x[q] = p + q < n_pay ? rc[(7 + p + q) * C] : 0.f;
          float4* d = reinterpret_cast<float4*>(mine + 8 + p);
          const float4 part = *d;
          *d = make_float4(__fadd_rn(part.x, x[0]), __fadd_rn(part.y, x[1]),
                           __fadd_rn(part.z, x[2]), __fadd_rn(part.w, x[3]));
        }
        // first-d_max selection: this candidate's rank among the masked
        // ones, in candidate order, from the ballot of its chunk
        const int t = total + __popc(bits & ((1u << lane) - 1u));
        if (t < d_max) {
          orow[t] = cid;
          orow[d_max + t] = 1.f;
        }
      }
    }
    total += __popc(bits);
  }
  if (wv_only) {
    const float wv = warp_sum(st[6]);
    if (lane == 0) orow[0] = wv;
    return;
  }
  for (int t = min(total, d_max) + lane; t < d_max; t += 32) {
    orow[t] = 0.f;
    orow[d_max + t] = 0.f;
  }
  *reinterpret_cast<float4*>(mine) = make_float4(st[0], st[1], st[2], st[3]);
  *reinterpret_cast<float4*>(mine + 4) =
      make_float4(st[4], st[5], st[6], st[7]);
  __syncwarp();
  for (int u = lane; u < n_val; u += 32)
    orow[2 * d_max + u] = tree_sum(acc + u, ld);
}

// One warp a cell (b, h) of B*H. fs (B, N, F): the agents' feature rows
// sorted by cell slot; starts (B, H+1): each cell's run [starts[h],
// starts[h+1]) in fs[b]. out (B*H, W): out[h, f*C + c] = fs[starts[h] + c, f]
// for c < min(run, C), else 0. Reads only the run, so an overflowing cell
// keeps its first C sorted members.
__global__ void __launch_bounds__(kThreads)
table_build_kernel(const float* __restrict__ fs,
                   const int* __restrict__ starts, float* __restrict__ out,
                   int B, int H, int N, int F, int C, int W) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t cell = (int64_t)blockIdx.x * kWarps + warp;
  if (cell >= (int64_t)B * H) return;
  const int b = (int)(cell / H), h = (int)(cell % H);
  const int* st = starts + (int64_t)b * (H + 1);
  const int s = st[h];
  const int run = min(st[h + 1] - s, C);
  const float* src = fs + ((int64_t)b * N + s) * F;
  float* dst = out + cell * W;
  for (int i = lane; i < W; i += 32) {
    const int f = i / C, c = i % C;
    dst[i] = (f < F && c < run) ? src[(int64_t)c * F + f] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// table_transpose_kernel
// ---------------------------------------------------------------------------

constexpr int kXposeThreads = 256;
// Floats of one staged run of cells (about 32 KB); a run is a multiple of 4
// cells, so with a 16-byte aligned mm every run's span starts 16-byte
// aligned, whatever C * L is.
constexpr int kXposeSpan = 8192;
// Shared memory a block may use on sm_90 (227 KB).
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ unsigned smem_u32(const float* p) {
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

// Stage the member rows of cells [h0, h0 + nc) into buf as (nc C, Fs):
// member m's feature f at buf[m Fs + f]. kBulk (L == F == Fs, mm 16-byte
// aligned): the cells' rows are one contiguous span, copied in 16-byte
// pieces (a last run whose span is not a multiple of 4 floats ends in
// 4-byte pieces). Else element by element (L > F, an even F restaged at
// the odd stride Fs = F + 1, or a misaligned mm).
template <bool kBulk>
__device__ __forceinline__ void stage_run(float* buf,
                                          const float* __restrict__ mm,
                                          int h0, int nc, int L, int F,
                                          int C, int Fs) {
  if (kBulk) {
    const int n = nc * C * F;
    const float* src = mm + (int64_t)h0 * C * F;
    for (int q = threadIdx.x * 4; q + 4 <= n; q += kXposeThreads * 4)
      cp_async16(buf + q, src + q);
    for (int e = n / 4 * 4 + threadIdx.x; e < n; e += kXposeThreads)
      cp_async4(buf + e, src + e);
  } else {
    for (int e = threadIdx.x; e < nc * C * F; e += kXposeThreads) {
      const int m = e / F, f = e % F;
      cp_async4(buf + m * Fs + f, mm + ((int64_t)h0 * C + m) * L + f);
    }
  }
}

// out (H, W): out[h, f*C + c] = mm[h*C + c, f] for f < F, else 0; mm (H*C,
// L) member-major slot rows, L >= F.
//
// The TPU kernel flips (C, 128) tiles in VMEM. Here the relayout is one
// streaming read and one streaming write: persistent blocks walk runs of T
// cells (gridDim.x apart), staging run r + gridDim.x with cp.async while
// they write run r, double buffered. A thread owns output lanes i = tid,
// tid + 256, ... of every row, so each warp store is 32 consecutive floats
// (the pad lanes f >= F included) and reads its 32 members' feature f from
// shared memory at the odd stride Fs: 32 distinct banks.
template <bool kBulk>
__global__ void __launch_bounds__(kXposeThreads)
table_transpose_kernel(const float* __restrict__ mm, float* __restrict__ out,
                       int H, int L, int F, int C, int W, int T, int Fs) {
  extern __shared__ __align__(16) float xbuf[];  // 2 x (T C Fs)
  const int span = T * C * Fs;
  const int runs = (H + T - 1) / T;
  int run = blockIdx.x;
  if (run < runs)
    stage_run<kBulk>(xbuf, mm, run * T, min(T, H - run * T), L, F, C, Fs);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int b = 0; run < runs; run += gridDim.x, b ^= 1) {
    const int next = run + gridDim.x;
    if (next < runs)
      stage_run<kBulk>(xbuf + (b ^ 1) * span, mm, next * T,
                       min(T, H - next * T), L, F, C, Fs);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const float* buf = xbuf + b * span;
    const int h0 = run * T, nc = min(T, H - h0);
    for (int i = threadIdx.x; i < W; i += kXposeThreads) {
      const int f = i / C, c = i % C;
      const bool live = f < F;
      const float* s = buf + c * Fs + f;
      float* d = out + (int64_t)h0 * W + i;
      for (int hl = 0; hl < nc; ++hl)
        d[(int64_t)hl * W] = live ? s[hl * C * Fs] : 0.f;
    }
    __syncthreads();  // buf is restaged for run + 2 gridDim.x
  }
}

unsigned blocks_for(int64_t warps) {
  return (unsigned)((warps + kWarps - 1) / kWarps);
}

// The file's kernels by name (gnt_gridwin_kernel).
struct NamedKernel {
  const char* name;
  const void* fn;
};
const NamedKernel kKernels[] = {
    {"grid_window_kernel", (const void*)grid_window_kernel},
    {"table_build_kernel", (const void*)table_build_kernel},
    {"table_transpose_kernel<true>",
     (const void*)table_transpose_kernel<true>},
    {"table_transpose_kernel<false>",
     (const void*)table_transpose_kernel<false>},
};

}  // namespace

extern "C" {

cudaError_t gnt_grid_window(const float* table, const float* own,
                            const int* slots, const unsigned char* keep,
                            float* out, int R, int W, int n_win, int C,
                            float r2, int need_exp, int d_max, int wv_only,
                            int n_pay, cudaStream_t stream) {
  if (R <= 0 || n_win <= 0 || n_win > kMaxWin || C <= 0 || d_max < 0 ||
      n_pay < 0 || n_win * C > 32 * kMaxChunks || (7 + n_pay) * C > W)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * kWinWarps * acc_floats(wv_only ? 0 : 8 + n_pay);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        grid_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  grid_window_kernel<<<(unsigned)((R + kWinWarps - 1) / kWinWarps),
                       32 * kWinWarps, smem, stream>>>(
      table, own, slots, keep, out, R, W, n_win, C, r2, need_exp, d_max,
      wv_only, n_pay);
  return cudaGetLastError();
}

// Kernel i of this file and its name, or null past the last.
const void* gnt_gridwin_kernel(int i, const char** name) {
  if (i < 0 || i >= (int)(sizeof(kKernels) / sizeof(kKernels[0])))
    return nullptr;
  *name = kKernels[i].name;
  return kKernels[i].fn;
}

cudaError_t gnt_table_build(const float* fs, const int* starts, float* out,
                            int B, int H, int N, int F, int C, int W,
                            cudaStream_t stream) {
  if (B <= 0 || H <= 0 || F <= 0 || C <= 0 || F * C > W)
    return cudaErrorInvalidValue;
  table_build_kernel<<<blocks_for((int64_t)B * H), kThreads, 0, stream>>>(
      fs, starts, out, B, H, N, F, C, W);
  return cudaGetLastError();
}

// A run of T cells (a multiple of 4, about kXposeSpan floats) a step;
// as many persistent blocks as there are runs, at most as many as the card
// holds at once (the occupancy query, after the shared memory opt-in).
cudaError_t gnt_table_transpose(const float* mm, float* out, int H, int L,
                                int F, int C, int W, cudaStream_t stream) {
  if (H <= 0 || F <= 0 || F > L || C <= 0 || F * C > W)
    return cudaErrorInvalidValue;
  const bool bulk = L == F && F % 2 == 1 &&
                    reinterpret_cast<uintptr_t>(mm) % 16 == 0;
  const int Fs = F | 1;
  const int T = 4 * std::max(1, kXposeSpan / (4 * C * Fs));
  const size_t smem = 2 * sizeof(float) * (size_t)T * C * Fs;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const void* fn = bulk ? (const void*)table_transpose_kernel<true>
                        : (const void*)table_transpose_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      kXposeThreads, smem);
  if (err != cudaSuccess) return err;
  const int runs = (H + T - 1) / T;
  const int grid = std::min(runs, std::max(1, per_sm) * sms);
  if (bulk)
    table_transpose_kernel<true><<<grid, kXposeThreads, smem, stream>>>(
        mm, out, H, L, F, C, W, T, Fs);
  else
    table_transpose_kernel<false><<<grid, kXposeThreads, smem, stream>>>(
        mm, out, H, L, F, C, W, T, Fs);
  return cudaGetLastError();
}

}  // extern "C"
