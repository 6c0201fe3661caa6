#!/usr/bin/env python3
"""Drive the PyTorch port (graph_neural_networks_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from kernels/csrc with nvcc (one nvcc a
source, side by side), then drives two serving paths, the training path,
the flocking deployment and training paths (device and host stores) and
the node-sharded paths:

* SpMM: holds the three graph-shift kernels against their plain PyTorch
  versions at the serving path's shapes and at edge cases, times each
  beside its plain version, one library call and its bound, then serves
  the band_n4096 SelectionGNN (N=4096 banded graph, [1,64,64] features,
  K=5, batch 32) in band and bcsr mode through InferenceEngine and checks
  the answers against dense mode and the kernel launch counts.
* Attention: holds the two flash-attention kernels (stats, apply) against
  their plain versions at the served shape and at edge cases, times them
  beside their bounds, then serves gat_band_n16384 (the band-mode
  GraphAttentionNetwork, 2 heads, F=G=32, batch 8, N=16384) through
  InferenceEngine against the materialized band path on the card, checks
  2 stats + 2 apply launches a forward, serves GAT, GCAT and
  EdgeVariantAttention at N=2048 against dense mode, and profiles the
  served forward.
* Training: holds the flash backward kernel (bwd_call) against its plain
  version at the served shape, the GCAT shape and edge cases, and the
  three differentiable SpMM shifts' input gradients against the plain
  backward shifts; times bwd_call beside its bound and one flash GAT layer
  forward + backward beside the materialized layer's; checks the full-width
  gat_band_n16384 gradients against the materialized band path; trains it
  through Model.train (Adam, 8 steps, validation at steps 0 and 4) and
  evaluate with exactly 2 stats + 2 apply + 2 bwd launches a step; trains
  band_n4096 (band: 2 register + 4 band_matmul a step; bcsr: 12
  bcsr_matmul) and GAT, GCAT and EdgeVariantAttention at N=2048 against
  dense mode (first-step gradients, 8 steps of loss); and profiles a
  training step of each.
* Flocking: holds the three grid-environment kernels (grid_window,
  table_build, table_transpose) against their plain versions bit for bit
  at flock_n262k's shapes and at edge cases; one flock_n4096 env step
  (fused and gather builds) against the dense all-pairs step; serves
  flock_n262k (LocalGNN_DB [6,32]/[4], N=262144: rollout_cost and
  rollout_traj_device over 100 steps, compute_trajectory with its graphs
  over 25) and flock_n4096 (2 samples, 100 steps) through Flocking's
  entry points against the same rollouts on the plain versions, with
  exact launch counts; times the kernels and profiles a rollout step.
* Flocking training: holds grid_window at the training path's new shapes
  (the expert's repel pass, r2 = 1 and d_max = 1; the recompute's main
  pass, d_max = 32 without payload) against its plain version bit for bit
  on flock_n262k's swarm and an edge swarm with d^2 = 1 pairs, and times
  the repel shape; trains flock_train_n262k (LocalGNN_DB [6,64]/[3],
  N=262144, T=50, ellDegree 32) through Flocking.large_device, Model.train
  with TrainerFlocking over the device-resident store (3 epochs, batch 1,
  randomEpoch DAGger at probExpert 0.5) and evaluate_flocking, with exact
  grid-kernel launch counts per step, re-roll and validation; checks the
  first batch's recompute bit for bit against the plain versions, the grid
  expert against the all-pairs expert and the ELL lsigf_db forward and
  gradient against the dense one at N=4096; profiles a training step
  (recompute and learning halves) and its peak memory.
* Flocking through the host store: trains flock_ref_n50 (the reference
  flockingGNN.py configuration: Flocking(...) of 50 agents, 440
  trajectories of T = 200 generated in f64 numpy on the host,
  LocalGNN_DB [6,64]/[3], batch 20; 2 epochs, randomEpoch DAGger at
  probExpert 0.993) through Model.train with TrainerFlocking's host store
  and evaluate_flocking on the all-pairs env; checks its closed loop on
  the card against the CPU, the dense recompute against the host store
  and the device store's first loss against the host store's; then
  trains flock_largetrain_n65536 (Flocking.large(env_grid=True): the
  expert's supervision on the grid kernels, ELL graphs of width 32 in the
  host store; 3 epochs, batch 1) with exact grid-kernel launch counts for
  the generation, a step, a re-roll, a relabel and a validation, the
  relabel's collision sums against all pairs, the generation bit-equal to
  the plain grid versions at T = 8, and a step of each store profiled at
  N = 65536.
* Node-sharded serving (one process drives every shard; a mesh repeats
  the one card): serves gat_band_n16384 through GraphAttentionNetwork
  .shard() and InferenceEngine over a (1, 4) and a (2, 2) data x graph
  mesh, 8 stats_ext_call + 8 apply_ext_call launches a forward, each
  answer against the unsharded band-mode model and the sharded windowed
  path; GCAT and EdgeVariantAttention at N=2048 sharded 4 ways against
  dense mode; band_n4096 SelectionGNN.shard() (the ring shift on
  band_matmul) against the unsharded band forward. Holds the two
  ext-layout kernels against their plain versions on operands
  halo-extended from real neighbour shards (first, interior and last
  shard), times them beside their bounds, and profiles a sharded forward
  beside the unsharded one.
* Node-sharded training: trains gat_band_n16384 .shard()ed over the
  (1, 4) and (2, 2) meshes through Model.train and Trainer(mesh=...)
  (8 Adam steps; 8 bwd_ext_call + 8 stats_ext_call + 8 apply_ext_call
  launches a step, no global flash launch), its first-step gradients
  (parameters, every layer's a1x, a2x, v) against the unsharded band
  model's and its losses against that model's trajectory; GCAT and
  EdgeVariantAttention at N=2048 and band_n4096 (the ring shift's
  backward, 48 band_matmul a step) sharded 4 ways likewise. Holds the
  shard-local flash backward (bwd_ext_call, kernel 12) against its plain
  version on the first, an interior and the last shard and a ragged
  partition, and all shards folded against the global bwd_call; times it
  beside its bound, and profiles a sharded step beside the unsharded one.
* The rest of single-controller parallel/ (mesh (1, 4) of the one card):
  holds bcsr_matmul on every shard's rectangular column slice of a
  scattered N=4096 graph (forward 4096 -> 1024 columns, backward on the
  transposed slice, pad blocks included) against its plain version and
  times both directions; serves and trains scattered_n4096_sharded (the
  band_n4096 SelectionGNN in bcsr mode over partition_nodes_bcsr: 32
  bcsr_matmul a forward, 48 a step) against the unsharded bcsr model;
  serves band_n4096 over the all-gather shift (ShardedGso(prefer_ring=
  False), 32 band_matmul a forward) against the ring-sharded model; takes
  one LocalGNN_DB([6,64], [3]) step over shard_ell of flock_train_n262k's
  first batch against the unsharded EllGso step; rolls flock_n262k
  through sharded_swarm_rollout (the fused cost rollout, T = 100, against
  Flocking.rollout_cost, its ok flag against the unsharded run's and the
  largest in-degree; the fused rollout with graphs, T = 25, against mesh
  (1, 1)) and flock_n4096's windowed rollout against mesh (1, 1), with
  exact table_build and grid_window counts; profiles the sharded forward,
  step and swarm step beside their unsharded counterparts.
* The static-GSO recurrent family (grnn_band_n4096: GraphRecurrentNN and
  its time- and node-gated forms at examples/epidemic.py's full widths,
  H = 12, K = 5, T = 8, batch 100, on band_n4096's graph): holds kernels
  1-3 at the recurrence's shapes (the register at R = 800 and 1200,
  band_matmul at R = 9600 and its backward at 1200 and 9600, bcsr_matmul
  both ways, a shard's own block) against their plain versions and times
  them; serves it in band and bcsr mode against dense mode on one z0
  (every step's error) and through InferenceEngine, with exact launch
  counts; trains it through Model.train (f1 loss, Adam 5e-4, 4 steps) and
  evaluate against dense mode (first-step gradients, losses, launches a
  step, peak memory), profiles a step of each; shards it over mesh (1, 4)
  (ungated and node-gated) against the unsharded band model, serving and
  training, with exact band_matmul counts. Then every architecture of the
  static filter families (spectral, node-variant, edge-variant dense and
  edge, ARMA, aggregation) and the edge-gated GRNN at N = 128 on the card
  against the CPU, forward and gradients.

Every phase prints JSON lines (with its seconds); any failure exits
non-zero. The last line is ``{"ok": true, "device": {...}}``.

Needs CUDA and this repository's graph_neural_networks_torch package;
imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet rates: HBM bandwidth and
# FP32 (non-tensor-core) FMA peak. The kernels run true-f32 FMAs.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Special-function units: 16 exp2 results a clock on each SM (CUDA C
# programming guide, arithmetic instruction throughput, compute capability
# 9.0), 132 SMs at the 1.98 GHz boost clock behind the 67 TFLOP/s above.
SFU_EXP_PER_S = 132 * 16 * 1.98e9

# f32 agreement: |got - want| <= RTOL * |want| + ATOL_REL * max|want|.
# The kernels and their plain versions sum the same products in another
# order, so agreement is to a few ulps of the accumulated magnitude.
RTOL = 1e-4
ATOL_REL = 1e-5
# Serving compares band/bcsr to dense mode: the dense shift sums over all N
# nodes (zeros included) and the readout contracts 64*4096 features.
SERVE_RTOL = 1e-4
SERVE_ATOL_REL = 1e-4

N_GRAPH = 4096
BATCH = 32
REQUESTS = (32, 17, 1, 32)
TAPS = 5

# gat_band_n16384: experiments/tpu_r2_flashattn.py:74-81 (2 heads,
# F = G = 32, batch 8, bench.make_graph(16384, 0.01, 256, seed=1)) as the
# attentionMode="band" GraphAttentionNetwork of
# experiments/tpu_r2_flash_train.py:53-55
GAT_N = 16384
GAT_DIMS = [32, 32, 32]
GAT_HEADS = [2, 2]
GAT_BATCH = 8
GAT_REQUESTS = (8, 5, 1, 8)
GAT_SMALL_N = 2048   # the RESULTS.md parity point


class SmokeFailure(Exception):
    pass


def emit(**kw):
    print(json.dumps(kw), flush=True)


def require(cond: bool, what: str):
    if not cond:
        raise SmokeFailure(what)


def banded_graph(rng, N, bw, dens):
    """The banded GSO of experiments/bench_bf16_train.py:banded_graph."""
    W = np.zeros((N, N))
    nnz_per_row = max(2, int(dens * bw))
    for i in range(N):
        js = i - bw // 2 + rng.integers(0, bw, nnz_per_row)
        js = np.clip(js, 0, N - 1)
        W[i, js] = rng.random(len(js))
    W = (W + W.T) / 2
    np.fill_diagonal(W, 0)
    return W / np.max(np.abs(np.linalg.eigvalsh(W)))


def compare(got, want, rtol=RTOL, atol_rel=ATOL_REL):
    """(max abs err, max rel err, within tolerance?)"""
    import torch
    got, want = got.double(), want.double()
    err = (got - want).abs()
    scale = want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= rtol * want.abs() + atol_rel * scale).all())
    rel = (err / want.abs().clamp_min(1e-30 + atol_rel * scale)).max().item()
    return err.max().item(), rel, ok


def time_ms(fn, reps=25, inner=10):
    """Median over `reps` of the mean time of `inner` back-to-back calls,
    from CUDA events, after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def graph_ms(fn, n=10, reps=20):
    """Device time of one call: the median over `reps` replays of a CUDA
    graph of `n` calls, over n. Unlike time_ms it leaves out the host's
    launch overhead (the Python wrapper and its ctypes call), which a
    kernel of a few microseconds does not hide."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    emit(phase="device", nvidia_smi=card,
         torch_device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return card


def phase_build():
    from graph_neural_networks_torch import kernels
    _, secs = kernels.build()
    kernels.library()
    emit(phase="build", seconds=secs, sources=list(kernels.SOURCES))
    # every kernel's registers and local (spill) bytes, as the runtime
    # loaded them
    attrs = kernels.attributes()
    emit(phase="kernel_attributes", source="cudaFuncGetAttributes",
         kernels=attrs)
    for name, a in attrs.items():
        require(a["local_bytes"] == 0,
                f"{name} uses {a['local_bytes']} bytes of local memory")
    require(len(attrs) == 26, f"{len(attrs)} kernels in the library's "
            "tables, not 26 (12 kernels; band_register_kernel in 4 "
            "instances; bcsr_matmul_kernel and its 3 narrow-tile "
            "instances on 2 block layouts, BCSR and band, 8; "
            "attn_apply_kernel in 6, attn_stats_kernel and attn_bwd_kernel "
            "in 2 each, table_transpose_kernel in 2)")


def _band_case(rng, N, bs, w_target):
    """A banded S (as f32 numpy) whose block bandwidth is w_target."""
    S = np.zeros((N, N))
    half = max(w_target * bs, 1)
    for i in range(N):
        js = np.clip(i + rng.integers(-half + 1, half, 6), 0, N - 1)
        S[i, js] = rng.standard_normal(len(js))
    return S


def phase_kernels(graph, rng, dev):
    """Each kernel against its plain version on the card."""
    import torch
    from graph_neural_networks_torch.ops import gso as gso_lib
    from graph_neural_networks_torch.ops import spmm
    S_band, S_bcsr = graph["band"], graph["bcsr"]
    results, errs = [], {}

    def check(name, case, got, want):
        max_abs, max_rel, ok = compare(got, want)
        results.append(dict(kernel=name, case=case, max_abs_err=max_abs,
                            max_rel_err=max_rel, ok=ok))
        errs.setdefault(name, max_abs)
        require(ok, f"{name} [{case}] disagrees with its plain version: "
                    f"max abs {max_abs}, max rel {max_rel}")

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    N = N_GRAPH
    w, sb = S_band.band_w, S_band.s_band[0]
    # slice shapes: band_matmul at layer 2's rows (its backward), the
    # register at layer 1's, bcsr both
    x = rand(2048, N)
    check("band_matmul", "R=2048 N=4096 w=1",
          spmm.band_matmul(x, sb, n_cols=N, w=w),
          spmm.band_matmul_plain(x, sb, n_cols=N, w=w))
    x32 = rand(BATCH, N)
    check("band_shift_register", "R=32 N=4096 w=1 K=5",
          spmm.band_shift_register(x32, sb, n_taps=TAPS, n_cols=N, w=w),
          spmm.band_shift_register_plain(x32, sb, n_taps=TAPS, n_cols=N, w=w))
    bl, br, bc = S_bcsr.blocks[0], S_bcsr.block_row, S_bcsr.block_col
    cs, cs_t = S_bcsr.col_start, S_bcsr.col_start_t
    # the served and trained row counts (32, 17, 1 at layer 1; 2048, 1088,
    # 64 at layer 2), both sides of each tile's row limit, forward on the
    # Gso's cached segment offsets and backward on the transposed layout
    for R in (2048, 1088, 65, 64, 63, 32, 17, 1):
        xx = x[:R]
        check("bcsr_matmul", f"R={R} N=4096 nnzb={bl.shape[0]}",
              spmm.bcsr_matmul(xx, bl, br, bc, n_cols=N, col_start=cs),
              spmm.bcsr_matmul_plain(xx, bl, br, bc, n_cols=N))
        if R in (1, 32, 64, 2048):
            bt, rt, ct = (S_bcsr.blocks_t[0], S_bcsr.block_row_t,
                          S_bcsr.block_col_t)
            check("bcsr_matmul", f"R={R} N=4096 blocks_t",
                  spmm.bcsr_matmul(xx, bt, rt, ct, n_cols=N, col_start=cs_t),
                  spmm.bcsr_matmul_plain(xx, bt, rt, ct, n_cols=N))
    # N % 4 != 0 (4-byte staging of x) and a ragged last block (N = 4000),
    # both tiles; segment offsets computed by the wrapper
    for Ne in (4001, 4000):
        g = gso_lib.as_gso(_band_case(rng, Ne, 128, 1), "bcsr", device=dev)
        for R in (17, 64, 100):
            xe = rand(R, Ne)
            check("bcsr_matmul", f"R={R} N={Ne} nnzb={g.blocks.shape[1]}",
                  spmm.bcsr_matmul(xe, g.blocks[0], g.block_row, g.block_col,
                                   n_cols=Ne),
                  spmm.bcsr_matmul_plain(xe, g.blocks[0], g.block_row,
                                         g.block_col, n_cols=Ne))

    # edge cases
    for Ne, we, R in ((4000, 1, 100), (1024, 0, 70), (1000, 2, 9)):
        g = gso_lib.as_gso(_band_case(rng, Ne, 128, we), "band",
                           device=dev)
        xe = rand(R, Ne)
        case = f"R={R} N={Ne} w={g.band_w}"
        check("band_matmul", case,
              spmm.band_matmul(xe, g.s_band[0], n_cols=Ne, w=g.band_w),
              spmm.band_matmul_plain(xe, g.s_band[0], n_cols=Ne, w=g.band_w))
        check("band_shift_register", case + " K=3",
              spmm.band_shift_register(xe, g.s_band[0], n_taps=3, n_cols=Ne,
                                       w=g.band_w),
              spmm.band_shift_register_plain(xe, g.s_band[0], n_taps=3,
                                             n_cols=Ne, w=g.band_w))
    # band_matmul on the BCSR mainloop: both sides of each tile's row
    # limit (R = 1, 17, 33 the narrow tiles of 16, 32, 64 rows; 64, 65),
    # ragged N and n_cols (a partial last block; x narrower than S, so its
    # columns past N read as zero; N % 4 != 0 takes the 4-byte staging),
    # w = 0 and 3; and the sharded ring shift's shapes (n_cols = 1024,
    # w = 1: R = 32 at layer 1, 2048 at layer 2)
    for Ne, we, Nx in ((4000, 1, 4000), (1000, 0, 1000), (1001, 3, 990),
                       (1024, 1, 1024)):
        g = gso_lib.as_gso(_band_case(rng, Ne, 128, we), "band", device=dev)
        require(g.band_w == we, f"band case has w={g.band_w}, not {we}")
        for R in (1, 17, 33, 64, 65) + ((32, 2048) if Ne == 1024 else ()):
            xe = rand(R, Nx)
            check("band_matmul", f"R={R} N={Nx} n_cols={Ne} w={we}",
                  spmm.band_matmul(xe, g.s_band[0], n_cols=Ne, w=we),
                  spmm.band_matmul_plain(xe, g.s_band[0], n_cols=Ne, w=we))
    # the register's edge cases: K = 1 and 2; the served requests' rows;
    # the row limit; enough rows that a block walks several row tiles and
    # panels; w = 2 and the widest band register_fits admits; N % 4 != 0
    # (the element-wise staging)
    def check_register(case, xr, s, wr, K):
        n = xr.shape[1]
        check("band_shift_register", case,
              spmm.band_shift_register(xr, s, n_taps=K, n_cols=n, w=wr),
              spmm.band_shift_register_plain(xr, s, n_taps=K, n_cols=n,
                                             w=wr))

    for K in (1, 2):
        check_register(f"R=32 N={N} w={w} K={K}", x32, sb, w, K)
    for R in sorted({1, 17, 64, 65, 1000, spmm.REGISTER_MAX_ROWS}):
        check_register(f"R={R} N={N} w={w} K={TAPS}", rand(R, N), sb, w,
                       TAPS)
    w_max = max(v for v in range(32) if spmm.register_fits(128, v))
    for we in (2, w_max):
        g = gso_lib.as_gso(_band_case(rng, N, 128, we), "band", device=dev)
        require(g.band_w == we, f"band case has w={g.band_w}, not {we}")
        for R in (32, 256):   # both tiles of the kernel
            check_register(f"R={R} N={N} w={we} K={TAPS} (panel "
                           f"{spmm.register_smem_bytes(128, we)} B)",
                           rand(R, N), g.s_band[0], we, TAPS)
    g = gso_lib.as_gso(_band_case(rng, 1001, 128, 1), "band", device=dev)
    for R in (33, 300):
        check_register(f"R={R} N=1001 w={g.band_w} K=4", rand(R, 1001),
                       g.s_band[0], g.band_w, 4)
    if dev.type == "cuda":
        # one band wider than register_fits admits: the wrapper refuses
        # (gso.gshift_register chains band_matmul there)
        wide = torch.zeros(N // 128, (2 * w_max + 3) * 128, 128, device=dev)
        try:
            spmm.band_shift_register(x32, wide, n_taps=TAPS, n_cols=N,
                                     w=w_max + 1)
            raise SmokeFailure(f"band_shift_register took w={w_max + 1}")
        except ValueError:
            pass

    # rectangular BCSR with an empty output block column: x (R, n_in) on
    # its own 8-block grid, y (R, 640) on a 5-block grid, column 2 empty;
    # n_in = 1001 stages x by 4-byte copies
    n_out = 640
    pattern = [(r, c) for c in (0, 1, 3, 4) for r in range(8)
               if rng.random() < 0.5 or r == c]
    brow = torch.tensor([p[0] for p in pattern], dtype=torch.int32,
                        device=dev)
    bcol = torch.tensor([p[1] for p in pattern], dtype=torch.int32,
                        device=dev)
    blocks = rand(len(pattern), 128, 128)
    for n_in, R in ((1000, 50), (1001, 50), (1000, 130)):
        xr = rand(R, n_in)
        yr = spmm.bcsr_matmul(xr, blocks, brow, bcol, n_cols=n_out)
        require(bool((yr[:, 256:384] == 0).all()),
                "bcsr empty column not zero")
        check("bcsr_matmul", f"rect R={R} {n_in}->{n_out}, empty column",
              yr, spmm.bcsr_matmul_plain(xr, blocks, brow, bcol,
                                         n_cols=n_out))
    # square BCSR with a hole: drop block column 5 of the graph's layout
    keep = bc != 5
    bl2, br2, bc2 = (bl[keep].contiguous(), br[keep].contiguous(),
                     bc[keep].contiguous())
    check("bcsr_matmul", "R=32 N=4096, empty column 5",
          spmm.bcsr_matmul(x32[:, :N], bl2, br2, bc2, n_cols=N),
          spmm.bcsr_matmul_plain(x32[:, :N], bl2, br2, bc2, n_cols=N))

    # the raw wrappers record no gradient: a kernel call that would need
    # one raises (the autograd Functions call them with grad off)
    if dev.type == "cuda":
        xg = rand(8, N).requires_grad_()
        try:
            spmm.band_matmul(xg, sb, n_cols=N, w=w)
            raise SmokeFailure("band_matmul accepted an input that needs grad")
        except NotImplementedError:
            pass
        torch.cuda.synchronize()
    emit(phase="kernels", rtol=RTOL, atol=f"{ATOL_REL}*max|plain|",
         checks=results)
    return errs


def _window_blocks(nb, w):
    """Band window blocks that lie inside the matrix (what the kernel runs)."""
    return sum(1 for j in range(nb) for t in range(2 * w + 1)
               if 0 <= j + t - w < nb)


def _bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(graph, dev):
    import torch
    from graph_neural_networks_torch.ops import gso as gso_lib
    from graph_neural_networks_torch.ops import spmm
    S_band, S_bcsr = graph["band"], graph["bcsr"]
    N, bs, w = N_GRAPH, 128, S_band.band_w
    nb = N // bs
    sb = S_band.s_band[0]
    bl, br, bc = S_bcsr.blocks[0], S_bcsr.block_row, S_bcsr.block_col
    cs = S_bcsr.col_start
    nnzb = bl.shape[0]
    Sd = S_band.S[0]
    win = _window_blocks(nb, w)

    # measured FP32 matmul rate of this card (TF32 off), for reference
    a = torch.randn(8192, 8192, device=dev)
    b = torch.randn(8192, 8192, device=dev)
    mm_ms = time_ms(lambda: torch.matmul(a, b), reps=5, inner=2)
    f32_matmul_tflops = 2 * 8192 ** 3 / (mm_ms * 1e-3) / 1e12
    del a, b

    x2048 = torch.randn(2048, N, device=dev)
    x32 = torch.randn(BATCH, N, device=dev)
    out_reg = torch.empty(TAPS, BATCH, N, device=dev)

    def chained_matmul():
        out_reg[0].copy_(x32)
        for k in range(1, TAPS):
            torch.matmul(out_reg[k - 1], Sd, out=out_reg[k])

    rows = {}
    R = 2048
    rows["band_matmul"] = dict(
        shape=f"R={R} N={N} w={w}",
        ms=time_ms(lambda: spmm.band_matmul(x2048, sb, n_cols=N, w=w)),
        graph_ms=graph_ms(lambda: spmm.band_matmul(x2048, sb, n_cols=N,
                                                   w=w)),
        plain_ms=time_ms(lambda: spmm.band_matmul_plain(x2048, sb, n_cols=N,
                                                        w=w)),
        library_ms=time_ms(lambda: torch.matmul(x2048, Sd)),
        library_call="torch.matmul(x, S_dense), TF32 off",
        flops=2 * R * win * bs * bs,
        bytes=4 * (2 * R * N + win * bs * bs))
    # the sharded ring shift's band_matmul (band_n4096 over 4 shards: the
    # own block of 1024 nodes, w = 1) at layer 1's and layer 2's rows
    Ns = N // SHARD_PARTS
    gs = gso_lib.as_gso(_band_case(np.random.default_rng(2), Ns, bs, 1),
                        "band", device=dev)
    sbs, Sds = gs.s_band[0], gs.S[0]
    wins = _window_blocks(Ns // bs, 1)
    for R in (BATCH, 2048):
        xs = torch.randn(R, Ns, device=dev)
        rows[f"band_matmul@R={R} n_cols={Ns}"] = dict(
            shape=f"R={R} N={Ns} w=1",
            ms=time_ms(lambda: spmm.band_matmul(xs, sbs, n_cols=Ns, w=1)),
            graph_ms=graph_ms(lambda: spmm.band_matmul(xs, sbs, n_cols=Ns,
                                                       w=1)),
            plain_ms=time_ms(lambda: spmm.band_matmul_plain(
                xs, sbs, n_cols=Ns, w=1)),
            library_ms=time_ms(lambda: torch.matmul(xs, Sds)),
            library_call="torch.matmul(x, S_dense), TF32 off",
            flops=2 * R * wins * bs * bs,
            bytes=4 * (2 * R * Ns + wins * bs * bs))
    R = BATCH
    rows["band_shift_register"] = dict(
        shape=f"R={R} N={N} w={w} K={TAPS}",
        ms=time_ms(lambda: spmm.band_shift_register(
            x32, sb, n_taps=TAPS, n_cols=N, w=w)),
        plain_ms=time_ms(lambda: spmm.band_shift_register_plain(
            x32, sb, n_taps=TAPS, n_cols=N, w=w)),
        library_ms=time_ms(chained_matmul),
        library_call=f"{TAPS - 1} chained torch.matmul(z, S_dense), TF32 off",
        flops=(TAPS - 1) * 2 * R * win * bs * bs,
        bytes=4 * (R * N + TAPS * R * N + sb.numel()))
    # the chained alternative the fused-register rule picks between
    # (gso.gshift_register above REGISTER_MAX_ROWS rows)
    def chained_band():
        z = x32
        for _ in range(1, TAPS):
            z = spmm.band_matmul(z, sb, n_cols=N, w=w)

    chained_band_ms = time_ms(chained_band)
    sweep = _register_sweep(sb, Sd, N, w, dev)
    for R, xx in ((2048, x2048), (BATCH, x32)):
        rows[f"bcsr_matmul@R={R}"] = dict(
            shape=f"R={R} N={N} nnzb={nnzb}",
            ms=time_ms(lambda: spmm.bcsr_matmul(xx, bl, br, bc, n_cols=N,
                                                col_start=cs)),
            graph_ms=graph_ms(lambda: spmm.bcsr_matmul(
                xx, bl, br, bc, n_cols=N, col_start=cs)),
            plain_ms=time_ms(lambda: spmm.bcsr_matmul_plain(
                xx, bl, br, bc, n_cols=N)),
            library_ms=time_ms(lambda: torch.matmul(xx, Sd)),
            library_call="torch.matmul(x, S_dense), TF32 off",
            flops=2 * R * nnzb * bs * bs,
            bytes=4 * (2 * R * N + bl.numel() + 2 * nnzb))
    for row in rows.values():
        row["bound_ms"], row["bound_by"] = _bound(row["bytes"], row["flops"])
        row["bound_ms_at_measured_matmul_rate"] = max(
            row["bytes"] / HBM_BYTES_PER_S,
            row["flops"] / (f32_matmul_tflops * 1e12)) * 1e3
    emit(phase="timing", f32_matmul_tflops=f32_matmul_tflops,
         chained_band_matmul_ms_at_register_shape=chained_band_ms,
         peaks=dict(hbm_tb_s=HBM_BYTES_PER_S / 1e12,
                    fp32_tflops=FP32_FLOPS_PER_S / 1e12),
         rows=rows)
    emit(phase="register_sweep", **sweep)
    return rows


SWEEP_ROWS = (1, 8, 32, 64, 128, 256, 512, 1024, 2048)


def _register_sweep(sb, Sd, N, w, dev):
    """band_shift_register against its two alternatives, K-1 chained
    band_matmul (what gso.gshift_register runs above REGISTER_MAX_ROWS)
    and K-1 chained torch.matmul(z, S_dense), at each swept row count;
    `register_wins_up_to` is the largest row count up to which the
    register beats the chained band_matmul at every swept count."""
    import torch
    from graph_neural_networks_torch.ops import spmm
    rows = []
    for R in SWEEP_ROWS:
        x = torch.randn(R, N, device=dev)
        out = torch.empty(TAPS, R, N, device=dev)

        def chained_band():
            z = x
            for _ in range(1, TAPS):
                z = spmm.band_matmul(z, sb, n_cols=N, w=w)

        def chained_dense():
            out[0].copy_(x)
            for k in range(1, TAPS):
                torch.matmul(out[k - 1], Sd, out=out[k])

        rows.append(dict(
            R=R,
            register_ms=time_ms(lambda: spmm.band_shift_register(
                x, sb, n_taps=TAPS, n_cols=N, w=w), reps=11),
            chained_band_matmul_ms=time_ms(chained_band, reps=11),
            chained_dense_ms=time_ms(chained_dense, reps=11)))
    wins = 0
    for row in rows:
        if row["register_ms"] >= row["chained_band_matmul_ms"]:
            break
        wins = row["R"]
    return dict(N=N, w=w, K=TAPS, rows=rows, register_wins_up_to=wins,
                REGISTER_MAX_ROWS=spmm.REGISTER_MAX_ROWS)


def _build_model(S, mode, dev):
    import torch
    from graph_neural_networks_torch.models import architectures as archs
    N = S.shape[0]
    return archs.SelectionGNN(
        [1, 64, 64], [TAPS, TAPS], True, "relu", [N, N], "NoPool", [1, 1],
        [5], S, gsoMode=mode, device=dev,
        generator=torch.Generator().manual_seed(0))


def _band_launches(step):
    """band_n4096's band-mode SpMM launches in one forward (step=False) or
    one training step: layer l's register has BATCH * G_l rows (G = 1,
    64), one band_shift_register at most spmm.REGISTER_MAX_ROWS rows, else
    TAPS-1 chained band_matmul; a step adds layer 2's backward, TAPS-1
    band_matmul (layer 1's input needs no gradient)."""
    from graph_neural_networks_torch.ops import spmm
    fused = [BATCH * g <= spmm.REGISTER_MAX_ROWS for g in (1, 64)]
    return {"band_shift_register": sum(fused),
            "band_matmul": (TAPS - 1) * (fused.count(False) + int(step))}


def phase_serving(S_np, rng, dev):
    """Serve the four requests in band and bcsr mode; the main path."""
    import torch
    from graph_neural_networks_torch.ops import spmm
    from graph_neural_networks_torch.serving import InferenceEngine
    engines = {m: InferenceEngine(_build_model(S_np, m, dev), BATCH, dev)
               for m in ("dense", "band", "bcsr")}
    ref = list(engines["dense"].arch.parameters())
    for m in ("band", "bcsr"):
        require(all(torch.equal(p, q) for p, q in
                    zip(engines[m].arch.parameters(), ref)),
                f"{m} model weights differ from dense")
    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    requests = [rng.standard_normal((n, 1, N_GRAPH)).astype(np.float32)
                for n in REQUESTS]
    want = [engines["dense"](x) for x in requests]

    expected = {"band": dict(_band_launches(step=False), bcsr_matmul=0),
                "bcsr": {"band_shift_register": 0, "band_matmul": 0,
                         "bcsr_matmul": 8}}
    launches, checks = {}, []
    for mode in ("band", "bcsr"):
        eng = engines[mode]
        spmm.reset_launch_counts()
        t0 = time.perf_counter()
        with _cached_structure(f"serving {mode}"):
            answers = [eng(x) for x in requests]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches for fn in spmm.KERNEL_WRAPPERS}
        per_forward = {k: v / len(REQUESTS) for k, v in counts.items()}
        require(per_forward == expected[mode],
                f"{mode}: launches per forward {per_forward}, expected "
                f"{expected[mode]}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        for x, y, yd in zip(requests, answers, want):
            require(tuple(y.shape) == (x.shape[0], 5) and y.dtype ==
                    torch.float32, f"{mode}: output {tuple(y.shape)}")
            max_abs, max_rel, ok = compare(y, yd, SERVE_RTOL, SERVE_ATOL_REL)
            checks.append(dict(mode=mode, batch=x.shape[0], max_abs_err=max_abs,
                               max_rel_err=max_rel, ok=ok))
            require(ok, f"{mode} batch {x.shape[0]} disagrees with dense: "
                        f"{max_abs}")
        emit(phase="serving", mode=mode, requests=list(REQUESTS),
             seconds=seconds, launches=counts, launches_per_forward=per_forward)
    emit(phase="serving_check", rtol=SERVE_RTOL,
         atol=f"{SERVE_ATOL_REL}*max|dense|", checks=checks)
    for mode in ("band", "bcsr", "dense"):
        _profile_forward(mode, engines[mode], requests[0])

    # small input: the band model on the card against the same model on the
    # CPU (the plain path the CPU tests hold against the JAX package)
    S_small = banded_graph(np.random.default_rng(1), 384, 160, 0.05)
    x = rng.standard_normal((4, 1, 384)).astype(np.float32)
    with torch.inference_mode():
        cpu = _build_model(S_small, "band", "cpu")(x)
        gpu = _build_model(S_small, "band", dev)(x)
    max_abs, _, ok = compare(gpu.cpu(), cpu, SERVE_RTOL, SERVE_ATOL_REL)
    emit(phase="small_reference", N=384, max_abs_err=max_abs, ok=ok)
    require(ok, "band model on the card disagrees with the CPU at N=384")
    return launches


def _profile_forward(mode, eng, x, n=10):
    """Where one served forward spends its time: the host clock per
    forward without the profiler, and device time by kernel from
    torch.profiler over `n` forwards."""
    prof = _device_profile(lambda: eng(x), n)
    emit(phase="profile", mode=mode, batch=int(x.shape[0]),
         wall_ms_per_forward=prof["wall_ms"],
         profiled_wall_ms_per_forward=prof["profiled_wall_ms"],
         device_ms_per_forward=prof["device_ms"],
         device_idle_share=prof["device_idle_share"],
         top=[dict(name=t["name"], ms_per_forward=t["ms"],
                   calls_per_forward=t["calls"]) for t in prof["top"]])


# ---------------------------------------------------------------------------
# Attention path (flash kernels)
# ---------------------------------------------------------------------------

def make_graph(N, density, bandwidth, seed=0):
    """bench.py:make_graph: the banded, non-symmetric graph of the flash
    attention benchmarks (edges within `bandwidth` of the diagonal)."""
    rng = np.random.default_rng(seed)
    S = np.zeros((N, N), np.float32)
    ii = rng.integers(0, N, size=int(density * N * N))
    jj = ii + rng.integers(-bandwidth, bandwidth + 1, size=len(ii))
    ok = (jj >= 0) & (jj < N)
    S[ii[ok], jj[ok]] = rng.random(ok.sum())
    return S, int((np.abs(S) > 0).sum())


def _attn_case(rng, N, w_target, E=1, bs=128):
    """E non-symmetric banded GSOs whose block bandwidth is w_target (for
    w_target = 0, nonzeros inside the diagonal blocks)."""
    S = np.zeros((E, N, N), np.float32)
    for e in range(E):
        ii = rng.integers(0, N, 6 * N)
        if w_target == 0:
            jj = ii // bs * bs + rng.integers(0, bs, len(ii))
        else:
            jj = ii + rng.integers(1 - w_target * bs, w_target * bs, len(ii))
        ok = (jj >= 0) & (jj < N)
        S[e, ii[ok], jj[ok]] = rng.random(ok.sum())
    return S


def _attn_holes_case(rng, N=2048, bs=128):
    """A w = 2 band with holes: no support in the whole window tile of row
    block 3 and column block 5 (k = 0 of column block 5), nor in the
    32 x 64 sub-tile at rows 6 bs .. 6 bs + 32, columns 7 bs .. 7 bs + 64
    (k = 1 of column block 7): the apply kernel skips both."""
    S = _attn_case(rng, N, 2)
    S[0, 3 * bs:4 * bs, 5 * bs:6 * bs] = 0
    S[0, 6 * bs:6 * bs + 32, 7 * bs:7 * bs + 64] = 0
    return S


def _apply_group(Q, F, Np, dev):
    """The signal rows a block of attn_apply_kernel serves at (Q, F, Np),
    as its launcher picks them ("plain" off the card)."""
    if dev.type != "cuda":
        return "plain"
    from graph_neural_networks_torch import kernels
    return kernels.library().gnt_attn_apply_group(Q, F, Np)


def _empty_rows(mask_row, rows):
    """mask_row (nb, W, ibs, ibs) with the given rows' support removed:
    rows without support."""
    m = mask_row.clone()
    ibs = m.shape[-1]
    for r in rows:
        m[r // ibs, :, r % ibs, :] = 0
    return m


def _other_rows(Np, rows):
    """The row indices below Np but those given."""
    return sorted(set(range(Np)) - set(rows))


def _check_empty_rows(name, mx, sm, rows, W, ibs):
    """A row without support: rowmax -1e12 and rowsum W*ibs (every window
    entry, as the JAX kernels count them), exactly."""
    require(bool((mx[:, rows] == -1e12).all())
            and bool((sm[:, rows] == float(W * ibs)).all()),
            f"{name}: a row without support has rowmax "
            f"{mx[:, rows].unique().tolist()}, rowsum "
            f"{sm[:, rows].unique().tolist()}, not -1e12 and {W * ibs}")


def _attn_operands(rng, dev, Q, F, N, Np):
    """Score projections (Q, Np) and signals (Q, F, Np), zero past N."""
    import torch

    def rand(*shape):
        t = np.zeros(shape[:-1] + (Np,), np.float32)
        t[..., :N] = rng.standard_normal(shape[:-1] + (N,))
        return torch.as_tensor(t, device=dev)
    return rand(Q, N), rand(Q, N), rand(Q, F, N)


def _attention_counts():
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.ops import spmm
    return {fn.__name__: fn.launches
            for fn in spmm.KERNEL_WRAPPERS + af.KERNEL_WRAPPERS}


def _reset_counts():
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.ops import spmm
    spmm.reset_launch_counts()
    af.reset_launch_counts()


def phase_attention_kernels(gso, rng, dev):
    """stats_call and apply_call against their plain versions on the card:
    at the served shape (layer inputs of gat_band_n16384: Q = 16, F = 32,
    with_s True and False) and at edge cases."""
    import torch
    from graph_neural_networks_torch.ops import attention_band as ab
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.ops import gso as gso_lib
    t_phase = time.perf_counter()
    results, errs = [], {}

    def check(name, case, got, want, served=False):
        max_abs, max_rel, ok = compare(got, want)
        results.append(dict(kernel=name, case=case, max_abs_err=max_abs,
                            max_rel_err=max_rel,
                            max_abs_plain=want.abs().max().item(), ok=ok))
        if served:
            errs[name] = max(errs.get(name, 0.0), max_abs)
        require(ok, f"{name} [{case}] disagrees with its plain version: "
                    f"max abs {max_abs}, max rel {max_rel}")

    def both(case, g, Q, F, served=False, with_s=(True, False)):
        ibs, w = g.block_size, g.band_w
        Np = g.s_band.shape[1] * ibs
        a1, a2, v = _attn_operands(rng, dev, Q, F, g.n, Np)
        case = f"{case} G={_apply_group(Q, F, Np, dev)}"
        for e, aux in enumerate(af.band_auxes(g)):
            tag = f"{case} e={e}" if g.E > 1 else case
            mx, sm = af.stats_call(a1, a2, aux.mask_row, w=w, ibs=ibs)
            pmx, psm = af.stats_plain(a1, a2, aux.mask_row, w=w, ibs=ibs)
            check("stats_call", tag + " rowmax", mx, pmx, served)
            check("stats_call", tag + " rowsum", sm, psm, served)
            for ws in with_s:
                args = (a1, a2, v, pmx, psm, aux.slab_col, aux.mask_col)
                got = af.apply_call(*args, w=w, ibs=ibs, with_s=ws,
                                    lists=aux.lists)
                want = af.apply_plain(*args, w=w, ibs=ibs, with_s=ws)
                check("apply_call", f"{tag} with_s={ws}", got, want, served)
                require(bool(torch.isfinite(got).all()),
                        f"apply_call [{tag}] is not finite")

    both(f"served Q=16 F=32 N={GAT_N} w={gso.band_w}", gso, 16, 32,
         served=True)
    # the apply kernel serves G = 4, 2 or 1 signal rows a block (G = 4 to
    # F = 32, 2 to F = 64), the rows past Q of the last group idle
    cases = [  # (N, w, E, Q, F)
        (4000, 1, 1, 16, 32),     # ragged N: the last block is partial
        (2048, 0, 1, 5, 32),      # w = 0: diagonal blocks only; Q = 4 + 1
        (2048, 3, 1, 3, 40),      # w = 3; F = 40 in a 64-feature pass
        (1024, 2, 1, 1, 8),       # Q = 1, F = 8, first and last w blocks
        (2048, 7, 1, 2, 8),       # w = 7: the stats mask rows need > 48 KB
        (1500, 1, 2, 4, 16),      # E = 2 with a shared support, ragged
        (2048, 2, 1, 7, 64),      # Q = 7 = 2 + 2 + 2 + 1, F = 64
        (2048, 2, 1, 16, 64),     # Q = 16 at F = 64
    ]
    for N, w, E, Q, F in cases:
        S = _attn_case(rng, N, w, E)
        require(not np.allclose(S, np.swapaxes(S, 1, 2)), "S is symmetric")
        g = gso_lib.as_gso(S, "band", device=dev)
        both(f"N={N} w={g.band_w} E={E} Q={Q} F={F}", g, Q, F)
        if E > 1:   # the entry point's edge-feature loop, against the
            # materialized band path on the card
            x = torch.as_tensor(rng.standard_normal((2, 6, N)),
                                dtype=torch.float32, device=dev)
            a = torch.as_tensor(rng.standard_normal((2, E, 2 * F)) * .3,
                                dtype=torch.float32, device=dev)
            W_p = torch.as_tensor(rng.standard_normal((2, E, F, 6)) * .3,
                                  dtype=torch.float32, device=dev)
            with torch.inference_mode():
                got = af.graph_attention_band_flash(
                    x, a, W_p, af.slab5(g), g.band_w,
                    auxes=af.band_auxes(g))
                want = ab.graph_attention_band(x, a, W_p, af.slab5(g),
                                               g.band_w)
            max_abs, _, ok = compare(got, want, SERVE_RTOL, SERVE_ATOL_REL)
            results.append(dict(kernel="graph_attention_band_flash",
                                case=f"N={N} E={E} vs materialized",
                                max_abs_err=max_abs, ok=ok))
            require(ok, f"flash GAT layer (E={E}) disagrees with the "
                        f"materialized band path: {max_abs}")

    g = gso_lib.as_gso(_attn_holes_case(rng), "band", device=dev)
    require(g.band_w == 2, f"holes case has w={g.band_w}")
    both("holes: an empty window tile and sub-tile, N=2048 w=2 Q=16 F=32",
         g, 16, 32)
    # rows without support in the first and last w row blocks (whose
    # windows leave the matrix) and in the middle: rowmax -1e12 and rowsum
    # W*ibs, as the JAX kernel and stats_plain give them
    ibs, w = g.block_size, g.band_w
    Np = g.s_band.shape[1] * ibs
    rows = [0, 5, ibs + 64, Np // 2 + 3, Np - 2 * ibs + 1, Np - 1]
    mrow = _empty_rows(af.band_auxes(g)[0].mask_row, rows)
    for Q in (16, 5):
        a1, a2, _ = _attn_operands(rng, dev, Q, 8, g.n, Np)
        mx, sm = af.stats_call(a1, a2, mrow, w=w, ibs=ibs)
        pmx, psm = af.stats_plain(a1, a2, mrow, w=w, ibs=ibs)
        case = f"empty rows {rows} N={g.n} w={w} Q={Q}"
        keep = _other_rows(Np, rows)   # -1e12 would set the tolerance
        check("stats_call", case + " rowmax", mx[:, keep], pmx[:, keep])
        check("stats_call", case + " rowsum", sm[:, keep], psm[:, keep])
        _check_empty_rows("stats_call", mx, sm, rows, 2 * w + 1, ibs)
        _check_empty_rows("stats_plain", pmx, psm, rows, 2 * w + 1, ibs)
    # a negative LeakyReLU slope: the score is not monotone in a1
    mx, sm = af.stats_call(a1, a2, mrow, w=w, ibs=ibs, slope=-0.3)
    pmx, psm = af.stats_plain(a1, a2, mrow, w=w, ibs=ibs, slope=-0.3)
    check("stats_call", f"slope=-0.3 N={g.n} w={w} Q=5 rowmax",
          mx[:, keep], pmx[:, keep])
    check("stats_call", f"slope=-0.3 N={g.n} w={w} Q=5 rowsum",
          sm[:, keep], psm[:, keep])

    # the raw wrappers record no gradient: a kernel call that would need
    # one raises (FlashApply calls them with grad off)
    if dev.type == "cuda":
        aux = af.band_auxes(gso)[0]
        a1, a2, v = _attn_operands(rng, dev, 2, 4, GAT_N, GAT_N)
        try:
            af.stats_call(a1.requires_grad_(), a2, aux.mask_row,
                          w=gso.band_w, ibs=gso.block_size)
            raise SmokeFailure("stats_call accepted an input that needs "
                               "grad")
        except NotImplementedError:
            pass
        torch.cuda.synchronize()
    emit(phase="attention_kernels", rtol=RTOL, atol=f"{ATOL_REL}*max|plain|",
         checks=results, seconds=time.perf_counter() - t_phase)
    return errs


def _attention_work(gso, Q, F, with_s=True):
    """Scores, bytes and operations of one stats and one apply call at
    (Q, F) on this band layout: dense-tile counts over the window blocks
    inside the matrix (what the kernels run), and the scores on the S+I
    support only."""
    from graph_neural_networks_torch.ops import attention_flash as af
    aux = af.band_auxes(gso)[0]
    ibs, w = gso.block_size, gso.band_w
    nb = gso.s_band.shape[1]
    Np, W = nb * ibs, 2 * w + 1
    return _attention_work_at(
        Q, F, Np, Np, nb * W * ibs * ibs,
        Q * _window_blocks(nb, w) * ibs * ibs,
        Q * int(aux.mask_row.sum().item()), with_s)


def _attention_bound(nbytes, flops_per, exps):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops_per * exps / FP32_FLOPS_PER_S,
                exps / SFU_EXP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_attention_timing(gso, dev):
    """Each attention kernel at the served shape (Q = 16, F = 32, with_s)
    beside its plain version and its bound; the flash GAT layer beside the
    materialized band layer, for scale (no single PyTorch call computes
    either kernel's function)."""
    import torch
    from graph_neural_networks_torch.ops import attention_band as ab
    from graph_neural_networks_torch.ops import attention_flash as af
    t_phase = time.perf_counter()
    Q, F = GAT_BATCH * GAT_HEADS[0], GAT_DIMS[1]
    ibs, w = gso.block_size, gso.band_w
    aux = af.band_auxes(gso)[0]
    a1, a2, v = _attn_operands(np.random.default_rng(5), dev, Q, F, GAT_N,
                               GAT_N)
    kw = dict(w=w, ibs=ibs)
    mx, sm = af.stats_plain(a1, a2, aux.mask_row, **kw)
    app = (a1, a2, v, mx, sm, aux.slab_col, aux.mask_col)
    lists = aux.lists
    work = _attention_work(gso, Q, F)
    shape = f"Q={Q} F={F} N={GAT_N} w={w} ibs={ibs}"
    rows = {
        "stats_call": dict(
            shape=shape,
            ms=time_ms(lambda: af.stats_call(a1, a2, aux.mask_row, **kw)),
            graph_ms=graph_ms(lambda: af.stats_call(a1, a2, aux.mask_row,
                                                    **kw)),
            plain_ms=time_ms(lambda: af.stats_plain(a1, a2, aux.mask_row,
                                                    **kw), reps=5, inner=2),
            work=work["stats"]),
        "apply_call": dict(
            shape=shape + " with_s",
            ms=time_ms(lambda: af.apply_call(*app, **kw, lists=lists)),
            graph_ms=graph_ms(lambda: af.apply_call(*app, **kw,
                                                    lists=lists)),
            G=_apply_group(Q, F, GAT_N, dev),
            plain_ms=time_ms(lambda: af.apply_plain(*app, **kw), reps=5,
                             inner=2),
            work=work["apply"]),
    }
    for row in rows.values():
        # the bound counts the work on the S+I support only: a masked score
        # adds exactly 0 to the max, the sum and the aggregation, so the
        # function needs no exp or FMA for it; the dense-tile figure (every
        # score of every window tile, what the kernels execute) beside it
        nbytes, flops_per = row.pop("work")
        row["bound_ms"], row["bound_by"] = _attention_bound(
            nbytes, flops_per, work["support_scores"])
        row["bound_ms_dense_tiles"], row["bound_by_dense_tiles"] = (
            _attention_bound(nbytes, flops_per, work["scores"]))
        row["bytes"], row["flops"] = nbytes, flops_per * work["support_scores"]
        row["library_ms"] = None
    # one GAT layer (B = 8, G = F = 32, 2 heads) both ways, for scale
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(GAT_BATCH, GAT_DIMS[0], GAT_N, generator=g).to(dev)
    a = (torch.randn(2, 1, 2 * F, generator=g) * .1).to(dev)
    W_p = (torch.randn(2, 1, F, GAT_DIMS[0], generator=g) * .1).to(dev)
    s5 = af.slab5(gso)
    with torch.inference_mode():
        flash_layer_ms = time_ms(lambda: af.graph_attention_band_flash(
            x, a, W_p, s5, w, auxes=af.band_auxes(gso)), reps=10, inner=3)
        torch.cuda.reset_peak_memory_stats()
        band_layer_ms = time_ms(lambda: ab.graph_attention_band(
            x, a, W_p, s5, w), reps=5, inner=1)
        band_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit(phase="attention_timing", rows=rows, scores=work["scores"],
         support_scores=work["support_scores"],
         peaks=dict(hbm_tb_s=HBM_BYTES_PER_S / 1e12,
                    fp32_tflops=FP32_FLOPS_PER_S / 1e12,
                    sfu_texp_s=SFU_EXP_PER_S / 1e12),
         library="none: no single PyTorch call computes either function",
         flash_gat_layer_ms=flash_layer_ms,
         materialized_band_gat_layer_ms=band_layer_ms,
         materialized_band_layer_peak_gb=band_peak_gb,
         seconds=time.perf_counter() - t_phase)
    return rows


def _build_gat(cls_name, S, mode, dev, dims=GAT_DIMS, heads=GAT_HEADS,
               taps=None):
    import torch
    from graph_neural_networks_torch.models import architectures as archs
    N = S.shape[0]
    L = len(dims) - 1
    common = dict(attentionMode=mode, device=dev,
                  generator=torch.Generator().manual_seed(0))
    if cls_name == "GraphAttentionNetwork":
        return archs.GraphAttentionNetwork(
            dims, heads, "relu", [N] * L, "NoPool", [1] * L, [4], True, S,
            **common)
    return getattr(archs, cls_name)(
        dims, taps, heads, True, "relu", [N] * L, "NoPool", [1] * L, [4], S,
        **common)


def _materialized_forward(arch, x, grad=False):
    """A served GAT through the port's materialized band attention
    (ops/attention_band.py), layer by layer with the model's weights:
    (readout output, last attention layer's output). grad=True records
    autograd (the reference of the training gradients)."""
    import torch
    from graph_neural_networks_torch.models.layers import _heads_out
    from graph_neural_networks_torch.ops import attention_band as ab
    from graph_neural_networks_torch.ops import attention_flash as af
    S = arch.S
    with contextlib.nullcontext() if grad else torch.inference_mode():
        x = torch.as_tensor(x, device=arch.device)[:, :, arch.ctx["order_map"]]
        for layer in arch.core.filters:
            y = ab.graph_attention_band(x, layer.mixer, layer.weight,
                                        af.slab5(S), S.band_w)
            x = _heads_out(y, layer.nonlinearity, layer.concatenate)
        return arch.core.readout(x.reshape(x.shape[0], -1)), x


def phase_attention_serving(rng, dev):
    """Serve gat_band_n16384 (the main path of this phase) and check it
    against the materialized band path on the card; then GAT, GCAT and
    EdgeVariantAttention at N = 2048 against dense mode."""
    import torch
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.serving import InferenceEngine
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    S, nnz = make_graph(GAT_N, 0.01, 256, seed=1)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    arch = _build_gat("GraphAttentionNetwork", S, "band", dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    # the band structure's build time, on a copy thrown away: the engine
    # builds the model's own at its first request
    t0 = time.perf_counter()
    spare = af._auxes(af.slab5(arch.S), arch.S.band_w)
    torch.cuda.synchronize()
    t_aux = time.perf_counter() - t0
    del spare
    eng = InferenceEngine(arch, GAT_BATCH, dev)
    require(getattr(arch.S, "_band_auxes", None) is None,
            "the band structure was built before the first request")
    emit(phase="attention_graph", N=GAT_N, nnz=nnz, band_w=arch.S.band_w,
         nb=arch.S.s_band.shape[1], host_seconds_make_graph=t_graph,
         host_seconds_build_model=t_build, seconds_band_aux=t_aux)
    requests = [rng.standard_normal((n, GAT_DIMS[0], GAT_N)).astype(
        np.float32) for n in GAT_REQUESTS]

    # the main path: counts set to 0 just before, read just after
    _reset_counts()
    t0 = time.perf_counter()
    with _cached_structure("gat_band_n16384 first request", lists=1):
        answers = [eng(requests[0])]   # band structure built here
    torch.cuda.synchronize()
    seconds_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    with _cached_structure("gat_band_n16384"):
        answers += [eng(x) for x in requests[1:]]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _attention_counts()
    auxes = getattr(eng.arch.S, "_band_auxes", None)
    require(eng.arch.S is arch.S and auxes is not None
            and not any(t.is_inference() for aux in auxes for t in aux),
            "the first request did not cache the band structure on the "
            "model's GSO outside inference mode")
    per_forward = {k: v / len(GAT_REQUESTS) for k, v in counts.items()}
    expected = {k: 0 for k in counts}
    expected.update(stats_call=2, apply_call=2)
    require(per_forward == expected,
            f"gat_band_n16384: launches per forward {per_forward}, "
            f"expected {expected}")
    checks = []

    def check(model, x, against, got, want, **extra):
        """Readout outputs and last attention layer outputs (the
        readout's 65536-input sum can round small errors away)."""
        for what, g, w in zip(("y", "y_gfl"), got, want):
            max_abs, max_rel, ok = compare(g, w, SERVE_RTOL, SERVE_ATOL_REL)
            checks.append(dict(model=model, batch=x.shape[0], output=what,
                               against=against, max_abs_err=max_abs,
                               max_rel_err=max_rel,
                               max_abs_ref=w.abs().max().item(), ok=ok,
                               **extra))
            require(ok, f"{model} batch {x.shape[0]}: {what} disagrees with "
                        f"{against}: {max_abs}")

    for x, y in zip(requests, answers):
        require(tuple(y.shape) == (x.shape[0], 4) and y.dtype ==
                torch.float32 and bool(torch.isfinite(y).all()),
                f"gat_band_n16384: output {tuple(y.shape)}")
        with torch.inference_mode():
            gfl = eng.arch.split_forward(x)[1]
        check("gat_band_n16384", x, "materialized band", (y, gfl),
              _materialized_forward(eng.arch, x))
    emit(phase="attention_serving", model="gat_band_n16384",
         requests=list(GAT_REQUESTS), seconds_first_request=seconds_first,
         seconds_other_requests=seconds, launches=counts,
         launches_per_forward=per_forward)
    launches = dict(counts)

    # N = 2048: band mode against dense mode, same weights
    S2, _ = make_graph(GAT_SMALL_N, 0.01, 256, seed=1)
    small = [("GraphAttentionNetwork", GAT_DIMS, GAT_HEADS, None),
             ("GraphConvolutionAttentionNetwork", [64, 16, 16], [2, 2],
              [3, 2]),
             ("EdgeVariantAttention", [32, 16], [2], [3])]
    for cls_name, dims, heads, taps in small:
        engines = {m: InferenceEngine(
            _build_gat(cls_name, S2, m, dev, dims, heads, taps), GAT_BATCH,
            dev) for m in ("band", "dense")}
        require(all(torch.equal(p, q) for p, q in zip(
            engines["band"].arch.parameters(),
            engines["dense"].arch.parameters())),
            f"{cls_name}: band and dense weights differ")
        xs = [rng.standard_normal((n, dims[0], GAT_SMALL_N)).astype(
            np.float32) for n in (GAT_BATCH, 3)]
        _reset_counts()
        got = [engines["band"](x) for x in xs]
        counts = _attention_counts()
        require(counts["stats_call"] > 0 and counts["apply_call"] > 0,
                f"{cls_name}: the band model launched no attention kernel")
        for x, y in zip(xs, got):
            with torch.inference_mode():
                gfl = engines["band"].arch.split_forward(x)[1]
                want = engines["dense"].arch.split_forward(x)
            check(f"{cls_name} N={GAT_SMALL_N}", x, "dense", (y, gfl),
                  want, launches=counts)
    emit(phase="attention_serving_check", rtol=SERVE_RTOL,
         atol=f"{SERVE_ATOL_REL}*max|reference|", checks=checks,
         seconds=time.perf_counter() - t_phase)
    return eng, requests[0], launches


# ---------------------------------------------------------------------------
# Training path (flash backward kernel, differentiable shifts)
# ---------------------------------------------------------------------------

TRAIN_STEPS = 8
# Training holds the band/bcsr/flash paths against a reference path on the
# card (dense mode; the materialized band path at N = 16384): first-step
# gradients within rtol 1e-4, atol 1e-4*max|reference| (f32 sums in
# another order through two layers and their VJPs), and the losses of 8
# Adam steps within rtol 1e-4 (the same differences carried through the
# optimizer).
TRAIN_RTOL = 1e-4
TRAIN_ATOL_REL = 1e-4
LOSS_RTOL = 1e-4
# At N = 16384 the reference is the materialized band path in f64 on the
# flash forward's ReLU gates (_relu_gates): among 8.4M outputs a layer a
# few lie within f32 rounding of 0, and a gate that flips between two f32
# paths moves a weight gradient by ~1e-3 of its max. A gradient whose f32
# materialized value misses the tolerance itself (the first layer's
# attention vector: its per-score terms cancel to ~1e-4 of their sum) is
# held to at most ILL_COND_FACTOR times that path's error instead.
ILL_COND_FACTOR = 2.0


def phase_train_kernels(gso, graph, rng, dev):
    """bwd_call against bwd_plain on the card at the served shape (Q = 16,
    F = 32, with S), the GCAT shape (F = 64, without S) and edge cases;
    then the input gradients of the three SpMM Functions against the plain
    versions of their backward shifts."""
    import torch
    from graph_neural_networks_torch import kernels
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.ops import gso as gso_lib
    from graph_neural_networks_torch.ops import spmm
    t_phase = time.perf_counter()
    results, errs = [], {}

    def check(name, case, got, want, served=False):
        max_abs, max_rel, ok = compare(got, want)
        results.append(dict(kernel=name, case=case, max_abs_err=max_abs,
                            max_rel_err=max_rel,
                            max_abs_plain=want.abs().max().item(), ok=ok))
        if served:
            errs[name] = max(errs.get(name, 0.0), max_abs)
        require(ok, f"{name} [{case}] disagrees with its plain version: "
                    f"max abs {max_abs}, max rel {max_rel}")

    def bwd(case, g, Q, F, with_s=(True, False), served=False):
        ibs, w = g.block_size, g.band_w
        Np = g.s_band.shape[1] * ibs
        empty, total = _empty_subchunks(g)
        case = f"{case} ({empty} of {total} sub-chunks skipped)"
        a1, a2, v = _attn_operands(rng, dev, Q, F, g.n, Np)
        ct = _attn_operands(rng, dev, Q, F, g.n, Np)[2]
        for e, aux in enumerate(af.band_auxes(g)):
            tag = f"{case} e={e}" if g.E > 1 else case
            mx, sm = af.stats_plain(a1, a2, aux.mask_row, w=w, ibs=ibs)
            args = (a1, a2, v, mx, sm, aux.slab_col, aux.mask_row, ct)
            for ws in with_s:
                got = af.bwd_call(*args, w=w, ibs=ibs, with_s=ws)
                torch.cuda.synchronize()
                want = af.bwd_plain(*args, w=w, ibs=ibs, with_s=ws)
                for what, t, p in zip(("da2", "da1p", "dv"), got, want):
                    require(bool(torch.isfinite(t).all()),
                            f"bwd_call [{tag}] {what} is not finite")
                    check("bwd_call", f"{tag} with_s={ws} {what}", t, p,
                          served)
                del got, want

    F = GAT_DIMS[1]
    Q = GAT_BATCH * GAT_HEADS[0]
    # the served graph's window tiles k = 0 and 2w lie half outside its
    # band: the kernel skips their sub-chunks without support
    require(_empty_subchunks(gso)[0] > 0, "no sub-chunk to skip")
    bwd(f"served Q={Q} F={F} N={GAT_N} w={gso.band_w}", gso, Q, F,
        with_s=(True,), served=True)
    bwd(f"GCAT shape Q={Q} F=64 N={GAT_N}", gso, Q, 64, with_s=(False,))
    cases = [  # (N, w in blocks, ibs, E, Q, F)
        (4000, 1, 128, 1, 16, 32),    # ragged N: the last block is partial
        (2048, 0, 128, 1, 5, 32),     # w = 0: diagonal blocks only
        (2048, 3, 128, 1, 3, 40),     # w = 3; F = 40: two feature slices
        (1024, 2, 128, 1, 1, 5),      # Q = 1, F = 5 (not a tile multiple)
        (1000, 3, 64, 2, 2, 8),       # ibs = 64 (half a row tile), E = 2
        (2000, 1, 192, 1, 4, 32),     # ibs = 192: a partial last row tile
        (2048, 1, 256, 1, 2, 36),     # ibs = 256: two row tiles
    ]
    for N, w, ibs, E, Qe, Fe in cases:
        S = _attn_case(rng, N, w, E, bs=ibs)
        require(not np.allclose(S, np.swapaxes(S, 1, 2)), "S is symmetric")
        g = gso_lib.as_gso(S, "band", block_size=ibs, device=dev)
        bwd(f"N={N} w={g.band_w} ibs={ibs} E={E} Q={Qe} F={Fe}", g, Qe, Fe)
    # every sub-chunk of the window with support: nothing is skipped
    N = 1024
    blk = np.arange(N) // 128
    S = (rng.random((1, N, N)) * (np.abs(blk[:, None] - blk[None]) <= 1)
         ).astype(np.float32)
    g = gso_lib.as_gso(S, "band", device=dev)
    require(g.band_w == 1 and _empty_subchunks(g)[0] == 0,
            "the dense band has sub-chunks without support")
    bwd(f"dense band N={N} w=1 Q=4 F=32", g, 4, 32)
    # attn_bwd_kernel's shared memory, as its launcher computes it: at
    # F = 64 the window fits to w = 90, at w = 2 the features to F = 96
    smem = kernels.library().gnt_attn_bwd_smem_bytes
    for Fs, ws, fits in ((64, 90, True), (64, 91, False), (96, 2, True),
                         (128, 2, False)):
        need = smem(Fs, 2 * ws + 1, 128)
        require((need <= af._BLOCK_SMEM_BYTES) == fits,
                f"attn_bwd_kernel at F={Fs} w={ws} needs {need} bytes of "
                f"shared memory (fits: {fits} expected)")

    # the SpMM Functions: input gradients through the kernels against the
    # plain versions of their backward shifts on the transposed layouts
    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    def input_grad(fn, x, ct):
        x = x.clone().requires_grad_()
        (fn(x) * ct).sum().backward()
        torch.cuda.synchronize()
        return x.grad

    N, gb, gc = N_GRAPH, graph["band"], graph["bcsr"]
    w, sb, sbt = gb.band_w, gb.s_band[0], gb.s_band_t[0]
    layout_t = (gc.blocks_t[0], gc.block_row_t, gc.block_col_t)
    for R in (2048, BATCH):
        x, ct = rand(R, N), rand(R, N)
        check("BandShift", f"dx R={R} N={N} w={w}",
              input_grad(lambda t: spmm.BandShift.apply(t, sb, sbt, N, w),
                         x, ct),
              spmm.band_matmul_plain(ct, sbt, n_cols=N, w=w))
        check("BcsrShift", f"dx R={R} N={N}",
              input_grad(lambda t: spmm.BcsrShift.apply(
                  t, gc.blocks[0], gc.block_row, gc.block_col, *layout_t, N),
                  x, ct),
              spmm.bcsr_matmul_plain(ct, *layout_t, n_cols=N))
    x, ct = rand(BATCH, N), rand(TAPS, BATCH, N)
    want = ct[TAPS - 1]
    for k in range(TAPS - 2, -1, -1):
        want = spmm.band_matmul_plain(want, sbt, n_cols=N, w=w) + ct[k]
    check("BandRegister", f"dx R={BATCH} N={N} K={TAPS}",
          input_grad(lambda t: spmm.BandRegister.apply(t, sb, sbt, TAPS, N,
                                                       w), x, ct), want)
    emit(phase="train_kernels", rtol=RTOL, atol=f"{ATOL_REL}*max|plain|",
         checks=results, seconds=time.perf_counter() - t_phase)
    return errs


def _empty_subchunks(gso):
    """(64-row x 64-column sub-chunks of a band Gso's window tiles inside
    the matrix with no support, all of them inside the matrix): the
    attention backward (attn_bwd_kernel) skips the first."""
    from graph_neural_networks_torch.ops import attention_flash as af
    mr = af.band_auxes(gso)[0].mask_row
    nb, W, ibs, _ = mr.shape
    n = ibs // 64
    occ = mr.view(nb, W, n, 64, n, 64).amax(dim=(3, 5)) > 0
    blk = (np.arange(nb)[:, None] + np.arange(W)[None] - (W - 1) // 2)
    inside = np.broadcast_to(((blk >= 0) & (blk < nb))[..., None, None],
                             occ.shape)
    empty = (~occ.cpu().numpy()) & inside
    return int(empty.sum()), int(inside.sum())


def _peak_gb(fn):
    """(fn(), peak device memory above what was allocated before it, in
    GB)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


def phase_train_timing(gso, dev):
    """bwd_call at the served shape beside its plain version and its
    bound; one flash GAT layer forward + backward beside the materialized
    band layer's, each with its peak memory."""
    import torch
    from graph_neural_networks_torch.ops import attention_band as ab
    from graph_neural_networks_torch.ops import attention_flash as af
    t_phase = time.perf_counter()
    Q, F = GAT_BATCH * GAT_HEADS[0], GAT_DIMS[1]
    ibs, w = gso.block_size, gso.band_w
    nb = gso.s_band.shape[1]
    Np, W = nb * ibs, 2 * w + 1
    aux = af.band_auxes(gso)[0]
    rng = np.random.default_rng(7)
    a1, a2, v = _attn_operands(rng, dev, Q, F, GAT_N, Np)
    ct = _attn_operands(rng, dev, Q, F, GAT_N, Np)[2]
    kw = dict(w=w, ibs=ibs)
    mx, sm = af.stats_plain(a1, a2, aux.mask_row, **kw)
    args = (a1, a2, v, mx, sm, aux.slab_col, aux.mask_row, ct)
    work = _attention_work(gso, Q, F)
    tile = nb * W * ibs * ibs
    # g and v in, dv out; a1, a2, rowmax, rowsum in, da2 out; mask_row and
    # slab_col in; the da1 partials out
    nbytes = 4 * (3 * Q * F * Np + 5 * Q * Np + 2 * tile + Q * nb * W * ibs)
    # per support score: the score and alpha (9), v^T dy (2F), dalpha,
    # delta, de, dpre, da2 and da1 sums, the coefficient (~11), dv (2F)
    flops_per = 4 * F + 20
    row = dict(shape=f"Q={Q} F={F} N={GAT_N} w={w} ibs={ibs} with_s",
               ms=time_ms(lambda: af.bwd_call(*args, **kw)),
               plain_ms=time_ms(lambda: af.bwd_plain(*args, **kw), reps=5,
                                inner=2),
               library_ms=None, bytes=nbytes,
               flops=flops_per * work["support_scores"])
    row["bound_ms"], row["bound_by"] = _attention_bound(
        nbytes, flops_per, work["support_scores"])
    row["bound_ms_dense_tiles"], row["bound_by_dense_tiles"] = (
        _attention_bound(nbytes, flops_per, work["scores"]))

    # one GAT layer (B = 8, G = F = 32, 2 heads) forward + backward
    g = torch.Generator(device="cpu").manual_seed(2)
    x = torch.randn(GAT_BATCH, GAT_DIMS[0], GAT_N, generator=g).to(dev)
    a = (torch.randn(2, 1, 2 * F, generator=g) * .1).to(dev)
    W_p = (torch.randn(2, 1, F, GAT_DIMS[0], generator=g) * .1).to(dev)
    ct_y = torch.randn(GAT_BATCH, 2, F, GAT_N, generator=g).to(dev)
    a.requires_grad_()
    W_p.requires_grad_()
    s5 = af.slab5(gso)

    def step(layer):
        a.grad = W_p.grad = None
        (layer() * ct_y).sum().backward()

    def flash():
        return af.graph_attention_band_flash(x, a, W_p, s5, w,
                                             auxes=af.band_auxes(gso))

    def band():
        return ab.graph_attention_band(x, a, W_p, s5, w)
    layer = dict(
        flash_fwd_bwd_ms=time_ms(lambda: step(flash), reps=10, inner=3),
        flash_fwd_bwd_peak_gb=_peak_gb(lambda: step(flash))[1],
        materialized_fwd_bwd_ms=time_ms(lambda: step(band), reps=5, inner=1),
        materialized_fwd_bwd_peak_gb=_peak_gb(lambda: step(band))[1])
    emit(phase="train_timing", bwd_call=row, scores=work["scores"],
         support_scores=work["support_scores"],
         library="none: no single PyTorch call computes the function",
         gat_layer=layer, seconds=time.perf_counter() - t_phase)
    return {"bwd_call": row}


def _synthetic_data(rng, sizes, features, N, classes):
    """A DataForClassification of seeded Gaussian signals (n, features, N)
    with uniform labels, for train/valid/test `sizes`."""
    from graph_neural_networks_torch.data import DataForClassification
    data = DataForClassification()
    data.nTrain, data.nValid, data.nTest = sizes
    for split, n in zip(("train", "valid", "test"), sizes):
        data.samples[split]["signals"] = rng.standard_normal(
            (n, features, N)).astype(np.float32)
        data.samples[split]["targets"] = rng.integers(0, classes, n)
    return data


def _model(arch, name, out_dir, lr=1e-3):
    from graph_neural_networks_torch import training
    return training.Model(arch, training.losses.cross_entropy_loss,
                          {"name": "ADAM", "lr": lr}, training.Trainer,
                          training.evaluate, name=name, saveDir=out_dir)


def _first_grads(arch, data, batch):
    """Parameter gradients of the CE loss on the Trainer's first batch."""
    import torch
    from graph_neural_networks_torch.training import losses
    idx = np.random.default_rng(0).permutation(data.nTrain)[:batch]
    x, y = data.getSamples("train", idx)
    loss = losses.cross_entropy_loss(
        arch.split_forward(x)[0], torch.as_tensor(y, device=arch.device))
    return loss.item(), torch.autograd.grad(loss, list(arch.parameters()))


@contextlib.contextmanager
def _relu_gates(arch, gates):
    """Within the block each attention layer of `arch` applies its ReLU as
    the product with its gate (pre-activation > 0): recorded into `gates`
    when it comes empty, else taken from it, so that two paths
    differentiate the same linear piece of the network."""
    layers = list(arch.core.filters)
    saved = [layer.nonlinearity for layer in layers]
    record = not gates

    def gate(i):
        def act(t):
            if record:
                gates.append(t > 0)
            return t * gates[i].to(t.dtype)
        return act
    for i, layer in enumerate(layers):
        layer.nonlinearity = gate(i)
    try:
        yield gates
    finally:
        for layer, fn in zip(layers, saved):
            layer.nonlinearity = fn


def _full_width_grads(arch, x, y):
    """Parameter gradients of the CE loss of one batch through the flash
    path, through the materialized band path in f32, and through it in
    f64 (a copy of the model), all three on the flash path's ReLU gates;
    the f32 materialized path's gradients on its own gates; each path's
    peak memory, its loss, and the count of gates on which the
    materialized path's own forward disagrees."""
    import copy

    import torch
    from graph_neural_networks_torch.training import losses

    def grads(model, forward):
        loss = losses.cross_entropy_loss(forward(), y)
        return loss.item(), [g.double() for g in torch.autograd.grad(
            loss, list(model.parameters()))]
    gates, own = [], []
    with _relu_gates(arch, gates):
        flash, peak_flash = _peak_gb(
            lambda: grads(arch, lambda: arch.split_forward(x)[0]))
    with _relu_gates(arch, own):
        _materialized_forward(arch, x)
    flips = sum(int((g != o).sum()) for g, o in zip(gates, own))
    with _relu_gates(arch, gates):
        mat, peak_mat = _peak_gb(lambda: grads(
            arch, lambda: _materialized_forward(arch, x, grad=True)[0]))
    own_gates = grads(arch, lambda: _materialized_forward(arch, x,
                                                          grad=True)[0])
    a64 = copy.deepcopy(arch)
    a64.core.double()
    a64.S.s_band = a64.S.s_band.double()
    with _relu_gates(a64, gates):
        ref = grads(a64, lambda: _materialized_forward(
            a64, x.double(), grad=True)[0])
    del a64
    torch.cuda.empty_cache()
    return dict(flash=flash, materialized=mat, f64=ref,
                materialized_own_gates=own_gates,
                peak_gb=dict(flash=peak_flash, materialized=peak_mat),
                gate_flips=flips, gates=sum(g.numel() for g in gates))


def _check_full_width(checks, model, flash, mat, ref, own):
    """Flash gradients against the f64 reference (see ILL_COND_FACTOR);
    `own` (the materialized path on its own gates) only shows what the
    flipped gates move."""
    for i, (g, m, r, o) in enumerate(zip(flash, mat, ref, own)):
        max_abs, max_rel, ok = compare(g, r, TRAIN_RTOL, TRAIN_ATOL_REL)
        mat_abs, _, mat_ok = compare(m, r, TRAIN_RTOL, TRAIN_ATOL_REL)
        by = "tolerance" if ok else "ill_conditioned"
        if not ok:
            ok = not mat_ok and max_abs <= ILL_COND_FACTOR * mat_abs
        checks.append(dict(model=model, against="materialized band f64",
                           param=i, max_abs_err=max_abs, max_rel_err=max_rel,
                           materialized_f32_max_abs_err=mat_abs,
                           own_gates_moved=(o - m).abs().max().item(),
                           max_abs_ref=r.abs().max().item(), ok=ok,
                           passed_by=by))
        require(ok, f"{model}: gradient of parameter {i} is {max_abs} from "
                    f"the f64 reference (the f32 materialized path "
                    f"{mat_abs})")


def _check_grads(checks, model, against, got, want):
    for i, (g, r) in enumerate(zip(got, want)):
        max_abs, max_rel, ok = compare(g, r, TRAIN_RTOL, TRAIN_ATOL_REL)
        checks.append(dict(model=model, against=against, param=i,
                           max_abs_err=max_abs, max_rel_err=max_rel,
                           max_abs_ref=r.abs().max().item(), ok=ok))
        require(ok, f"{model}: gradient of parameter {i} disagrees with "
                    f"{against}: {max_abs}")


@contextlib.contextmanager
def _cached_structure(what, lists=0):
    """Fail if the calls inside build graph structure that is built once
    and cached: a BCSR shift computing its segment offsets
    (``spmm.bcsr_col_start``, two launches on the card) instead of taking
    the Gso's, or more than `lists` builds of the flash apply's entry lists
    (``attention_flash.support_lists``, a nonzero with its host sync and
    some ten launches; a band Gso builds its own once, at first use)."""
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.ops import spmm
    calls = {"bcsr_col_start": [], "support_lists": []}
    origs = {"bcsr_col_start": (spmm, spmm.bcsr_col_start),
             "support_lists": (af, af.support_lists)}

    def counted(name):
        mod, orig = origs[name]

        def fn(*a, **kw):
            calls[name].append(1)
            return orig(*a, **kw)
        return fn
    for name, (mod, _) in origs.items():
        setattr(mod, name, counted(name))
    try:
        yield
    finally:
        for name, (mod, orig) in origs.items():
            setattr(mod, name, orig)
    require(not calls["bcsr_col_start"],
            f"{what}: {len(calls['bcsr_col_start'])} BCSR segment offsets "
            "computed per call, not taken from the Gso")
    require(len(calls["support_lists"]) <= lists,
            f"{what}: {len(calls['support_lists'])} builds of the apply "
            f"kernel's entry lists, expected at most {lists}")


def _train_counts(model, data, batch, expected=None, **trainer_kw):
    """Model.train for TRAIN_STEPS steps (validation at step 0 only; more
    Trainer options in trainer_kw), the counts set to 0 just before and
    read just after; then the losses."""
    import torch
    _reset_counts()
    t0 = time.perf_counter()
    with _cached_structure(model.name):
        out = model.train(data, nEpochs=1, batchSize=batch,
                          validationInterval=TRAIN_STEPS, **trainer_kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _attention_counts()
    losses = out["lossTrain"]
    require(len(losses) == TRAIN_STEPS and bool(np.isfinite(losses).all()),
            f"{model.name}: losses {losses}")
    if expected is not None:
        require(counts == expected, f"{model.name}: launches {counts}, "
                                    f"expected {expected}")
    return out, counts, seconds


def _vs_dense(label, build, modes, data, batch, checks, out_dir,
              expected=None):
    """First-step gradients and TRAIN_STEPS Adam steps of loss in each
    kernel mode against dense mode, the same weights on the card."""
    dense = build("dense")
    _, want = _first_grads(dense, data, batch)
    ref, _, _ = _train_counts(_model(dense, f"{label}_dense", out_dir),
                              data, batch)
    trained, launches = {}, {}
    for mode in modes:
        arch = build(mode)
        _, got = _first_grads(arch, data, batch)
        _check_grads(checks, f"{label} {mode}", "dense", got, want)
        model = _model(arch, f"{label}_{mode}", out_dir)
        out, counts, seconds = _train_counts(
            model, data, batch, None if expected is None else expected[mode])
        if expected is None:
            require(counts["bwd_call"] > 0, f"{label} {mode}: no bwd_call")
        ok = bool(np.allclose(out["lossTrain"], ref["lossTrain"],
                              rtol=LOSS_RTOL, atol=0))
        checks.append(dict(model=f"{label} {mode}", against="dense",
                           losses=out["lossTrain"].tolist(),
                           dense_losses=ref["lossTrain"].tolist(), ok=ok,
                           launches=counts, seconds=seconds))
        require(ok, f"{label} {mode}: losses {out['lossTrain']} vs dense "
                    f"{ref['lossTrain']}")
        trained[mode] = (model, data, batch)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    return trained, launches


def phase_training(eng, S_np, rng, dev, out_dir):
    """The training path: full-width gradients of gat_band_n16384 against
    the materialized band path, Model.train + evaluate on it with its
    launch counts, then band_n4096 (band, bcsr) and the three attention
    models at N = 2048 against dense mode."""
    import torch
    t_phase = time.perf_counter()
    arch = eng.arch
    checks = []

    # full-width gradients of one step: flash against the materialized
    # band path, on the flash path's ReLU gates
    x = torch.as_tensor(rng.standard_normal(
        (GAT_BATCH, GAT_DIMS[0], GAT_N)).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.integers(0, 4, GAT_BATCH), device=dev)
    fw = _full_width_grads(arch, x, y)
    _check_full_width(checks, "gat_band_n16384", fw["flash"][1],
                      fw["materialized"][1], fw["f64"][1],
                      fw["materialized_own_gates"][1])
    emit(phase="training_grads", model="gat_band_n16384",
         loss=fw["flash"][0], materialized_loss=fw["materialized"][0],
         f64_loss=fw["f64"][0], peak_gb=fw["peak_gb"],
         relu_gates=fw["gates"],
         gates_flipped_by_materialized_f32=fw["gate_flips"],
         rtol=TRAIN_RTOL, atol=f"{TRAIN_ATOL_REL}*max|reference|",
         ill_conditioned_factor=ILL_COND_FACTOR, checks=checks)
    del fw

    # the main path: Model.train + evaluate on gat_band_n16384
    data = _synthetic_data(rng, (TRAIN_STEPS * GAT_BATCH, GAT_BATCH,
                                 GAT_BATCH), GAT_DIMS[0], GAT_N, 4)
    model = _model(arch, "gat_band_n16384", out_dir)
    _reset_counts()
    t0 = time.perf_counter()
    with _cached_structure("gat_band_n16384 training"):
        out = model.train(data, nEpochs=1, batchSize=GAT_BATCH,
                          validationInterval=4)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _attention_counts()
    n_val = len(out["costValid"])
    expected = {k: 0 for k in counts}
    expected.update(stats_call=(TRAIN_STEPS + n_val) * 2,
                    apply_call=(TRAIN_STEPS + n_val) * 2,
                    bwd_call=TRAIN_STEPS * 2)
    require(n_val == 2 and counts == expected,
            f"gat_band_n16384: {n_val} validations, launches {counts}, "
            f"expected {expected}")
    require(bool(np.isfinite(out["lossTrain"]).all())
            and len(out["lossTrain"]) == TRAIN_STEPS,
            f"gat_band_n16384: losses {out['lossTrain']}")
    result = model.evaluate(data, doSaveVars=False)
    require(all(r is not None and 0 <= r <= 1 for r in result.values()),
            f"gat_band_n16384: evaluate {result}")
    launches = dict(counts)
    emit(phase="training", model="gat_band_n16384", steps=TRAIN_STEPS,
         batch=GAT_BATCH, losses=out["lossTrain"].tolist(),
         cost_valid=out["costValid"].tolist(), evaluate=result,
         seconds=seconds, step_ms=(np.asarray(out["timeTrain"]) *
                                   1e3).tolist(),
         launches=counts, launches_per_step=dict(stats_call=2, apply_call=2,
                                                 bwd_call=2),
         validation_forwards=n_val)
    trained = {"gat_band_n16384": (model, data, GAT_BATCH)}

    # band_n4096, band and bcsr mode, against dense mode
    checks = []
    data = _synthetic_data(rng, (TRAIN_STEPS * BATCH, BATCH, BATCH), 1,
                           N_GRAPH, 5)

    def per(step, val):   # TRAIN_STEPS steps + one validation forward
        counts = {k: 0 for k in _attention_counts()}
        counts.update({k: TRAIN_STEPS * n + val.get(k, 0)
                       for k, n in step.items()})
        return counts
    expected = {
        "band": per(_band_launches(step=True), _band_launches(step=False)),
        "bcsr": per({"bcsr_matmul": 12}, {"bcsr_matmul": 8})}
    sel, sel_launches = _vs_dense(
        "band_n4096", lambda m: _build_model(S_np, m, dev), ("band", "bcsr"),
        data, BATCH, checks, out_dir, expected)
    for mode, entry in sel.items():
        trained[f"band_n4096 {mode}"] = entry
    for k, n in sel_launches.items():
        launches[k] += n

    # GAT, GCAT and EdgeVariantAttention at N = 2048, against dense mode
    S2, _ = make_graph(GAT_SMALL_N, 0.01, 256, seed=1)
    small = [("GraphAttentionNetwork", GAT_DIMS, GAT_HEADS, None),
             ("GraphConvolutionAttentionNetwork", [64, 16, 16], [2, 2],
              [3, 2]),
             ("EdgeVariantAttention", [32, 16], [2], [3])]
    for cls_name, dims, heads, taps in small:
        data = _synthetic_data(rng, (TRAIN_STEPS * GAT_BATCH, GAT_BATCH,
                                     GAT_BATCH), dims[0], GAT_SMALL_N, 4)
        _vs_dense(f"{cls_name} N={GAT_SMALL_N}",
                  lambda m: _build_gat(cls_name, S2, m, dev, dims, heads,
                                       taps),
                  ("band",), data, GAT_BATCH, checks, out_dir)
    emit(phase="training_check", rtol=TRAIN_RTOL,
         atol=f"{TRAIN_ATOL_REL}*max|dense|", loss_rtol=LOSS_RTOL,
         checks=checks, seconds=time.perf_counter() - t_phase)
    return launches, trained


def _device_profile(fn, n):
    """Host ms per call of `fn` (no profiler, synchronized), device ms per
    call and the top device kernels from torch.profiler over `n` calls,
    and the device's idle share of those profiled calls' host time (the
    same window: the unprofiled calls' time can be shorter than the
    device time of the profiled ones)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) / n * 1e3
    # kernel rows only: an operator's row, or a user annotation's such as
    # "Optimizer.step#Adam.step", repeats its kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / n / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return dict(
        wall_ms=wall_ms, profiled_wall_ms=profiled_ms,
        device_ms=device_ms if events else "not measured",
        device_idle_share=(1 - device_ms / profiled_ms) if events
        else "not measured",
        top=[dict(name=e.key[:80], ms=e.self_device_time_total / n / 1e3,
                  calls=e.count / n) for e in top])


def phase_train_profile(trained, n=6, phase="train_profile"):
    """Where one training step (forward, loss, backward, Adam) spends its
    time, for each trained model of a training phase."""
    from graph_neural_networks_torch import training
    for name, (model, data, batch) in trained.items():
        trainer = training.Trainer(model, data, 1, batch)
        batches = [np.arange(i * batch, (i + 1) * batch) % data.nTrain
                   for i in range(n + 3)]
        it = iter(batches * 3)
        prof = _device_profile(lambda: trainer.train_batch(next(it)), n)
        emit(phase=phase, model=name, batch=batch,
             host_ms_per_step=prof["wall_ms"],
             profiled_host_ms_per_step=prof["profiled_wall_ms"],
             device_ms_per_step=prof["device_ms"],
             device_idle_share=prof["device_idle_share"],
             top=[dict(name=t["name"], ms_per_step=t["ms"],
                       calls_per_step=t["calls"]) for t in prof["top"]])


# ---------------------------------------------------------------------------
# Flocking path (cell-grid environment kernels)
# ---------------------------------------------------------------------------

# flock_n262k: bench.py:284-318 (the JAX package's flagship closed loop):
# LocalGNN_DB([6,32], [4], True, "tanh", [2], 1), N = 262144, one sample,
# circular initial geometry from default_rng(0); flock_n4096: the
# deployment of examples/largeswarm.py:84-90, 184-217 (LocalGNN_DB([6,64],
# [3]), N = 4096, 2 samples, default_rng(1)). Both: commRadius 2, repelDist
# 1, samplingTime 0.01, env_grid=True (side-2r cells, C = 32, 4 windows),
# ell_degree 32, lam_iters 0. Random weights from a torch seed: the JAX
# init cannot run here (the CPU tests carry JAX weights across).
FLOCK = {
    "flock_n262k": dict(N=262144, B=1, seed=0, dims=[6, 32], taps=[4],
                        wseed=1),
    "flock_n4096": dict(N=4096, B=2, seed=1, dims=[6, 64], taps=[3],
                        wseed=2),
}
FLOCK_D = 32
FLOCK_T_EVAL = 100     # 1 s at dt = 0.01, as examples/largeswarm.py deploys
FLOCK_T_TRAIN = 25     # bench.py's long chain
# The grid kernels' plain versions do the same IEEE operations and sum in
# the kernels' order (gridwin._warp_sum), so kernel and plain outputs, and
# whole rollouts on either, are held equal bit for bit.


def _flock_setup(name, dev):
    """(env, initPos, initVel, policy) of a flocking configuration."""
    import torch
    from graph_neural_networks_torch.data.flocking import Flocking
    from graph_neural_networks_torch.models.architectures_time import (
        LocalGNN_DB)
    c = FLOCK[name]
    env = Flocking.for_rollout(c["N"], commRadius=2.0, repelDist=1.0,
                               samplingTime=0.01,
                               rng=np.random.default_rng(c["seed"]),
                               device=dev)
    ip, iv = env.compute_initial_positions(
        c["N"], c["B"], env.commRadius, minDist=env.initMinDist,
        geometry="circular", xMaxInitVel=3.0, yMaxInitVel=3.0)
    net = LocalGNN_DB(c["dims"], c["taps"], True, "tanh", [2], 1, device=dev,
                      generator=torch.Generator().manual_seed(c["wseed"]))
    return env, ip, iv, net


def _flock_counts():
    from graph_neural_networks_torch.ops import gridwin
    return {fn.__name__: fn.launches for fn in gridwin.KERNEL_WRAPPERS}


@contextlib.contextmanager
def _plain_gridwin():
    """The grid env with the kernels' plain versions in their place (the
    smoke's own substitution; the package has no switch)."""
    from graph_neural_networks_torch.ops import gridwin
    saved = {fn.__name__: fn for fn in gridwin.KERNEL_WRAPPERS}
    for name in saved:
        setattr(gridwin, name, getattr(gridwin, name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(gridwin, name, fn)


def _grid_inputs(pos, vel, factor, C, table_size=None, v=None, pay=None,
                 builder="fused"):
    """A grid table and the window operands of every agent: (table
    (B*H, W), own, slots, keep, H, W, ok)."""
    from graph_neural_networks_torch.data import flocking as fl
    B, _, N = pos.shape
    H, Gx, Gy, C = fl._grid_geometry(N, table_size, C, factor)
    inv_s = 1.0 / (factor * 2.0)
    px, py, vx, vy = pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1]
    rows, cx, cy, ok, _ = fl._grid_build_table(
        px, py, vx, vy, inv_s, H, Gx, Gy, C, v=v, pay=pay, builder=builder)
    own, slots, keep = fl._window_operands(px, py, vx, vy, cx, cy, H, Gx,
                                           Gy, inv_s, factor)
    W = rows.shape[-1]
    return rows.view(B * H, W), own, slots, keep, H, W, bool(ok.all())


def _window_work(table, own, slots, keep, out, *, C, n_feat, d_max):
    """What grid_window must do on this run's data, as a dict with bytes
    and flops. Bytes: own, slots and keep read once, the output written
    once, and of the table only what the kept windows reach: each touched
    row's C valid lanes and its members' other n_feat - 1 lanes (an empty
    slot needs only its valid lane; a row that no agent keeps, nothing).
    Flops: 8 a valid candidate (the distance and the mask), and a
    neighbour's 17 state operations and one add a payload feature."""
    nbytes = lambda t: t.numel() * t.element_size()
    members = (table[:, 4 * C:5 * C] > 0).sum(dim=1)   # valid lanes a row
    touched = slots[keep].long().unique()
    n_members = int(members[touched].sum())
    table_bytes = 4 * (touched.numel() * C + n_members * (n_feat - 1))
    candidates = int((members[slots.long()] * keep).sum())
    neighbours = int(out[:, 2 * d_max + 7].sum())
    return dict(bytes=nbytes(own) + nbytes(slots) + nbytes(keep)
                + nbytes(out) + table_bytes,
                table_bytes=table_bytes, touched_rows=touched.numel(),
                touched_members=n_members, candidates=candidates,
                neighbours=neighbours,
                flops=8 * candidates + (17 + n_feat - 7) * neighbours)


def _cell_starts(pos):
    """(starts (1, H+1) int32, H): the run starts of the agents' cells in
    the quad scheme's table (one sample), as table_build takes them."""
    import torch
    from graph_neural_networks_torch.data import flocking as fl
    N = pos.shape[-1]
    H, Gx, Gy, _ = fl._grid_geometry(N, None, 32, 2)
    cell = lambda x: torch.floor(x * 0.25).to(torch.int32)
    h = fl._grid_hash(cell(pos[0, 0]), cell(pos[0, 1]), Gx, Gy)
    starts = torch.zeros(1, H + 1, dtype=torch.int32, device=pos.device)
    starts[0, 1:] = torch.cumsum(torch.bincount(h.long(), minlength=H), 0)
    return starts, H


def _edge_swarm(rng, n, extent, dev):
    """n agents uniform in [-extent, extent]^2, a 6 x 6 cluster of spacing
    0.25 on the cell corner (4, 4) (35+ neighbors each, more than d_max),
    and two pairs at exactly d^2 = r^2; (1, 2, n + 40) positions and
    velocities."""
    import torch
    g = 0.25 * np.arange(6) - 0.625
    gx, gy = np.meshgrid(g, g)
    pos = np.concatenate(
        [rng.uniform(-extent, extent, (2, n)),
         np.array([[0.5, 0.5], [0.5, 2.5], [-3.0, 1.0], [-1.0, 1.0]]).T,
         np.stack([4.0 + gx.ravel(), 4.0 + gy.ravel()])], axis=1)
    vel = rng.normal(size=pos.shape)
    as_t = lambda a: torch.as_tensor(a[None].astype(np.float32), device=dev)
    return as_t(pos), as_t(vel)


def phase_flock_kernels(rng, dev):
    """grid_window, table_build and table_transpose against their plain
    versions on the card, bit for bit: at the served shapes of flock_n262k
    and at edge cases."""
    import torch
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    results, errs = [], {}

    def check_window(case, args, d_max, n_pay, wv_only=False, r2=4.0,
                     C=32):
        kw = dict(C=C, r2=r2, d_max=d_max, wv_only=wv_only, n_pay=n_pay)
        got = gridwin.grid_window(*args, **kw)
        want = gridwin.grid_window_plain(*args, **kw)
        same = bool(torch.equal(got, want))
        max_abs = (got - want).abs().max().item()
        results.append(dict(kernel="grid_window", case=case, equal=same,
                            max_abs_err=max_abs))
        errs.setdefault("grid_window", max_abs)
        require(same, f"grid_window [{case}] differs from its plain version "
                      f"(max abs {max_abs})")
        return got

    def check_table(name, case, got, want):
        same = bool(torch.equal(got, want))
        results.append(dict(kernel=name, case=case, equal=same))
        errs.setdefault(name, 0.0 if same else float("nan"))
        require(same, f"{name} [{case}] differs from its plain version")

    # served shapes: flock_n262k's initial swarm, payload P = 18
    env, ip, iv, _ = _flock_setup("flock_n262k", dev)
    pos = torch.as_tensor(ip, dtype=torch.float32, device=dev)
    vel = torch.as_tensor(iv, dtype=torch.float32, device=dev)
    N = pos.shape[-1]
    g = torch.Generator(device="cpu").manual_seed(3)
    v = torch.rand(1, N, generator=g).to(dev)
    pay = torch.randn(1, N, 18, generator=g).to(dev)
    tables = {}
    for builder in ("scatter", "gather", "fused"):
        tables[builder] = _grid_inputs(pos, vel, 2, 32, v=v, pay=pay,
                                       builder=builder)
        require(tables[builder][-1], f"262k {builder} table overflowed")
    for builder in ("gather", "fused"):
        same = bool(torch.equal(tables[builder][0], tables["scatter"][0]))
        results.append(dict(kernel="table_build" if builder == "fused"
                             else "table_transpose",
                             case=f"262k {builder} build == scatter build",
                             equal=same))
        require(same, f"262k {builder} table differs from the scatter table")
    table, own, slots, keep, H, W, _ = tables["fused"]
    args = (table, own, slots, keep)
    check_window("262k eval: d_max=0 n_pay=18", args, 0, 18)
    check_window("262k train: d_max=32 n_pay=18", args, 32, 18)
    check_window("262k lambda pass: wv_only", args, 0, 0, wv_only=True)
    check_window("262k n_pay=12 d_max=32", args, 32, 12)
    init_args = _grid_inputs(pos, vel, 2, 32, v=v)[:4]   # P = 0, W = 256
    check_window("262k init step: d_max=32 n_pay=0", init_args, 32, 0)

    # table_build and table_transpose at the served shape (F = 25)
    starts, Hh = _cell_starts(pos)
    fs = torch.randn(1, N, 25, generator=g).to(dev)
    check_table("table_build", "262k F=25", gridwin.table_build(
        fs, starts, C=32), gridwin.table_build_plain(fs, starts, C=32))
    mm = torch.randn(Hh * 32, 25, generator=g).to(dev)
    check_table("table_transpose", "262k F=25 (H*C, 25)",
                gridwin.table_transpose(mm, C=32, F=25),
                gridwin.table_transpose_plain(mm, C=32, F=25))
    mm128 = torch.randn(4096 * 16, 128, generator=g).to(dev)
    check_table("table_transpose", "H=4096 C=16 F=7 L=128 (pad lanes)",
                gridwin.table_transpose(mm128, C=16, F=7),
                gridwin.table_transpose_plain(mm128, C=16, F=7))

    # table_transpose edge cases: H not a multiple of the run (8 cells at
    # C = 32, F = 25), one cell, one feature, C = 16 with L = 7, an odd C
    # (the last run's span ends in 4-byte copies), an even F (restaged at
    # an odd stride), a misaligned mm (both element-wise)
    for H_, C_, F_ in ((1003, 32, 25), (1, 32, 25), (4099, 32, 1),
                       (4099, 16, 7), (513, 3, 5), (999, 32, 8)):
        mm_e = torch.randn(H_ * C_, F_, generator=g).to(dev)
        check_table("table_transpose", f"H={H_} C={C_} F=L={F_}",
                    gridwin.table_transpose(mm_e, C=C_, F=F_),
                    gridwin.table_transpose_plain(mm_e, C=C_, F=F_))
    flat = torch.randn(1003 * 32 * 25 + 1, generator=g).to(dev)
    mm_m = flat[1:].view(1003 * 32, 25)
    require(dev.type != "cuda" or mm_m.data_ptr() % 16 != 0,
            "misaligned case is aligned")
    check_table("table_transpose", "H=1003 C=32 F=L=25, mm 4 B past 16 B",
                gridwin.table_transpose(mm_m, C=32, F=25),
                gridwin.table_transpose_plain(mm_m, C=32, F=25))

    # edge cases: both schemes, > d_max neighbors, d^2 = r^2 pairs, empty
    # cells, aliased windows, the exp test, an overflowing cell; 8 + n_pay
    # output sums at, one past and 33 past a warp's 32 lanes (each lane
    # adds up one sum); 397 + 40 agents, so the last block of 4 warps is
    # partial
    epos, evel = _edge_swarm(rng, 397, 12.0, dev)
    n_e = epos.shape[-1]
    require(n_e % 4 != 0, "the edge swarm fills its last block")
    ev = torch.rand(1, n_e, generator=g).to(dev)
    for factor, C in ((2, 32), (1, 16)):
        for n_pay in (0, 12, 18, 24, 25, 57):
            epay = torch.randn(1, n_e, n_pay, generator=g).to(dev)
            ea = _grid_inputs(epos, evel, factor, C, v=ev,
                              pay=epay if n_pay else None)
            require(ea[-1], f"edge swarm overflowed (factor {factor})")
            for d_max in (0, 32):
                out = check_window(f"factor={factor} C={C} n_pay={n_pay} "
                                   f"d_max={d_max} R={n_e}", ea[:4], d_max,
                                   n_pay, C=C)
            cnt = out[:, 2 * 32 + 7]
            require(cnt.max().item() > 32, "no row with > d_max neighbors")
            # both boundary pairs (the 4 agents after the uniform ones)
            # see each other
            ids = out[:, :32]
            for a, b in ((n_e - 40, n_e - 39), (n_e - 38, n_e - 37)):
                require(bool((ids[a] == b).any() and (ids[b] == a).any()),
                        f"d^2 = r^2 pair {a}, {b} not neighbors")
        check_window(f"factor={factor} wv_only", ea[:4], 0, 0, wv_only=True,
                     C=C)
    for factor, C, ts in ((1, 64, 4), (2, 128, 2)):
        ea = _grid_inputs(epos[..., :200] / 4, evel[..., :200], factor, C,
                          table_size=ts, v=ev[:, :200])
        require(not bool(ea[3].all()), "no aliased window")
        check_window(f"aliased windows: factor={factor} table={ts}", ea[:4],
                     32, 0, C=C)
    ea = _grid_inputs(epos[..., :200] / 3, evel[..., :200], 2, 128,
                      table_size=4, v=ev[:, :200])
    check_window("r2=25 (exp test on)", ea[:4], 32, 0, r2=25.0, C=128)
    # an overflowing cell (the 6 x 6 cluster puts 9 agents in each of its
    # 4 cells, above C = 8): the table keeps the first C of each
    ea = _grid_inputs(epos, evel, 1, 8, v=ev)
    require(not ea[-1], "the cluster's cells did not overflow C = 8")
    check_window("overflowing cells: factor=1 C=8", ea[:4], 32, 0, C=8)
    # an overflowing cell: the first C sorted members stay
    counts = torch.tensor([[40, 0, 7, 33, 1, 0, 0, 19]], dtype=torch.int32)
    st = torch.zeros(1, 9, dtype=torch.int32)
    st[0, 1:] = torch.cumsum(counts[0], 0)
    fs_o = torch.randn(1, int(st[0, -1]), 9, generator=g).to(dev)
    st = st.to(dev)
    check_table("table_build", "overflowing runs (40, 33 > C=32)",
                gridwin.table_build(fs_o, st, C=32),
                gridwin.table_build_plain(fs_o, st, C=32))
    tb = gridwin.table_build(fs_o, st, C=32)
    require(bool(torch.equal(tb[0, 0, :32], fs_o[0, :32, 0])),
            "table_build overflow did not keep the first C members")

    if dev.type == "cuda":
        torch.cuda.synchronize()
    emit(phase="flock_kernels", checks=results,
         seconds=time.perf_counter() - t_phase)
    return errs


def phase_flock_env(dev):
    """One grid env step of flock_n4096 (2 samples, payload P = 12) on the
    kernels against the dense all-pairs reference: the neighbor sets as
    0/1 matrices, the states, the payload shift against W @ payload, and
    lambda against the same Rayleigh fold on the dense W; once with the
    fused build and once with the gather build (table_transpose), which
    must agree bit for bit."""
    import torch
    from graph_neural_networks_torch.data import flocking as fl
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    env, ip, iv, _ = _flock_setup("flock_n4096", dev)
    pos = torch.as_tensor(ip, dtype=torch.float32, device=dev)
    vel = torch.as_tensor(iv, dtype=torch.float32, device=dev)
    B, _, N = pos.shape
    g = torch.Generator(device="cpu").manual_seed(4)
    v0 = (torch.rand(B, N, generator=g) + 0.5).to(dev)
    pay = torch.randn(B, N, 12, generator=g).to(dev)
    gridwin.reset_launch_counts()
    outs = {b: fl.env_step_grid(pos, vel, 2.0, FLOCK_D, v0, lam_iters=0,
                                cell_cap=32, cell_factor=2, payload=pay,
                                builder=b) for b in ("fused", "gather")}
    counts = _flock_counts()
    expected = dict(grid_window=2, table_build=1, table_transpose=1)
    require(counts == expected, f"flock_env launches {counts}, expected "
                                f"{expected}")
    for a, b in zip(outs["fused"], outs["gather"]):
        require(bool(torch.equal(a, b)), "gather-built step differs from "
                                         "the fused-built step")
    idx, val, st, v, sh, ok = outs["fused"]
    require(bool(ok), "flock_n4096 step: cell overflow or in-degree > d_max")
    W = (fl.comm_graph(pos, 2.0, "power") > 0).float()
    lam_ref = (torch.einsum("bn,bnm,bm->b", v0, W, v0)
               / (v0 * v0).sum(-1))
    lam = 1.0 / val.amax(dim=(1, 2))
    Sg = torch.zeros_like(W)
    Sg.scatter_add_(2, idx.long(), (val > 0).float())
    same_sets = bool(torch.equal(Sg, W))
    require(same_sets, "grid neighbor sets differ from the dense graph")
    checks = {}
    for name, got, want, axis in (
            ("states", st, fl.states(pos, vel, W), 1),
            ("shift", sh, torch.einsum("bmn,bnp->bmp", W, pay)
             / lam_ref[:, None, None], 2),
            ("v", v, torch.einsum("bnm,bn->bm", W, v0), None),
            ("lambda", lam, lam_ref, None)):
        if name == "v":
            want = want / want.norm(dim=-1, keepdim=True)
        got, want = got.double(), want.double()
        dims = tuple(i for i in range(want.dim()) if i != axis)
        scale = (want.abs().amax(dim=dims, keepdim=True) if axis is not None
                 else want.abs().max())
        err = (got - want).abs()
        ok_c = bool((err <= 1e-4 * want.abs() + 1e-5 * scale).all())
        checks[name] = dict(max_abs_err=err.max().item(), ok=ok_c)
        require(ok_c, f"flock_env {name} disagrees with the dense step: "
                      f"{checks[name]}")
    emit(phase="flock_env", config="flock_n4096", B=B, N=N,
         edges=int(W.sum().item()), max_in_degree=int(W.sum(1).max().item()),
         neighbor_sets_equal=same_sets, lam=lam.tolist(),
         lam_dense=lam_ref.tolist(), checks=checks, launches=counts,
         rtol=1e-4, atol="1e-5*max|dense| (per state channel)",
         seconds=time.perf_counter() - t_phase)
    return counts


def _rollout_compare(label, got, want):
    """Kernel and plain rollouts' arrays must be equal bit for bit."""
    import torch
    out = {}
    for name, a, b in zip(("pos", "vel", "accel", "states"), got, want):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        out[name] = dict(max_abs_err=(a - b).abs().max().item(),
                         equal=bool(torch.equal(a, b)))
        require(out[name]["equal"], f"{label}: kernel and plain rollouts "
                                    f"differ in {name}: {out[name]}")
    return out


def phase_flock_serving(dev, card):
    """The closed loop through Flocking's entry points on the kernels:
    flock_n262k eval-shaped (rollout_cost, rollout_traj_device; T = 100)
    and train-shaped (compute_trajectory with its ELL graphs; T = 25), and
    flock_n4096 (rollout_cost; T = 100); each against the same rollout
    with the plain versions substituted, ok true, exact launch counts."""
    import torch
    from graph_neural_networks_torch.data import flocking as fl
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    kw = dict(ell_degree=FLOCK_D, env_grid=True, lam_iters=0,
              env_grid_strict=True)
    launches = dict(grid_window=0, table_build=0, table_transpose=0)

    def run(label, fn, T, n_steps_b, expect):
        gridwin.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _flock_counts()
        require(counts == expect, f"{label}: launches {counts}, expected "
                                  f"{expect}")
        for k, n in counts.items():
            launches[k] += n
        with _plain_gridwin():
            t0 = time.perf_counter()
            plain = fn()
            torch.cuda.synchronize()
            plain_seconds = time.perf_counter() - t0
        return out, plain, dict(
            config=label, T=T, seconds=seconds, plain_seconds=plain_seconds,
            agent_steps_per_s=n_steps_b * (T - 1) / seconds, launches=counts)

    def expect(T):
        # 1 table build a step; the first step's window pass + 32 cold-start
        # lambda passes (lam_iters 0 -> max(0, 32)), then one pass a step
        return dict(grid_window=33 + (T - 1), table_build=T,
                    table_transpose=0)

    rows = []
    env, ip, iv, net = _flock_setup("flock_n262k", dev)
    N = FLOCK["flock_n262k"]["N"]
    dur = FLOCK_T_EVAL * env.samplingTime
    (cf, ce), (pcf, pce), row = run(
        "flock_n262k eval rollout_cost", lambda: env.rollout_cost(
            ip, iv, dur, net, **kw), FLOCK_T_EVAL, N, expect(FLOCK_T_EVAL))
    require(np.isfinite(cf) and np.isfinite(ce), "non-finite cost")
    require((cf, ce) == (pcf, pce), f"262k cost {cf}, {ce} vs plain "
                                    f"{pcf}, {pce}")
    rows.append(dict(row, cost_full=cf, cost_end=ce, plain_cost_full=pcf,
                     plain_cost_end=pce))
    (pos, vel), (ppos, pvel), row = run(
        "flock_n262k eval rollout_traj_device", lambda:
        env.rollout_traj_device(ip, iv, dur, net, **kw), FLOCK_T_EVAL, N,
        expect(FLOCK_T_EVAL))
    require(tuple(pos.shape) == (1, FLOCK_T_EVAL, 2, N)
            and bool(torch.isfinite(pos).all()), "262k trajectory")
    cost_dev = float(fl.evaluate_cost_device(vel))
    require(abs(cost_dev - cf) <= 1e-5 * abs(cf),
            f"trajectory cost {cost_dev} vs rollout_cost {cf}")
    rows.append(dict(row, cost_of_trajectory=cost_dev,
                     vs_plain=_rollout_compare("262k traj", (pos, vel),
                                               (ppos, pvel))))
    del pos, vel, ppos, pvel
    dur_t = FLOCK_T_TRAIN * env.samplingTime
    got, want, row = run(
        "flock_n262k train compute_trajectory", lambda:
        env.compute_trajectory(ip, iv, dur_t, net, return_graphs=True, **kw),
        FLOCK_T_TRAIN, N, expect(FLOCK_T_TRAIN))
    g, w = got[4], want[4]
    require(g.idx.shape == (1, FLOCK_T_TRAIN, N, FLOCK_D)
            and g.val.dtype == np.float64, f"graphs {g.idx.shape}")
    require(np.array_equal(g.idx, w.idx) and np.array_equal(g.val, w.val),
            "262k graph trajectory differs between kernel and plain")
    rows.append(dict(row, edges=int((g.val > 0).sum()),
                     max_in_degree=int((g.val > 0).sum(-1).max()),
                     vs_plain=_rollout_compare("262k compute_trajectory",
                                               got[:4], want[:4])))
    del got, want, g, w
    env4, ip4, iv4, net4 = _flock_setup("flock_n4096", dev)
    c4 = FLOCK["flock_n4096"]
    (cf4, ce4), (pcf4, pce4), row = run(
        "flock_n4096 eval rollout_cost", lambda: env4.rollout_cost(
            ip4, iv4, dur, net4, **kw), FLOCK_T_EVAL, c4["N"] * c4["B"],
        expect(FLOCK_T_EVAL))
    require((cf4, ce4) == (pcf4, pce4), f"4096 cost {cf4}, {ce4} vs plain "
                                        f"{pcf4}, {pce4}")
    rows.append(dict(row, cost_full=cf4, cost_end=ce4, plain_cost_full=pcf4,
                     plain_cost_end=pce4))
    emit(phase="flock_serving", nvidia_smi=card, rows=rows,
         launches=launches, seconds=time.perf_counter() - t_phase)
    return launches, (env, ip, iv, net)


def phase_flock_timing(dev, card):
    """Each grid kernel at flock_n262k's served shape beside its plain
    version and its bound (bytes: each operand read once and the output
    written once; grid_window's table counted as far as this run's windows
    reach it, `_window_work`, and `bound_ms_rows` counting its agents'
    n_win whole table rows instead); the one-expression torch relayout as
    table_transpose's library call."""
    import torch
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    env, ip, iv, _ = _flock_setup("flock_n262k", dev)
    pos = torch.as_tensor(ip, dtype=torch.float32, device=dev)
    vel = torch.as_tensor(iv, dtype=torch.float32, device=dev)
    N = pos.shape[-1]
    g = torch.Generator(device="cpu").manual_seed(5)
    v = torch.rand(1, N, generator=g).to(dev)
    pay = torch.randn(1, N, 18, generator=g).to(dev)
    table, own, slots, keep, H, W, ok = _grid_inputs(pos, vel, 2, 32, v=v,
                                                     pay=pay)
    R, n_win = slots.shape
    C, F, P = 32, 25, 18
    rows = {}

    def window_row(shape, d_max, n_pay):
        kw = dict(C=C, r2=4.0, d_max=d_max, n_pay=n_pay)
        args = (table, own, slots, keep)
        out = gridwin.grid_window(*args, **kw)
        row = dict(
            shape=shape,
            ms=time_ms(lambda: gridwin.grid_window(*args, **kw)),
            plain_ms=time_ms(lambda: gridwin.grid_window_plain(*args, **kw),
                             reps=5, inner=2),
            library_ms=None,
            **_window_work(*args, out, C=C, n_feat=7 + n_pay, d_max=d_max))
        # the whole-row count: every agent's n_win table rows
        row["bytes_rows"] = (row["bytes"] - row["table_bytes"]
                             + 4 * R * n_win * W)
        row["bound_ms_rows"], _ = _bound(row["bytes_rows"], row["flops"])
        return row

    rows["grid_window"] = window_row(
        f"R={R} n_win={n_win} C={C} W={W} d_max=0 n_pay={P}", 0, P)
    rows["grid_window@train"] = window_row(
        f"R={R} n_win={n_win} C={C} W={W} d_max=32 n_pay={P}", 32, P)
    fs = torch.randn(1, N, F, generator=g).to(dev)
    starts, _ = _cell_starts(pos)
    rows["table_build"] = dict(
        shape=f"N={N} F={F} H={H} C={C} W={W}",
        ms=time_ms(lambda: gridwin.table_build(fs, starts, C=C)),
        plain_ms=time_ms(lambda: gridwin.table_build_plain(fs, starts, C=C),
                         reps=5, inner=2),
        library_ms=None, bytes=4 * (N * F + (H + 1) + H * W), flops=0)
    mm = torch.randn(H * C, F, generator=g).to(dev)
    rows["table_transpose"] = dict(
        shape=f"H={H} C={C} F={F} W={W}",
        ms=time_ms(lambda: gridwin.table_transpose(mm, C=C, F=F)),
        plain_ms=time_ms(lambda: gridwin.table_transpose_plain(mm, C=C, F=F),
                         reps=5, inner=2),
        library_ms=time_ms(lambda: mm.view(H, C, F)[:, :, :F].transpose(
            1, 2).contiguous()),
        library_call="mm.view(H, C, F)[:, :, :F].transpose(1, 2)"
                     ".contiguous() (no lane padding)",
        bytes=4 * (H * C * F + H * W), flops=0)
    for row in rows.values():
        row["bound_ms"], row["bound_by"] = _bound(row["bytes"], row["flops"])
    emit(phase="flock_timing", nvidia_smi=card, rows=rows,
         peaks=dict(hbm_tb_s=HBM_BYTES_PER_S / 1e12,
                    fp32_tflops=FP32_FLOPS_PER_S / 1e12),
         seconds=time.perf_counter() - t_phase)
    return rows


def phase_flock_profile(setup, card, n=10):
    """Where one flock_n262k eval-shaped rollout step (policy, physics, the
    grid env step) spends its time."""
    import torch
    env, ip, iv, net = setup
    init_fn, step_fn = env._chunked_pieces(net, FLOCK_D, 0, True,
                                           return_graphs=False)
    with torch.no_grad():
        carry = [init_fn(env._as_device(ip), env._as_device(iv))[0]]

        def step():
            carry[0] = step_fn(carry[0])[0]

        prof = _device_profile(step, n)
    emit(phase="flock_profile", nvidia_smi=card,
         config="flock_n262k eval step",
         host_ms_per_step=prof["wall_ms"],
         profiled_host_ms_per_step=prof["profiled_wall_ms"],
         device_ms_per_step=prof["device_ms"],
         device_idle_share=prof["device_idle_share"],
         top=[dict(name=t["name"], ms_per_step=t["ms"],
                   calls_per_step=t["calls"]) for t in prof["top"]])


# ---------------------------------------------------------------------------
# Flocking training (the device-resident DAGger store)
# ---------------------------------------------------------------------------

# flock_train_n262k: examples/largeswarm.py --deviceStore as RESULTS.md
# records its 262,144-agent training run (--nTrain 4 --batch 1
# --trainDuration 0.5 --ellDegree 32): LocalGNN_DB([6,64], [3], True,
# "tanh", [2], 1), Flocking.large_device(262144, commRadius 2, repelDist 1,
# nTrain 4, nValid 1, nTest 1, duration 0.5, dt 0.01: T = 50, ell_degree
# 32, env_grid=True, lam_iters 1, default_rng(0)), TrainerFlocking
# (deviceStore, ellDegree 32, randomEpoch DAGger), batch 1, Adam 5e-4,
# MSE. The smoke trains 3 epochs at probExpert 0.5 (the DAGger-heavy
# regime RESULTS.md records) with validation every 4 steps; random
# weights from a torch seed. The ELL-vs-dense check runs at flock_n4096's
# N (the dense (1, 50, 1, N, N) stack is 3.4 GB there).
FLOCK_TRAIN = dict(N=262144, nTrain=4, nValid=1, nTest=1, duration=0.5,
                   dims=[6, 64], taps=[3], D=32, lam_iters=1, seed=0,
                   wseed=3, epochs=3, probExpert=0.5, valid_every=4,
                   n_ref=4096, bit_steps=10)


def _recompute_launches(T, lam):
    """A training batch's recompute (B = 1): one table a step; the main,
    the repel and max(lam, 32) lambda passes at t = 0, then the main, the
    repel and lam lambda passes a step."""
    return dict(grid_window=2 + max(lam, 32) + (T - 1) * (2 + lam),
                table_build=T, table_transpose=0)


def _rollout_launches(T, lam):
    """One fused-policy rollout (any B): the main pass and max(lam, 32)
    lambda passes at t = 0, then the main pass and lam lambda passes a
    step."""
    return dict(grid_window=1 + max(lam, 32) + (T - 1) * (1 + lam),
                table_build=T, table_transpose=0)


def _repel_edge_swarm(rng, dev):
    """The edge swarm plus two isolated pairs at exactly d^2 = 1 (the
    repel boundary, where the window pass counts a pair and the all-pairs
    expert does not): (pos, vel, [(a, b), ...])."""
    import torch
    epos, evel = _edge_swarm(rng, 397, 12.0, dev)
    n = epos.shape[-1]
    extra = torch.tensor([[14.0, 15.0, 14.0, 14.0],
                          [14.0, 14.0, -14.0, -15.0]], device=dev)[None]
    pos = torch.cat([epos, extra], dim=2)
    vel = torch.cat([evel, torch.ones_like(extra)], dim=2)
    return pos, vel, [(n, n + 1), (n + 2, n + 3)]


def phase_flock_train_kernels(rng, dev):
    """grid_window at the training path's two new shapes against its plain
    version, bit for bit: the expert's repel pass (r2 = 1, d_max = 1,
    n_pay = 0) and the recompute's main pass (d_max = 32, n_pay = 0, the
    table with v lanes), on flock_n262k's swarm and on the edge swarm;
    then the repel shape timed beside its bound."""
    import torch
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    results, errs = [], {}

    def check(case, args, **kw):
        got = gridwin.grid_window(*args, **kw)
        want = gridwin.grid_window_plain(*args, **kw)
        same = bool(torch.equal(got, want))
        max_abs = (got - want).abs().max().item()
        results.append(dict(kernel="grid_window", case=case, equal=same,
                            max_abs_err=max_abs))
        errs["grid_window"] = max(errs.get("grid_window", 0.0), max_abs)
        require(same, f"grid_window [{case}] differs from its plain version "
                      f"(max abs {max_abs})")
        return got

    repel = dict(C=32, r2=1.0, d_max=1, n_pay=0)
    main = dict(C=32, r2=4.0, d_max=32, n_pay=0)
    _, ip, iv, _ = _flock_setup("flock_n262k", dev)
    pos = torch.as_tensor(ip, dtype=torch.float32, device=dev)
    vel = torch.as_tensor(iv, dtype=torch.float32, device=dev)
    N = pos.shape[-1]
    g = torch.Generator(device="cpu").manual_seed(6)
    v = torch.rand(1, N, generator=g).to(dev)
    table, own, slots, keep, H, W, ok = _grid_inputs(pos, vel, 2, 32, v=v)
    require(ok, "262k table overflowed")
    args = (table, own, slots, keep)
    out_r = check("262k repel: r2=1 d_max=1 n_pay=0", args, **repel)
    check("262k recompute: d_max=32 n_pay=0", args, **main)
    require(out_r[:, 2 + 7].max().item() > 1,
            "no agent of the 262k swarm has two repel-range neighbors")

    epos, evel, pairs = _repel_edge_swarm(rng, dev)
    ev = torch.rand(1, epos.shape[-1], generator=g).to(dev)
    for factor, C in ((2, 32), (1, 16)):
        ea = _grid_inputs(epos, evel, factor, C, v=ev)
        require(ea[-1], f"edge swarm overflowed (factor {factor})")
        out = check(f"edge repel: factor={factor} C={C}", ea[:4],
                    **dict(repel, C=C))
        check(f"edge recompute: factor={factor} C={C} d_max=32", ea[:4],
              **dict(main, C=C))
        cnt = out[:, 2 + 7]
        require(cnt.max().item() > 1, "no edge-swarm agent with two "
                                      "repel-range neighbors")
        for a, b in pairs:   # d^2 = 1 exactly: the window pass counts it
            require(out[a, 0].item() == b and out[b, 0].item() == a
                    and cnt[a].item() == 1 and cnt[b].item() == 1,
                    f"d^2 = 1 pair {a}, {b}: ids {out[a, 0].item()}, "
                    f"{out[b, 0].item()}, counts {cnt[a].item()}, "
                    f"{cnt[b].item()}")

    # the repel shape at 262k: CUDA events, a CUDA graph's device time, the
    # plain version, and the bound by the bytes this run's windows reach
    R, n_win = slots.shape
    row = dict(
        shape=f"R={R} n_win={n_win} C=32 W={W} r2=1 d_max=1 n_pay=0",
        ms=time_ms(lambda: gridwin.grid_window(*args, **repel)),
        graph_ms=graph_ms(lambda: gridwin.grid_window(*args, **repel)),
        plain_ms=time_ms(lambda: gridwin.grid_window_plain(*args, **repel),
                         reps=5, inner=2),
        library_ms=None,
        **_window_work(*args, out_r, C=32, n_feat=7, d_max=1))
    row["bound_ms"], row["bound_by"] = _bound(row["bytes"], row["flops"])
    emit(phase="flock_train_kernels", checks=results, repel_timing=row,
         seconds=time.perf_counter() - t_phase)
    return errs, {"grid_window@repel": row}


def _ell_dense(ell, N):
    """The dense (B, T, E, N, N) stack of an EllGso on its device:
    S[..., e, n, m] = val[..., e, m, d] for n = idx[..., m, d]."""
    import torch
    idx, val = ell.idx, ell.val
    St = torch.zeros(val.shape[:-1] + (N,), dtype=val.dtype,
                     device=val.device)                      # (..., e, m, n)
    St.scatter_add_(-1, idx[..., None, :, :].expand(val.shape).long(), val)
    return St.transpose(-1, -2)


def _counting_trainer(log):
    """TrainerFlocking with each training step, DAGger store update,
    validation and coverage check logged with its grid-kernel launches
    (the wrappers' count deltas) and its wall seconds, the card synced at
    both ends, into `log`; a store update also logs whether it changed the
    store."""
    import torch
    from graph_neural_networks_torch.training import TrainerFlocking

    class CountingTrainerFlocking(TrainerFlocking):
        def _counted(self, what, fn, *args):
            torch.cuda.synchronize()
            before = _flock_counts()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            after = _flock_counts()
            log.append(dict(what=what, seconds=seconds, launches={
                k: after[k] - before[k] for k in after}))
            return out

        def train_batch(self, idx):
            return self._counted("step", super().train_batch, idx)

        def _device_store_update(self, sel):
            self._counted("reroll", super()._device_store_update, sel)
            t = self.posAll.new_tensor(np.asarray(sel)).long()
            log[-1].update(learners=len(sel), store_changed=bool(
                (self.posAll[t] != self.posOrig[t]).any()))

        def _valid_cost(self):
            return self._counted("validation", super()._valid_cost)

        def _grid_coverage_check(self):
            return self._counted("coverage check",
                                 super()._grid_coverage_check)

    return CountingTrainerFlocking


def _train_checks(data, dev):
    """The checks beside flock_train_n262k's path: the first batch's
    recompute over its first steps on the kernels against the plain
    versions (bit for bit); the grid expert against the all-pairs expert
    at flock_n4096's swarm; LocalGNN_DB's ELL forward, loss and gradient
    against the dense lsigf_db at N = n_ref, T = 50."""
    import torch
    from graph_neural_networks_torch.data import flocking as fl
    from graph_neural_networks_torch.models.architectures_time import (
        LocalGNN_DB)
    c = FLOCK_TRAIN
    out = {}
    first = np.random.default_rng(c["seed"]).permutation(c["nTrain"])[:1]
    pos = data.pos["train"][first, :c["bit_steps"]]
    vel = data.vel["train"][first, :c["bit_steps"]]
    args = (pos, vel, 2.0, 1.0, fl.EXPERT_ACCEL_MAX, c["D"], True)
    got = fl.recompute_supervision_grid(*args, lam_iters=c["lam_iters"])
    with _plain_gridwin():
        want = fl.recompute_supervision_grid(*args, lam_iters=c["lam_iters"])
    same = {name: bool(torch.equal(a, b)) for name, a, b in (
        ("states", got[0], want[0]), ("labels", got[1], want[1]),
        ("idx", got[2].idx, want[2].idx), ("val", got[2].val, want[2].val))}
    require(all(same.values()), f"recompute kernels vs plain: {same}")
    require(bool(got[3]) and int(got[4]) <= c["D"],
            f"first batch: ok {bool(got[3])}, max in-degree {int(got[4])}")
    out["recompute_vs_plain"] = dict(batch=first.tolist(),
                                     steps=c["bit_steps"], equal=same,
                                     max_in_degree=int(got[4]))
    del got, want

    _, ip, iv, _ = _flock_setup("flock_n4096", dev)
    p4 = torch.as_tensor(ip, dtype=torch.float32, device=dev)
    v4 = torch.as_tensor(iv, dtype=torch.float32, device=dev)
    # the collision sums themselves: at zero velocity and no clip the
    # expert is its repel term alone (the velocity term, thousands at this
    # swarm, would clip nearly every entry at 10 and hide the sums)
    z4 = torch.zeros_like(v4)
    rep_grid, ok = fl.expert_accel_grid(p4, z4, 2.0, 1.0, 1e9)
    rep_ref = fl.expert_accel(p4, z4, 1.0, 1e9)
    err, rel, agree = compare(rep_grid, rep_ref, rtol=1e-4, atol_rel=1e-5)
    d2 = ((p4[:, :, :, None] - p4[:, :, None, :]) ** 2).sum(1)
    n_edge = int((d2 == 1.0).sum())
    del d2
    require(bool(ok) and agree, f"grid collision sums vs all-pairs: max abs "
                                f"{err}, rel {rel}, ok {bool(ok)}")
    a_grid = fl.expert_accel_grid(p4, v4, 2.0, 1.0, 10.0)[0]
    a_ref = fl.expert_accel(p4, v4, 1.0, 10.0)
    err_c, rel_c, agree_c = compare(a_grid, a_ref, rtol=1e-4, atol_rel=1e-5)
    require(agree_c, f"grid expert vs all-pairs, clipped at 10: max abs "
                     f"{err_c}, rel {rel_c}")
    out["expert_vs_all_pairs"] = dict(
        N=p4.shape[-1], B=p4.shape[0], rtol=1e-4,
        atol="1e-5*max|all-pairs|", pairs_at_d2_eq_1=n_edge,
        collision_sums=dict(
            max_abs_err=err, max_rel_err=rel,
            max_abs=float(rep_ref.abs().max()),
            nonzero_share=float((rep_ref != 0).double().mean())),
        clipped_at_10=dict(max_abs_err=err_c, max_rel_err=rel_c,
                           clipped_share=float(
                               (a_ref.abs() >= 10.0).double().mean())))

    ref = fl.Flocking.large_device(
        c["n_ref"], commRadius=2.0, repelDist=1.0, nTrain=1, nValid=0,
        nTest=0, duration=c["duration"], samplingTime=0.01,
        ell_degree=c["D"], lam_iters=c["lam_iters"],
        rng=np.random.default_rng(1), env_grid=True, device=dev)
    x, y, ell, ok, deg = fl.recompute_supervision_grid(
        ref.pos["train"], ref.vel["train"], 2.0, 1.0, fl.EXPERT_ACCEL_MAX,
        c["D"], True, lam_iters=c["lam_iters"])
    require(bool(ok) and int(deg) <= c["D"], "n_ref recompute not exact")
    S = _ell_dense(ell, c["n_ref"])
    net = LocalGNN_DB(c["dims"], c["taps"], True, "tanh", [2], 1,
                      device=dev,
                      generator=torch.Generator().manual_seed(c["wseed"]))
    params = list(net.parameters())
    res = {}
    for name, graph in (("ell", ell), ("dense", S)):
        yh = net(x, graph)
        loss = ((yh - y) ** 2).mean()
        res[name] = (yh.detach(), loss.detach(),
                     torch.autograd.grad(loss, params))
    rows = {}
    pairs = [("forward", res["ell"][0], res["dense"][0]),
             ("loss", res["ell"][1], res["dense"][1])]
    pairs += [(f"grad {n}", a, b) for (n, _), a, b in zip(
        net.named_parameters(), res["ell"][2], res["dense"][2])]
    for name, a, b in pairs:
        err, rel, agree = compare(a, b, rtol=1e-4, atol_rel=1e-4)
        rows[name] = dict(max_abs_err=err, max_rel_err=rel)
        require(agree, f"ELL vs dense lsigf_db, {name}: max abs {err}, "
                       f"rel {rel}")
    out["ell_vs_dense"] = dict(N=c["n_ref"], T=x.shape[1],
                               dense_gb=S.numel() * 4 / 1e9, rtol=1e-4,
                               atol="1e-4*max|dense|", checks=rows)
    return out


def phase_flock_training(dev, card, out_dir):
    """flock_train_n262k through its entry points: Flocking.large_device,
    Model.train with TrainerFlocking (device store, randomEpoch DAGger),
    evaluate_flocking; the counts of the grid kernels from 0 over that
    path, and per step, re-roll and validation; then the checks of
    _train_checks."""
    import torch
    from graph_neural_networks_torch import training
    from graph_neural_networks_torch.data import flocking as fl
    from graph_neural_networks_torch.models.architectures_time import (
        LocalGNN_DB)
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    c = FLOCK_TRAIN
    T = len(np.arange(0, c["duration"], 0.01))
    lam = c["lam_iters"]
    n_samples = c["nTrain"] + c["nValid"] + c["nTest"]
    log = []

    gridwin.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = fl.Flocking.large_device(
        c["N"], commRadius=2.0, repelDist=1.0, nTrain=c["nTrain"],
        nValid=c["nValid"], nTest=c["nTest"], duration=c["duration"],
        samplingTime=0.01, ell_degree=c["D"], lam_iters=lam,
        rng=np.random.default_rng(c["seed"]), env_grid=True, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_counts = _flock_counts()
    net = LocalGNN_DB(c["dims"], c["taps"], True, "tanh", [2], 1, device=dev,
                      generator=torch.Generator().manual_seed(c["wseed"]))
    model = training.Model(net, training.losses.mse_loss,
                           {"name": "ADAM", "lr": 5e-4},
                           _counting_trainer(log), training.evaluate_flocking,
                           name="flock_train", saveDir=out_dir)
    t0 = time.perf_counter()
    out = model.train(data, c["epochs"], 1, deviceStore=True,
                      ellDegree=c["D"], probExpert=c["probExpert"],
                      DAGgerType="randomEpoch",
                      validationInterval=c["valid_every"], seed=c["seed"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    costs = model.evaluate(data)
    eval_s = time.perf_counter() - t0
    launches = _flock_counts()

    store = [getattr(data, a)[s] for a in ("pos", "vel")
             for s in ("train", "valid", "test")]
    require(all(bool(torch.isfinite(a).all()) for a in store),
            "non-finite generated store")
    require(data.generation_ok, "grid overflow during generation")
    losses, valid = out["lossTrain"], out["costValid"]
    require(len(losses) == c["epochs"] * c["nTrain"]
            and np.isfinite(losses).all(), f"losses {losses}")
    require(len(valid) > 0 and np.isfinite(valid).all(), f"valid {valid}")
    require(sorted(costs) == ["costBestEnd", "costBestFull", "costLastEnd",
                              "costLastFull"]
            and np.isfinite(list(costs.values())).all(), f"costs {costs}")
    rerolls = [e for e in log if e["what"] == "reroll"]
    require(rerolls and all(e["store_changed"] for e in rerolls),
            f"learner re-rolls {rerolls}")

    # launch counts: generation, each logged part, evaluation (2
    # checkpoints x compute_trajectory at its default lam_iters 8)
    recompute = _recompute_launches(T, lam)
    expect = {"step": recompute, "reroll": _rollout_launches(T, lam),
              "validation": _rollout_launches(T, lam),
              "coverage check": {k: n * c["nTrain"]
                                 for k, n in recompute.items()}}
    want = {k: n * n_samples for k, n in recompute.items()}
    require(gen_counts == want, f"generation launches {gen_counts}, "
                                f"expected {want}")
    for e in log:
        require(e["launches"] == expect[e["what"]],
                f"{e['what']}: launches {e['launches']}, expected "
                f"{expect[e['what']]}")
    ev = _rollout_launches(T, 8)
    total = {k: gen_counts[k] + sum(e["launches"][k] for e in log)
             + 2 * ev[k] for k in launches}
    require(launches == total, f"path launches {launches}, its parts add "
                               f"up to {total}")
    emit(phase="flock_training", nvidia_smi=card, config="flock_train_n262k",
         N=c["N"], T=T, dims=c["dims"], taps=c["taps"], ell_degree=c["D"],
         store_gb=sum(a.numel() * a.element_size() for a in store) / 1e9,
         generation_s=gen_s, train_s=train_s, evaluate_s=eval_s,
         loss=[float(v) for v in losses], cost_valid=[float(v) for v in valid],
         evaluate=costs, rerolls=rerolls,
         launches_per=dict(generation_sample=recompute, step=recompute,
                           reroll=expect["reroll"],
                           validation=expect["validation"],
                           evaluate_rollout=ev),
         launches=launches, seconds=time.perf_counter() - t_phase)
    t0 = time.perf_counter()
    checks = _train_checks(data, dev)
    emit(phase="flock_training_check", checks=checks,
         seconds=time.perf_counter() - t0)
    return launches, (model, data)


def phase_flock_train_profile(trained, card, n=4):
    """Where one flock_train_n262k training step spends its time: the whole
    step, its recompute (no grad: the grid kernels) and its learning half
    (full-history forward over the ELL graphs, loss, backward, Adam), each
    after warm-up; and the peak device memory of one step."""
    import torch
    from graph_neural_networks_torch import training
    model, data = trained
    c = FLOCK_TRAIN
    trainer = training.TrainerFlocking(
        model, data, 1, 1, deviceStore=True, ellDegree=c["D"],
        coverageCheck=False)
    idx = np.arange(1)
    pos, vel = trainer._step_args(idx)
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    _, peak_gb = _peak_gb(lambda: trainer.train_batch(idx))
    batch = trainer._recompute(pos, vel)
    profs = dict(
        step=_device_profile(lambda: trainer.train_batch(idx), n),
        recompute=_device_profile(lambda: trainer._recompute(pos, vel), n),
        learn=_device_profile(lambda: trainer._learn(*batch[:3]), n))
    step_dev = profs["step"]["device_ms"]
    rows = {k: dict(host_ms=p["wall_ms"], profiled_host_ms=p["profiled_wall_ms"],
                    device_ms=p["device_ms"],
                    device_idle_share=p["device_idle_share"],
                    top=[dict(name=t["name"], ms=t["ms"], calls=t["calls"])
                         for t in p["top"]])
            for k, p in profs.items()}
    emit(phase="flock_train_profile", nvidia_smi=card,
         config="flock_train_n262k step (B = 1, T = 50)",
         peak_gb_above_base=peak_gb, base_allocated_gb=base_gb,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         recompute_share_of_step_device_ms=(
             profs["recompute"]["device_ms"] / step_dev
             if isinstance(step_dev, float) else "not measured"),
         **rows)


# ---------------------------------------------------------------------------
# Flocking through the host-numpy store (Flocking(...), Flocking.large)
# ---------------------------------------------------------------------------

# flock_ref_n50: the reference flockingGNN.py configuration as JAX
# examples/flocking.py runs it without --quick: Flocking(nAgents=50,
# commRadius=2, repelDist=1, nTrain=400, nValid=20, nTest=20, duration=2,
# samplingTime=0.01) from default_rng(0) (T = 200), LocalGNN_DB([6,64],
# [3], True, "tanh", [2], 1), TrainerFlocking's host store, batch 20, Adam
# lr 5e-4, MSE, randomEpoch DAGger at probExpert 0.993. Cut: 2 epochs of
# 30 (epoch 1 runs a DAGger re-roll); random weights from a torch seed.
FLOCK_REF = dict(N=50, nTrain=400, nValid=20, nTest=20, duration=2.0,
                 dims=[6, 64], taps=[3], batch=20, lr=5e-4, probExpert=0.993,
                 epochs=2, seed=0, wseed=4, device_steps=3)
# The closed loop of 20 validation samples over 200 steps on the card
# against the same loop on the CPU: f32 sums in another order grow along
# the loop, so rtol 1e-3 and atol 1e-3 * the largest magnitude.
REF_LOOP_RTOL = 1e-3
REF_LOOP_ATOL_REL = 1e-3

# flock_largetrain_n65536: JAX examples/largeswarm.py --largeTrain
# --trainAgents 65536 --nTrain 4 --batch 1 --trainDuration 0.5
# --ellDegree 32: Flocking.large(65536, commRadius=2, repelDist=1,
# nTrain=4, nValid=1, nTest=1, duration=0.5, samplingTime=0.01,
# ell_degree=32, env_grid=True) from default_rng(0) (T = 50, the quad grid,
# lam_iters 8), LocalGNN_DB([6,64], [3]), TrainerFlocking(ellDegree=32)'s
# host store, batch 1, randomEpoch at 0.993. Cut: 3 epochs of 30, N = 65536
# (at 262144 the host store alone would be ~20 GB of numpy).
FLOCK_LARGE = dict(N=65536, nTrain=4, nValid=1, nTest=1, duration=0.5, D=32,
                   lam_iters=8, dims=[6, 64], taps=[3], epochs=3,
                   probExpert=0.993, seed=0, wseed=5, bit_T=8, profile_n=3,
                   device_lam_iters=1, check_rows=4096, check_steps=(0, 25, 49))


def _host_gb(*arrays):
    """GB of host numpy arrays and numpy-leaf EllGsos."""
    total = 0
    for a in arrays:
        for leaf in ((a.idx, a.val) if hasattr(a, "idx") else (a,)):
            total += np.asarray(leaf).nbytes
    return total / 1e9


def _counting_host_trainer(log, trainers):
    """TrainerFlocking logging, with its grid-kernel launches and its wall
    seconds (the card synced at both ends), each step, each learner
    re-roll with its relabel (rollout_policy), each relabel alone and each
    validation into `log`; every trainer made is appended to `trainers`."""
    import torch
    from graph_neural_networks_torch.training import TrainerFlocking

    class CountingHostTrainer(TrainerFlocking):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            trainers.append(self)

        def _counted(self, what, fn, *args, **kw):
            torch.cuda.synchronize()
            before = _flock_counts()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            after = _flock_counts()
            log.append(dict(what=what, seconds=seconds, launches={
                k: after[k] - before[k] for k in after}))
            return out

        def train_batch(self, idx):
            return self._counted("step", super().train_batch, idx)

        def _rollout_policy(self, init_pos, init_vel, *a, **k):
            out = self._counted("rollout_policy", super()._rollout_policy,
                                init_pos, init_vel, *a, **k)
            log[-1]["learners"] = len(init_pos)
            return out

        def _expert_accel(self, pos, vel):
            return self._counted("relabel", super()._expert_accel, pos, vel)

        def _valid_cost(self):
            return self._counted("validation", super()._valid_cost)

    return CountingHostTrainer


def _step_profile(trainer, idx, n, profiled=True):
    """A training step's host ms, device ms, idle share and top kernels
    (torch.profiler over n steps), its peak device memory, and the upload
    alone (the host store's index and copy to the card; the device store's
    gather) in host ms, synchronized. profiled=False: host ms only (a step
    of thousands of small launches would take the profiler minutes)."""
    import torch
    _, peak_gb = _peak_gb(lambda: trainer.train_batch(idx))
    if profiled:
        prof = _device_profile(lambda: trainer.train_batch(idx), n)
    else:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.train_batch(idx)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
        prof = dict(wall_ms=wall, profiled_wall_ms="not profiled",
                    device_ms="not measured",
                    device_idle_share="not measured", top=[])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        trainer._step_args(idx)
        torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) / n * 1e3
    return dict(host_ms=prof["wall_ms"],
                profiled_host_ms=prof["profiled_wall_ms"],
                device_ms=prof["device_ms"],
                device_idle_share=prof["device_idle_share"],
                upload_host_ms=upload_ms, peak_gb_above_base=peak_gb,
                top=[dict(name=t["name"], ms=t["ms"], calls=t["calls"])
                     for t in prof["top"]])


def _ref_model(dev, out_dir, trainer_cls, name):
    import torch
    from graph_neural_networks_torch import training
    from graph_neural_networks_torch.models.architectures_time import (
        LocalGNN_DB)
    c = FLOCK_REF
    net = LocalGNN_DB(c["dims"], c["taps"], True, "tanh", [2], 1, device=dev,
                      generator=torch.Generator().manual_seed(c["wseed"]))
    return training.Model(net, training.losses.mse_loss,
                          {"name": "ADAM", "lr": c["lr"]}, trainer_cls,
                          training.evaluate_flocking, name=name,
                          saveDir=out_dir)


def phase_flock_ref_training(dev, card, out_dir):
    """flock_ref_n50 through its entry points: Flocking(...) on the host,
    Model.train with TrainerFlocking's host store (randomEpoch DAGger) and
    evaluate_flocking, all on the all-pairs env; the grid kernels' counts
    over that path (none runs on it); then its checks: the closed loop of
    the validation split on the card against the CPU, the dense
    recompute on the card against the host store, a few device-store steps
    against the host store's first loss; and one step profiled."""
    import torch
    from graph_neural_networks_torch import training
    from graph_neural_networks_torch.data import flocking as fl
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    c = FLOCK_REF
    T = len(np.arange(0, c["duration"], 0.01))
    log, trainers = [], []

    gridwin.reset_launch_counts()
    t0 = time.perf_counter()
    data = fl.Flocking(nAgents=c["N"], commRadius=2.0, repelDist=1.0,
                       nTrain=c["nTrain"], nValid=c["nValid"],
                       nTest=c["nTest"], duration=c["duration"],
                       samplingTime=0.01, rng=np.random.default_rng(c["seed"]),
                       device=dev)
    gen_s = time.perf_counter() - t0
    model = _ref_model(dev, out_dir, _counting_host_trainer(log, trainers),
                       "flock_ref")
    t0 = time.perf_counter()
    out = model.train(data, c["epochs"], c["batch"], validationInterval=20,
                      probExpert=c["probExpert"], DAGgerType="randomEpoch",
                      seed=c["seed"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    costs = model.evaluate(data)
    eval_s = time.perf_counter() - t0
    launches = _flock_counts()

    losses, valid = out["lossTrain"], out["costValid"]
    n_steps = c["epochs"] * c["nTrain"] // c["batch"]
    require(len(losses) == n_steps and np.isfinite(losses).all(),
            f"losses {losses}")
    require(len(valid) == -(-n_steps // 20) and np.isfinite(valid).all(),
            f"valid {valid}")
    require(sorted(costs) == ["costBestEnd", "costBestFull", "costLastEnd",
                              "costLastFull"]
            and np.isfinite(list(costs.values())).all(), f"costs {costs}")
    rerolls = [e for e in log if e["what"] == "rollout_policy"]
    require(len(rerolls) == 1 and rerolls[0]["learners"] > 0,
            f"epoch 1's DAGger re-roll: {rerolls}")
    trainer = trainers[0]
    S = trainer.SAll
    require(isinstance(S, np.ndarray) and S.shape == (c["nTrain"], T, c["N"],
                                                       c["N"]),
            f"dense host store {getattr(S, 'shape', S)}")
    require(all(v == 0 for v in launches.values()),
            f"the all-pairs path launched grid kernels: {launches}")
    steps = [e["seconds"] for e in log if e["what"] == "step"]
    emit(phase="flock_ref_training", nvidia_smi=card, config="flock_ref_n50",
         N=c["N"], T=T, n_samples=c["nTrain"] + c["nValid"] + c["nTest"],
         dims=c["dims"], taps=c["taps"], batch=c["batch"],
         host_store_gb=_host_gb(trainer.xAll, trainer.yAll, trainer.SAll),
         dataset_gb=_host_gb(*(getattr(data, f)[s] for f in (
             "pos", "vel", "accel", "commGraph", "state")
             for s in ("train", "valid", "test"))),
         generation_s=gen_s, train_s=train_s, evaluate_s=eval_s,
         step_s_median=float(np.median(steps)),
         loss=[float(v) for v in losses], cost_valid=[float(v) for v in valid],
         expert_cost=data.evaluate(vel=data.getData("vel", "test")),
         evaluate=costs, rerolls=rerolls,
         validations=[e for e in log if e["what"] == "validation"],
         launches=launches, seconds=time.perf_counter() - t_phase)

    # checks beside the path
    t0 = time.perf_counter()
    checks = {}
    net = model.archit
    ip, iv = data.getData("initPos", "valid"), data.getData("initVel", "valid")
    got = data.compute_trajectory(ip, iv, c["duration"], net)
    cpu_env = fl.Flocking.for_rollout(c["N"], 2.0, 1.0, 0.01, device="cpu")
    cpu_net = _ref_model("cpu", out_dir, training.TrainerFlocking,
                         "cpu").archit
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    want = cpu_env.compute_trajectory(ip, iv, c["duration"], cpu_net)
    rows = {}
    for name, a, b in zip(("pos", "vel", "accel", "states", "graphs"), got,
                          want):
        err, rel, agree = compare(torch.as_tensor(a), torch.as_tensor(b),
                                  rtol=REF_LOOP_RTOL,
                                  atol_rel=REF_LOOP_ATOL_REL)
        rows[name] = dict(max_abs_err=err, max_rel_err=rel,
                          max_abs=float(np.abs(b).max()))
        require(agree, f"dense closed loop, card vs CPU, {name}: max abs "
                       f"{err}, rel {rel}")
    checks["closed_loop_card_vs_cpu"] = dict(
        B=len(ip), T=T, rtol=REF_LOOP_RTOL,
        atol=f"{REF_LOOP_ATOL_REL}*max|cpu|", fields=rows,
        cost_card=data.evaluate(vel=got[1]),
        cost_cpu=cpu_env.evaluate(vel=want[1]))

    # the first batch's recompute on the card against the host store: equal
    # to f32 rounding but for the pairs within rounding of a cut (the
    # graph's d2 <= 4, the expert's d2 < 1), which the f32 recompute may
    # settle the other way: an agent with such a pair is left out of the
    # state or label comparison, a graph with a flipped edge out of the
    # graph comparison, and every flipped edge must lie at the cut
    idx = np.arange(c["batch"])
    pos64 = torch.as_tensor(data.getData("pos", "train")[idx], device=dev)
    x, y, Sd = fl.recompute_supervision(
        pos64.float(), torch.as_tensor(data.getData("vel", "train")[idx],
                                       dtype=torch.float32, device=dev),
        2.0, 1.0, data.accelMax)
    require(not bool(y[:, -1].any()), "recompute: accel[T-1] not zeroed")
    host = {f: torch.as_tensor(data.getData(f, "train")[idx], device=dev)
            for f in ("state", "accel", "commGraph")}
    d2 = ((pos64[..., :, None] - pos64[..., None, :]) ** 2).sum(2)
    flip = (host["commGraph"] > 0) != (Sd > 0)
    off_cut = float((d2[flip] - 4.0).abs().max()) if flip.any() else 0.0
    require(off_cut < 1e-4, f"recompute: a graph edge flipped {off_cut} "
                            "from the range cut d2 = 4")
    near_r = (flip.any(-1) | flip.any(-2))[:, :, None]
    near_rep = ((d2 - 1.0).abs() < 1e-4).any(-1)[:, :, None]
    keep = dict(state=~near_r, accel=~near_rep,
                commGraph=~flip.any((-1, -2))[:, :, None, None])
    rows = dict(flipped_edges=int(flip.sum()) // 2,
                graphs_with_a_flip=int(flip.any((-1, -2)).sum()),
                agents_at_the_repel_cut=int(near_rep.sum()))
    for name, a in (("state", x), ("accel", y), ("commGraph", Sd)):
        k = keep[name].expand_as(a)
        err, rel, agree = compare(a[k], host[name][k], rtol=1e-4,
                                  atol_rel=1e-4)
        rows[name] = dict(max_abs_err=err, max_rel_err=rel,
                          compared_share=float(k.double().mean()))
        require(agree, f"dense recompute vs host store, {name}: max abs "
                       f"{err}, rel {rel}")
    checks["recompute_vs_host_store"] = dict(batch=idx.tolist(), rtol=1e-4,
                                             atol="1e-4*max|host|",
                                             fields=rows)
    y_first = y.cpu().numpy().astype(np.float64)
    del pos64, d2, flip, host, x, y, Sd

    # a few steps of the device store (the dense recompute) against the
    # host store from the same weights. Their first losses differ by the
    # labels of the agents at the repel cut (above), so the first step is
    # also taken on the host store with the recompute's labels of that
    # batch, which must give the device store's loss to f32 rounding
    def trainers(name):
        return (training.TrainerFlocking(_ref_model(
            dev, out_dir, training.TrainerFlocking, name), data, 1,
            c["batch"]))
    host_tr = trainers("host")
    dev_tr = training.TrainerFlocking(_ref_model(
        dev, out_dir, training.TrainerFlocking, "device"), data, 1,
        c["batch"], deviceStore=True)
    same_tr = trainers("same_labels")
    same_tr.yAll = same_tr.yAll.copy()
    same_tr.yAll[idx] = y_first
    batches = [np.arange(i * c["batch"], (i + 1) * c["batch"]) % c["nTrain"]
               for i in range(c["device_steps"])]
    host_loss = [host_tr.train_batch(b)[0] for b in batches]
    dev_loss = [dev_tr.train_batch(b)[0] for b in batches]
    same0 = same_tr.train_batch(batches[0])[0]
    rel0 = abs(dev_loss[0] - host_loss[0]) / abs(host_loss[0])
    rel_same = abs(dev_loss[0] - same0) / abs(same0)
    require(rel_same <= 1e-4 and np.isfinite(dev_loss).all(),
            f"device store's first loss {dev_loss[0]} vs the host store's on "
            f"the same labels {same0} (rel {rel_same})")
    checks["device_store_vs_host_store"] = dict(
        steps=c["device_steps"], rtol=1e-4,
        first_loss_rel_err_same_labels=rel_same,
        first_loss_rel_err_host_labels=rel0, host_loss=host_loss,
        device_loss=dev_loss, host_loss_same_labels=same0)
    emit(phase="flock_ref_training_check", checks=checks,
         seconds=time.perf_counter() - t0)

    idx = np.arange(c["batch"])
    # the device store's step runs eigvalsh on 4000 50 x 50 matrices, which
    # torch loops one matrix at a time on the card: timed, not profiled
    prof = dict(host_store=_step_profile(host_tr, idx, 4),
                device_store=_step_profile(dev_tr, idx, 2, profiled=False))
    # the dense recompute's lambda_max on the batch's 4000 graphs:
    # eigvalsh (what the step runs) against power iteration
    W = (torch.as_tensor(host_tr.SAll[idx], device=dev) > 0).float()
    W = W.reshape(-1, c["N"], c["N"])

    def once_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    lam = dict(matrices=W.shape[0],
               eigvalsh_host_ms=once_ms(lambda: torch.linalg.eigvalsh(W)),
               power_host_ms=once_ms(lambda: fl.lambda_max_power(W)))
    emit(phase="flock_ref_profile", nvidia_smi=card,
         config="flock_ref_n50 step (B = 20, T = 200, N = 50)",
         upload_mb=(4 * (host_tr.xAll[idx].size + host_tr.yAll[idx].size
                         + host_tr.SAll[idx].size)) / 1e6, lambda_max=lam,
         **prof)
    return launches


def _repel_rows(pos, rows, repel):
    """All-pairs collision sums of the agents `rows` against the whole
    swarm, as data.flocking.expert_accel sums them (2 * sum_j dp * (inv^2 +
    inv) over d2 < repel^2): pos (1, 2, N) -> (2, len(rows))."""
    import torch
    from graph_neural_networks_torch.data.base import ZERO_TOL
    dp = pos[0][:, rows, None] - pos[0][:, None, :]          # 2, R, N
    d2 = (dp ** 2).sum(0)
    inv = torch.where(d2 > ZERO_TOL, 1.0 / d2, torch.zeros_like(d2))
    w = (d2 < repel ** 2).to(d2.dtype) * (inv ** 2 + inv)
    return 2.0 * (dp * w).sum(-1)


def phase_flock_largetrain(dev, card, out_dir):
    """flock_largetrain_n65536 through its entry points: Flocking.large(
    env_grid=True) (the expert's supervision on the grid kernels),
    Model.train with TrainerFlocking's ELL host store (randomEpoch DAGger)
    and evaluate_flocking; the grid kernels' counts from 0 over that path
    and for its parts; then a learner re-roll and its relabel driven
    beside the path, the relabel's collision sums against all pairs, the
    generation against the plain grid versions bit for bit at a reduced T,
    a step profiled on the host store and the same step on the device
    store over Flocking.large_device at the same N."""
    import torch
    from graph_neural_networks_torch import training
    from graph_neural_networks_torch.data import flocking as fl
    from graph_neural_networks_torch.models.architectures_time import (
        LocalGNN_DB)
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    c = FLOCK_LARGE
    T = len(np.arange(0, c["duration"], 0.01))
    lam = c["lam_iters"]
    n_samples = c["nTrain"] + c["nValid"] + c["nTest"]
    log, trainers = [], []
    kw = dict(commRadius=2.0, repelDist=1.0, samplingTime=0.01,
              ell_degree=c["D"], env_grid=True, device=dev)

    gridwin.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = fl.Flocking.large(c["N"], nTrain=c["nTrain"], nValid=c["nValid"],
                             nTest=c["nTest"], duration=c["duration"],
                             lam_iters=lam,
                             rng=np.random.default_rng(c["seed"]), **kw)
    gen_s = time.perf_counter() - t0
    gen_counts = _flock_counts()
    net = LocalGNN_DB(c["dims"], c["taps"], True, "tanh", [2], 1, device=dev,
                      generator=torch.Generator().manual_seed(c["wseed"]))
    model = training.Model(net, training.losses.mse_loss,
                           {"name": "ADAM", "lr": 5e-4},
                           _counting_host_trainer(log, trainers),
                           training.evaluate_flocking, name="flock_large",
                           saveDir=out_dir)
    t0 = time.perf_counter()
    out = model.train(data, c["epochs"], 1, ellDegree=c["D"],
                      probExpert=c["probExpert"], DAGgerType="randomEpoch",
                      seed=c["seed"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    costs = model.evaluate(data)
    eval_s = time.perf_counter() - t0
    launches = _flock_counts()

    trainer = trainers[0]
    losses, valid = out["lossTrain"], out["costValid"]
    require(len(losses) == c["epochs"] * c["nTrain"]
            and np.isfinite(losses).all(), f"losses {losses}")
    require(len(valid) > 0 and np.isfinite(valid).all(), f"valid {valid}")
    require(sorted(costs) == ["costBestEnd", "costBestFull", "costLastEnd",
                              "costLastFull"]
            and np.isfinite(list(costs.values())).all(), f"costs {costs}")
    S = trainer.SAll
    require(trainer._is_ell(S) and S.val.dtype == np.float32
            and S.idx.shape == (c["nTrain"], T, c["N"], c["D"]),
            f"ELL host store {S}")
    # launch counts: generation (gen_batch 4: one table and 2 + lam window
    # passes a step for each chunk of samples), each logged part, and
    # evaluate (2 checkpoints x compute_trajectory at lam_iters 8)
    n_chunks = -(-n_samples // 4)
    want_gen = dict(grid_window=n_chunks * T * (2 + lam),
                    table_build=n_chunks * T, table_transpose=0)
    require(gen_counts == want_gen, f"generation launches {gen_counts}, "
                                    f"expected {want_gen}")
    roll = _rollout_launches(T, lam)
    relabel = dict(grid_window=1, table_build=1, table_transpose=0)
    zero = dict(grid_window=0, table_build=0, table_transpose=0)
    for e in log:
        if e["what"] == "rollout_policy":
            want = {k: roll[k] + relabel[k] for k in roll}
        else:
            want = dict(step=zero, relabel=relabel, validation=roll)[e["what"]]
        require(e["launches"] == want, f"{e['what']}: launches "
                                       f"{e['launches']}, expected {want}")
    total = {k: gen_counts[k] + sum(e["launches"][k] for e in log
                                    if e["what"] != "relabel")
             + 2 * roll[k] for k in launches}
    require(launches == total, f"path launches {launches}, its parts add "
                               f"up to {total}")
    for k in ("table_build", "grid_window"):
        require(launches[k] > 0, f"{k} never launched on the path")
    emit(phase="flock_largetrain", nvidia_smi=card,
         config="flock_largetrain_n65536", N=c["N"], T=T, dims=c["dims"],
         taps=c["taps"], ell_degree=c["D"], lam_iters=lam,
         dataset_gb=_host_gb(*(getattr(data, f)[s] for f in (
             "pos", "vel", "accel", "commGraph", "state")
             for s in ("train", "valid", "test"))),
         host_store_gb=_host_gb(trainer.xAll, trainer.yAll, trainer.SAll),
         generation_s=gen_s, train_s=train_s, evaluate_s=eval_s,
         loss=[float(v) for v in losses], cost_valid=[float(v) for v in valid],
         evaluate=costs,
         rerolls=[e for e in log if e["what"] == "rollout_policy"],
         step_s=[e["seconds"] for e in log if e["what"] == "step"],
         launches_per=dict(generation=want_gen, step=zero, reroll=roll,
                           relabel=relabel, validation=roll,
                           evaluate_rollout=roll),
         launches=launches, seconds=time.perf_counter() - t_phase)

    # a learner re-roll and its relabel, beside the path, counted
    t0 = time.perf_counter()
    ip, iv = trainer.initPosAll[:1], trainer.initVelAll[:1]
    before = _flock_counts()
    pos, vel, _, states, graphs = data.compute_trajectory(
        ip, iv, c["duration"], net)
    torch.cuda.synchronize()
    mid = _flock_counts()
    y = trainer._expert_accel(pos, vel)
    after = _flock_counts()
    reroll_l = {k: mid[k] - before[k] for k in mid}
    relabel_l = {k: after[k] - mid[k] for k in mid}
    require(reroll_l == roll and relabel_l == relabel,
            f"re-roll {reroll_l}, relabel {relabel_l}")
    require(np.isfinite(y).all() and np.abs(y).max() <= data.accelMax,
            "relabel out of range")
    # the relabel's collision sums (zero velocity, no clip) against all
    # pairs for check_rows agents at a few steps
    accel_max = data.accelMax
    data.accelMax = 1e9
    try:
        rep = trainer._expert_accel(pos, np.zeros_like(vel))
    finally:
        data.accelMax = accel_max
    rows_t = torch.as_tensor(np.random.default_rng(7).choice(
        c["N"], c["check_rows"], replace=False), device=dev)
    errs = {}
    for t in c["check_steps"]:
        p_t = torch.as_tensor(pos[:, t], dtype=torch.float32, device=dev)
        ref = _repel_rows(p_t, rows_t, 1.0)
        got_t = torch.as_tensor(rep[0, t], dtype=torch.float32,
                                device=dev)[:, rows_t]
        err, rel, agree = compare(got_t, ref, rtol=1e-4, atol_rel=1e-5)
        errs[t] = dict(max_abs_err=err, max_rel_err=rel,
                       max_abs=float(ref.abs().max()),
                       nonzero_share=float((ref != 0).double().mean()))
        require(agree, f"relabel collision sums at t={t} vs all pairs: max "
                       f"abs {err}, rel {rel}")
    emit(phase="flock_largetrain_check", reroll_launches=reroll_l,
         relabel_launches=relabel_l,
         relabel_vs_all_pairs=dict(rows=c["check_rows"], rtol=1e-4,
                                   atol="1e-5*max|all-pairs|", steps=errs),
         seconds=time.perf_counter() - t0)
    del pos, vel, states, graphs, y, rep

    # Flocking.large's generation on the kernels against the plain
    # versions, bit for bit, at T = bit_T
    t0 = time.perf_counter()
    gen = lambda: fl.Flocking.large(
        c["N"], nTrain=1, nValid=0, nTest=0, duration=c["bit_T"] * 0.01,
        lam_iters=lam, rng=np.random.default_rng(c["seed"]), **kw)
    a = gen()
    with _plain_gridwin():
        b = gen()
    same = {}
    for f in ("pos", "vel", "accel", "state"):
        same[f] = bool(np.array_equal(a.getData(f, "train"),
                                      b.getData(f, "train")))
    ga, gb = a.getData("commGraph", "train"), b.getData("commGraph", "train")
    same["idx"] = bool(np.array_equal(ga.idx, gb.idx))
    same["val"] = bool(np.array_equal(ga.val, gb.val))
    require(all(same.values()), f"Flocking.large kernels vs plain: {same}")
    emit(phase="flock_largetrain_bits", T=c["bit_T"], equal=same,
         seconds=time.perf_counter() - t0)
    del a, b

    # a step of each store at N = 65536
    t0 = time.perf_counter()
    idx = np.arange(1)
    host = _step_profile(trainer, idx, c["profile_n"])
    upload_gb = _host_gb(trainer.xAll[idx], trainer.yAll[idx],
                         trainer._S_index(trainer.SAll, idx))
    del trainers[:], trainer, data, model
    torch.cuda.empty_cache()
    dstore = fl.Flocking.large_device(
        c["N"], nTrain=c["nTrain"], nValid=c["nValid"], nTest=c["nTest"],
        duration=c["duration"], lam_iters=c["device_lam_iters"],
        rng=np.random.default_rng(c["seed"]), **kw)
    dtrainer = training.TrainerFlocking(
        training.Model(net, training.losses.mse_loss,
                       {"name": "ADAM", "lr": 5e-4},
                       training.TrainerFlocking, training.evaluate_flocking,
                       name="flock_large_device", saveDir=out_dir),
        dstore, 1, 1, deviceStore=True, ellDegree=c["D"], coverageCheck=False)
    device = _step_profile(dtrainer, idx, c["profile_n"])
    emit(phase="flock_largetrain_profile", nvidia_smi=card,
         config="flock_largetrain_n65536 step (B = 1, T = 50, N = 65536)",
         host_store=dict(host, upload_gb=upload_gb),
         device_store=dict(device, lam_iters=c["device_lam_iters"],
                           store="Flocking.large_device (pos, vel only)"),
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         seconds=time.perf_counter() - t0)
    return launches


# ---------------------------------------------------------------------------
# Node-sharded path (single controller; the shards share the one card)
# ---------------------------------------------------------------------------

# gat_band_n16384 node-sharded with order="none": over a (1, 4) data x
# graph mesh (4 shards: block 4096, ibs 128, nbl 32, w 2, halo 256) and a
# (2, 2) one (2 data slices x 2 shards); both meshes repeat the one card.
SHARD_PARTS = 4
SHARD_MESHES = (((1, 4), None), ((2, 2), "data"))
SHARD_REQUESTS = (8, 5, 1)


def _shard_operands(rng, dev, part, Q, F, mc, mr):
    """Global projections and signals at the partition's padded width
    (zero on padded nodes), cut into shards on `dev` and halo-extended from
    the real neighbour shards; each shard's masks on `dev`."""
    import torch
    from graph_neural_networks_torch.parallel.mesh import halo_ext
    a1, a2, v = _attn_operands(rng, dev, Q, F, part.n_orig, part.n_padded)
    bs, halo = part.block_size, part.halo

    def shards(t):
        return [t[..., p * bs:(p + 1) * bs].contiguous()
                for p in range(part.n_parts)]
    own = dict(a1=shards(a1), a2=shards(a2), v=shards(v))
    ext = {k: halo_ext(t, halo) for k, t in own.items()}
    masks = [(torch.as_tensor(mc[p], device=dev),
              torch.as_tensor(mr[p], device=dev),
              torch.as_tensor(part.slabs[p, 0], device=dev))
             for p in range(part.n_parts)]
    return own, ext, masks


def phase_shard_kernels(part, mc, mr, rng, dev):
    """stats_ext_call and apply_ext_call against their plain versions on
    the card, on operands halo-extended from real neighbour shards: at the
    served shard shape (gat_band_n16384 over 4 shards: Q = 16, F = 32,
    Np = 4096, w = 2, ibs = 128) for the first, an interior and the last
    shard, with_s True and False; and on a ragged 4-shard partition
    (N = 2000, 48 padded nodes, F = 40) and on partitions with w = 1 and
    3."""
    import torch
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.parallel.mesh import halo_ext
    t_phase = time.perf_counter()
    results, errs = [], {}

    def check(name, case, got, want, served):
        max_abs, max_rel, ok = compare(got, want)
        results.append(dict(kernel=name, case=case, max_abs_err=max_abs,
                            max_rel_err=max_rel,
                            max_abs_plain=want.abs().max().item(), ok=ok))
        if served:
            errs[name] = max(errs.get(name, 0.0), max_abs)
        require(ok and bool(torch.isfinite(got).all()),
                f"{name} [{case}] disagrees with its plain version: max abs "
                f"{max_abs}, max rel {max_rel}")

    def run(label, part, mc, mr, Q, F, served):
        w, ibs = part.w, part.inner_bs
        own, ext, masks = _shard_operands(rng, dev, part, Q, F, mc, mr)
        label = f"{label} G={_apply_group(Q, F, part.block_size, dev)}"
        stats = [af.stats_ext_plain(ext["a1"][p], own["a2"][p], masks[p][1],
                                    w=w, ibs=ibs)
                 for p in range(part.n_parts)]
        mx_ext = halo_ext([s[0] for s in stats], part.halo)
        sm_ext = halo_ext([s[1] for s in stats], part.halo)
        for p in sorted({0, 1, part.n_parts - 1}):
            case = f"{label} shard {p}/{part.n_parts}"
            mx, sm = af.stats_ext_call(ext["a1"][p], own["a2"][p],
                                       masks[p][1], w=w, ibs=ibs)
            check("stats_ext_call", case + " rowmax", mx, stats[p][0], served)
            check("stats_ext_call", case + " rowsum", sm, stats[p][1], served)
            args = (own["a1"][p], ext["a2"][p], ext["v"][p], mx_ext[p],
                    sm_ext[p], masks[p][2], masks[p][0])
            lists = af.support_lists(masks[p][0])
            for ws in (True, False):
                got = af.apply_ext_call(*args, w=w, ibs=ibs, with_s=ws,
                                        lists=lists)
                want = af.apply_ext_plain(*args, w=w, ibs=ibs, with_s=ws)
                check("apply_ext_call", f"{case} with_s={ws}", got, want,
                      served)

    run(f"served Q=16 F=32 Np={part.block_size} w={part.w}", part, mc, mr,
        GAT_BATCH * GAT_HEADS[0], GAT_DIMS[1], True)
    # rows without support on the first and last shards, in their first
    # and last w row blocks (windows into a halo past the global end) and
    # in the middle: rowmax -1e12 and rowsum W*ibs, as stats_call gives
    # the same rows
    w, ibs, Np = part.w, part.inner_bs, part.block_size
    rows = [0, 7, ibs + 1, Np // 2, Np - ibs - 1, Np - 1]
    mr_e = [_empty_rows(torch.as_tensor(mr[p], device=dev), rows)
            for p in range(part.n_parts)]
    for Q in (16, 3):
        own, ext, _ = _shard_operands(rng, dev, part, Q, 8, mc, mr)
        for p in (0, part.n_parts - 1):
            case = f"empty rows {rows} shard {p}/{part.n_parts} Q={Q}"
            mx, sm = af.stats_ext_call(ext["a1"][p], own["a2"][p], mr_e[p],
                                       w=w, ibs=ibs)
            pmx, psm = af.stats_ext_plain(ext["a1"][p], own["a2"][p],
                                          mr_e[p], w=w, ibs=ibs)
            keep = _other_rows(Np, rows)
            check("stats_ext_call", case + " rowmax", mx[:, keep],
                  pmx[:, keep], False)
            check("stats_ext_call", case + " rowsum", sm[:, keep],
                  psm[:, keep], False)
            _check_empty_rows("stats_ext_call", mx, sm, rows, 2 * w + 1,
                              ibs)
            _check_empty_rows("stats_ext_plain", pmx, psm, rows, 2 * w + 1,
                              ibs)
    S2, _ = make_graph(2000, 0.01, 256, seed=2)
    part2 = par.partition_nodes(S2, SHARD_PARTS, order="none")
    require(part2.is_ring and part2.n_padded > part2.n_orig,
            f"ragged case: w={part2.w}, nbl={part2.nbl}")
    run(f"ragged N=2000 Q=3 F=40 Np={part2.block_size} w={part2.w}", part2,
        *par.attention._row_col_masks(part2), 3, 40, False)
    # narrower and wider windows over 4 shards of 1024 (w = 1, 3, 7; the
    # first and last shards' halos past the global ends are fully masked
    # rows), with Q and F across the apply kernel's groups
    for bandwidth, w, Q, F in ((100, 1, 4, 32), (300, 3, 4, 32),
                               (300, 3, 1, 64), (850, 7, 7, 8),
                               (850, 7, 5, 64)):
        S3, _ = make_graph(4096, 0.01, bandwidth, seed=3)
        part3 = par.partition_nodes(S3, SHARD_PARTS, order="none")
        require(part3.is_ring and part3.w == w, f"w={part3.w}, expected {w}")
        run(f"N=4096 Q={Q} F={F} Np={part3.block_size} w={w}", part3,
            *par.attention._row_col_masks(part3), Q, F, False)
    emit(phase="shard_kernels", rtol=RTOL, atol=f"{ATOL_REL}*max|plain|",
         checks=results, seconds=time.perf_counter() - t_phase)
    return errs


def _attention_work_at(Q, F, Np, n_rows, tile, scores, support,
                       with_s=True):
    """Scores, bytes and operations of one stats and one apply call. Np:
    the own row length (a2 in stats; a1 and y in apply); n_rows: that of
    the operands read through the window (a1 in stats; a2, the stats and v
    in apply), Np + 2*w*ibs halo-extended; tile: the floats of one
    (nb, W, ibs, ibs) mask or slab. Each operand's bytes counted once."""
    stats_bytes = 4 * (Q * n_rows + 3 * Q * Np + tile)  # a1, a2; max, sum
    apply_bytes = 4 * (Q * F * (n_rows + Np) + Q * Np + 3 * Q * n_rows
                       + (2 if with_s else 1) * tile)
    # per score: the score (add, LeakyReLU, e*m - (1-m)*1e12: 6 flops),
    # then max, subtract, sum (stats) or subtract, divide, *m, *S and the
    # 2F aggregation (apply); one exp in either
    stats_flops, apply_flops = 9, 9 + int(with_s) + 2 * F
    return dict(scores=scores, support_scores=support,
                stats=(stats_bytes, stats_flops),
                apply=(apply_bytes, apply_flops))


def phase_shard_timing(part, mc, mr, dev):
    """Each ext kernel at the served shard shape (an interior shard of
    gat_band_n16384 over 4: Q = 16, F = 32, with_s) beside its plain
    version and its bound (the S+I support of that shard's own rows or
    columns; the dense-tile figure, every score of the W window blocks the
    kernels walk, beside it). No single PyTorch call computes either."""
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.parallel.mesh import halo_ext
    t_phase = time.perf_counter()
    Q, F = GAT_BATCH * GAT_HEADS[0], GAT_DIMS[1]
    w, ibs, Np = part.w, part.inner_bs, part.block_size
    own, ext, masks = _shard_operands(np.random.default_rng(7), dev, part,
                                      Q, F, mc, mr)
    kw = dict(w=w, ibs=ibs)
    stats = [af.stats_ext_plain(ext["a1"][q], own["a2"][q], masks[q][1],
                                **kw) for q in range(part.n_parts)]
    p = 1
    mcol, mrow, slab = masks[p]
    mx_ext = halo_ext([st[0] for st in stats], part.halo)[p]
    sm_ext = halo_ext([st[1] for st in stats], part.halo)[p]
    app = (own["a1"][p], ext["a2"][p], ext["v"][p], mx_ext, sm_ext, slab,
           mcol)
    lists = af.support_lists(mcol)
    n_rows = Np + 2 * part.halo
    tile = part.nbl * (2 * w + 1) * ibs * ibs
    scores = Q * part.nbl * (2 * w + 1) * ibs * ibs
    shape = f"Q={Q} F={F} Np={Np} (+2*{part.halo} halo) w={w} ibs={ibs}"
    rows = {
        "stats_ext_call": dict(
            shape=shape,
            ms=time_ms(lambda: af.stats_ext_call(ext["a1"][p], own["a2"][p],
                                                 mrow, **kw)),
            graph_ms=graph_ms(lambda: af.stats_ext_call(
                ext["a1"][p], own["a2"][p], mrow, **kw)),
            plain_ms=time_ms(lambda: af.stats_ext_plain(
                ext["a1"][p], own["a2"][p], mrow, **kw), reps=5, inner=2),
            work=_attention_work_at(Q, F, Np, n_rows, tile, scores,
                                    Q * int(mrow.sum().item()))["stats"],
            support=Q * int(mrow.sum().item())),
        "apply_ext_call": dict(
            shape=shape + " with_s",
            ms=time_ms(lambda: af.apply_ext_call(*app, **kw, lists=lists)),
            graph_ms=graph_ms(lambda: af.apply_ext_call(*app, **kw,
                                                        lists=lists)),
            G=_apply_group(Q, F, Np, dev),
            plain_ms=time_ms(lambda: af.apply_ext_plain(*app, **kw), reps=5,
                             inner=2),
            work=_attention_work_at(Q, F, Np, n_rows, tile, scores,
                                    Q * int(mcol.sum().item()))["apply"],
            support=Q * int(mcol.sum().item())),
    }
    for row in rows.values():
        nbytes, flops_per = row.pop("work")
        support = row.pop("support")
        row["bound_ms"], row["bound_by"] = _attention_bound(
            nbytes, flops_per, support)
        row["bound_ms_dense_tiles"], row["bound_by_dense_tiles"] = (
            _attention_bound(nbytes, flops_per, scores))
        row["bytes"], row["flops"] = nbytes, flops_per * support
        row["support_scores"], row["scores"] = support, scores
        row["library_ms"] = None
    emit(phase="shard_timing", rows=rows,
         library="none: no single PyTorch call computes either function",
         seconds=time.perf_counter() - t_phase)
    return rows


def _windowed_forward(arch, x, sattn):
    """A sharded GAT through the sharded windowed path (plain torch,
    parallel.attention with local_flash=False), layer by layer with the
    model's weights: (readout output, last attention layer's output)."""
    import torch
    from graph_neural_networks_torch.models.layers import _heads_out
    from graph_neural_networks_torch.parallel import attention as sha
    with torch.inference_mode():
        x = torch.as_tensor(x, device=arch.device)[:, :, arch.ctx["order_map"]]
        for layer in arch.core.filters:
            y = sha.sharded_graph_attention(x, layer.mixer, layer.weight,
                                            sattn)
            x = _heads_out(y, layer.nonlinearity, layer.concatenate)
        return arch.core.readout(x.reshape(x.shape[0], -1)), x


def phase_shard_serving(rng, dev):
    """Serve gat_band_n16384 node-sharded over the (1, 4) and (2, 2) meshes
    (the main path of this phase: 8 stats_ext_call + 8 apply_ext_call a
    forward, no global flash launch), each answer against the unsharded
    band-mode model (flash kernels 7-8) and the sharded windowed path;
    then GCAT and EdgeVariantAttention at N = 2048 sharded 4 ways against
    dense mode, and band_n4096 SelectionGNN.shard(mesh, 4) (the ring
    shift on band_matmul) against the unsharded band forward."""
    import torch
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.serving import InferenceEngine
    t_phase = time.perf_counter()
    S, nnz = make_graph(GAT_N, 0.01, 256, seed=1)
    ref = InferenceEngine(_build_gat("GraphAttentionNetwork", S, "band",
                                     dev), GAT_BATCH, dev)
    requests = [rng.standard_normal((n, GAT_DIMS[0], GAT_N)).astype(
        np.float32) for n in SHARD_REQUESTS]
    with torch.inference_mode():
        want = [(ref(x), ref.arch.split_forward(x)[1]) for x in requests]
    checks, launches, engines = [], {}, {}

    def check(model, x, against, got, want, **extra):
        for what, g, w in zip(("y", "y_gfl"), got, want):
            max_abs, max_rel, ok = compare(g, w, SERVE_RTOL, SERVE_ATOL_REL)
            checks.append(dict(model=model, batch=x.shape[0], output=what,
                               against=against, max_abs_err=max_abs,
                               max_rel_err=max_rel,
                               max_abs_ref=w.abs().max().item(), ok=ok,
                               **extra))
            require(ok, f"{model} batch {x.shape[0]}: {what} disagrees with "
                        f"{against}: {max_abs}")

    for shape, data_axis in SHARD_MESHES:
        label = f"gat_band_n16384 mesh {shape}"
        mesh = par.make_mesh(shape, devices=[dev] * 4)
        arch = _build_gat("GraphAttentionNetwork", S, "dense", dev)
        t0 = time.perf_counter()
        arch.shard(mesh, shape[1], data_axis=data_axis)
        part = arch.S.partition
        sattn = arch.S.band_attention
        torch.cuda.synchronize()
        t_shard = time.perf_counter() - t0
        require(sattn.use_flash, f"{label}: the flash schedule is off")
        eng = InferenceEngine(arch, GAT_BATCH, mesh.home)
        require(eng.arch.S is arch.S, f"{label}: the engine moved the GSO")
        # the main path: counts set to 0 just before, read just after
        _reset_counts()
        t0 = time.perf_counter()
        with _cached_structure(label):
            answers = [eng(x) for x in requests]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _attention_counts()
        per_forward = {k: v / len(requests) for k, v in counts.items()}
        expected = {k: 0 for k in counts}
        expected.update(stats_ext_call=8, apply_ext_call=8)
        require(per_forward == expected,
                f"{label}: launches per forward {per_forward}, expected "
                f"{expected}")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        windowed = par.ShardedBandAttention(mesh, part, data_axis=data_axis,
                                            local_flash=False)
        for x, y, (y_ref, gfl_ref) in zip(requests, answers, want):
            require(tuple(y.shape) == (x.shape[0], 4) and bool(
                torch.isfinite(y).all()), f"{label}: output {tuple(y.shape)}")
            with torch.inference_mode():
                gfl = eng.arch.split_forward(x)[1]
            check(label, x, "unsharded band (kernels 7-8)", (y, gfl),
                  (y_ref, gfl_ref))
            check(label, x, "sharded windowed", (y, gfl),
                  _windowed_forward(eng.arch, x, windowed))
        emit(phase="shard_serving", model=label, nnz=nnz,
             n_parts=part.n_parts, block=part.block_size, ibs=part.inner_bs,
             nbl=part.nbl, w=part.w, halo=part.halo,
             slab_mib=part.slabs.nbytes / 2 ** 20, seconds_shard=t_shard,
             requests=list(SHARD_REQUESTS), seconds=seconds, launches=counts,
             launches_per_forward=per_forward)
        engines[shape] = eng
        del windowed

    # N = 2048: sharded 4 ways (block 512, nbl 4) against dense mode
    S2, _ = make_graph(GAT_SMALL_N, 0.01, 256, seed=1)
    mesh = par.make_mesh((1, SHARD_PARTS), devices=[dev] * SHARD_PARTS)
    small = [("GraphConvolutionAttentionNetwork", [64, 16, 16], [2, 2],
              [3, 2]),
             ("EdgeVariantAttention", [32, 16], [2], [3])]
    for cls_name, dims, heads, taps in small:
        dense = InferenceEngine(
            _build_gat(cls_name, S2, "dense", dev, dims, heads, taps),
            GAT_BATCH, dev)
        sharded = _build_gat(cls_name, S2, "dense", dev, dims, heads, taps)
        sharded.shard(mesh, SHARD_PARTS)
        eng = InferenceEngine(sharded, GAT_BATCH, dev)
        xs = [rng.standard_normal((n, dims[0], GAT_SMALL_N)).astype(
            np.float32) for n in (GAT_BATCH, 3)]
        _reset_counts()
        got = [eng(x) for x in xs]
        counts = _attention_counts()
        require(counts["stats_ext_call"] > 0 and counts["apply_ext_call"] > 0
                and counts["stats_call"] == counts["apply_call"] == 0,
                f"{cls_name}: launches {counts}")
        for x, y in zip(xs, got):
            with torch.inference_mode():
                gfl = eng.arch.split_forward(x)[1]
                ref_out = dense.arch.split_forward(x)
            check(f"{cls_name} N={GAT_SMALL_N} sharded "
                  f"w={sharded.S.partition.w}", x, "dense", (y, gfl),
                  ref_out, launches=counts)

    # band_n4096: the ring shift's local contraction on band_matmul
    rng4 = np.random.default_rng(0)
    S4 = banded_graph(rng4, N_GRAPH, 256, 0.05)
    unsharded = InferenceEngine(_build_model(S4, "band", dev), BATCH, dev)
    arch4 = _build_model(S4, "band", dev).shard(mesh, SHARD_PARTS)
    part4 = arch4.S.partition
    eng4 = InferenceEngine(arch4, BATCH, dev)
    xs = [rng.standard_normal((n, 1, N_GRAPH)).astype(np.float32)
          for n in (BATCH, 17, 1)]
    _reset_counts()
    got = [eng4(x) for x in xs]
    torch.cuda.synchronize()
    counts = _attention_counts()
    per_forward = {k: v / len(xs) for k, v in counts.items()}
    expected = {k: 0 for k in counts}
    expected.update(band_matmul=2 * (TAPS - 1) * SHARD_PARTS)
    require(per_forward == expected,
            f"band_n4096 sharded: launches per forward {per_forward}, "
            f"expected {expected}")
    for x, y in zip(xs, got):
        max_abs, max_rel, ok = compare(y, unsharded(x), SERVE_RTOL,
                                       SERVE_ATOL_REL)
        checks.append(dict(model="band_n4096 sharded", batch=x.shape[0],
                           output="y", against="unsharded band",
                           max_abs_err=max_abs, max_rel_err=max_rel, ok=ok))
        require(ok, f"band_n4096 sharded batch {x.shape[0]} disagrees with "
                    f"the unsharded band forward: {max_abs}")
    emit(phase="shard_serving", model="band_n4096 mesh (1, 4)",
         block=part4.block_size, ibs=part4.inner_bs, nbl=part4.nbl,
         w=part4.w, launches=counts, launches_per_forward=per_forward)
    emit(phase="shard_serving_check", rtol=SERVE_RTOL,
         atol=f"{SERVE_ATOL_REL}*max|reference|", checks=checks,
         seconds=time.perf_counter() - t_phase)
    profiles = [("gat_band_n16384 unsharded", ref, requests[0])]
    profiles += [(f"gat_band_n16384 sharded mesh {shape}", eng, requests[0])
                 for shape, eng in engines.items()]
    profiles += [("band_n4096 band unsharded", unsharded, xs[0]),
                 ("band_n4096 sharded mesh (1, 4)", eng4, xs[0])]
    return launches, engines, profiles


def phase_shard_profile(profiles):
    """One sharded forward beside the unsharded one of the same model
    (gat_band_n16384, band_n4096): host ms, device ms, idle share and top
    device ops."""
    for label, eng, x in profiles:
        _profile_forward(label, eng, x)


# ---------------------------------------------------------------------------
# Node-sharded training (kernel 12: the shard-local flash backward)
# ---------------------------------------------------------------------------

# A sharded model's first-step gradients against the unsharded band
# model's (same weights, same batch): the flash kernels walk each shard's
# row tiles in the unsharded kernels' order (da2 and dv the same sums; da1
# and the ring shift's halo terms are folded in another order at the shard
# edges), so rtol 1e-5, atol 1e-6*max|unsharded|, both on the unsharded
# model's ReLU gates (_shared_gates); the losses of 8 Adam steps within
# LOSS_RTOL, as the unsharded training. The ring shift sums
# other products in another order (the square local band plus the halo
# corrections against the whole band, and the register kernel in the
# unsharded layers), so a tap gradient, a sum of B*N = 131072
# products, is held to atol 1e-5*max|unsharded| (1e-5 relative to its
# largest entry).
SHARD_GRAD_RTOL = 1e-5
SHARD_GRAD_ATOL_REL = 1e-6
SHARD_SHIFT_GRAD_ATOL_REL = 1e-5


@contextlib.contextmanager
def _attention_inputs(record):
    """Within the block every flash attention application, sharded
    (ShardedBandAttention.apply) or not (attention_flash.flash_apply),
    appends its (a1x, a2x, v) to `record`, so that their gradients can be
    asked for."""
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.parallel import attention as sha
    flash_apply, sharded_apply = af.flash_apply, sha.ShardedBandAttention.apply

    def flash(a1x, a2x, v, *args, **kw):
        record.append((a1x, a2x, v))
        return flash_apply(a1x, a2x, v, *args, **kw)

    def sharded(self, a1x, a2x, v, *args, **kw):
        record.append((a1x, a2x, v))
        return sharded_apply(self, a1x, a2x, v, *args, **kw)
    af.flash_apply, sha.ShardedBandAttention.apply = flash, sharded
    try:
        yield record
    finally:
        af.flash_apply = flash_apply
        sha.ShardedBandAttention.apply = sharded_apply


@contextlib.contextmanager
def _shared_gates(arch, gates, flips):
    """Within the block every filter layer of `arch` applies its ReLU as
    the product with a gate (pre-activation > 0), recorded into `gates`
    when it comes empty, else taken from it (adding to flips[0] the
    entries where this model's own gate differs): two models then
    differentiate the same linear piece of the network. A gate within f32
    rounding of 0 may flip between two paths that sum in another order,
    and then moves a weight gradient by ~1e-3 of its max. Attention layers
    apply their own nonlinearity (_relu_gates); a graph-filter core
    applies core.sigma once a filter layer."""
    if arch.core.filter_kind != "graph_filter":
        with _relu_gates(arch, gates):
            yield
        return
    core, record, calls = arch.core, not gates, iter(range(1 << 30))

    def act(t):
        i = next(calls)
        if record:
            gates.append(t > 0)
        else:
            flips[0] += int(((t > 0) != gates[i]).sum())
        return t * gates[i].to(t.dtype)
    saved, core.sigma = core.sigma, act
    try:
        yield
    finally:
        core.sigma = saved


def _step_grads(arch, data, batch, gates, inputs=(0, 1, 2)):
    """One CE step's gradients on the Trainer's first batch, on the ReLU
    gates of `gates` (_shared_gates): of every parameter, then of each
    attention application's a1x, a2x and v (`inputs` picks among them;
    those that need a gradient); the kernel launches of the step, counted
    from 0; and the gates where this model's own forward differs."""
    import torch
    from graph_neural_networks_torch.training import losses
    idx = np.random.default_rng(0).permutation(data.nTrain)[:batch]
    x, y = data.getSamples("train", idx)
    record, flips = [], [0]
    _reset_counts()
    with _shared_gates(arch, gates, flips), _attention_inputs(record):
        loss = losses.cross_entropy_loss(
            arch.split_forward(x)[0], torch.as_tensor(y, device=arch.device))
    wrt = list(arch.parameters()) + [ts[i] for ts in record for i in inputs
                                     if ts[i].requires_grad]
    grads = torch.autograd.grad(loss, wrt)
    torch.cuda.synchronize()
    return loss.item(), grads, _attention_counts(), flips[0]


def _check_shard_grads(checks, model, got, want,
                       atol_rel=SHARD_GRAD_ATOL_REL, against="unsharded band"):
    """Sharded gradients against the unsharded model's; counts those equal
    bit for bit."""
    import torch
    require(len(got) == len(want), f"{model}: {len(got)} gradients against "
                                   f"{len(want)}")
    equal = 0
    for i, (g, r) in enumerate(zip(got, want)):
        max_abs, max_rel, ok = compare(g, r, SHARD_GRAD_RTOL, atol_rel)
        equal += bool(torch.equal(g, r))
        checks.append(dict(model=model, against=against, grad=i,
                           max_abs_err=max_abs, max_rel_err=max_rel,
                           max_abs_ref=r.abs().max().item(),
                           atol=f"{atol_rel}*max|unsharded|",
                           bit_equal=bool(torch.equal(g, r)), ok=ok))
        require(ok, f"{model}: gradient {i} disagrees with the {against} "
                    f"model's: max abs {max_abs}, max rel {max_rel}")
    return equal


def phase_shard_training(rng, dev, out_dir):
    """Train node-sharded models through Model -> Trainer(mesh=...) ->
    loss -> backward -> Adam (the main path of this phase): gat_band_n16384
    over the (1, 4) and (2, 2) meshes, each step 8 bwd_ext_call + 8
    stats_ext_call + 8 apply_ext_call launches and no global flash launch;
    first-step gradients of every parameter and of every layer's a1x, a2x
    and v against the unsharded band model (kernels 7-9), and the losses
    of 8 Adam steps against its trajectory. Then GCAT and
    EdgeVariantAttention at N = 2048 sharded 4 ways (kernel 12 with and
    without S) and band_n4096 sharded 4 ways (the ring shift's backward on
    band_matmul: 32 launches a forward, 16 a backward) against their
    unsharded band models."""
    from graph_neural_networks_torch import parallel as par
    t_phase = time.perf_counter()
    checks, launches, trained = [], {}, {}

    def train(model, data, batch, expected, **kw):
        out, counts, seconds = _train_counts(model, data, batch, expected,
                                             **kw)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        return out, counts, seconds

    def vs_reference(label, unsharded, sharded, data, batch, per_step,
                     per_fwd, meshes, atol_rel=SHARD_GRAD_ATOL_REL):
        """The unsharded band model's first-step gradients and trajectory,
        then each sharded model's (sharded(mesh)) against them."""
        ref, gates = unsharded(), []
        _, want, _, _ = _step_grads(ref, data, batch, gates)
        ref_model = _model(ref, f"{label}_unsharded", out_dir)
        ref_out, _, _ = _train_counts(ref_model, data, batch)
        trained[f"{label} unsharded"] = (ref_model, data, batch)
        for mesh, kw in meshes:
            name = f"{label} mesh {tuple(mesh.devices.shape)}"
            arch = sharded(mesh)
            loss, got, counts, flips = _step_grads(arch, data, batch, gates)
            step = {k: 0 for k in counts}
            step.update(per_step)
            require(counts == step, f"{name}: launches in a step {counts}, "
                                    f"expected {step}")
            equal = _check_shard_grads(checks, name, got, want, atol_rel)
            model = _model(arch, name.replace(" ", "_"), out_dir)
            n_val = 1   # validation at step 0 only: one forward
            expected = {k: TRAIN_STEPS * n + n_val * per_fwd.get(k, 0)
                        for k, n in step.items()}
            out, counts, seconds = train(model, data, batch, expected,
                                         mesh=mesh, **kw)
            ok = bool(np.allclose(out["lossTrain"], ref_out["lossTrain"],
                                  rtol=LOSS_RTOL, atol=0))
            checks.append(dict(model=name, against="unsharded band",
                               losses=out["lossTrain"].tolist(),
                               unsharded_losses=ref_out["lossTrain"].tolist(),
                               ok=ok, launches=counts, seconds=seconds,
                               step_ms=(np.asarray(out["timeTrain"])
                                        * 1e3).tolist()))
            require(ok, f"{name}: losses {out['lossTrain']} vs unsharded "
                        f"{ref_out['lossTrain']}")
            emit(phase="shard_training", model=name, batch=batch,
                 trainer_kwargs=dict(mesh=str(mesh), **kw),
                 first_step_loss=loss, grads=len(got),
                 grads_bit_equal=equal, relu_gates_flipped=flips,
                 launches_per_step=per_step,
                 launches=counts, steps=TRAIN_STEPS, seconds=seconds)
            trained[name] = (model, data, batch)

    S, _ = make_graph(GAT_N, 0.01, 256, seed=1)
    gat_data = _synthetic_data(rng, (TRAIN_STEPS * GAT_BATCH, GAT_BATCH,
                                     GAT_BATCH), GAT_DIMS[0], GAT_N, 4)
    meshes = [(par.make_mesh(shape, devices=[dev] * SHARD_PARTS),
               dict(meshAxis="data") if data_axis else {})
              for shape, data_axis in SHARD_MESHES]

    def shard_gat(arch, mesh):
        n = mesh.shape["graph"]
        data_axis = "data" if mesh.shape["data"] > 1 else None
        arch.shard(mesh, n, data_axis=data_axis)
        require(arch.S.band_attention.use_flash,
                f"{mesh}: the flash schedule is off")
        return arch
    flash = dict(stats_ext_call=8, apply_ext_call=8)
    vs_reference("gat_band_n16384",
                 lambda: _build_gat("GraphAttentionNetwork", S, "band", dev),
                 lambda mesh: shard_gat(_build_gat(
                     "GraphAttentionNetwork", S, "dense", dev), mesh),
                 gat_data, GAT_BATCH, dict(flash, bwd_ext_call=8), flash,
                 meshes)

    # GCAT and EdgeVariantAttention at N = 2048, sharded 4 ways: first-step
    # gradients (kernel 12 with S, and without it in GCAT's taps)
    S2, _ = make_graph(GAT_SMALL_N, 0.01, 256, seed=1)
    mesh4 = meshes[0][0]
    # (GCAT's v: the unsharded taps hand the stacked tensor itself to the
    # next shift, the sharded ones a view of it, so the gradients of those
    # two objects cover different uses; its a1x and a2x are compared)
    small = [("GraphConvolutionAttentionNetwork", [64, 16, 16], [2, 2],
              [3, 2], (0, 1)),
             ("EdgeVariantAttention", [32, 16], [2], [3], (0, 1, 2))]
    for cls_name, dims, heads, taps, inputs in small:
        data = _synthetic_data(rng, (GAT_BATCH, GAT_BATCH, GAT_BATCH),
                               dims[0], GAT_SMALL_N, 4)

        def build(mode="band"):
            return _build_gat(cls_name, S2, mode, dev, dims, heads, taps)
        gates = []
        _, want, _, _ = _step_grads(build(), data, GAT_BATCH, gates, inputs)
        arch = shard_gat(build("dense"), mesh4)
        _, got, counts, flips = _step_grads(arch, data, GAT_BATCH, gates,
                                            inputs)
        require(counts["bwd_ext_call"] > 0 and counts["bwd_call"] == 0
                and counts["stats_call"] == counts["apply_call"] == 0,
                f"{cls_name}: launches {counts}")
        name = (f"{cls_name} N={GAT_SMALL_N} sharded "
                f"w={arch.S.partition.w}")
        equal = _check_shard_grads(checks, name, got, want)
        emit(phase="shard_training", model=name, grads=len(got),
             grads_bit_equal=equal, relu_gates_flipped=flips,
             launches_per_step=counts)

    # band_n4096: the ring shift's backward, 4 shards
    S4 = banded_graph(np.random.default_rng(0), N_GRAPH, 256, 0.05)
    sel_data = _synthetic_data(rng, (TRAIN_STEPS * BATCH, BATCH, BATCH), 1,
                               N_GRAPH, 5)
    shifts = 2 * (TAPS - 1) * SHARD_PARTS   # 2 layers, K - 1 shifts a shard
    # backward: only the second layer's shifts act on an input that needs
    # a gradient; the first layer's act on the data
    vs_reference("band_n4096", lambda: _build_model(S4, "band", dev),
                 lambda mesh: _build_model(S4, "band", dev).shard(
                     mesh, SHARD_PARTS),
                 sel_data, BATCH,
                 dict(band_matmul=shifts + shifts // 2),
                 dict(band_matmul=shifts), meshes[:1],
                 SHARD_SHIFT_GRAD_ATOL_REL)
    emit(phase="shard_training_check", rtol=SHARD_GRAD_RTOL,
         loss_rtol=LOSS_RTOL, checks=checks,
         seconds=time.perf_counter() - t_phase)
    return launches, trained


def phase_shard_train_kernels(part, mc, mr, rng, dev):
    """bwd_ext_call against bwd_ext_plain on the card, on operands
    halo-extended from real neighbour shards: at the served shard shape
    (Q = 16, F = 32, Np = 4096, w = 2, ibs = 128) for the first, an
    interior and the last shard, with_s True and False, on a ragged
    4-shard partition (N = 2000, 48 padded nodes, F = 40) and on
    partitions with w = 1 and 3. Then every served-shape shard's
    backward, folded and halo-folded, against the global bwd_call (kernel
    9) on the same operands: da2 and dv are expected bit-equal, da1
    within ulps."""
    import torch
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.parallel.mesh import halo_ext, halo_fold
    t_phase = time.perf_counter()
    results, errs = [], {}

    def check(case, got, want, served):
        max_abs, max_rel, ok = compare(got, want)
        results.append(dict(kernel="bwd_ext_call", case=case,
                            max_abs_err=max_abs, max_rel_err=max_rel,
                            max_abs_plain=want.abs().max().item(), ok=ok))
        if served:
            errs["bwd_ext_call"] = max(errs.get("bwd_ext_call", 0.0), max_abs)
        require(ok and bool(torch.isfinite(got).all()),
                f"bwd_ext_call [{case}] disagrees with its plain version: "
                f"max abs {max_abs}, max rel {max_rel}")

    def run(label, part, mc, mr, Q, F, served):
        w, ibs, halo = part.w, part.inner_bs, part.halo
        own, ext, masks = _shard_operands(rng, dev, part, Q, F, mc, mr)
        bs = part.block_size
        g = _attn_operands(rng, dev, Q, F, part.n_orig, part.n_padded)[2]
        g_ext = halo_ext([g[..., p * bs:(p + 1) * bs].contiguous()
                          for p in range(part.n_parts)], halo)
        slabs = par.attention._ext_slabs(part)[:, 0]
        stats = [af.stats_ext_plain(ext["a1"][p], own["a2"][p], masks[p][1],
                                    w=w, ibs=ibs)
                 for p in range(part.n_parts)]

        def operands(p):
            return (ext["a1"][p], own["a2"][p], own["v"][p], *stats[p],
                    torch.as_tensor(slabs[p], device=dev), masks[p][1],
                    g_ext[p])
        for p in sorted({0, 1, part.n_parts - 1}):
            args = operands(p)
            for ws in (True, False):
                got = af.bwd_ext_call(*args, w=w, ibs=ibs, with_s=ws)
                torch.cuda.synchronize()
                want = af.bwd_ext_plain(*args, w=w, ibs=ibs, with_s=ws)
                for what, t, r in zip(("da2", "da1p", "dv"), got, want):
                    check(f"{label} shard {p}/{part.n_parts} with_s={ws} "
                          f"{what}", t, r, served)
                del got, want
        if not served:
            return
        # every shard against the global kernel 9 on the same operands
        outs = [af.bwd_ext_call(*operands(p), w=w, ibs=ibs)
                for p in range(part.n_parts)]
        sharded = [torch.cat(ts, dim=-1) for ts in (
            [o[0] for o in outs],
            halo_fold([af.fold_ext_partials(o[1]) for o in outs], halo),
            [o[2] for o in outs])]

        def glob(ts):
            return torch.cat(ts, dim=-1)
        da2, da1p, dv = af.bwd_call(
            glob(own["a1"]), glob(own["a2"]), glob(own["v"]),
            glob([s[0] for s in stats]), glob([s[1] for s in stats]),
            torch.as_tensor(np.concatenate(list(part.slabs[:, 0])),
                            device=dev),
            torch.as_tensor(np.concatenate(list(mr)), device=dev), g,
            w=w, ibs=ibs)
        torch.cuda.synchronize()
        for what, t, r in zip(("da2", "da1", "dv"), sharded,
                              (da2, af.fold_window_partials(da1p, w), dv)):
            max_abs, max_rel, ok = compare(t, r)
            results.append(dict(kernel="bwd_ext_call", case=(
                f"{label} all shards, folded, against bwd_call {what}"),
                max_abs_err=max_abs, max_rel_err=max_rel,
                bit_equal=bool(torch.equal(t, r)), ok=ok))
            require(ok, f"sharded backward against bwd_call: {what} max abs "
                        f"{max_abs}")

    run(f"served Q=16 F=32 Np={part.block_size} w={part.w}", part, mc, mr,
        GAT_BATCH * GAT_HEADS[0], GAT_DIMS[1], True)
    S2, _ = make_graph(2000, 0.01, 256, seed=2)
    part2 = par.partition_nodes(S2, SHARD_PARTS, order="none")
    require(part2.is_ring and part2.n_padded > part2.n_orig,
            f"ragged case: w={part2.w}, nbl={part2.nbl}")
    run(f"ragged N=2000 Q=3 F=40 Np={part2.block_size} w={part2.w}", part2,
        *par.attention._row_col_masks(part2), 3, 40, False)
    # narrower and wider windows over 4 shards of 1024 (w = 1, 3, 7; the
    # first and last shards' halos past the global ends are fully masked
    # rows), with Q and F across the apply kernel's groups
    for bandwidth, w, Q, F in ((100, 1, 4, 32), (300, 3, 4, 32),
                               (300, 3, 1, 64), (850, 7, 7, 8),
                               (850, 7, 5, 64)):
        S3, _ = make_graph(4096, 0.01, bandwidth, seed=3)
        part3 = par.partition_nodes(S3, SHARD_PARTS, order="none")
        require(part3.is_ring and part3.w == w, f"w={part3.w}, expected {w}")
        run(f"N=4096 Q={Q} F={F} Np={part3.block_size} w={w}", part3,
            *par.attention._row_col_masks(part3), Q, F, False)
    emit(phase="shard_train_kernels", rtol=RTOL,
         atol=f"{ATOL_REL}*max|plain|", checks=results,
         seconds=time.perf_counter() - t_phase)
    return errs


def phase_shard_train_timing(part, mc, mr, dev):
    """bwd_ext_call at the served shard shape (an interior shard of
    gat_band_n16384 over 4: Q = 16, F = 32, with_s) beside its plain
    version and its bound: the bytes of its operands and outputs, each
    once, and its operations on that shard's S+I support (halo columns
    included), the larger; the dense-tile figure beside it. No single
    PyTorch call computes the function."""
    import torch
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.parallel.mesh import halo_ext
    t_phase = time.perf_counter()
    Q, F = GAT_BATCH * GAT_HEADS[0], GAT_DIMS[1]
    w, ibs, Np, nbl = part.w, part.inner_bs, part.block_size, part.nbl
    W = 2 * w + 1
    rng = np.random.default_rng(7)
    own, ext, masks = _shard_operands(rng, dev, part, Q, F, mc, mr)
    g = _attn_operands(rng, dev, Q, F, part.n_orig, part.n_padded)[2]
    p = 1
    g_ext = halo_ext([g[..., q * Np:(q + 1) * Np].contiguous()
                      for q in range(part.n_parts)], part.halo)[p]
    mrow = masks[p][1]
    mx, sm = af.stats_ext_plain(ext["a1"][p], own["a2"][p], mrow, w=w,
                                ibs=ibs)
    slab = torch.as_tensor(par.attention._ext_slabs(part)[p, 0], device=dev)
    args = (ext["a1"][p], own["a2"][p], own["v"][p], mx, sm, slab, mrow,
            g_ext)
    kw = dict(w=w, ibs=ibs)
    n_rows = Np + 2 * part.halo
    tile = nbl * W * ibs * ibs
    # g_ext and v in, dv out; a1_ext, a2, rowmax, rowsum in, da2 out;
    # mask_row and the slab's row window in; the da1 partials out
    nbytes = 4 * (Q * F * (n_rows + 2 * Np) + Q * n_rows + 4 * Q * Np
                  + 2 * tile + Q * nbl * W * ibs)
    flops_per = 4 * F + 20   # as bwd_call's (phase_train_timing)
    support = Q * int(mrow.sum().item())
    scores = Q * tile
    row = dict(shape=(f"Q={Q} F={F} Np={Np} (+2*{part.halo} halo) w={w} "
                      f"ibs={ibs} with_s"),
               ms=time_ms(lambda: af.bwd_ext_call(*args, **kw)),
               plain_ms=time_ms(lambda: af.bwd_ext_plain(*args, **kw),
                                reps=5, inner=2),
               library_ms=None, bytes=nbytes, flops=flops_per * support,
               support_scores=support, scores=scores)
    row["bound_ms"], row["bound_by"] = _attention_bound(nbytes, flops_per,
                                                        support)
    row["bound_ms_dense_tiles"], row["bound_by_dense_tiles"] = (
        _attention_bound(nbytes, flops_per, scores))
    emit(phase="shard_train_timing", bwd_ext_call=row,
         library="none: no single PyTorch call computes the function",
         seconds=time.perf_counter() - t_phase)
    return {"bwd_ext_call": row}


# ---------------------------------------------------------------------------
# The rest of single-controller parallel/: scattered-graph BCSR sharding
# (kernel 1 on one shard's rectangular column slice), the all-gather shift
# (kernel 3), the row-sharded ELL GSO and the sharded swarm (kernels 5-6
# per shard)
# ---------------------------------------------------------------------------

# scattered_n4096_sharded: band_n4096's SelectionGNN([1,64,64], [5,5]),
# bcsr mode, batch 32 (experiments/bench_bf16_train.py:51-57), on a
# scattered N = 4096 graph built as __graft_entry__.py:176-188 builds its
# dry run's, at the size of experiments/bench_shardmap_tpu.py:122-130:
# 3 * nb pairs of inner_block x inner_block blocks at 30% fill (inner
# block 128: 96 pairs), symmetric, eig-normalized. Sharded 4 ways on one
# card (mesh (1, 4)) with partition_nodes_bcsr, ctx["S"] swapped for the
# ShardedGso as shard() does with order="none". The unsharded bcsr model
# is the reference.
SCATTER_IBS = 128
# flock_n262k over a (1, 4) mesh of the one card: its costs against
# Flocking.rollout_cost, its trajectories against mesh (1, 1). The
# sharded lambda sums the shards' partials (JAX's psum) in another order
# than one shard, and the swarm then drifts apart over the steps: held to
# rtol 1e-4 (costs) and rtol 1e-4 with 1e-5 of the largest value
# (trajectories), as the JAX package's sharded tests hold theirs.
SWARM_RTOL = 1e-4
SWARM_ATOL_REL = 1e-5


def scattered_graph(rng, N, ibs):
    """The scattered graph of __graft_entry__.py:176-188 at N nodes."""
    nbk = N // ibs
    S = np.zeros((N, N), np.float32)
    for _ in range(3 * nbk):
        bi, bj = rng.integers(0, nbk, 2)
        blk = rng.random((ibs, ibs)) * (rng.random((ibs, ibs)) > .7)
        S[bi * ibs:(bi + 1) * ibs, bj * ibs:(bj + 1) * ibs] = blk
        S[bj * ibs:(bj + 1) * ibs, bi * ibs:(bi + 1) * ibs] = blk.T
    S /= max(np.max(np.abs(np.linalg.eigvalsh(S))), 1e-6)
    return S


def _bcsr_sharded_model(S, part, mesh, dev):
    """scattered_n4096's model with ctx["S"] a ShardedGso over the BCSR
    partition (as shard() installs its ring one)."""
    from graph_neural_networks_torch import parallel as par
    arch = _build_model(S, "bcsr", dev)
    arch.ctx["S"] = arch.S = par.ShardedGso(mesh, part)
    require(not arch.S.uses_ring, "the BCSR partition took the ring shift")
    return arch


def phase_shard_bcsr_kernels(part, rng, dev):
    """Kernel 1 on the rectangular layouts of scattered_n4096's shards (the
    BCSR shift's shard-local contraction): forward x (R, 4096) -> (R, 1024)
    on a shard's blocks and backward g (R, 1024) -> (R, 4096) on its
    transposed blocks, pad blocks included, at the served rows (2048, 32,
    17, 1) on every shard, against bcsr_matmul_plain; then both directions
    timed at R = 2048 on the shard with the most real blocks beside the
    plain version, one torch.matmul on the dense column slice and the
    bound of that shard's real blocks."""
    import torch
    from graph_neural_networks_torch.ops import spmm
    results, errs, rows = [], {}, {}
    bs, ibs, Np = part.block_size, part.inner_bs, part.n_padded
    S_perm = torch.as_tensor(part.S_perm[0], device=dev)

    def layout(p):
        on = lambda a: torch.as_tensor(a, device=dev)
        bl, br, bc = on(part.blocks[p, 0]), on(part.brow[p, 0]), \
            on(part.bcol[p, 0])
        blt, brt, bct = on(part.blocks_t[p, 0]), on(part.brow_t[p, 0]), \
            on(part.bcol_t[p, 0])
        return (bl, br, bc, spmm.bcsr_col_start(bc, bs, ibs),
                blt, brt, bct, spmm.bcsr_col_start(bct, Np, ibs))

    def check(case, got, want, rtol=RTOL, atol_rel=ATOL_REL):
        max_abs, max_rel, ok = compare(got, want, rtol, atol_rel)
        results.append(dict(kernel="bcsr_matmul", case=case,
                            max_abs_err=max_abs, max_rel_err=max_rel, ok=ok))
        if rtol == RTOL:
            errs["bcsr_matmul"] = max(errs.get("bcsr_matmul", 0.0), max_abs)
        require(ok, f"bcsr_matmul [{case}] disagrees with its reference: "
                    f"max abs {max_abs}, max rel {max_rel}")

    x = torch.as_tensor(rng.standard_normal((2048, Np)).astype(np.float32),
                        device=dev)
    g = torch.as_tensor(rng.standard_normal((2048, bs)).astype(np.float32),
                        device=dev)
    real = [int(part.nnzb[p]) for p in range(part.n_parts)]
    for p in range(part.n_parts):
        bl, br, bc, cs, blt, brt, bct, cst = layout(p)
        pads = bl.shape[0] - real[p], blt.shape[0] - int(
            (part.blocks_t[p, 0].reshape(blt.shape[0], -1) != 0).any(1).sum())
        for R in (2048, 32, 17, 1):
            check(f"shard {p} fwd R={R} {Np}->{bs} nnzb={bl.shape[0]} "
                  f"({pads[0]} pad)",
                  spmm.bcsr_matmul(x[:R], bl, br, bc, n_cols=bs,
                                   block_size=ibs, col_start=cs),
                  spmm.bcsr_matmul_plain(x[:R], bl, br, bc, n_cols=bs,
                                         block_size=ibs))
            check(f"shard {p} bwd R={R} {bs}->{Np} nnzb={blt.shape[0]} "
                  f"(~{pads[1]} pad)",
                  spmm.bcsr_matmul(g[:R], blt, brt, bct, n_cols=Np,
                                   block_size=ibs, col_start=cst),
                  spmm.bcsr_matmul_plain(g[:R], blt, brt, bct, n_cols=Np,
                                         block_size=ibs))
    # all shards' column slices against the dense product (which sums the
    # zeros of S too: held as serving holds bcsr against dense mode)
    check("all shards, fwd R=2048 against x @ S (dense)",
          torch.cat([spmm.bcsr_matmul(x, *layout(p)[:3], n_cols=bs,
                                      block_size=ibs)
                     for p in range(part.n_parts)], dim=1), x @ S_perm,
          SERVE_RTOL, SERVE_ATOL_REL)
    p = int(np.argmax(real))
    bl, br, bc, cs, blt, brt, bct, cst = layout(p)
    S_p = S_perm[:, p * bs:(p + 1) * bs].contiguous()
    S_pt = S_p.t().contiguous()
    R, n = 2048, real[p]
    rows["bcsr_matmul@shard fwd"] = dict(
        shape=f"R={R} {Np}->{bs} nnzb={bl.shape[0]} ({n} real) shard {p}",
        ms=time_ms(lambda: spmm.bcsr_matmul(x, bl, br, bc, n_cols=bs,
                                            block_size=ibs, col_start=cs)),
        graph_ms=graph_ms(lambda: spmm.bcsr_matmul(
            x, bl, br, bc, n_cols=bs, block_size=ibs, col_start=cs)),
        plain_ms=time_ms(lambda: spmm.bcsr_matmul_plain(
            x, bl, br, bc, n_cols=bs, block_size=ibs)),
        library_ms=time_ms(lambda: torch.matmul(x, S_p)),
        library_call="torch.matmul(x, S[:, shard columns] dense), TF32 off",
        flops=2 * R * n * ibs * ibs,
        bytes=4 * (R * Np + R * bs + n * (ibs * ibs + 2)))
    n_t = int((part.blocks_t[p, 0].reshape(blt.shape[0], -1) != 0)
              .any(1).sum())
    rows["bcsr_matmul@shard bwd"] = dict(
        shape=f"R={R} {bs}->{Np} nnzb={blt.shape[0]} ({n_t} real) shard {p}",
        ms=time_ms(lambda: spmm.bcsr_matmul(g, blt, brt, bct, n_cols=Np,
                                            block_size=ibs, col_start=cst)),
        graph_ms=graph_ms(lambda: spmm.bcsr_matmul(
            g, blt, brt, bct, n_cols=Np, block_size=ibs, col_start=cst)),
        plain_ms=time_ms(lambda: spmm.bcsr_matmul_plain(
            g, blt, brt, bct, n_cols=Np, block_size=ibs)),
        library_ms=time_ms(lambda: torch.matmul(g, S_pt)),
        library_call="torch.matmul(g, S[:, shard columns]^T dense), TF32 off",
        flops=2 * R * n_t * ibs * ibs,
        bytes=4 * (R * bs + R * Np + n_t * (ibs * ibs + 2)))
    for row in rows.values():
        row["bound_ms"], row["bound_by"] = _bound(row["bytes"], row["flops"])
    emit(phase="shard_bcsr_kernels", rtol=RTOL, atol=f"{ATOL_REL}*max|plain|",
         real_blocks=real, padded_to=int(part.blocks.shape[2]),
         padded_to_t=int(part.blocks_t.shape[2]), checks=results, rows=rows)
    return errs, rows


def phase_shard_bcsr(S, part, rng, dev, out_dir):
    """scattered_n4096_sharded (the main path of this phase): served through
    InferenceEngine with exactly 32 bcsr_matmul a forward (2 layers x 4
    shifts x 4 shards, on the column slices) against the unsharded bcsr
    model, then its first-step gradients against that model's and 8 Adam
    steps through Model.train(mesh=...) with exactly 48 a step (layer 2's
    backward on the transposed slices) against its losses."""
    import torch
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.serving import InferenceEngine
    t_phase = time.perf_counter()
    mesh = par.make_mesh((1, SHARD_PARTS), devices=[dev] * SHARD_PARTS)
    unsharded = InferenceEngine(_build_model(S, "bcsr", dev), BATCH, dev)
    eng = InferenceEngine(_bcsr_sharded_model(S, part, mesh, dev), BATCH,
                          dev)
    xs = [rng.standard_normal((n, 1, N_GRAPH)).astype(np.float32)
          for n in (BATCH, 17, 1)]
    checks, launches = [], {}
    label = "scattered_n4096 sharded mesh (1, 4)"
    _reset_counts()
    with _cached_structure(label):
        got = [eng(x) for x in xs]
    torch.cuda.synchronize()
    counts = _attention_counts()
    shifts = 2 * (TAPS - 1) * SHARD_PARTS
    per_forward = {k: v / len(xs) for k, v in counts.items()}
    expected = {k: 0 for k in counts}
    expected["bcsr_matmul"] = shifts
    require(per_forward == expected, f"{label}: launches per forward "
                                     f"{per_forward}, expected {expected}")
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    for x, y in zip(xs, got):
        want = unsharded(x)
        max_abs, max_rel, ok = compare(y, want, SERVE_RTOL, SERVE_ATOL_REL)
        checks.append(dict(model=label, batch=x.shape[0], output="y",
                           against="unsharded bcsr", max_abs_err=max_abs,
                           max_rel_err=max_rel,
                           bit_equal=bool(torch.equal(y, want)), ok=ok))
        require(ok and tuple(y.shape) == (x.shape[0], 5),
                f"{label} batch {x.shape[0]} disagrees with the unsharded "
                f"bcsr forward: {max_abs}")
    emit(phase="shard_bcsr", model=label, block=part.block_size,
         ibs=part.inner_bs, real_blocks=part.nnzb.tolist(),
         padded_to=int(part.blocks.shape[2]),
         shard_mib=part.shard_bytes / 2 ** 20, launches=counts,
         launches_per_forward=per_forward)

    data = _synthetic_data(rng, (TRAIN_STEPS * BATCH, BATCH, BATCH), 1,
                           N_GRAPH, 5)
    gates = []
    ref = _build_model(S, "bcsr", dev)
    _, want_g, _, _ = _step_grads(ref, data, BATCH, gates)
    ref_model = _model(ref, "scattered_n4096_unsharded", out_dir)
    ref_out, _, _ = _train_counts(ref_model, data, BATCH)
    arch = _bcsr_sharded_model(S, part, mesh, dev)
    loss, got_g, counts, flips = _step_grads(arch, data, BATCH, gates)
    step = {k: 0 for k in counts}
    step["bcsr_matmul"] = shifts + shifts // 2
    require(counts == step, f"{label}: launches in a step {counts}, "
                            f"expected {step}")
    equal = _check_shard_grads(checks, label, got_g, want_g,
                               SHARD_SHIFT_GRAD_ATOL_REL, "unsharded bcsr")
    model = _model(arch, "scattered_n4096_sharded", out_dir)
    expected = {k: TRAIN_STEPS * n for k, n in step.items()}
    expected["bcsr_matmul"] += shifts          # validation at step 0
    out, counts, seconds = _train_counts(model, data, BATCH, expected,
                                         mesh=mesh)
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    ok = bool(np.allclose(out["lossTrain"], ref_out["lossTrain"],
                          rtol=LOSS_RTOL, atol=0))
    checks.append(dict(model=label, against="unsharded bcsr",
                       losses=out["lossTrain"].tolist(),
                       unsharded_losses=ref_out["lossTrain"].tolist(), ok=ok,
                       launches=counts, seconds=seconds))
    require(ok, f"{label}: losses {out['lossTrain']} vs unsharded "
                f"{ref_out['lossTrain']}")
    emit(phase="shard_bcsr_training", model=label, batch=BATCH,
         first_step_loss=loss, grads=len(got_g), grads_bit_equal=equal,
         relu_gates_flipped=flips, launches_per_step=step, launches=counts,
         steps=TRAIN_STEPS, seconds=seconds)
    emit(phase="shard_bcsr_check", rtol=SHARD_GRAD_RTOL,
         atol=f"{SHARD_SHIFT_GRAD_ATOL_REL}*max|unsharded|",
         serve_rtol=SERVE_RTOL, loss_rtol=LOSS_RTOL, checks=checks,
         seconds=time.perf_counter() - t_phase)
    trained = {"scattered_n4096 bcsr unsharded": (ref_model, data, BATCH),
               label: (model, data, BATCH)}
    profiles = [("scattered_n4096 bcsr unsharded", unsharded, xs[0]),
                (label, eng, xs[0])]
    return launches, trained, profiles


def phase_shard_bcsr_profile(trained, profiles):
    """A served scattered_n4096 forward and a training step, sharded over
    mesh (1, 4) beside the unsharded bcsr model's."""
    for label, eng, x in profiles:
        _profile_forward(label, eng, x)
    phase_train_profile(trained, 6, "shard_bcsr_train_profile")


def phase_shard_allgather(rng, dev):
    """band_n4096_allgather (the main path of this phase): band_n4096
    sharded 4 ways with ShardedGso(prefer_ring=False), each shard gathering
    the node axis and running the ring's local contraction (band_matmul
    on its own block, the halo terms as einsums): exactly 32 band_matmul a
    forward, held against the ring-sharded model's forward; then one
    step's gradients (48 launches) against the ring's. Then the partition
    the all-gather shift exists for, one past the ring: band_n4096 closed
    into a cycle (node 0 ~ node N-1) and partitioned with order "none", so
    the band is w = 31 inner blocks against nbl = 8 a shard (each shard's
    square band crops the halo corrections that overhang it); served and
    stepped with the same exact counts, held against the unsharded bcsr
    model of the same graph."""
    import torch
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.serving import InferenceEngine
    t_phase = time.perf_counter()
    S4 = banded_graph(np.random.default_rng(0), N_GRAPH, 256, 0.05)
    mesh = par.make_mesh((1, SHARD_PARTS), devices=[dev] * SHARD_PARTS)

    def build(ring):
        arch = _build_model(S4, "band", dev).shard(mesh, SHARD_PARTS)
        if not ring:
            arch.ctx["S"] = arch.S = par.ShardedGso(mesh, arch.S.partition,
                                                    prefer_ring=False)
        require(arch.S.uses_ring == ring, "ShardedGso routing")
        return arch
    ring = InferenceEngine(build(True), BATCH, dev)
    eng = InferenceEngine(build(False), BATCH, dev)
    xs = [rng.standard_normal((n, 1, N_GRAPH)).astype(np.float32)
          for n in (BATCH, 17, 1)]
    label = "band_n4096 all-gather mesh (1, 4)"
    _reset_counts()
    got = [eng(x) for x in xs]
    torch.cuda.synchronize()
    counts = _attention_counts()
    shifts = 2 * (TAPS - 1) * SHARD_PARTS
    per_forward = {k: v / len(xs) for k, v in counts.items()}
    expected = {k: 0 for k in counts}
    expected["band_matmul"] = shifts
    require(per_forward == expected, f"{label}: launches per forward "
                                     f"{per_forward}, expected {expected}")
    checks = []
    for x, y in zip(xs, got):
        want = ring(x)
        max_abs, max_rel, ok = compare(y, want, SERVE_RTOL, SERVE_ATOL_REL)
        checks.append(dict(model=label, batch=x.shape[0], output="y",
                           against="ring-sharded", max_abs_err=max_abs,
                           max_rel_err=max_rel,
                           bit_equal=bool(torch.equal(y, want)), ok=ok))
        require(ok, f"{label} batch {x.shape[0]} disagrees with the ring: "
                    f"{max_abs}")
    data = _synthetic_data(rng, (BATCH, BATCH, BATCH), 1, N_GRAPH, 5)
    gates = []
    _, want_g, _, _ = _step_grads(ring.arch, data, BATCH, gates)
    loss, got_g, step_counts, flips = _step_grads(eng.arch, data, BATCH,
                                                  gates)
    step = {k: 0 for k in step_counts}
    step["band_matmul"] = shifts + shifts // 2
    require(step_counts == step, f"{label}: launches in a step "
                                 f"{step_counts}, expected {step}")
    equal = _check_shard_grads(checks, label, got_g, want_g,
                               SHARD_SHIFT_GRAD_ATOL_REL, "ring-sharded")
    launches = {k: counts[k] + step_counts[k] for k in counts}
    emit(phase="shard_allgather", model=label, launches=counts,
         launches_per_forward=per_forward, launches_per_step=step,
         first_step_loss=loss, grads_bit_equal=equal,
         relu_gates_flipped=flips, serve_rtol=SERVE_RTOL,
         grad_rtol=SHARD_GRAD_RTOL,
         grad_atol=f"{SHARD_SHIFT_GRAD_ATOL_REL}*max|ring|", checks=checks,
         seconds=time.perf_counter() - t_phase)

    t_phase = time.perf_counter()
    S_cyc = S4.copy()
    S_cyc[0, -1] = S_cyc[-1, 0] = S4[S4 > 0].mean()
    part = par.partition_nodes(S_cyc, SHARD_PARTS, order="none")
    require(part.w > part.nbl, f"the cycle's partition is a ring: w "
                               f"{part.w}, nbl {part.nbl}")
    cyc = _build_model(S_cyc, "bcsr", dev)
    cyc.ctx["S"] = cyc.S = par.ShardedGso(mesh, part)
    require(not cyc.S.uses_ring, "the cycle took the ring shift")
    unsharded = InferenceEngine(_build_model(S_cyc, "bcsr", dev), BATCH, dev)
    eng = InferenceEngine(cyc, BATCH, dev)
    label = "band_n4096 closed into a cycle, all-gather mesh (1, 4)"
    checks = []
    _reset_counts()
    got = [eng(x) for x in xs]
    torch.cuda.synchronize()
    counts = _attention_counts()
    per_forward = {k: v / len(xs) for k, v in counts.items()}
    require(per_forward == expected, f"{label}: launches per forward "
                                     f"{per_forward}, expected {expected}")
    for x, y in zip(xs, got):
        want = unsharded(x)
        max_abs, max_rel, ok = compare(y, want, SERVE_RTOL, SERVE_ATOL_REL)
        checks.append(dict(model=label, batch=x.shape[0], output="y",
                           against="unsharded bcsr", max_abs_err=max_abs,
                           max_rel_err=max_rel,
                           bit_equal=bool(torch.equal(y, want)), ok=ok))
        require(ok and tuple(y.shape) == (x.shape[0], 5),
                f"{label} batch {x.shape[0]} disagrees with the unsharded "
                f"bcsr forward: {max_abs}")
    gates = []
    _, want_g, _, _ = _step_grads(unsharded.arch, data, BATCH, gates)
    loss, got_g, step_counts, flips = _step_grads(eng.arch, data, BATCH,
                                                  gates)
    require(step_counts == step, f"{label}: launches in a step "
                                 f"{step_counts}, expected {step}")
    equal = _check_shard_grads(checks, label, got_g, want_g,
                               SHARD_SHIFT_GRAD_ATOL_REL, "unsharded bcsr")
    for k in launches:
        launches[k] += counts[k] + step_counts[k]
    emit(phase="shard_allgather_cycle", model=label, w=part.w, nbl=part.nbl,
         ibs=part.inner_bs, launches=counts,
         launches_per_forward=per_forward, launches_per_step=step,
         first_step_loss=loss, grads_bit_equal=equal,
         relu_gates_flipped=flips, serve_rtol=SERVE_RTOL,
         grad_rtol=SHARD_GRAD_RTOL,
         grad_atol=f"{SHARD_SHIFT_GRAD_ATOL_REL}*max|unsharded|",
         checks=checks, seconds=time.perf_counter() - t_phase)
    return launches


def phase_shard_db_training(dev, card):
    """flock_train_n262k_sharded_db (the main path of this phase): the
    first batch's supervision of Flocking.large_device (N = 262144, T = 50,
    ell_degree 32, lam_iters 1; recomputed on kernels 5-6 with exact
    counts), then one LocalGNN_DB([6,64], [3]) step -- forward, MSE,
    backward, Adam -- over shard_ell of its graphs on mesh (1, 4): no kernel
    (the ELL shift is torch code), its loss, output and gradients against
    the same step over the unsharded EllGso; each step's host and device
    ms, idle share and peak memory."""
    import copy

    import torch
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.data import flocking as fl
    from graph_neural_networks_torch.models.architectures_time import (
        LocalGNN_DB)
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    c = FLOCK_TRAIN
    T = len(np.arange(0, c["duration"], 0.01))
    gridwin.reset_launch_counts()
    data = fl.Flocking.large_device(
        c["N"], commRadius=2.0, repelDist=1.0, nTrain=1, nValid=0, nTest=0,
        duration=c["duration"], samplingTime=0.01, ell_degree=c["D"],
        lam_iters=c["lam_iters"], rng=np.random.default_rng(c["seed"]),
        env_grid=True, device=dev)
    x, y, ell, ok, deg = fl.recompute_supervision_grid(
        data.pos["train"], data.vel["train"], 2.0, 1.0,
        fl.EXPERT_ACCEL_MAX, c["D"], True, lam_iters=c["lam_iters"])
    torch.cuda.synchronize()
    counts = _flock_counts()
    one = _recompute_launches(T, c["lam_iters"])
    expected = {k: 2 * n for k, n in one.items()}   # generation + recompute
    require(counts == expected, f"large_device + recompute launches {counts},"
                                f" expected {expected}")
    require(bool(ok) and int(deg) <= c["D"],
            f"recompute: ok {bool(ok)}, largest in-degree {int(deg)}")
    mesh = par.make_mesh((1, SHARD_PARTS), devices=[dev] * SHARD_PARTS)
    sgso = par.shard_ell(ell, mesh)
    net = LocalGNN_DB(c["dims"], c["taps"], True, "tanh", [2], 1,
                      device=dev,
                      generator=torch.Generator().manual_seed(c["wseed"]))
    nets = {"sharded": (net, sgso), "unsharded": (copy.deepcopy(net), ell)}
    opts = {k: torch.optim.Adam(m.parameters(), lr=5e-4)
            for k, (m, _) in nets.items()}

    def step(name):
        model, S = nets[name]
        opts[name].zero_grad()
        out = model(x, S)
        loss = ((out - y) ** 2).mean()
        loss.backward()
        grads = [p.grad.clone() for p in model.parameters()]
        opts[name].step()
        return loss.detach(), out.detach(), grads

    res, rows = {}, {}
    for name in ("sharded", "unsharded"):
        _reset_counts()
        gridwin.reset_launch_counts()
        res[name], peak = _peak_gb(lambda: step(name))
        launched = {k: n for k, n in {**_attention_counts(),
                                      **_flock_counts()}.items() if n}
        require(not launched, f"{name} step launched {launched}")
        rows[name] = dict(peak_gb=peak)
    checks = {}
    (l_s, o_s, g_s), (l_u, o_u, g_u) = res["sharded"], res["unsharded"]
    pairs = [("loss", l_s, l_u), ("output", o_s, o_u)] + [
        (f"grad {n}", a, b) for (n, _), a, b in zip(
            net.named_parameters(), g_s, g_u)]
    for name, a, b in pairs:
        err, rel, agree = compare(a, b, TRAIN_RTOL, TRAIN_ATOL_REL)
        checks[name] = dict(max_abs_err=err, max_rel_err=rel,
                            bit_equal=bool(torch.equal(a, b)))
        require(agree, f"sharded vs unsharded LocalGNN_DB step, {name}: "
                       f"max abs {err}, rel {rel}")
    params = dict(max_abs_diff_after_adam=max(
        (a - b).abs().max().item() for a, b in zip(
            nets["sharded"][0].parameters(),
            nets["unsharded"][0].parameters())))
    for name in ("sharded", "unsharded"):
        prof = _device_profile(lambda: step(name), 3)
        rows[name].update(host_ms_per_step=prof["wall_ms"],
                          profiled_host_ms_per_step=prof["profiled_wall_ms"],
                          device_ms_per_step=prof["device_ms"],
                          device_idle_share=prof["device_idle_share"],
                          top=[dict(name=t["name"], ms_per_step=t["ms"],
                                    calls_per_step=t["calls"])
                               for t in prof["top"][:5]])
    emit(phase="shard_db_training", nvidia_smi=card,
         config="flock_train_n262k_sharded_db mesh (1, 4)", N=c["N"], T=T,
         D=c["D"], largest_in_degree=int(deg), launches=counts,
         rtol=TRAIN_RTOL, atol=f"{TRAIN_ATOL_REL}*max|unsharded|",
         checks=checks, params=params, steps=rows,
         seconds=time.perf_counter() - t_phase)
    return counts


def phase_shard_swarm(dev, card):
    """The sharded swarm on the grid kernels (the main path of this
    phase), mesh (1, 4) of the one card: flock_n262k's fused cost rollout
    (T = 100, eval-shaped: 1 table_build a step, 4 grid_window a step and
    4 x 32 cold-start lambda passes) against Flocking.rollout_cost, its ok
    flag against the unsharded run's and the largest in-degree; its fused
    rollout with graphs (T = 25, the ELL lambda) and flock_n4096's windowed
    rollout (2 samples, T = 25) against the same rollouts on mesh (1, 1);
    exact launch counts, seconds and peak memory each."""
    import warnings

    import torch
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    meshes = {n: par.make_mesh((1, n), devices=[dev] * n)
              for n in (SHARD_PARTS, 1)}
    launches = dict(grid_window=0, table_build=0, table_transpose=0)
    rows = []

    def run(label, n, roll, pos, vel, T, lam_passes):
        gridwin.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, peak = _peak_gb(lambda: roll(pos, vel))
        seconds = time.perf_counter() - t0
        counts = _flock_counts()
        expect = dict(grid_window=n * (1 + lam_passes + (T - 1)),
                      table_build=T, table_transpose=0)
        require(counts == expect, f"{label}: launches {counts}, expected "
                                  f"{expect}")
        if n == SHARD_PARTS:
            for k, m in counts.items():
                launches[k] += m
        rows.append(dict(config=label, T=T, seconds=seconds, peak_gb=peak,
                         launches=counts))
        return out

    def close(label, got, want):
        out = {}
        for name, a, b in zip(("pos", "vel", "accel", "states"), got, want):
            err, rel, ok = compare(a, b, SWARM_RTOL, SWARM_ATOL_REL)
            out[name] = dict(max_abs_err=err, max_rel_err=rel,
                             bit_equal=bool(torch.equal(a, b)))
            require(ok, f"{label}: {name} differs from mesh (1, 1): max abs "
                        f"{err}, rel {rel}")
        out["graph_idx_equal_share"] = float(
            (got[4].idx == want[4].idx).double().mean())
        require(bool(got[-1]) == bool(want[-1]), f"{label}: ok flags differ")
        return out

    env, ip, iv, net = _flock_setup("flock_n262k", dev)
    N, D = FLOCK["flock_n262k"]["N"], FLOCK_D
    T = FLOCK_T_EVAL
    pos, vel, n_orig = par.pad_swarm(ip, iv, meshes[SHARD_PARTS])
    kw = dict(comm_radius=env.commRadius, dt=env.samplingTime,
              accel_max=env.accelMax, d_max=D, n_orig=n_orig, lam_iters=0,
              env_grid=True)
    label = "flock_n262k fused cost mesh (1, 4)"
    cf, ce, deg, ok = run(label, SHARD_PARTS, par.sharded_swarm_rollout(
        T, net.causal_window, net, mesh=meshes[SHARD_PARTS], step_mode=True,
        return_cost=True, **kw), pos, vel, T, 32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ucf, uce = env.rollout_cost(ip, iv, T * env.samplingTime, net,
                                    ell_degree=D, env_grid=True, lam_iters=0)
    u_ok = not any(issubclass(w.category, RuntimeWarning)
                   and "grid env" in str(w.message) for w in caught)
    cf, ce, deg, ok = float(cf), float(ce), int(deg), bool(ok)
    require(np.isfinite(cf) and np.isfinite(ce), f"{label}: non-finite cost")
    for what, a, b in (("cost_full", cf, ucf), ("cost_end", ce, uce)):
        require(abs(a - b) <= SWARM_RTOL * abs(b),
                f"{label}: {what} {a} vs rollout_cost {b}")
    require(ok == (u_ok and deg <= D),
            f"{label}: ok {ok}, unsharded ok {u_ok}, largest in-degree {deg}")
    rows[-1].update(cost_full=cf, cost_end=ce, rollout_cost_full=ucf,
                    rollout_cost_end=uce, ok=ok, unsharded_ok=u_ok,
                    largest_in_degree=deg, d_max=D)

    T = FLOCK_T_TRAIN
    traj = {n: run(f"flock_n262k fused with graphs mesh (1, {n})", n,
                   par.sharded_swarm_rollout(
                       T, net.causal_window, net, mesh=meshes[n],
                       step_mode=True, **kw), pos, vel, T, 0)
            for n in (SHARD_PARTS, 1)}
    got, want = traj[SHARD_PARTS], traj[1]
    require(tuple(got[4].idx.shape) == (1, T, N, D)
            and bool(torch.isfinite(got[0]).all()), "262k sharded graphs")
    rows[-2].update(vs_mesh_1=close("flock_n262k fused with graphs", got,
                                    want),
                    ok=bool(got[-1]), largest_in_degree=int(got[-2]))
    del traj, got, want

    env4, ip4, iv4, net4 = _flock_setup("flock_n4096", dev)
    pos4, vel4, n4 = par.pad_swarm(ip4, iv4, meshes[SHARD_PARTS])
    kw4 = dict(kw, n_orig=n4)
    win = {n: run(f"flock_n4096 windowed mesh (1, {n})", n,
                  par.sharded_swarm_rollout(
                      T, net4.causal_window, net4, mesh=meshes[n], **kw4),
                  pos4, vel4, T, 0)
           for n in (SHARD_PARTS, 1)}
    rows[-2].update(vs_mesh_1=close("flock_n4096 windowed",
                                    win[SHARD_PARTS], win[1]),
                    ok=bool(win[SHARD_PARTS][-1]))
    emit(phase="shard_swarm", nvidia_smi=card, rtol=SWARM_RTOL,
         atol=f"{SWARM_ATOL_REL}*max|mesh (1, 1)|", rows=rows,
         launches=launches, seconds=time.perf_counter() - t_phase)
    return launches, (env, ip, iv, net, pos, vel, kw)


def phase_shard_swarm_profile(setup, card, n=10):
    """Where one flock_n262k eval-shaped step spends its time sharded over
    mesh (1, 4) (policy, physics, the sharded env step: the table once, the
    window pass a shard) beside the unsharded step (flock_profile's)."""
    import torch
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.parallel import swarm
    env, ip, iv, net, pos, vel, kw = setup
    mesh = par.make_mesh((1, SHARD_PARTS), devices=[pos.device] * SHARD_PARTS)
    pieces = {
        "flock_n262k eval step unsharded": (
            env._chunked_pieces(net, FLOCK_D, 0, True, return_graphs=False),
            (env._as_device(ip), env._as_device(iv))),
        "flock_n262k eval step sharded mesh (1, 4)": (
            swarm._rollout_pieces(
                net.causal_window, net, kw["comm_radius"], kw["dt"],
                kw["accel_max"], kw["d_max"], mesh, "graph", kw["n_orig"],
                0, True, True, True), (pos, vel)),
    }
    for label, ((init_fn, step_fn), args) in pieces.items():
        with torch.no_grad():
            carry = [init_fn(*args)[0]]

            def step():
                carry[0] = step_fn(carry[0])[0]

            prof = _device_profile(step, n)
        emit(phase="shard_swarm_profile", nvidia_smi=card, config=label,
             host_ms_per_step=prof["wall_ms"],
             profiled_host_ms_per_step=prof["profiled_wall_ms"],
             device_ms_per_step=prof["device_ms"],
             device_idle_share=prof["device_idle_share"],
             top=[dict(name=t["name"], ms_per_step=t["ms"],
                       calls_per_step=t["calls"]) for t in prof["top"]])


# ---------------------------------------------------------------------------
# The static-GSO recurrent family and the static filter families
# ---------------------------------------------------------------------------

# grnn_band_n4096: examples/epidemic.py:46-47, 64-72 in full mode,
# GraphRecurrentNN(1, 2, 12, [5, 5], True, "tanh", "relu", "relu", [2], S)
# and GatedGraphRecurrentNN(..., gateType=...): seqLen 8, batch 100, Adam
# at lr 5e-4, f1_score_loss; on band_n4096's graph (banded_graph, N = 4096,
# bandwidth 256, density 0.05, seed 0, normalized by its largest
# |eigenvalue| as the example normalizes its own). Seeded sequences shaped
# as the Epidemics dataset's stand in for it: states in {0, 1, 2}, infected
# indicators. The edge gate's gates are (B*T, N, N) by definition (53 GB
# here): static_families runs it at N = 128.
GRNN_T = 8
GRNN_BATCH = 100
GRNN_H = 12
GRNN_K = 5
GRNN_LR = 5e-4
GRNN_STEPS = 4
GRNN_REQUESTS = (100, 37, 1)
GRNN_GATES = (None, "time", "node")
GRNN_SHARD_GATES = (None, "node")
STATIC_N = 128
STATIC_RTOL = 1e-4
STATIC_ATOL_REL = 1e-4


def _gate_name(gate):
    return "GRNN" if gate is None else f"GatedGRNN-{gate}"


def _grnn(S, mode, dev, gate=None):
    """grnn_band_n4096's model in gsoMode `mode`; the weights drawn from
    one seed, so every mode holds the same ones."""
    import torch
    from graph_neural_networks_torch.models import architectures as archs
    args = (1, 2, GRNN_H, [GRNN_K, GRNN_K], True, "tanh", "relu", "relu",
            [2], S)
    kw = dict(gsoMode=mode, device=dev,
              generator=torch.Generator().manual_seed(0))
    if gate is None:
        return archs.GraphRecurrentNN(*args, **kw)
    return archs.GatedGraphRecurrentNN(*args, gateType=gate, **kw)


def _grnn_launches(mode, gate, step, shards=0):
    """SpMM launches of one grnn_band_n4096 forward (step=False) or the
    backward a training step adds to it (step=True), from the code: each
    hidden state (the main one and, gated, the two gate GRNNs) runs one
    lsigf over the inputs (B*T*F rows) and one a recurrence step (B*H
    rows); the output filter, and the node gate's two GraphFilter(H -> 1)
    heads, run on B*T*H rows. An lsigf shifts K-1 times: on band, one
    band_shift_register up to spmm.REGISTER_MAX_ROWS rows, else K-1 chained
    band_matmul; on bcsr K-1 bcsr_matmul; sharded (shards > 0) K-1 ring
    shifts of one band_matmul a shard. Backward: the input's gradient of
    every shift whose input needs one (not the data's, not z0's: the
    recurrence's steps 2..T and the layers on z), one band_matmul (or
    bcsr_matmul) a shift, on the register too."""
    from graph_neural_networks_torch.ops import spmm
    B, T, H, K = GRNN_BATCH, GRNN_T, GRNN_H, GRNN_K
    states = 1 if gate is None else 3
    calls = [(B * T, states, False), (B * H, states, False),
             (B * H, states * (T - 1), True),
             (B * T * H, 1 + (2 if gate == "node" else 0), True)]
    c = {"band_shift_register": 0, "band_matmul": 0, "bcsr_matmul": 0}
    for rows, n, grad in calls:
        shifts = n * (K - 1)
        if step and not grad:
            continue
        if shards:
            c["band_matmul"] += shifts * shards
        elif mode == "bcsr":
            c["bcsr_matmul"] += shifts
        elif step:
            c["band_matmul"] += shifts
        elif rows <= spmm.REGISTER_MAX_ROWS:
            c["band_shift_register"] += n
        else:
            c["band_matmul"] += shifts
    return c


def _expect(*parts, scale=(1,)):
    """All the counted wrappers at 0, plus sum(scale[i] * parts[i])."""
    counts = {k: 0 for k in _attention_counts()}
    for part, n in zip(parts, scale):
        for k, v in part.items():
            counts[k] += n * v
    return counts


def _sequence_data(rng, sizes, N):
    """Seeded train/valid/test sequences shaped as Epidemics': x (n, T, 1,
    N) states in {0, 1, 2}, y (n, T, N) infected indicators; evaluate is
    Epidemics.evaluate, 1 - F1 on the infected class of the argmax."""
    from graph_neural_networks_torch.data import Data

    class Sequences(Data):
        def evaluate(self, yHat, y, tol=1e-9):
            yHat = np.asarray(yHat)
            C, N_ = yHat.shape[-2], yHat.shape[-1]
            pred = np.argmax(yHat.reshape(-1, C, N_), axis=1).astype(float)
            y = np.asarray(y).reshape(-1, N_).astype(float)
            tp = np.sum(y * pred, axis=1)
            fp = np.sum((1 - y) * pred, axis=1)
            fn = np.sum(y * (1 - pred), axis=1)
            with np.errstate(invalid="ignore", divide="ignore"):
                p = tp / (tp + fp)
                r = tp / (tp + fn)
            p = np.where(np.isnan(p), np.where(tp < tol, 1.0, 0.0), p)
            p = np.where((tp + fp == 0) & (tp >= tol), 0.0, p)
            r = np.where(np.isnan(r), np.where(tp < tol, 1.0, 0.0), r)
            with np.errstate(invalid="ignore", divide="ignore"):
                f1 = 2 * p * r / (p + r)
            return float(1 - np.mean(np.where(np.isnan(f1), 0.0, f1)))

    data = Sequences()
    data.nTrain, data.nValid, data.nTest = sizes
    for split, n in zip(("train", "valid", "test"), sizes):
        data.samples[split]["signals"] = rng.integers(
            0, 3, (n, GRNN_T, 1, N)).astype(np.float32)
        data.samples[split]["targets"] = rng.integers(
            0, 2, (n, GRNN_T, N)).astype(np.float32)
    return data


def _z0(dev, seed=1):
    """A (GRNN_BATCH, H, N_GRAPH) z0 drawn from its own seed."""
    import torch
    return torch.randn((GRNN_BATCH, GRNN_H, N_GRAPH), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(seed))


def _per_step_err(y, want):
    """Max abs error at each of the T steps of (B, T, ., N) outputs."""
    return [(y[:, t].double() - want[:, t].double()).abs().max().item()
            for t in range(y.shape[1])]


def phase_grnn_kernels(graph, rng, dev):
    """Kernels 1-3 at the recurrent family's shapes against their plain
    versions (forward and the backward's transposed layouts), and their
    times beside the plain version, the library call and the bound."""
    import torch
    from graph_neural_networks_torch.ops import gso as gso_lib
    from graph_neural_networks_torch.ops import spmm
    S_band, S_bcsr = graph["band"], graph["bcsr"]
    N, bs, w, K = N_GRAPH, 128, S_band.band_w, GRNN_K
    sb, sbt, Sd = S_band.s_band[0], S_band.s_band_t[0], S_band.S[0]
    fwd = (S_bcsr.blocks[0], S_bcsr.block_row, S_bcsr.block_col,
           S_bcsr.col_start)
    bwd = (S_bcsr.blocks_t[0], S_bcsr.block_row_t, S_bcsr.block_col_t,
           S_bcsr.col_start_t)
    nnzb = fwd[0].shape[0]
    win = _window_blocks(N // bs, w)
    r_x = GRNN_BATCH * GRNN_T          # the inputs' register (F = 1)
    r_z = GRNN_BATCH * GRNN_H          # a recurrence step's register
    r_o = r_x * GRNN_H                 # the output filter's shifts
    # the ring shift's own block of a shard (n_cols = 1024, w = 1)
    Ns = N // SHARD_PARTS
    gs = gso_lib.as_gso(_band_case(np.random.default_rng(2), Ns, bs, 1),
                        "band", device=dev)
    wins = _window_blocks(Ns // bs, 1)
    results, errs, rows = [], {}, {}

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    def check(name, case, got, want):
        max_abs, max_rel, ok = compare(got, want)
        results.append(dict(kernel=name, case=case, max_abs_err=max_abs,
                            max_rel_err=max_rel, ok=ok))
        errs[name] = max(errs.get(name, 0.0), max_abs)
        require(ok, f"{name} [{case}] disagrees with its plain version: "
                    f"max abs {max_abs}, max rel {max_rel}")

    def time_row(key, shape, kernel, plain, library, library_call, flops,
                 nbytes):
        row = dict(shape=shape, ms=time_ms(kernel), graph_ms=graph_ms(kernel),
                   plain_ms=time_ms(plain, reps=5, inner=2),
                   library_ms=time_ms(library, reps=5, inner=2),
                   library_call=library_call, flops=flops, bytes=nbytes)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, flops)
        rows[key] = row

    lib = "torch.matmul(x, S_dense), TF32 off"
    for R in (r_x, r_z):
        x = rand(R, N)
        check("band_shift_register", f"R={R} N={N} w={w} K={K}",
              spmm.band_shift_register(x, sb, n_taps=K, n_cols=N, w=w),
              spmm.band_shift_register_plain(x, sb, n_taps=K, n_cols=N, w=w))
        out = torch.empty(K, R, N, device=dev)

        def chained(x=x, out=out):
            out[0].copy_(x)
            for k in range(1, K):
                torch.matmul(out[k - 1], Sd, out=out[k])
        time_row(f"band_shift_register@R={R}", f"R={R} N={N} w={w} K={K}",
                 lambda x=x: spmm.band_shift_register(x, sb, n_taps=K,
                                                      n_cols=N, w=w),
                 lambda x=x: spmm.band_shift_register_plain(
                     x, sb, n_taps=K, n_cols=N, w=w),
                 chained, f"{K - 1} chained torch.matmul(z, S_dense), TF32 "
                 "off", (K - 1) * 2 * R * win * bs * bs,
                 4 * (R * N + K * R * N + sb.numel()))
    for R, slab, way in ((r_o, sb, "forward"), (r_z, sbt, "backward"),
                         (r_o, sbt, "backward")):
        x = rand(R, N)
        S_lib = Sd if way == "forward" else Sd.T.contiguous()
        check("band_matmul", f"R={R} N={N} w={w} {way}",
              spmm.band_matmul(x, slab, n_cols=N, w=w),
              spmm.band_matmul_plain(x, slab, n_cols=N, w=w))
        time_row(f"band_matmul@R={R} {way}", f"R={R} N={N} w={w} {way}",
                 lambda x=x, s=slab: spmm.band_matmul(x, s, n_cols=N, w=w),
                 lambda x=x, s=slab: spmm.band_matmul_plain(x, s, n_cols=N,
                                                            w=w),
                 lambda x=x, S=S_lib: torch.matmul(x, S), lib,
                 2 * R * win * bs * bs, 4 * (2 * R * N + win * bs * bs))
    for R in (r_z, r_o):
        x = rand(R, Ns)
        sbs, Sds = gs.s_band[0], gs.S[0]
        check("band_matmul", f"R={R} N={Ns} w=1 (a shard's own block)",
              spmm.band_matmul(x, sbs, n_cols=Ns, w=1),
              spmm.band_matmul_plain(x, sbs, n_cols=Ns, w=1))
        time_row(f"band_matmul@R={R} n_cols={Ns}", f"R={R} N={Ns} w=1",
                 lambda x=x: spmm.band_matmul(x, sbs, n_cols=Ns, w=1),
                 lambda x=x: spmm.band_matmul_plain(x, sbs, n_cols=Ns, w=1),
                 lambda x=x: torch.matmul(x, Sds), lib,
                 2 * R * wins * bs * bs, 4 * (2 * R * Ns + wins * bs * bs))
    for R, lay, way in ((r_x, fwd, "forward"), (r_z, fwd, "forward"),
                        (r_o, fwd, "forward"), (r_z, bwd, "backward"),
                        (r_o, bwd, "backward")):
        x = rand(R, N)
        bl, br, bc, cs = lay
        S_lib = Sd if way == "forward" else Sd.T.contiguous()
        check("bcsr_matmul", f"R={R} N={N} nnzb={nnzb} {way}",
              spmm.bcsr_matmul(x, bl, br, bc, n_cols=N, col_start=cs),
              spmm.bcsr_matmul_plain(x, bl, br, bc, n_cols=N))
        time_row(f"bcsr_matmul@R={R} {way}", f"R={R} N={N} nnzb={nnzb} "
                 f"{way}",
                 lambda x=x, l=lay: spmm.bcsr_matmul(
                     x, l[0], l[1], l[2], n_cols=N, col_start=l[3]),
                 lambda x=x, l=lay: spmm.bcsr_matmul_plain(
                     x, l[0], l[1], l[2], n_cols=N),
                 lambda x=x, S=S_lib: torch.matmul(x, S), lib,
                 2 * R * nnzb * bs * bs,
                 4 * (2 * R * N + bl.numel() + 2 * nnzb))
    emit(phase="grnn_kernels", rtol=RTOL, atol=f"{ATOL_REL}*max|plain|",
         checks=results)
    emit(phase="grnn_timing", rows=rows,
         peaks=dict(hbm_tb_s=HBM_BYTES_PER_S / 1e12,
                    fp32_tflops=FP32_FLOPS_PER_S / 1e12))
    return errs, rows


def phase_grnn_serving(S_np, rng, dev):
    """grnn_band_n4096 (ungated, time and node gates) in band and bcsr mode
    against dense mode, the same weights: split_forward on an explicit z0
    (both outputs, the error at each step), then requests through
    InferenceEngine (z0 from the forward's default generator, seeded 0 in
    every mode); exact launch counts; a generator-drawn z0's forward."""
    import torch
    from graph_neural_networks_torch.serving import InferenceEngine
    launches = {k: 0 for k in _attention_counts()}
    checks, engines = [], {}
    B, N = GRNN_BATCH, N_GRAPH
    x = rng.integers(0, 3, (B, GRNN_T, 1, N)).astype(np.float32)
    requests = [rng.integers(0, 3, (n, GRNN_T, 1, N)).astype(np.float32)
                for n in GRNN_REQUESTS]
    z0 = _z0(dev)
    for gate in GRNN_GATES:
        name = _gate_name(gate)
        dense = _grnn(S_np, "dense", dev, gate)
        dense_eng = InferenceEngine(dense, B, dev)
        with torch.inference_mode():
            want = dense.split_forward(x, z0=z0)
        want_req = [dense_eng(r) for r in requests]
        for mode in ("band", "bcsr"):
            arch = _grnn(S_np, mode, dev, gate)
            require(all(torch.equal(p, q) for p, q in
                        zip(arch.parameters(), dense.parameters())),
                    f"{name} {mode}: weights differ from dense")
            fwd = _expect(_grnn_launches(mode, gate, False))
            _reset_counts()
            t0 = time.perf_counter()
            with torch.inference_mode():
                got = arch.split_forward(x, z0=z0)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _attention_counts()
            require(counts == fwd, f"{name} {mode}: launches {counts}, "
                                   f"expected {fwd}")
            for out, g, wnt in (("y", got[0], want[0]),
                                ("y_output_layer", got[1], want[1])):
                require(tuple(g.shape) == (B, GRNN_T, 2, N),
                        f"{name} {mode}: {out} {tuple(g.shape)}")
                max_abs, max_rel, ok = compare(g, wnt, SERVE_RTOL,
                                               SERVE_ATOL_REL)
                checks.append(dict(model=name, mode=mode, output=out,
                                   batch=B, against="dense",
                                   max_abs_err=max_abs, max_rel_err=max_rel,
                                   per_step_max_abs_err=_per_step_err(g, wnt),
                                   ok=ok))
                require(ok, f"{name} {mode} {out} disagrees with dense: "
                            f"{max_abs} (per step "
                            f"{_per_step_err(g, wnt)})")
            eng = InferenceEngine(arch, B, dev)
            _reset_counts()
            answers = [eng(r) for r in requests]
            counts = _attention_counts()
            require(counts == _expect(fwd, scale=(len(requests),)),
                    f"{name} {mode} requests: launches {counts}")
            for r, y, yd in zip(requests, answers, want_req):
                require(tuple(y.shape) == (r.shape[0], GRNN_T, 2, N),
                        f"{name} {mode}: answer {tuple(y.shape)}")
                max_abs, max_rel, ok = compare(y, yd, SERVE_RTOL,
                                               SERVE_ATOL_REL)
                checks.append(dict(model=name, mode=mode, output="request",
                                   batch=r.shape[0], against="dense",
                                   max_abs_err=max_abs, max_rel_err=max_rel,
                                   ok=ok))
                require(ok, f"{name} {mode} request {r.shape[0]} disagrees "
                            f"with dense: {max_abs}")
            for k, v in counts.items():
                launches[k] += v + fwd[k]
            with torch.inference_mode():
                drawn = arch.apply(x, generator=torch.Generator(
                    device=dev).manual_seed(5))
            require(tuple(drawn.shape) == (B, GRNN_T, 2, N)
                    and bool(torch.isfinite(drawn).all()),
                    f"{name} {mode}: a generator-drawn z0's forward")
            emit(phase="grnn_serving", model=name, mode=mode, batch=B,
                 T=GRNN_T, seconds=seconds, launches_per_forward={
                     k: v for k, v in fwd.items() if v},
                 requests=list(GRNN_REQUESTS))
            if gate is None:
                engines[mode] = eng
        engines.setdefault("dense", dense_eng)
        del dense
    emit(phase="grnn_serving_check", rtol=SERVE_RTOL,
         atol=f"{SERVE_ATOL_REL}*max|dense|", checks=checks)
    for mode in ("band", "bcsr", "dense"):
        _profile_forward(f"grnn_band_n4096 {mode}", engines[mode],
                         requests[0], n=5)
    return launches


def _grnn_model(arch, name, out_dir):
    from graph_neural_networks_torch import training
    return training.Model(arch, training.losses.f1_score_loss,
                          {"name": "ADAM", "lr": GRNN_LR}, training.Trainer,
                          training.evaluate, name=name, saveDir=out_dir)


def _grnn_grads(arch, data, z0):
    """The f1 loss and parameter gradients on the Trainer's first batch,
    z0 given."""
    import torch
    from graph_neural_networks_torch.training import losses
    idx = np.random.default_rng(0).permutation(data.nTrain)[:GRNN_BATCH]
    x, y = data.getSamples("train", idx)
    loss = losses.f1_score_loss(arch.split_forward(x, z0=z0)[0],
                                torch.as_tensor(y, device=arch.device))
    return loss.item(), torch.autograd.grad(loss, list(arch.parameters()))


def _grnn_train(model, data, fwd, step):
    """Model.train for GRNN_STEPS steps (validation at step 0), the counts
    set to 0 just before and read just after, held to fwd and step (per
    step and validation forward); evaluate; the losses."""
    import torch
    _reset_counts()
    t0 = time.perf_counter()
    with _cached_structure(model.name):
        out = model.train(data, nEpochs=1, batchSize=GRNN_BATCH,
                          validationInterval=GRNN_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _attention_counts()
    n_val = len(out["costValid"])
    expected = _expect(fwd, step, scale=(GRNN_STEPS + n_val, GRNN_STEPS))
    losses = out["lossTrain"]
    require(len(losses) == GRNN_STEPS and bool(np.isfinite(losses).all()),
            f"{model.name}: losses {losses}")
    require(n_val == 1 and counts == expected,
            f"{model.name}: {n_val} validations, launches {counts}, "
            f"expected {expected}")
    result = model.evaluate(data, doSaveVars=False)
    require(all(r is not None and 0 <= r <= 1 for r in result.values()),
            f"{model.name}: evaluate {result}")
    return out, counts, seconds, result


def phase_grnn_training(S_np, rng, dev, out_dir):
    """grnn_band_n4096 (ungated, time and node gates) trained in band and
    bcsr mode through Model.train (f1 loss, Adam 5e-4, batch 100) and
    evaluate against dense mode with the same weights: the first step's
    gradients on the same z0, the losses of GRNN_STEPS steps (the
    Trainer's generator draws the same z0 sequence in every mode), exact
    launch counts, a step's peak memory."""
    import torch
    checks, trained = [], {}
    launches = {k: 0 for k in _attention_counts()}
    data = _sequence_data(rng, (GRNN_STEPS * GRNN_BATCH, GRNN_BATCH,
                                GRNN_BATCH), N_GRAPH)
    z0 = _z0(dev)
    for gate in GRNN_GATES:
        name = _gate_name(gate)
        dense = _grnn(S_np, "dense", dev, gate)
        _, want = _grnn_grads(dense, data, z0)
        ref = _grnn_model(dense, f"{name}_dense", out_dir).train(
            data, nEpochs=1, batchSize=GRNN_BATCH,
            validationInterval=GRNN_STEPS)
        del dense
        for mode in ("band", "bcsr"):
            arch = _grnn(S_np, mode, dev, gate)
            loss0, got = _grnn_grads(arch, data, z0)
            _check_grads(checks, f"{name} {mode}", "dense", got, want)
            fwd = _grnn_launches(mode, gate, False)
            step = _grnn_launches(mode, gate, True)
            model = _grnn_model(arch, f"{name}_{mode}", out_dir)
            out, counts, seconds, result = _grnn_train(model, data, fwd,
                                                       step)
            ok = bool(np.allclose(out["lossTrain"], ref["lossTrain"],
                                  rtol=LOSS_RTOL, atol=0))
            checks.append(dict(model=f"{name} {mode}", against="dense",
                               losses=out["lossTrain"].tolist(),
                               dense_losses=ref["lossTrain"].tolist(),
                               ok=ok))
            require(ok, f"{name} {mode}: losses {out['lossTrain']} vs "
                        f"dense {ref['lossTrain']}")
            trainer = model.trainer(model, data, 1, GRNN_BATCH)
            _, peak = _peak_gb(lambda: trainer.train_batch(
                np.arange(GRNN_BATCH)))
            emit(phase="grnn_training", model=name, mode=mode,
                 steps=GRNN_STEPS, batch=GRNN_BATCH, T=GRNN_T,
                 first_step_loss=loss0, losses=out["lossTrain"].tolist(),
                 cost_valid=out["costValid"].tolist(), evaluate=result,
                 seconds=seconds,
                 step_ms=(np.asarray(out["timeTrain"]) * 1e3).tolist(),
                 launches=counts, launches_per_step={
                     k: v + step[k] for k, v in fwd.items() if v + step[k]},
                 step_peak_gb=peak)
            for k, v in counts.items():
                launches[k] += v
            trained[f"grnn_band_n4096 {name} {mode}"] = (model, data,
                                                         GRNN_BATCH)
    emit(phase="grnn_training_check", rtol=TRAIN_RTOL,
         atol=f"{TRAIN_ATOL_REL}*max|dense|", loss_rtol=LOSS_RTOL,
         checks=checks)
    return launches, trained


def phase_grnn_sharded(S_np, rng, dev, out_dir):
    """grnn_band_n4096 (ungated and node-gated) .shard()ed over mesh (1, 4)
    of the card (the ring shift: one band_matmul a shard a shift) against
    the unsharded band model: a forward on an explicit z0, the first
    step's gradients, GRNN_STEPS steps of loss through Model.train, exact
    band_matmul counts; the ungated model's sharded step and forward
    profiled beside the unsharded ones."""
    import torch
    from graph_neural_networks_torch import parallel as par
    mesh = par.make_mesh((1, SHARD_PARTS), devices=[dev] * SHARD_PARTS)
    checks = []
    launches = {k: 0 for k in _attention_counts()}
    data = _sequence_data(rng, (GRNN_STEPS * GRNN_BATCH, GRNN_BATCH,
                                GRNN_BATCH), N_GRAPH)
    x = data.samples["test"]["signals"]
    z0 = _z0(dev, seed=2)
    for gate in GRNN_SHARD_GATES:
        name = _gate_name(gate)
        unsharded = _grnn(S_np, "band", dev, gate)
        sharded = _grnn(S_np, "band", dev, gate).shard(mesh, SHARD_PARTS)
        part = sharded.S.partition
        require(sharded.S.uses_ring and part.n_padded == N_GRAPH,
                f"{name}: partition w={part.w}, n_padded={part.n_padded}")
        fwd = _grnn_launches("band", gate, False, shards=SHARD_PARTS)
        step = _grnn_launches("band", gate, True, shards=SHARD_PARTS)
        with torch.inference_mode():
            want = unsharded.split_forward(x, z0=z0)
            _reset_counts()
            got = sharded.split_forward(x, z0=z0)
            torch.cuda.synchronize()
            counts = _attention_counts()
        require(counts == _expect(fwd), f"{name} sharded: launches "
                                        f"{counts}, expected {fwd}")
        for out, g, wnt in (("y", got[0], want[0]),
                            ("y_output_layer", got[1], want[1])):
            max_abs, max_rel, ok = compare(g, wnt, SERVE_RTOL,
                                           SERVE_ATOL_REL)
            checks.append(dict(model=f"{name} sharded", output=out,
                               against="unsharded band", max_abs_err=max_abs,
                               max_rel_err=max_rel,
                               per_step_max_abs_err=_per_step_err(g, wnt),
                               ok=ok))
            require(ok, f"{name} sharded {out} disagrees with the unsharded "
                        f"band model: {max_abs}")
        _, g_want = _grnn_grads(unsharded, data, z0)
        _, g_got = _grnn_grads(sharded, data, z0)
        _check_grads(checks, f"{name} sharded", "unsharded band", g_got,
                     g_want)
        ref = _grnn_model(unsharded, f"{name}_unsharded", out_dir).train(
            data, nEpochs=1, batchSize=GRNN_BATCH,
            validationInterval=GRNN_STEPS)
        model = _grnn_model(sharded, f"{name}_sharded", out_dir)
        out, counts, seconds, result = _grnn_train(model, data, fwd, step)
        ok = bool(np.allclose(out["lossTrain"], ref["lossTrain"],
                              rtol=LOSS_RTOL, atol=0))
        checks.append(dict(model=f"{name} sharded", against="unsharded band",
                           losses=out["lossTrain"].tolist(),
                           unsharded_losses=ref["lossTrain"].tolist(),
                           ok=ok))
        require(ok, f"{name} sharded: losses {out['lossTrain']} vs "
                    f"unsharded {ref['lossTrain']}")
        for k, v in counts.items():
            launches[k] += v
        emit(phase="grnn_sharded", model=name, mesh=[1, SHARD_PARTS],
             ibs=part.inner_bs, nbl=part.nbl, w=part.w, seconds=seconds,
             launches=counts, launches_per_forward=fwd["band_matmul"],
             launches_per_step=fwd["band_matmul"] + step["band_matmul"],
             evaluate=result)
        if gate is not None:
            continue
        for label, arch in (("unsharded", unsharded), ("sharded", sharded)):
            trainer = model.trainer(_grnn_model(arch, name, out_dir), data,
                                    1, GRNN_BATCH)
            it = iter([np.arange(GRNN_BATCH)] * 20)
            step_prof = _device_profile(lambda: trainer.train_batch(
                next(it)), 3)

            def forward(arch=arch):
                with torch.inference_mode():
                    arch.apply(x, z0=z0)
            fwd_prof = _device_profile(forward, 3)
            for what, prof in (("step", step_prof), ("forward", fwd_prof)):
                emit(phase="grnn_shard_profile", model=f"{name} {label}",
                     of=what, host_ms=prof["wall_ms"],
                     profiled_host_ms=prof["profiled_wall_ms"],
                     device_ms=prof["device_ms"],
                     device_idle_share=prof["device_idle_share"],
                     top=[dict(name=t["name"], ms=t["ms"], calls=t["calls"])
                          for t in prof["top"]])
    emit(phase="grnn_sharded_check", rtol=SERVE_RTOL,
         atol=f"{SERVE_ATOL_REL}*max|reference|", loss_rtol=LOSS_RTOL,
         checks=checks)
    return launches


def _static_models(S, N):
    """Every architecture of the static filter families at N nodes, and the
    edge-gated GRNN: (name, build(device), input features, recurrent?)."""
    import torch
    from graph_neural_networks_torch.models import architectures as archs

    def gen():
        return dict(generator=torch.Generator().manual_seed(0))
    sel = ([N, N], "NoPool", [1, 1])
    return [
        ("SpectralGNN M<N", lambda d: archs.SpectralGNN(
            [2, 8, 8], [12, 12], True, "relu", [N // 2, N // 4],
            "MaxPoolLocal", [2, 2], [5], S, device=d, **gen()), 2, False),
        ("NodeVariantGNN", lambda d: archs.NodeVariantGNN(
            [2, 8, 8], [3, 3], [8, N], True, "relu", *sel, [5], S,
            device=d, **gen()), 2, False),
        ("EdgeVariantGNN dense", lambda d: archs.EdgeVariantGNN(
            [2, 4, 4], [3, 2], [N, 16], True, "relu", *sel, [5], S,
            device=d, **gen()), 2, False),
        ("EdgeVariantGNN edge", lambda d: archs.EdgeVariantGNN(
            [2, 8, 8], [3, 3], [N, 16], True, "relu", *sel, [5], S,
            evMode="edge", device=d, **gen()), 2, False),
        ("LocalEdgeNet edge", lambda d: archs.LocalEdgeNet(
            [2, 8], [3], [N], True, "tanh", [N], "NoPool", [1], [3], S,
            evMode="edge", device=d, **gen()), 2, False),
        ("ARMAfilterGNN", lambda d: archs.ARMAfilterGNN(
            [2, 8, 8], [2, 2], [3, 3], True, "relu", *sel, [5], S,
            device=d, **gen()), 2, False),
        ("LocalARMA", lambda d: archs.LocalARMA(
            [2, 8], [2], [3], True, "tanh", [N], "NoPool", [1], [3], S,
            tMax=3, device=d, **gen()), 2, False),
        ("AggregationGNN", lambda d: archs.AggregationGNN(
            [2, 8, 8], [3, 3], True, "relu", "NoPool", [2, 1], [5], S,
            maxN=24, nNodes=4, dimLayersAggMLP=[5], device=d, **gen()), 2,
         False),
        ("MultiNodeAggregationGNN", lambda d: archs.MultiNodeAggregationGNN(
            [4, 3], [16, 8], [[2, 4], [4, 4], [3]], [[3], [3]], True,
            "relu", "NoPool", [[1], [1]], [5], S, device=d, **gen()), 2,
         False),
        ("GatedGRNN-edge", lambda d: archs.GatedGraphRecurrentNN(
            1, 2, GRNN_H, [GRNN_K, GRNN_K], True, "tanh", "relu", "relu",
            [2], S, gateType="edge", device=d, **gen()), 1, True),
    ]


def phase_static_families(rng, dev):
    """Each architecture of the static filter families, and the edge-gated
    GRNN (dense (B*T, N, N) gates), at N = STATIC_N on the card against the
    same model, same weights, on the CPU: the output and the gradient of
    every parameter of mean(y^2)."""
    import torch
    N = STATIC_N
    S = banded_graph(np.random.default_rng(20), N, 32, 0.2)
    checks = []
    for name, build, F0, recurrent in _static_models(S, N):
        shape = (4, 4, F0, N) if recurrent else (4, F0, N)
        x = rng.standard_normal(shape).astype(np.float32)
        z0 = rng.standard_normal((4, GRNN_H, N)).astype(np.float32)
        outs = {}
        for where in ("cpu", dev):
            arch = build(where)
            y = arch.apply(x, z0=z0) if recurrent else arch.apply(x)
            grads = torch.autograd.grad(torch.mean(y ** 2),
                                        list(arch.parameters()))
            outs[str(where)] = (y.detach().cpu(), [g.cpu() for g in grads])
        (y_c, g_c), (y_g, g_g) = outs["cpu"], outs[str(dev)]
        for what, got, want in [("y", y_g, y_c)] + [
                (f"grad {i}", g, w) for i, (g, w) in enumerate(zip(g_g,
                                                                   g_c))]:
            max_abs, max_rel, ok = compare(got, want, STATIC_RTOL,
                                           STATIC_ATOL_REL)
            checks.append(dict(model=name, what=what, max_abs_err=max_abs,
                               max_rel_err=max_rel, ok=ok))
            require(ok, f"{name} {what} on the card disagrees with the CPU: "
                        f"{max_abs}")
        emit(phase="static_families", model=name, N=N,
             params=sum(int(g.numel()) for g in g_c),
             output=list(y_g.shape))
    emit(phase="static_families_check", rtol=STATIC_RTOL,
         atol=f"{STATIC_ATOL_REL}*max|cpu|", checks=checks)


REPLACES = {
    "band_matmul": "graph_neural_networks_tpu/ops/spmm.py:624",
    "band_shift_register": "graph_neural_networks_tpu/ops/spmm.py:441",
    "bcsr_matmul": "graph_neural_networks_tpu/ops/spmm.py:151",
    "stats_call": "graph_neural_networks_tpu/ops/attention_flash.py:212",
    "apply_call": "graph_neural_networks_tpu/ops/attention_flash.py:234",
    "bwd_call": "graph_neural_networks_tpu/ops/attention_flash.py:261",
    "table_transpose": "graph_neural_networks_tpu/ops/gridwin.py:175",
    "table_build": "graph_neural_networks_tpu/ops/gridwin.py:265",
    "grid_window": "graph_neural_networks_tpu/ops/gridwin.py:356",
    "stats_ext_call": "graph_neural_networks_tpu/ops/attention_flash.py:312",
    "apply_ext_call": "graph_neural_networks_tpu/ops/attention_flash.py:337",
    "bwd_ext_call": "graph_neural_networks_tpu/ops/attention_flash.py:370",
}


def timed(name, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit(phase="phase_seconds", of=name, seconds=time.perf_counter() - t0)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "graph_neural_networks_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(graph_neural_networks_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.ops import gso as gso_lib
    from graph_neural_networks_torch.parallel import (
        attention as par_attention)
    from graph_neural_networks_torch.utils.device import resolve_device

    try:
        dev = resolve_device("cuda")
        card = phase_device()
        timed("build", phase_build)
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        S_np = banded_graph(rng, N_GRAPH, 256, 0.05)
        graph = {m: gso_lib.as_gso(S_np, m, device=dev)
                 for m in ("band", "bcsr")}
        emit(phase="graph", N=N_GRAPH, band_w=graph["band"].band_w,
             slab=list(graph["band"].s_band.shape[1:]),
             nnzb=int(graph["bcsr"].blocks.shape[1]),
             seconds=time.perf_counter() - t0)
        errs = timed("kernels", phase_kernels, graph,
                     np.random.default_rng(1), dev)
        rows = timed("timing", phase_timing, graph, dev)
        launches = timed("serving", phase_serving, S_np,
                         np.random.default_rng(3), dev)
        eng, x8, attn_launches = timed(
            "attention_serving", phase_attention_serving,
            np.random.default_rng(4), dev)
        launches.update({k: v for k, v in attn_launches.items()
                         if k in ("stats_call", "apply_call")})
        gso = eng.arch.S
        errs.update(timed("attention_kernels", phase_attention_kernels, gso,
                          np.random.default_rng(6), dev))
        rows.update(timed("attention_timing", phase_attention_timing, gso,
                          dev))
        timed("attention_profile", _profile_forward, "gat_band_n16384", eng,
              x8)
        errs.update(timed("train_kernels", phase_train_kernels, gso, graph,
                          np.random.default_rng(8), dev))
        rows.update(timed("train_timing", phase_train_timing, gso, dev))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            # the Best/Last checkpoints of the trained models
            train_launches, trained = timed(
                "training", phase_training, eng, S_np,
                np.random.default_rng(9), dev, out_dir)
        for k, n in train_launches.items():
            launches[k] = launches.get(k, 0) + n
        timed("train_profile", phase_train_profile, trained)
        errs.update(timed("flock_kernels", phase_flock_kernels,
                          np.random.default_rng(10), dev))
        env_launches = timed("flock_env", phase_flock_env, dev)
        serve_launches, setup = timed("flock_serving", phase_flock_serving,
                                      dev, card)
        for k in serve_launches:
            launches[k] = env_launches[k] + serve_launches[k]
        rows.update(timed("flock_timing", phase_flock_timing, dev, card))
        timed("flock_profile", phase_flock_profile, setup, card)
        del setup
        train_errs, train_rows = timed(
            "flock_train_kernels", phase_flock_train_kernels,
            np.random.default_rng(15), dev)
        errs["grid_window"] = max(errs["grid_window"],
                                  train_errs["grid_window"])
        rows.update(train_rows)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            flock_train_launches, trained = timed(
                "flock_training", phase_flock_training, dev, card, out_dir)
            timed("flock_train_profile", phase_flock_train_profile, trained,
                  card)
            del trained
        for k in ("grid_window", "table_build"):
            launches[k] += flock_train_launches[k]
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            timed("flock_ref_training", phase_flock_ref_training, dev, card,
                  out_dir)
            large_launches = timed("flock_largetrain",
                                   phase_flock_largetrain, dev, card,
                                   out_dir)
        for k in ("grid_window", "table_build"):
            launches[k] += large_launches[k]
        torch.cuda.empty_cache()
        shard_launches, engines, profiles = timed(
            "shard_serving", phase_shard_serving, np.random.default_rng(11),
            dev)
        for k in ("stats_ext_call", "apply_ext_call"):
            launches[k] = shard_launches[k]
        part = engines[(1, SHARD_PARTS)].arch.S.partition
        mc, mr = par_attention._row_col_masks(part)
        errs.update(timed("shard_kernels", phase_shard_kernels, part, mc, mr,
                          np.random.default_rng(12), dev))
        rows.update(timed("shard_timing", phase_shard_timing, part, mc, mr,
                          dev))
        timed("shard_profile", phase_shard_profile, profiles)
        del engines, profiles
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            st_launches, st_trained = timed(
                "shard_training", phase_shard_training,
                np.random.default_rng(13), dev, out_dir)
            timed("shard_train_profile", phase_train_profile, st_trained, 6,
                  "shard_train_profile")
            del st_trained
        launches["bwd_ext_call"] = st_launches["bwd_ext_call"]
        errs.update(timed("shard_train_kernels", phase_shard_train_kernels,
                          part, mc, mr, np.random.default_rng(14), dev))
        rows.update(timed("shard_train_timing", phase_shard_train_timing,
                          part, mc, mr, dev))
        # the rest of single-controller parallel/
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        S_sc = scattered_graph(np.random.default_rng(16), N_GRAPH,
                               SCATTER_IBS)
        spart = par.partition_nodes_bcsr(S_sc, SHARD_PARTS,
                                         inner_block=SCATTER_IBS)
        emit(phase="scattered_graph", N=N_GRAPH, ibs=SCATTER_IBS,
             nnz=int(np.count_nonzero(S_sc)), real_blocks=spart.nnzb.tolist(),
             seconds=time.perf_counter() - t0)
        bcsr_errs, bcsr_rows = timed("shard_bcsr_kernels",
                                     phase_shard_bcsr_kernels, spart,
                                     np.random.default_rng(17), dev)
        errs["bcsr_matmul"] = max(errs["bcsr_matmul"],
                                  bcsr_errs["bcsr_matmul"])
        rows.update(bcsr_rows)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            bcsr_launches, bcsr_trained, bcsr_profiles = timed(
                "shard_bcsr", phase_shard_bcsr, S_sc, spart,
                np.random.default_rng(18), dev, out_dir)
            timed("shard_bcsr_profile", phase_shard_bcsr_profile,
                  bcsr_trained, bcsr_profiles)
            del bcsr_trained, bcsr_profiles
        launches["bcsr_matmul"] += bcsr_launches["bcsr_matmul"]
        ag_launches = timed("shard_allgather", phase_shard_allgather,
                            np.random.default_rng(19), dev)
        launches["band_matmul"] += ag_launches["band_matmul"]
        torch.cuda.empty_cache()
        db_launches = timed("shard_db_training", phase_shard_db_training,
                            dev, card)
        swarm_launches, swarm_setup = timed("shard_swarm", phase_shard_swarm,
                                            dev, card)
        timed("shard_swarm_profile", phase_shard_swarm_profile, swarm_setup,
              card)
        del swarm_setup
        for k in ("grid_window", "table_build"):
            launches[k] += db_launches[k] + swarm_launches[k]
        # the static-GSO recurrent family and the static filter families
        torch.cuda.empty_cache()
        grnn_errs, grnn_rows = timed("grnn_kernels", phase_grnn_kernels,
                                     graph, np.random.default_rng(21), dev)
        for k, v in grnn_errs.items():
            errs[k] = max(errs[k], v)
        rows.update(grnn_rows)
        grnn_launches = [timed("grnn_serving", phase_grnn_serving, S_np,
                               np.random.default_rng(22), dev)]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            tr_launches, trained = timed(
                "grnn_training", phase_grnn_training, S_np,
                np.random.default_rng(23), dev, out_dir)
            grnn_launches.append(tr_launches)
            timed("grnn_train_profile", phase_train_profile, trained, 3,
                  "grnn_train_profile")
            del trained
            torch.cuda.empty_cache()
            grnn_launches.append(timed(
                "grnn_sharded", phase_grnn_sharded, S_np,
                np.random.default_rng(24), dev, out_dir))
        for part_launches in grnn_launches:
            for k in ("band_shift_register", "band_matmul", "bcsr_matmul"):
                launches[k] += part_launches[k]
        timed("static_families", phase_static_families,
              np.random.default_rng(25), dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    for name, n in launches.items():
        if n == 0:
            print(f"chip_smoke: FAILED: {name} never launched on the main "
                  "path", file=sys.stderr)
            return 1
    summary = []
    sources = dict(stats_call="attention_flash.cu",
                   apply_call="attention_flash.cu",
                   bwd_call="attention_flash.cu", grid_window="gridwin.cu",
                   table_build="gridwin.cu", table_transpose="gridwin.cu",
                   stats_ext_call="attention_flash.cu",
                   apply_ext_call="attention_flash.cu",
                   bwd_ext_call="attention_flash.cu")
    for name in ("bcsr_matmul", "band_shift_register", "band_matmul",
                 "stats_call", "apply_call", "bwd_call", "table_transpose",
                 "table_build", "grid_window", "stats_ext_call",
                 "apply_ext_call", "bwd_ext_call"):
        row = rows["bcsr_matmul@R=2048" if name == "bcsr_matmul" else name]
        source = sources.get(name, "spmm.cu")
        summary.append(dict(
            name=name, route="cuda",
            source=f"graph_neural_networks_torch/kernels/csrc/{source}",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=errs[name], ms=row["ms"], kernel_ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["shape"]))
    print(card, flush=True)
    emit(kernels=summary)
    emit(ok=True, device=dict(platform="gpu",
                              kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
