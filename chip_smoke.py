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
* Edge mode and the architecture left-outs: serves gat_edge_n16384
  (gat_band_n16384's GAT with attentionMode="edge": the SDDMM and segment
  softmax of ops/attention_sparse.py on the 2.29 M edges of the S+I
  support, no kernel of the library) through InferenceEngine and trains
  it 3 steps through Model.train, against the same weights in band mode
  (kernels 7-9; first-step gradients on shared ReLU gates, losses), with
  its profile and peak memory; GCAT and EdgeVariantAttention at N = 2048
  in edge mode against dense mode; grnn_band_n4096's GRNNs (ungated, time
  and node gates) with gsoMode="edge" against band mode (kernels 1-3),
  served and trained 4 steps; the edge gate against the dense edge gate
  at N = 512, then trained alone at N = 4096; and SelectionGNN with
  Graclus coarsening, LocalActivationGNN (max and median) and
  SelectionGNN under the EDS and SpectralProxies orderings at the
  examples' widths (N = 100), on the card against the CPU, served and
  trained 4 steps.
* The chunked all-pairs env, the windowed re-forward, the segmented
  rollouts and the host loop (no kernel of the library; kernels 5-6 run
  as the grid references, counted): rolls flock_n4096_chunked
  (examples/largeswarm.py --no-envGrid: 2 samples, T = 100, env_chunk
  512) in step mode, through the windowed re-forward and in host
  segments of 8 steps, against the grid rollout from the same state (one
  step's neighbour sets, states and values at t = 0, the first 10 steps)
  and the all-pairs dense loop, with a step's profile; flock_n65536_
  chunked's rollout_cost (env_chunk 8192) beside the grid's; generates
  flock_largetrain_n4096_chunked with Flocking.large(env_grid=None)
  against the grid generation, holds the chunked relabel against the f64
  expert and trains it 2 epochs; rolls flock_n4096_chunked over mesh
  (1, 4) on the all-pairs sharded env (windowed, fused, cost, and a
  GraphRecurrentNN_DB as the windowed policy) against one card; and runs
  a callable policy's host loop (full horizon and windowed) and the open
  loop on flock_ref_n50's env.
* The tasks: movielens_n1186 (MovieLens' synthetic fallback at ML-100k's
  943 users x 1682 movies, the graph of the most-rated kept movie, N =
  1186) trains examples/movielens.py's three models at full width
  (SelectionGNN on Trainer/evaluate, the one- and two-layer LocalGNN on
  TrainerSingleNode/evaluate_single_node; batch 5, one epoch) in bcsr mode
  (kernel 1) against dense mode from the same weights: first-step
  gradients, losses, the evaluators' costs, exact bcsr_matmul counts a
  forward, a step, a validation and an evaluation, a step's profile, and
  kernel 1 at the graph's shapes (R = 5 and 320) against its plain
  version, timed beside its bound and x @ S_dense. Then each of the seven
  task drivers (graph_neural_networks_torch/examples: movielens,
  epidemic, sourceloc, authorship, twentynews, variants, transfer) runs
  main() at full width with --epochs 1 on the synthetic fallbacks, its
  first model's first step on the card against the CPU.

* bf16 of the GRNNs, edge mode and MultiNodeAggregationGNN, and the
  native graph-structure library (after the bf16 phases): kernels 1b-3b at
  the bf16 GRNN's shapes (R = 800, 1200, 9600; a shard's 1024 columns)
  against their plain versions, timed beside f32; grnn_band_n4096's GRNNs
  served in bf16 in band and bcsr mode and sharded over mesh (1, 4), with
  the f32 engine's exact launch counts, against bf16 dense and f32;
  gat_edge_n16384 served and trained 3 steps in bf16 beside f32,
  grnn_edge_n4096 served in bf16 (no kernel launched); the
  MultiNodeAggregationGNN of static_families in bf16; and the native
  library, built from the port's own source, bit-equal to the numpy
  layouts, neighborhoods and Graclus coarsening, timed beside them.

Every phase prints JSON lines (with its seconds); any failure exits
non-zero. The last line is ``{"ok": true, "device": {...}}``.

Needs CUDA and this repository's graph_neural_networks_torch package;
imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
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
    from graph_neural_networks_torch.utils import native
    _, secs = kernels.build()
    kernels.library()
    emit(phase="build", seconds=secs, sources=list(kernels.SOURCES))
    # the native graph-structure library, from the port's own source with
    # the host compiler (the layouts built below run it)
    lib, secs = native.build()
    native.library()
    emit(phase="native_build", seconds=secs,
         library=os.path.relpath(lib, HERE), compiler=native.CXX,
         flags=list(native.CXX_FLAGS))
    # every kernel's registers and local (spill) bytes, as the runtime
    # loaded them; the graph-shift kernels' dynamic shared memory a block
    # on band_n4096's layout (kernels.SMEM_LAYOUT)
    attrs = kernels.attributes()
    emit(phase="kernel_attributes", source="cudaFuncGetAttributes",
         kernels=attrs)
    for name, a in attrs.items():
        require(a["local_bytes"] == 0,
                f"{name} uses {a['local_bytes']} bytes of local memory")
    require(len(attrs) == 58, f"{len(attrs)} kernels in the library's "
            "tables, not 58 (12 kernels; band_register_kernel in 4 "
            "instances; bcsr_matmul_kernel and its 3 narrow-tile "
            "instances on 2 block layouts, BCSR and band, 8; "
            "attn_apply_kernel in 6, attn_stats_kernel and attn_bwd_kernel "
            "in 2 each, table_transpose_kernel in 2; and the bf16-io "
            "instances: bcsr_mma_kernel in 5 tiles on 2 block layouts, 10, "
            "band_register_mma_kernel in 3 tiles x 2 stagings, 6, "
            "attn_stats_bf16_kernel global and ext, 2, "
            "attn_apply_mma_kernel in 3 groups x global and ext, 6, and "
            "attn_bwd_mma_kernel in 4 feature widths x global and ext, 8: "
            "32)")
    for name, a in attrs.items():
        if name.endswith(", bf16>") and "attn" not in name:
            require(a["dynamic_shared_bytes"] > 0,
                    f"{name}: no dynamic shared memory reported")


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
    and K-1 chained torch.matmul(z, S_dense), at each swept row count, in
    the slab's dtype (f32 or bf16); `register_wins_up_to` is the largest
    row count up to which the register beats the chained band_matmul at
    every swept count."""
    import torch
    from graph_neural_networks_torch.ops import spmm
    rows = []
    for R in SWEEP_ROWS:
        x = torch.randn(R, N, device=dev).to(sb.dtype)
        out = torch.empty(TAPS, R, N, device=dev, dtype=sb.dtype)

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
    return dict(N=N, w=w, K=TAPS, dtype=str(sb.dtype).split(".")[-1],
                rows=rows, register_wins_up_to=wins,
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


def _device_profile(fn, n, warmup=3):
    """Host ms per call of `fn` (no profiler, synchronized), device ms per
    call and the top device kernels from torch.profiler over `n` calls,
    and the device's idle share of those profiled calls' host time (the
    same window: the unprofiled calls' time can be shorter than the
    device time of the profiled ones); `warmup` calls first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
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
    row = dict(config="flock_n262k eval step",
               host_ms_per_step=prof["wall_ms"],
               profiled_host_ms_per_step=prof["profiled_wall_ms"],
               device_ms_per_step=prof["device_ms"],
               device_idle_share=prof["device_idle_share"],
               top=[dict(name=t["name"], ms_per_step=t["ms"],
                         calls_per_step=t["calls"]) for t in prof["top"]])
    emit(phase="flock_profile", nvidia_smi=card, **row)
    return row


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


def phase_flock_train_profile(trained, card, n=1):
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
                   probExpert=0.993, seed=0, wseed=5, bit_T=8, profile_n=1,
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
    prof = dict(host_store=_step_profile(host_tr, idx, 2),
                device_store=_step_profile(dev_tr, idx, 1, profiled=False))
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
    return launches, data


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
            # one profiled call after one warm-up (PR 22's cut: the
            # profiler's own processing of a sharded step's events took
            # most of this phase)
            step_prof = _device_profile(lambda: trainer.train_batch(
                next(it)), 1, warmup=1)

            def forward(arch=arch):
                with torch.inference_mode():
                    arch.apply(x, z0=z0)
            fwd_prof = _device_profile(forward, 1, warmup=1)
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


# ---------------------------------------------------------------------------
# The time-varying recurrent and aggregation controllers (GRNN_DB, AggGNN_DB)
# ---------------------------------------------------------------------------

# flock_grnn_n262k and flock_agg_n262k: flock_n262k's swarm (bench.py:
# 284-318: N = 262144, one sample, default_rng(0), env_grid=True,
# ell_degree 32, lam_iters 0) under the two other controllers of JAX
# examples/flocking.py:77-90 at their full widths: GraphRecurrentNN_DB(6,
# 2, 64, [3, 3], True, "tanh", "identity", "identity", [2], 1), whose
# payload (Ka-1)(F+H) + (Kb-1)H = 268 > 1.5 * 32 columns takes the unfused
# step (its registers shift over the emitted d_max = 32 graph), and
# AggregationGNN_DB([6, 32], [2], True, "tanh", "MaxPoolLocal", [2], [2],
# 1, nExchanges=4), whose 24 columns ride the cell table (the fused step).
# Random weights from a torch seed. The step-mode check runs at
# flock_n4096's swarm (2 samples) over T = 25.
DB_MODELS = {
    "flock_grnn_n262k": dict(kind="grnn", H=64, wseed=7, fused=False),
    "flock_agg_n262k": dict(kind="agg", dims=[6, 32], wseed=8, fused=True),
}
DB_T_CHECK = 25
DB_PAY = 24          # the AggGNN's payload: nExchanges 4 x 6 features


def _db_policy(name, dev):
    import torch
    from graph_neural_networks_torch.models.architectures_time import (
        AggregationGNN_DB, GraphRecurrentNN_DB)
    c = DB_MODELS[name]
    gen = torch.Generator().manual_seed(c["wseed"])
    if c["kind"] == "grnn":
        return GraphRecurrentNN_DB(6, 2, c["H"], [3, 3], True, "tanh",
                                   "identity", "identity", [2], 1,
                                   device=dev, generator=gen)
    return AggregationGNN_DB(c["dims"], [2], True, "tanh", "MaxPoolLocal",
                             [2], [2], 1, nExchanges=4, device=dev,
                             generator=gen)


def _window_row(args, out, shape, *, C, d_max, n_pay, r2=4.0):
    """grid_window's timing row on `args` (its output `out`): CUDA events,
    a CUDA graph's device time, the plain version, and the bound by the
    bytes this run's windows reach."""
    from graph_neural_networks_torch.ops import gridwin
    kw = dict(C=C, r2=r2, d_max=d_max, n_pay=n_pay)
    row = dict(
        shape=shape, ms=time_ms(lambda: gridwin.grid_window(*args, **kw)),
        graph_ms=graph_ms(lambda: gridwin.grid_window(*args, **kw)),
        plain_ms=time_ms(lambda: gridwin.grid_window_plain(*args, **kw),
                         reps=5, inner=2),
        library_ms=None,
        **_window_work(*args, out, C=C, n_feat=7 + n_pay, d_max=d_max))
    row["bound_ms"], row["bound_by"] = _bound(row["bytes"], row["flops"])
    return row


def phase_db_kernels(dev):
    """Kernels 5-6 at the controllers' shapes on flock_n262k's swarm, each
    against its plain version bit for bit and timed beside its bound: the
    fused AggGNN step's table (F = 7 + 24 = 31, W = 1024) and window pass
    (n_pay = 24, at d_max 0 and 32), and the unfused GRNN step's window
    pass (d_max = 32, no payload)."""
    import torch
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    results, errs, rows = [], {}, {}
    _, ip, iv, _ = _flock_setup("flock_n262k", dev)
    pos = torch.as_tensor(ip, dtype=torch.float32, device=dev)
    vel = torch.as_tensor(iv, dtype=torch.float32, device=dev)
    N = pos.shape[-1]
    C, F = 32, 7 + DB_PAY
    g = torch.Generator(device="cpu").manual_seed(7)
    v = torch.rand(1, N, generator=g).to(dev)
    pay = torch.randn(1, N, DB_PAY, generator=g).to(dev)
    W_agg = gridwin.table_width(F, C)
    require(F * C <= W_agg == 1024, f"AggGNN table: {F} x {C} lanes in "
                                    f"{W_agg}")

    def check_window(case, args, **kw):
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

    tables = {b: _grid_inputs(pos, vel, 2, C, v=v, pay=pay, builder=b)
              for b in ("scatter", "fused")}
    require(tables["fused"][-1], "262k AggGNN table overflowed")
    same = bool(torch.equal(tables["fused"][0], tables["scatter"][0]))
    results.append(dict(kernel="table_build", case="262k F=31 fused build "
                        "== scatter build", equal=same))
    require(same, "262k AggGNN fused table differs from the scatter table")
    table, own, slots, keep, _, W, _ = tables["fused"]
    require(W == W_agg, f"table width {W}")
    R, n_win = slots.shape
    require(n_win * C <= gridwin.MAX_CANDIDATES,
            f"{n_win} x {C} candidates above {gridwin.MAX_CANDIDATES}")
    args = (table, own, slots, keep)
    out_e = check_window("262k AggGNN eval: d_max=0 n_pay=24", args, C=C,
                         r2=4.0, d_max=0, n_pay=DB_PAY)
    out_t = check_window("262k AggGNN graphs: d_max=32 n_pay=24", args, C=C,
                         r2=4.0, d_max=32, n_pay=DB_PAY)
    rows["grid_window@agg"] = _window_row(
        args, out_e, f"R={R} n_win={n_win} C={C} W={W} d_max=0 "
        f"n_pay={DB_PAY}", C=C, d_max=0, n_pay=DB_PAY)
    rows["grid_window@agg_graphs"] = _window_row(
        args, out_t, f"R={R} n_win={n_win} C={C} W={W} d_max=32 "
        f"n_pay={DB_PAY}", C=C, d_max=32, n_pay=DB_PAY)
    del tables, table, args
    # the AggGNN table from sorted rows: table_build at F = 31
    starts, Hh = _cell_starts(pos)
    fs = torch.randn(1, N, F, generator=g).to(dev)
    got = gridwin.table_build(fs, starts, C=C)
    same = bool(torch.equal(got, gridwin.table_build_plain(fs, starts, C=C)))
    results.append(dict(kernel="table_build", case="262k F=31", equal=same))
    errs["table_build"] = 0.0 if same else float("nan")
    require(same, "table_build [262k F=31] differs from its plain version")
    row = dict(shape=f"N={N} F={F} H={Hh} C={C} W={got.shape[-1]}",
               ms=time_ms(lambda: gridwin.table_build(fs, starts, C=C)),
               graph_ms=graph_ms(lambda: gridwin.table_build(fs, starts,
                                                             C=C)),
               plain_ms=time_ms(lambda: gridwin.table_build_plain(
                   fs, starts, C=C), reps=5, inner=2),
               library_ms=None,
               bytes=4 * (N * F + (Hh + 1) + Hh * got.shape[-1]), flops=0)
    row["bound_ms"], row["bound_by"] = _bound(row["bytes"], row["flops"])
    rows["table_build@agg"] = row
    del got, fs
    # the unfused GRNN step: the table carries no payload (W = 256) and the
    # window pass emits the d_max = 32 graph the policy shifts over
    ua = _grid_inputs(pos, vel, 2, C, v=v)
    require(ua[-1], "262k table overflowed")
    args = ua[:4]
    out_u = check_window("262k GRNN unfused step: d_max=32 n_pay=0", args,
                         C=C, r2=4.0, d_max=32, n_pay=0)
    require(int(out_u[:, 2 * 32 + 7].max()) <= 32,
            "an in-degree above d_max at flock_n262k's swarm")
    rows["grid_window@unfused"] = _window_row(
        args, out_u, f"R={R} n_win={n_win} C={C} W={ua[5]} d_max=32 "
        "n_pay=0", C=C, d_max=32, n_pay=0)
    emit(phase="db_kernels", checks=results, timing=rows,
         seconds=time.perf_counter() - t_phase)
    return errs, rows


def phase_db_serving(dev, card):
    """flock_grnn_n262k (unfused) and flock_agg_n262k (fused) through
    Flocking.for_rollout's entry points on the kernels: rollout_cost (T =
    100) and rollout_traj_device (T = 25; the unfused step emits its graph
    every step), each against the same rollout with the plain versions
    substituted, bit for bit, with exact launch counts and peak memory;
    then step mode against split_forward over the emitted ELL history at
    flock_n4096's swarm."""
    import torch
    from graph_neural_networks_torch.ops import gridwin
    from graph_neural_networks_torch.ops.ell import EllGso
    t_phase = time.perf_counter()
    kw = dict(ell_degree=FLOCK_D, env_grid=True, lam_iters=0,
              env_grid_strict=True)
    launches = dict(grid_window=0, table_build=0, table_transpose=0)

    def expect(T):
        # as flock_n262k's: a table a step, the first step's pass and 32
        # cold-start lambda passes, then one pass a step (the unfused
        # step's graph comes out of the same pass)
        return dict(grid_window=33 + (T - 1), table_build=T,
                    table_transpose=0)

    def run(label, fn, T, N):
        gridwin.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        counts = _flock_counts()
        require(counts == expect(T), f"{label}: launches {counts}, expected "
                                     f"{expect(T)}")
        for k, n in counts.items():
            launches[k] += n
        with _plain_gridwin():
            t0 = time.perf_counter()
            plain = fn()
            torch.cuda.synchronize()
            plain_seconds = time.perf_counter() - t0
        return out, plain, dict(
            config=label, T=T, seconds=seconds, plain_seconds=plain_seconds,
            agent_steps_per_s=N * (T - 1) / seconds, peak_gb_above_base=peak,
            launches=counts)

    env, ip, iv, _ = _flock_setup("flock_n262k", dev)
    N = FLOCK["flock_n262k"]["N"]
    dt = env.samplingTime
    rows, setups = [], {}
    for name, c in DB_MODELS.items():
        net = _db_policy(name, dev)
        fused = net.payload_width <= 1.5 * FLOCK_D
        require(fused == c["fused"], f"{name}: payload {net.payload_width} "
                                     f"fused {fused}")
        (cf, ce), (pcf, pce), row = run(
            f"{name} rollout_cost", lambda: env.rollout_cost(
                ip, iv, FLOCK_T_EVAL * dt, net, **kw), FLOCK_T_EVAL, N)
        require(np.isfinite(cf) and np.isfinite(ce), f"{name}: cost")
        require((cf, ce) == (pcf, pce), f"{name} cost {cf}, {ce} vs plain "
                                        f"{pcf}, {pce}")
        rows.append(dict(row, payload_width=net.payload_width, fused=fused,
                         parameters=net.parameter_count(), cost_full=cf,
                         cost_end=ce, plain_cost_full=pcf,
                         plain_cost_end=pce))
        (pos, vel), (ppos, pvel), row = run(
            f"{name} rollout_traj_device", lambda: env.rollout_traj_device(
                ip, iv, DB_T_CHECK * dt, net, **kw), DB_T_CHECK, N)
        require(tuple(pos.shape) == (1, DB_T_CHECK, 2, N)
                and bool(torch.isfinite(pos).all()), f"{name}: trajectory")
        rows.append(dict(row, vs_plain=_rollout_compare(
            f"{name} traj", (pos, vel), (ppos, pvel))))
        setups[name] = (env, ip, iv, net)
        del pos, vel, ppos, pvel
        torch.cuda.empty_cache()

    # step mode is exact: the rollout's accelerations against the clipped
    # split_forward over the states and ELL graphs the rollout emitted
    env4, ip4, iv4, _ = _flock_setup("flock_n4096", dev)
    exact = {}
    for name in DB_MODELS:
        net = setups[name][3]
        _, _, accel, xs, g = env4.compute_trajectory(
            ip4, iv4, DB_T_CHECK * dt, net, return_graphs=True, **kw)
        as_t = lambda a, dt_=torch.float32: torch.as_tensor(
            a, device=dev).to(dt_)
        S = EllGso(as_t(g.idx, torch.int32), as_t(g.val))
        deg = int((g.val > 0).sum(-1).max())
        require(deg <= FLOCK_D, f"{name} 4096: in-degree {deg}")
        with torch.no_grad():
            y = net.split_forward(as_t(xs), S)[0]
        a_max = env4.accelMax
        got = torch.clamp(y, -a_max, a_max)[:, :-1]
        want = as_t(accel)[:, :-1]
        err, rel, agree = compare(got, want)
        exact[name] = dict(B=xs.shape[0], N=xs.shape[-1], T=DB_T_CHECK,
                           max_in_degree=deg, max_abs_err=err,
                           max_rel_err=rel, rtol=RTOL,
                           atol=f"{ATOL_REL}*max|step|")
        require(agree, f"{name}: step mode vs split_forward at 4096: max abs "
                       f"{err}, rel {rel}")
    emit(phase="db_serving", nvidia_smi=card, rows=rows,
         step_mode_exact=exact, launches=launches,
         seconds=time.perf_counter() - t_phase)
    return launches, setups, rows


def phase_db_profile(setups, serving_rows, local, card, n=10):
    """Where a step of each controller's flock_n262k rollout (rollout_cost's
    step: policy, physics, the grid env step) spends its time, beside
    LocalGNN_DB's step (`flock_profile` of this run); for the unfused GRNN,
    the share of its step that the ELL register gather (EllShiftRows'
    forward at the step's shape, CUDA events) takes."""
    import torch
    from graph_neural_networks_torch.ops import filters
    from graph_neural_networks_torch.ops.ell import EllGso
    out = {}
    for name, (env, ip, iv, net) in setups.items():
        init_fn, step_fn = env._chunked_pieces(net, FLOCK_D, 0, True,
                                               return_graphs="auto")
        with torch.no_grad():
            carry = [init_fn(env._as_device(ip), env._as_device(iv))[0]]

            def step():
                carry[0] = step_fn(carry[0])[0]

            _, peak = _peak_gb(step)
            prof = _device_profile(step, n)
            row = dict(host_ms_per_step=prof["wall_ms"],
                       profiled_host_ms_per_step=prof["profiled_wall_ms"],
                       device_ms_per_step=prof["device_ms"],
                       device_idle_share=prof["device_idle_share"],
                       step_peak_gb_above_base=peak,
                       rollout_s_100_steps=next(
                           r["seconds"] for r in serving_rows
                           if r["config"] == f"{name} rollout_cost"),
                       top=[dict(name=t["name"], ms_per_step=t["ms"],
                                 calls_per_step=t["calls"])
                            for t in prof["top"]])
            if not DB_MODELS[name]["fused"]:
                _, _, _, i_t, s_t, pstate, _, _ = carry[0]
                pay = net.rollout_payload(pstate)
                S_t = EllGso(i_t, s_t[:, None])
                gather_ms = time_ms(lambda: filters.step_shift_rows(pay,
                                                                    S_t),
                                    reps=10, inner=2)
                row.update(
                    ell_gather=dict(
                        rows=int(i_t.numel()), width=int(pay.shape[-1]),
                        gathered_gb=i_t.numel() * pay.shape[-1] * 4 / 1e9,
                        ms=gather_ms),
                    ell_gather_share_of_step_device_ms=(
                        gather_ms / prof["device_ms"]
                        if isinstance(prof["device_ms"], float)
                        else "not measured"))
            del carry
        out[name] = row
        torch.cuda.empty_cache()
    emit(phase="db_profile", nvidia_smi=card, steps=out,
         local_gnn_db_step=local)


def _db_train_net(dev):
    """flock_train_n262k's training of the GRNN at the reference width:
    GraphRecurrentNN_DB(6, 2, 64, [3, 3], ...) as JAX examples/flocking.py
    builds GraphRNN."""
    import torch
    from graph_neural_networks_torch.models.architectures_time import (
        GraphRecurrentNN_DB)
    return GraphRecurrentNN_DB(6, 2, 64, [3, 3], True, "tanh", "identity",
                               "identity", [2], 1, device=dev,
                               generator=torch.Generator().manual_seed(9))


def phase_db_training(data, dev, card, out_dir):
    """GraphRecurrentNN_DB (H = 64) trained on flock_train_n262k's device
    store (Flocking.large_device of `flock_training`, reused) through
    Model.train with TrainerFlocking(deviceStore=True, ellDegree=32) and
    randomEpoch DAGger, flock_train_n262k's cut: each step recomputes its
    supervision on kernels 5-6 and differentiates _grnn_db_ell_rows; the
    re-rolls and validations run the unfused grid rollout. First the
    first step's loss and gradients against the same step on the plain
    versions; exact launch counts; then a step profiled."""
    import torch
    from graph_neural_networks_torch import training
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    c = FLOCK_TRAIN
    T = len(np.arange(0, c["duration"], 0.01))
    lam = c["lam_iters"]
    net = _db_train_net(dev)
    require(net.payload_width > 1.5 * c["D"], "the GRNN would fuse")

    # the first step on the kernels and on the plain versions: the
    # recompute bit for bit, then the loss and every gradient (one z0)
    probe = training.TrainerFlocking(
        training.Model(net, training.losses.mse_loss,
                       {"name": "ADAM", "lr": 5e-4},
                       training.TrainerFlocking, training.evaluate_flocking,
                       name="db_probe", saveDir=out_dir),
        data, 1, 1, deviceStore=True, ellDegree=c["D"], coverageCheck=False)
    first = np.random.default_rng(c["seed"]).permutation(c["nTrain"])[:1]
    pos, vel = probe._step_args(first)
    z0 = torch.randn((1, net.H, pos.shape[-1]), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(5))
    params = list(net.parameters())

    def loss_grads(batch):
        x, y, S = batch[:3]
        loss = ((net.split_forward(x, S, z0=z0)[0] - y) ** 2).mean()
        return loss.detach(), torch.autograd.grad(loss, params)

    bk = probe._recompute(pos, vel)
    with _plain_gridwin():
        bp = probe._recompute(pos, vel)
    same = {k: bool(torch.equal(a, b)) for k, a, b in (
        ("states", bk[0], bp[0]), ("labels", bk[1], bp[1]),
        ("idx", bk[2].idx, bp[2].idx), ("val", bk[2].val, bp[2].val))}
    require(all(same.values()), f"GRNN first batch recompute: {same}")
    (lk, gk), step_peak = _peak_gb(lambda: loss_grads(bk))
    lp, gp = loss_grads(bp)
    del bp
    checks = dict(recompute_equal=same, loss=float(lk),
                  loss_plain=float(lp), learn_peak_gb_above_base=step_peak)
    rows = {}
    for (pname, _), a, b in zip(net.named_parameters(), gk, gp):
        err, rel, agree = compare(a, b, rtol=1e-4, atol_rel=1e-5)
        rows[pname] = dict(max_abs_err=err, max_rel_err=rel)
        require(agree, f"GRNN first-step gradient {pname}: kernels vs plain "
                       f"max abs {err}, rel {rel}")
    require(np.isfinite(float(lk))
            and abs(float(lk) - float(lp)) <= 1e-6 * abs(float(lp)),
            f"GRNN first-step loss {float(lk)} vs plain {float(lp)}")
    checks["grads"] = rows
    del bk, gk, gp, probe
    torch.cuda.empty_cache()

    # the path: Model.train from the store, then evaluate_flocking
    log = []
    net = _db_train_net(dev)
    model = training.Model(net, training.losses.mse_loss,
                           {"name": "ADAM", "lr": 5e-4},
                           _counting_trainer(log), training.evaluate_flocking,
                           name="db_train", saveDir=out_dir)
    gridwin.reset_launch_counts()
    torch.cuda.synchronize()
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
    losses, valid = out["lossTrain"], out["costValid"]
    require(len(losses) == c["epochs"] * c["nTrain"]
            and np.isfinite(losses).all(), f"GRNN losses {losses}")
    require(len(valid) > 0 and np.isfinite(valid).all(), f"valid {valid}")
    require(np.isfinite(list(costs.values())).all() and len(costs) == 4,
            f"costs {costs}")
    rerolls = [e for e in log if e["what"] == "reroll"]
    require(rerolls and all(e["store_changed"] for e in rerolls),
            f"GRNN learner re-rolls {rerolls}")
    recompute = _recompute_launches(T, lam)
    expect = {"step": recompute, "reroll": _rollout_launches(T, lam),
              "validation": _rollout_launches(T, lam),
              "coverage check": {k: n * c["nTrain"]
                                 for k, n in recompute.items()}}
    for e in log:
        want = expect[e["what"]]
        require(e["launches"] == want, f"GRNN {e['what']}: launches "
                                       f"{e['launches']}, expected {want}")
    ev = _rollout_launches(T, 8)
    total = {k: sum(e["launches"][k] for e in log) + 2 * ev[k]
             for k in launches}
    require(launches == total, f"GRNN path launches {launches}, its parts "
                               f"add up to {total}")
    emit(phase="db_training", nvidia_smi=card,
         config="flock_train_n262k, GraphRecurrentNN_DB H = 64",
         N=c["N"], T=T, ell_degree=c["D"], payload_width=net.payload_width,
         parameters=net.parameter_count(), train_s=train_s,
         evaluate_s=eval_s, loss=[float(v) for v in losses],
         cost_valid=[float(v) for v in valid], evaluate=costs,
         rerolls=rerolls, launches_per=dict(
             step=recompute, reroll=expect["reroll"],
             validation=expect["validation"], evaluate_rollout=ev),
         launches=launches, first_step=checks,
         seconds=time.perf_counter() - t_phase)

    # one step (the path above warmed it up): its peak memory, then one
    # step timed and one profiled
    trainer = training.TrainerFlocking(model, data, 1, 1, deviceStore=True,
                                       ellDegree=c["D"], coverageCheck=False)
    idx = np.arange(1)
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    _, peak_gb = _peak_gb(lambda: trainer.train_batch(idx))
    p = _device_profile(lambda: trainer.train_batch(idx), 1, warmup=0)
    emit(phase="db_train_profile", nvidia_smi=card,
         config="flock_train_n262k GRNN step (B = 1, T = 50, H = 64)",
         peak_gb_above_base=peak_gb, base_allocated_gb=base_gb,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         host_ms=p["wall_ms"], profiled_host_ms=p["profiled_wall_ms"],
         device_ms=p["device_ms"], device_idle_share=p["device_idle_share"],
         top=[dict(name=t["name"], ms=t["ms"], calls=t["calls"])
              for t in p["top"]])
    return launches


def phase_db_ref_training(data, dev, card, out_dir):
    """The reference experiment's other two controllers (JAX
    examples/flocking.py:83, 86 at full width: AggGNN [6, 32] with
    nExchanges 4, GraphRNN with H = 64) trained from flock_ref_n50's host
    store (`flock_ref_training`'s Flocking(50, ...), reused) for one epoch
    of batch 20, then evaluated: all pairs, so no grid kernel runs, and
    every validation and test rollout is the dense closed loop
    (Flocking._dense_pieces)."""
    import torch
    from graph_neural_networks_torch import training
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    c = FLOCK_REF
    dense_calls = []
    pieces = data._dense_pieces

    def counting_pieces(*a, **k):
        dense_calls.append(1)
        return pieces(*a, **k)

    rows = {}
    data._dense_pieces = counting_pieces
    try:
        for name, build in (
                ("AggGNN", lambda gen: _db_agg_ref(dev, gen)),
                ("GraphRNN", lambda gen: _db_train_net(dev))):
            net = build(torch.Generator().manual_seed(10))
            model = training.Model(net, training.losses.mse_loss,
                                   {"name": "ADAM", "lr": c["lr"]},
                                   training.TrainerFlocking,
                                   training.evaluate_flocking, name=name,
                                   saveDir=out_dir)
            gridwin.reset_launch_counts()
            del dense_calls[:]
            t0 = time.perf_counter()
            out = model.train(data, 1, c["batch"], validationInterval=10,
                              probExpert=c["probExpert"],
                              DAGgerType="randomEpoch", seed=c["seed"])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            n_valid = len(out["costValid"])
            costs = model.evaluate(data)
            launches = _flock_counts()
            losses = out["lossTrain"]
            require(len(losses) == c["nTrain"] // c["batch"]
                    and np.isfinite(losses).all(), f"{name} losses {losses}")
            require(n_valid > 0 and np.isfinite(out["costValid"]).all(),
                    f"{name} validation {out['costValid']}")
            require(np.isfinite(list(costs.values())).all(),
                    f"{name} costs {costs}")
            require(len(dense_calls) == n_valid + 2,
                    f"{name}: {len(dense_calls)} dense closed loops for "
                    f"{n_valid} validations and 2 test rollouts")
            require(all(v == 0 for v in launches.values()),
                    f"{name}: the all-pairs path launched grid kernels: "
                    f"{launches}")
            rows[name] = dict(parameters=net.parameter_count(),
                              train_s=train_s, loss=[float(v) for v in losses],
                              cost_valid=[float(v) for v in out["costValid"]],
                              evaluate=costs,
                              dense_closed_loops=len(dense_calls),
                              launches=launches)
    finally:
        del data._dense_pieces
    emit(phase="db_ref_training", nvidia_smi=card, config="flock_ref_n50",
         epochs=1, batch=c["batch"], models=rows,
         seconds=time.perf_counter() - t_phase)


def _db_agg_ref(dev, gen):
    from graph_neural_networks_torch.models.architectures_time import (
        AggregationGNN_DB)
    return AggregationGNN_DB([6, 32], [2], True, "tanh", "MaxPoolLocal",
                             [2], [2], 1, nExchanges=4, device=dev,
                             generator=gen)


# ---------------------------------------------------------------------------
# Edge mode (the edge-list GSO) and the architecture left-outs
# ---------------------------------------------------------------------------

# gat_edge_n16384: gat_band_n16384's GraphAttentionNetwork with
# attentionMode="edge": ops/attention_sparse.py's SDDMM and segment softmax
# on the 2.29 M edges of the S+I support, plain torch (gathers, index_add_,
# scatter_reduce; no kernel of the library), held against the same weights
# in band mode (kernels 7-9), a path that shares no code with it; GCAT and
# EdgeVariantAttention at N = 2048 against dense mode. grnn_edge_n4096:
# grnn_band_n4096's GRNNs with gsoMode="edge" against band mode (kernels
# 1-3); the edge gate against the dense one at N = 512, then alone at N =
# 4096. The left-outs at the examples' widths (examples/sourceloc.py:33,
# 137-140; examples/authorship.py:47-49, 64) on sourceloc's SBM graph (N =
# 100, 5 communities), each on the card against the CPU.
EDGE_TRAIN_STEPS = 3
EDGE_GATE_CHECK_N = 512
LEFT_N = 100
LEFT_BATCH = 100
LEFT_STEPS = 4
LEFT_RTOL = 1e-4
LEFT_ATOL_REL = 1e-4


def _all_counts():
    """Every kernel wrapper's count: the SpMM, attention and grid ones."""
    return dict(_attention_counts(), **_flock_counts())


def _reset_all_counts():
    from graph_neural_networks_torch.ops import gridwin
    _reset_counts()
    gridwin.reset_launch_counts()


def _no_kernel(what):
    """Require that no kernel of the library launched since the counts
    were set to 0: the edge-list paths are plain torch."""
    counts = _all_counts()
    require(not any(counts.values()),
            f"{what}: the edge-list path launched kernels: {counts}")


def _check_outputs(checks, model, against, pairs, rtol, atol_rel, **extra):
    for what, g, w in pairs:
        max_abs, max_rel, ok = compare(g, w, rtol, atol_rel)
        checks.append(dict(model=model, output=what, against=against,
                           max_abs_err=max_abs, max_rel_err=max_rel,
                           max_abs_ref=w.abs().max().item(), ok=ok, **extra))
        require(ok, f"{model}: {what} disagrees with {against}: {max_abs}")


@contextlib.contextmanager
def _shared_slopes(slopes, take=None, flips=None):
    """Within the block every attention score's LeakyReLU takes its slope
    from `slopes` (score > 0, one entry a call): recorded when it comes
    empty, else taken from it, as _relu_gates does for the layers' ReLU.
    A record of another layout is laid out like the score by
    `take(record, score)` (_edge_take, _band_take). A score within
    rounding of 0 takes another slope in another f32 path, which moves a
    mixer's gradient (its terms cancel) by more than the tolerance; given
    `flips`, the count of scores whose own slope the record overrides is
    appended to it a call."""
    import torch
    functional = torch.nn.functional
    leaky_relu = functional.leaky_relu
    record, calls = not slopes, iter(range(1 << 30))

    def shared(t, negative_slope=0.01, inplace=False):
        i = next(calls)
        if record:
            slopes.append(t.detach() > 0)
        m = slopes[i]
        if m.shape != t.shape:
            m = take(m, t)
        require(m.shape == t.shape, f"shared slopes: score {tuple(t.shape)}, "
                                    f"record {tuple(slopes[i].shape)}")
        if flips is not None and not record:
            flips.append(int((m != (t.detach() > 0)).sum()))
        return torch.where(m, t, t * negative_slope)
    functional.leaky_relu = shared
    try:
        yield slopes
    finally:
        functional.leaky_relu = leaky_relu


def _edge_take(edges):
    """A dense (..., N, N) slope record laid out like an edge-list score
    (nnz, ...): its entries at the (row, col) of `edges`."""
    return lambda m, t: m[..., edges.row, edges.col].movedim(-1, 0)


def _band_take(edges, w, ibs):
    """An edge-list slope record (nnz, B, P, E) laid out like the
    materialized band path's scores (B, P, E, nb, 2w+1, ibs, ibs), where
    [r, k, p, q] is row r*ibs+p and column (r+k-w)*ibs+q
    (ops/attention_band.py): the record at every edge of `edges`, the
    score's own slope elsewhere (masked out of the softmax)."""
    r, p = edges.row // ibs, edges.row % ibs
    k, q = edges.col // ibs - r + w, edges.col % ibs

    def take(m, t):
        out = t.detach() > 0
        out[..., r, k, p, q] = m.movedim(0, -1)
        return out
    return take


def _shared_gate_grads(y, models, gates, slopes=None, take=None,
                       flips=None):
    """[(loss, parameter gradients in f64)] of the CE loss against `y` for
    each (arch, forward) of `models` in turn, all on the ReLU gates in
    `gates` (_relu_gates: recorded by the first forward when it comes
    empty) and, given `slopes`, on its attention slopes (_shared_slopes)."""
    import torch
    from graph_neural_networks_torch.training import losses
    out = []
    for arch, forward in models:
        with _relu_gates(arch, gates), (
                contextlib.nullcontext() if slopes is None
                else _shared_slopes(slopes, take, flips)):
            loss = losses.cross_entropy_loss(forward(), y)
            out.append((loss.item(), [g.double() for g in torch.autograd.grad(
                loss, list(arch.parameters()))]))
    return out


def _edge_grad_rows(model, against, got, want, ref, factor=ILL_COND_FACTOR):
    """Edge-path gradients `got` against `want`, another f32 path on the
    same ReLU gates, within TRAIN_RTOL/TRAIN_ATOL_REL. `ref` is a path in
    f64 that shares no code with the edge list, on the edge path's ReLU
    gates and attention slopes. A parameter outside the tolerance of
    `want` passes only when it is within the tolerance of `ref`, or, given
    `factor` (where `ref` is `want`'s own path in f64, on its own
    branches), when `want` misses `ref` too and the edge gradient is
    within `factor` times `want`'s error there: the attention mixers'
    gradients cancel (a row's softmax gradient sums to zero), the two f32
    paths sum them in another order, and the edge path's atomic sums
    change that order run by run."""
    rows = []
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        max_abs, max_rel, ok = compare(g, w, TRAIN_RTOL, TRAIN_ATOL_REL)
        e_abs, _, e_ok = compare(g, r, TRAIN_RTOL, TRAIN_ATOL_REL)
        w_abs, _, w_ok = compare(w, r, TRAIN_RTOL, TRAIN_ATOL_REL)
        by = "tolerance"
        if not ok:
            by = "f64 reference" if e_ok else "ill_conditioned"
            ok = e_ok or (factor is not None and not w_ok
                          and e_abs <= factor * w_abs)
        rows.append(dict(model=model, against=against, param=i,
                         max_abs_err=max_abs, max_rel_err=max_rel,
                         max_abs_ref=w.abs().max().item(), edge_vs_f64=e_abs,
                         reference_vs_f64=w_abs, ok=ok, passed_by=by))
    return rows


def _edge_grads_check(checks, edge, band, x, y):
    """First-step loss and gradients of gat_edge_n16384 against band mode
    (the flash backward, kernel 9) on the band forward's ReLU gates, held
    by _edge_grad_rows with the materialized band path in f64
    (ops/attention_band.py) on the same gates and the edge forward's
    attention slopes as the reference: kernel 9 computes its scores'
    slopes inside, and the edge path's second-layer scores come from the
    first layer's atomic sums, so a few of its 36.7M scores near 0 take
    another slope from run to run. Kernel 9 itself is held to the f64
    path by _check_full_width. Returns the edge step's peak memory and
    the count of gates."""
    import copy

    import torch
    gates, slopes, flips = [], [], []
    ((band_loss, band_g),) = _shared_gate_grads(
        y, [(band, lambda: band.core(x, band.ctx)[0])], gates)
    ((edge_loss, edge_g),), peak = _peak_gb(lambda: _shared_gate_grads(
        y, [(edge, lambda: edge.core(x, edge.ctx)[0])], gates, slopes))
    require(torch.equal(edge.ctx["order_map"].cpu(),
                        band.ctx["order_map"].cpu()),
            "gat_edge_n16384: edge and band mode order the nodes apart")
    b64 = copy.deepcopy(band)
    b64.core.double()
    b64.S.s_band = b64.S.s_band.double()
    take = _band_take(edge.S, b64.S.band_w, b64.S.s_band.shape[-1])
    ((_, ref),) = _shared_gate_grads(
        y, [(b64, lambda: _materialized_forward(b64, x.double(),
                                                grad=True)[0])],
        gates, slopes, take, flips)
    del b64, slopes
    torch.cuda.empty_cache()
    rows = _edge_grad_rows("gat_edge_n16384", "band (kernel 9)", edge_g,
                           band_g, ref, factor=None)
    loss_ok = abs(edge_loss - band_loss) <= LOSS_RTOL * abs(band_loss)
    rows.append(dict(model="gat_edge_n16384", output="first-step loss",
                     against="band", loss=edge_loss, band_loss=band_loss,
                     ok=loss_ok))
    emit(phase="gat_edge_grads", rtol=TRAIN_RTOL,
         atol=f"{TRAIN_ATOL_REL}*max|band|",
         f64_reference="materialized band path, f64, the band forward's "
                       "ReLU gates and the edge forward's attention slopes",
         f64_slopes_overridden_per_layer=flips, checks=rows)
    checks.extend(rows)
    for row in rows:
        require(row["ok"], f"gat_edge_n16384: {row}")
    return peak, sum(int(g.numel()) for g in gates)


def _edge_small_check(checks, rng, dev):
    """GCAT and EdgeVariantAttention at N = 2048 in edge mode against
    dense mode: outputs, then first-step gradients on the dense forward's
    ReLU gates and attention slopes, held by _edge_grad_rows with dense
    mode in f64 as the reference."""
    import copy

    import torch
    S2, _ = make_graph(GAT_SMALL_N, 0.01, 256, seed=1)
    for cls_name, dims, heads, taps in (
            ("GraphConvolutionAttentionNetwork", [64, 16, 16], [2, 2],
             [3, 2]),
            ("EdgeVariantAttention", [32, 16], [2], [3])):
        archs = {m: _build_gat(cls_name, S2, m, dev, dims, heads, taps)
                 for m in ("edge", "dense")}
        data = _synthetic_data(rng, (GAT_BATCH, 1, 1), dims[0], GAT_SMALL_N,
                               4)
        x = data.samples["train"]["signals"]
        _reset_all_counts()
        with torch.inference_mode():
            got = archs["edge"].split_forward(x)
        _no_kernel(f"{cls_name} edge")
        with torch.inference_mode():
            want = archs["dense"].split_forward(x)
        label = f"{cls_name} N={GAT_SMALL_N} edge"
        _check_outputs(checks, label, "dense", zip(("y", "y_gfl"), got,
                                                   want),
                       SERVE_RTOL, SERVE_ATOL_REL, batch=GAT_BATCH)
        x, y = (torch.as_tensor(a, device=dev) for a in data.getSamples(
            "train", np.random.default_rng(0).permutation(GAT_BATCH)))
        d64 = copy.deepcopy(archs["dense"])
        d64.core.double()
        d64.S.S = d64.S.S.double()
        (_, want), (_, got), (_, ref) = _shared_gate_grads(y, [
            (a, lambda a=a, t=t: a.core(t, a.ctx)[0])
            for a, t in ((archs["dense"], x), (archs["edge"], x),
                         (d64, x.double()))], [], [],
            _edge_take(archs["edge"].S))
        rows = _edge_grad_rows(label, "dense", got, want, ref)
        checks.extend(rows)
        for row in rows:
            require(row["ok"], f"{label}: {row}")


def phase_gat_edge(rng, dev, out_dir):
    """gat_edge_n16384, the main path of this phase: built from the graph
    (the edge list on the host), served through InferenceEngine and
    trained through Model.train in edge mode, each held against the same
    weights in band mode; the edge path launches no kernel, the band
    reference exactly its own. Then GCAT and EdgeVariantAttention at N =
    2048 in edge mode against dense mode."""
    import torch
    from graph_neural_networks_torch.ops import attention_sparse as asp
    from graph_neural_networks_torch.serving import InferenceEngine
    t_phase = time.perf_counter()
    S, _ = make_graph(GAT_N, 0.01, 256, seed=1)
    t0 = time.perf_counter()
    edge = _build_gat("GraphAttentionNetwork", S, "edge", dev)
    torch.cuda.synchronize()
    t_edge = time.perf_counter() - t0
    t0 = time.perf_counter()
    listed = asp.build_edge_list(S, device=dev)
    torch.cuda.synchronize()
    t_list = time.perf_counter() - t0
    band = _build_gat("GraphAttentionNetwork", S, "band", dev)
    support = int(np.count_nonzero(S)) - int(np.count_nonzero(np.diag(S))) \
        + GAT_N
    require(isinstance(edge.S, asp.EdgeList) and edge.S.nnz == support
            and torch.equal(edge.S.col, listed.col),
            f"gat_edge_n16384: {getattr(edge.S, 'nnz', None)} edges, the "
            f"S+I support has {support}")
    require(all(torch.equal(p, q) for p, q in zip(edge.parameters(),
                                                  band.parameters())),
            "gat_edge_n16384: edge and band weights differ")
    del listed
    emit(phase="gat_edge_graph", N=GAT_N, nnz=support,
         host_seconds_build_model=t_edge,
         host_seconds_build_edge_list=t_list,
         edge_list_gb=(edge.S.row.numel() * 8 * 2
                       + edge.S.s_val.numel() * 4) / 1e9)
    engines = {m: InferenceEngine(a, GAT_BATCH, dev)
               for m, a in (("edge", edge), ("band", band))}
    requests = [rng.standard_normal((n, GAT_DIMS[0], GAT_N)).astype(
        np.float32) for n in GAT_REQUESTS]
    answers, seconds, launches, checks = {}, {}, {}, []
    for mode in ("edge", "band"):
        # each mode's path: the counts set to 0 just before, read just after
        _reset_all_counts()
        t0 = time.perf_counter()
        answers[mode] = [engines[mode](x) for x in requests]
        torch.cuda.synchronize()
        seconds[mode] = time.perf_counter() - t0
        launches[mode] = _all_counts()
        if mode == "edge":
            _no_kernel("gat_edge_n16384 serving")
    expected = {k: 0 for k in launches["band"]}
    expected.update(stats_call=2 * len(requests), apply_call=2 * len(requests))
    require(launches["band"] == expected,
            f"gat_band_n16384 reference: launches {launches['band']}, "
            f"expected {expected}")
    for x, got, want in zip(requests, answers["edge"], answers["band"]):
        require(tuple(got.shape) == (x.shape[0], 4)
                and bool(torch.isfinite(got).all()),
                f"gat_edge_n16384: output {tuple(got.shape)}")
        _check_outputs(checks, "gat_edge_n16384", "band (kernels 7-8)",
                       [("y", got, want)], SERVE_RTOL, SERVE_ATOL_REL,
                       batch=x.shape[0])
    with torch.inference_mode():
        gfl = [engines[m].arch.split_forward(requests[0])[1]
               for m in ("edge", "band")]
    _check_outputs(checks, "gat_edge_n16384", "band (kernels 7-8)",
                   [("y_gfl", gfl[0], gfl[1])], SERVE_RTOL, SERVE_ATOL_REL,
                   batch=requests[0].shape[0])
    del gfl
    _, serve_peak = _peak_gb(lambda: engines["edge"](requests[0]))
    emit(phase="gat_edge_serving", model="gat_edge_n16384",
         requests=list(GAT_REQUESTS), seconds=seconds["edge"],
         band_seconds=seconds["band"], forward_peak_gb=serve_peak,
         band_launches={k: v for k, v in launches["band"].items() if v})
    _profile_forward("gat_edge_n16384 edge", engines["edge"], requests[0],
                     n=5)
    del answers

    # training: the first step's gradients, then EDGE_TRAIN_STEPS steps of
    # Model.train in each mode from the same weights
    x = torch.as_tensor(rng.standard_normal(
        (GAT_BATCH, GAT_DIMS[0], GAT_N)).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.integers(0, 4, GAT_BATCH), device=dev)
    grad_peak, n_gates = _edge_grads_check(checks, edge, band, x, y)
    del x, y
    torch.cuda.empty_cache()
    data = _synthetic_data(rng, (EDGE_TRAIN_STEPS * GAT_BATCH, GAT_BATCH,
                                 GAT_BATCH), GAT_DIMS[0], GAT_N, 4)
    outs, train_launches = {}, {}
    for mode, arch in (("edge", edge), ("band", band)):
        model = _model(arch, f"gat_{mode}_n16384", out_dir)
        _reset_all_counts()
        t0 = time.perf_counter()
        out = model.train(data, nEpochs=1, batchSize=GAT_BATCH,
                          validationInterval=EDGE_TRAIN_STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _all_counts()
        n_val = len(out["costValid"])
        require(len(out["lossTrain"]) == EDGE_TRAIN_STEPS
                and bool(np.isfinite(out["lossTrain"]).all()),
                f"gat_{mode}_n16384: losses {out['lossTrain']}")
        if mode == "edge":
            _no_kernel("gat_edge_n16384 training")
        else:
            want = {k: 0 for k in counts}
            want.update(stats_call=2 * (EDGE_TRAIN_STEPS + n_val),
                        apply_call=2 * (EDGE_TRAIN_STEPS + n_val),
                        bwd_call=2 * EDGE_TRAIN_STEPS)
            require(counts == want, f"gat_band_n16384 reference training: "
                                    f"launches {counts}, expected {want}")
            train_launches = counts
        outs[mode] = (model, out, secs)
    e_loss, b_loss = outs["edge"][1]["lossTrain"], outs["band"][1]["lossTrain"]
    ok = bool(np.allclose(e_loss, b_loss, rtol=LOSS_RTOL, atol=0))
    checks.append(dict(model="gat_edge_n16384", output="losses",
                       against="band", losses=e_loss.tolist(),
                       band_losses=b_loss.tolist(), ok=ok))
    require(ok, f"gat_edge_n16384: losses {e_loss} vs band {b_loss}")
    model = outs["edge"][0]
    from graph_neural_networks_torch import training
    trainer = training.Trainer(model, data, 1, GAT_BATCH)
    _, step_peak = _peak_gb(lambda: trainer.train_batch(
        np.arange(GAT_BATCH)))
    emit(phase="gat_edge_training", model="gat_edge_n16384",
         steps=EDGE_TRAIN_STEPS, batch=GAT_BATCH, losses=e_loss.tolist(),
         band_losses=b_loss.tolist(), seconds=outs["edge"][2],
         band_seconds=outs["band"][2],
         step_ms=(np.asarray(outs["edge"][1]["timeTrain"]) * 1e3).tolist(),
         band_step_ms=(np.asarray(outs["band"][1]["timeTrain"])
                       * 1e3).tolist(),
         grad_peak_gb=grad_peak, step_peak_gb=step_peak, relu_gates=n_gates,
         band_launches={k: v for k, v in train_launches.items() if v})
    phase_train_profile({"gat_edge_n16384 edge": (model, data, GAT_BATCH)},
                        2, "gat_edge_train_profile")
    del outs, model, trainer, engines, edge, band
    torch.cuda.empty_cache()

    _edge_small_check(checks, rng, dev)
    emit(phase="gat_edge_check", serve_rtol=SERVE_RTOL,
         serve_atol=f"{SERVE_ATOL_REL}*max|reference|", train_rtol=TRAIN_RTOL,
         train_atol=f"{TRAIN_ATOL_REL}*max|reference|", loss_rtol=LOSS_RTOL,
         checks=checks, seconds=time.perf_counter() - t_phase)
    return {k: launches["band"].get(k, 0) + train_launches.get(k, 0)
            for k in ("stats_call", "apply_call", "bwd_call")}


def phase_grnn_edge(S_np, rng, dev, out_dir):
    """grnn_edge_n4096: the ungated, time- and node-gated GRNNs of
    grnn_band_n4096 with gsoMode="edge" against the same weights in band
    mode: split_forward on one z0, requests through InferenceEngine, the
    first step's gradients, GRNN_STEPS steps of Model.train (the edge path
    launches no kernel; the band reference exactly its counts); a step's
    peak. The edge gate against the dense edge gate at N =
    EDGE_GATE_CHECK_N, then trained alone at N = 4096."""
    import torch
    from graph_neural_networks_torch import training
    from graph_neural_networks_torch.ops import attention_sparse as asp
    from graph_neural_networks_torch.serving import InferenceEngine
    t_phase = time.perf_counter()
    B, N, T = GRNN_BATCH, N_GRAPH, GRNN_T
    t0 = time.perf_counter()
    nnz = asp.build_edge_list(S_np).nnz
    emit(phase="grnn_edge_graph", N=N, nnz=nnz,
         host_seconds_build_edge_list=time.perf_counter() - t0)
    launches = {k: 0 for k in _attention_counts()}
    checks = []
    x = rng.integers(0, 3, (B, T, 1, N)).astype(np.float32)
    requests = [rng.integers(0, 3, (n, T, 1, N)).astype(np.float32)
                for n in GRNN_REQUESTS]
    data = _sequence_data(rng, (GRNN_STEPS * B, B, B), N)
    z0 = _z0(dev)
    for gate in GRNN_GATES:
        name = _gate_name(gate)
        band, edge = (_grnn(S_np, m, dev, gate) for m in ("band", "edge"))
        require(isinstance(edge.S, asp.EdgeList) and edge.S.nnz == nnz
                and all(torch.equal(p, q) for p, q in
                        zip(edge.parameters(), band.parameters())),
                f"{name}: the edge model's list or weights")
        with torch.inference_mode():
            want = band.split_forward(x, z0=z0)
        _reset_all_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            got = edge.split_forward(x, z0=z0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _no_kernel(f"{name} edge forward")
        _check_outputs(checks, f"{name} edge", "band (kernels 1-3)",
                       zip(("y", "y_output_layer"), got, want), SERVE_RTOL,
                       SERVE_ATOL_REL,
                       per_step_max_abs_err=_per_step_err(got[0], want[0]))
        engs = {m: InferenceEngine(a, B, dev) for m, a in (("edge", edge),
                                                           ("band", band))}
        _reset_all_counts()
        answers = [engs["edge"](r) for r in requests]
        _no_kernel(f"{name} edge requests")
        _reset_counts()
        for r, y in zip(requests, answers):
            _check_outputs(checks, f"{name} edge", "band (kernels 1-3)",
                           [("request", y, engs["band"](r))], SERVE_RTOL,
                           SERVE_ATOL_REL, batch=r.shape[0])
        fwd = _grnn_launches("band", gate, False)
        require(_attention_counts() == _expect(fwd, scale=(len(requests),)),
                f"{name} band reference requests: {_attention_counts()}")
        for k, v in fwd.items():
            launches[k] += v * len(requests)
        _check_grads(checks, f"{name} edge", "band (kernels 1-3)",
                     _grnn_grads(edge, data, z0)[1],
                     _grnn_grads(band, data, z0)[1])
        step = _grnn_launches("band", gate, True)
        runs = {}
        for mode, arch in (("edge", edge), ("band", band)):
            model = _grnn_model(arch, f"{name}_{mode}", out_dir)
            _reset_all_counts()
            runs[mode] = (model,) + _grnn_train(
                model, data, fwd if mode == "band" else {},
                step if mode == "band" else {})
            if mode == "edge":
                _no_kernel(f"{name} edge training")
        for k, v in runs["band"][2].items():
            launches[k] += v
        e_loss = runs["edge"][1]["lossTrain"]
        b_loss = runs["band"][1]["lossTrain"]
        ok = bool(np.allclose(e_loss, b_loss, rtol=LOSS_RTOL, atol=0))
        checks.append(dict(model=f"{name} edge", output="losses",
                           against="band", losses=e_loss.tolist(),
                           band_losses=b_loss.tolist(), ok=ok))
        require(ok, f"{name} edge: losses {e_loss} vs band {b_loss}")
        trainer = training.Trainer(runs["edge"][0], data, 1, B)
        _, peak = _peak_gb(lambda: trainer.train_batch(np.arange(B)))
        emit(phase="grnn_edge", model=name, N=N, batch=B, T=T,
             forward_seconds=secs, losses=e_loss.tolist(),
             band_losses=b_loss.tolist(), seconds=runs["edge"][3],
             step_ms=(np.asarray(runs["edge"][1]["timeTrain"])
                      * 1e3).tolist(),
             evaluate=runs["edge"][4], step_peak_gb=peak)
        if gate is None:
            _profile_forward(f"grnn_edge_n4096 {name} edge", engs["edge"],
                             requests[0], n=3)
            phase_train_profile(
                {f"grnn_edge_n4096 {name} edge": (runs["edge"][0], data, B)},
                2, "grnn_edge_train_profile")
        del runs, engs, band, edge, trainer
        torch.cuda.empty_cache()

    # the edge gate: per-edge gates against the dense (B*T, N, N) gates at
    # N = EDGE_GATE_CHECK_N, the same weights and z0
    n5 = EDGE_GATE_CHECK_N
    S5 = banded_graph(np.random.default_rng(26), n5, 64, 0.2)
    dense, edge = (_grnn(S5, m, dev, "edge") for m in ("dense", "edge"))
    x5 = rng.integers(0, 3, (B, T, 1, n5)).astype(np.float32)
    z5 = torch.as_tensor(rng.standard_normal((B, GRNN_H, n5)).astype(
        np.float32), device=dev)
    with torch.inference_mode():
        want = dense.split_forward(x5, z0=z5)
        _reset_all_counts()
        got = edge.split_forward(x5, z0=z5)
    _no_kernel("GatedGRNN-edge edge forward")
    _check_outputs(checks, f"GatedGRNN-edge N={n5} edge", "dense edge gate",
                   zip(("y", "y_output_layer"), got, want), SERVE_RTOL,
                   SERVE_ATOL_REL)
    data5 = _sequence_data(rng, (B, B, B), n5)
    (_, g_dense), dense_peak = _peak_gb(lambda: _grnn_grads(dense, data5, z5))
    (_, g_edge), edge_peak = _peak_gb(lambda: _grnn_grads(edge, data5, z5))
    _check_grads(checks, f"GatedGRNN-edge N={n5} edge", "dense edge gate",
                 g_edge, g_dense)
    emit(phase="grnn_edge_gate_check", N=n5, nnz=edge.S.nnz,
         dense_grad_peak_gb=dense_peak, edge_grad_peak_gb=edge_peak)
    del dense, edge, g_dense, g_edge
    torch.cuda.empty_cache()

    # the edge gate alone at N = 4096 (its dense gates would be 54 GB)
    edge = _grnn(S_np, "edge", dev, "edge")
    model = _grnn_model(edge, "GatedGRNN-edge_edge", out_dir)
    _reset_all_counts()
    out, _, secs, result = _grnn_train(model, data, {}, {})
    _no_kernel("GatedGRNN-edge edge training")
    trainer = training.Trainer(model, data, 1, B)
    _, peak = _peak_gb(lambda: trainer.train_batch(np.arange(B)))
    emit(phase="grnn_edge", model="GatedGRNN-edge", N=N, batch=B, T=T,
         nnz=nnz, losses=out["lossTrain"].tolist(), seconds=secs,
         step_ms=(np.asarray(out["timeTrain"]) * 1e3).tolist(),
         evaluate=result, step_peak_gb=peak)
    emit(phase="grnn_edge_check", rtol=SERVE_RTOL,
         atol=f"{SERVE_ATOL_REL}*max|reference|", train_rtol=TRAIN_RTOL,
         train_atol=f"{TRAIN_ATOL_REL}*max|reference|", loss_rtol=LOSS_RTOL,
         checks=checks, seconds=time.perf_counter() - t_phase)
    del model, trainer, edge
    torch.cuda.empty_cache()
    return launches


def _left_out_models(S, N):
    """The item-3 architectures at the examples' widths: (name, build(device),
    classes)."""
    import torch
    from graph_neural_networks_torch.models import architectures as archs

    def kw(d):
        return dict(device=d, generator=torch.Generator().manual_seed(0))
    sel = ([1, 32, 32], [5, 5], True, "relu")
    local = ([1, 32], [5], True)
    return [
        ("SelectionGNN coarsening", lambda d: archs.SelectionGNN(
            *sel, [0, 0], "MaxPoolLocal", [2, 2], [5], S, coarsening=True,
            rng=np.random.default_rng(1), **kw(d)), 5),
        ("LocalActivationGNN max", lambda d: archs.LocalActivationGNN(
            *local, "max_local", [3], [N], "NoPool", [1], [2], S,
            order="Degree", **kw(d)), 2),
        ("LocalActivationGNN median", lambda d: archs.LocalActivationGNN(
            *local, "median_local", [3], [N], "NoPool", [1], [2], S,
            order="Degree", **kw(d)), 2),
        ("SelectionGNN EDS", lambda d: archs.SelectionGNN(
            *sel, [10, 10], "MaxPoolLocal", [6, 8], [5], S, order="EDS",
            **kw(d)), 5),
        ("SelectionGNN SpectralProxies", lambda d: archs.SelectionGNN(
            *sel, [10, 10], "MaxPoolLocal", [6, 8], [5], S,
            order="SpectralProxies", **kw(d)), 5),
    ]


def phase_left_outs(rng, dev, out_dir):
    """The architecture left-outs (Graclus coarsening, the local
    activations, the EDS and SpectralProxies orderings) at the examples'
    widths on sourceloc's SBM graph: each model's forward and gradients on
    the card against the same model on the CPU, served through
    InferenceEngine and trained LEFT_STEPS steps through Model.train.
    Dense mode: no kernel of the library runs."""
    import torch
    from graph_neural_networks_torch.serving import InferenceEngine
    from graph_neural_networks_torch.utils import graph as gt
    t_phase = time.perf_counter()
    N = LEFT_N
    W = gt.Graph("SBM", N, {"nCommunities": 5, "probIntra": 0.8,
                            "probInter": 0.2},
                 rng=np.random.default_rng(0)).W
    S = W / np.max(np.abs(np.linalg.eigvalsh(W)))
    checks = []
    for name, build, classes in _left_out_models(S, N):
        data = _synthetic_data(rng, (LEFT_STEPS * LEFT_BATCH, LEFT_BATCH,
                                     LEFT_BATCH), 1, N, classes)
        x = data.samples["valid"]["signals"]
        outs = {}
        for where in ("cpu", dev):
            t0 = time.perf_counter()
            arch = build(where)
            built = time.perf_counter() - t0
            y = arch.apply(x)
            grads = torch.autograd.grad(torch.mean(y ** 2),
                                        list(arch.parameters()))
            outs[str(where)] = (arch, built, y.detach().cpu(),
                                [g.cpu() for g in grads])
        (_, _, y_c, g_c), (arch, built, y_g, g_g) = (outs["cpu"],
                                                     outs[str(dev)])
        _check_outputs(checks, name, "cpu",
                       [("y", y_g, y_c)] + [(f"grad {i}", g, w) for i, (g, w)
                                            in enumerate(zip(g_g, g_c))],
                       LEFT_RTOL, LEFT_ATOL_REL)
        require(outs["cpu"][0].order == arch.order,
                f"{name}: the node order differs between the CPU and the card")
        _reset_all_counts()
        served = InferenceEngine(arch, LEFT_BATCH, dev)(x)
        _check_outputs(checks, name, "its own forward",
                       [("served", served, y_g.to(dev))], LEFT_RTOL,
                       LEFT_ATOL_REL)
        model = _model(arch, name.replace(" ", "_"), out_dir)
        t0 = time.perf_counter()
        out = model.train(data, nEpochs=1, batchSize=LEFT_BATCH,
                          validationInterval=LEFT_STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        require(len(out["lossTrain"]) == LEFT_STEPS
                and bool(np.isfinite(out["lossTrain"]).all()),
                f"{name}: losses {out['lossTrain']}")
        result = model.evaluate(data, doSaveVars=False)
        require(all(r is not None and 0 <= r <= 1 for r in result.values()),
                f"{name}: evaluate {result}")
        require(not any(_all_counts().values()),
                f"{name}: dense mode launched kernels: {_all_counts()}")
        emit(phase="left_outs", model=name, N=N, nodes=list(arch.N),
             params=arch.parameter_count(), host_seconds_build=built,
             losses=out["lossTrain"].tolist(), seconds=secs,
             evaluate=result)
    emit(phase="left_outs_check", rtol=LEFT_RTOL,
         atol=f"{LEFT_ATOL_REL}*max|cpu|", checks=checks,
         seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# The chunked all-pairs env, the windowed re-forward, the segmented rollouts
# and the host loop
# ---------------------------------------------------------------------------

# flock_n4096_chunked: examples/largeswarm.py --no-envGrid's deployment:
# flock_n4096's swarm (2 samples, default_rng(1)) and policy
# (LocalGNN_DB([6,64], [3]), random weights), T = 100, ell_degree 32,
# env_chunk 512 (n_deploy // 8), lam_iters 0. flock_n65536_chunked: the
# same policy at N = 65536, env_chunk 8192 (Flocking.large's N // 8), one
# sample, T = 25, rollout_cost only (a dense all-pairs step cannot run
# there: one (N, N) f32 matrix is 17.2 GB). flock_largetrain_n4096_chunked:
# examples/largeswarm.py --largeTrain --no-envGrid --trainAgents 4096
# --nTrain 4 --batch 1 --trainDuration 0.5: Flocking.large(env_grid=None)
# (env_chunk 512, lam_iters 8, T = 50, 6 samples), TrainerFlocking
# (ellDegree 32), 2 epochs.
CHUNK = dict(D=32, chunk=512, lam_iters=0, T=FLOCK_T_EVAL, w=3, seg=8,
             T_close=10, T_dense=10, dense_lam_iters=64, big_N=65536,
             big_chunk=8192, big_T=25, shard_chunk=128, shard_T=25,
             profile_n=5)
CHUNK_TRAIN = dict(N=4096, nTrain=4, nValid=1, nTest=1, duration=0.5, D=32,
                   lam_iters=8, epochs=2, probExpert=0.993, seed=0, wseed=6,
                   relabel_steps=(0, 12, 24, 36, 49))
CHUNK_HOST = dict(N=50, B=20, seed=0, T=100, w=3, wseed=7)
CHUNK_RTOL = 1e-4          # a rollout against another form of it
CHUNK_STEP_ATOL_REL = 1e-5  # one env step against another
CHUNK_GRID_TOL = 2e-4      # chunked against grid rollouts (JAX test_ell.py)


def _max_dev(a, b):
    """Largest |a - b| of two host or device arrays."""
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _rollouts_close(label, got, want, rtol=CHUNK_RTOL, atol=CHUNK_RTOL,
                    fields=("pos", "vel")):
    """got/want: (pos, vel, ...) host arrays; |got - want| <= atol + rtol
    |want| on each field named. Returns the deviations."""
    out = {}
    for name, a, b in zip(fields, got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        ok = bool(np.isfinite(a).all()
                  and (np.abs(a - b) <= atol + rtol * np.abs(b)).all())
        out[name] = dict(max_abs_err=_max_dev(a, b), ok=ok)
        require(ok, f"{label}: {name} {out[name]}")
    return out


def _dense_rows(idx, val, N):
    """(B, N, N) dense matrices of (B, N, D) ELL rows, whatever the slot
    order."""
    import torch
    B = idx.shape[0]
    S = torch.zeros((B, N, N), dtype=torch.float32, device=idx.device)
    return S.scatter_add_(2, idx.long(), val.float())


def _dense_sets(idx, val, N):
    """The neighbour sets of (B, N, D) ELL rows as (B, N, N) 0/1
    matrices."""
    return _dense_rows(idx, (val > 0).float(), N)


def _state_check(label, got, want, axis=1):
    """|got - want| <= CHUNK_STEP_ATOL_REL * the channel's largest value."""
    import torch
    got, want = got.double(), want.double()
    dims = tuple(i for i in range(want.dim()) if i != axis)
    scale = want.abs().amax(dim=dims, keepdim=True)
    err = (got - want).abs()
    ok = bool((err <= CHUNK_STEP_ATOL_REL * scale).all()
              and torch.isfinite(got).all())
    out = dict(max_abs_err=err.max().item(),
               max_err_over_channel_max=(err / scale.clamp_min(1e-30))
               .max().item(), ok=ok)
    require(ok, f"{label}: {out}")
    return out


def _timed_rollout(fn):
    """(fn(), seconds, peak GB above the start), synchronized."""
    import torch
    t0 = time.perf_counter()
    out, peak = _peak_gb(fn)
    return out, time.perf_counter() - t0, peak


def phase_chunked_serving(dev, card):
    """flock_n4096_chunked through Flocking.compute_trajectory on the
    chunked all-pairs env: (a) step mode, (b) the windowed re-forward at
    w = causal_window (3) against (a), (c) seg=8 bit-equal to (a), (d) the
    grid rollout (kernels 5-6, counted) from the same state, one env step
    at t = 0 against the chunked step (neighbour sets, states, values) and
    the first 10 steps' positions, and the windowed re-forward on the grid
    against the grid's step mode, (e) the all-pairs dense loop (ell_topk,
    lambda by 64-pass power iteration) against the chunked env at
    lam_iters 64 over 10 steps; a step's host and device ms, idle share
    and peak memory. No kernel runs on the chunked path."""
    import torch
    from graph_neural_networks_torch.data import flocking as fl
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    c = CHUNK
    env, ip, iv, net = _flock_setup("flock_n4096", dev)
    N, B = ip.shape[-1], ip.shape[0]
    dt = env.samplingTime
    dur = c["T"] * dt
    kw = dict(ell_degree=c["D"], env_chunk=c["chunk"],
              lam_iters=c["lam_iters"])
    rows = {}
    gridwin.reset_launch_counts()
    a, a_s, a_peak = _timed_rollout(
        lambda: env.compute_trajectory(ip, iv, dur, net, **kw))
    b, b_s, b_peak = _timed_rollout(
        lambda: env.compute_trajectory(ip, iv, dur, net, step_mode=False,
                                       history_window=c["w"], **kw))
    s, s_s, s_peak = _timed_rollout(
        lambda: env.compute_trajectory(ip, iv, dur, net, seg=c["seg"], **kw))
    chunk_counts = _flock_counts()
    require(not any(chunk_counts.values()),
            f"the chunked env launched grid kernels: {chunk_counts}")
    require(a[4].idx.shape == (B, c["T"], N, c["D"]), "chunked graphs")
    rows["a_step_mode"] = dict(seconds=a_s, peak_gb=a_peak,
                               ms_per_step=a_s / (c["T"] - 1) * 1e3,
                               cost=env.evaluate(vel=a[1]),
                               max_in_degree=int((a[4].val > 0).sum(-1)
                                                 .max()))
    rows["b_windowed"] = dict(seconds=b_s, peak_gb=b_peak, w=c["w"],
                              vs_a=_rollouts_close("windowed vs step", b, a),
                              cost=env.evaluate(vel=b[1]))
    same = {f: bool(np.array_equal(x, y)) for f, x, y in zip(
        ("pos", "vel", "accel", "states"), s[:4], a[:4])}
    same["idx"] = bool(np.array_equal(s[4].idx, a[4].idx))
    same["val"] = bool(np.array_equal(s[4].val, a[4].val))
    require(all(same.values()), f"seg={c['seg']} differs: {same}")
    rows["c_segmented"] = dict(seconds=s_s, peak_gb=s_peak, seg=c["seg"],
                               equal_to_a=same)

    # (d) the grid from the same state: one step at t = 0, then rollouts
    pos = torch.as_tensor(ip, dtype=torch.float32, device=dev)
    vel = torch.as_tensor(iv, dtype=torch.float32, device=dev)
    v0 = torch.ones((B, N), device=dev) / np.sqrt(N)
    gridwin.reset_launch_counts()
    gi, gs, gx, _, deg, ok = fl.env_step_grid(
        pos, vel, 2.0, c["D"], v0, lam_iters=0, cell_cap=32, cell_factor=2,
        in_degree=True)
    step_counts = _flock_counts()
    D = max(c["D"], int(deg.max()))
    if D > c["D"]:                      # the sets compare untruncated
        gi, gs, gx, _, ok = fl.env_step_grid(
            pos, vel, 2.0, D, v0, lam_iters=0, cell_cap=32, cell_factor=2)
        step_counts = _flock_counts()
    require(bool(ok), "grid step at t = 0: cell overflow")
    ci, cs, cx, _ = fl.env_step_chunked(pos, vel, 2.0, D, c["chunk"], v0,
                                        lam_iters=0)
    Sg, Sc = _dense_sets(gi, gs, N), _dense_sets(ci, cs, N)
    require(bool(torch.equal(Sg, Sc)), "grid and chunked neighbour sets "
                                       "differ at t = 0")
    step_check = dict(
        d_max=D, largest_in_degree=int(deg.max()),
        edges=int(Sc.sum().item()), neighbour_sets_equal=True,
        states=_state_check("t = 0 states, grid vs chunked", gx, cx),
        values=_state_check("t = 0 values, grid vs chunked",
                            _dense_rows(gi, gs, N), _dense_rows(ci, cs, N),
                            axis=0),
        launches=step_counts)
    del Sg, Sc
    gkw = dict(ell_degree=c["D"], env_grid=True, lam_iters=c["lam_iters"])
    gridwin.reset_launch_counts()
    g, g_s, _ = _timed_rollout(
        lambda: env.compute_trajectory(ip, iv, dur, net, **gkw))
    g_counts = _flock_counts()
    want = dict(grid_window=33 + (c["T"] - 1), table_build=c["T"],
                table_transpose=0)
    require(g_counts == want, f"grid rollout launches {g_counts}, expected "
                              f"{want}")
    gridwin.reset_launch_counts()
    gw, gw_s, _ = _timed_rollout(
        lambda: env.compute_trajectory(ip, iv, dur, net, step_mode=False,
                                       history_window=c["w"], **gkw))
    gw_counts = _flock_counts()
    require(gw_counts == want, f"grid windowed launches {gw_counts}, "
                               f"expected {want}")
    first = c["T_close"]
    close10 = _rollouts_close(
        f"chunked vs grid, first {first} steps",
        (a[0][:, :first], a[1][:, :first]), (g[0][:, :first],
                                             g[1][:, :first]),
        rtol=CHUNK_GRID_TOL, atol=CHUNK_GRID_TOL)
    rows["d_grid"] = dict(
        seconds=g_s, t0_step=step_check, first_steps=first,
        first_steps_vs_chunked=close10,
        max_dev_all_steps=dict(pos=_max_dev(a[0], g[0]),
                               vel=_max_dev(a[1], g[1])),
        cost_full=dict(chunked=env.evaluate(vel=a[1]),
                       grid=env.evaluate(vel=g[1])),
        cost_end=dict(chunked=env.evaluate(vel=a[1][:, -1:]),
                      grid=env.evaluate(vel=g[1][:, -1:])),
        launches=g_counts,
        windowed=dict(seconds=gw_s, launches=gw_counts,
                      vs_grid_step=_rollouts_close("grid windowed vs step",
                                                   gw, g)))
    launches = {k: step_counts[k] + g_counts[k] + gw_counts[k]
                for k in g_counts}

    # (e) the all-pairs dense loop, lambda by 64-pass power iteration
    dur_e = c["T_dense"] * dt
    e_dense, e_s, e_peak = _timed_rollout(
        lambda: env.compute_trajectory(ip, iv, dur_e, net, ell_degree=c["D"],
                                       lam_method="power"))
    e_chunk = env.compute_trajectory(ip, iv, dur_e, net, ell_degree=c["D"],
                                     env_chunk=c["chunk"],
                                     lam_iters=c["dense_lam_iters"])
    rows["e_dense"] = dict(seconds=e_s, peak_gb=e_peak, T=c["T_dense"],
                           lam_iters=c["dense_lam_iters"],
                           vs_chunked=_rollouts_close("dense vs chunked",
                                                      e_chunk, e_dense))

    # a chunked step's profile (step mode, as (a))
    init_fn, step_fn = env._pieces(net, c["D"], None, c["lam_iters"],
                                   "power", env_chunk=c["chunk"])
    with torch.no_grad():
        carry = [init_fn(env._as_device(ip), env._as_device(iv))[0]]

        def step():
            carry[0] = step_fn(carry[0])[0]

        _, step_peak = _peak_gb(step)
        prof = _device_profile(step, c["profile_n"], warmup=2)
    rows["profile"] = dict(
        host_ms_per_step=prof["wall_ms"],
        profiled_host_ms_per_step=prof["profiled_wall_ms"],
        device_ms_per_step=prof["device_ms"],
        device_idle_share=prof["device_idle_share"], step_peak_gb=step_peak,
        top=[dict(name=t["name"], ms_per_step=t["ms"],
                  calls_per_step=t["calls"]) for t in prof["top"]])
    emit(phase="chunked_serving", nvidia_smi=card,
         config="flock_n4096_chunked", N=N, B=B, T=c["T"], d_max=c["D"],
         env_chunk=c["chunk"], lam_iters=c["lam_iters"], rows=rows,
         launches=launches, seconds=time.perf_counter() - t_phase)
    return launches, net


def phase_chunked_big(net, dev, card):
    """flock_n65536_chunked: rollout_cost on the chunked env (chunk 8192)
    beside the grid's rollout_cost of the same state (kernels 5-6,
    counted); both costs, ms a step and the peak memory."""
    import torch
    from graph_neural_networks_torch.data.flocking import Flocking
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    c = CHUNK
    N = c["big_N"]
    env = Flocking.for_rollout(N, commRadius=2.0, repelDist=1.0,
                               samplingTime=0.01, device=dev,
                               rng=np.random.default_rng(1))
    ip, iv = env.compute_initial_positions(
        N, 1, env.commRadius, minDist=env.initMinDist, geometry="circular",
        xMaxInitVel=3.0, yMaxInitVel=3.0)
    dur = c["big_T"] * env.samplingTime
    torch.cuda.empty_cache()
    gridwin.reset_launch_counts()
    (cf, ce), ch_s, ch_peak = _timed_rollout(lambda: env.rollout_cost(
        ip, iv, dur, net, ell_degree=c["D"], env_chunk=c["big_chunk"],
        lam_iters=c["lam_iters"]))
    require(not any(_flock_counts().values()),
            "the chunked env launched grid kernels")
    torch.cuda.empty_cache()
    (gcf, gce), g_s, g_peak = _timed_rollout(lambda: env.rollout_cost(
        ip, iv, dur, net, ell_degree=c["D"], env_grid=True,
        lam_iters=c["lam_iters"], env_grid_strict=True))
    counts = _flock_counts()
    want = dict(grid_window=33 + (c["big_T"] - 1), table_build=c["big_T"],
                table_transpose=0)
    require(counts == want, f"grid cost launches {counts}, expected {want}")
    require(np.isfinite([cf, ce, gcf, gce]).all(), "non-finite cost")
    rel = abs(cf - gcf) / abs(gcf)
    require(rel <= 1e-3, f"chunked cost {cf} vs grid {gcf}: {rel}")
    emit(phase="chunked_big", nvidia_smi=card, config="flock_n65536_chunked",
         N=N, B=1, T=c["big_T"], env_chunk=c["big_chunk"], d_max=c["D"],
         cost_full=dict(chunked=cf, grid=gcf, rel_diff=rel),
         cost_end=dict(chunked=ce, grid=gce),
         chunked=dict(seconds=ch_s, ms_per_step=ch_s / c["big_T"] * 1e3,
                      peak_gb=ch_peak,
                      dense_step_matrix_gb=4 * N * N / 1e9),
         grid=dict(seconds=g_s, ms_per_step=g_s / c["big_T"] * 1e3,
                   peak_gb=g_peak, launches=counts),
         seconds=time.perf_counter() - t_phase)
    return counts


def phase_chunked_training(dev, card, out_dir):
    """flock_largetrain_n4096_chunked: Flocking.large(env_grid=None) held
    against Flocking.large(env_grid=True) from the same initial conditions
    (t = 0: neighbour sets, states and labels; the deviation over T), the
    chunked relabel against the f64 host expert, then Model.train with
    TrainerFlocking's ELL host store on the chunked env (finite losses and
    validation) and a step's profile."""
    import torch
    from graph_neural_networks_torch import training
    from graph_neural_networks_torch.data import flocking as fl
    from graph_neural_networks_torch.models.architectures_time import (
        LocalGNN_DB)
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    c = CHUNK_TRAIN
    kw = dict(commRadius=2.0, repelDist=1.0, nTrain=c["nTrain"],
              nValid=c["nValid"], nTest=c["nTest"], duration=c["duration"],
              samplingTime=0.01, ell_degree=c["D"], lam_iters=c["lam_iters"],
              device=dev)
    gridwin.reset_launch_counts()
    data, gen_s, gen_peak = _timed_rollout(lambda: fl.Flocking.large(
        c["N"], rng=np.random.default_rng(c["seed"]), **kw))
    require(not any(_flock_counts().values()),
            "the chunked generation launched grid kernels")
    require(data.rollout_env_chunk == c["N"] // 8
            and data.rollout_env_grid is None, "chunked rollout defaults")
    gridwin.reset_launch_counts()
    grid, grid_s, _ = _timed_rollout(lambda: fl.Flocking.large(
        c["N"], rng=np.random.default_rng(c["seed"]), env_grid=True, **kw))
    gen_counts = _flock_counts()
    T = len(np.arange(0, c["duration"], 0.01))
    n_chunks = -(-(c["nTrain"] + c["nValid"] + c["nTest"]) // 4)
    want = dict(grid_window=n_chunks * T * (2 + c["lam_iters"]),
                table_build=n_chunks * T, table_transpose=0)
    require(gen_counts == want, f"grid generation launches {gen_counts}, "
                                f"expected {want}")
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    check, over_T = {}, {}
    for split in ("train", "valid", "test"):
        ga = data.getData("commGraph", split)
        gb = grid.getData("commGraph", split)
        for b in range(ga.idx.shape[0]):
            same = torch.equal(
                _dense_sets(as_t(ga.idx[b, :1]), as_t(ga.val[b, :1, 0]),
                            c["N"]),
                _dense_sets(as_t(gb.idx[b, :1]), as_t(gb.val[b, :1, 0]),
                            c["N"]))
            require(same, f"{split}[{b}]: t = 0 neighbour sets differ")
        for f, axis in (("state", 1), ("accel", 1)):
            a0 = as_t(data.getData(f, split)[:, 0])
            b0 = as_t(grid.getData(f, split)[:, 0])
            check[f"{split}_{f}_t0"] = _state_check(
                f"{split} {f} at t = 0, chunked vs grid", a0, b0, axis=axis)
        for f in ("pos", "vel", "state", "accel"):
            over_T[f"{split}_{f}"] = _max_dev(data.getData(f, split),
                                              grid.getData(f, split))
    del grid
    net = LocalGNN_DB([6, 64], [3], True, "tanh", [2], 1, device=dev,
                      generator=torch.Generator().manual_seed(c["wseed"]))
    model = training.Model(net, training.losses.mse_loss,
                           {"name": "ADAM", "lr": 5e-4},
                           training.TrainerFlocking,
                           training.evaluate_flocking, name="chunk_large",
                           saveDir=out_dir)
    trainer = training.TrainerFlocking(model, data, c["epochs"], 1,
                                       ellDegree=c["D"])
    # the chunked relabel of one stored trajectory against the f64 expert
    pos = data.getData("pos", "train")[:1].astype(np.float64)
    vel = data.getData("vel", "train")[:1].astype(np.float64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = trainer._expert_accel(pos, vel)
    torch.cuda.synchronize()
    relabel_s = time.perf_counter() - t0
    rel = {}
    for t in c["relabel_steps"]:
        ref = fl.expert_accel_host(pos[:, t], vel[:, t], data.repelDist,
                                   data.accelMax)
        err, r, agree = compare(torch.as_tensor(y[:, t]),
                                torch.as_tensor(ref), rtol=1e-4,
                                atol_rel=1e-4)
        rel[t] = dict(max_abs_err=err, max_rel_err=r,
                      unclipped_share=float((np.abs(ref)
                                             < data.accelMax).mean()))
        require(agree, f"chunked relabel at t={t} vs the f64 expert: {err}")
    gridwin.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.train(data, c["epochs"], 1, ellDegree=c["D"],
                      probExpert=c["probExpert"], DAGgerType="randomEpoch",
                      seed=c["seed"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    costs = model.evaluate(data)
    train_counts = _flock_counts()
    require(not any(train_counts.values()),
            f"chunked training launched grid kernels: {train_counts}")
    losses, valid = out["lossTrain"], out["costValid"]
    require(len(losses) == c["epochs"] * c["nTrain"]
            and np.isfinite(losses).all(), f"losses {losses}")
    require(len(valid) > 0 and np.isfinite(valid).all(), f"valid {valid}")
    require(np.isfinite(list(costs.values())).all(), f"costs {costs}")
    trainer = training.TrainerFlocking(model, data, 1, 1, ellDegree=c["D"])
    prof = _step_profile(trainer, np.arange(1), 3)
    emit(phase="chunked_training", nvidia_smi=card,
         config="flock_largetrain_n4096_chunked", N=c["N"], T=T,
         env_chunk=data.rollout_env_chunk, generation_s=gen_s,
         generation_peak_gb=gen_peak, grid_generation_s=grid_s,
         grid_launches=gen_counts, t0_checks=check, max_dev_over_T=over_T,
         relabel=dict(seconds=relabel_s, rtol=1e-4,
                      atol="1e-4*max|f64 expert|", steps=rel),
         train_s=train_s, loss=[float(v) for v in losses],
         cost_valid=[float(v) for v in valid], evaluate=costs,
         step=prof, seconds=time.perf_counter() - t_phase)
    return gen_counts


def phase_chunked_sharded(net, dev, card):
    """flock_n4096_chunked's swarm over mesh (1, 4) of the one card on the
    all-pairs sharded env (env_chunk 128 rows a sub-chunk): the windowed,
    fused step-mode (the payload by masked product) and cost rollouts of
    the LocalGNN_DB policy and a GraphRecurrentNN_DB (flock_grnn_n262k's
    widths) as a windowed policy at w = 3, each against the one-card
    chunked rollout of the same policy; no kernel runs."""
    import torch
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.models.architectures_time import (
        GraphRecurrentNN_DB)
    from graph_neural_networks_torch.ops import gridwin
    t_phase = time.perf_counter()
    c = CHUNK
    env, ip, iv, _ = _flock_setup("flock_n4096", dev)
    T = c["shard_T"]
    dur = T * env.samplingTime
    mesh = par.make_mesh((1, SHARD_PARTS), devices=[dev] * SHARD_PARTS)
    pos, vel, n_orig = par.pad_swarm(ip, iv, mesh)
    grnn = GraphRecurrentNN_DB(6, 2, 64, [3, 3], True, "tanh", "identity",
                               "identity", [2], 1, device=dev,
                               generator=torch.Generator().manual_seed(3))
    one_kw = dict(ell_degree=c["D"], env_chunk=c["chunk"],
                  lam_iters=c["lam_iters"])
    roll = lambda policy, **k: par.sharded_swarm_rollout(
        T, c["w"], policy, env.commRadius, env.samplingTime, env.accelMax,
        c["D"], mesh, n_orig=n_orig, lam_iters=c["lam_iters"],
        env_chunk=c["shard_chunk"], **k)(pos, vel)
    cases = {
        "windowed": (lambda: roll(net), lambda: env.compute_trajectory(
            ip, iv, dur, net, step_mode=False, history_window=c["w"],
            **one_kw)),
        "fused": (lambda: roll(net, step_mode=True),
                  lambda: env.compute_trajectory(ip, iv, dur, net,
                                                 **one_kw)),
        "cost": (lambda: roll(net, step_mode=True, return_cost=True),
                 lambda: env.rollout_cost(ip, iv, dur, net, **one_kw)),
        "grnn_windowed": (lambda: roll(grnn), lambda: env.compute_trajectory(
            ip, iv, dur, grnn, step_mode=False, history_window=c["w"],
            **one_kw)),
    }
    rows = {}
    gridwin.reset_launch_counts()
    for name, (sharded, one) in cases.items():
        got, s_s, s_peak = _timed_rollout(sharded)
        want, o_s, _ = _timed_rollout(one)
        require(bool(got[-1]), f"{name}: ok False on the all-pairs env")
        if name == "cost":
            cf, ce = float(got[0]), float(got[1])
            rel = [abs(cf - want[0]) / abs(want[0]),
                   abs(ce - want[1]) / abs(want[1])]
            require(max(rel) <= CHUNK_RTOL, f"cost {cf}, {ce} vs one card "
                                             f"{want}: {rel}")
            vs = dict(cost=[cf, ce], one_card=list(want), rel_diff=rel)
        else:
            vs = _rollouts_close(f"sharded {name} vs one card",
                                 (got[0].cpu().numpy(), got[1].cpu().numpy()),
                                 want)
        rows[name] = dict(seconds=s_s, one_card_seconds=o_s,
                          ms_per_step=s_s / (T - 1) * 1e3, peak_gb=s_peak,
                          largest_in_degree=int(got[-2]), vs_one_card=vs)
    counts = _flock_counts()
    require(not any(counts.values()),
            f"the all-pairs sharded env launched grid kernels: {counts}")
    emit(phase="chunked_sharded", nvidia_smi=card,
         config="flock_n4096_chunked over mesh (1, 4)", T=T,
         env_chunk=c["shard_chunk"], rows=rows, rtol=CHUNK_RTOL,
         atol=CHUNK_RTOL, seconds=time.perf_counter() - t_phase)


def phase_chunked_host_loop(dev, card):
    """The host loop on flock_ref_n50's env (N = 50, 20 samples, 1 s): a
    plain callable policy (LocalGNN_DB([6,64], [3]) behind a lambda, no
    step interface) over the full horizon and over history_window 3,
    against the module's step-mode dense rollout on the card; and the
    open loop replaying the f64 expert's accelerations, which gives back
    the expert's trajectory."""
    import torch
    from graph_neural_networks_torch.data.flocking import Flocking
    from graph_neural_networks_torch.models.architectures_time import (
        LocalGNN_DB)
    t_phase = time.perf_counter()
    c = CHUNK_HOST
    env = Flocking.for_rollout(c["N"], commRadius=2.0, repelDist=1.0,
                               samplingTime=0.01, device=dev,
                               rng=np.random.default_rng(c["seed"]))
    ip, iv = env.compute_initial_positions(
        c["N"], c["B"], env.commRadius, minDist=env.initMinDist,
        geometry="circular", xMaxInitVel=3.0, yMaxInitVel=3.0)
    net = LocalGNN_DB([6, 64], [3], True, "tanh", [2], 1, device=dev,
                      generator=torch.Generator().manual_seed(c["wseed"]))
    dur = c["T"] * env.samplingTime
    ref, ref_s, _ = _timed_rollout(
        lambda: env.compute_trajectory(ip, iv, dur, net))
    policy = lambda x, S: net(x, S)
    rows = {}
    for name, window in (("full_horizon", None), ("windowed", c["w"])):
        got, s, _ = _timed_rollout(lambda: env.compute_trajectory(
            ip, iv, dur, policy, history_window=window))
        require(got[4].shape == (c["B"], c["T"], c["N"], c["N"]),
                f"{name}: host graphs {got[4].shape}")
        rows[name] = dict(seconds=s, vs_step_mode=_rollouts_close(
            f"host loop {name} vs step mode", got, ref))
    pos, vel, acc = env.compute_optimal_trajectory(ip, iv, dur, 0.01, 1.0)
    op = env.compute_trajectory(ip, iv, dur, accel=acc)
    replay = dict(pos=bool(np.array_equal(op[0], pos)),
                  vel=bool(np.array_equal(op[1], vel)),
                  no_states=op[3] is None and op[4] is None)
    require(all(replay.values()), f"open loop replay: {replay}")
    emit(phase="chunked_host_loop", nvidia_smi=card, config="flock_ref_n50",
         B=c["B"], T=c["T"], step_mode_seconds=ref_s, rows=rows,
         open_loop=replay, seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# The tasks: the single-node path (movielens_n1186) and the seven drivers
# ---------------------------------------------------------------------------

# movielens_n1186: examples/movielens.py's models at full width (F = [1, 64,
# 32], K = [5, 5], smooth-L1, Adam 5e-3, batch 5) on MovieLens' synthetic
# fallback at ML-100k's shape (943 users x 1682 movies, default_rng(0),
# kNN 10, ratios 0.9 / 0.1). Its target is the most-rated movie that the
# graph keeps (movies ranked by rating count, stable): movie 701, 38th (the
# graph drops movies of in-degree 0, the example's node 50 among them); the
# kept graph has N = 1186 (10 x 10 BCSR blocks of 128) and 132 / 15 / 16
# samples. Checking the rank on the card would take 37 constructions of
# ~0.8 s of host time; tests/test_torch_single_node.py applies the same
# rule at a small size.
ML_CELL = dict(users=943, movies=1682, label=701, kNN=10, seed=0, batch=5,
               lr=5e-3, valid_every=10, F=[1, 64, 32], K=[5, 5])
ML_RTOL = 1e-4
ML_ATOL_REL = 1e-4
DRIVERS = ("movielens", "epidemic", "sourceloc", "authorship", "twentynews",
           "variants", "transfer")
DRIVER_RTOL = 1e-4
DRIVER_ATOL_REL = 1e-4


ML_MODELS = (("SelGNN", 2, "Trainer", "evaluate"),
             ("LocalGNN1Ly", 1, "TrainerSingleNode", "evaluate_single_node"),
             ("LocalGNN2Ly", 2, "TrainerSingleNode", "evaluate_single_node"))


def _ml_arch(S, name, layers, mode, dev):
    """One of movielens_n1186's models in `mode`, the weights of torch
    seed 0 (the same in every mode)."""
    import torch
    from graph_neural_networks_torch.models import architectures as archs
    N, F, K = S.shape[0], ML_CELL["F"][:layers + 1], ML_CELL["K"][:layers]
    cls = archs.SelectionGNN if name == "SelGNN" else archs.LocalGNN
    return cls(F, K, True, "relu", [N] * layers, "NoPool", [1] * layers,
               [1], S, order="Degree", gsoMode=mode, device=dev,
               generator=torch.Generator().manual_seed(0))


def _ml_launches(arch, step):
    """bcsr_matmul launches of a forward (step=False) or a training step:
    K-1 shifts a layer, and a step adds the backward shifts of every layer
    but the first (its input needs no gradient)."""
    taps = arch._cfg["taps"]
    return sum(k - 1 for k in taps) + (
        sum(k - 1 for k in taps[1:]) if step else 0)


def _ml_model(arch, name, trainer, evaluator, out_dir):
    from graph_neural_networks_torch import training as T
    loss = T.losses.adapt_extra_dimension_loss(T.losses.smooth_l1_loss)
    return T.Model(arch, loss, {"name": "ADAM", "lr": ML_CELL["lr"]},
                   trainer, evaluator, name=name, saveDir=out_dir)


def _ml_first_step(model, data):
    """The loss and the parameter gradients of the model's trainer's first
    step (the first batch of its seed-0 permutation), and the SpMM
    launches of that step."""
    trainer = model.trainer(model, data, 1, ML_CELL["batch"])
    idx = np.random.default_rng(0).permutation(data.nTrain)[
        :ML_CELL["batch"]]
    _reset_counts()
    loss, _ = trainer.train_batch(idx)
    counts = _attention_counts()
    return loss, [p.grad.detach().clone() for p in model.archit.parameters()
                  ], counts


def phase_single_node(dev, out_dir):
    """movielens_n1186: its three models in dense and bcsr mode from the
    same weights; first-step gradients, one epoch of Model.train (with
    TrainerSingleNode for the Local GNNs) and the evaluators' costs, bcsr
    against dense, with exact bcsr_matmul counts a step, a validation and
    an evaluation; a step's profile of each mode; then kernel 1 at the
    graph's shapes (R = B·F = 5 and 320) against its plain version, timed
    beside its bound and x @ S_dense."""
    import torch
    from graph_neural_networks_torch import data as D
    from graph_neural_networks_torch import training as T
    from graph_neural_networks_torch.ops import spmm
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    data = D.MovieLens("movie", ML_CELL["label"], 0.9, 0.1,
                       kNN=ML_CELL["kNN"], nSynthUsers=ML_CELL["users"],
                       nSynthMovies=ML_CELL["movies"],
                       rng=np.random.default_rng(ML_CELL["seed"]))
    data.expandDims()
    W = data.getGraph()
    S = W / np.max(np.abs(np.linalg.eigvalsh(W)))
    N = S.shape[0]
    host_s = time.perf_counter() - t0
    emit(phase="movielens_graph", N=N, nnz=int(np.count_nonzero(W)),
         label=ML_CELL["label"], label_position=data.labelID[0],
         samples=[data.nTrain, data.nValid, data.nTest],
         host_seconds=host_s)
    checks, launches, trained = [], 0, {}
    steps = -(-data.nTrain // ML_CELL["batch"])
    validations = len(range(0, steps, ML_CELL["valid_every"]))
    for name, layers, tr, ev in ML_MODELS:
        tr, ev = getattr(T, tr), getattr(T, ev)
        dense, bcsr = (_ml_arch(S, name, layers, m, dev)
                       for m in ("dense", "bcsr"))
        require(all(torch.equal(p, q) for p, q in
                    zip(dense.parameters(), bcsr.parameters())),
                f"{name}: bcsr weights differ from dense")
        require(bcsr.S.mode == "bcsr" and bcsr.S.blocks.shape[1] ==
                bcsr.S.block_row.shape[0], f"{name}: not a BCSR Gso")
        fwd, step = _ml_launches(bcsr, False), _ml_launches(bcsr, True)
        # a forward's launches, then the first step's gradients
        _reset_counts()
        with torch.no_grad():
            bcsr.apply(data.getSamples("test")[0])
        require(_attention_counts()["bcsr_matmul"] == fwd,
                f"{name}: {_attention_counts()} launches a forward, "
                f"expected {fwd} bcsr_matmul")
        first = {}
        for mode, arch in (("dense", dense), ("bcsr", bcsr)):
            model = _ml_model(arch, f"{name}_first_{mode}", tr, ev, out_dir)
            first[mode] = _ml_first_step(model, data)
        require(first["bcsr"][2]["bcsr_matmul"] == step and not any(
            first["dense"][2].values()), f"{name}: first-step launches "
            f"{first['bcsr'][2]} (bcsr), {first['dense'][2]} (dense), "
            f"expected {step} bcsr_matmul")
        _check_grads(checks, f"{name} bcsr", "dense", first["bcsr"][1],
                     first["dense"][1])
        # one epoch through Model.train and the evaluator, fresh weights
        outs = {}
        for mode in ("dense", "bcsr"):
            arch = _ml_arch(S, name, layers, mode, dev)
            model = _ml_model(arch, f"{name}_{mode}", tr, ev, out_dir)
            _reset_counts()
            t0 = time.perf_counter()
            out = model.train(data, nEpochs=1, batchSize=ML_CELL["batch"],
                              validationInterval=ML_CELL["valid_every"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            train_counts = _attention_counts()
            _reset_counts()
            result = model.evaluate(data, doSaveVars=False)
            eval_counts = _attention_counts()
            outs[mode] = (out, result, secs, train_counts, eval_counts)
            trained[f"{name} {mode}"] = model
        (d_out, d_res, d_s, d_tc, _), (b_out, b_res, b_s, b_tc, b_ec) = (
            outs["dense"], outs["bcsr"])
        want_train = steps * step + validations * fwd
        require(b_tc["bcsr_matmul"] == want_train and not any(d_tc.values()),
                f"{name}: training launches {b_tc}, expected "
                f"{want_train} bcsr_matmul ({steps} steps x {step} + "
                f"{validations} validations x {fwd})")
        require(b_ec["bcsr_matmul"] == 2 * fwd,
                f"{name}: evaluation launches {b_ec}, expected {2 * fwd}")
        launches += b_tc["bcsr_matmul"] + b_ec["bcsr_matmul"] + fwd + step
        require(len(b_out["lossTrain"]) == steps and bool(
            np.isfinite(b_out["lossTrain"]).all()),
            f"{name}: losses {b_out['lossTrain']}")
        ok = bool(np.allclose(b_out["lossTrain"], d_out["lossTrain"],
                              rtol=ML_RTOL, atol=0))
        costs_ok = all(r is not None and np.isfinite(r) for r in
                       list(b_res.values()) + list(d_res.values())) and all(
            np.isclose(b_res[k], d_res[k], rtol=ML_RTOL, atol=0)
            for k in ("costBest", "costLast"))
        checks.append(dict(model=f"{name} bcsr", against="dense",
                           losses=b_out["lossTrain"].tolist(),
                           dense_losses=d_out["lossTrain"].tolist(),
                           max_rel_loss=float(np.max(np.abs(
                               b_out["lossTrain"] - d_out["lossTrain"])
                               / np.abs(d_out["lossTrain"]))),
                           evaluate=b_res, dense_evaluate=d_res, ok=ok,
                           costs_ok=costs_ok))
        require(ok, f"{name}: bcsr losses {b_out['lossTrain']} vs dense "
                    f"{d_out['lossTrain']}")
        require(costs_ok, f"{name}: bcsr costs {b_res} vs dense {d_res}")
        emit(phase="single_node", model=name, trainer=tr.__name__,
             evaluator=ev.__name__, params=bcsr.parameter_count(),
             steps=steps, validations=validations,
             bcsr_matmul_per_forward=fwd, bcsr_matmul_per_step=step,
             train_launches=b_tc["bcsr_matmul"],
             evaluate_launches=b_ec["bcsr_matmul"], seconds_bcsr=b_s,
             seconds_dense=d_s, evaluate=b_res, dense_evaluate=d_res)
    emit(phase="single_node_check", rtol=ML_RTOL,
         atol=f"{ML_ATOL_REL}*max|dense|", checks=checks)

    # a step's profile, each mode (the two-layer Local GNN)
    for mode in ("bcsr", "dense"):
        model = trained[f"LocalGNN2Ly {mode}"]
        trainer = model.trainer(model, data, 1, ML_CELL["batch"])
        bs = ML_CELL["batch"]
        it = iter([np.arange(i * bs, (i + 1) * bs) % data.nTrain
                   for i in range(40)])
        prof = _device_profile(lambda: trainer.train_batch(next(it)), 6)
        emit(phase="single_node_profile", model="LocalGNN2Ly", mode=mode,
             batch=bs, host_ms_per_step=prof["wall_ms"],
             profiled_host_ms_per_step=prof["profiled_wall_ms"],
             device_ms_per_step=prof["device_ms"],
             device_idle_share=prof["device_idle_share"],
             top=[dict(name=t["name"], ms_per_step=t["ms"],
                       calls_per_step=t["calls"]) for t in prof["top"]])

    # kernel 1 at the graph's shapes: layer 1's rows (B = 5, F = 1) and
    # layer 2's (F = 64), forward and layer 2's backward on blocks_t
    g = trained["LocalGNN2Ly bcsr"].archit.S
    bl, br, bc, cs = g.blocks[0], g.block_row, g.block_col, g.col_start
    bt, rt, ct, cst = (g.blocks_t[0], g.block_row_t, g.block_col_t,
                       g.col_start_t)
    nnzb, bsz = bl.shape[0], g.block_size
    Sd = g.S[0]
    rng = np.random.default_rng(30)
    errs, rows, results = {}, {}, []
    for R in (ML_CELL["batch"], ML_CELL["batch"] * ML_CELL["F"][1]):
        x = torch.as_tensor(rng.standard_normal((R, N)).astype(np.float32),
                            device=dev)
        for layout, (b_, r_, c_, s_) in (("blocks", (bl, br, bc, cs)),
                                         ("blocks_t", (bt, rt, ct, cst))):
            max_abs, max_rel, ok = compare(
                spmm.bcsr_matmul(x, b_, r_, c_, n_cols=N, col_start=s_),
                spmm.bcsr_matmul_plain(x, b_, r_, c_, n_cols=N))
            results.append(dict(kernel="bcsr_matmul", case=f"R={R} N={N} "
                                f"nnzb={nnzb} {layout}", max_abs_err=max_abs,
                                max_rel_err=max_rel, ok=ok))
            errs["bcsr_matmul"] = max(errs.get("bcsr_matmul", 0.0), max_abs)
            require(ok, f"bcsr_matmul at R={R} N={N} {layout} disagrees "
                        f"with its plain version: {max_abs}")
        row = dict(
            shape=f"R={R} N={N} nnzb={nnzb}",
            ms=time_ms(lambda: spmm.bcsr_matmul(x, bl, br, bc, n_cols=N,
                                                col_start=cs)),
            graph_ms=graph_ms(lambda: spmm.bcsr_matmul(
                x, bl, br, bc, n_cols=N, col_start=cs)),
            plain_ms=time_ms(lambda: spmm.bcsr_matmul_plain(
                x, bl, br, bc, n_cols=N)),
            library_ms=time_ms(lambda: torch.matmul(x, Sd)),
            library_call="torch.matmul(x, S_dense), TF32 off",
            flops=2 * R * nnzb * bsz * bsz,
            bytes=4 * (2 * R * N + bl.numel() + 2 * nnzb))
        row["bound_ms"], row["bound_by"] = _bound(row["bytes"], row["flops"])
        rows[f"bcsr_matmul@movielens R={R}"] = row
    emit(phase="single_node_kernels", checks=results, rtol=RTOL,
         atol=f"{ATOL_REL}*max|plain|")
    emit(phase="single_node_timing", rows=rows,
         seconds=time.perf_counter() - t_phase)
    return errs, rows, {"bcsr_matmul": launches}


def _driver_first_step(spec, task, device, out_dir):
    """The loss and parameter gradients of the first step of `spec`'s
    trainer on `device`, the first batch of its seed-0 permutation; a GRNN
    takes a z0 drawn on the CPU (a CUDA generator draws another)."""
    import torch
    from graph_neural_networks_torch import training as T
    arch = spec.build(device)
    if hasattr(arch, "H"):
        z0 = torch.randn((task.batch, arch.H, arch.S.N),
                         generator=torch.Generator().manual_seed(1))
        forward = arch.split_forward
        arch.split_forward = lambda x, generator=None: forward(x, z0=z0)
    model = T.Model(arch, spec.loss, {"name": "ADAM", "lr": spec.lr},
                    spec.trainer, spec.evaluator, name=spec.name,
                    saveDir=out_dir)
    trainer = spec.trainer(model, task.data, task.nEpochs, task.batch,
                           **spec.train_kw)
    idx = np.random.default_rng(0).permutation(task.data.nTrain)[:task.batch]
    loss, _ = trainer.train_batch(idx)
    return loss, [p.grad.detach().cpu() for p in arch.parameters()]


def _finite_costs(result):
    vals = [v for r in result.values()
            for v in (r.values() if isinstance(r, dict) else [r])]
    return bool(vals) and all(v is not None and np.isfinite(v) for v in vals)


def phase_task_drivers(dev, out_dir):
    """Each of the seven task drivers' main() at its full widths on the
    card with --epochs 1, on the datasets' synthetic fallbacks (dense mode,
    as the JAX drivers: no kernel of the library), its seconds and results,
    every cost finite; and each driver's first model's first step on the
    card against the same model on the CPU (loss and every gradient)."""
    import importlib
    import io

    import torch
    checks = []
    for name in DRIVERS:
        mod = importlib.import_module(
            f"graph_neural_networks_torch.examples.{name}")
        sub = os.path.join(out_dir, name)
        with contextlib.redirect_stdout(io.StringIO()):
            task = mod.setup(mod._args(["--epochs", "1"]))
            spec = task.models[0]
            steps = {where: _driver_first_step(spec, task, where, sub)
                     for where in ("cpu", dev)}
        (l_c, g_c), (l_g, g_g) = steps["cpu"], steps[dev]
        _check_outputs(
            checks, f"{name} {spec.name}", "cpu",
            [("loss", torch.tensor([l_g]), torch.tensor([l_c]))]
            + [(f"grad {i}", g, w) for i, (g, w) in enumerate(zip(g_g, g_c))],
            DRIVER_RTOL, DRIVER_ATOL_REL)
        _reset_all_counts()
        log = io.StringIO()
        t0 = time.perf_counter()
        argv = ["--epochs", "1", "--device", str(dev)]
        with contextlib.redirect_stdout(log):
            result = mod.main(argv + ["--saveDir", sub])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        require(_finite_costs(result), f"{name}: costs {result}")
        require(not any(_all_counts().values()),
                f"{name}: the dense driver launched kernels: {_all_counts()}")
        emit(phase="task_driver", driver=name, argv=argv,
             models=[s.name for s in task.models], seconds=secs,
             result=result, first_model=spec.name, first_loss_card=l_g,
             first_loss_cpu=l_c, log_tail=log.getvalue().splitlines()[-3:])
        del task
    emit(phase="task_drivers_check", rtol=DRIVER_RTOL,
         atol=f"{DRIVER_ATOL_REL}*max|cpu|", checks=checks)


# ---------------------------------------------------------------------------
# Item 2: bf16 serving on the bf16 instances of kernels 1-3 and 7-8, (x, S)
# requests for the DB family, export_model/load_exported, introspection
# ---------------------------------------------------------------------------

# H100 SXM data-sheet dense bf16 tensor-core peak: the bf16 instances'
# operation bound (kernels 1-3 run their products on tensor cores by
# mma.sync; 7-8 on the CUDA cores)
BF16_FLOPS_PER_S = 989e12
# A bf16 instance against its bf16 plain version: 2 ulps of the larger
# magnitude for one rounding of an f32 accumulator (kernels 1, 3, 8), the
# ulp taken at no less than BF16_ULP_FLOOR of the output's largest
# magnitude (below it, f32 sums in another order can straddle more than a
# bf16 rounding boundary); the register's tap k within k + 1 ulps of the
# tap's largest magnitude; the f32 stats (kernel 7) within 1e-5 relative.
BF16_ULPS = 2
BF16_ULP_FLOOR = 1e-3
BF16_STATS_RTOL = 1e-5
# Served outputs: band and bcsr against dense, both bf16; every bf16
# engine against its f32 engine; of the largest |y|.
BF16_SERVE_TOL = 1e-2
BF16_VS_F32_TOL = 5e-2
BF16_KERNELS = ("bcsr_matmul", "band_shift_register", "band_matmul",
                "stats_call", "apply_call")
# flock_n262k's LocalGNN_DB served as engine(x, EllGso): 4 trajectories of
# T = 10 from a kernel 5/6 rollout, ragged requests
DB_REQ = dict(B=4, T=10, requests=(4, 3, 1))
HOST_US_CALLS = 2000


def _ulps_of(got, want, floor_share=BF16_ULP_FLOOR, scale=None):
    """Largest |got - want| in bf16 ulps (8 significant bits) of the larger
    magnitude (or of `scale`), taken at no less than floor_share of
    max|want|."""
    import torch
    got, want = got.double(), want.double()
    if scale is None:
        scale = torch.maximum(got.abs(), want.abs()).clamp_min(
            floor_share * want.abs().max().item())
    else:
        scale = torch.full_like(want, scale)
    ulp = torch.exp2(torch.floor(torch.log2(scale.clamp_min(1e-30))) - 7)
    return ((got - want).abs() / ulp).max().item()


def _bf16_bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _op_calls():
    """The kernels' op calls by (name, dtype name) since the last clear."""
    from graph_neural_networks_torch import kernels
    return {f"{name}:{str(dt).split('.')[-1]}": n
            for (name, dt), n in kernels.OP_CALLS.items() if n}


def _host_us(fn, calls=HOST_US_CALLS):
    """Host microseconds a call of a launching wrapper, from the host clock
    over `calls` back-to-back calls (the card runs ahead of the host at
    these shapes; synchronized once at the end)."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def phase_bf16_kernels(graph, S_np, gat_gso, dev):
    """Each bf16 instance against its bf16 plain version at band_n4096's
    shapes (R = 32 and 2048, K = 5) and at the edges of the tensor-core
    tiles (R = 1, 16, 17, 64, 65, 129; N = 4004 and the ragged 4001; an
    empty BCSR segment; the register at K = 2 and on each of its panels),
    and at gat_band_n16384's (Q = 16, F = 32, w = 2; the stats kernel
    also at the edges of its lanes' signal-row splits, Q = 1, 3, 4, 5, 17,
    33, at a negative slope, on rows without support and at ibs = 64 and
    192), synchronized after each; then each timed by CUDA events and
    graph_ms beside the f32 instance, with its bound and x_bf16 @
    S_dense_bf16; the bf16
    register_sweep; and a wrapper's host us a call at R = 32 without and
    with the op registration."""
    import torch
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.ops import gso as gso_lib
    from graph_neural_networks_torch.ops import spmm
    bf = torch.bfloat16
    rng = torch.Generator(device=dev).manual_seed(31)
    N, bs, w = N_GRAPH, 128, graph["band"].band_w
    nb = N // bs
    gb, gc = (graph[m].to(dtype=bf) for m in ("band", "bcsr"))
    sb, sb32 = gb.s_band[0], graph["band"].s_band[0]
    bl, br, bc, cs = gc.blocks[0], gc.block_row, gc.block_col, gc.col_start
    bl32 = graph["bcsr"].blocks[0]
    Sd = gb.S[0]
    nnzb, win = bl.shape[0], _window_blocks(nb, w)
    checks, errs, rows = [], {k: 0.0 for k in BF16_KERNELS}, {}

    def check(name, shape, got, want, ulps=None, **kw):
        torch.cuda.synchronize()
        require(got.dtype == want.dtype, f"{name} {shape}: {got.dtype}")
        err = (got.double() - want.double()).abs().max().item()
        errs[name] = max(errs[name], err)
        if ulps is None:
            rel = ((got.double() - want.double()).abs()
                   / want.double().abs().clamp_min(1e-30)).max().item()
            ok = rel <= BF16_STATS_RTOL
            checks.append(dict(kernel=name, shape=shape, max_abs_err=err,
                               max_rel_err=rel, ok=ok))
        else:
            got_ulps = _ulps_of(got, want, **kw)
            ok = got_ulps <= ulps
            checks.append(dict(kernel=name, shape=shape, max_abs_err=err,
                               max_ulps=got_ulps, allowed_ulps=ulps, ok=ok))
        require(ok, f"bf16 {name} {shape} disagrees with its plain version: "
                    f"{checks[-1]}")

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=rng).to(bf)

    # the graph shift at the served rows and on each side of the tensor-core
    # tiles' row limits (m16 tiles: 16, 32, 64 rows narrow, 128 wide), at N
    # = 4096 (16-byte staging), 4004 (N % 8 == 4: element-wise staging) and
    # the ragged 4001
    n_rag, n_8b = N - 95, N - 92
    for R in (1, 16, 17, BATCH, 64, 65, 129, 2048):
        for n_in in (N, n_8b, n_rag) if R in (17, 65, 2048) else (N,):
            x = randn(R, n_in)
            check("bcsr_matmul", f"R={R} N={n_in}",
                  spmm.bcsr_matmul(x, bl, br, bc, n_cols=N, col_start=cs),
                  spmm.bcsr_matmul_plain(x, bl, br, bc, n_cols=N), BF16_ULPS)
            check("band_matmul", f"R={R} N={n_in}",
                  spmm.band_matmul(x, sb, n_cols=N, w=w),
                  spmm.band_matmul_plain(x, sb, n_cols=N, w=w), BF16_ULPS)
    # an empty BCSR segment: block column 5 dropped from the layout
    keep = bc != 5
    bl5, br5, bc5 = (bl[keep].contiguous(), br[keep].contiguous(),
                     bc[keep].contiguous())
    for R in (BATCH, 2048):
        x = randn(R, N)
        y = spmm.bcsr_matmul(x, bl5, br5, bc5, n_cols=N)
        torch.cuda.synchronize()
        require(bool((y[:, 5 * bs:6 * bs] == 0).all()),
                f"bf16 bcsr_matmul R={R}: the empty block column not zero")
        check("bcsr_matmul", f"R={R} N={N} empty column 5", y,
              spmm.bcsr_matmul_plain(x, bl5, br5, bc5, n_cols=N), BF16_ULPS)
    del bl5, br5, bc5

    # the register: the served rows, each side of its row limits (32-row
    # narrow items up to 64 rows, 128-row wide ones above), K = 2 and 5;
    # ragged N (4001, and 4004: element-wise staging); and its wide panels:
    # 64 columns at w = 1 (above), 2 and 3, 32 at w = 5 (the fallback; the
    # f32 kernel's widest band)
    np_rng = np.random.default_rng(34)
    cases = [(R, N, sb, w, K) for R in (1, 16, 17, BATCH, 64, 65, 129, 2048)
             for K in ((2, TAPS) if R in (BATCH, 2048) else (TAPS,))]
    for n in (n_rag, n_8b):
        g = gso_lib.as_gso(S_np[:n, :n], "band", device=dev).to(dtype=bf)
        cases += [(R, n, g.s_band[0], g.band_w, TAPS) for R in (17, 65)]
    for we in (2, 3, 5):
        g = gso_lib.as_gso(_band_case(np_rng, N, bs, we), "band",
                           device=dev).to(dtype=bf)
        require(g.band_w == we, f"band case has w={g.band_w}, not {we}")
        cases += [(R, N, g.s_band[0], we, TAPS) for R in (BATCH, 256)]
    for R, n, s_band, ww, K in cases:
        x = randn(R, n)
        got = spmm.band_shift_register(x, s_band, n_taps=K, n_cols=n, w=ww)
        want = spmm.band_shift_register_plain(x, s_band, n_taps=K, n_cols=n,
                                              w=ww)
        require(torch.equal(got[0], x), "bf16 register: tap 0 is not x")
        for k in range(1, K):
            check("band_shift_register", f"R={R} N={n} w={ww} K={K} tap {k}",
                  got[k], want[k], k + 1, scale=want[k].abs().max().item())
    del cases, g

    # attention at the served shape, on the f32 model's band structure cast
    # to bf16 (cast from its cache, not rebuilt)
    gat_b = gat_gso.to(dtype=bf)
    aux, aux32 = af.band_auxes(gat_b)[0], af.band_auxes(gat_gso)[0]
    ibs, wa = gat_gso.block_size, gat_gso.band_w
    Np = gat_gso.s_band.shape[1] * ibs
    Q, F = 2 * GAT_BATCH, GAT_DIMS[1]
    a1, a2, v = randn(Q, Np), randn(Q, Np), randn(Q, F, Np)
    mx, sm = af.stats_call(a1, a2, aux.mask_row, w=wa, ibs=ibs)
    pmx, psm = af.stats_plain(a1, a2, aux.mask_row, w=wa, ibs=ibs)
    check("stats_call", f"Q={Q} N={Np} w={wa} rowmax", mx, pmx)
    check("stats_call", f"Q={Q} N={Np} w={wa} rowsum", sm, psm)
    # the bf16 stats kernel's edges: signal rows on each side of its lanes'
    # splits (a power of 2 of them a list, at most 32 a block), a negative
    # slope, rows without support in the first, middle and last row blocks,
    # and ibs = 64 and 192
    for Qe in (1, 3, 4, 5, 17, 33):
        a1e, a2e = randn(Qe, Np), randn(Qe, Np)
        got = af.stats_call(a1e, a2e, aux.mask_row, w=wa, ibs=ibs)
        want = af.stats_plain(a1e, a2e, aux.mask_row, w=wa, ibs=ibs)
        for j, what in enumerate(("rowmax", "rowsum")):
            check("stats_call", f"Q={Qe} N={Np} w={wa} {what}", got[j],
                  want[j])
    for Qe in (5, Q):  # a negative slope: the max over the scores
        a1e, a2e = randn(Qe, Np), randn(Qe, Np)
        got = af.stats_call(a1e, a2e, aux.mask_row, w=wa, ibs=ibs,
                            slope=-0.2)
        want = af.stats_plain(a1e, a2e, aux.mask_row, w=wa, ibs=ibs,
                              slope=-0.2)
        for j, what in enumerate(("rowmax", "rowsum")):
            check("stats_call", f"Q={Qe} N={Np} w={wa} slope=-0.2 {what}",
                  got[j], want[j])
    rows_e = [0, 7, ibs + 1, Np // 2, Np - ibs - 1, Np - 1]
    mr_e = _empty_rows(aux.mask_row, rows_e)
    got = af.stats_call(a1, a2, mr_e, w=wa, ibs=ibs)
    want = af.stats_plain(a1, a2, mr_e, w=wa, ibs=ibs)
    keep = _other_rows(Np, rows_e)
    for j, what in enumerate(("rowmax", "rowsum")):
        check("stats_call", f"empty rows {rows_e} {what}", got[j][:, keep],
              want[j][:, keep])
    _check_empty_rows("stats_call bf16", *got, rows_e, 2 * wa + 1, ibs)
    np_rng = np.random.default_rng(35)
    for S_e, ibs_e, Qe in ((_attn_case(np_rng, 1000, 3, bs=64), 64, 5),
                           (_attn_case(np_rng, 2000, 1, bs=192), 192, 16)):
        g_e = gso_lib.as_gso(S_e, "band", block_size=ibs_e, device=dev)
        m_e = af.band_auxes(g_e)[0].mask_row.to(bf)
        Np_e, w_e = m_e.shape[0] * ibs_e, g_e.band_w
        a1e, a2e = randn(Qe, Np_e), randn(Qe, Np_e)
        got = af.stats_call(a1e, a2e, m_e, w=w_e, ibs=ibs_e)
        want = af.stats_plain(a1e, a2e, m_e, w=w_e, ibs=ibs_e)
        for j, what in enumerate(("rowmax", "rowsum")):
            check("stats_call", f"Q={Qe} N={g_e.n} w={w_e} ibs={ibs_e} "
                  f"{what}", got[j], want[j])
    del a1e, a2e, mr_e, got, want
    y = af.apply_call(a1, a2, v, mx, sm, aux.slab_col, aux.mask_col, w=wa,
                      ibs=ibs, lists=aux.lists)
    check("apply_call", f"Q={Q} F={F} N={Np} w={wa}", y, af.apply_plain(
        a1, a2, v, mx, sm, aux.slab_col, aux.mask_col, w=wa, ibs=ibs),
        BF16_ULPS)
    emit(phase="bf16_kernels", ulp_floor_share=BF16_ULP_FLOOR,
         stats_rtol=BF16_STATS_RTOL, checks=checks)

    # timing: bf16 and f32 instances on the same values
    def row(name, shape, fn, fn32, plain, library, library_call, nbytes,
            flops):
        r = dict(shape=shape, ms=time_ms(fn), graph_ms=graph_ms(fn),
                 f32_ms=time_ms(fn32), f32_graph_ms=graph_ms(fn32),
                 plain_ms=time_ms(plain, reps=5, inner=2),
                 library_ms=None if library is None else time_ms(library),
                 library_call=library_call, bytes=nbytes, flops=flops)
        r["bound_ms"], r["bound_by"] = _bf16_bound(nbytes, flops)
        rows[name] = r

    for R in (2048, BATCH):
        x = randn(R, N)
        x32 = x.float()
        row(f"bcsr_matmul@R={R}", f"R={R} N={N} nnzb={nnzb}",
            lambda: spmm.bcsr_matmul(x, bl, br, bc, n_cols=N, col_start=cs),
            lambda: spmm.bcsr_matmul(x32, bl32, br, bc, n_cols=N,
                                     col_start=cs),
            lambda: spmm.bcsr_matmul_plain(x, bl, br, bc, n_cols=N),
            lambda: torch.matmul(x, Sd), "torch.matmul(x_bf16, S_dense_bf16)",
            2 * (2 * R * N + bl.numel()) + 4 * nnzb, 2 * R * nnzb * bs * bs)
        row(f"band_matmul@R={R}", f"R={R} N={N} w={w}",
            lambda: spmm.band_matmul(x, sb, n_cols=N, w=w),
            lambda: spmm.band_matmul(x32, sb32, n_cols=N, w=w),
            lambda: spmm.band_matmul_plain(x, sb, n_cols=N, w=w),
            lambda: torch.matmul(x, Sd), "torch.matmul(x_bf16, S_dense_bf16)",
            2 * (2 * R * N + win * bs * bs), 2 * R * win * bs * bs)
        out = torch.empty(TAPS, R, N, device=dev, dtype=bf)

        def chained(x=x, out=out):
            out[0].copy_(x)
            for k in range(1, TAPS):
                torch.matmul(out[k - 1], Sd, out=out[k])

        row(f"band_shift_register@R={R}", f"R={R} N={N} w={w} K={TAPS}",
            lambda: spmm.band_shift_register(x, sb, n_taps=TAPS, n_cols=N,
                                             w=w),
            lambda: spmm.band_shift_register(x32, sb32, n_taps=TAPS,
                                             n_cols=N, w=w),
            lambda: spmm.band_shift_register_plain(x, sb, n_taps=TAPS,
                                                   n_cols=N, w=w),
            chained, f"{TAPS - 1} chained torch.matmul(z_bf16, S_dense_bf16)",
            2 * ((1 + TAPS) * R * N + win * bs * bs),
            (TAPS - 1) * 2 * R * win * bs * bs)
    f32 = dict(a1=a1.float(), a2=a2.float(), v=v.float())
    mx32, sm32 = af.stats_call(f32["a1"], f32["a2"], aux32.mask_row, w=wa,
                               ibs=ibs)
    support = int(aux32.mask_row.sum().item())
    twin = _window_blocks(Np // ibs, wa) * ibs * ibs
    row("stats_call", f"Q={Q} N={Np} w={wa}",
        lambda: af.stats_call(a1, a2, aux.mask_row, w=wa, ibs=ibs),
        lambda: af.stats_call(f32["a1"], f32["a2"], aux32.mask_row, w=wa,
                              ibs=ibs),
        lambda: af.stats_plain(a1, a2, aux.mask_row, w=wa, ibs=ibs),
        None, None, 2 * (2 * Q * Np + twin) + 4 * 2 * Q * Np,
        5 * Q * support)
    # its operations: an expf a support score, on the SFU (as
    # shard_bf16_kernels bounds kernel 10b)
    t_exp = Q * support / SFU_EXP_PER_S * 1e3
    rows["stats_call"]["exp_ms"] = t_exp
    if t_exp > rows["stats_call"]["bound_ms"]:
        rows["stats_call"].update(bound_ms=t_exp, bound_by="operations")
    row("apply_call", f"Q={Q} F={F} N={Np} w={wa} with S",
        lambda: af.apply_call(a1, a2, v, mx, sm, aux.slab_col, aux.mask_col,
                              w=wa, ibs=ibs, lists=aux.lists),
        lambda: af.apply_call(f32["a1"], f32["a2"], f32["v"], mx32, sm32,
                              aux32.slab_col, aux32.mask_col, w=wa, ibs=ibs,
                              lists=aux32.lists),
        lambda: af.apply_plain(a1, a2, v, mx, sm, aux.slab_col, aux.mask_col,
                               w=wa, ibs=ibs),
        None, None,
        2 * (2 * Q * Np + 2 * Q * F * Np + twin) + 4 * 2 * Q * Np
        + aux.sup_entries.numel() * 2 + aux.sup_offs.numel() * 4,
        (2 * F + 7) * Q * support)

    # the bf16 register against the bf16 chained band_matmul and chained
    # torch.matmul at SWEEP_ROWS: measured, it moves no dispatch
    # (REGISTER_MAX_ROWS is the f32 sweep's)
    emit(phase="register_sweep_bf16", **_register_sweep(sb, Sd, N, w, dev))

    # the wrapper's host us a call at R = 32: the CUDA implementation
    # called directly (the wrapper before the op registration: the same
    # checks and launch), through the registered op (torch.library.Library
    # define/impl, what the wrappers call), and through a
    # torch.library.custom_op of the same implementation
    x = randn(BATCH, N)
    probe = torch.library.custom_op(
        "gnt_probe::band_matmul", spmm._band_matmul_cuda, mutates_args=(),
        schema="(Tensor x, Tensor s_band, int n_cols, int w, int block_size)"
               " -> Tensor")
    host = {"float32": {}, "bfloat16": {}}
    # in turns (f32, bf16, bf16, f32), each form twice a dtype
    for dt in (torch.float32, bf, bf, torch.float32):
        xd, sbd = x.to(dt), (sb32 if dt == torch.float32 else sb)
        tag = str(dt).split(".")[-1]
        for form, fn in (
                ("direct_impl", lambda: spmm._band_matmul_cuda(
                    xd, sbd, N, w, 128)),
                ("library_op", lambda: spmm.band_matmul(
                    xd, sbd, n_cols=N, w=w)),
                ("custom_op", lambda: probe(xd, sbd, N, w, 128))):
            host[tag].setdefault(form, []).append(_host_us(fn))
    emit(phase="bf16_timing", peaks=dict(
        hbm_tb_s=HBM_BYTES_PER_S / 1e12,
        bf16_dense_tflops=BF16_FLOPS_PER_S / 1e12), rows=rows,
        host_us_per_call_band_matmul_R32=host)
    return errs, rows


def _bf16_engines(build, batch, dev):
    """{dtype tag: engine} of one model (f32 engine on the model, the bf16
    engine on its bf16 copy)."""
    import torch
    from graph_neural_networks_torch.serving import InferenceEngine
    arch = build()
    return {"f32": InferenceEngine(arch, batch, dev),
            "bf16": InferenceEngine(arch, batch, dev, dtype=torch.bfloat16)}


def _serve_counted(eng, requests):
    """Answers to `requests`, the kernels' launches and op calls counted
    from 0 just before and read just after."""
    import torch
    from graph_neural_networks_torch import kernels
    _reset_counts()
    kernels.OP_CALLS.clear()
    answers = [eng(x) for x in requests]
    torch.cuda.synchronize()
    return answers, _attention_counts(), _op_calls()


def phase_bf16_serving(S_np, gat_arch, rng, dev):
    """band_n4096 (band, bcsr, dense; band also at batch 64, whose second
    layer's 4096 rows take the chained band_matmul) and gat_band_n16384
    (band; dense mode one sample at a time) served in bf16 with REQUESTS /
    GAT_REQUESTS: the launches a forward equal the f32 engines', every one
    a bf16 instance; band and bcsr against bf16 dense, every bf16 engine
    against its f32 engine; host and device ms of a forward beside f32's.
    The main path of the bf16 kernels. Returns their launches and the
    engines."""
    import torch
    from graph_neural_networks_torch.serving import InferenceEngine
    t_phase = time.perf_counter()
    requests = [rng.standard_normal((n, 1, N_GRAPH)).astype(np.float32)
                for n in REQUESTS]
    engines = {m: _bf16_engines(lambda m=m: _build_model(S_np, m, dev), BATCH,
                                dev) for m in ("dense", "band", "bcsr")}
    checks, served, profiles = [], {}, []
    bf16_launches = {k: 0 for k in BF16_KERNELS}

    def vs(label, got, want, tol):
        for i, (g, wnt) in enumerate(zip(got, want)):
            scale = wnt.abs().max().item()
            err = (g - wnt).abs().max().item()
            ok = bool(torch.isfinite(g).all()) and err <= tol * scale
            checks.append(dict(check=label, request=i, max_abs_err=err,
                               max_abs_ref=scale, share=err / scale,
                               allowed_share=tol, ok=ok))
            require(ok, f"bf16 serving: {label} request {i}: {err} > "
                        f"{tol} * {scale}")

    def serve(label, engs, reqs, n_req):
        out = {}
        for tag in ("f32", "bf16"):
            answers, counts, calls = _serve_counted(engs[tag], reqs)
            per_forward = {k: v / n_req for k, v in counts.items() if v}
            out[tag] = dict(answers=answers, per_forward=per_forward,
                            calls=calls)
        f, b = out["f32"], out["bf16"]
        require(f["per_forward"] == b["per_forward"],
                f"{label}: bf16 launches a forward {b['per_forward']}, f32 "
                f"{f['per_forward']}")
        require(all(k.endswith(":bfloat16") for k in b["calls"]),
                f"{label}: a bf16 forward called {b['calls']}")
        for k, n in b["calls"].items():
            bf16_launches[k.split(":")[0]] += n
        vs(f"{label} bf16 vs f32", b["answers"], f["answers"],
           BF16_VS_F32_TOL)
        emit(phase="bf16_serving", model=label,
             launches_per_forward=b["per_forward"], op_calls=b["calls"],
             f32_op_calls=f["calls"])
        served[label] = out
        for tag in ("f32", "bf16"):
            prof = _device_profile(lambda: engs[tag](reqs[0]), 5)
            profiles.append(dict(model=label, dtype=tag,
                                 host_ms=prof["wall_ms"],
                                 device_ms=prof["device_ms"],
                                 device_idle_share=prof["device_idle_share"],
                                 top=prof["top"][:4]))
        return out

    for mode in ("dense", "band", "bcsr"):
        serve(f"band_n4096 {mode}", engines[mode], requests, len(REQUESTS))
    dense_b = served["band_n4096 dense"]["bf16"]["answers"]
    for mode in ("band", "bcsr"):
        vs(f"band_n4096 {mode} bf16 vs dense bf16",
           served[f"band_n4096 {mode}"]["bf16"]["answers"], dense_b,
           BF16_SERVE_TOL)
    wide = [rng.standard_normal((n, 1, N_GRAPH)).astype(np.float32)
            for n in (2 * BATCH, BATCH + 1)]
    wide_engines = _bf16_engines(lambda: _build_model(S_np, "band", dev),
                                 2 * BATCH, dev)
    serve(f"band_n4096 band B={2 * BATCH}", wide_engines, wide, len(wide))
    gat_reqs = [rng.standard_normal((n, GAT_DIMS[0], GAT_N)).astype(
        np.float32) for n in GAT_REQUESTS]
    gat = {"f32": InferenceEngine(gat_arch, GAT_BATCH, dev),
           "bf16": InferenceEngine(gat_arch, GAT_BATCH, dev,
                                   dtype=torch.bfloat16)}
    out = serve("gat_band_n16384 band", gat, gat_reqs, len(GAT_REQUESTS))
    # dense-mode GAT at N = 16384 in bf16, one sample a forward (a batch of
    # 8 would hold ~9 GB a score tensor), with the band model's weights (it
    # was trained in phase_training)
    S_gat = gat_arch.S.S[0].cpu().numpy().astype(np.float64)
    dense_arch = _build_gat("GraphAttentionNetwork", S_gat, "dense", dev)
    with torch.no_grad():
        for p, q in zip(dense_arch.parameters(), gat_arch.parameters()):
            p.copy_(q)
    dense = InferenceEngine(dense_arch, 1, dev, dtype=torch.bfloat16)
    require(torch.equal(dense.arch.S.S, gat_arch.S.S),
            "gat_band_n16384: dense and band GSOs differ")
    x0 = gat_reqs[0]
    want = torch.cat([dense(x0[i:i + 1]) for i in range(x0.shape[0])])
    vs("gat_band_n16384 band bf16 vs dense bf16 (first request)",
       [out["bf16"]["answers"][0]], [want], BF16_SERVE_TOL)
    del dense, want
    torch.cuda.empty_cache()
    emit(phase="bf16_serving_check", checks=checks, profiles=profiles,
         seconds=time.perf_counter() - t_phase)
    served_engines = {f"band_n4096 {m} {tag}": e
                      for m, engs in engines.items()
                      for tag, e in engs.items()}
    served_engines.update({f"gat_band_n16384 band {tag}": e
                           for tag, e in gat.items()})
    return bf16_launches, served_engines


def phase_multi_arg_serving(dev, card):
    """flock_n262k's LocalGNN_DB([6,32],[4]) served as engine(x, EllGso):
    4 trajectories x T = 10 rolled on the grid kernels (their ELL graphs,
    D = 32), requests of 4, 3 and 1; bit-equal to arch.apply on the padded
    batch in f32; in bf16 within BF16_VS_F32_TOL of arch.apply in f32 on
    the request, graph and weights rounded to bf16 (the numbers the bf16
    engine is given), its distance to the unrounded f32 answer printed
    beside it."""
    import torch
    from graph_neural_networks_torch.ops.ell import EllGso
    from graph_neural_networks_torch.serving import InferenceEngine
    t_phase = time.perf_counter()
    env, _, _, net = _flock_setup("flock_n262k", dev)
    c = FLOCK["flock_n262k"]
    B, T = DB_REQ["B"], DB_REQ["T"]
    ip, iv = env.compute_initial_positions(
        c["N"], B, env.commRadius, minDist=env.initMinDist,
        geometry="circular", xMaxInitVel=3.0, yMaxInitVel=3.0)
    t0 = time.perf_counter()
    _, _, _, states, graphs = env.compute_trajectory(
        ip, iv, T * env.samplingTime, net, return_graphs=True,
        ell_degree=FLOCK_D, env_grid=True, lam_iters=0, env_grid_strict=True)
    t_roll = time.perf_counter() - t0
    x = torch.as_tensor(states, dtype=torch.float32, device=dev)
    S = EllGso(torch.as_tensor(graphs.idx, device=dev),
               torch.as_tensor(graphs.val, dtype=torch.float32, device=dev))
    require(tuple(x.shape) == (B, T, 6, c["N"]) and tuple(S.idx.shape) == (
        B, T, c["N"], FLOCK_D), f"DB request {tuple(x.shape)}")
    del states, graphs
    with torch.inference_mode():
        want = net.apply(x, S)
        # f32 on the numbers the bf16 engine is given: the request, graph
        # and weights rounded to bf16 (the rounding of the raw states alone
        # moves the answer: features up to ~1e2-1e4, 1/r^4 of close pairs)
        rounded = copy.deepcopy(net)
        for p in rounded.parameters():
            p.copy_(p.bfloat16().float())
        want_rounded = rounded.apply(x.bfloat16().float(), EllGso(
            S.idx, S.val.bfloat16().float()))
        del rounded
    engines = {"f32": InferenceEngine(net, B, dev),
               "bf16": InferenceEngine(net, B, dev, dtype=torch.bfloat16)}
    rows = []
    for tag, eng in engines.items():
        for n in DB_REQ["requests"]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = eng(x[:n], EllGso(S.idx[:n], S.val[:n]))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            err = (got - want[:n]).abs().max().item()
            scale = want[:n].abs().max().item()
            row = dict(dtype=tag, n=n, host_ms=ms, max_abs_err=err,
                       max_abs_ref=scale,
                       bit_equal=bool(torch.equal(got, want[:n])))
            if tag == "f32":
                ok = row["bit_equal"]
            else:
                ref = want_rounded[:n]
                row.update(
                    rounded_inputs_vs_f32=(ref - want[:n]).abs().max().item(),
                    max_abs_err_vs_rounded_inputs=(got - ref).abs().max()
                    .item(), max_abs_ref_rounded=ref.abs().max().item())
                ok = bool(torch.isfinite(got).all()) and row[
                    "max_abs_err_vs_rounded_inputs"] <= (
                        BF16_VS_F32_TOL * row["max_abs_ref_rounded"])
            rows.append(dict(row, ok=ok))
            require(ok, f"flock_n262k (x, EllGso) {tag} n={n}: {rows[-1]}")
    emit(phase="multi_arg_serving", model="flock_n262k LocalGNN_DB([6,32],"
         "[4])", B=B, T=T, N=c["N"], D=FLOCK_D, edges=int((S.val > 0).sum()),
         rollout_seconds=t_roll, rows=rows, nvidia_smi=card,
         seconds=time.perf_counter() - t_phase)
    return engines["f32"], (x[:1], EllGso(S.idx[:1], S.val[:1])), (net, x,
                                                                     S)


_EXPORT_RELOAD = """
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from graph_neural_networks_torch.ops import attention_flash as af
from graph_neural_networks_torch.ops import spmm
from graph_neural_networks_torch.serving import load_exported
cases = torch.load(sys.argv[2], weights_only=False)
out, counts = {}, {}
for key, (path, args) in cases.items():
    t0 = time.perf_counter()
    fn = load_exported(path)
    fn(*args)   # warm-up
    spmm.reset_launch_counts()
    af.reset_launch_counts()
    out[key] = fn(*args).cpu()   # synchronizes
    counts[key] = {f.__name__: f.launches for f in spmm.KERNEL_WRAPPERS
                   + af.KERNEL_WRAPPERS if f.launches}
    counts[key]["seconds"] = time.perf_counter() - t0
assert not any(m.startswith("graph_neural_networks_torch.models")
               for m in sys.modules), "the model code was imported"
torch.save(out, sys.argv[3])
print(json.dumps(counts))
"""


def phase_export(S_np, gat_arch, rng, dev):
    """export_model on the card for band_n4096 (band and bcsr, f32 and bf16)
    and gat_band_n16384 (bf16); each reloaded in a fresh process (which
    imports no model code) and answering one request bit-equal to the
    engine, with the engine's launch counts."""
    import torch
    from graph_neural_networks_torch.serving import (InferenceEngine,
                                                     export_model)
    t_phase = time.perf_counter()
    x = rng.standard_normal((BATCH, 1, N_GRAPH)).astype(np.float32)
    xg = rng.standard_normal((GAT_BATCH, GAT_DIMS[0], GAT_N)).astype(
        np.float32)
    cases = [("band_n4096 band", lambda: _build_model(S_np, "band", dev),
              BATCH, x, ("f32", "bf16")),
             ("band_n4096 bcsr", lambda: _build_model(S_np, "bcsr", dev),
              BATCH, x, ("f32", "bf16")),
             ("gat_band_n16384 band", lambda: gat_arch, GAT_BATCH, xg,
              ("bf16",))]
    rows, want, want_counts, saved = [], {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        for label, build, batch, xr, tags in cases:
            arch = build()
            for tag in tags:
                dtype = torch.bfloat16 if tag == "bf16" else None
                key = f"{label} {tag}"
                path = os.path.join(tmp, key.replace(" ", "_") + ".pt2")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                blob = export_model(arch, (xr,), path=path, dtype=dtype,
                                    device=dev)
                seconds = time.perf_counter() - t0
                eng = InferenceEngine(arch, batch, dev, dtype=dtype)
                eng(xr)   # warm-up (a GAT builds no band structure: cached)
                _reset_counts()
                want[key] = eng(xr).cpu()
                torch.cuda.synchronize()
                want_counts[key] = {k: v for k, v in
                                    _attention_counts().items() if v}
                rows.append(dict(model=key, export_seconds=seconds,
                                 bytes=len(blob)))
                saved[key] = (path, (xr,))
        inputs = os.path.join(tmp, "inputs.pt")
        outputs = os.path.join(tmp, "outputs.pt")
        torch.save(saved, inputs)
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", _EXPORT_RELOAD, HERE,
                              inputs, outputs], capture_output=True,
                             text=True, timeout=600)
        reload_seconds = time.perf_counter() - t0
        require(run.returncode == 0,
                f"export reload failed: {run.stderr[-3000:]}")
        got_counts = json.loads(run.stdout.strip().splitlines()[-1])
        got = torch.load(outputs, weights_only=False)
    for r in rows:
        key = r["model"]
        counts = dict(got_counts[key])
        r["reload_seconds"] = counts.pop("seconds")
        r.update(launches=counts, engine_launches=want_counts[key],
                 bit_equal=bool(torch.equal(got[key], want[key])),
                 max_abs_err=(got[key] - want[key]).abs().max().item())
        require(r["bit_equal"], f"export {key}: the reloaded program "
                                f"differs from the engine: {r}")
        require(counts == want_counts[key],
                f"export {key}: reloaded launches {counts}, engine "
                f"{want_counts[key]}")
    emit(phase="export", rows=rows, reload_process_seconds=reload_seconds,
         seconds=time.perf_counter() - t_phase)


def phase_introspection(engines):
    """flops_per_sample, cost_analysis and memory_analysis of each served
    engine (one padded batch of its last request's shapes)."""
    rows = []
    for label, eng in engines.items():
        m = eng.memory_analysis()
        rows.append(dict(model=label, batch=eng.batch_size,
                         dtype=str(eng.dtype), cost=eng.cost_analysis(),
                         flops_per_sample=eng.flops_per_sample(),
                         memory=dict(
                             argument_size_in_bytes=m.argument_size_in_bytes,
                             output_size_in_bytes=m.output_size_in_bytes,
                             temp_size_in_bytes=m.temp_size_in_bytes)))
    emit(phase="introspection", rows=rows)



# ---------------------------------------------------------------------------
# Item 1: bf16 mixed-precision training (Trainer(precision="bf16")) on the
# bf16 instances of kernels 1-3 and 7-8 and on kernel 9b
# ---------------------------------------------------------------------------

# kernel 9b (attn_bwd_mma_kernel) against its bf16 plain version: dv within
# BF16_ULPS bf16 ulps of the larger value, the ulp taken at no less than
# BF16_ULP_FLOOR of max|dv| (one rounding of an f32 sum taken in another
# order, the coefficient carried as two bf16 parts); da2 and the folded da1
# (f32) within BF16_BWD_REL of their largest magnitude
BF16_BWD_REL = 1e-3
# a bf16 training step on the kernels against the same bf16 step on the
# kernels' plain versions (on the card, from the same masters and batch):
# first-step gradients within BF16_TRAIN_GRAD_TOL of each leaf's largest
# |g|; against the f32 step: the losses within BF16_TRAIN_LOSS (the JAX
# package's own bf16 bound, tests/test_training.py:
# test_bf16_mixed_precision_training). The first-step gradients' distance
# from f32's is reported, not held to BF16_TRAIN_GRAD_TOL: bf16 rounding
# alone moves them further (the JAX package's own bf16 gradients of
# band_n4096's SelectionGNN at N = 1024 lie 5-14% of max|g| from its f32
# ones, experiments/bf16_grad_noise.py)
BF16_TRAIN_GRAD_TOL = 5e-2
BF16_TRAIN_LOSS = dict(rtol=0.05, atol=0.02)
BF16_TRAIN_STEPS = 3
# flock_train_n262k in bf16: 2 steps (cut from its 3 epochs of 4 steps)
BF16_FLOCK_STEPS = 2


def _bf16_aux(aux):
    """A BandAux with its float fields in bf16 (its entry lists kept)."""
    import torch
    return type(aux)(*(t.to(torch.bfloat16) if t.is_floating_point() else t
                       for t in aux))


def _rel_err(got, want):
    """max|got - want| over max|want|."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp_min(1e-30)).item()


def phase_bf16_train_kernels(gso, dev):
    """Kernel 9b (bwd_call on bf16 operands: attn_bwd_mma_kernel) against
    its bf16 plain version at gat_band_n16384's shape (Q = 16, F = 32,
    w = 2, with S, on the served model's band structure cast to bf16) and
    at edge shapes: Q = 1, 2, 3 (the kernel's signal-row pairs); F = 8,
    24, 32, 40, 48, 64; w = 1, 2, 3; without S; a window tile and a
    sub-tile without support; ragged N; ibs = 64 and 192 (one and three
    64-row tiles); each synchronized; and the shared memory the launcher
    asks for against the Python check's layout. Then the served shape
    timed by CUDA events and graph_ms beside the f32 instance on the same
    values, with its plain version and its bound."""
    import torch
    from graph_neural_networks_torch import kernels
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.ops import gso as gso_lib
    t_phase = time.perf_counter()
    bf = torch.bfloat16
    rng = np.random.default_rng(36)
    checks, errs = [], {"bwd_call": 0.0}

    def case(label, g, Q, F, with_s, aux=None, served=False):
        ibs, w = g.block_size, g.band_w
        Np = g.s_band.shape[1] * ibs
        aux = _bf16_aux(af.band_auxes(g)[0]) if aux is None else aux
        a1, a2, v = (t.to(bf) for t in _attn_operands(rng, dev, Q, F, g.n,
                                                      Np))
        ct = _attn_operands(rng, dev, Q, F, g.n, Np)[2].to(bf)
        mx, sm = af.stats_plain(a1, a2, aux.mask_row, w=w, ibs=ibs)
        args = (a1, a2, v, mx, sm, aux.slab_col, aux.mask_row, ct)
        kernels.OP_CALLS.clear()
        got = af.bwd_call(*args, w=w, ibs=ibs, with_s=with_s)
        torch.cuda.synchronize()
        require(kernels.OP_CALLS["bwd_call", bf] == 1 and got[2].dtype == bf
                and got[0].dtype == got[1].dtype == torch.float32,
                f"bf16 bwd_call [{label}]: dtypes {[t.dtype for t in got]}")
        want = af.bwd_plain(*args, w=w, ibs=ibs, with_s=with_s)
        fold = [af.fold_window_partials(t[1], w) for t in (got, want)]
        empty, total = _empty_subchunks(g)
        row = dict(case=label, Q=Q, F=F, N=g.n, w=w, ibs=ibs, with_s=with_s,
                   sub_chunks_skipped=f"{empty} of {total}",
                   da2_rel=_rel_err(got[0], want[0]),
                   da1_rel=_rel_err(*fold),
                   dv_ulps=_ulps_of(got[2], want[2]),
                   max_abs_err=max((t - p).abs().max().item() for t, p in
                                   zip(got, want)))
        row["ok"] = (all(bool(torch.isfinite(t.float()).all()) for t in got)
                     and row["da2_rel"] <= BF16_BWD_REL
                     and row["da1_rel"] <= BF16_BWD_REL
                     and row["dv_ulps"] <= BF16_ULPS)
        checks.append(row)
        require(row["ok"], f"bf16 bwd_call [{label}] disagrees with its "
                           f"plain version: {row}")
        if served:
            errs["bwd_call"] = max(errs["bwd_call"], row["max_abs_err"])
        return args

    Q, F, w = GAT_BATCH * GAT_HEADS[0], GAT_DIMS[1], gso.band_w
    served = _bf16_aux(af.band_auxes(gso.to(dtype=bf))[0])
    args = case(f"served Q={Q} F={F} N={GAT_N} w={w}", gso, Q, F, True,
                served, served=True)
    case(f"served without S, F=8", gso, Q, 8, False, served)
    case(f"GCAT shape without S, F=64", gso, Q, 64, False, served)
    # the kernel's signal-row pairs at their edges (Q = 1, 2, 3) and
    # F = 48 (NF = 3)
    for Qe, Fe in ((1, 32), (2, 32), (3, 32), (Q, 48)):
        case(f"served Q={Qe} F={Fe}", gso, Qe, Fe, True, served)
    for label, S, ibs, Qe, Fe in (
            ("N=2048 w=1 F=24", _attn_case(rng, 2048, 1), 128, 4, 24),
            ("holes N=2048 w=2 F=32", _attn_holes_case(rng), 128, 3, 32),
            ("ragged N=4000 w=1 F=32", _attn_case(rng, 4000, 1), 128, 16,
             32),
            ("N=1000 w=3 ibs=64 F=40", _attn_case(rng, 1000, 3, bs=64), 64,
             2, 40),
            ("N=2000 w=1 ibs=192 F=32", _attn_case(rng, 2000, 1, bs=192),
             192, 4, 32)):
        g = gso_lib.as_gso(S, "band", block_size=ibs, device=dev)
        for ws in (True, False):
            case(f"{label} Q={Qe}", g, Qe, Fe, ws)
    require(_empty_subchunks(gso_lib.as_gso(
        _attn_holes_case(np.random.default_rng(1)), "band", device=dev))[0]
        > 0, "the holes graph has no sub-chunk to skip")
    # the shared memory the bf16 launcher asks for (the library's against
    # the Python check's layout), and F past the kernel
    smem = {Fs: kernels.entry("gnt_attn_bwd_smem_bytes", bf)(Fs, 2 * w + 1,
                                                              128)
            for Fs in (8, 32, 64)}
    require(all(0 < n <= af._BLOCK_SMEM_BYTES for n in smem.values()),
            f"attn_bwd_mma_kernel shared memory {smem}")
    for Fs, Ws, ibs_s in ((8, 5, 128), (32, 5, 128), (48, 3, 64),
                          (64, 7, 192), (16, 3, 256)):
        got = kernels.entry("gnt_attn_bwd_smem_bytes", bf)(Fs, Ws, ibs_s)
        require(got == af.bwd_bf16_smem_bytes(Fs, Ws, ibs_s),
                f"attn_bwd_mma_kernel at F={Fs} W={Ws} ibs={ibs_s}: {got} "
                "bytes, the Python check "
                f"{af.bwd_bf16_smem_bytes(Fs, Ws, ibs_s)}")
    try:
        af._check_bwd_smem("bwd_call", w, gso.block_size, 65, bf)
        raise SmokeFailure("the bf16 backward took F = 65")
    except ValueError:
        pass

    # timing at the served shape: the bf16 and f32 instances on the same
    # values
    aux32 = af.band_auxes(gso)[0]
    a1, a2, v, mx, sm, _, _, ct = args
    args32 = (a1.float(), a2.float(), v.float(), mx, sm, aux32.slab_col,
              aux32.mask_row, ct.float())
    ibs = gso.block_size
    nb = gso.s_band.shape[1]
    Np, W = nb * ibs, 2 * w + 1
    tile = nb * W * ibs * ibs
    support = Q * int(aux32.mask_row.sum().item())
    # bf16 g, v, dv, a1, a2, mask_row and slab_col; f32 rowmax, rowsum,
    # da2 and the da1 partials; each read or written once
    nbytes = 2 * (3 * Q * F * Np + 2 * Q * Np + 2 * tile) + 4 * (
        3 * Q * Np + Q * nb * W * ibs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_exp = support / SFU_EXP_PER_S * 1e3
    t_mma = 4 * F * support / BF16_FLOPS_PER_S * 1e3
    bound = max(t_bytes, t_exp, t_mma)
    kw = dict(w=w, ibs=ibs)
    row = dict(
        shape=f"Q={Q} F={F} N={GAT_N} w={w} ibs={ibs} with_s",
        ms=time_ms(lambda: af.bwd_call(*args, **kw)),
        graph_ms=graph_ms(lambda: af.bwd_call(*args, **kw)),
        f32_ms=time_ms(lambda: af.bwd_call(*args32, **kw)),
        f32_graph_ms=graph_ms(lambda: af.bwd_call(*args32, **kw)),
        plain_ms=time_ms(lambda: af.bwd_plain(*args, **kw), reps=5,
                         inner=2),
        library_ms=None, bytes=nbytes, support_scores=support,
        bound_ms=bound, bound_by="bytes" if bound == t_bytes
        else "operations", bytes_ms=t_bytes, exp_ms=t_exp,
        products_ms=t_mma)
    emit(phase="bf16_train_kernels", dv_ulps_allowed=BF16_ULPS,
         ulp_floor_share=BF16_ULP_FLOOR, f32_rel_allowed=BF16_BWD_REL,
         checks=checks, smem_bytes=smem, timing=row,
         library="none: no single PyTorch call computes the function",
         seconds=time.perf_counter() - t_phase)
    return errs, {"bwd_call": row}


@contextlib.contextmanager
def _plain_kernels():
    """Within the block the SpMM and attention wrappers (kernels 1-3, 7-9)
    run their plain versions, on the card too: the reference a path on the
    kernels is held to. The wrappers' counts do not move."""
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.ops import spmm

    def plain(fn):
        def call(*args, **kw):
            kw.pop("lists", None)
            kw.pop("col_start", None)
            return fn(*args, **kw)
        return call
    subs = [(spmm, "band_matmul", spmm.band_matmul_plain),
            (spmm, "band_shift_register", spmm.band_shift_register_plain),
            (spmm, "bcsr_matmul", spmm.bcsr_matmul_plain),
            (af, "stats_call", af.stats_plain),
            (af, "apply_call", af.apply_plain),
            (af, "bwd_call", af.bwd_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in subs]
    for mod, name, fn in subs:
        setattr(mod, name, plain(fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _twin(arch):
    """A second architecture on the same masters: its own copy of the
    parameters, the context (GSO, band structure) shared."""
    twin = copy.copy(arch)
    twin.core = copy.deepcopy(arch.core)
    return twin


def _bf16_vs_f32(label, archs, data, batch, model_fn, steps, expected=None,
                 profile=None, ref=None, **trainer_kw):
    """`steps` Trainer steps of one model in f32 and in bf16
    (precision='bf16') from the same masters (archs: f32, bf16 and, when a
    third is given, bf16 on the plain versions for the first step) on the
    same batches: the first step's gradients on the masters (the bf16
    ones against the plain versions' or, given ref = (label, gradients),
    against those, and beside f32's), the losses, the
    launches of the steps (counts from 0 just before, read just after:
    equal in both, `expected` a step when given) and the op calls by dtype
    (every one of the bf16 steps a bf16 instance, of the f32 steps an f32
    one), each step's host ms; then `profile`(trainer) device ms per step.
    Returns the check row and the bf16 launches."""
    import torch
    from graph_neural_networks_torch import kernels
    runs = {}
    if len(archs) == 3:
        model = model_fn(archs[2], f"{label}_bf16_plain")
        trainer = model.trainer(model, data, 1, batch, precision="bf16",
                                **trainer_kw)
        with _plain_kernels():
            trainer.train_batch(np.arange(batch) % data.nTrain)
        torch.cuda.synchronize()
        plain_grads = [p.grad.detach().double().clone()
                       for p in model.archit.parameters()]
        del model, trainer
    for tag, arch in zip(("f32", "bf16"), archs):
        model = model_fn(arch, f"{label}_{tag}")
        kw = dict(trainer_kw, **({"precision": "bf16"} if tag == "bf16"
                                 else {}))
        trainer = model.trainer(model, data, 1, batch, **kw)
        torch.cuda.synchronize()
        _reset_all_counts()
        kernels.OP_CALLS.clear()
        losses, host_ms, grads = [], [], None
        for s in range(steps):
            idx = np.arange(s * batch, (s + 1) * batch) % data.nTrain
            loss, secs = trainer.train_batch(idx)
            losses.append(loss)
            host_ms.append(secs * 1e3)
            if grads is None:
                grads = [p.grad.detach().double().clone()
                         for p in model.archit.parameters()]
        torch.cuda.synchronize()
        runs[tag] = dict(losses=losses, host_ms=host_ms, grads=grads,
                         counts=_all_counts(), calls=_op_calls(),
                         trainer=trainer, model=model)
    f, b = runs["f32"], runs["bf16"]

    def shares(got, want):   # each leaf's max|got - want| / max|want|
        return [(g - w_).abs().max().item() / max(w_.abs().max().item(),
                                                  1e-30)
                for g, w_ in zip(got, want)]
    vs_f32 = shares(b["grads"], f["grads"])
    vs_plain = (shares(b["grads"], plain_grads) if len(archs) == 3
                else None)
    vs_ref = shares(b["grads"], ref[1]) if ref is not None else None
    per_step = {k: n / steps for k, n in b["counts"].items() if n}
    row = dict(model=label, steps=steps, batch=batch,
               losses_bf16=b["losses"], losses_f32=f["losses"],
               first_step_grad_shares_vs_bf16_plain=vs_plain,
               grad_share_allowed=BF16_TRAIN_GRAD_TOL,
               first_step_grad_shares_vs_f32=vs_f32,
               launches_per_step=per_step, op_calls_bf16=b["calls"],
               op_calls_f32=f["calls"], host_ms_bf16=b["host_ms"],
               host_ms_f32=f["host_ms"])
    if ref is not None:
        row.update(first_step_grad_reference=ref[0],
                   first_step_grad_shares_vs_reference=vs_ref)
    require(all(p.dtype == torch.float32
                for p in b["model"].archit.parameters()),
            f"{label}: the bf16 run's masters are not f32")
    require(b["counts"] == f["counts"],
            f"{label}: bf16 launches {b['counts']}, f32 {f['counts']}")
    if expected is not None:
        want = {k: n * steps for k, n in expected.items() if n}
        require({k: n for k, n in b["counts"].items() if n} == want,
                f"{label}: launches {b['counts']}, expected {want}")
    require(all(k.endswith(":bfloat16") for k in b["calls"])
            and all(k.endswith(":float32") for k in f["calls"]),
            f"{label}: op calls bf16 {b['calls']}, f32 {f['calls']}")
    require(vs_plain is None or max(vs_plain) <= BF16_TRAIN_GRAD_TOL,
            f"{label}: bf16 first-step gradients {vs_plain} of max|g| from "
            "the plain versions'")
    if ref is not None:
        require(max(vs_ref) <= BF16_TRAIN_GRAD_TOL,
                f"{label}: bf16 first-step gradients {vs_ref} of max|g| "
                f"from the {ref[0]}'s")
    require(bool(np.isfinite(b["losses"]).all()) and np.allclose(
        b["losses"], f["losses"], **BF16_TRAIN_LOSS),
        f"{label}: bf16 losses {b['losses']}, f32 {f['losses']}")
    if profile is not None:
        for tag in ("f32", "bf16"):
            prof = profile(runs[tag]["trainer"])
            row[f"profile_{tag}"] = dict(
                host_ms=prof["wall_ms"], device_ms=prof["device_ms"],
                device_idle_share=prof["device_idle_share"],
                top=prof["top"][:5])
    return row, b["calls"]


def _step_profile_fn(batch, n=3):
    """A trainer's device ms a step: _device_profile over n steps."""
    def profile(trainer):
        nt = trainer.data.nTrain
        it = itertools.cycle([np.arange(i * batch, (i + 1) * batch) % nt
                              for i in range(n + 1)])
        return _device_profile(lambda: trainer.train_batch(next(it)), n,
                               warmup=1)
    return profile


def phase_bf16_training(gat_arch, S_np, rng, dev, out_dir):
    """Trainer(precision='bf16') against f32 training from the same masters
    and batches, and its first step against the bf16 step on the plain
    versions: band_n4096 in band and bcsr mode, gat_band_n16384 (the
    served model's weights) and movielens_n1186's LocalGNN2Ly in bcsr mode
    (TrainerSingleNode): see _bf16_vs_f32. A bf16 step launches what an f32
    step launches, every launch a bf16 instance (kernel 9b included).
    Returns the bf16 launches by kernel."""
    from graph_neural_networks_torch import data as D
    from graph_neural_networks_torch import training as T
    t_phase = time.perf_counter()
    rows, launches = [], {}

    def add(calls):
        for k, n in calls.items():
            name = k.split(":")[0]
            launches[name] = launches.get(name, 0) + n

    data = _synthetic_data(rng, (BF16_TRAIN_STEPS * BATCH, BATCH, BATCH), 1,
                           N_GRAPH, 5)
    band_step = _band_launches(step=True)
    for mode, expected in (
            ("band", {k: n for k, n in band_step.items() if n}),
            ("bcsr", {"bcsr_matmul": 12})):
        arch = _build_model(S_np, mode, dev)
        row, calls = _bf16_vs_f32(
            f"band_n4096 {mode}", (arch, _twin(arch), _twin(arch)), data,
            BATCH,
            lambda a, name: _model(a, name, out_dir), BF16_TRAIN_STEPS,
            expected, _step_profile_fn(BATCH))
        rows.append(row)
        add(calls)
    data = _synthetic_data(rng, (BF16_TRAIN_STEPS * GAT_BATCH, GAT_BATCH,
                                 GAT_BATCH), GAT_DIMS[0], GAT_N, 4)
    row, calls = _bf16_vs_f32(
        "gat_band_n16384", (gat_arch, _twin(gat_arch), _twin(gat_arch)),
        data, GAT_BATCH,
        lambda a, name: _model(a, name, out_dir), BF16_TRAIN_STEPS,
        dict(stats_call=2, apply_call=2, bwd_call=2),
        _step_profile_fn(GAT_BATCH))
    rows.append(row)
    add(calls)
    ml = D.MovieLens("movie", ML_CELL["label"], 0.9, 0.1,
                     kNN=ML_CELL["kNN"], nSynthUsers=ML_CELL["users"],
                     nSynthMovies=ML_CELL["movies"],
                     rng=np.random.default_rng(ML_CELL["seed"]))
    ml.expandDims()
    W = ml.getGraph()
    S = W / np.max(np.abs(np.linalg.eigvalsh(W)))
    arch = _ml_arch(S, "LocalGNN2Ly", 2, "bcsr", dev)
    row, calls = _bf16_vs_f32(
        "movielens_n1186 LocalGNN2Ly bcsr", (arch, _twin(arch),
                                             _twin(arch)), ml,
        ML_CELL["batch"], lambda a, name: _ml_model(
            a, name, T.TrainerSingleNode, T.evaluate_single_node, out_dir),
        BF16_TRAIN_STEPS, {"bcsr_matmul": _ml_launches(arch, step=True)},
        _step_profile_fn(ML_CELL["batch"]))
    rows.append(row)
    add(calls)
    emit(phase="bf16_training", grad_share_allowed=BF16_TRAIN_GRAD_TOL,
         loss_tolerance=BF16_TRAIN_LOSS, checks=rows,
         seconds=time.perf_counter() - t_phase)
    return launches


def phase_bf16_flock_training(data, dev, card, out_dir):
    """flock_train_n262k's LocalGNN_DB([6,64],[3]) on the device store the
    f32 phase built: BF16_FLOCK_STEPS TrainerFlocking steps in bf16
    against f32 from the same masters (each step recomputes its
    supervision in f32 on kernels 5-6, then learns: in bf16 x and the ELL
    graphs' val, idx kept); the grid kernels' launches equal; the learning
    half's host and device ms in each precision. Its learning half runs no
    kernel, so there is no plain-version reference for its gradients."""
    import torch
    from graph_neural_networks_torch import training
    from graph_neural_networks_torch.models.architectures_time import (
        LocalGNN_DB)
    t_phase = time.perf_counter()
    c = FLOCK_TRAIN
    net = LocalGNN_DB(c["dims"], c["taps"], True, "tanh", [2], 1, device=dev,
                      generator=torch.Generator().manual_seed(c["wseed"]))
    twin = LocalGNN_DB(c["dims"], c["taps"], True, "tanh", [2], 1,
                       device=dev,
                       generator=torch.Generator().manual_seed(c["wseed"]))

    def model_fn(arch, name):
        return training.Model(arch, training.losses.mse_loss,
                              {"name": "ADAM", "lr": 5e-4},
                              training.TrainerFlocking,
                              training.evaluate_flocking, name=name,
                              saveDir=out_dir)

    def learn_profile(trainer):
        x, y, S, _, _ = trainer._recompute(*trainer._step_args([0]))
        return _device_profile(lambda: trainer._learn(x, y, S), 1, warmup=1)
    T = len(np.arange(0, c["duration"], 0.01))
    row, _ = _bf16_vs_f32(
        "flock_train_n262k", (net, twin), data, 1, model_fn,
        BF16_FLOCK_STEPS, _recompute_launches(T, c["lam_iters"]),
        learn_profile, deviceStore=True, ellDegree=c["D"],
        coverageCheck=False, seed=c["seed"])
    emit(phase="bf16_flock_training", nvidia_smi=card,
         grad_share_allowed=BF16_TRAIN_GRAD_TOL,
         loss_tolerance=BF16_TRAIN_LOSS, check=row,
         seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# Item 2.1: sharded models in bf16, served and trained, on the bf16
# instances of the ext kernels (10b: attn_stats_kernel<true, bf16>; 11b:
# attn_apply_mma_kernel<true, G>, the tensor-core apply that 8b shares;
# 12b: attn_bwd_mma_kernel<true, NF>)
# ---------------------------------------------------------------------------

# 10b-12b against their bf16 plain versions: y and dv within BF16_ULPS bf16
# ulps of the larger value (the ulp taken at no less than BF16_ULP_FLOOR of
# the output's largest magnitude); da2 and the folded da1 within
# BF16_BWD_REL of their largest magnitude; the f32 stats within
# BF16_EXT_STATS_REL of theirs. Every shard assembled against the global
# bf16 kernels 7b-9b on the same operands: the stats, y, da2 and dv
# bit-equal (each global kernel and its ext form are one template walking
# the same chunks in the same order; the f32 pairs are bit-equal too), the
# halo-folded da1 within BF16_BWD_REL (its columns are summed in another
# order at the shard edges).
BF16_EXT_STATS_REL = 1e-5
SHARD_BF16_KERNELS = ("stats_ext_call", "apply_ext_call", "bwd_ext_call")


def _shard_case_bf16(rng, dev, part, Q, F, mc, mr):
    """bf16 operands of one partition's ext kernels: each shard's own and
    halo-extended a1, a2 and v (_shard_operands, rounded to bf16), its
    masks and own slab, its halo-extended column slab, a cotangent g
    (global, and each shard's halo-extended), and each shard's stats from
    stats_ext_plain."""
    import torch
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.parallel.mesh import halo_ext
    bf = torch.bfloat16
    own, ext, masks = _shard_operands(rng, dev, part, Q, F, mc, mr)
    own = {k: [t.to(bf) for t in ts] for k, ts in own.items()}
    ext = {k: [t.to(bf) for t in ts] for k, ts in ext.items()}
    masks = [tuple(t.to(bf) for t in m) for m in masks]
    bs = part.block_size
    g = _attn_operands(rng, dev, Q, F, part.n_orig, part.n_padded)[2].to(bf)
    g_ext = halo_ext([g[..., p * bs:(p + 1) * bs].contiguous()
                      for p in range(part.n_parts)], part.halo)
    slabs = torch.as_tensor(par.attention._ext_slabs(part)[:, 0],
                            device=dev).to(bf)
    stats = [af.stats_ext_plain(ext["a1"][p], own["a2"][p], masks[p][1],
                                w=part.w, ibs=part.inner_bs)
             for p in range(part.n_parts)]
    return dict(own=own, ext=ext, masks=masks, g=g, g_ext=g_ext,
                slabs=slabs, stats=stats,
                mx_ext=halo_ext([s[0] for s in stats], part.halo),
                sm_ext=halo_ext([s[1] for s in stats], part.halo))


def _ext_bwd_args(c, p):
    return (c["ext"]["a1"][p], c["own"]["a2"][p], c["own"]["v"][p],
            *c["stats"][p], c["slabs"][p], c["masks"][p][1], c["g_ext"][p])


def _ext_apply_args(c, p):
    return (c["own"]["a1"][p], c["ext"]["a2"][p], c["ext"]["v"][p],
            c["mx_ext"][p], c["sm_ext"][p], c["masks"][p][2],
            c["masks"][p][0])


def phase_shard_bf16_kernels(part, mc, mr, dev):
    """Kernels 10b, 11b and 12b (stats_ext_call, apply_ext_call and
    bwd_ext_call on bf16 operands) against their bf16 plain versions on
    operands halo-extended from real neighbour shards, synchronized after
    each: at the served shard shape (gat_band_n16384 over 4: Q = 16,
    F = 32, Np = 4096, w = 2) for the first, an interior and the last
    shard, with_s both ways; on partitions with w = 1 (Q = 4, F = 24;
    Q = 1, F = 48), w = 3 (F = 64 and F = 8) and the holes graph (w = 2,
    an empty window tile and sub-tile); rows without support on the first
    and last shards.
    Then every served shard assembled against the global bf16 kernels
    7b-9b on the same operands, and the served shape timed by CUDA events
    and graph_ms beside the f32 ext kernels on the same values, with the
    plain versions and the bounds (bf16 bytes against the support's exps
    and products at the bf16 tensor-core peak)."""
    import torch
    from graph_neural_networks_torch import kernels
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.parallel.mesh import halo_ext, halo_fold
    t_phase = time.perf_counter()
    bf = torch.bfloat16
    rng = np.random.default_rng(38)
    checks, errs = [], {k: 0.0 for k in SHARD_BF16_KERNELS}

    def check(name, case, got, want, served, ulps=False, rel=None):
        torch.cuda.synchronize()
        require(got.dtype == want.dtype, f"{name} [{case}]: {got.dtype}")
        err = (got.double() - want.double()).abs().max().item()
        row = dict(kernel=name, case=case, max_abs_err=err)
        if ulps:
            row.update(max_ulps=_ulps_of(got, want), allowed_ulps=BF16_ULPS)
            ok = row["max_ulps"] <= BF16_ULPS
        else:
            row.update(rel_err=_rel_err(got, want), allowed_rel=rel)
            ok = row["rel_err"] <= rel
        row["ok"] = ok = ok and bool(torch.isfinite(got.float()).all())
        checks.append(row)
        if served:
            errs[name] = max(errs[name], err)
        require(ok, f"bf16 {name} [{case}] disagrees with its plain "
                    f"version: {row}")

    def run(label, part, mc, mr, Q, F, served=False):
        w, ibs = part.w, part.inner_bs
        c = _shard_case_bf16(rng, dev, part, Q, F, mc, mr)
        label = f"{label} G={_apply_group(Q, F, part.block_size, dev)}"
        for p in sorted({0, 1, part.n_parts - 1}):
            case = f"{label} shard {p}/{part.n_parts}"
            kernels.OP_CALLS.clear()
            mx, sm = af.stats_ext_call(c["ext"]["a1"][p], c["own"]["a2"][p],
                                       c["masks"][p][1], w=w, ibs=ibs)
            check("stats_ext_call", case + " rowmax", mx, c["stats"][p][0],
                  served, rel=BF16_EXT_STATS_REL)
            check("stats_ext_call", case + " rowsum", sm, c["stats"][p][1],
                  served, rel=BF16_EXT_STATS_REL)
            args = _ext_apply_args(c, p)
            lists = af.support_lists(c["masks"][p][0])
            for ws in (True, False):
                got = af.apply_ext_call(*args, w=w, ibs=ibs, with_s=ws,
                                        lists=lists)
                check("apply_ext_call", f"{case} with_s={ws}", got,
                      af.apply_ext_plain(*args, w=w, ibs=ibs, with_s=ws),
                      served, ulps=True)
                bargs = _ext_bwd_args(c, p)
                got = af.bwd_ext_call(*bargs, w=w, ibs=ibs, with_s=ws)
                want = af.bwd_ext_plain(*bargs, w=w, ibs=ibs, with_s=ws)
                bcase = f"{case} with_s={ws}"
                check("bwd_ext_call", bcase + " da2", got[0], want[0],
                      served, rel=BF16_BWD_REL)
                check("bwd_ext_call", bcase + " da1 (ext columns)",
                      af.fold_ext_partials(got[1]),
                      af.fold_ext_partials(want[1]), served,
                      rel=BF16_BWD_REL)
                check("bwd_ext_call", bcase + " dv", got[2], want[2], served,
                      ulps=True)
            calls = _op_calls()
            require(calls == {"stats_ext_call:bfloat16": 1,
                              "apply_ext_call:bfloat16": 2,
                              "bwd_ext_call:bfloat16": 2},
                    f"bf16 ext kernels [{case}]: op calls {calls}")
        return c

    served_c = run(f"served Q=16 F=32 Np={part.block_size} w={part.w}",
                   part, mc, mr, GAT_BATCH * GAT_HEADS[0], GAT_DIMS[1],
                   served=True)
    # rows without support on the first and last shards: in their first
    # and last w row blocks and in the middle
    w, ibs, Np = part.w, part.inner_bs, part.block_size
    rows = [0, 7, ibs + 1, Np // 2, Np - ibs - 1, Np - 1]
    for p in (0, part.n_parts - 1):
        c = served_c
        mr_e = _empty_rows(c["masks"][p][1], rows)
        mx, sm = af.stats_ext_call(c["ext"]["a1"][p], c["own"]["a2"][p],
                                   mr_e, w=w, ibs=ibs)
        pmx, psm = af.stats_ext_plain(c["ext"]["a1"][p], c["own"]["a2"][p],
                                      mr_e, w=w, ibs=ibs)
        keep = _other_rows(Np, rows)
        case = f"empty rows {rows} shard {p}/{part.n_parts}"
        check("stats_ext_call", case + " rowmax", mx[:, keep], pmx[:, keep],
              False, rel=BF16_EXT_STATS_REL)
        check("stats_ext_call", case + " rowsum", sm[:, keep], psm[:, keep],
              False, rel=BF16_EXT_STATS_REL)
        _check_empty_rows("stats_ext_call bf16", mx, sm, rows, 2 * w + 1,
                          ibs)
    for bandwidth, wt, Q, F in ((100, 1, 4, 24), (100, 1, 1, 48),
                                (300, 3, 3, 64), (300, 3, 5, 8)):
        S3, _ = make_graph(4096, 0.01, bandwidth, seed=3)
        part3 = par.partition_nodes(S3, SHARD_PARTS, order="none")
        require(part3.is_ring and part3.w == wt,
                f"w={part3.w}, expected {wt}")
        run(f"N=4096 Q={Q} F={F} Np={part3.block_size} w={wt}", part3,
            *par.attention._row_col_masks(part3), Q, F)
    Sh = _attn_holes_case(np.random.default_rng(1))[0]
    parth = par.partition_nodes(Sh, SHARD_PARTS, order="none")
    require(parth.is_ring and parth.w == 2, f"holes: w={parth.w}")
    run(f"holes N=2048 Q=3 F=32 Np={parth.block_size} w=2", parth,
        *par.attention._row_col_masks(parth), 3, 32)

    # every served shard assembled against the global bf16 kernels 7b-9b
    c, P, halo = served_c, part.n_parts, part.halo
    kw = dict(w=w, ibs=ibs)

    def cat(ts):
        return torch.cat(ts, dim=-1)
    st = [af.stats_ext_call(c["ext"]["a1"][p], c["own"]["a2"][p],
                            c["masks"][p][1], **kw) for p in range(P)]
    mxe = halo_ext([s[0] for s in st], halo)
    sme = halo_ext([s[1] for s in st], halo)
    lists = [af.support_lists(c["masks"][p][0]) for p in range(P)]
    ys = [af.apply_ext_call(c["own"]["a1"][p], c["ext"]["a2"][p],
                            c["ext"]["v"][p], mxe[p], sme[p],
                            c["masks"][p][2], c["masks"][p][0], **kw,
                            lists=lists[p]) for p in range(P)]
    bw = [af.bwd_ext_call(c["ext"]["a1"][p], c["own"]["a2"][p],
                          c["own"]["v"][p], *st[p], c["slabs"][p],
                          c["masks"][p][1], c["g_ext"][p], **kw)
          for p in range(P)]
    a1g, a2g, vg = (cat(c["own"][k]) for k in ("a1", "a2", "v"))
    mcg, mrg = (torch.as_tensor(np.concatenate(list(m)), device=dev).to(bf)
                for m in (mc, mr))
    slabg = torch.as_tensor(np.concatenate(list(part.slabs[:, 0])),
                            device=dev).to(bf)
    gmx, gsm = af.stats_call(a1g, a2g, mrg, **kw)
    gy = af.apply_call(a1g, a2g, vg, gmx, gsm, slabg, mcg, **kw,
                       lists=af.support_lists(mcg))
    gda2, gda1p, gdv = af.bwd_call(a1g, a2g, vg, gmx, gsm, slabg, mrg,
                                   c["g"], **kw)
    torch.cuda.synchronize()
    assembled = []
    for what, got, want, exact in (
            ("rowmax", cat([s[0] for s in st]), gmx, True),
            ("rowsum", cat([s[1] for s in st]), gsm, True),
            ("y", cat(ys), gy, True),
            ("da2", cat([b[0] for b in bw]), gda2, True),
            ("dv", cat([b[2] for b in bw]), gdv, True),
            ("da1", cat(halo_fold([af.fold_ext_partials(b[1]) for b in bw],
                                  halo)),
             af.fold_window_partials(gda1p, w), False)):
        row = dict(output=what, bit_equal=bool(torch.equal(got, want)),
                   rel_err=_rel_err(got, want))
        row["ok"] = row["bit_equal"] if exact else (
            row["rel_err"] <= BF16_BWD_REL)
        assembled.append(row)
        require(row["ok"], f"bf16 shards assembled against the global "
                           f"kernels: {row}")

    # timing at the served shape: an interior shard, bf16 and f32 on the
    # same values
    p, Q, F = 1, GAT_BATCH * GAT_HEADS[0], GAT_DIMS[1]
    nbl, W = part.nbl, 2 * w + 1
    n_rows, tile = Np + 2 * halo, nbl * W * ibs * ibs
    sargs = (c["ext"]["a1"][p], c["own"]["a2"][p], c["masks"][p][1])
    aargs = _ext_apply_args(c, p)
    bargs = _ext_bwd_args(c, p)

    def f32(args):
        return tuple(t.float() for t in args)
    lists = af.support_lists(c["masks"][p][0])
    s_row = int(c["masks"][p][1].float().sum().item())
    s_col = int(c["masks"][p][0].float().sum().item())
    # bytes: each input read once, each output written once (bf16 operands
    # 2 bytes, the f32 stats, da2 and da1 partials 4)
    work = {
        "stats_ext_call": (
            2 * (Q * n_rows + Q * Np + tile) + 4 * 2 * Q * Np,
            Q * s_row, 0,
            lambda: af.stats_ext_call(*sargs, **kw),
            lambda: af.stats_ext_call(*f32(sargs), **kw),
            lambda: af.stats_ext_plain(*sargs, **kw)),
        "apply_ext_call": (
            2 * (Q * Np + Q * n_rows + Q * F * (n_rows + Np) + 2 * tile)
            + 4 * 2 * Q * n_rows,
            Q * s_col, 2 * F * Q * s_col,
            lambda: af.apply_ext_call(*aargs, **kw, lists=lists),
            lambda: af.apply_ext_call(*f32(aargs), **kw, lists=lists),
            lambda: af.apply_ext_plain(*aargs, **kw)),
        "bwd_ext_call": (
            2 * (Q * F * (n_rows + 2 * Np) + Q * n_rows + Q * Np + 2 * tile)
            + 4 * (3 * Q * Np + Q * nbl * W * ibs),
            Q * s_row, 4 * F * Q * s_row,
            lambda: af.bwd_ext_call(*bargs, **kw),
            lambda: af.bwd_ext_call(*f32(bargs), **kw),
            lambda: af.bwd_ext_plain(*bargs, **kw)),
    }
    rows = {}
    for name, (nbytes, exps, flops, kern, kern32, plain) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_exp = exps / SFU_EXP_PER_S * 1e3
        t_mma = flops / BF16_FLOPS_PER_S * 1e3
        bound = max(t_bytes, t_exp, t_mma)
        rows[name] = dict(
            shape=(f"Q={Q} F={F} Np={Np} (+2*{halo} halo) w={w} ibs={ibs} "
                   "with_s"),
            ms=time_ms(kern), graph_ms=graph_ms(kern),
            f32_ms=time_ms(kern32), f32_graph_ms=graph_ms(kern32),
            plain_ms=time_ms(plain, reps=5, inner=2), library_ms=None,
            bytes=nbytes, support_scores=exps, bound_ms=bound,
            bound_by="bytes" if bound == t_bytes else "operations",
            bytes_ms=t_bytes, exp_ms=t_exp, products_ms=t_mma)
    rows["apply_ext_call"]["G"] = _apply_group(Q, F, Np, dev)
    emit(phase="shard_bf16_kernels", ulps_allowed=BF16_ULPS,
         ulp_floor_share=BF16_ULP_FLOOR, bwd_rel_allowed=BF16_BWD_REL,
         stats_rel_allowed=BF16_EXT_STATS_REL, checks=checks,
         assembled=assembled, timing=rows,
         library="none: no single PyTorch call computes these functions",
         seconds=time.perf_counter() - t_phase)
    return errs, rows


def phase_shard_bf16_serving(rng, dev, S_sc, spart, db_req):
    """Sharded models served in bf16 (InferenceEngine(dtype=bf16) on the
    ShardedGso's bf16 twin), the main path of kernels 10b-11b and of the
    shifts' bf16 instances on shards: gat_band_n16384 over the (1, 4) and
    (2, 2) meshes (exactly 8 stats_ext_call + 8 apply_ext_call a forward,
    every one bf16, no global flash launch); band_n4096 ring-sharded 4
    ways and over the all-gather (32 band_matmul a forward, bf16);
    scattered_n4096_sharded (32 bcsr_matmul a forward on the rectangular
    slices, bf16). Each answer against the unsharded bf16 engine within
    BF16_SERVE_TOL of max|y| and the f32 sharded engine within
    BF16_VS_F32_TOL; host and device ms of a forward beside f32's (the
    GAT meshes and the ring). Then flock_n262k_db_request's
    LocalGNN_DB served as (x, ShardedEllGso) over mesh (1, 4), f32 and
    bf16, against (x, EllGso): within f32 rounding in f32 (rtol
    SHARD_GRAD_RTOL, atol SHARD_GRAD_ATOL_REL of max), within
    BF16_SERVE_TOL in bf16. Returns the bf16
    launches by kernel, and the sharded GATs ({mesh shape: arch}) and the
    unsharded band GAT it served, for phase_shard_bf16_training."""
    import torch
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.ops.ell import EllGso
    from graph_neural_networks_torch.serving import InferenceEngine
    t_phase = time.perf_counter()
    bf = torch.bfloat16
    checks, profiles, rows, launches = [], [], [], {}

    def vs(label, got, want, tol=BF16_SERVE_TOL):
        for i, (g, w_) in enumerate(zip(got, want)):
            scale = w_.abs().max().item()
            err = (g - w_).abs().max().item()
            ok = bool(torch.isfinite(g).all()) and err <= tol * scale
            checks.append(dict(check=label, request=i, max_abs_err=err,
                               max_abs_ref=scale, share=err / scale,
                               allowed_share=tol,
                               bit_equal=bool(torch.equal(g, w_)), ok=ok))
            require(ok, f"sharded bf16 serving: {label} request {i}: {err} "
                        f"> {tol} * {scale}")

    def serve(label, engs, reqs, per_forward, against, profile=True):
        """The bf16 engine's answers, launches and op calls counted from 0
        just before and read just after; against the unsharded bf16 and
        the f32 sharded answers; both engines profiled unless not
        `profile`."""
        answers, counts, calls = _serve_counted(engs["bf16"], reqs)
        got = {k: v / len(reqs) for k, v in counts.items() if v}
        require(got == per_forward, f"{label}: launches a forward {got}, "
                                    f"expected {per_forward}")
        require(calls and all(k.endswith(":bfloat16") for k in calls),
                f"{label}: a bf16 forward called {calls}")
        for k, n in calls.items():
            name = k.split(":")[0]
            launches[name] = launches.get(name, 0) + n
        want_f = [engs["f32"](x) for x in reqs]
        vs(f"{label} vs unsharded bf16", answers, against)
        vs(f"{label} vs f32 sharded", answers, want_f, BF16_VS_F32_TOL)
        rows.append(dict(model=label, launches_per_forward=got,
                         op_calls=calls))
        for tag in ("f32", "bf16") if profile else ():
            prof = _device_profile(lambda: engs[tag](reqs[0]), 5)
            profiles.append(dict(model=label, dtype=tag,
                                 host_ms=prof["wall_ms"],
                                 device_ms=prof["device_ms"],
                                 device_idle_share=prof["device_idle_share"],
                                 top=prof["top"][:4]))

    def engines(arch, batch):
        return {"f32": InferenceEngine(arch, batch, dev),
                "bf16": InferenceEngine(arch, batch, dev, dtype=bf)}

    # gat_band_n16384 over the two meshes, against the unsharded band
    # model in bf16 (kernels 7b-8b)
    S, _ = make_graph(GAT_N, 0.01, 256, seed=1)
    reqs = [rng.standard_normal((n, GAT_DIMS[0], GAT_N)).astype(np.float32)
            for n in SHARD_REQUESTS]
    gat_ref = _build_gat("GraphAttentionNetwork", S, "band", dev)
    ref = InferenceEngine(gat_ref, GAT_BATCH, dev, dtype=bf)
    want_u = [ref(x) for x in reqs]
    del ref
    gat_archs = {}
    for shape, data_axis in SHARD_MESHES:
        mesh = par.make_mesh(shape, devices=[dev] * SHARD_PARTS)
        arch = _build_gat("GraphAttentionNetwork", S, "dense", dev)
        arch.shard(mesh, shape[1], data_axis=data_axis)
        require(arch.S.band_attention.use_flash,
                f"mesh {shape}: the flash schedule is off")
        engs = engines(arch, GAT_BATCH)
        serve(f"gat_band_n16384 mesh {shape}", engs, reqs,
              {"stats_ext_call": 8, "apply_ext_call": 8}, want_u)
        twin = engs["bf16"]._served.ctx["S"]
        require(twin is arch.S.to(dtype=bf) and twin.dtype == bf
                and arch.S.dtype == torch.float32,
                f"mesh {shape}: the served GSO is not the bf16 twin")
        gat_archs[shape] = arch
        del engs, twin

    # band_n4096 ring and all-gather, scattered_n4096 BCSR: 4 shards
    mesh = par.make_mesh((1, SHARD_PARTS), devices=[dev] * SHARD_PARTS)
    S4 = banded_graph(np.random.default_rng(0), N_GRAPH, 256, 0.05)
    xs = [rng.standard_normal((n, 1, N_GRAPH)).astype(np.float32)
          for n in (BATCH, 17, 1)]

    def allgather():
        arch = _build_model(S4, "band", dev).shard(mesh, SHARD_PARTS)
        arch.ctx = dict(arch.ctx, S=par.ShardedGso(mesh, arch.S.partition,
                                                   prefer_ring=False))
        arch.S = arch.ctx["S"]
        require(not arch.S.uses_ring, "the all-gather case took the ring")
        return arch
    shifts = 2 * (TAPS - 1) * SHARD_PARTS
    band_ref = InferenceEngine(_build_model(S4, "band", dev), BATCH, dev,
                               dtype=bf)
    want_band = [band_ref(x) for x in xs]
    del band_ref
    serve("band_n4096 ring mesh (1, 4)", engines(_build_model(
        S4, "band", dev).shard(mesh, SHARD_PARTS), BATCH), xs,
        {"band_matmul": shifts}, want_band)
    serve("band_n4096_allgather mesh (1, 4)", engines(allgather(), BATCH), xs,
          {"band_matmul": shifts}, want_band, profile=False)
    bcsr_ref = InferenceEngine(_build_model(S_sc, "bcsr", dev), BATCH, dev,
                               dtype=bf)
    serve("scattered_n4096_sharded mesh (1, 4)", engines(
        _bcsr_sharded_model(S_sc, spart, mesh, dev), BATCH), xs,
        {"bcsr_matmul": shifts}, [bcsr_ref(x) for x in xs], profile=False)
    del bcsr_ref

    # flock_n262k_db_request: LocalGNN_DB served as (x, ShardedEllGso)
    net, x, S = db_req
    Ssh = par.shard_ell(S, mesh)
    for tag, dtype in (("f32", None), ("bf16", bf)):
        eng = InferenceEngine(net, DB_REQ["B"], dev, dtype=dtype)
        for n in DB_REQ["requests"]:
            want = eng(x[:n], EllGso(S.idx[:n], S.val[:n]))
            got = eng(x[:n], par.ShardedEllGso(Ssh.idx[:n], Ssh.val[:n],
                                               mesh, n_orig=Ssh.n_orig))
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            row = dict(check=f"flock_n262k (x, ShardedEllGso) {tag} vs "
                             "(x, EllGso)", request=n, max_abs_err=err,
                       max_abs_ref=scale, bit_equal=bool(torch.equal(
                           got, want)))
            # f32: a shard's rows contract in kernels picked for its row
            # count, so within f32 rounding (SHARD_GRAD_RTOL and _ATOL_REL)
            row["ok"] = ok = bool(torch.isfinite(got).all()) and (
                compare(got, want, SHARD_GRAD_RTOL, SHARD_GRAD_ATOL_REL)[2]
                if tag == "f32" else err <= BF16_SERVE_TOL * scale)
            checks.append(row)
            require(ok, f"sharded DB request: {row}")
        del eng
    emit(phase="shard_bf16_serving", models=rows, checks=checks,
         profiles=profiles, tolerance=dict(
             vs_unsharded_bf16=f"{BF16_SERVE_TOL}*max|reference|",
             vs_f32=f"{BF16_VS_F32_TOL}*max|reference|",
             db_vs_ell=(f"f32 rtol {SHARD_GRAD_RTOL}, atol "
                        f"{SHARD_GRAD_ATOL_REL}*max|reference|; bf16 "
                        f"{BF16_SERVE_TOL}*max|reference|")),
         seconds=time.perf_counter() - t_phase)
    return launches, gat_archs, gat_ref


def _bf16_step_grads(arch, data, batch, name, out_dir, **trainer_kw):
    """The first bf16 Trainer step's gradients on the f32 masters (the
    Trainer's first batch of _bf16_vs_f32)."""
    import torch
    model = _model(arch, name, out_dir)
    trainer = model.trainer(model, data, 1, batch, precision="bf16",
                            **trainer_kw)
    trainer.train_batch(np.arange(batch) % data.nTrain)
    torch.cuda.synchronize()
    return [p.grad.detach().double().clone()
            for p in model.archit.parameters()]


def phase_shard_bf16_training(rng, dev, out_dir, gat_archs, gat_ref):
    """Sharded models trained with Trainer(mesh=..., precision='bf16') on
    the bf16 twins, the main path of kernel 12b: gat_band_n16384 over the
    (1, 4) and (2, 2) meshes and band_n4096 ring-sharded 4 ways, 3 steps
    each from the same masters as an f32 sharded run (_bf16_vs_f32): the
    launches of a step equal the f32 sharded step's (8 bwd_ext_call + 8
    stats_ext_call + 8 apply_ext_call; 48 band_matmul), every one bf16;
    the first step's gradients within BF16_TRAIN_GRAD_TOL of each leaf's
    max|g| of the unsharded bf16 step on the kernels (7b-9b; 2b-3b); the
    losses within BF16_TRAIN_LOSS of f32's; host and device ms of a step
    beside f32's. gat_archs, gat_ref: shard_bf16_serving's sharded GATs
    and the unsharded band GAT (their masters as built). Returns the bf16
    launches by kernel."""
    import torch
    from graph_neural_networks_torch import parallel as par
    t_phase = time.perf_counter()
    rows, launches = [], {}

    def add(calls):
        for k, n in calls.items():
            name = k.split(":")[0]
            launches[name] = launches.get(name, 0) + n

    def model_fn(a, name):
        return _model(a, name, out_dir)
    data = _synthetic_data(rng, (BF16_TRAIN_STEPS * GAT_BATCH, GAT_BATCH,
                                 GAT_BATCH), GAT_DIMS[0], GAT_N, 4)
    ref = _bf16_step_grads(gat_ref, data, GAT_BATCH, "gat_ref", out_dir)
    for shape, data_axis in SHARD_MESHES:
        arch = gat_archs.pop(shape)
        mesh = arch.S.mesh
        kw = dict(mesh=mesh, **(dict(meshAxis="data") if data_axis else {}))
        row, calls = _bf16_vs_f32(
            f"gat_band_n16384 mesh {shape}", (arch, _twin(arch)), data,
            GAT_BATCH, model_fn, BF16_TRAIN_STEPS,
            dict(stats_ext_call=8, apply_ext_call=8, bwd_ext_call=8),
            _step_profile_fn(GAT_BATCH),
            ref=("unsharded bf16 step (kernels 7b-9b)", ref), **kw)
        rows.append(row)
        add(calls)
        del arch
        torch.cuda.empty_cache()
    S4 = banded_graph(np.random.default_rng(0), N_GRAPH, 256, 0.05)
    data = _synthetic_data(rng, (BF16_TRAIN_STEPS * BATCH, BATCH, BATCH), 1,
                           N_GRAPH, 5)
    ref = _bf16_step_grads(_build_model(S4, "band", dev), data, BATCH,
                           "band_ref", out_dir)
    mesh = par.make_mesh((1, SHARD_PARTS), devices=[dev] * SHARD_PARTS)
    arch = _build_model(S4, "band", dev).shard(mesh, SHARD_PARTS)
    shifts = 2 * (TAPS - 1) * SHARD_PARTS
    row, calls = _bf16_vs_f32(
        "band_n4096 ring mesh (1, 4)", (arch, _twin(arch)), data, BATCH,
        model_fn, BF16_TRAIN_STEPS, dict(band_matmul=shifts + shifts // 2),
        _step_profile_fn(BATCH),
        ref=("unsharded bf16 step (kernels 2b-3b)", ref), mesh=mesh)
    rows.append(row)
    add(calls)
    emit(phase="shard_bf16_training", grad_share_allowed=BF16_TRAIN_GRAD_TOL,
         loss_tolerance=BF16_TRAIN_LOSS, checks=rows,
         seconds=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# Item 2.2: bf16 of the GRNNs, MultiNodeAggregationGNN and the edge-list GSO;
# item 9: the native graph-structure library
# ---------------------------------------------------------------------------

# grnn_band_n4096_bf16: the GRNN served in bf16 (band, bcsr, sharded over
# mesh (1, 4)) against bf16 dense within BF16_SERVE_TOL and against its f32
# engine within BF16_VS_F32_TOL (bf16 rounding alone moves a full-width
# GRNN's answer 0.6-1.6% of max|y| from f32: the recurrence feeds each
# step's rounding to the next); gat_edge_n16384_bf16 and
# grnn_edge_n4096_bf16 served (and the GAT trained EDGE_BF16_STEPS steps)
# in bf16 beside f32; multinode_bf16 at static_families' size.
EDGE_BF16_STEPS = 3
MULTI_REQUESTS = (4, 3, 1)


def phase_grnn_bf16_kernels(graph, dev):
    """Kernels 1b-3b at the bf16 GRNN's shapes against their bf16 plain
    versions, with phase_bf16_kernels' ulp bounds: the register (2b) at R =
    800 (the inputs' B*T*F rows) and 1200 (a recurrence step's B*H), K =
    5, tap k within k + 1 ulps; band_matmul (3b) at R = 9600 (the output
    filter's B*T*H) and on a shard's own block (n_cols = 1024, w = 1) at R
    = 800, 1200 and 9600; bcsr_matmul (1b) at R = 800, 1200 and 9600;
    within BF16_ULPS. Each timed by CUDA events and graph_ms beside its f32
    instance, its plain version, x_bf16 @ S_bf16 and its bound."""
    import torch
    from graph_neural_networks_torch.ops import gso as gso_lib
    from graph_neural_networks_torch.ops import spmm
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(41)
    N, bs, K = N_GRAPH, 128, GRNN_K
    g32, c32 = graph["band"], graph["bcsr"]
    gb, gc = g32.to(dtype=bf), c32.to(dtype=bf)
    w = gb.band_w
    sb, sb32, Sd = gb.s_band[0], g32.s_band[0], gb.S[0]
    bl, bl32 = gc.blocks[0], c32.blocks[0]
    br, bc, cs = gc.block_row, gc.block_col, gc.col_start
    nnzb, win = bl.shape[0], _window_blocks(N // bs, w)
    Ns = N // SHARD_PARTS
    gs32 = gso_lib.as_gso(_band_case(np.random.default_rng(2), Ns, bs, 1),
                          "band", device=dev)
    gs = gs32.to(dtype=bf)
    wins = _window_blocks(Ns // bs, 1)
    r_x, r_z = GRNN_BATCH * GRNN_T, GRNN_BATCH * GRNN_H
    r_o = r_x * GRNN_H
    checks, errs, rows = [], {k: 0.0 for k in BF16_KERNELS[:3]}, {}

    def check(name, shape, got, want, ulps, **kw):
        torch.cuda.synchronize()
        require(got.dtype == want.dtype == bf, f"{name} {shape}: {got.dtype}")
        err = (got.double() - want.double()).abs().max().item()
        errs[name] = max(errs[name], err)
        got_ulps = _ulps_of(got, want, **kw)
        checks.append(dict(kernel=name, shape=shape, max_abs_err=err,
                           max_ulps=got_ulps, allowed_ulps=ulps,
                           ok=got_ulps <= ulps))
        require(got_ulps <= ulps, f"bf16 {name} {shape} disagrees with its "
                                  f"plain version: {checks[-1]}")

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(bf)

    def row(key, shape, fn, fn32, plain, library, nbytes, flops):
        r = dict(shape=shape, ms=time_ms(fn), graph_ms=graph_ms(fn),
                 f32_ms=time_ms(fn32), f32_graph_ms=graph_ms(fn32),
                 plain_ms=time_ms(plain, reps=5, inner=2),
                 library_ms=time_ms(library, reps=5, inner=2),
                 library_call="torch.matmul(x_bf16, S_dense_bf16)"
                 if "register" not in key else
                 f"{K - 1} chained torch.matmul(z_bf16, S_dense_bf16)",
                 bytes=nbytes, flops=flops)
        r["bound_ms"], r["bound_by"] = _bf16_bound(nbytes, flops)
        rows[key] = r

    for R in (r_x, r_z):
        x = randn(R, N)
        got = spmm.band_shift_register(x, sb, n_taps=K, n_cols=N, w=w)
        want = spmm.band_shift_register_plain(x, sb, n_taps=K, n_cols=N,
                                              w=w)
        require(torch.equal(got[0], x), "bf16 register: tap 0 is not x")
        for k in range(1, K):
            check("band_shift_register", f"R={R} N={N} w={w} K={K} tap {k}",
                  got[k], want[k], k + 1, scale=want[k].abs().max().item())
        x32 = x.float()
        out = torch.empty(K, R, N, device=dev, dtype=bf)

        def chained(x=x, out=out):
            out[0].copy_(x)
            for k in range(1, K):
                torch.matmul(out[k - 1], Sd, out=out[k])
        row(f"band_shift_register@R={R}", f"R={R} N={N} w={w} K={K}",
            lambda x=x: spmm.band_shift_register(x, sb, n_taps=K, n_cols=N,
                                                 w=w),
            lambda x=x32: spmm.band_shift_register(x, sb32, n_taps=K,
                                                   n_cols=N, w=w),
            lambda x=x: spmm.band_shift_register_plain(x, sb, n_taps=K,
                                                       n_cols=N, w=w),
            chained, 2 * ((1 + K) * R * N + win * bs * bs),
            (K - 1) * 2 * R * win * bs * bs)
    for R, n, slab, slab32, Sl, ww, nwin, tag in (
            (r_o, N, sb, sb32, Sd, w, win, ""),
            (r_x, Ns, gs.s_band[0], gs32.s_band[0], gs.S[0], 1, wins,
             f" n_cols={Ns}"),
            (r_z, Ns, gs.s_band[0], gs32.s_band[0], gs.S[0], 1, wins,
             f" n_cols={Ns}"),
            (r_o, Ns, gs.s_band[0], gs32.s_band[0], gs.S[0], 1, wins,
             f" n_cols={Ns}")):
        x = randn(R, n)
        check("band_matmul", f"R={R} N={n} w={ww}",
              spmm.band_matmul(x, slab, n_cols=n, w=ww),
              spmm.band_matmul_plain(x, slab, n_cols=n, w=ww), BF16_ULPS)
        row(f"band_matmul@R={R}{tag}", f"R={R} N={n} w={ww}",
            lambda x=x, s=slab, n=n, ww=ww: spmm.band_matmul(
                x, s, n_cols=n, w=ww),
            lambda x=x.float(), s=slab32, n=n, ww=ww: spmm.band_matmul(
                x, s, n_cols=n, w=ww),
            lambda x=x, s=slab, n=n, ww=ww: spmm.band_matmul_plain(
                x, s, n_cols=n, w=ww),
            lambda x=x, S=Sl: torch.matmul(x, S),
            2 * (2 * R * n + nwin * bs * bs), 2 * R * nwin * bs * bs)
    for R in (r_x, r_z, r_o):
        x = randn(R, N)
        check("bcsr_matmul", f"R={R} N={N} nnzb={nnzb}",
              spmm.bcsr_matmul(x, bl, br, bc, n_cols=N, col_start=cs),
              spmm.bcsr_matmul_plain(x, bl, br, bc, n_cols=N), BF16_ULPS)
        row(f"bcsr_matmul@R={R}", f"R={R} N={N} nnzb={nnzb}",
            lambda x=x: spmm.bcsr_matmul(x, bl, br, bc, n_cols=N,
                                         col_start=cs),
            lambda x=x.float(): spmm.bcsr_matmul(x, bl32, br, bc, n_cols=N,
                                                 col_start=cs),
            lambda x=x: spmm.bcsr_matmul_plain(x, bl, br, bc, n_cols=N),
            lambda x=x: torch.matmul(x, Sd),
            2 * (2 * R * N + bl.numel()) + 4 * nnzb, 2 * R * nnzb * bs * bs)
    emit(phase="grnn_bf16_kernels", ulp_floor_share=BF16_ULP_FLOOR,
         checks=checks)
    emit(phase="grnn_bf16_timing", peaks=dict(
        hbm_tb_s=HBM_BYTES_PER_S / 1e12,
        bf16_dense_tflops=BF16_FLOPS_PER_S / 1e12), rows=rows)
    return errs, rows


def _vs(checks, label, got, want, tol):
    """Each answer finite and within `tol` of the largest |want|."""
    for i, (g, wnt) in enumerate(zip(got, want)):
        share = (g - wnt).abs().max().item() / wnt.abs().max().item()
        ok = bool(g.isfinite().all()) and share <= tol
        checks.append(dict(check=label, request=i, share=share,
                           allowed_share=tol, ok=ok))
        require(ok, f"{label} request {i}: {share} of max|y| > {tol}")


def _serve_pair(label, arch, batch, requests, dev, expected, profile):
    """`arch` served by its f32 and its bf16 engine: the answers, the
    launches of each (counts from 0 just before, read just after; both
    equal to `expected` a request), every op call of the bf16 engine a
    bf16 one and of the f32 engine an f32 one; host ms a forward; with
    `profile`, each engine's forward profiled. Returns the answers by
    dtype tag, the bf16 op calls and the row."""
    import torch
    from graph_neural_networks_torch.serving import InferenceEngine
    out, row = {}, dict(model=label, batch=batch,
                        requests=[int(r.shape[0]) for r in requests])
    for tag, dt in (("f32", None), ("bf16", torch.bfloat16)):
        eng = InferenceEngine(arch, batch, dev, dtype=dt)
        eng(requests[0])                       # the first request's set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _reset_all_counts()
        answers, counts, calls = _serve_counted(eng, requests)
        row[f"host_ms_per_request_{tag}"] = \
            (time.perf_counter() - t0) * 1e3 / len(requests)
        want = {k: v * len(requests) for k, v in expected.items()}
        got = {k: v for k, v in dict(counts, **_flock_counts()).items()
               if v}
        require(got == {k: v for k, v in want.items() if v},
                f"{label} {tag}: launches {got}, expected {want}")
        suffix = ":bfloat16" if tag == "bf16" else ":float32"
        require(all(k.endswith(suffix) for k in calls),
                f"{label} {tag}: op calls {calls}")
        out[tag] = answers
        row[f"op_calls_{tag}"] = calls
        if profile:
            prof = _device_profile(lambda: eng(requests[0]), 5)
            row[f"profile_{tag}"] = dict(
                host_ms=prof["wall_ms"], device_ms=prof["device_ms"],
                device_idle_share=prof["device_idle_share"],
                top=prof["top"][:5])
        del eng
    row["launches_per_forward"] = {k: v for k, v in expected.items() if v}
    return out, row["op_calls_bf16"], row


def phase_grnn_bf16_serving(S_np, rng, dev, profile=False):
    """grnn_band_n4096 (ungated, time and node gates) served in bf16 in
    band and bcsr mode and, ungated and node-gated, .shard()ed over mesh
    (1, 4) (the ShardedGso's bf16 twin), beside its f32 engine: requests
    of GRNN_REQUESTS rows, z0 drawn by both engines alike (rounded to bf16
    in the bf16 one); every launch a bf16 instance, exactly as many as the
    f32 engine's (_grnn_launches); against the bf16 dense engine within
    BF16_SERVE_TOL (sharded: BF16_VS_F32_TOL) and against the f32 engine
    within BF16_VS_F32_TOL of max|y|, each distance printed. Returns the
    bf16 launches."""
    import torch
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.serving import InferenceEngine
    t_phase = time.perf_counter()
    B, N = GRNN_BATCH, N_GRAPH
    requests = [rng.integers(0, 3, (n, GRNN_T, 1, N)).astype(np.float32)
                for n in GRNN_REQUESTS]
    mesh = par.make_mesh((1, SHARD_PARTS), devices=[dev] * SHARD_PARTS)
    checks, rows, launches = [], [], {k: 0 for k in BF16_KERNELS[:3]}
    for gate in GRNN_GATES:
        name = _gate_name(gate)
        dense = InferenceEngine(_grnn(S_np, "dense", dev, gate), B, dev,
                                dtype=torch.bfloat16)
        dense16 = [dense(r) for r in requests]
        del dense
        modes = ("band", "bcsr") + (
            ("sharded",) if gate in GRNN_SHARD_GATES else ())
        for mode in modes:
            label = f"grnn_band_n4096 {name} {mode}"
            arch = _grnn(S_np, "band" if mode == "sharded" else mode, dev,
                         gate)
            shards = 0
            if mode == "sharded":
                arch.shard(mesh, SHARD_PARTS)
                shards = SHARD_PARTS
                require(arch.S.uses_ring, f"{label}: not the ring shift")
            fwd = _grnn_launches("band" if shards else mode, gate, False,
                                 shards=shards)
            out, calls, row = _serve_pair(label, arch, B, requests, dev, fwd,
                                          profile)
            for k, n in calls.items():
                launches[k.split(":")[0]] += n
            # the sharded ring shift rounds its band product and its halo
            # corrections apiece, which the recurrence carries:
            # 1.4% of max|y| from bf16 dense in the CPU rehearsal (N =
            # 1024), so it is held as bf16 is to f32
            _vs(checks, f"{label} bf16 vs dense bf16", out["bf16"], dense16,
                BF16_VS_F32_TOL if shards else BF16_SERVE_TOL)
            _vs(checks, f"{label} bf16 vs f32", out["bf16"], out["f32"],
                BF16_VS_F32_TOL)
            row["per_step_share_vs_f32"] = [
                e / out["f32"][0].abs().max().item()
                for e in _per_step_err(out["bf16"][0], out["f32"][0])]
            rows.append(row)
            emit(phase="grnn_bf16_serving", **row)
            del arch
            torch.cuda.empty_cache()
    emit(phase="grnn_bf16_serving_check", checks=checks,
         seconds=time.perf_counter() - t_phase)
    return launches


def phase_edge_bf16(S_np, rng, dev, out_dir, profile=False):
    """Edge mode in bf16 (the EdgeList's s_val cast, no kernel of the
    library anywhere): gat_edge_n16384 served in bf16 beside f32
    (GAT_REQUESTS) and trained EDGE_BF16_STEPS steps in bf16 beside f32
    from the same masters (losses within BF16_TRAIN_LOSS, first-step
    gradient shares printed); grnn_edge_n4096 (ungated, time and node
    gates) served in bf16 beside f32. Answers within BF16_VS_F32_TOL of
    max|y| of f32's; with `profile`, forwards and steps profiled."""
    import torch
    from graph_neural_networks_torch.ops import attention_sparse as asp
    t_phase = time.perf_counter()
    checks = []
    S, _ = make_graph(GAT_N, 0.01, 256, seed=1)
    gat = _build_gat("GraphAttentionNetwork", S, "edge", dev)
    require(isinstance(gat.S, asp.EdgeList), "gat_edge_n16384: no EdgeList")
    requests = [rng.standard_normal((n, GAT_DIMS[0], GAT_N)).astype(
        np.float32) for n in GAT_REQUESTS]
    out, _, row = _serve_pair("gat_edge_n16384", gat, GAT_BATCH, requests,
                              dev, {}, profile)
    _vs(checks, "gat_edge_n16384 bf16 vs f32", out["bf16"], out["f32"],
        BF16_VS_F32_TOL)
    emit(phase="edge_bf16_serving", **row)
    del out
    data = _synthetic_data(rng, (EDGE_BF16_STEPS * GAT_BATCH, GAT_BATCH,
                                 GAT_BATCH), GAT_DIMS[0], GAT_N, 4)
    _reset_all_counts()
    train_row, _ = _bf16_vs_f32(
        "gat_edge_n16384", (gat, _twin(gat)), data, GAT_BATCH,
        lambda a, name: _model(a, name, out_dir), EDGE_BF16_STEPS,
        profile=_step_profile_fn(GAT_BATCH) if profile else None)
    _no_kernel("gat_edge_n16384 bf16 training")
    require(gat.ctx_for_dtype(torch.bfloat16)["S"].s_val.dtype
            == torch.bfloat16, "gat_edge_n16384: the bf16 context")
    emit(phase="edge_bf16_training", **train_row)
    del gat, data
    torch.cuda.empty_cache()
    requests = [rng.integers(0, 3, (n, GRNN_T, 1, N_GRAPH)).astype(
        np.float32) for n in GRNN_REQUESTS]
    for gate in GRNN_GATES:
        label = f"grnn_edge_n4096 {_gate_name(gate)}"
        arch = _grnn(S_np, "edge", dev, gate)
        out, _, row = _serve_pair(label, arch, GRNN_BATCH, requests, dev, {},
                                  profile and gate is None)
        _vs(checks, f"{label} bf16 vs f32", out["bf16"], out["f32"],
            BF16_VS_F32_TOL)
        emit(phase="edge_bf16_serving", **row)
        del arch, out
        torch.cuda.empty_cache()
    emit(phase="edge_bf16_check", checks=checks,
         loss_tolerance=BF16_TRAIN_LOSS,
         seconds=time.perf_counter() - t_phase)


def phase_multinode_bf16(rng, dev):
    """MultiNodeAggregationGNN at static_families' size (N = STATIC_N)
    served in bf16 beside f32: f32 arithmetic on the bf16-rounded request
    and parameters, as JAX's bf16 engine computes it; within
    BF16_SERVE_TOL of the f32 engine; its bf16 argument bytes."""
    import torch
    from graph_neural_networks_torch.serving import InferenceEngine
    N = STATIC_N
    S = banded_graph(np.random.default_rng(20), N, 32, 0.2)
    build = dict((name, b) for name, b, _, _ in _static_models(S, N))[
        "MultiNodeAggregationGNN"]
    arch = build(dev)
    requests = [rng.standard_normal((n, 2, N)).astype(np.float32)
                for n in MULTI_REQUESTS]
    batch = MULTI_REQUESTS[0]
    out, _, row = _serve_pair("multinode_bf16", arch, batch, requests, dev,
                              {}, False)
    checks = []
    _vs(checks, "multinode_bf16 bf16 vs f32", out["bf16"], out["f32"],
        BF16_SERVE_TOL)
    eng = InferenceEngine(arch, batch, dev, dtype=torch.bfloat16,
                          example_args=(requests[0],))
    n_params = sum(p.numel() for p in arch.parameters())
    mem = eng.memory_analysis()
    require(mem.argument_size_in_bytes == 2 * (requests[0].size + n_params),
            f"multinode_bf16: argument bytes {mem.argument_size_in_bytes}")
    emit(phase="multinode_bf16", N=N, params=n_params,
         argument_bytes=mem.argument_size_in_bytes,
         temp_bytes=mem.temp_size_in_bytes, checks=checks, **row)


@contextlib.contextmanager
def _numpy_host():
    """The layouts, neighborhoods and Graclus matching on their numpy plain
    versions (GNT_NO_NATIVE) within the block."""
    before = os.environ.get("GNT_NO_NATIVE")
    os.environ["GNT_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        if before is None:
            del os.environ["GNT_NO_NATIVE"]
        else:
            os.environ["GNT_NO_NATIVE"] = before


def _bit_equal(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_bit_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    if hasattr(a, "toarray"):
        return _bit_equal(a.toarray(), b.toarray())
    return a == b


def phase_native(S_np):
    """The native graph-structure library built on this host from the
    port's own copy of the source (utils/native.py; phase_build built it),
    never the JAX package's; held bit-equal to the numpy plain versions: the band and
    BCSR layouts of band_n4096's graph (N = 4096) and gat_band_n16384's (N
    = 16384), the K-hop neighborhoods (K = 1-3, lists and tables) and the
    Graclus coarsening of the left-outs' SBM (N = LEFT_N); host seconds of
    each, native beside numpy."""
    import scipy.sparse
    from graph_neural_networks_torch.ops import spmm
    from graph_neural_networks_torch.utils import graph as gt
    from graph_neural_networks_torch.utils import native
    t_phase = time.perf_counter()
    path, _ = native.build()
    require(path.startswith(os.path.join(HERE, "graph_neural_networks_torch",
                                         "kernels", "build")),
            f"native library at {path}")
    require(native.library()._name == path, "another native library loaded")
    rows = []

    def both(label, fn):
        t0 = time.perf_counter()
        got = fn()
        native_s = time.perf_counter() - t0
        with _numpy_host():
            t0 = time.perf_counter()
            want = fn()
            numpy_s = time.perf_counter() - t0
        ok = _bit_equal(got, want)
        rows.append(dict(what=label, native_s=native_s, numpy_s=numpy_s,
                         bit_equal=ok))
        require(ok, f"native {label} differs from its numpy version")
        return got

    S_gat, _ = make_graph(GAT_N, 0.01, 256, seed=1)
    for name, S in (("band_n4096", S_np), ("gat_band_n16384", S_gat)):
        _, w = both(f"{name} dense_to_band",
                    lambda S=S: spmm.dense_to_band(S, 128))
        both(f"{name} dense_to_band_at w={w + 1}",
             lambda S=S: spmm.dense_to_band_at(S, 128, w + 1))
        both(f"{name} dense_to_bcsr", lambda S=S: spmm.dense_to_bcsr(S, 128))
    del S_gat
    W = gt.Graph("SBM", LEFT_N, {"nCommunities": 5, "probIntra": 0.8,
                                 "probInter": 0.2},
                 rng=np.random.default_rng(0)).W
    for K in (1, 2, 3):
        for kind in ("list", "matrix"):
            both(f"left_outs SBM compute_neighborhood K={K} {kind}",
                 lambda K=K, kind=kind: gt.compute_neighborhood(
                     W, K, output_type=kind))
    both("left_outs SBM coarsen levels=2", lambda: gt.coarsen(
        scipy.sparse.csr_matrix(W), 2, rng=np.random.default_rng(1)))
    emit(phase="native", library=os.path.relpath(path, HERE), rows=rows,
         seconds=time.perf_counter() - t_phase)


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
        local_profile = timed("flock_profile", phase_flock_profile, setup,
                              card)
        del setup
        # the time-varying recurrent and aggregation controllers on the
        # grid: the unfused (GRNN) and fused (AggGNN) steps at 262,144
        db_errs, db_rows = timed("db_kernels", phase_db_kernels, dev)
        for k, v in db_errs.items():
            errs[k] = max(errs[k], v)
        rows.update(db_rows)
        db_serve_launches, db_setups, db_serving_rows = timed(
            "db_serving", phase_db_serving, dev, card)
        timed("db_profile", phase_db_profile, db_setups, db_serving_rows,
              local_profile, card)
        del db_setups
        torch.cuda.empty_cache()
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
            store = trained[1]
            del trained
            torch.cuda.empty_cache()
            db_train_launches = timed("db_training", phase_db_training,
                                      store, dev, card, out_dir)
            timed("bf16_flock_training", phase_bf16_flock_training, store,
                  dev, card, out_dir)
            del store
        for k in ("grid_window", "table_build"):
            launches[k] += (flock_train_launches[k] + db_serve_launches[k]
                            + db_train_launches[k])
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            _, ref_data = timed("flock_ref_training",
                                phase_flock_ref_training, dev, card, out_dir)
            timed("db_ref_training", phase_db_ref_training, ref_data, dev,
                  card, out_dir)
            del ref_data
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
            timed("grnn_train_profile", phase_train_profile, trained, 2,
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
        # edge mode (the edge-list GSO) and the architecture left-outs
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            edge_launches = [
                timed("gat_edge", phase_gat_edge, np.random.default_rng(27),
                      dev, out_dir),
                timed("grnn_edge", phase_grnn_edge, S_np,
                      np.random.default_rng(28), dev, out_dir)]
            timed("left_outs", phase_left_outs, np.random.default_rng(29),
                  dev, out_dir)
        for part_launches in edge_launches:
            for k, v in part_launches.items():
                if v:
                    launches[k] += v
        # the chunked all-pairs env, the windowed re-forward, the segmented
        # rollouts and the host loop; kernels 5-6 as the grid references
        torch.cuda.empty_cache()
        chunk_launches, chunk_net = timed("chunked_serving",
                                          phase_chunked_serving, dev, card)
        big_launches = timed("chunked_big", phase_chunked_big, chunk_net,
                             dev, card)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            ctrain_launches = timed("chunked_training",
                                    phase_chunked_training, dev, card,
                                    out_dir)
        timed("chunked_sharded", phase_chunked_sharded, chunk_net, dev, card)
        timed("chunked_host_loop", phase_chunked_host_loop, dev, card)
        for part_launches in (chunk_launches, big_launches, ctrain_launches):
            for k in ("grid_window", "table_build"):
                launches[k] += part_launches[k]
        # the tasks: TrainerSingleNode on movielens_n1186 in bcsr mode
        # (kernel 1) and the seven task drivers (dense, no kernel)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            ml_errs, ml_rows, ml_launches = timed(
                "single_node", phase_single_node, dev, out_dir)
            timed("task_drivers", phase_task_drivers, dev, out_dir)
        errs["bcsr_matmul"] = max(errs["bcsr_matmul"],
                                  ml_errs["bcsr_matmul"])
        launches["bcsr_matmul"] += ml_launches["bcsr_matmul"]
        # item 2: bf16 serving on the bf16 instances of kernels 1-3 and
        # 7-8, (x, S) requests, export and reload, introspection
        torch.cuda.empty_cache()
        bf16_errs, bf16_rows = timed("bf16_kernels", phase_bf16_kernels,
                                     graph, S_np, gso, dev)
        bf16_launches, served = timed("bf16_serving", phase_bf16_serving,
                                      S_np, eng.arch,
                                      np.random.default_rng(32), dev)
        db_engine, _, db_req = timed("multi_arg_serving",
                                     phase_multi_arg_serving, dev, card)
        served["flock_n262k LocalGNN_DB (x, EllGso) f32"] = db_engine
        timed("export", phase_export, S_np, eng.arch,
              np.random.default_rng(33), dev)
        timed("introspection", phase_introspection, served)
        del served, db_engine
        # item 1: bf16 mixed-precision training on kernel 9b and the bf16
        # instances of kernels 1-3 and 7-8
        torch.cuda.empty_cache()
        bwd16_errs, bwd16_rows = timed(
            "bf16_train_kernels", phase_bf16_train_kernels, gso, dev)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            bf16_train_launches = timed(
                "bf16_training", phase_bf16_training, eng.arch, S_np,
                np.random.default_rng(37), dev, out_dir)
        for k in BF16_KERNELS:
            bf16_launches[k] += bf16_train_launches.get(k, 0)
        bf16_launches["bwd_call"] = bf16_train_launches.get("bwd_call", 0)
        # item 2.1: sharded models in bf16, served and trained, on kernels
        # 10b-12b and the shifts' bf16 instances on shards
        torch.cuda.empty_cache()
        ext16_errs, ext16_rows = timed("shard_bf16_kernels",
                                       phase_shard_bf16_kernels, part, mc,
                                       mr, dev)
        ext16_launches, gat_archs, gat_ref = timed(
            "shard_bf16_serving", phase_shard_bf16_serving,
            np.random.default_rng(39), dev, S_sc, spart, db_req)
        del db_req
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            for k, n in timed("shard_bf16_training",
                              phase_shard_bf16_training,
                              np.random.default_rng(40), dev, out_dir,
                              gat_archs, gat_ref).items():
                ext16_launches[k] = ext16_launches.get(k, 0) + n
        del gat_archs, gat_ref
        for k in ("band_matmul", "bcsr_matmul"):
            bf16_launches[k] += ext16_launches.get(k, 0)
        for k in SHARD_BF16_KERNELS:
            bf16_launches[k] = ext16_launches.get(k, 0)
        # item 2.2: the GRNNs (kernels 1b-3b at their shapes), edge mode and
        # MultiNodeAggregationGNN in bf16; item 9: the native library
        torch.cuda.empty_cache()
        g16_errs, g16_rows = timed("grnn_bf16_kernels",
                                   phase_grnn_bf16_kernels, graph, dev)
        for k, v in g16_errs.items():
            bf16_errs[k] = max(bf16_errs[k], v)
        for k, n in timed("grnn_bf16_serving", phase_grnn_bf16_serving, S_np,
                          np.random.default_rng(41), dev).items():
            bf16_launches[k] += n
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            timed("edge_bf16", phase_edge_bf16, S_np,
                  np.random.default_rng(42), dev, out_dir)
        timed("multinode_bf16", phase_multinode_bf16,
              np.random.default_rng(43), dev)
        timed("native", phase_native, S_np)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    for name, n in list(launches.items()) + [
            (f"{k}_bf16", v) for k, v in bf16_launches.items()]:
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
        if name == "bcsr_matmul":
            # the single-node path's shapes (movielens_n1186)
            summary[-1]["other_shapes"] = [
                {k: r[k] for k in ("shape", "ms", "graph_ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
                for k_, r in ml_rows.items()]
    # the bf16-io instances of kernels 1-3 and 7-8 (bf16_serving's launches)
    bf16_keys = dict(bcsr_matmul="bcsr_matmul@R=2048",
                     band_matmul="band_matmul@R=2048",
                     band_shift_register=f"band_shift_register@R={BATCH}")
    for name in BF16_KERNELS:
        row = bf16_rows[bf16_keys.get(name, name)]
        summary.append(dict(
            name=f"{name}_bf16", route="cuda",
            source="graph_neural_networks_torch/kernels/csrc/"
                   f"{sources.get(name, 'spmm.cu')}",
            replaces=REPLACES[name], launches=bf16_launches[name],
            max_abs_err=bf16_errs[name], ms=row["ms"], kernel_ms=row["ms"],
            graph_ms=row["graph_ms"], f32_ms=row["f32_ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["shape"]))
        if name in g16_errs:
            # the bf16 GRNN's shapes (grnn_bf16_kernels)
            summary[-1]["grnn_shapes"] = [
                {k: r[k] for k in ("shape", "ms", "graph_ms", "f32_ms",
                                   "f32_graph_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")}
                for key, r in g16_rows.items() if key.startswith(name + "@")]
    # kernel 9b: bf16_training's launches (bf16 training of
    # gat_band_n16384)
    row = bwd16_rows["bwd_call"]
    summary.append(dict(
        name="bwd_call_bf16", route="cuda",
        source="graph_neural_networks_torch/kernels/csrc/attention_flash.cu",
        replaces=REPLACES["bwd_call"], launches=bf16_launches["bwd_call"],
        max_abs_err=bwd16_errs["bwd_call"], ms=row["ms"], kernel_ms=row["ms"],
        graph_ms=row["graph_ms"], f32_ms=row["f32_ms"],
        f32_graph_ms=row["f32_graph_ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"],
        library_ms=row["library_ms"], shape=row["shape"]))
    # kernels 10b-12b: the sharded bf16 serving and training launches
    for name in SHARD_BF16_KERNELS:
        row = ext16_rows[name]
        summary.append(dict(
            name=f"{name}_bf16", route="cuda",
            source="graph_neural_networks_torch/kernels/csrc/"
                   "attention_flash.cu",
            replaces=REPLACES[name], launches=bf16_launches[name],
            max_abs_err=ext16_errs[name], ms=row["ms"], kernel_ms=row["ms"],
            graph_ms=row["graph_ms"], f32_ms=row["f32_ms"],
            f32_graph_ms=row["f32_graph_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=row["shape"]))
    print(card, flush=True)
    emit(kernels=summary)
    emit(ok=True, device=dict(platform="gpu",
                              kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
