#!/usr/bin/env python3
"""chip_smoke.py's bf16 phases alone, on one CUDA card.

    python3 experiments/torch_bf16_phases.py [--sharded] [--grnn-edge]

Runs phase_device and phase_build, then phase_bf16_serving (band_n4096 in
band, bcsr and dense mode and gat_band_n16384 served in bf16 beside f32,
each forward profiled), phase_bf16_kernels, phase_bf16_train_kernels
(kernel 9b) and phase_bf16_training (band_n4096 band and bcsr,
gat_band_n16384 and movielens_n1186 trained in bf16 beside f32, each
step profiled), early in a process: in the full chip_smoke.py they run
last, where torch.profiler keeps only part of the kernel events.
gat_band_n16384 is the untrained band model (its band structure built by
one f32 request); its weights do not change the times. With --sharded,
then the sharded bf16 phases (phase_multi_arg_serving for the
flock_n262k_db_request request, phase_shard_bf16_kernels,
phase_shard_bf16_serving and phase_shard_bf16_training: gat_band_n16384
over the (1, 4) and (2, 2) meshes, band_n4096 ring-sharded and
scattered_n4096_sharded, each forward and step profiled beside f32).
With --grnn-edge, last: phase_grnn_bf16_serving (grnn_band_n4096's GRNNs
in band and bcsr mode and sharded, bf16 beside f32) and phase_edge_bf16
(gat_edge_n16384 served and trained, grnn_edge_n4096 served, bf16 beside
f32), each forward and step profiled.
Prints chip_smoke.py's JSON lines.
"""

import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from graph_neural_networks_torch import parallel as par  # noqa: E402
from graph_neural_networks_torch.ops import gso as gso_lib  # noqa: E402
from graph_neural_networks_torch.serving import InferenceEngine  # noqa: E402
from graph_neural_networks_torch.utils.device import resolve_device  # noqa: E402


def main() -> int:
    dev = resolve_device("cuda")
    card = cs.phase_device()
    cs.timed("build", cs.phase_build)
    S_np = cs.banded_graph(np.random.default_rng(0), cs.N_GRAPH, 256, 0.05)
    graph = {m: gso_lib.as_gso(S_np, m, device=dev) for m in ("band", "bcsr")}
    S, _ = cs.make_graph(cs.GAT_N, 0.01, 256, seed=1)
    arch = cs._build_gat("GraphAttentionNetwork", S, "band", dev)
    InferenceEngine(arch, cs.GAT_BATCH, dev)(
        np.random.default_rng(4).standard_normal(
            (1, cs.GAT_DIMS[0], cs.GAT_N)).astype(np.float32))
    torch.cuda.synchronize()
    cs.timed("bf16_serving", cs.phase_bf16_serving, S_np, arch,
             np.random.default_rng(32), dev)
    cs.timed("bf16_kernels", cs.phase_bf16_kernels, graph, S_np, arch.S, dev)
    cs.timed("bf16_train_kernels", cs.phase_bf16_train_kernels, arch.S, dev)
    with tempfile.TemporaryDirectory(prefix="torch_bf16_phases_") as out_dir:
        cs.timed("bf16_training", cs.phase_bf16_training, arch, S_np,
                 np.random.default_rng(37), dev, out_dir)
    if "--sharded" in sys.argv[1:]:
        sharded(card, dev, S)
    if "--grnn-edge" in sys.argv[1:]:
        torch.cuda.empty_cache()
        cs.timed("grnn_bf16_serving", cs.phase_grnn_bf16_serving, S_np,
                 np.random.default_rng(41), dev, True)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="torch_bf16_phases_") as d:
            cs.timed("edge_bf16", cs.phase_edge_bf16, S_np,
                     np.random.default_rng(42), dev, d, True)
    return 0


def sharded(card, dev, S):
    """The sharded bf16 phases."""
    torch.cuda.empty_cache()
    _, _, db_req = cs.timed("multi_arg_serving", cs.phase_multi_arg_serving,
                            dev, card)
    part = par.partition_nodes(S, cs.SHARD_PARTS, order="none")
    cs.timed("shard_bf16_kernels", cs.phase_shard_bf16_kernels, part,
             *par.attention._row_col_masks(part), dev)
    S_sc = cs.scattered_graph(np.random.default_rng(16), cs.N_GRAPH,
                              cs.SCATTER_IBS)
    spart = par.partition_nodes_bcsr(S_sc, cs.SHARD_PARTS,
                                     inner_block=cs.SCATTER_IBS)
    _, gat_archs, gat_ref = cs.timed(
        "shard_bf16_serving", cs.phase_shard_bf16_serving,
        np.random.default_rng(39), dev, S_sc, spart, db_req)
    del db_req
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="torch_bf16_phases_") as out_dir:
        cs.timed("shard_bf16_training", cs.phase_shard_bf16_training,
                 np.random.default_rng(40), dev, out_dir, gat_archs, gat_ref)


if __name__ == "__main__":
    sys.exit(main())
