#!/usr/bin/env python3
"""Time the bf16 graph-shift kernels of the PyTorch port (spmm.cu's
bcsr_mma_kernel and band_register_mma_kernel) against variants of their
tile choice, on one CUDA card.

    python3 experiments/torch_bf16_tiles.py

Each variant is a copy of this checkout's graph_neural_networks_torch under
experiments/torch_tile_variants/ (gitignored) with one edit of
kernels/csrc/spmm.cu's tile choice (VARIANTS). Each is built by its own nvcc
run and timed in a process of its own at band_n4096's graph (N = 4096,
w = 1, bs = 128), R = 128 .. 2048: bcsr_matmul and band_matmul (one call)
and band_shift_register (K = 5), by chip_smoke.graph_ms (the device time of
a CUDA graph's replay), in bf16. The processes run in turns, shipped first
and last and each variant twice (forward, then backward order), so that two
tile choices are compared only within one call. Prints the card's name and
power limit, then one JSON line a process.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT = os.path.join(HERE, "torch_tile_variants")
ROWS = (2048, 1024, 512, 256, 128)

_WIDE_RULE = "bs % MmaWide::kBN == 0 && 2 * blocks128 >= sms"
_REG = "using RegWide = RegTile<128, 64, 4, 2, 3>;"
# name -> (what it tries, [(text of spmm.cu, its replacement)])
VARIANTS = {
    "wide64": ("the mainloop's 128 x 64 tile at every R > 64",
               [(_WIDE_RULE, "false")]),
    "wide128": ("the mainloop's 128 x 128 tile at every R > 64",
                [(_WIDE_RULE, "bs % MmaWide::kBN == 0")]),
    "wide256": ("a 256 x 128 mainloop tile, 16 warps, one block an SM",
                [("using MmaWide = MmaTile<128, 128, 2, 4, 1, 3, 2>;",
                  "using MmaWide = MmaTile<256, 128, 4, 4, 1, 3, 1>;"),
                 (_WIDE_RULE, "bs % MmaWide::kBN == 0")]),
    "reg128": ("the register's 128-column panel, 8 warps, one block an SM",
               [(_REG, "using RegWide = RegTile<128, 128, 4, 2, 3>;")]),
    "reg128w16": ("the register's 128-column panel, 16 warps",
                  [(_REG, "using RegWide = RegTile<128, 128, 4, 4, 3>;")]),
}


def make_variant(name: str) -> str:
    """This checkout's package copied under OUT/name with the variant's
    edits (each must match once); the copy's root."""
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "graph_neural_networks_torch"),
                    os.path.join(root, "graph_neural_networks_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    src = os.path.join(root, "graph_neural_networks_torch", "kernels",
                       "csrc", "spmm.cu")
    with open(src) as f:
        text = f.read()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in spmm.cu once")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text)
    return root


def time_root(root: str, name: str) -> dict:
    """graph_ms of the three bf16 kernels of the package under `root`."""
    sys.path.insert(0, root)
    sys.path.insert(1, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from graph_neural_networks_torch import kernels
    from graph_neural_networks_torch.ops import gso as gso_lib
    from graph_neural_networks_torch.ops import spmm
    kernels.build()
    dev, bf = torch.device("cuda"), torch.bfloat16
    S = cs.banded_graph(np.random.default_rng(0), 4096, 256, 0.05)
    band = gso_lib.as_gso(S, "band", device=dev).to(dtype=bf)
    bcsr = gso_lib.as_gso(S, "bcsr", device=dev).to(dtype=bf)
    N, w, sb = 4096, band.band_w, band.s_band[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    out = dict(variant=name, package=os.path.dirname(spmm.__file__))
    for R in ROWS:
        x = torch.randn(R, N, device=dev, generator=gen).to(bf)
        out[f"bcsr_matmul@R={R}"] = cs.graph_ms(lambda: spmm.bcsr_matmul(
            x, bcsr.blocks[0], bcsr.block_row, bcsr.block_col, n_cols=N,
            col_start=bcsr.col_start))
        out[f"band_matmul@R={R}"] = cs.graph_ms(
            lambda: spmm.band_matmul(x, sb, n_cols=N, w=w))
        out[f"band_shift_register@R={R}"] = cs.graph_ms(
            lambda: spmm.band_shift_register(x, sb, n_taps=5, n_cols=N, w=w))
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--time":
        print(json.dumps(time_root(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    roots = {"shipped": ROOT}
    roots.update({name: make_variant(name) for name in VARIANTS})
    names = list(VARIANTS)
    order = ["shipped", *names, *reversed(names), "shipped"]
    for name in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--time", roots[name], name])
        if r.returncode != 0:
            return r.returncode
    print(json.dumps({"variants": {k: v[0] for k, v in VARIANTS.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
