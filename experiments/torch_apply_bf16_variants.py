#!/usr/bin/env python3
"""Time the bf16 apply (kernels 8 and 11 on bf16 operands) in its two forms
on one CUDA card: the tensor-core kernel the package ships
(attention_flash.cu's attn_apply_mma_kernel) and the FMA form it replaced
(attn_apply_kernel<kExt, G, bf16>: f32 tiles staged from bf16, the product
in f32 FMAs).

    python3 experiments/torch_apply_bf16_variants.py

The FMA form is a copy of this checkout's graph_neural_networks_torch under
experiments/torch_apply_bf16_variants/ (gitignored) whose bf16 apply
launcher dispatches attn_apply_kernel<kExt, G, bf16> (VARIANTS), built by
its own nvcc run. Each form is timed in a process of its own, at
gat_band_n16384's shapes (chip_smoke.make_graph's graph): the global apply
(kExt = false) at Q = 16, F = 32, N = 16384, w = 2, with S, and the ext
apply (kExt = true) of an interior shard of that graph over 4 (Np = 4096
+ 2 * 256 halo columns), by chip_smoke.time_ms (CUDA events) and
chip_smoke.graph_ms (a CUDA graph's replay), beside its distance from the
bf16 plain version in bf16 ulps. The processes run in turns: shipped,
fma, fma, shipped. Prints the card's name and power limit, then one JSON
line a process.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT = os.path.join(HERE, "torch_apply_bf16_variants")

# name -> (what it is, [(text of attention_flash.cu, its replacement)])
VARIANTS = {
    "fma": ("attn_apply_kernel<kExt, G, bf16>: the FMA form on f32 tiles",
            [("        attn_apply_mma_kernel<kExt, G>,\n",
              "        attn_apply_kernel<kExt, G, bf16>,\n"),
             ("    attn_apply_mma_kernel<kExt, G><<<",
              "    attn_apply_kernel<kExt, G, bf16><<<"),
             ("    const size_t smem = apply_mma_smem_bytes(G, W, A.ibs);",
              "    const size_t smem = apply_smem_bytes(G, W, A.ibs);")]),
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
                       "csrc", "attention_flash.cu")
    with open(src) as f:
        text = f.read()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in the source once")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text)
    return root


def time_root(root: str, name: str) -> dict:
    """The bf16 apply of the package under `root`, global and ext, at the
    served shapes: ms, graph_ms and ulps from the bf16 plain version."""
    sys.path.insert(0, root)
    sys.path.insert(1, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from graph_neural_networks_torch import kernels
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.ops import gso as gso_lib
    from graph_neural_networks_torch.parallel.mesh import halo_ext
    kernels.build()
    dev, bf = torch.device("cuda"), torch.bfloat16
    S, _ = cs.make_graph(cs.GAT_N, 0.01, 256, seed=1)
    gso = gso_lib.as_gso(S, "band", device=dev)
    aux = cs._bf16_aux(af.band_auxes(gso)[0])
    Q, F, w, ibs = 16, 32, gso.band_w, gso.block_size
    Np = gso.s_band.shape[1] * ibs
    rng = np.random.default_rng(1)
    a1, a2, v = (t.to(bf) for t in cs._attn_operands(rng, dev, Q, F, gso.n,
                                                     Np))
    mx, sm = af.stats_plain(a1, a2, aux.mask_row, w=w, ibs=ibs)
    glob = (a1, a2, v, mx, sm, aux.slab_col, aux.mask_col)
    kw = dict(w=w, ibs=ibs, lists=aux.lists)
    out = dict(variant=name, package=os.path.dirname(af.__file__))
    got = af.apply_call(*glob, **kw)
    out["global"] = dict(
        shape=f"Q={Q} F={F} N={gso.n} w={w} with_s",
        ulps=cs._ulps_of(got, af.apply_plain(*glob, w=w, ibs=ibs)),
        ms=cs.time_ms(lambda: af.apply_call(*glob, **kw)),
        graph_ms=cs.graph_ms(lambda: af.apply_call(*glob, **kw)))
    part = par.partition_nodes(S, 4, order="none")
    mc, mr = par.attention._row_col_masks(part)
    own, ext, masks = cs._shard_operands(rng, dev, part, Q, F, mc, mr)
    own = {k: [t.to(bf) for t in ts] for k, ts in own.items()}
    ext = {k: [t.to(bf) for t in ts] for k, ts in ext.items()}
    masks = [tuple(t.to(bf) for t in m) for m in masks]
    stats = [af.stats_ext_plain(ext["a1"][q], own["a2"][q], masks[q][1],
                                w=part.w, ibs=part.inner_bs)
             for q in range(part.n_parts)]
    p = 1
    args = (own["a1"][p], ext["a2"][p], ext["v"][p],
            halo_ext([s[0] for s in stats], part.halo)[p],
            halo_ext([s[1] for s in stats], part.halo)[p], masks[p][2],
            masks[p][0])
    kx = dict(w=part.w, ibs=part.inner_bs,
              lists=af.support_lists(masks[p][0]))
    got = af.apply_ext_call(*args, **kx)
    out["ext"] = dict(
        shape=(f"Q={Q} F={F} Np={part.block_size} (+2*{part.halo} halo) "
               f"w={part.w} with_s, shard {p}/{part.n_parts}"),
        ulps=cs._ulps_of(got, af.apply_ext_plain(*args, w=part.w,
                                                 ibs=part.inner_bs)),
        ms=cs.time_ms(lambda: af.apply_ext_call(*args, **kx)),
        graph_ms=cs.graph_ms(lambda: af.apply_ext_call(*args, **kx)))
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
