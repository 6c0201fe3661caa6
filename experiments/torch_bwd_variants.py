#!/usr/bin/env python3
"""Time kernel 9b (attention_flash.cu's attn_bwd_mma_kernel, the bf16
flash backward) against variants of its arithmetic, on one CUDA card.

    python3 experiments/torch_bwd_variants.py

Each variant is a copy of this checkout's graph_neural_networks_torch under
experiments/torch_bwd_variants/ (gitignored) with edits of
kernels/csrc/attention_flash.cu (VARIANTS), built by its own nvcc run and
timed in a process of its own at gat_band_n16384's shape (Q = 16, F = 32,
N = 16384, w = 2, with S; chip_smoke.make_graph's graph) by
chip_smoke.time_ms (CUDA events) and chip_smoke.graph_ms (a CUDA graph's
replay), beside its distance from the bf16 plain version (dv in bf16
ulps, da2 and the folded da1 relative to their largest magnitude). The
processes run in turns, shipped first and last and each variant twice.
Prints the card's name and power limit, then one JSON line a process.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT = os.path.join(HERE, "torch_bwd_variants")

_ALPHA = "__device__ __forceinline__ unsigned ld_pair(const bf16* p) {"
_FAST = """__device__ __forceinline__ float alpha_fast(float a2, float a1, float m,
                                            float mx, float rinv,
                                            float slope) {
  return m != 0.f
             ? __fmul_rn(__expf(__fsub_rn(leaky_score(a2, a1, slope), mx)),
                         rinv)
             : 0.f;
}

""" + _ALPHA
# name -> (what it tries, [(text of attention_flash.cu, its replacement)])
VARIANTS = {
    "fast_exp": ("__expf (ex2.approx) for alpha's exp in both passes",
                 [(_ALPHA, _FAST),
                  ("const float al = alpha(ra2[h], j ? bf16_hi(a1p)",
                   "const float al = alpha_fast(ra2[h], j ? bf16_hi(a1p)"),
                  ("const float al = alpha(ra2[h], a1v,",
                   "const float al = alpha_fast(ra2[h], a1v,")]),
    "hi_only": ("diagnostic, not a candidate: the dv product without the "
                "coefficient's lo part (one mma where two run)",
                [("          mma_bf16(dva[2 * nj], alo, bb[0], bb[1]);\n",
                  ""),
                 ("          mma_bf16(dva[2 * nj + 1], alo, bb[2], bb[3]);\n",
                  "")]),
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
    """Kernel 9b of the package under `root` at the served shape: its ms,
    graph_ms and distance from the bf16 plain version."""
    sys.path.insert(0, root)
    sys.path.insert(1, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from graph_neural_networks_torch import kernels
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.ops import gso as gso_lib
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
    ct = cs._attn_operands(rng, dev, Q, F, gso.n, Np)[2].to(bf)
    mx, sm = af.stats_plain(a1, a2, aux.mask_row, w=w, ibs=ibs)
    args = (a1, a2, v, mx, sm, aux.slab_col, aux.mask_row, ct)
    got = af.bwd_call(*args, w=w, ibs=ibs)
    want = af.bwd_plain(*args, w=w, ibs=ibs)
    fold = [af.fold_window_partials(t[1], w) for t in (got, want)]
    return dict(variant=name, package=os.path.dirname(af.__file__),
                ms=cs.time_ms(lambda: af.bwd_call(*args, w=w, ibs=ibs)),
                graph_ms=cs.graph_ms(lambda: af.bwd_call(*args, w=w,
                                                         ibs=ibs)),
                dv_ulps=cs._ulps_of(got[2], want[2]),
                da2_rel=cs._rel_err(got[0], want[0]),
                da1_rel=cs._rel_err(*fold))


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
