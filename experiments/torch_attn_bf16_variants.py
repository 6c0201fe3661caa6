#!/usr/bin/env python3
"""Time the bf16 flash attention kernels 7b, 9b, 10b and 12b
(attention_flash.cu's attn_stats_bf16_kernel and attn_bwd_mma_kernel, each
global and ext) against other forms of them, on one CUDA card.

    python3 experiments/torch_attn_bf16_variants.py --prepare [COMMIT]
    python3 experiments/torch_attn_bf16_variants.py [NAME ...]

A form is a copy of graph_neural_networks_torch under
experiments/torch_attn_bf16_variants/<name>/ (gitignored), built by its
own nvcc run and timed in a process of its own: "parent", the package of
an earlier commit (by default d04c200, the forms these kernels replaced:
attn_stats_kernel<kExt, bf16> and the one-signal-row attn_bwd_mma_kernel),
unpacked by --prepare with git archive where git is, before the run on the
card; and each of VARIANTS, this checkout's package with edits of
kernels/csrc/attention_flash.cu (diagnostics are not candidates: they
change what is computed, to show what a part of the kernel costs). Each
process times, at gat_band_n16384's shapes (chip_smoke.make_graph's
graph), stats_call and bwd_call (Q = 16, F = 32, N = 16384, w = 2, with S)
and stats_ext_call and bwd_ext_call on an interior shard of that graph
over 4 (Np = 4096 + 2 * 256 halo columns), by chip_smoke.time_ms (CUDA
events) and chip_smoke.graph_ms (a CUDA graph's replay), beside each
output's distance from its bf16 plain version (stats relative, dv in bf16
ulps, da2 and the folded da1 relative to their largest magnitude). The
processes run in turns: shipped, the named forms (default: parent and
every variant), the same reversed, shipped. Prints the card's name and
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
OUT = os.path.join(HERE, "torch_attn_bf16_variants")
PACKAGE = "graph_neural_networks_torch"
PARENT = "d04c200"

_TWO_PASS = """      float m = -INFINITY;
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
"""
# one pass: a running max, the sum rescaled when the max grows; the H
# lanes' (max, sum) pairs merged by a xor tree
_ONLINE = """      float m = -INFINITY, s = 0.f;
#pragma unroll 4
      for (int t = h; t < n; t += H) {
        const float e =
            leaky_score(a2v, bf16_bits(a1t[row[t] * L.qs + qr]), slope);
        if (e > m) {
          s = __fadd_rn(__fmul_rn(s, expf(__fsub_rn(m, e))), 1.f);
          m = e;
        } else {
          s = __fadd_rn(s, expf(__fsub_rn(e, m)));
        }
      }
      for (int o = ql; o < 32; o <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m, o);
        const float so = __shfl_xor_sync(0xffffffffu, s, o);
        const float mn = fmaxf(m, mo);
        s = __fadd_rn(
            __fmul_rn(s, m == mn ? 1.f : expf(__fsub_rn(m, mn))),
            __fmul_rn(so, mo == mn ? 1.f : expf(__fsub_rn(mo, mn))));
        m = mn;
      }
"""
_A_ALPHA = """              const float al = alpha(ra2[h], j ? bf16_hi(a1p) : bf16_lo(a1p),
                                     m, rmx[h], rrv[h], slope);
"""
_B_ALPHA = """              const float al =
                  alpha(ra2[h], a1v, j ? bf16_hi(mm) : bf16_lo(mm), rmx[h],
                        rrv[h], slope);
"""
# name -> (what it is, [(text of attention_flash.cu, its replacement)])
VARIANTS = {
    "stats_online": ("attn_stats_bf16_kernel with the max and the exp-sum "
                     "in one pass over the list (online softmax)",
                     [(_TWO_PASS, _ONLINE)]),
    "stats_score_max": ("attn_stats_bf16_kernel's max over the scores at "
                        "every slope (no a1 shortcut at slope >= 0)",
                        [("      if (slope >= 0.f) {\n        // the score",
                          "      if (false) {\n        // the score")]),
    "stats_rb32": ("attn_stats_bf16_kernel at up to 32 rows a block",
                   [("  for (int rb = 16; rb >= kStatsWarps; rb /= 2) {",
                     "  for (int rb = 32; rb >= kStatsWarps; rb /= 2) {")]),
    "bwd_2stage": ("attn_bwd_mma_kernel with 2 chunk stages (one ahead)",
                   [("constexpr int kBwdMmaStages = 3;",
                     "constexpr int kBwdMmaStages = 2;"),
                    ("    if (nch > 1) stage(1, 1, t0);\n    cp_commit();\n",
                     ""),
                    ("      cp_wait<1>();\n      // chunk ci (and v)",
                     "      cp_wait<0>();\n      // chunk ci (and v)"),
                    ("      if (ci + 2 < nch) stage((ci + 2) % kBwdMmaStages, "
                     "ci + 2, t0);",
                     "      if (ci + 1 < nch) stage((ci + 1) % kBwdMmaStages, "
                     "ci + 1, t0);"),
                    ("    if (n_live > 1) stage(1, list[1], t0);\n"
                     "    cp_commit();\n", ""),
                    ("      cp_wait<1>();\n      // chunk li landed",
                     "      cp_wait<0>();\n      // chunk li landed"),
                    ("      if (li + 2 < n_live)\n        stage((li + 2) % "
                     "kBwdMmaStages, list[li + 2], t0);",
                     "      if (li + 1 < n_live)\n        stage((li + 1) % "
                     "kBwdMmaStages, list[li + 1], t0);")]),
    "bwd_no_alpha_a": ("diagnostic: pass A's coefficients without the "
                       "score and its exp (m / rowsum)",
                       [(_A_ALPHA, "              const float al = "
                         "__fmul_rn(m, rrv[h]);\n")]),
    "bwd_no_alpha_b": ("diagnostic: pass B's alpha without the score and "
                       "its exp (m / rowsum)",
                       [(_B_ALPHA, "              const float al = __fmul_rn("
                         "j ? bf16_hi(mm) : bf16_lo(mm), rrv[h]);\n")]),
}


def prepare(commit: str) -> None:
    """OUT/parent: the package of `commit`, by git archive."""
    root = os.path.join(OUT, "parent")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    archive = subprocess.run(["git", "-C", ROOT, "archive", commit, PACKAGE],
                             capture_output=True, check=True).stdout
    subprocess.run(["tar", "-x", "-C", root], input=archive, check=True)
    with open(os.path.join(root, "COMMIT"), "w") as f:
        f.write(commit + "\n")


def make_variant(name: str) -> str:
    """This checkout's package copied under OUT/name with the variant's
    edits (each must match once); the copy's root."""
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PACKAGE), os.path.join(root, PACKAGE),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    src = os.path.join(root, PACKAGE, "kernels", "csrc", "attention_flash.cu")
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
    """The four kernels of the package under `root` at the served shapes:
    ms, graph_ms and the distances from the bf16 plain versions."""
    sys.path.insert(0, root)
    sys.path.insert(1, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from graph_neural_networks_torch import kernels
    from graph_neural_networks_torch import parallel as par
    from graph_neural_networks_torch.ops import attention_flash as af
    from graph_neural_networks_torch.ops import gso as gso_lib
    kernels.build()
    dev, bf = torch.device("cuda"), torch.bfloat16
    attrs = {k: (a["registers"], a["local_bytes"])
             for k, a in kernels.attributes().items()
             if k.startswith(("attn_stats", "attn_bwd_mma"))}
    S, _ = cs.make_graph(cs.GAT_N, 0.01, 256, seed=1)
    gso = gso_lib.as_gso(S, "band", device=dev)
    aux = cs._bf16_aux(af.band_auxes(gso)[0])
    Q, F, w, ibs = 16, 32, gso.band_w, gso.block_size
    Np = gso.s_band.shape[1] * ibs
    rng = np.random.default_rng(1)
    a1, a2, v = (t.to(bf) for t in cs._attn_operands(rng, dev, Q, F, gso.n,
                                                     Np))
    ct = cs._attn_operands(rng, dev, Q, F, gso.n, Np)[2].to(bf)
    out = dict(variant=name, package=os.path.dirname(af.__file__),
               registers_local_bytes=attrs)

    def stats_row(call, plain, args, kw):
        got, want = call(*args, **kw), plain(*args, **kw)
        return dict(rel=max(cs._rel_err(g, p) for g, p in zip(got, want)),
                    ms=cs.time_ms(lambda: call(*args, **kw)),
                    graph_ms=cs.graph_ms(lambda: call(*args, **kw)))

    def bwd_row(call, plain, fold, args, kw):
        got, want = call(*args, **kw), plain(*args, **kw)
        return dict(dv_ulps=cs._ulps_of(got[2], want[2]),
                    da2_rel=cs._rel_err(got[0], want[0]),
                    da1_rel=cs._rel_err(fold(got[1]), fold(want[1])),
                    ms=cs.time_ms(lambda: call(*args, **kw)),
                    graph_ms=cs.graph_ms(lambda: call(*args, **kw)))

    kw = dict(w=w, ibs=ibs)
    out["stats"] = stats_row(af.stats_call, af.stats_plain,
                             (a1, a2, aux.mask_row), kw)
    mx, sm = af.stats_plain(a1, a2, aux.mask_row, **kw)
    out["bwd"] = bwd_row(af.bwd_call, af.bwd_plain,
                         lambda t: af.fold_window_partials(t, w),
                         (a1, a2, v, mx, sm, aux.slab_col, aux.mask_row, ct),
                         kw)
    part = par.partition_nodes(S, 4, order="none")
    c = cs._shard_case_bf16(rng, dev, part, Q, F,
                            *par.attention._row_col_masks(part))
    p, kx = 1, dict(w=part.w, ibs=part.inner_bs)
    out["stats_ext"] = stats_row(
        af.stats_ext_call, af.stats_ext_plain,
        (c["ext"]["a1"][p], c["own"]["a2"][p], c["masks"][p][1]), kx)
    out["bwd_ext"] = bwd_row(af.bwd_ext_call, af.bwd_ext_plain,
                             af.fold_ext_partials, cs._ext_bwd_args(c, p),
                             kx)
    out["shapes"] = dict(
        glob=f"Q={Q} F={F} N={gso.n} w={w} with_s",
        ext=(f"Q={Q} F={F} Np={part.block_size} (+2*{part.halo} halo) "
             f"w={part.w} with_s, shard {p}/{part.n_parts}"))
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--time":
        print(json.dumps(time_root(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    if len(sys.argv) >= 2 and sys.argv[1] == "--prepare":
        prepare(sys.argv[2] if len(sys.argv) > 2 else PARENT)
        return 0
    names = sys.argv[1:] or ["parent", *VARIANTS]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    roots = {"shipped": ROOT}
    for name in names:
        if name == "parent":
            roots[name] = os.path.join(OUT, "parent")
            if not os.path.isdir(os.path.join(roots[name], PACKAGE)):
                raise SystemExit("parent: run --prepare first")
        else:
            roots[name] = make_variant(name)
    order = ["shipped", *names, *reversed(names), "shipped"]
    for name in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--time", roots[name], name])
        if r.returncode != 0:
            return r.returncode
    print(json.dumps({"variants": {k: v[0] for k, v in VARIANTS.items()
                                   if k in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
