#!/usr/bin/env python3
"""Drive the PyTorch port (graph_neural_networks_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written SpMM kernels from kernels/csrc with nvcc, holds
each against its plain PyTorch version at the serving path's shapes and at
edge cases, times each beside its plain version, one library call and its
bound, then serves the band_n4096 SelectionGNN (N=4096 banded graph,
[1,64,64] features, K=5, batch 32) in band and bcsr mode through
InferenceEngine and checks the answers against dense mode and the kernel
launch counts. Every phase prints one JSON line; any failure exits
non-zero. The last line is ``{"ok": true, "device": {...}}``.

Needs CUDA and this repository's graph_neural_networks_torch package;
imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet rates: HBM bandwidth and
# FP32 (non-tensor-core) FMA peak. The kernels run true-f32 FMAs.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

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
    _, log, secs = kernels.build()
    kernels.library()
    resources = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=secs, sources=list(kernels.SOURCES),
         ptxas=resources)


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
    # slice shapes: layer 2 chained shift, layer 1 fused register, bcsr both
    x = rand(2048, N)
    check("band_matmul", "R=2048 N=4096 w=1",
          spmm.band_matmul(x, sb, n_cols=N, w=w),
          spmm.band_matmul_plain(x, sb, n_cols=N, w=w))
    x32 = rand(BATCH, N)
    check("band_shift_register", "R=32 N=4096 w=1 K=5",
          spmm.band_shift_register(x32, sb, n_taps=TAPS, n_cols=N, w=w),
          spmm.band_shift_register_plain(x32, sb, n_taps=TAPS, n_cols=N, w=w))
    bl, br, bc = S_bcsr.blocks[0], S_bcsr.block_row, S_bcsr.block_col
    for xx in (x, x32):
        check("bcsr_matmul", f"R={xx.shape[0]} N=4096 nnzb={bl.shape[0]}",
              spmm.bcsr_matmul(xx, bl, br, bc, n_cols=N),
              spmm.bcsr_matmul_plain(xx, bl, br, bc, n_cols=N))

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
    # rectangular BCSR with an empty output block column: x (R, 1000) on
    # its own 8-block grid, y (R, 640) on a 5-block grid, column 2 empty
    n_in, n_out = 1000, 640
    pattern = [(r, c) for c in (0, 1, 3, 4) for r in range(8)
               if rng.random() < 0.5 or r == c]
    brow = torch.tensor([p[0] for p in pattern], dtype=torch.int32,
                        device=dev)
    bcol = torch.tensor([p[1] for p in pattern], dtype=torch.int32,
                        device=dev)
    blocks = rand(len(pattern), 128, 128)
    xr = rand(50, n_in)
    yr = spmm.bcsr_matmul(xr, blocks, brow, bcol, n_cols=n_out)
    require(bool((yr[:, 256:384] == 0).all()), "bcsr empty column not zero")
    check("bcsr_matmul", f"rect R=50 {n_in}->{n_out}, empty column",
          yr, spmm.bcsr_matmul_plain(xr, blocks, brow, bcol, n_cols=n_out))
    # square BCSR with a hole: drop block column 5 of the graph's layout
    keep = bc != 5
    bl2, br2, bc2 = (bl[keep].contiguous(), br[keep].contiguous(),
                     bc[keep].contiguous())
    check("bcsr_matmul", "R=32 N=4096, empty column 5",
          spmm.bcsr_matmul(x32[:, :N], bl2, br2, bc2, n_cols=N),
          spmm.bcsr_matmul_plain(x32[:, :N], bl2, br2, bc2, n_cols=N))

    # forward-only: a kernel call that would need a gradient raises (the
    # plain CPU path differentiates)
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
    from graph_neural_networks_torch.ops import spmm
    S_band, S_bcsr = graph["band"], graph["bcsr"]
    N, bs, w = N_GRAPH, 128, S_band.band_w
    nb = N // bs
    sb = S_band.s_band[0]
    bl, br, bc = S_bcsr.blocks[0], S_bcsr.block_row, S_bcsr.block_col
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
        plain_ms=time_ms(lambda: spmm.band_matmul_plain(x2048, sb, n_cols=N,
                                                        w=w)),
        library_ms=time_ms(lambda: torch.matmul(x2048, Sd)),
        library_call="torch.matmul(x, S_dense), TF32 off",
        flops=2 * R * win * bs * bs,
        bytes=4 * (R * N + R * N + sb.numel()))
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
    for R, xx in ((2048, x2048), (BATCH, x32)):
        rows[f"bcsr_matmul@R={R}"] = dict(
            shape=f"R={R} N={N} nnzb={nnzb}",
            ms=time_ms(lambda: spmm.bcsr_matmul(xx, bl, br, bc, n_cols=N)),
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
    return rows


def _build_model(S, mode, dev):
    import torch
    from graph_neural_networks_torch.models import architectures as archs
    N = S.shape[0]
    return archs.SelectionGNN(
        [1, 64, 64], [TAPS, TAPS], True, "relu", [N, N], "NoPool", [1, 1],
        [5], S, gsoMode=mode, device=dev,
        generator=torch.Generator().manual_seed(0))


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

    expected = {"band": {"band_shift_register": 1, "band_matmul": 4,
                         "bcsr_matmul": 0},
                "bcsr": {"band_shift_register": 0, "band_matmul": 0,
                         "bcsr_matmul": 8}}
    launches, checks = {}, []
    for mode in ("band", "bcsr"):
        eng = engines[mode]
        spmm.reset_launch_counts()
        t0 = time.perf_counter()
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
    with torch.inference_mode():   # the kernels are forward-only
        cpu = _build_model(S_small, "band", "cpu")(x)
        gpu = _build_model(S_small, "band", dev)(x)
    max_abs, _, ok = compare(gpu.cpu(), cpu, SERVE_RTOL, SERVE_ATOL_REL)
    emit(phase="small_reference", N=384, max_abs_err=max_abs, ok=ok)
    require(ok, "band model on the card disagrees with the CPU at N=384")
    return launches


def _profile_forward(mode, eng, x, n=10):
    """Where one served batch-32 forward spends its time: the host clock
    per forward without the profiler, and device time by kernel from
    torch.profiler over `n` forwards."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        eng(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng(x)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng(x)
        torch.cuda.synchronize()
    # kernel rows only: an operator's row repeats its kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / n / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    emit(phase="profile", mode=mode, batch=int(x.shape[0]),
         wall_ms_per_forward=wall_ms,
         device_ms_per_forward=device_ms if events else "not measured",
         device_idle_share=(1 - device_ms / wall_ms) if events
         else "not measured",
         top=[dict(name=e.key[:80],
                   ms_per_forward=e.self_device_time_total / n / 1e3,
                   calls_per_forward=e.count / n) for e in top])


REPLACES = {
    "band_matmul": "graph_neural_networks_tpu/ops/spmm.py:624",
    "band_shift_register": "graph_neural_networks_tpu/ops/spmm.py:441",
    "bcsr_matmul": "graph_neural_networks_tpu/ops/spmm.py:151",
}


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
    from graph_neural_networks_torch.ops import gso as gso_lib
    from graph_neural_networks_torch.utils.device import resolve_device

    try:
        dev = resolve_device("cuda")
        card = phase_device()
        phase_build()
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        S_np = banded_graph(rng, N_GRAPH, 256, 0.05)
        graph = {m: gso_lib.as_gso(S_np, m, device=dev)
                 for m in ("band", "bcsr")}
        emit(phase="graph", N=N_GRAPH, band_w=graph["band"].band_w,
             slab=list(graph["band"].s_band.shape[1:]),
             nnzb=int(graph["bcsr"].blocks.shape[1]),
             seconds=time.perf_counter() - t0)
        errs = phase_kernels(graph, np.random.default_rng(1), dev)
        rows = phase_timing(graph, dev)
        launches = phase_serving(S_np, np.random.default_rng(3), dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    for name, n in launches.items():
        if n == 0:
            print(f"chip_smoke: FAILED: {name} never launched on the main "
                  "path", file=sys.stderr)
            return 1
    summary = []
    for name in ("bcsr_matmul", "band_shift_register", "band_matmul"):
        row = rows["bcsr_matmul@R=2048" if name == "bcsr_matmul" else name]
        summary.append(dict(
            name=name, route="cuda",
            source="graph_neural_networks_torch/kernels/csrc/spmm.cu",
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
