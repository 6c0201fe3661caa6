"""Build and load the package's hand-written CUDA kernels, and the
helpers every kernel wrapper shares.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc -c`` per source, all started together, then
linked into one shared library with a plain C interface, loaded with
``ctypes``. The build happens at the first CUDA call that needs it, never
at import, into ``kernels/build/<source hash>/`` (listed in .gitignore), so
a CPU-only machine imports the package without a compiler.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(_HERE, "build")
SOURCES = ("spmm.cu", "attention_flash.cu", "gridwin.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# --split-compile=0: each source's device optimizations run in parallel
# over the CPUs (attention_flash.cu's 26 instances were the build's long
# pole)
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "--split-compile=0")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each export in csrc/ but the kernel tables; all return
# cudaError_t, but gnt_attn_bwd_smem_bytes and gnt_spmm_smem_bytes a byte
# count and gnt_attn_apply_group a row count. An entry ending in _bf16 is the bf16-io
# instance of the entry without it, with the same arguments.
_SIGNATURES = {
    # x, s_band, y, R, N, n_cols, nb, w, bs, stream
    "gnt_band_matmul": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, blocks, block_row, col_start, y, R, N, n_cols, bs, stream
    "gnt_bcsr_matmul": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, s_band, out, R, N, nb, w, bs, K, stream
    "gnt_band_register": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # a1, a2, mask_row, rowmax, rowsum, Q, Np, nb, w, ibs, slope, stream
    "gnt_attn_stats": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # a1_ext, a2, mask_row, rowmax, rowsum, Q, Np, nb, w, ibs, slope, stream
    "gnt_attn_stats_ext": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # a1, a2, v, rowmax, rowsum, slab_col, sup_entries, sup_offs, y, Q, F,
    # Np, nb, w, ibs, with_s, slope, stream
    "gnt_attn_apply": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _I, _I, _I, _F, _P),
    # a1, a2_ext, v_ext, mx_ext, sm_ext, slab_col, sup_entries, sup_offs,
    # y, Q, F, Np, nb, w, ibs, with_s, slope, stream
    "gnt_attn_apply_ext": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _I, _I, _F, _P),
    # g, a1, a2, v, rowmax, rowsum, slab_col, mask_row, da2, da1p, dv, Q, F,
    # Np, nb, w, ibs, with_s, slope, stream
    "gnt_attn_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                     _I, _I, _I, _I, _F, _P),
    # g_ext, a1_ext, a2, v, rowmax, rowsum, slab_col_ext, mask_row, da2,
    # da1p, dv, Q, F, Np, nb, w, ibs, with_s, slope, stream
    "gnt_attn_bwd_ext": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                         _I, _I, _I, _I, _I, _F, _P),
    # table, own, slots, keep, out, R, W, n_win, C, r2, need_exp, d_max,
    # wv_only, n_pay, stream
    "gnt_grid_window": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                        _I, _P),
    # F, W, ibs: attn_bwd_kernel's dynamic shared memory in bytes
    "gnt_attn_bwd_smem_bytes": (_I, _I, _I),
    # Q, F, Np: the signal rows a block of attn_apply_kernel serves
    "gnt_attn_apply_group": (_I, _I, _I),
    # kernel (from a table below), out (4 ints): cudaFuncGetAttributes
    "gnt_kernel_attributes": (_P, _P),
    # i (of gnt_spmm_kernel's table), w, bs: that kernel's dynamic shared
    # memory a block on such a layout, in bytes
    "gnt_spmm_smem_bytes": (_I, _I, _I),
    # fs, starts, out, B, H, N, F, C, W, stream
    "gnt_table_build": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # mm, out, H, L, F, C, W, stream
    "gnt_table_transpose": (_P, _P, _I, _I, _I, _I, _I, _P),
}
_SIGNATURES.update({
    f"{name}_bf16": _SIGNATURES[name]
    for name in ("gnt_band_matmul", "gnt_bcsr_matmul", "gnt_band_register",
                 "gnt_attn_stats", "gnt_attn_apply", "gnt_attn_bwd",
                 "gnt_attn_stats_ext", "gnt_attn_apply_ext",
                 "gnt_attn_bwd_ext", "gnt_attn_bwd_smem_bytes")})

# The io types a kernel has an instance for (its launcher's name suffix).
IO_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}

# Calls of the registered ops (ops.spmm, ops.attention_flash: the kernels
# with a bf16 instance) and of bwd_call and the ext wrappers (kernels 9-12,
# which have one too), by (name, io dtype), on the CPU and on CUDA alike:
# what shows that a path ran in the dtype it was asked for.
OP_CALLS: collections.Counter = collections.Counter()
# Each source's table of its kernels: gnt_<source>_kernel(i, &name) gives
# kernel i's address and name, or null past the last.
_KERNEL_TABLES = ("gnt_spmm_kernel", "gnt_attention_kernel",
                  "gnt_gridwin_kernel")

# The differentiable form of each kernel wrapper: a torch.autograd.Function
# whose forward and backward call the wrappers with grad off.
AUTOGRAD_FUNCTIONS = {
    "band_matmul": "ops.spmm.BandShift",
    "band_shift_register": "ops.spmm.BandRegister",
    "bcsr_matmul": "ops.spmm.BcsrShift",
    "stats_call": "ops.attention_flash.FlashApply",
    "apply_call": "ops.attention_flash.FlashApply",
    "bwd_call": "ops.attention_flash.FlashApply (it is that Function's "
                "backward)",
    "stats_ext_call": "parallel.attention.ShardedBandAttention.apply",
    "apply_ext_call": "parallel.attention.ShardedBandAttention.apply",
    "bwd_ext_call": "parallel.attention.ShardedBandAttention.apply (its "
                    "backward)",
}


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); the kernels "
                           "are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run_all(cmds) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")


def build() -> tuple[str, float]:
    """Compile the sources if this hash is not built yet.

    Returns (library path, build seconds); seconds is 0.0 when the library
    was already there. Each source compiles in its own nvcc process, all at
    once; the library is linked under a temporary name and renamed, so
    concurrent processes never load a half-written file.
    """
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    lib = os.path.join(out_dir, "libgnt_kernels.so")
    if os.path.exists(lib):
        return lib, 0.0
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        objs = [os.path.join(tmp_dir, s + ".o") for s in SOURCES]
        _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", o,
                   os.path.join(CSRC, s)]
                  for s, o in zip(SOURCES, objs)])
        tmp = os.path.join(tmp_dir, "lib.so")
        _run_all([[_nvcc(), *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name in _KERNEL_TABLES:
        fn = getattr(lib, name)
        fn.argtypes = (_I, ctypes.POINTER(ctypes.c_char_p))
        fn.restype = _P
    lib.gnt_error_string.argtypes = (ctypes.c_int,)
    lib.gnt_error_string.restype = ctypes.c_char_p
    return lib


# The layout (band w, block size) at which attributes() reports the
# graph-shift kernels' dynamic shared memory: band_n4096's.
SMEM_LAYOUT = (1, 128)
# The layout (F, W, ibs) at which it reports the flash backward kernels':
# gat_band_n16384's (F = 32, w = 2); an attn_bwd_mma_kernel instance of NF
# k16 feature steps at F = 16 NF, the widest it takes.
ATTN_SMEM_LAYOUT = (32, 5, 128)


def attributes() -> dict:
    """cudaFuncGetAttributes of every kernel of the library, by kernel
    name: its registers a thread, local (spill) bytes, static shared bytes
    and most threads a block; for the graph-shift kernels (spmm.cu) also
    the dynamic shared bytes a block takes on a band of SMEM_LAYOUT, and
    for the flash backward kernels at ATTN_SMEM_LAYOUT."""
    lib = library()
    found = {}
    for table in _KERNEL_TABLES:
        name = ctypes.c_char_p()
        i = 0
        while fn := getattr(lib, table)(i, ctypes.byref(name)):
            out = (ctypes.c_int * 4)()
            kernel = name.value.decode()
            check(lib.gnt_kernel_attributes(fn, out), f"{kernel} attributes")
            found[kernel] = dict(registers=out[0], local_bytes=out[1],
                                 static_shared_bytes=out[2],
                                 max_threads=out[3])
            if table == "gnt_spmm_kernel":
                found[kernel]["dynamic_shared_bytes"] = \
                    lib.gnt_spmm_smem_bytes(i, *SMEM_LAYOUT)
            elif kernel.startswith("attn_bwd_kernel"):
                found[kernel]["dynamic_shared_bytes"] = \
                    lib.gnt_attn_bwd_smem_bytes(*ATTN_SMEM_LAYOUT)
            elif kernel.startswith("attn_bwd_mma_kernel"):
                nf = int(kernel.split(",")[1])
                found[kernel]["dynamic_shared_bytes"] = \
                    lib.gnt_attn_bwd_smem_bytes_bf16(16 * nf,
                                                     *ATTN_SMEM_LAYOUT[1:])
            i += 1
    return found


def check(err: int, name: str) -> None:
    """Raise if a launcher returned anything but cudaSuccess (0)."""
    if err != 0:
        msg = library().gnt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} ({msg})")


def on_cuda(name: str, x: torch.Tensor, *others: torch.Tensor) -> bool:
    """True when a wrapper's call goes to its kernel (x on CUDA), False for
    its plain version (x on the CPU). Raises on mixed devices and on a
    call that would need a gradient through the raw wrapper: the kernels
    are differentiated by their autograd Functions (AUTOGRAD_FUNCTIONS),
    which call the wrappers with grad off."""
    for t in others:
        if t.device != x.device:
            raise ValueError(f"{name}: inputs on {x.device} and {t.device}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *others)):
        how = (f"call graph_neural_networks_torch.{AUTOGRAD_FUNCTIONS[name]}"
               " to differentiate through the kernel"
               if name in AUTOGRAD_FUNCTIONS else
               "the kernel has no gradient (the environment runs forward "
               "only)")
        raise NotImplementedError(
            f"{name}: the raw kernel wrapper records no gradient; {how}")
    return True


def entry(name: str, dtype: torch.dtype):
    """The library's launcher `name` (gnt_...) for io dtype `dtype`;
    raises for a dtype no instance takes."""
    if dtype not in IO_DTYPES:
        raise TypeError(f"{name}: no kernel instance takes {dtype}; the io "
                        f"dtypes are {list(IO_DTYPES)}")
    return getattr(library(), name + IO_DTYPES[dtype])


def io_dtype(name: str, x: torch.Tensor) -> torch.dtype:
    """x's dtype, the io dtype of a kernel with f32 and bf16 instances;
    raises for any other."""
    if x.dtype not in IO_DTYPES:
        raise TypeError(f"{name}: the kernel takes f32 or bf16, got "
                        f"{x.dtype}")
    return x.dtype


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether a call records a gradient: the wrappers of the ops (which
    have no autograd formula) then run the plain version directly on the
    CPU; on CUDA :func:`on_cuda` has raised already."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_inputs(name: str, **tensors) -> None:
    """Raise unless each ``arg=(tensor, dtype)`` has that dtype and is
    contiguous (what the kernels take)."""
    for arg, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def stream() -> int:
    """The current CUDA stream, as the launchers take it."""
    return torch.cuda.current_stream().cuda_stream
