"""Build and load the package's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. The build happens at the first CUDA call that needs it, never
at import, into ``kernels/build/<source hash>/`` (listed in .gitignore), so
a CPU-only machine imports the package without a compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(_HERE, "build")
SOURCES = ("spmm.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of each launcher in csrc/spmm.cu; all return cudaError_t.
_SIGNATURES = {
    # x, s_band, y, R, N, n_cols, nb, w, bs, stream
    "gnt_band_matmul": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, blocks, block_row, col_start, y, R, N, n_cols, bs, stream
    "gnt_bcsr_matmul": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, s_band, out, R, N, nb, w, bs, K, stream
    "gnt_band_register": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
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


def build() -> tuple[str, str, float]:
    """Compile the sources if this hash is not built yet.

    Returns (library path, nvcc's output with the -Xptxas -v resource
    report, build seconds); seconds is 0.0 when the library was already
    there. The library is written under a temporary name and renamed, so
    concurrent processes never load a half-written file.
    """
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    lib = os.path.join(out_dir, "libgnt_kernels.so")
    if os.path.exists(lib):
        return lib, "", 0.0
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gnt_error_string.argtypes = (ctypes.c_int,)
    lib.gnt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned anything but cudaSuccess (0)."""
    if err != 0:
        msg = library().gnt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} ({msg})")
