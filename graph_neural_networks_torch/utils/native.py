"""ctypes binding of the host graph-structure library
(``kernels/csrc/graphcore.cpp``): K-hop BFS neighborhoods, one level of
Graclus matching, and the dense -> band and dense -> BCSR tilings.

The counterpart of the JAX package's ``utils/native.py``, with the same
entry points and return contracts. The library is compiled from the
package's own copy of the source with the host C++ compiler (``g++``
unless another is given) at the first call that needs it, never at
import, into ``kernels/build/graphcore-<hash>/`` (the hash of the source,
the flags and the compiler), portable code without ``-march=native``. The
library is linked under a temporary name and renamed, so processes that
start together never load a half-written file. A build or a load that
fails raises with the compiler's output.

Callers (``ops.spmm``'s layouts, ``utils.graph``'s neighborhoods and
Graclus matching) use the library unless the environment sets
``GNT_NO_NATIVE`` (the JAX package's switch), which takes their numpy
plain versions; a failed build never falls back to them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from typing import Optional

import numpy as np

from graph_neural_networks_torch import kernels

SOURCE = os.path.join(kernels.CSRC, "graphcore.cpp")
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")

__all__ = ["enabled", "build", "library", "bfs_khop", "graclus_match",
           "band_extract", "bcsr_count", "bcsr_extract"]


def enabled() -> bool:
    """Whether the callers use the library: unless ``GNT_NO_NATIVE`` is
    set."""
    return not os.environ.get("GNT_NO_NATIVE")


def _build_dir(compiler: str) -> str:
    h = hashlib.sha256(" ".join((compiler,) + CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(kernels.BUILD_ROOT, f"graphcore-{h.hexdigest()[:16]}")


def build(compiler: Optional[str] = None) -> tuple[str, float]:
    """Compile the library with `compiler` (``g++`` by default) if it is
    not built yet; returns (library path, build seconds, 0.0 when it was
    there). Raises RuntimeError with the compiler's output on a failure."""
    compiler = CXX if compiler is None else compiler
    out_dir = _build_dir(compiler)
    lib = os.path.join(out_dir, "libgraphcore.so")
    if os.path.exists(lib):
        return lib, 0.0
    os.makedirs(kernels.BUILD_ROOT, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_ROOT) as tmp_dir:
        tmp = os.path.join(tmp_dir, "libgraphcore.so")
        cmd = [compiler, *CXX_FLAGS, "-o", tmp, SOURCE]
        try:
            run = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"graphcore build failed: {' '.join(cmd)}: "
                               f"{e}") from e
        if run.returncode != 0:
            raise RuntimeError(f"graphcore build failed ({run.returncode}): "
                               f"{' '.join(cmd)}\n{run.stdout}{run.stderr}")
        os.makedirs(out_dir, exist_ok=True)
        os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


@functools.cache
def library(compiler: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    path, _ = build(compiler)
    lib = ctypes.CDLL(path)
    i64 = ctypes.c_int64
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.bfs_khop.restype = i64
    lib.bfs_khop.argtypes = [p64, p64, i64, i64, i64, i64, p64,
                             ctypes.c_void_p, i64]
    lib.graclus_match.restype = i64
    lib.graclus_match.argtypes = [p64, p64, pd, pd, p64, i64, p64]
    lib.band_extract.restype = i64
    lib.band_extract.argtypes = [pf, i64, i64, i64, pf]
    lib.bcsr_count.restype = i64
    lib.bcsr_count.argtypes = [pf, i64, i64]
    lib.bcsr_extract.restype = None
    lib.bcsr_extract.argtypes = [pf, i64, i64, pf, p32, p32]
    return lib


def bfs_khop(indptr: np.ndarray, indices: np.ndarray, n_nodes: int,
             k_hops: int, n_rows: int, nb: int):
    """K-hop neighborhoods over a CSR adjacency: (table (n_rows,
    max_count) int64, sorted and padded with the row's own index; counts
    (n_rows,) int64)."""
    lib = library()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    counts = np.zeros(n_rows, np.int64)
    max_count = lib.bfs_khop(indptr, indices, n_nodes, k_hops, n_rows, nb,
                             counts, None, 0)
    out = np.empty((n_rows, max_count), np.int64)
    lib.bfs_khop(indptr, indices, n_nodes, k_hops, n_rows, nb, counts,
                 out.ctypes.data_as(ctypes.c_void_p), max_count)
    return out, counts


def graclus_match(indptr, indices, data, weights, visit_order, n_nodes):
    """One level of greedy Graclus matching over a CSR graph: (cluster_id
    (n_nodes,) int64, n_clusters)."""
    cluster_id = np.zeros(n_nodes, np.int64)
    n_clusters = library().graclus_match(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int64),
        np.ascontiguousarray(data, np.float64),
        np.ascontiguousarray(weights, np.float64),
        np.ascontiguousarray(visit_order, np.int64), n_nodes, cluster_id)
    return cluster_id, int(n_clusters)


def band_extract(S: np.ndarray, block_size: int, w: int):
    """The band slab of S at block bandwidth w, (nb, (2w+1)*bs, bs) f32,
    and the smallest block bandwidth covering S's nonzeros."""
    S = np.ascontiguousarray(S, np.float32)
    n = S.shape[0]
    nb = -(-n // block_size)
    out = np.zeros((nb, (2 * w + 1) * block_size, block_size), np.float32)
    max_bw = library().band_extract(S, n, block_size, w, out)
    return out, int(max_bw)


def bcsr_count(S: np.ndarray, block_size: int) -> int:
    """The nonzero (bs x bs) blocks of S (1 for an all-zero S, which keeps
    one zero block)."""
    S = np.ascontiguousarray(S, np.float32)
    return int(library().bcsr_count(S, S.shape[0], block_size))


def bcsr_extract(S: np.ndarray, block_size: int):
    """BCSR tiles of S sorted by (block col, block row): (blocks (nnzb, bs,
    bs) f32, rows (nnzb,) int32, cols (nnzb,) int32)."""
    S = np.ascontiguousarray(S, np.float32)
    n = S.shape[0]
    nnzb = bcsr_count(S, block_size)
    blocks = np.zeros((nnzb, block_size, block_size), np.float32)
    rows = np.zeros(nnzb, np.int32)
    cols = np.zeros(nnzb, np.int32)
    library().bcsr_extract(S, n, block_size, blocks, rows, cols)
    return blocks, rows, cols
