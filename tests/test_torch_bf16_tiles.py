"""PyTorch port, the tensor-core tiles of the bf16 graph shift: the bf16
plain versions of kernels 1-3 (what the wrappers run on the CPU) against
the JAX Pallas kernels in bf16 (interpret mode) at the edges of the CUDA
tiles, and the bf16 register's fit rule against the f32 one.

The CUDA bf16 instances cut their work in m16 row tiles (16, 32 and 64-row
narrow tiles up to 64 rows, 128-row wide ones above), stage x by 16-byte
copies only when N % 8 == 0, and write zeros for an empty BCSR segment. So
the cases here are R in {1, 16, 17, 64, 65, 129} (each side of every row
limit), N = 256 (16-byte staging), 252 (N % 8 == 4: element-wise staging
on the card) and 251 (odd), a BCSR layout with an empty block column, and
the register at K = 2 and 5, all at block size 64 (the kernels' K-step).
Each row of a shift depends only on that row of x, so the JAX kernel runs
once a case on 129 rows and each R is held against its first R rows.

Tolerances, with the bf16 ulp of a value v taken as 2^(floor(log2|v|) - 7)
(8 significant bits), as in tests/test_torch_bf16.py:
  * band_matmul and bcsr_matmul (one rounding of an f32 accumulator, as
    JAX): 2 ulps of the larger of the two values, per element;
  * the register: tap k (k >= 1) within k + 1 ulps of the tap's largest
    magnitude (each tap is rounded before the next reads it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_networks_torch.ops import spmm as tspmm
from graph_neural_networks_tpu.ops import spmm as jspmm
from tests.test_torch_bf16 import _bf16, _f64, _j, _ulps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BS = 64
ROWS = (1, 16, 17, 64, 65, 129)
NS = (256, 252, 251)
TAPS = (2, 5)


def _banded(rng, n, half=90):
    S = np.zeros((n, n))
    for i in range(n):
        js = np.clip(i + rng.integers(-half, half + 1, 5), 0, n - 1)
        S[i, js] = rng.standard_normal(5)
    return S


@pytest.fixture(scope="module")
def band_cases():
    """N -> (x (129, N), s_band, w, JAX band_matmul of x, {K: JAX
    register of x})."""
    cases = {}
    for n in NS:
        rng = np.random.default_rng(n)
        s_band, w = tspmm.dense_to_band(_banded(rng, n), BS)
        x, s_band = (_bf16(rng.standard_normal((max(ROWS), n))),
                     _bf16(s_band))
        y = jspmm.band_matmul(_j(x), _j(s_band), n_cols=n, w=w, block_size=BS,
                              row_tile=64, interpret=True)
        taps = {K: jspmm.band_shift_register(
            _j(x), _j(s_band), n_taps=K, n_cols=n, w=w, block_size=BS,
            row_tile=64, interpret=True) for K in TAPS}
        cases[n] = (x, s_band, w, y, taps)
    return cases


@pytest.fixture(scope="module")
def bcsr_cases():
    """N -> (x (129, N), the layout with block column 1 empty, JAX
    bcsr_matmul of x)."""
    cases = {}
    for n in NS:
        rng = np.random.default_rng(n + 1)
        blocks, rows, cols = tspmm.dense_to_bcsr(_banded(rng, n), BS)
        keep = cols != 1
        blocks, rows, cols = blocks[keep], rows[keep], cols[keep]
        x = _bf16(rng.standard_normal((max(ROWS), n)))
        blocks = _bf16(blocks)
        y = jspmm.bcsr_matmul(_j(x), _j(blocks), jnp.asarray(rows),
                              jnp.asarray(cols), n_cols=n, block_size=BS,
                              row_tile=64, interpret=True)
        cases[n] = (x, blocks, torch.from_numpy(rows), torch.from_numpy(cols),
                    y)
    return cases


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("R", ROWS)
def test_band_matmul_bf16_tile_edges(band_cases, R, n):
    x, s_band, w, want, _ = band_cases[n]
    got = tspmm.band_matmul(x[:R], s_band, n_cols=n, w=w, block_size=BS)
    assert got.dtype == torch.bfloat16 and got.shape == (R, n)
    assert _ulps(got, want[:R]).max() <= 2


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("R", ROWS)
def test_bcsr_matmul_bf16_tile_edges(bcsr_cases, R, n):
    x, blocks, rows, cols, want = bcsr_cases[n]
    got = tspmm.bcsr_matmul(x[:R], blocks, rows, cols, n_cols=n,
                            block_size=BS)
    assert got.dtype == torch.bfloat16 and got.shape == (R, n)
    assert _ulps(got, want[:R]).max() <= 2
    # the empty segment (block column 1) writes zeros
    assert not (cols == 1).any()
    assert bool((got[:, BS:2 * BS] == 0).all())


@pytest.mark.parametrize("K", TAPS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("R", ROWS)
def test_band_shift_register_bf16_tile_edges(band_cases, R, n, K):
    x, s_band, w, _, taps = band_cases[n]
    want = taps[K]
    got = tspmm.band_shift_register(x[:R], s_band, n_taps=K, n_cols=n, w=w,
                                    block_size=BS)
    assert got.dtype == torch.bfloat16 and got.shape == (K, R, n)
    assert torch.equal(got[0], x[:R])
    for k in range(1, K):
        scale = np.abs(_f64(want[k][:R])).max()
        assert _ulps(got[k], want[k][:R], scale).max() <= k + 1, k


@pytest.mark.parametrize("bs", [64, 128])
def test_register_fits_bf16_admits_every_f32_layout(bs):
    """The bf16 register's fallback tile (a 32-column panel of 40-element
    bf16 rows, two staged (128, 72) bf16 slices) takes less shared memory
    than the f32 kernel's tile, so the bf16 rule admits every layout the f32
    one does (gso.gshift_register fuses by the f32 rule in either dtype)."""
    f32_max = max(w for w in range(64) if tspmm.register_fits(bs, w))
    assert f32_max == {64: 11, 128: 5}[bs]
    for w in range(f32_max + 1):
        assert tspmm.register_fits(bs, w, torch.bfloat16), w
        assert (tspmm.register_smem_bytes(bs, w, torch.bfloat16)
                < tspmm.register_smem_bytes(bs, w))
    assert tspmm.register_smem_bytes(bs, 1, torch.bfloat16) == 2 * (
        3 * bs * 40 + 2 * 128 * 72)
    bf16_max = max(w for w in range(64)
                   if tspmm.register_fits(bs, w, torch.bfloat16))
    assert bf16_max == {64: 18, 128: 9}[bs]
    assert not tspmm.register_fits(16, 0, torch.bfloat16)
