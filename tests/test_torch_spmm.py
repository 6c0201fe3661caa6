"""PyTorch port, ops/spmm.py: host layouts and the kernels' plain versions,
held against the JAX package on the CPU.

Layouts must be bit-identical. The plain versions are compared with the
JAX Pallas kernels run in interpret mode at atol = rtol = 1e-5: both sum
the same f32 products, in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_networks_torch.ops import spmm as tspmm
from graph_neural_networks_tpu.ops import spmm as jspmm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-5, rtol=1e-5)


def _banded(rng, N, half, per_row=5):
    """Random S with nonzeros within `half` of the diagonal."""
    S = np.zeros((N, N))
    for i in range(N):
        js = np.clip(i + rng.integers(-half, half + 1, per_row), 0, N - 1)
        S[i, js] = rng.standard_normal(len(js))
    return S


LAYOUT_CASES = [  # (N, bs, half-bandwidth)
    (96, 16, 20), (90, 16, 40), (300, 32, 5), (256, 128, 200), (64, 16, 0),
]


@pytest.mark.parametrize("no_native", [False, True])
@pytest.mark.parametrize("N,bs,half", LAYOUT_CASES)
def test_layouts_bit_equal(monkeypatch, no_native, N, bs, half):
    if no_native:
        monkeypatch.setenv("GNT_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("GNT_NO_NATIVE", raising=False)
    S = _banded(np.random.default_rng(N + half), N, half)
    jb, jw = jspmm.dense_to_band(S, bs)
    tb, tw = tspmm.dense_to_band(S, bs)
    assert jw == tw and jb.dtype == tb.dtype and np.array_equal(jb, tb)
    assert np.array_equal(jspmm.dense_to_band_at(S, bs, jw + 1),
                          tspmm.dense_to_band_at(S, bs, tw + 1))
    jl, tl = jspmm.dense_to_bcsr(S, bs), tspmm.dense_to_bcsr(S, bs)
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(
        jspmm.dense_to_bcsr_with_pattern(S.T, bs, jl[1], jl[2]),
        tspmm.dense_to_bcsr_with_pattern(S.T, bs, tl[1], tl[2]))
    for a, b in zip(jspmm.bcsr_transpose(*jl), tspmm.bcsr_transpose(*tl)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_layouts_of_zero_matrix():
    S = np.zeros((40, 40))
    for a, b in zip(jspmm.dense_to_bcsr(S, 16), tspmm.dense_to_bcsr(S, 16)):
        assert np.array_equal(a, b)
    (jb, jw), (tb, tw) = jspmm.dense_to_band(S, 16), tspmm.dense_to_band(S, 16)
    assert jw == tw == 0 and np.array_equal(jb, tb)


def test_auto_tiles():
    for n in (100, 128, 256, 384, 512, 640, 1024, 4096):
        assert tspmm.auto_col_tile(n) == jspmm.auto_col_tile(n)
        assert tspmm.auto_col_tile(n, 16) == jspmm.auto_col_tile(n, 16)
    for r in (1, 255, 256, 511, 512, 1023, 1024, 5000):
        assert tspmm.auto_row_tile(r) == jspmm.auto_row_tile(r)


@pytest.mark.parametrize("N,half,col_tile", [
    (96, 20, 1), (96, 20, 2), (96, 20, 4),   # the JAX kernel's column tiles
    (90, 20, 2),                             # ragged N
    (64, 0, 1),                              # w = 0
])
def test_band_matmul_plain_matches_jax(N, half, col_tile):
    rng = np.random.default_rng(7)
    bs, R = 16, 11
    S = _banded(rng, N, half)
    s_band, w = tspmm.dense_to_band(S, bs)
    if half == 0:
        assert w == 0
    x = rng.standard_normal((R, N)).astype(np.float32)
    want = jspmm.band_matmul(jnp.asarray(x), jnp.asarray(s_band), n_cols=N,
                             w=w, block_size=bs, row_tile=8,
                             col_tile=col_tile, interpret=True)
    got = tspmm.band_matmul_plain(torch.from_numpy(x),
                                  torch.from_numpy(s_band), n_cols=N, w=w,
                                  block_size=bs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the wrapper takes the plain path for a CPU tensor and launches nothing
    before = tspmm.band_matmul.launches
    y = tspmm.band_matmul(torch.from_numpy(x), torch.from_numpy(s_band),
                          n_cols=N, w=w, block_size=bs)
    assert torch.equal(y, got) and tspmm.band_matmul.launches == before


@pytest.mark.parametrize("R,N,n_cols,half,w", [
    (1, 96, 96, 20, 2),     # one row: the narrowest row tile on the card
    (17, 90, 90, 20, 2),    # ragged N = n_cols, past a 16-row tile
    (33, 85, 90, 20, 2),    # x narrower than S: its columns past N are 0
    (65, 90, 90, 20, 2),    # one row past the narrow tiles
    (17, 64, 64, 0, 0),     # w = 0: the diagonal blocks only
    (33, 96, 96, 40, 3),    # w = 3
])
def test_band_matmul_plain_matches_jax_at_row_counts(R, N, n_cols, half, w):
    """The plain version against the JAX kernel at the row counts that
    pick the CUDA kernel's tiles (it runs the BCSR mainloop on the band
    slab's blocks), ragged shapes and block bandwidths 0 and 3."""
    rng = np.random.default_rng(R + N + half)
    bs = 16
    s_band, w_got = tspmm.dense_to_band(_banded(rng, n_cols, half), bs)
    assert w_got == w
    x = rng.standard_normal((R, N)).astype(np.float32)
    want = jspmm.band_matmul(jnp.asarray(x), jnp.asarray(s_band),
                             n_cols=n_cols, w=w, block_size=bs, row_tile=8,
                             interpret=True)
    got = tspmm.band_matmul(torch.from_numpy(x), torch.from_numpy(s_band),
                            n_cols=n_cols, w=w, block_size=bs)
    assert got.shape == (R, n_cols)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("N,half,K", [(96, 20, 4), (90, 40, 3), (64, 0, 2)])
def test_band_shift_register_plain_matches_jax(N, half, K):
    rng = np.random.default_rng(11)
    bs, R = 16, 12
    S = _banded(rng, N, half)
    s_band, w = tspmm.dense_to_band(S, bs)
    x = rng.standard_normal((R, N)).astype(np.float32)
    want = jspmm.band_shift_register(jnp.asarray(x), jnp.asarray(s_band),
                                     n_taps=K, n_cols=N, w=w, block_size=bs,
                                     row_tile=8, interpret=True)
    got = tspmm.band_shift_register(torch.from_numpy(x),
                                    torch.from_numpy(s_band), n_taps=K,
                                    n_cols=N, w=w, block_size=bs)
    assert got.shape == (K, R, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _bcsr_case(rng, n_in, n_cols, bs, empty_col):
    nb_in, nb_out = -(-n_in // bs), -(-n_cols // bs)
    pattern = [(r, c) for c in range(nb_out) if c != empty_col
               for r in range(nb_in) if rng.random() < 0.6 or r == c % nb_in]
    rows = np.array([p[0] for p in pattern], np.int32)
    cols = np.array([p[1] for p in pattern], np.int32)
    blocks = rng.standard_normal((len(pattern), bs, bs)).astype(np.float32)
    return blocks, rows, cols


@pytest.mark.parametrize("n_in,n_cols,empty_col", [
    (96, 96, None),      # square
    (90, 90, 2),         # square, ragged N, an empty output column
    (40, 64, 1),         # rectangular, x on its own (ragged) block grid
    (64, 40, None),      # rectangular the other way
])
def test_bcsr_matmul_plain_matches_jax(n_in, n_cols, empty_col):
    rng = np.random.default_rng(n_in + n_cols)
    bs, R = 16, 10
    blocks, rows, cols = _bcsr_case(rng, n_in, n_cols, bs, empty_col)
    x = rng.standard_normal((R, n_in)).astype(np.float32)
    want = jspmm.bcsr_matmul(jnp.asarray(x), jnp.asarray(blocks),
                             jnp.asarray(rows), jnp.asarray(cols),
                             n_cols=n_cols, block_size=bs, row_tile=8,
                             interpret=True)
    got = tspmm.bcsr_matmul(torch.from_numpy(x), torch.from_numpy(blocks),
                            torch.from_numpy(rows), torch.from_numpy(cols),
                            n_cols=n_cols, block_size=bs)
    assert got.shape == (R, n_cols)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if empty_col is not None:
        assert not got[:, empty_col * bs:(empty_col + 1) * bs].any()


@pytest.mark.parametrize("R,n_in,n_cols", [
    (1, 96, 96),         # one row: the narrowest row tile on the card
    (17, 96, 96),        # a served request's rows, past a 16-row tile
    (65, 96, 96),        # one row past the narrow tiles
    (17, 90, 40),        # ragged rectangular: x on its own ragged grid
])
def test_bcsr_matmul_plain_matches_jax_at_row_counts(R, n_in, n_cols):
    """The plain version against the JAX kernel at the row counts that
    pick the CUDA kernel's tiles, with the layout's segment offsets passed
    as a Gso passes them."""
    rng = np.random.default_rng(R + n_in + n_cols)
    bs = 16
    blocks, rows, cols = _bcsr_case(rng, n_in, n_cols, bs, None)
    x = rng.standard_normal((R, n_in)).astype(np.float32)
    want = jspmm.bcsr_matmul(jnp.asarray(x), jnp.asarray(blocks),
                             jnp.asarray(rows), jnp.asarray(cols),
                             n_cols=n_cols, block_size=bs, row_tile=8,
                             interpret=True)
    cs = torch.from_numpy(tspmm.bcsr_col_start(cols, n_cols, bs))
    got = tspmm.bcsr_matmul(torch.from_numpy(x), torch.from_numpy(blocks),
                            torch.from_numpy(rows), torch.from_numpy(cols),
                            n_cols=n_cols, block_size=bs, col_start=cs)
    assert got.shape == (R, n_cols)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_cols,empty_col", [(96, None), (90, 2),
                                              (40, 1)])
def test_bcsr_col_start_is_the_segment_offsets(n_cols, empty_col):
    """bcsr_col_start (numpy, as a Gso caches it, and torch) equals
    searchsorted(block_col, arange(nb + 1)), the JAX kernel's offsets: an
    empty column has an empty segment."""
    bs = 16
    _, _, cols = _bcsr_case(np.random.default_rng(n_cols), 64, n_cols, bs,
                            empty_col)
    nb = -(-n_cols // bs)
    want = np.searchsorted(cols, np.arange(nb + 1))
    got = tspmm.bcsr_col_start(cols, n_cols, bs)
    assert got.dtype == np.int32 and got.shape == (nb + 1,)
    np.testing.assert_array_equal(got, want)
    got_t = tspmm.bcsr_col_start(torch.from_numpy(cols), n_cols, bs)
    assert got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), want)
    if empty_col is not None:
        assert got[empty_col] == got[empty_col + 1]


def test_bcsr_matmul_of_graph_matches_dense():
    rng = np.random.default_rng(3)
    S = _banded(rng, 100, 30)
    blocks, rows, cols = tspmm.dense_to_bcsr(S, 16)
    x = rng.standard_normal((6, 100)).astype(np.float32)
    got = tspmm.bcsr_matmul(torch.from_numpy(x), torch.from_numpy(blocks),
                            torch.from_numpy(rows), torch.from_numpy(cols),
                            n_cols=100, block_size=16)
    np.testing.assert_allclose(got.numpy(), x @ S.astype(np.float32), **TOL)


def test_wrappers_check_shapes():
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError):
        tspmm.band_matmul(x, torch.zeros(2, 48, 16), n_cols=64, w=1,
                          block_size=16)
    with pytest.raises(ValueError):
        tspmm.band_shift_register(x, torch.zeros(4, 48, 16), n_taps=3,
                                  n_cols=48, w=1, block_size=16)
    with pytest.raises(ValueError):
        tspmm.bcsr_matmul(x, torch.zeros(3, 16, 16),
                          torch.zeros(2, dtype=torch.int32),
                          torch.zeros(3, dtype=torch.int32), n_cols=64,
                          block_size=16)
    with pytest.raises(ValueError, match="col_start"):
        tspmm.bcsr_matmul(x, torch.zeros(3, 16, 16),
                          torch.zeros(3, dtype=torch.int32),
                          torch.zeros(3, dtype=torch.int32), n_cols=64,
                          block_size=16,
                          col_start=torch.zeros(4, dtype=torch.int32))


def test_register_fit_rule():
    assert tspmm.register_fits(128, 1) and tspmm.register_fits(64, 1)
    assert not tspmm.register_fits(16, 1)
    # measured on the H100 (chip_smoke.py register_sweep, PERF.md): the
    # register beats chained band_matmul at every swept row count to 2048
    assert tspmm.REGISTER_MAX_ROWS == 2048


@pytest.mark.parametrize("bs,w,fits", [
    (128, 1, True), (128, 2, True), (128, 5, True),   # 84, 116, 212 KB
    (128, 6, False),                                  # 244 KB > 227 KB
    (64, 11, True), (64, 12, False), (16, 0, False),
])
def test_register_fits_slab_panel(bs, w, fits):
    """The CUDA register keeps a (2w+1)*bs x 32 slab panel and two staged
    (128, 32 + 4) slices in one block's 227 KB of shared memory."""
    assert tspmm.register_smem_bytes(bs, w) == 4 * (
        (2 * w + 1) * bs * 32 + 2 * 128 * 36)
    assert tspmm.register_fits(bs, w) is fits
