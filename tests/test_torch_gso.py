"""PyTorch port, ops/gso.py: Gso layouts, gshift and gshift_register in
dense, band and bcsr mode, held against the JAX package on the CPU (its
Pallas paths in TPU interpret mode). Tolerance atol = rtol = 1e-5 (f32
sums of the same products in another order)."""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graph_neural_networks_torch.ops import gso as tgso
from graph_neural_networks_torch.ops import spmm as tspmm
from graph_neural_networks_tpu.ops import gso as jgso


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-5, rtol=1e-5)


def _banded(rng, N, half, per_row=4):
    S = np.zeros((N, N))
    for i in range(N):
        js = np.clip(i + rng.integers(-half, half + 1, per_row), 0, N - 1)
        S[i, js] = rng.random(len(js))
    return S / N ** 0.5


def _gsos(S, mode, bs):
    with pltpu.force_tpu_interpret_mode():
        j = jgso.as_gso(S, mode=mode, block_size=bs)
    return j, tgso.as_gso(S, mode=mode, block_size=bs, device="cpu")


# E=2 cases: the second edge feature has another band / block pattern, so
# band re-extracts at a common w and bcsr falls back to the union pattern.
def _edge_features(E, N, seed):
    rng = np.random.default_rng(seed)
    S = [_banded(rng, N, 10)]
    if E == 2:
        S.append(_banded(rng, N, 40))
    return np.stack(S)


@pytest.mark.parametrize("mode", ["dense", "band", "bcsr"])
@pytest.mark.parametrize("E", [1, 2])
def test_layouts_match(mode, E):
    S = _edge_features(E, 90, E)
    j, t = _gsos(S, mode, 16)
    assert (t.n, t.n_edge_features, t.mode) == (j.n, j.n_edge_features, mode)
    np.testing.assert_array_equal(t.S.numpy(), np.asarray(j.S))
    if mode == "band":
        assert t.band_w == j.band_w
        np.testing.assert_array_equal(t.s_band.numpy(), np.asarray(j.s_band))
        np.testing.assert_array_equal(t.s_band_t.numpy(),
                                      np.asarray(j.s_band_t))
    if mode == "bcsr":
        for name in ("blocks", "block_row", "block_col", "blocks_t",
                     "block_row_t", "block_col_t"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)))
        assert t.block_row.dtype == torch.int32


@pytest.mark.parametrize("E", [1, 2])
def test_bcsr_segment_offsets_cached_with_the_layouts(E):
    """Both BCSR layouts carry their segment offsets, built once with
    them: col_start = searchsorted(block_col, arange(nb + 1)), and kept by
    a device move."""
    S = _edge_features(E, 90, E)
    t = tgso.as_gso(S, mode="bcsr", block_size=16, device="cpu")
    nb = -(-90 // 16)
    for cs, bc in ((t.col_start, t.block_col), (t.col_start_t,
                                                 t.block_col_t)):
        assert cs.dtype == torch.int32 and cs.shape == (nb + 1,)
        np.testing.assert_array_equal(
            cs.numpy(), np.searchsorted(bc.numpy(), np.arange(nb + 1)))
    assert t.to("cpu") is t


def test_bcsr_shift_takes_the_cached_offsets(monkeypatch):
    """gshift on a bcsr Gso passes the layout's cached segment offsets to
    every bcsr_matmul, forward (col_start) and backward (col_start_t), and
    its input gradient equals dense mode's."""
    S = _edge_features(1, 90, 3)
    t = tgso.as_gso(S, mode="bcsr", block_size=16, device="cpu")
    seen = []
    orig = tspmm.bcsr_matmul

    def recorder(*a, **kw):
        seen.append(kw.get("col_start"))
        return orig(*a, **kw)
    monkeypatch.setattr(tspmm, "bcsr_matmul", recorder)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 1, 2, 90)).astype(
        np.float32)).requires_grad_()
    ct = torch.from_numpy(rng.standard_normal((3, 1, 2, 90)).astype(
        np.float32))
    (tgso.gshift(t, x) * ct).sum().backward()
    assert len(seen) == 2
    assert seen[0] is t.col_start and seen[1] is t.col_start_t
    xd = x.detach().clone().requires_grad_()
    dense = tgso.as_gso(S, mode="dense", device="cpu")
    (tgso.gshift(dense, xd) * ct).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), xd.grad.numpy(), **TOL)


def test_union_pattern_used_for_differing_edge_features():
    S = _edge_features(2, 90, 2)
    t = tgso.as_gso(S, mode="bcsr", block_size=16, device="cpu")
    _, r0, _ = tspmm.dense_to_bcsr(S[0], 16)
    assert len(t.block_row) > len(r0)   # wider than feature 0's own pattern


@pytest.mark.parametrize("mode", ["dense", "band", "bcsr"])
@pytest.mark.parametrize("E", [1, 2])
def test_gshift_matches_jax(mode, E):
    rng = np.random.default_rng(5)
    N = 90
    S = _edge_features(E, N, 10 + E)
    j, t = _gsos(S, mode, 16)
    x = rng.standard_normal((3, E, 4, N)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jgso.gshift(j, x))
    got = tgso.gshift(t, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode,bs", [
    ("dense", 16), ("band", 16), ("bcsr", 16),
    ("band", 64),    # block size the CUDA register kernel takes: fused path
])
@pytest.mark.parametrize("E", [1, 2])
def test_gshift_register_matches_jax(mode, E, bs):
    rng = np.random.default_rng(6)
    N, K = 150, 4
    S = _edge_features(E, N, 20 + E)
    j, t = _gsos(S, mode, bs)
    x = rng.standard_normal((2, E, 3, N)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jgso.gshift_register(j, x, K))
    got = tgso.gshift_register(t, torch.from_numpy(x), K)
    assert got.shape == (2, E, K, 3, N)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _count_calls(monkeypatch):
    calls = {"band_shift_register": 0, "band_matmul": 0, "bcsr_matmul": 0}
    for name in calls:
        fn = getattr(tspmm, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tspmm, name, counted)
    return calls


@pytest.mark.parametrize("B,G,expect", [
    # rows = B*G: fused register at <= REGISTER_MAX_ROWS, chained above
    (32, 1, {"band_shift_register": 1, "band_matmul": 0, "bcsr_matmul": 0}),
    (33, 64, {"band_shift_register": 0, "band_matmul": 4, "bcsr_matmul": 0}),
])
def test_gshift_register_dispatch(monkeypatch, B, G, expect):
    N, K = 256, 5
    S = _banded(np.random.default_rng(1), N, 60)
    t = tgso.as_gso(S, mode="band", device="cpu")
    calls = _count_calls(monkeypatch)
    x = torch.randn(B, 1, G, N, generator=torch.Generator().manual_seed(0))
    tgso.gshift_register(t, x, K)
    assert calls == expect


@pytest.mark.parametrize("B,chained", [(2048, False), (2049, True)])
def test_gshift_register_dispatch_at_row_limit(monkeypatch, B, chained):
    """Fused at exactly REGISTER_MAX_ROWS rows, chained one row past."""
    assert B - int(chained) == tspmm.REGISTER_MAX_ROWS
    N, K = 256, 3
    t = tgso.as_gso(_banded(np.random.default_rng(1), N, 60), mode="band",
                    device="cpu")
    calls = _count_calls(monkeypatch)
    tgso.gshift_register(t, torch.zeros(B, 1, 1, N), K)
    assert calls == {"band_shift_register": int(not chained),
                     "band_matmul": (K - 1) * int(chained),
                     "bcsr_matmul": 0}


def test_gshift_register_chains_past_the_slab_panel(monkeypatch):
    """A band too wide for the register's shared-memory slab panel
    (register_fits) chains band_matmul, however few the rows."""
    N, K = 1792, 5
    S = _banded(np.random.default_rng(4), N, 6 * 128 + 100)
    t = tgso.as_gso(S, mode="band", device="cpu")
    assert t.band_w >= 6 and not tspmm.register_fits(128, t.band_w)
    calls = _count_calls(monkeypatch)
    x = torch.randn(1, 1, 2, N, generator=torch.Generator().manual_seed(0))
    got = tgso.gshift_register(t, x, K)
    assert calls == {"band_shift_register": 0, "band_matmul": K - 1,
                     "bcsr_matmul": 0}
    want = [x]
    for _ in range(K - 1):
        want.append(want[-1] @ torch.as_tensor(S, dtype=torch.float32))
    torch.testing.assert_close(got, torch.stack(want, dim=2), atol=1e-4,
                               rtol=1e-5)


def test_bcsr_register_chains_bcsr_matmul(monkeypatch):
    S = _banded(np.random.default_rng(2), 256, 60)
    t = tgso.as_gso(S, mode="bcsr", device="cpu")
    calls = _count_calls(monkeypatch)
    tgso.gshift_register(t, torch.zeros(4, 1, 1, 256), 5)
    assert calls == {"band_shift_register": 0, "band_matmul": 0,
                     "bcsr_matmul": 4}


def test_as_gso_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tgso.as_gso(np.eye(8), mode="edge", device="cpu")
