"""PyTorch port, ops/gridwin.py: the plain versions of the three cell-grid
kernels, held against the JAX package's Pallas kernels run in interpret
mode on the CPU.

Tables, selected ids, val and cnt must be equal bit for bit. The masked
sums (states, wv, wpay) are f32 sums of the same terms (up to 45 of them
here) in another order, so they may differ by a few ulps of the largest
term, which can exceed a 1e-7-relative share of a sum that cancels: held
per output column to rtol 1e-6, atol 1e-6 * max|column| (the 1/d^2 state
terms put the columns on different scales).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_networks_torch.ops import gridwin as tgw
from graph_neural_networks_tpu.data import flocking as jF
from graph_neural_networks_tpu.ops import gridwin as jgw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


R_RADIUS = 2.0


def _swarm(rng, n, extent, cluster_at=None):
    """n agents uniform in [-extent, extent]^2, plus a 6 x 6 cluster of
    spacing 0.25 centered on the cell corner `cluster_at` (every member has
    at least 35 neighbors, more than d_max = 32; 9 in each of the corner's
    cells), plus pairs exactly at d^2 = r^2."""
    pos = rng.uniform(-extent, extent, (2, n))
    extra = [np.array([[0.5, 0.5], [0.5, 2.5]]).T,       # d = 2 in y
             np.array([[-3.0, 1.0], [-1.0, 1.0]]).T]     # d = 2 in x
    if cluster_at is not None:
        g = 0.25 * np.arange(6) - 0.625
        gx, gy = np.meshgrid(g, g)
        extra.append(np.stack([cluster_at[0] + gx.ravel(),
                               cluster_at[1] + gy.ravel()]))
    pos = np.concatenate([pos] + extra, axis=1).astype(np.float32)
    vel = rng.normal(size=pos.shape).astype(np.float32)
    return pos, vel


def _windows(pos, cx, cy, Gx, Gy, factor, inv_s):
    """(h9 (N, n_win), keep (N, n_win)) in the JAX window order."""
    if factor == 1:
        offs = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
        ax, ay = cx, cy
    else:
        offs = [(dx, dy) for dx in (0, 1) for dy in (0, 1)]
        ax = np.floor(pos[0] * np.float32(inv_s)
                      - np.float32(1.0 / factor)).astype(np.int32)
        ay = np.floor(pos[1] * np.float32(inv_s)
                      - np.float32(1.0 / factor)).astype(np.int32)
    offs = np.array(offs)
    h9 = (np.remainder(ax[:, None] + offs[:, 0], Gx)
          + Gx * np.remainder(ay[:, None] + offs[:, 1], Gy)).astype(np.int32)
    n_win = len(offs)
    keep = np.ones(h9.shape, bool)
    for w in range(n_win):
        for w2 in range(w):
            keep[:, w] &= h9[:, w] != h9[:, w2]
    return h9, keep


def _case(seed, factor, C, n_pay, table_size=None, extent=9.0,
          cluster=True):
    """A table from the JAX scatter build and each agent's windows."""
    rng = np.random.default_rng(seed)
    pos, vel = _swarm(rng, 150, extent,
                      cluster_at=(4.0, 4.0) if cluster else None)
    N = pos.shape[1]
    H, Gx, Gy, Cc = jF._grid_geometry(N, table_size, C, factor)
    inv_s = 1.0 / (factor * R_RADIUS)
    v = rng.normal(size=N).astype(np.float32)
    pay = (jnp.asarray(rng.normal(size=(N, n_pay)), jnp.float32)
           if n_pay else None)
    table, cx, cy, ok, _ = jF._grid_build_table(
        *(jnp.asarray(a) for a in (pos[0], pos[1], vel[0], vel[1])), inv_s,
        H, Gx, Gy, Cc, v=jnp.asarray(v), pay=pay, builder="scatter")
    h9, keep = _windows(pos, np.asarray(cx), np.asarray(cy), Gx, Gy, factor,
                        inv_s)
    return dict(table=np.asarray(table), pos=pos, vel=vel, h9=h9, keep=keep,
                C=Cc, N=N, ok=bool(ok))


def _run_both(case, r2, d_max, n_pay, wv_only=False):
    table, pos, vel = case["table"], case["pos"], case["vel"]
    h9, keep, C, N = case["h9"], case["keep"], case["C"], case["N"]
    n_win = h9.shape[1]
    ids = np.arange(N, dtype=np.float32)
    own128 = np.zeros((N, 128), np.float32)
    own128[:, :5] = np.stack([pos[0], pos[1], vel[0], vel[1], ids], 1)
    own128[:, 5:5 + n_win] = keep
    cand = table[h9.T]                                 # (n_win, N, W)
    want = np.asarray(jgw.grid_window(
        jnp.asarray(cand), jnp.asarray(own128), C=C, r2=r2, d_max=d_max,
        wv_only=wv_only, n_pay=n_pay, interpret=True))
    got = tgw.grid_window(
        torch.tensor(table), torch.tensor(own128[:, :5]),
        torch.tensor(h9), torch.tensor(keep), C=C, r2=r2, d_max=d_max,
        wv_only=wv_only, n_pay=n_pay).numpy()
    return got, want


def _assert_sums(got, want):
    """Per column: |got - want| <= 1e-6 |want| + 1e-6 max|want column|."""
    scale = np.abs(want).max(axis=0, keepdims=True)
    np.testing.assert_array_less(np.abs(got - want),
                                 1e-6 * (np.abs(want) + scale) + 1e-30)


WINDOW_CASES = [  # (cell factor, C, n_pay, d_max)
    (2, 32, 0, 32), (2, 32, 18, 32), (2, 32, 18, 0), (2, 32, 12, 32),
    (1, 16, 0, 32), (1, 16, 12, 0), (1, 16, 5, 32),
]


@pytest.mark.parametrize("factor,C,n_pay,d_max", WINDOW_CASES)
def test_grid_window_plain_matches_pallas(factor, C, n_pay, d_max):
    case = _case(factor + C + n_pay, factor, C, n_pay)
    assert case["ok"]
    got, want = _run_both(case, R_RADIUS ** 2, d_max, n_pay)
    D = d_max
    assert got.shape == (case["N"], tgw._out_width(D, n_pay))
    np.testing.assert_array_equal(got[:, :2 * D], want[:, :2 * D])   # idx, val
    np.testing.assert_array_equal(got[:, 2 * D + 7], want[:, 2 * D + 7])
    _assert_sums(got[:, 2 * D:2 * D + 7], want[:, 2 * D:2 * D + 7])
    _assert_sums(got[:, 2 * D + 8:], want[:, 2 * D + 8:2 * D + 8 + n_pay])
    cnt = got[:, 2 * D + 7]
    # the cluster's members see more than d_max neighbors; every other
    # agent fills exactly its in-degree's worth of slots
    assert cnt.max() > 32
    if D:
        np.testing.assert_array_equal(got[:, D:2 * D].sum(1),
                                      np.minimum(cnt, D))


@pytest.mark.parametrize("factor,C", [(2, 32), (1, 16)])
def test_grid_window_wv_only_matches_pallas(factor, C):
    case = _case(7, factor, C, 0)
    got, want = _run_both(case, R_RADIUS ** 2, 32, 0, wv_only=True)
    assert got.shape == (case["N"], 1)
    _assert_sums(got[:, 0:1], want[:, 0:1])
    full, _ = _run_both(case, R_RADIUS ** 2, 32, 0)
    np.testing.assert_allclose(got[:, 0], full[:, 2 * 32 + 6], rtol=1e-6,
                               atol=1e-6)


def test_grid_window_boundary_pairs_are_neighbors():
    """Agents at exactly d^2 = r^2 are in range (d2 <= r2), on both
    implementations."""
    case = _case(3, 2, 32, 0, cluster=False)
    got, want = _run_both(case, R_RADIUS ** 2, 32, 0)
    N = case["N"]
    for a, b in ((N - 4, N - 3), (N - 2, N - 1)):
        d = case["pos"][:, a] - case["pos"][:, b]
        assert float(np.float32(d[0] * d[0]) + np.float32(d[1] * d[1])) == 4.0
        for out in (got, want):
            assert b in out[a, :32][out[a, 32:64] > 0]
            assert a in out[b, :32][out[b, 32:64] > 0]


@pytest.mark.parametrize("factor,table_size", [(1, 4), (2, 2)])
def test_grid_window_aliased_windows_counted_once(factor, table_size):
    """A table so small that the modular map aliases an agent's windows:
    keep drops the repeats, so no candidate counts twice."""
    C = 64 if factor == 1 else 128
    case = _case(5, factor, C, 0, table_size=table_size, extent=3.0,
                 cluster=False)
    assert case["ok"] and not case["keep"].all()
    got, want = _run_both(case, R_RADIUS ** 2, 32, 0)
    np.testing.assert_array_equal(got[:, :64], want[:, :64])
    np.testing.assert_array_equal(got[:, 71], want[:, 71])
    _assert_sums(got[:, 64:71], want[:, 64:71])
    # the in-degree is the true one, from the dense distances
    pos = case["pos"]
    d = pos[:, :, None] - pos[:, None, :]
    d2 = d[0] * d[0] + d[1] * d[1]
    deg = ((d2 <= 4.0) & ~np.eye(case["N"], dtype=bool)).sum(0)
    np.testing.assert_array_equal(got[:, 71], deg)


def test_grid_window_exp_test_above_its_bound():
    """r^2 above -ln(1e-9) (~20.7) turns the exp(-d2) > 1e-9 test on: both
    implementations drop the candidates between the two bounds."""
    # a 2x2-slot table that every agent's windows cover whole: all agents
    # are candidates of all
    case = _case(9, 2, 64, 0, table_size=4, extent=4.0, cluster=False)
    assert case["ok"] and case["keep"].all()
    r2 = 25.0
    got, want = _run_both(case, r2, 0, 0)
    np.testing.assert_array_equal(got[:, 7], want[:, 7])
    _assert_sums(got[:, :7], want[:, :7])
    pos = case["pos"]
    d = pos[:, :, None] - pos[:, None, :]
    d2 = (d[0] * d[0] + d[1] * d[1]).astype(np.float32)
    within = (d2 <= r2) & ~np.eye(case["N"], dtype=bool)
    assert (within & (d2 > 20.8)).any()          # the test has work to do
    kept = within & (np.exp(-d2.astype(np.float64)) > 1e-9)
    np.testing.assert_array_equal(got[:, 7], kept.sum(0))


def _sorted_features(rng, N, F, H, max_run):
    """fs (N, F) rows of agents sorted by cell and starts (H+1,): random
    runs of at most max_run members (some cells empty)."""
    counts = rng.integers(0, max_run + 1, H)
    counts[rng.random(H) < 0.3] = 0
    while counts.sum() != N:
        h = rng.integers(0, H)
        if counts.sum() < N and counts[h] < max_run:
            counts[h] += 1
        elif counts.sum() > N and counts[h] > 0:
            counts[h] -= 1
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    fs = rng.normal(size=(N, F)).astype(np.float32)
    return fs, starts


@pytest.mark.parametrize("C,F,H", [(32, 7, 32), (32, 25, 32), (16, 19, 64)])
def test_table_build_plain_matches_pallas(C, F, H):
    rng = np.random.default_rng(C + F + H)
    N = 300
    fs, starts = _sorted_features(rng, N, F, H, max_run=C)
    assert np.diff(starts).max() <= C
    # a 4-cell tile keeps the interpreted kernel's unrolled body small
    fs_pad = np.zeros((N + jgw.table_build_pad_rows(C, 4), 128), np.float32)
    fs_pad[:N, :F] = fs
    want = np.asarray(jgw.table_build(jnp.asarray(fs_pad),
                                      jnp.asarray(starts), C=C, F=F,
                                      tile_h=4, interpret=True))
    got = tgw.table_build(torch.tensor(fs)[None],
                          torch.tensor(starts)[None], C=C)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_table_build_overflow_keeps_first_members():
    """Cells with more members than C keep their first C sorted members:
    the port's table_build equals JAX's gather build there. JAX's fused
    build (gridwin.py:265) is held to this only when no cell overflows: on
    overflow its fixed per-tile window can read past the tile and write
    other rows (ROADMAP queue 3), which the port does not copy."""
    rng = np.random.default_rng(2)
    N, C = 400, 4
    pos = rng.uniform(-6, 6, (2, N)).astype(np.float32)
    vel = rng.normal(size=(2, N)).astype(np.float32)
    H, Gx, Gy, _ = jF._grid_geometry(N, 64, C, 1)
    args = [jnp.asarray(a) for a in (pos[0], pos[1], vel[0], vel[1])]
    table, _, _, ok, (order, _) = jF._grid_build_table(
        *args, 1.0 / R_RADIUS, H, Gx, Gy, C, builder="gather")
    assert not bool(ok)
    # the sorted feature rows and run starts the JAX build used
    order = np.asarray(order)
    cx = np.floor(pos[0] * np.float32(0.5)).astype(np.int32)
    cy = np.floor(pos[1] * np.float32(0.5)).astype(np.int32)
    hs = (np.remainder(cx, Gx) + Gx * np.remainder(cy, Gy))[order]
    feats = np.stack([pos[0], pos[1], vel[0], vel[1], np.ones(N),
                      np.arange(N), np.zeros(N)], 1).astype(np.float32)
    starts = np.searchsorted(hs, np.arange(H + 1)).astype(np.int32)
    assert np.diff(starts).max() > C
    got = tgw.table_build(torch.tensor(feats[order])[None],
                          torch.tensor(starts)[None], C=C)[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(table))


@pytest.mark.parametrize("C,F,H", [(16, 7, 8), (32, 25, 4), (8, 40, 4)])
def test_table_transpose_plain_matches_pallas(C, F, H):
    rng = np.random.default_rng(C * F)
    mm = np.zeros((H * C, 128), np.float32)
    mm[:, :F] = rng.normal(size=(H * C, F))
    want = np.asarray(jgw.table_transpose(jnp.asarray(mm), C=C, F=F,
                                          interpret=True))
    got = tgw.table_transpose(torch.tensor(mm), C=C, F=F).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (H, tgw.table_width(F, C))
    # the port's own operand width: (H*C, F) rows
    got_f = tgw.table_transpose(torch.tensor(mm[:, :F].copy()), C=C,
                                F=F).numpy()
    np.testing.assert_array_equal(got_f, want)


@pytest.mark.parametrize("C,F,H", [
    (3, 5, 37),    # C*F = 15 floats a cell: spans not 16-byte aligned
    (32, 25, 13),  # the served C, F; H not a multiple of the kernel's run
])
def test_table_transpose_plain_unaligned_and_ragged(C, F, H):
    rng = np.random.default_rng(H)
    mm = np.zeros((H * C, 128), np.float32)
    mm[:, :F] = rng.normal(size=(H * C, F))
    want = np.asarray(jgw.table_transpose(jnp.asarray(mm), C=C, F=F,
                                          interpret=True))
    got = tgw.table_transpose_plain(torch.tensor(mm[:, :F].copy()), C=C,
                                    F=F).numpy()
    np.testing.assert_array_equal(got, want)


EDGE_CASES = [  # (cell factor, C, n_pay, d_max, wv_only, table_size)
    (2, 32, 18, 0, False, None), (2, 32, 0, 0, True, None),
    (1, 16, 25, 32, False, None),      # 33 output sums, more than lanes
    (1, 8, 0, 32, False, None),        # the cluster's cells overflow C = 8
    (1, 64, 12, 32, False, 4),         # aliased windows, with a payload
]


@pytest.mark.parametrize("factor,C,n_pay,d_max,wv_only,table_size",
                         EDGE_CASES)
def test_grid_window_plain_matches_pallas_edge_cases(
        factor, C, n_pay, d_max, wv_only, table_size):
    """The cases the CUDA kernel's layout makes special (more output sums
    than a warp has lanes, an overflowing cell, aliased windows with a
    payload) and the served eval and lambda-pass shapes, against the JAX
    kernel."""
    small = table_size is not None
    case = _case(60 + factor + C + n_pay, factor, C, n_pay,
                 table_size=table_size, extent=3.0 if small else 9.0,
                 cluster=not small)
    assert case["ok"] == (C != 8)
    if small:
        assert not case["keep"].all()
    got, want = _run_both(case, R_RADIUS ** 2, d_max, n_pay,
                          wv_only=wv_only)
    if wv_only:
        assert got.shape == (case["N"], 1)
        _assert_sums(got[:, 0:1], want[:, 0:1])
        return
    D = d_max
    assert got.shape == (case["N"], tgw._out_width(D, n_pay))
    np.testing.assert_array_equal(got[:, :2 * D], want[:, :2 * D])
    np.testing.assert_array_equal(got[:, 2 * D + 7], want[:, 2 * D + 7])
    _assert_sums(got[:, 2 * D:2 * D + 7], want[:, 2 * D:2 * D + 7])
    _assert_sums(got[:, 2 * D + 8:], want[:, 2 * D + 8:2 * D + 8 + n_pay])
