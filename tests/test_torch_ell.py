"""PyTorch port, ops/ell.py, the delayed filters of ops/filters.py and
LocalGNN_DB's full-history forward, held against the JAX package on the
CPU with the same inputs (made with numpy from a seed) and weights
(carried across by load_flax_params).

Tolerance: rtol = atol = 1e-4 (f32 sums over D neighbours, K taps and the
readout, taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from graph_neural_networks_torch.models import architectures_time as tarcht
from graph_neural_networks_torch.ops import ell as tell
from graph_neural_networks_torch.ops import filters as tfilt
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu.models import architectures_time as jarcht
from graph_neural_networks_tpu.ops import ell as jell
from graph_neural_networks_tpu.ops import filters as jfilt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)


def _stack(seed, lead, E, N, p=0.25):
    """A random sparse GSO stack (*lead, E, N, N), no self loops."""
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=lead + (1, N, N)) < p
    mask &= ~np.eye(N, dtype=bool)
    return (rng.normal(size=lead + (E, N, N)) * mask).astype(np.float32)


def _both(S, d_max=None):
    """The JAX EllGso of S and the port's, from the JAX conversion."""
    j = jell.ell_from_dense(S, d_max=d_max)
    t = tell.EllGso(torch.tensor(np.asarray(j.idx)),
                    torch.tensor(np.asarray(j.val)))
    return j, t


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("E", [1, 2])
def test_ell_from_dense_and_to_dense_match_jax(E):
    S = _stack(0, (2, 3), E, 12)
    j = jell.ell_from_dense(S)
    t = tell.ell_from_dense(S)
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
    np.testing.assert_array_equal(t.val.numpy(), np.asarray(j.val))
    assert (t.n, t.d, t.n_edge_features) == (12, j.d, E)
    np.testing.assert_array_equal(tell.ell_to_dense(t), S)
    np.testing.assert_array_equal(tell.ell_to_dense(t), jell.ell_to_dense(j))
    # a capped table keeps the same top entries as the JAX one
    jc = jell.ell_from_dense(S, d_max=2)
    tc = tell.ell_from_dense(S, d_max=2)
    np.testing.assert_array_equal(tc.idx.numpy(), np.asarray(jc.idx))


@pytest.mark.parametrize("E,G", [(1, 5), (2, 3)])
def test_ell_shift_rows_forward_and_grad_match_jax_and_dense(E, G):
    B, N = 3, 20
    S = _stack(1, (B,), E, N)
    j, t = _both(S)
    rng = np.random.default_rng(2)
    xr = rng.normal(size=(B, N, E, G)).astype(np.float32)
    gy = rng.normal(size=(B, N, E, G)).astype(np.float32)
    want = jell.ell_shift_rows(jnp.asarray(xr), j)
    x_t = _t(xr).requires_grad_(True)
    got = tell.ell_shift_rows(x_t, t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    dense = np.einsum("bnec,benm->bmec", xr, S)
    np.testing.assert_allclose(got.detach().numpy(), dense, **TOL)
    got.backward(_t(gy))
    jgx = jax.grad(lambda x: jnp.sum(jell.ell_shift_rows(x, j) * gy))(
        jnp.asarray(xr))
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(jgx), **TOL)
    # the input gradient is the shift by S transposed
    np.testing.assert_allclose(x_t.grad.numpy(),
                               np.einsum("bmec,benm->bnec", gy, S), **TOL)


def test_ell_shift_rows_rectangular_and_lead_axes():
    """Output rows fewer than the gather source's, two leading axes."""
    rng = np.random.default_rng(3)
    Nn, No, D = 30, 11, 4
    idx = rng.integers(0, Nn, size=(2, 3, No, D)).astype(np.int32)
    val = rng.normal(size=(2, 3, 1, No, D)).astype(np.float32)
    xr = rng.normal(size=(2, 3, Nn, 1, 6)).astype(np.float32)
    want = jell.ell_shift_rows(jnp.asarray(xr),
                               jell.EllGso(jnp.asarray(idx), jnp.asarray(val)))
    got = tell.ell_shift_rows(_t(xr), tell.EllGso(_t(idx), _t(val)))
    assert tuple(got.shape) == (2, 3, No, 1, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("E", [1, 2])
def test_ell_shift_matches_jax(E):
    B, T, G, N = 2, 3, 4, 16
    S = _stack(4, (B, T), E, N)
    j, t = _both(S)
    x = np.random.default_rng(5).normal(size=(B, T, E, G, N)).astype(
        np.float32)
    want = jell.ell_shift(jnp.asarray(x), j)
    got = tell.ell_shift(_t(x), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.einsum("btegn,btenm->btegm", x, S), **TOL)


def test_ell_shift_rows_saves_no_gathered_rows():
    """The backward keeps idx and val only: no tensor of the gathered
    (No*D, E*G) size is saved for it."""
    B, N, D, C = 2, 50, 8, 6
    rng = np.random.default_rng(6)
    idx = _t(rng.integers(0, N, size=(B, N, D)).astype(np.int32))
    val = _t(rng.normal(size=(B, 1, N, D)).astype(np.float32))
    x = torch.randn(B, N, 1, C, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        y = tell.ell_shift_rows(x, tell.EllGso(idx, val))
    assert (B, N, D) in saved and (B, 1, N, D) in saved
    assert all(int(np.prod(s)) < B * N * D * C for s in saved), saved
    y.sum().backward()
    assert x.grad is not None
    # the table is data: a val that requires grad is refused
    with pytest.raises(ValueError, match="signal only"):
        tell.ell_shift_rows(x, tell.EllGso(idx, val.requires_grad_(True)))


@pytest.mark.parametrize("E,K,G,F", [(1, 3, 6, 8), (2, 2, 3, 5),
                                     (1, 1, 4, 3)])
def test_lsigf_db_ell_and_dense_match_jax(E, K, G, F):
    B, T, N = 2, 6, 14
    S = _stack(7, (B, T), E, N)
    j, t = _both(S)
    rng = np.random.default_rng(8)
    h = rng.normal(size=(F, E, K, G)).astype(np.float32)
    b = rng.normal(size=(F, 1)).astype(np.float32)
    x = rng.normal(size=(B, T, G, N)).astype(np.float32)
    want = np.asarray(jfilt.lsigf_db(jnp.asarray(h), j, jnp.asarray(x),
                                     jnp.asarray(b)))
    want_dense = np.asarray(jfilt.lsigf_db(jnp.asarray(h), jnp.asarray(S),
                                           jnp.asarray(x), jnp.asarray(b)))
    np.testing.assert_allclose(want, want_dense, **TOL)
    got = tfilt.lsigf_db(_t(h), t, _t(x), _t(b))
    got_dense = tfilt.lsigf_db(_t(h), _t(S), _t(x), _t(b))
    assert tuple(got.shape) == (B, T, F, N)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got_dense.numpy(), want_dense, **TOL)


def test_lsigf_db_ell_gradient_matches_jax_and_dense():
    B, T, E, K, G, F, N = 2, 5, 1, 3, 4, 6, 12
    S = _stack(9, (B, T), E, N)
    j, t = _both(S)
    rng = np.random.default_rng(10)
    h = rng.normal(size=(F, E, K, G)).astype(np.float32)
    x = rng.normal(size=(B, T, G, N)).astype(np.float32)
    cot = rng.normal(size=(B, T, F, N)).astype(np.float32)
    jgh, jgx = jax.grad(lambda h_, x_: jnp.sum(jfilt.lsigf_db(h_, j, x_)
                                               * cot), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(x))
    for graph in (t, _t(S)):
        h_t = _t(h).requires_grad_(True)
        x_t = _t(x).requires_grad_(True)
        (tfilt.lsigf_db(h_t, graph, x_t) * _t(cot)).sum().backward()
        np.testing.assert_allclose(h_t.grad.numpy(), np.asarray(jgh), **TOL)
        np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(jgx), **TOL)


def _transplanted(dims, taps, seed):
    jnet = jarcht.LocalGNN_DB(dims, taps, True, "tanh", [2], 1)
    params = jnet.init(jax.random.PRNGKey(seed), N=16, T=3)
    tnet = tarcht.LocalGNN_DB(dims, taps, True, "tanh", [2], 1,
                              device="cpu")
    load_flax_params(tnet, jax.tree_util.tree_map(np.asarray,
                                                  unfreeze(params)))
    return jnet, params, tnet


@pytest.mark.parametrize("graph", ["ell", "dense4", "dense5"])
def test_local_gnn_db_forward_matches_jax(graph):
    """split_forward with transplanted flax params, 2 layers, over an
    EllGso, a 4-d (B,T,N,N) stack and a 5-d one."""
    jnet, params, tnet = _transplanted([6, 8, 5], [3, 2], 11)
    B, T, N = 2, 7, 16
    S = np.abs(_stack(12, (B, T), 1, N))
    j, t = _both(S)
    x = np.random.default_rng(13).normal(size=(B, T, 6, N)).astype(
        np.float32)
    jS, tS = {"ell": (j, t), "dense4": (S[:, :, 0], _t(S[:, :, 0])),
              "dense5": (S, _t(S))}[graph]
    want_y, want_g = jnet.split_forward(params, jnp.asarray(x), jS)
    with torch.no_grad():
        got_y, got_g = tnet.split_forward(_t(x), tS)
    assert tuple(got_y.shape) == (B, T, 2, N)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)
    np.testing.assert_allclose(tnet(_t(x), tS).detach().numpy(),
                               np.asarray(want_y), **TOL)


def test_rollout_step_over_ell_matches_full_history():
    """rollout_step over each step's EllGso reproduces the full-history
    forward at every t, and the JAX rollout_step."""
    jnet, params, tnet = _transplanted([6, 8, 5], [3, 2], 14)
    B, T, N = 2, 6, 16
    S = np.abs(_stack(15, (B, T), 1, N))
    j, t = _both(S)
    x = np.random.default_rng(16).normal(size=(B, T, 6, N)).astype(
        np.float32)
    with torch.no_grad():
        full = tnet(_t(x), t)
        state = tnet.rollout_init(B, N)
        jstate = jnet.rollout_init(params, B, N)
        for k in range(T):
            S_k = t.time_step(k)
            state, y = tnet.rollout_step(state, _t(x[:, k]), S_k)
            jstate, jy = jnet.rollout_step(
                params, jstate, jnp.asarray(x[:, k]),
                jell.EllGso(j.idx[:, k], j.val[:, k]))
            np.testing.assert_allclose(y.numpy(), full[:, k].numpy(), **TOL)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        # a dense per-step graph gives the same steps
        state_d = tnet.rollout_init(B, N)
        for k in range(T):
            state_d, y = tnet.rollout_step(state_d, _t(x[:, k]),
                                           _t(S[:, k, 0]))
        np.testing.assert_allclose(y.numpy(), full[:, -1].numpy(), **TOL)


def test_tap_register_step_matches_jax():
    rng = np.random.default_rng(17)
    F, E, K, G, B, N = 5, 2, 3, 4, 2, 10
    w = rng.normal(size=(F, E, K, G)).astype(np.float32)
    b = rng.normal(size=(F, 1)).astype(np.float32)
    reg = rng.normal(size=(B, N, E, K - 1, G)).astype(np.float32)
    x = rng.normal(size=(B, N, G)).astype(np.float32)
    S = _stack(18, (B,), E, N)
    j, t = _both(S)
    jr, jy = jfilt.tap_register_step(jnp.asarray(w), jnp.asarray(b),
                                     jnp.asarray(reg), jnp.asarray(x), j)
    for graph in (t, _t(S)):
        r, y = tfilt.tap_register_step(_t(w), _t(b), _t(reg), _t(x), graph)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), **TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
