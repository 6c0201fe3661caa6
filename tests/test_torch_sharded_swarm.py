"""PyTorch port, parallel/db.py and parallel/swarm.py: the row-sharded ELL
GSO (ShardedEllGso, shard_ell) under the DB filters and LocalGNN_DB, the
node-sharded grid environment step and env_step_grid's ELL lambda, held
against the JAX package on the CPU with the same inputs and weights. The
closed-loop sharded rollouts are in tests/test_torch_sharded_swarm_rollout.py.

The port's meshes repeat the CPU device; the JAX side runs on the 8
virtual CPU devices of tests/conftest.py. Exact: selected neighbor ids,
the exactness flags. Shifts and model outputs at rtol = atol = 1e-4 (f32
sums over D neighbours and taps in another order). Env steps: the window
sums and lambda (whose norms sum the shards' partials, JAX's psum, in
another order) at rtol 1e-5 plus 1e-6 of the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from graph_neural_networks_torch import parallel as tpar
from graph_neural_networks_torch.data import flocking as tF
from graph_neural_networks_torch.models import architectures_time as tarcht
from graph_neural_networks_torch.ops import ell as tell
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import parallel as jpar
from graph_neural_networks_tpu.data import flocking as jF
from graph_neural_networks_tpu.models import architectures_time as jarcht
from graph_neural_networks_tpu.ops import ell as jell

from tests.test_torch_flocking import _close, _swarm
from tests.test_torch_parallel import meshes  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)


def _stack(seed, lead, N, deg):
    """A random (*lead, 1, N, N) GSO stack, in-degree <= deg."""
    rng = np.random.default_rng(seed)
    S = np.zeros(lead + (1, N, N), np.float32)
    for i in np.ndindex(*lead):
        for m in range(N):
            nbrs = rng.choice(N, size=rng.integers(1, deg + 1),
                              replace=False)
            S[i][0, nbrs, m] = rng.standard_normal(len(nbrs))
    return S


def _transplanted(dims, taps, seed, N=16):
    jnet = jarcht.LocalGNN_DB(dims, taps, True, "tanh", [2], 1)
    params = jnet.init(jax.random.PRNGKey(seed), N=N, T=2)
    tnet = tarcht.LocalGNN_DB(dims, taps, True, "tanh", [2], 1,
                              device="cpu")
    load_flax_params(tnet, jax.tree_util.tree_map(np.asarray,
                                                  unfreeze(params)))
    return jnet, params, tnet


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# ShardedEllGso
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [24, 10])            # 10 -> padded to 12
def test_sharded_ell_shifts_match_jax(meshes, N):
    tmesh, jmesh = meshes[(2, 4)]
    B, T, G = 2, 3, 3
    S = _stack(N, (B, T), N, 4)
    j_ell = jell.ell_from_dense(S)
    sg_j = jpar.shard_ell(j_ell, jmesh)
    sg_t = tpar.shard_ell(tell.EllGso(np.array(j_ell.idx),
                                      np.array(j_ell.val)), tmesh)
    assert (sg_t.n, sg_t.n_orig) == (sg_j.n, sg_j.n_orig) == (-(-N // 4) * 4,
                                                              N)
    np.testing.assert_array_equal(sg_t.idx.numpy(), np.asarray(sg_j.idx))
    np.testing.assert_array_equal(sg_t.val.numpy(), np.asarray(sg_j.val))
    x = np.random.default_rng(1).standard_normal(
        (B, T, 1, G, N)).astype(np.float32)
    with jmesh:
        want = np.asarray(sg_j.unpad_signal(jax.jit(sg_j.db_shift)(
            sg_j.pad_signal(jnp.asarray(x)))))
        xr = jnp.moveaxis(sg_j.pad_signal(jnp.asarray(x)), -1, -3)
        want_rows = np.asarray(jax.jit(sg_j.db_shift_rows)(xr))
    xp = sg_t.pad_signal(_t(x))
    got = sg_t.unpad_signal(sg_t.db_shift(xp))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.einsum("btegn,btenm->btegm", x, S), **TOL)
    got_rows = sg_t.db_shift_rows(torch.movedim(xp, -1, -3))
    np.testing.assert_allclose(got_rows.numpy(), want_rows, **TOL)
    step = sg_t.time_step(1)
    assert isinstance(step, tpar.ShardedEllGso) and step.n_orig == N
    np.testing.assert_array_equal(step.idx.numpy(), sg_t.idx[:, 1].numpy())


def test_local_gnn_db_over_shard_ell_matches_jax(meshes):
    """A LocalGNN_DB forward and the gradients of its parameters over
    shard_ell's graphs, against the JAX model over the JAX ShardedEllGso
    and the port over the unsharded EllGso."""
    tmesh, jmesh = meshes[(2, 4)]
    jnet, params, tnet = _transplanted([6, 8, 8], [3, 3], 4)
    B, T, N = 4, 5, 16
    S = np.abs(_stack(5, (B, T), N, 4))
    j_ell = jell.ell_from_dense(S)
    t_ell = tell.EllGso(_t(j_ell.idx), _t(j_ell.val))
    sg_j = jpar.shard_ell(j_ell, jmesh)
    sg_t = tpar.shard_ell(t_ell, tmesh)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, T, 6, N)).astype(np.float32)
    y = rng.standard_normal((B, T, 2, N)).astype(np.float32)

    def jloss(p):
        return jnp.mean((jnet.apply(p, jnp.asarray(x), sg_j) - y) ** 2)
    with jmesh:
        want = np.asarray(jax.jit(lambda p: jnet.apply(
            p, jnp.asarray(x), sg_j))(params))
        jgrads = jax.jit(jax.grad(jloss))(params)
    flat = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    for S_t, label in ((sg_t, "sharded"), (t_ell, "unsharded")):
        tnet.zero_grad()
        out = tnet(_t(x), S_t)
        ((out - _t(y)) ** 2).mean().backward()
        np.testing.assert_allclose(out.detach().numpy(), want,
                                   err_msg=label, **TOL)
        for path, (p, transpose) in tnet.flax_names().items():
            key = next(k for k in flat if tuple(
                getattr(e, "key", None) for e in k)[-len(path):] == path)
            g = np.asarray(flat[key])
            np.testing.assert_allclose(p.grad.numpy(), g.T if transpose
                                       else g, err_msg=f"{label} {path}",
                                       **TOL)


# ---------------------------------------------------------------------------
# The grid environment step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lam_iters", [0, 2])
def test_env_step_grid_ell_lambda_matches_jax(lam_iters):
    """lam_path='ell': lambda by power iteration over the emitted ELL
    graph, against _jnp_env_step_grid's on both of its window paths."""
    _, ip, iv = _swarm(256, 2, 7)
    v0 = np.abs(np.random.default_rng(lam_iters).normal(
        size=(2, 256))).astype(np.float32)
    got = tF.env_step_grid(_t(ip), _t(iv), 2.0, 32, _t(v0),
                           lam_iters=lam_iters, cell_cap=32, cell_factor=2,
                           lam_path="ell")
    assert bool(got[-1])
    for use_kernel in (False, True):
        want = jF._jnp_env_step_grid(
            jnp.asarray(ip), jnp.asarray(iv), 2.0, 32, jnp.asarray(v0),
            lam_iters=lam_iters, cell_cap=32, cell_factor=2,
            use_kernel=use_kernel, lam_path="ell")
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        _close(got[1].numpy(), want[1])
        _close(got[2].numpy(), want[2], axis=1)
        _close(got[3].numpy(), want[3])
    if lam_iters == 0:                    # v is kept, not advanced
        np.testing.assert_array_equal(got[3].numpy(), v0)


ENV_CASES = [  # (payload width, d_max, lam_iters, mesh)
    (0, 0, 0, (1, 8)), (5, 0, 2, (1, 8)), (5, 32, 0, (2, 4)),
    (0, 32, 2, (1, 8)),
]


@pytest.mark.parametrize("P,d_max,lam_iters,shape", ENV_CASES)
def test_sharded_env_step_matches_jax(meshes, P, d_max, lam_iters, shape):
    """One sharded grid env step, B = 2, N = 256 on 8 or 4 shards,
    against the JAX sharded step and the port's one-shard step
    (env_step_grid: the window lambda at d_max = 0, the ELL one above)."""
    tmesh, jmesh = meshes[shape]
    _, ip, iv = _swarm(256, 2, 8)
    rng = np.random.default_rng(P + d_max + lam_iters)
    v0 = np.abs(rng.normal(size=(2, 256))).astype(np.float32)
    pay = rng.normal(size=(2, 256, P)).astype(np.float32) if P else None
    tp = lambda a: None if a is None else _t(a)
    got = tpar.sharded_env_step(_t(ip), _t(iv), 2.0, d_max, tmesh,
                                v_prev=_t(v0), lam_iters=lam_iters,
                                env_grid=True, payload=tp(pay))
    with jmesh:
        want = jax.jit(lambda p, u, v, *pl: jpar.sharded_env_step(
            p, u, 2.0, d_max, jmesh, v_prev=v, lam_iters=lam_iters,
            env_grid=True, payload=pl[0] if pl else None))(
                jnp.asarray(ip), jnp.asarray(iv), jnp.asarray(v0),
                *(() if pay is None else (jnp.asarray(pay),)))
    # the one-shard form; at d_max > 0 (the ELL lambda) it takes no payload
    one_pay = pay if d_max == 0 else None
    one = tF.env_step_grid(_t(ip), _t(iv), 2.0, d_max, _t(v0),
                           lam_iters=lam_iters, cell_cap=32, cell_factor=2,
                           payload=tp(one_pay), in_degree=True,
                           lam_path="ell" if d_max else "window")
    assert bool(got[-1]) and bool(want[-1]) and bool(one[-1])
    np.testing.assert_array_equal(got[-2].numpy(), one[-2].numpy())  # deg
    for ref in ((want, one) if one_pay is not None or not P else (want,)):
        assert tuple(got[0].shape) == tuple(ref[0].shape) == (2, 256, d_max)
        if d_max:
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(ref[0]))
            _close(got[1].numpy(), ref[1])                   # val / lam
        _close(got[2].numpy(), ref[2], axis=1)               # states
        _close(got[3].numpy(), ref[3])                       # v
        if P:
            _close(got[4].numpy(), ref[4], axis=-1)          # shifted
