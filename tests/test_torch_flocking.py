"""PyTorch port, data/flocking.py and LocalGNN_DB: the cell-grid
environment, the dense reference step and the closed-loop rollouts, held
against the JAX package on the CPU with the same inputs and weights
(carried across by load_flax_params).

Exact: tables, (order, vpos), ok, selected neighbor ids, the initial
positions. Float sums taken in another order (the window sums, norms, the
policy's small matmuls) are held to rtol 1e-5 with an absolute term of
1e-6 of the column's largest value; rollout positions and velocities to
rtol = atol = 1e-5 over 10 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from graph_neural_networks_torch.data import flocking as tF
from graph_neural_networks_torch.models import architectures_time as tarcht
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu.data import flocking as jF
from graph_neural_networks_tpu.models import architectures_time as jarcht


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-5, atol_rel=1e-6, axis=None):
    """|got - want| <= rtol |want| + atol_rel max|want| (per slice along
    `axis` when given, e.g. per state channel)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if axis is None:
        scale = np.abs(want).max()
    else:
        red = tuple(i for i in range(want.ndim) if i != axis % want.ndim)
        scale = np.abs(want).max(axis=red, keepdims=True)
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * np.abs(want) + atol_rel * scale
                                 + 1e-30)


def _swarm(N, B, seed):
    env = tF.Flocking.for_rollout(N, 2.0, 1.0, 0.01, device="cpu",
                                  rng=np.random.default_rng(seed))
    ip, iv = env.compute_initial_positions(N, B, 2.0, minDist=0.1,
                                           geometry="circular")
    return env, ip.astype(np.float32), iv.astype(np.float32)


def _policy(dims, taps, seed):
    jnet = jarcht.LocalGNN_DB(dims, taps, True, "tanh", [2], 1)
    params = jnet.init(jax.random.PRNGKey(seed), N=16, T=3)
    tnet = tarcht.LocalGNN_DB(dims, taps, True, "tanh", [2], 1,
                              device="cpu")
    load_flax_params(tnet, jax.tree_util.tree_map(np.asarray,
                                                  unfreeze(params)))
    return jnet, params, tnet


@pytest.mark.parametrize("geometry", ["circular", "rectangular"])
def test_initial_positions_equal_jax(geometry):
    kw = dict(minDist=0.1, geometry=geometry, xMaxInitVel=3.0,
              yMaxInitVel=3.0)
    jenv = jF.Flocking.for_rollout(300, 2.0, 1.0, 0.01,
                                   rng=np.random.default_rng(4))
    tenv = tF.Flocking.for_rollout(300, 2.0, 1.0, 0.01, device="cpu",
                                   rng=np.random.default_rng(4))
    for a, b in zip(jenv.compute_initial_positions(300, 3, 2.0, **kw),
                    tenv.compute_initial_positions(300, 3, 2.0, **kw)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("factor,C", [(2, 32), (1, 16)])
@pytest.mark.parametrize("with_v,P", [(False, 0), (True, 0), (True, 5)])
def test_grid_build_table_matches_jax(factor, C, with_v, P):
    """Every port builder against the JAX scatter build (which JAX's own
    tests hold bit equal to its gather and fused builds when ok)."""
    rng = np.random.default_rng(11 + P)
    B, N, r = 2, 700, 2.0
    xy = rng.uniform(0, 40, (B, 4, N)).astype(np.float32)
    xy[:, 2:] = rng.normal(size=(B, 2, N))
    v = rng.normal(size=(B, N)).astype(np.float32)
    pay = rng.normal(size=(B, N, P)).astype(np.float32)
    H, Gx, Gy, Cc = jF._grid_geometry(N, None, C, factor)
    inv_s = 1.0 / (factor * r)
    want = [jF._grid_build_table(
        *(jnp.asarray(xy[b, i]) for i in range(4)), inv_s, H, Gx, Gy, Cc,
        v=jnp.asarray(v[b]) if with_v else None,
        pay=jnp.asarray(pay[b]) if P else None, builder="scatter")
        for b in range(B)]
    for builder in ("fused", "gather", "scatter"):
        rows, cx, cy, ok, (order, vpos) = tF._grid_build_table(
            *(torch.tensor(xy[:, i]) for i in range(4)), inv_s, H, Gx, Gy,
            Cc, v=torch.tensor(v) if with_v else None,
            pay=torch.tensor(pay) if P else None, builder=builder)
        for b, (w_rows, w_cx, w_cy, w_ok, (w_order, w_vpos)) in \
                enumerate(want):
            assert bool(ok[b]) and bool(w_ok)
            for got, ref in ((rows[b], w_rows), (cx[b], w_cx),
                             (cy[b], w_cy), (order[b], w_order),
                             (vpos[b], w_vpos)):
                np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_grid_build_table_flags_overflow():
    rng = np.random.default_rng(1)
    xy = torch.tensor(rng.uniform(0, 4, (4, 1, 200)), dtype=torch.float32)
    H, Gx, Gy, C = tF._grid_geometry(200, 64, 8, 1)
    *_, ok, _ = tF._grid_build_table(*xy, 0.5, H, Gx, Gy, C)
    assert not bool(ok[0])


ENV_CASES = [  # (cell factor, cell_cap, payload width, lam_iters)
    (2, 32, 0, 0), (2, 32, 12, 0), (2, 32, 12, 2), (1, 16, 0, 2),
    (1, 16, 5, 0),
]


@pytest.mark.parametrize("factor,cap,P,lam_iters", ENV_CASES)
def test_env_step_grid_matches_jax(factor, cap, P, lam_iters):
    """One grid env step, B = 2, against _jnp_env_step_grid on both of its
    window paths (XLA, and the Pallas kernel in interpret mode)."""
    _, ip, iv = _swarm(256, 2, 3)
    rng = np.random.default_rng(P + lam_iters)
    v0 = np.abs(rng.normal(size=(2, 256))).astype(np.float32)
    pay = rng.normal(size=(2, 256, P)).astype(np.float32) if P else None
    D = 32
    got = tF.env_step_grid(
        torch.tensor(ip), torch.tensor(iv), 2.0, D, torch.tensor(v0),
        lam_iters=lam_iters, cell_cap=cap, cell_factor=factor,
        payload=None if pay is None else torch.tensor(pay))
    assert bool(got[-1])
    for use_kernel in (False, True):
        want = jF._jnp_env_step_grid(
            jnp.asarray(ip), jnp.asarray(iv), 2.0, D, jnp.asarray(v0),
            lam_iters=lam_iters, cell_cap=cap, cell_factor=factor,
            use_kernel=use_kernel,
            payload=None if pay is None else jnp.asarray(pay))
        assert bool(want[-1])
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        _close(got[1].numpy(), want[1])                      # val / lam
        _close(got[2].numpy(), want[2], axis=1)              # states
        _close(got[3].numpy(), want[3])                      # v
        if P:
            _close(got[4].numpy(), want[4], axis=-1)         # shifted


def test_env_step_grid_matches_dense_reference():
    """The grid step against the dense all-pairs step of the port: the
    same neighbor sets, states, payload shift and Rayleigh-fold lambda."""
    _, ip, iv = _swarm(200, 2, 5)
    pos, vel = torch.tensor(ip), torch.tensor(iv)
    v0 = torch.rand(2, 200, generator=torch.Generator().manual_seed(0))
    pay = torch.randn(2, 200, 4, generator=torch.Generator().manual_seed(1))
    idx, val, st, v, sh, ok = tF.env_step_grid(
        pos, vel, 2.0, 32, v0, lam_iters=0, cell_cap=32, cell_factor=2,
        payload=pay)
    assert bool(ok)
    W = (tF.comm_graph(pos, 2.0, "power") > 0).to(pos.dtype)
    lam = (torch.einsum("bn,bnm,bm->b", v0, W, v0)
           / (v0 * v0).sum(-1))
    Sg = torch.zeros_like(W)
    Sg.scatter_add_(2, idx.long(), val)       # row m: its in-neighbors
    np.testing.assert_array_equal((Sg > 0).numpy(), (W > 0).numpy())
    _close((Sg * lam[:, None, None]).numpy(), W.numpy())
    _close(st.numpy(), tF.states(pos, vel, W).numpy(), rtol=1e-4, axis=1)
    _close(sh.numpy(), (torch.einsum("bmn,bnp->bmp", W, pay)
                        / lam[:, None, None]).numpy(), rtol=1e-4)


def test_dense_reference_matches_jax():
    _, ip, iv = _swarm(64, 2, 6)
    pos, vel = jnp.asarray(ip), jnp.asarray(iv)
    for method in ("eig", "power"):
        want = np.asarray(jF._jnp_comm_graph(pos, 2.0, method))
        got = tF.comm_graph(torch.tensor(ip), 2.0, method).numpy()
        _close(got, want)
    _close(tF.states(torch.tensor(ip), torch.tensor(iv),
                     torch.tensor(want)).numpy(),
           jF._jnp_states(pos, vel, jnp.asarray(want)), axis=1)
    W01 = (want > 0).astype(np.float32)
    _close(tF.lambda_max_power(torch.tensor(W01)).numpy(),
           jF._lambda_max_power(jnp.asarray(W01)))


def test_local_gnn_db_step_matches_jax():
    """rollout_step_shifted with transplanted weights (a JAX init tree
    loads leaf for leaf) against the JAX step, 2 layers."""
    jnet, params, tnet = _policy([6, 8, 5], [3, 2], 0)
    assert tnet.payload_width == jnet.payload_width == 2 * 6 + 1 * 8
    assert tnet.causal_window == jnet.causal_window
    rng = np.random.default_rng(0)
    B, N = 2, 40
    x = rng.normal(size=(B, 6, N)).astype(np.float32)
    state = [rng.normal(size=(B, N, 1, k - 1, g)).astype(np.float32)
             for k, g in ((3, 6), (2, 8))]
    sh = rng.normal(size=(B, N, 1, 20)).astype(np.float32)
    j_state, j_y = jnet.rollout_step_shifted(
        params, tuple(jnp.asarray(s) for s in state), jnp.asarray(x),
        jnp.asarray(sh))
    with torch.no_grad():
        t_state, t_y = tnet.rollout_step_shifted(
            tuple(torch.tensor(s) for s in state), torch.tensor(x),
            torch.tensor(sh))
    _close(t_y.numpy(), j_y)
    # layer 1's register is moved data; layer 2's holds layer 1's output
    np.testing.assert_array_equal(t_state[0].numpy(), np.asarray(j_state[0]))
    _close(t_state[1].numpy(), j_state[1])
    _close(tnet.rollout_payload(t_state).numpy(),
           jnet.rollout_payload(j_state))
    for a, b in zip(tnet.rollout_init(B, N), jnet.rollout_init(None, B, N)):
        assert tuple(a.shape) == b.shape and not a.any()


def test_load_flax_params_rejects_unmatched_leaves():
    _, params, tnet = _policy([6, 8], [3], 1)
    tree = jax.tree_util.tree_map(np.asarray, unfreeze(params))
    tree["params"]["GraphFilterDB_1"] = {"weight": np.zeros((1, 1, 1, 1))}
    with pytest.raises(KeyError, match="GraphFilterDB_1"):
        load_flax_params(tnet, tree)


@pytest.fixture(scope="module")
def rollout_pair():
    """A 128-agent, 2-sample swarm and a transplanted LocalGNN_DB; T = 10."""
    jenv = jF.Flocking.for_rollout(128, 2.0, 1.0, 0.01,
                                   rng=np.random.default_rng(2))
    tenv, ip, iv = _swarm(128, 2, 2)
    jnet, params, tnet = _policy([6, 8], [3], 2)
    return jenv, tenv, ip, iv, jnet, params, tnet


def test_rollout_cost_and_traj_device_match_jax(rollout_pair):
    jenv, tenv, ip, iv, jnet, params, tnet = rollout_pair
    kw = dict(ell_degree=16, env_grid=True, lam_iters=0)
    cf, ce = tenv.rollout_cost(ip, iv, 0.1, tnet, **kw)
    jcf, jce = jenv.rollout_cost(ip, iv, 0.1, jnet, params, **kw)
    np.testing.assert_allclose([cf, ce], [jcf, jce], rtol=1e-5)
    pos, vel = tenv.rollout_traj_device(ip, iv, 0.1, tnet, **kw)
    jpos, jvel = jenv.rollout_traj_device(ip, iv, 0.1, jnet, params, **kw)
    assert tuple(pos.shape) == (2, 10, 2, 128)
    for a, b in ((pos, jpos), (vel, jvel)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    # the device cost of the returned trajectory is the rollout's cost
    np.testing.assert_allclose(float(tF.evaluate_cost_device(vel)), cf,
                               rtol=1e-5)
    np.testing.assert_allclose(
        tenv.evaluate(vel=vel.numpy().astype(np.float64)),
        float(jF.evaluate_cost_device(jnp.asarray(jvel))), rtol=1e-5)


@pytest.mark.parametrize("return_graphs", [True, False])
def test_compute_trajectory_matches_jax(rollout_pair, return_graphs):
    jenv, tenv, ip, iv, jnet, params, tnet = rollout_pair
    kw = dict(ell_degree=16, env_grid=True, lam_iters=2,
              return_graphs=return_graphs)
    got = tenv.compute_trajectory(ip, iv, 0.1, tnet, **kw)
    want = jenv.compute_trajectory(ip, iv, 0.1, archit=jnet, params=params,
                                   **kw)
    for a, b in zip(got[:2], want[:2]):                  # pos, vel
        assert a.dtype == np.float64 and a.shape == (2, 10, 2, 128)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # accel is the policy's output: f32 matmuls of O(1) terms in another
    # order, a few ulps of the channel's largest value apart
    _close(got[2], want[2], rtol=1e-4, atol_rel=1e-5, axis=2)
    _close(got[3], want[3], rtol=1e-4, atol_rel=1e-5, axis=2)   # states
    g, jg = got[4], want[4]
    assert g.idx.shape == jg.idx.shape and g.val.shape == jg.val.shape
    assert g.idx.shape[-1] == (16 if return_graphs else 0)
    if return_graphs:
        def dense(e):
            idx, val = np.asarray(e.idx), np.asarray(e.val)[:, :, 0]
            S = np.zeros(idx.shape[:3] + (128,))
            np.put_along_axis(S, idx, val, axis=-1)
            return S
        np.testing.assert_array_equal(dense(g) > 0, dense(jg) > 0)
        _close(dense(g), dense(jg))


def test_unported_paths_raise(rollout_pair):
    jenv, tenv, ip, iv, jnet, params, tnet = rollout_pair
    # payload width 12 > 1.5 * 4: the unfused step path is ported
    # (test_torch_db_family.py); it shifts over the emitted graph, so it
    # refuses to emit none
    with pytest.raises(ValueError, match="requires the fused"):
        tenv.compute_trajectory(ip, iv, 0.05, tnet, ell_degree=4,
                                env_grid=True, return_graphs=False)
    # the all-pairs loop is ported (test_torch_flocking_host.py); the grid
    # without an ELL width is refused
    with pytest.raises(ValueError, match="env_grid requires ell_degree"):
        tenv.compute_trajectory(ip, iv, 0.05, tnet, env_grid=True)
    # lam_path="ell" is ported (test_torch_sharded_swarm.py); it takes no
    # payload, and an unknown path is refused
    with pytest.raises(ValueError, match="window-lambda"):
        tF.env_step_grid(torch.tensor(ip), torch.tensor(iv), 2.0, 8,
                         torch.ones(2, 128), lam_path="ell",
                         payload=torch.zeros(2, 128, 3))
    with pytest.raises(ValueError, match="unknown lam_path"):
        tF.env_step_grid(torch.tensor(ip), torch.tensor(iv), 2.0, 8,
                         torch.ones(2, 128), lam_path="eig")
    # the paths that once raised naming item 7.3, now against JAX (the
    # chunked env and the other rollouts: tests/test_torch_chunked_env.py,
    # tests/test_torch_rollout_modes.py). Flocking.large without env_grid:
    args = (128, 2.0, 1.0, 1, 0, 0, 0.03, 0.01, 16)
    td = tF.Flocking.large(*args, rng=np.random.default_rng(2),
                           device="cpu")
    jd = jF.Flocking.large(*args, rng=np.random.default_rng(2))
    assert td.rollout_env_chunk == jd.rollout_env_chunk == 16
    np.testing.assert_array_equal(td.getData("commGraph", "train").idx,
                                  np.asarray(jd.getData("commGraph",
                                                        "train").idx))
    _close(td.getData("state", "train"), jd.getData("state", "train"),
           rtol=1e-4, atol_rel=1e-4, axis=2)
    # step_mode=False: the windowed re-forward on the grid
    kw = dict(ell_degree=16, env_grid=True, lam_iters=0, step_mode=False)
    cf = tenv.rollout_cost(ip, iv, 0.05, tnet, **kw)
    jcf = jenv.rollout_cost(ip, iv, 0.05, jnet, params, **kw)
    np.testing.assert_allclose(cf, [float(c) for c in jcf], rtol=1e-5)
    # a policy without the step interface: the windowed re-forward
    class Windowed(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, x, S):
            return self.net(x, S)

    pos, _ = tenv.rollout_traj_device(ip, iv, 0.05, Windowed(tnet),
                                      history_window=3, ell_degree=16,
                                      env_grid=True)
    jpos, _ = jenv.rollout_traj_device(
        ip, iv, 0.05, lambda p, x, S: jnet.apply(p, x, S), params,
        history_window=3, ell_degree=16, env_grid=True)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=1e-5,
                               atol=1e-5)
    # ... which needs a window
    with pytest.raises(ValueError, match="needs history_window"):
        tenv.rollout_traj_device(ip, iv, 0.05, Windowed(tnet),
                                 ell_degree=16, env_grid=True)
