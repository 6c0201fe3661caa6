"""PyTorch port, differentiable shifts: ops/spmm.py's BandShift,
BandRegister and BcsrShift and their routing in ops/gso.py, held against
jax.grad of the JAX package's custom VJPs (band_shift, band_register,
bcsr_shift; Pallas kernels in TPU interpret mode) and against dense
autograd of x @ S, on the CPU.

Tolerance atol = rtol = 1e-5: the same f32 products summed in another
order (K-1 chained shifts for the register).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graph_neural_networks_torch.ops import gso as tgso
from graph_neural_networks_torch.ops import spmm as tspmm
from graph_neural_networks_tpu.ops import gso as jgso
from graph_neural_networks_tpu.ops import spmm as jspmm

TOL = dict(atol=1e-5, rtol=1e-5)
BS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(N, half, R, seed):
    """A non-symmetric banded S (half = 0: inside the diagonal blocks), x
    (R, N) and the rng, as numpy."""
    rng = np.random.default_rng(seed)
    S = np.zeros((N, N))
    for i in range(N):
        js = (i // BS * BS + rng.integers(0, BS, 4) if half == 0
              else i + rng.integers(-half, half + 1, 4))
        js = np.clip(js, 0, N - 1)
        S[i, js] = rng.standard_normal(len(js))
    assert not np.allclose(S, S.T)
    x = rng.standard_normal((R, N)).astype(np.float32)
    return S, x, rng


def _dense_grad(S, x, ct, K=None):
    """d/dx of <ct, x S> (or of the K-tap register) by dense autograd."""
    xt = torch.from_numpy(x).requires_grad_()
    St = torch.from_numpy(S.astype(np.float32))
    if K is None:
        y = xt @ St
    else:
        zs = [xt]
        for _ in range(1, K):
            zs.append(zs[-1] @ St)
        y = torch.stack(zs)
    (y * torch.from_numpy(ct)).sum().backward()
    return xt.grad.numpy()


@pytest.mark.parametrize("N,half", [(90, 20), (64, 0), (100, 40)],
                         ids=["w2-ragged", "w0", "w3-ragged"])
def test_band_shift_grad(N, half):
    S, x, rng = _case(N, half, 6, seed=N + half)
    ct = rng.standard_normal((6, N)).astype(np.float32)
    g = tgso.as_gso(S, "band", BS, device="cpu")
    jg = jgso.as_gso(S, "band", BS)
    xt = torch.from_numpy(x).requires_grad_()
    y = tspmm.BandShift.apply(xt, g.s_band[0], g.s_band_t[0], N, g.band_w,
                              BS)
    (y * torch.from_numpy(ct)).sum().backward()

    def jloss(x):
        return jnp.sum(jspmm.band_shift(x, jg.s_band[0], jg.s_band_t[0], N,
                                        jg.band_w, BS, 8) * ct)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss)(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), _dense_grad(S, x, ct), **TOL)


@pytest.mark.parametrize("K", [2, 4])
def test_band_register_grad(K):
    N = 90
    S, x, rng = _case(N, 30, 5, seed=K)
    ct = rng.standard_normal((K, 5, N)).astype(np.float32)
    g = tgso.as_gso(S, "band", BS, device="cpu")
    jg = jgso.as_gso(S, "band", BS)
    xt = torch.from_numpy(x).requires_grad_()
    z = tspmm.BandRegister.apply(xt, g.s_band[0], g.s_band_t[0], K, N,
                                 g.band_w, BS)
    assert z.shape == (K, 5, N)
    (z * torch.from_numpy(ct)).sum().backward()

    def jloss(x):
        return jnp.sum(jspmm.band_register(x, jg.s_band[0], jg.s_band_t[0],
                                           K, N, jg.band_w, BS, 8) * ct)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss)(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), _dense_grad(S, x, ct, K),
                               **TOL)


@pytest.mark.parametrize("N,half", [(96, 20), (90, 50)],
                         ids=["square", "ragged"])
def test_bcsr_shift_grad(N, half):
    S, x, rng = _case(N, half, 7, seed=N)
    ct = rng.standard_normal((7, N)).astype(np.float32)
    g = tgso.as_gso(S, "bcsr", BS, device="cpu")
    jg = jgso.as_gso(S, "bcsr", BS)
    xt = torch.from_numpy(x).requires_grad_()
    y = tspmm.BcsrShift.apply(xt, g.blocks[0], g.block_row, g.block_col,
                              g.blocks_t[0], g.block_row_t, g.block_col_t,
                              N, BS)
    (y * torch.from_numpy(ct)).sum().backward()

    def jloss(x):
        return jnp.sum(jspmm.bcsr_shift(
            x, jg.blocks[0], jg.block_row, jg.block_col, jg.blocks_t[0],
            jg.block_row_t, jg.block_col_t, N, BS) * ct)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss)(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), _dense_grad(S, x, ct), **TOL)


@pytest.mark.parametrize("mode", ["band", "bcsr"])
def test_gshift_register_grad_matches_dense_mode(mode):
    """gso.gshift_register through the Functions (fused register at few
    rows, chained shifts above REGISTER_MAX_ROWS) against dense mode, E = 2
    edge features."""
    N, K = 80, 3
    S = np.stack([_case(N, 20, 1, seed=s)[0] for s in (1, 2)])
    rng = np.random.default_rng(3)
    grads = {}
    for m in (mode, "dense"):
        g = tgso.as_gso(S, m, 64, device="cpu")
        for B in (2, tspmm.REGISTER_MAX_ROWS + 1):
            x = torch.from_numpy(rng.standard_normal((B, 2, 1, N)).astype(
                np.float32) if m == mode else grads[("x", B)])
            grads[("x", B)] = x.numpy()
            x.requires_grad_()
            z = tgso.gshift_register(g, x, K)
            assert z.shape == (B, 2, K, 1, N)
            (z * torch.linspace(-1, 1, N)).sum().backward()
            grads[(m, B)] = x.grad.numpy()
    for B in (2, tspmm.REGISTER_MAX_ROWS + 1):
        np.testing.assert_allclose(grads[(mode, B)], grads[("dense", B)],
                                   **TOL)


@pytest.fixture
def counted(monkeypatch):
    """Count the kernel wrappers' calls by the Functions (on the CPU the
    wrappers run their plain versions and count no launch)."""
    calls = {}
    for name in ("band_matmul", "band_shift_register", "bcsr_matmul"):
        fn = getattr(tspmm, name)

        def wrapper(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tspmm, name, wrapper)
    return calls


@pytest.mark.parametrize("mode", ["band", "bcsr"])
def test_no_backward_shift_without_input_grad(counted, mode):
    """A shift whose input needs no gradient runs no backward kernel: only
    its forward call, however much of the graph after it is trained."""
    N = 64
    S, x, _ = _case(N, 20, 3, seed=5)
    g = tgso.as_gso(S, mode, BS, device="cpu")
    w = torch.ones(N, requires_grad=True)
    x4 = torch.from_numpy(x)[:, None, None]                # (3, 1, 1, N)
    (tgso.gshift(g, x4) * w).sum().backward()
    forward = "band_matmul" if mode == "band" else "bcsr_matmul"
    assert counted == {forward: 1}
    (tgso.gshift(g, x4.clone().requires_grad_()) * w).sum().backward()
    assert counted == {forward: 3}
    counted.clear()
    z = tgso.gshift_register(tgso.as_gso(S, "band", 64, device="cpu"),
                             x4, 4)
    (z * w).sum().backward()
    assert counted == {"band_shift_register": 1}


def test_raw_wrappers_name_their_function():
    from graph_neural_networks_torch import kernels
    for fn in tspmm.KERNEL_WRAPPERS:
        assert fn.__name__ in kernels.AUTOGRAD_FUNCTIONS
        path = kernels.AUTOGRAD_FUNCTIONS[fn.__name__]
        assert hasattr(tspmm, path.rsplit(".", 1)[1])
