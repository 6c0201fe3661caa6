"""PyTorch port, attention ops: ops/attention_flash.py (band structure,
the two kernels' plain versions, flash_apply and the flash GAT-family
entry points), ops/attention_band.py and the attention functionals of
ops/filters.py, held against the JAX package on the CPU.

The JAX Pallas kernels run with interpret=True under
pltpu.force_tpu_interpret_mode(), as tests/test_attention_flash.py runs
them; the JAX band functionals run their XLA path (the CPU backend).
Every S is non-symmetric, so a swapped row/column orientation fails.

Tolerance atol = rtol = 1e-4: f32 softmax scores and aggregations summed
in another order (and exp from another library) on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graph_neural_networks_torch.ops import attention_band as tab
from graph_neural_networks_torch.ops import attention_flash as taf
from graph_neural_networks_torch.ops import filters as tfilters
from graph_neural_networks_torch.ops import gso as tgso
from graph_neural_networks_tpu.ops import attention_band as jab
from graph_neural_networks_tpu.ops import attention_flash as jaf
from graph_neural_networks_tpu.ops import filters as jfilters
from graph_neural_networks_tpu.ops import gso as jgso


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-4, rtol=1e-4)

# (N, half-bandwidth, ibs, E): block bandwidth w from 0 up, ragged N
# (N < nb*ibs) included
CASES = [(96, 20, 16, 1), (90, 40, 16, 2), (64, 3, 16, 1), (120, 30, 32, 1)]
CASE_IDS = ["w2", "ragged-E2", "w0", "ibs32"]


def _graph(N, half, E, seed):
    """E non-symmetric banded GSOs, nonzeros within `half` of the diagonal
    (as tests/test_attention_flash.py:_setup)."""
    rng = np.random.default_rng(seed)
    S = np.zeros((E, N, N), np.float32)
    for e in range(E):
        ii = rng.integers(0, N, 4 * N)
        jj = ii + rng.integers(-half, half + 1, 4 * N)
        ok = (jj >= 0) & (jj < N)
        S[e, ii[ok], jj[ok]] = rng.random(ok.sum())
    assert not np.allclose(S, np.swapaxes(S, 1, 2))
    return S


def _setup(N, half, ibs, E, P=2, F=3, G=2, B=2, K=None, seed=0):
    """(S, torch band Gso, JAX band Gso, numpy x, a, W_p)."""
    rng = np.random.default_rng(seed + 100)
    S = _graph(N, half, E, seed)
    tg = tgso.as_gso(S, mode="band", block_size=ibs, device="cpu")
    jg = jgso.as_gso(S, mode="band", block_size=ibs)
    hop = () if K is None else (K,)
    x = rng.standard_normal((B, G, N)).astype(np.float32)
    a = (rng.standard_normal((P,) + hop + (E, 2 * F)) * .3).astype(np.float32)
    W_p = (rng.standard_normal((P,) + hop + (E, F, G)) * .3).astype(
        np.float32)
    return S, tg, jg, x, a, W_p


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _kernel_operands(seed, Q=3, F=4, N=96, half=20, ibs=16, E=1):
    """Score projections, signals and the band structure of one edge
    feature, padded to Np as the entry points pad them."""
    rng = np.random.default_rng(seed)
    _, tg, jg, *_ = _setup(N, half, ibs, E, seed=seed)
    nb = tg.s_band.shape[1]
    Np = nb * ibs
    a1, a2 = (np.pad(rng.standard_normal((Q, N)).astype(np.float32),
                     ((0, 0), (0, Np - N))) for _ in range(2))
    v = np.pad(rng.standard_normal((Q, F, N)).astype(np.float32),
               ((0, 0), (0, 0), (0, Np - N)))
    return tg, jg, a1, a2, v


@pytest.mark.parametrize("N,half,ibs,E", CASES, ids=CASE_IDS)
def test_band_aux_bit_equal_to_jax(N, half, ibs, E):
    _, tg, jg, *_ = _setup(N, half, ibs, E)
    assert tg.band_w == jg.band_w
    taux = taf.band_auxes(tg)
    jaux = jaf._auxes(jfilters._slab5(jg), jg.band_w)
    assert len(taux) == len(jaux) == E
    for t, j in zip(taux, jaux):
        for name in ("slab_col", "mask_col", "mask_row"):
            assert np.array_equal(getattr(t, name).numpy(),
                                  np.asarray(getattr(j, name))), name
        # the apply kernel's entry lists, which the JAX package has no
        # counterpart of: empty at ibs < 64, which no kernel tiles
        assert t.sup_entries.numel() == 0 and t.sup_offs.shape == (0, 9)
    # built once per Gso, kept across a same-device move
    assert taf.band_auxes(tg) is taux
    assert taf.band_auxes(tg.to("cpu")) is taux


@pytest.mark.parametrize("N,half,ibs", [(96, 20, 16), (90, 40, 16),
                                        (64, 3, 16)],
                         ids=["w2", "ragged", "w0"])
def test_stats_plain_matches_jax_kernel(N, half, ibs):
    tg, jg, a1, a2, _ = _kernel_operands(1, N=N, half=half, ibs=ibs)
    w = tg.band_w
    mask_row = taf.band_auxes(tg)[0].mask_row
    with pltpu.force_tpu_interpret_mode():
        jmx, jsm = jaf._stats_call(*_j(a1, a2), jaf._auxes(
            jfilters._slab5(jg), w)[0].mask_row, w, ibs, 0.2, True)
    mx, sm = taf.stats_call(*_t(a1, a2), mask_row, w=w, ibs=ibs)
    assert mx.shape == sm.shape == a1.shape
    np.testing.assert_allclose(mx.numpy(), np.asarray(jmx).reshape(a1.shape),
                               **TOL)
    np.testing.assert_allclose(sm.numpy(), np.asarray(jsm).reshape(a1.shape),
                               **TOL)
    assert taf.stats_call.launches == 0   # CPU tensors: the plain version


@pytest.mark.parametrize("N,half,ibs", [(96, 20, 16), (90, 40, 16),
                                        (120, 30, 32)],
                         ids=["w2", "ragged", "ibs32"])
def test_stats_plain_rows_without_support_match_jax_kernel(N, half, ibs):
    """Rows without support in the first and last w row blocks (whose
    windows leave the matrix) and in the middle: stats_plain against the
    JAX _stats_call, which clamps the off-matrix window blocks onto
    zero-mask tiles, so such a row has rowmax -1e12 and rowsum W*ibs (the
    convention the CUDA kernel keeps, in both instances)."""
    tg, jg, a1, a2, _ = _kernel_operands(3, N=N, half=half, ibs=ibs)
    w = tg.band_w
    mask = taf.band_auxes(tg)[0].mask_row.numpy().copy()
    nb = mask.shape[0]
    Np, W = nb * ibs, 2 * w + 1
    assert w >= 1 and nb >= 2 * w
    rows = [0, w * ibs - 1, Np // 2 + 1, Np - w * ibs, Np - 1]
    for r in rows:
        mask[r // ibs, :, r % ibs, :] = 0
    with pltpu.force_tpu_interpret_mode():
        jmx, jsm = jaf._stats_call(*_j(a1, a2, mask), w, ibs, 0.2, True)
    jmx, jsm = (np.asarray(t).reshape(a1.shape) for t in (jmx, jsm))
    mx, sm = taf.stats_plain(*_t(a1, a2, mask), w=w, ibs=ibs)
    np.testing.assert_allclose(mx.numpy(), jmx, **TOL)
    np.testing.assert_allclose(sm.numpy(), jsm, **TOL)
    for got_mx, got_sm in ((mx.numpy(), sm.numpy()), (jmx, jsm)):
        assert (got_mx[:, rows] == np.float32(-1e12)).all()
        assert (got_sm[:, rows] == W * ibs).all()


@pytest.mark.parametrize("with_s", [True, False])
@pytest.mark.parametrize("N,half,ibs", [(96, 20, 16), (90, 40, 16)],
                         ids=["w2", "ragged"])
def test_apply_plain_matches_jax_kernel(N, half, ibs, with_s):
    tg, jg, a1, a2, v = _kernel_operands(2, N=N, half=half, ibs=ibs)
    w = tg.band_w
    jaux = jaf._auxes(jfilters._slab5(jg), w)[0]
    taux = taf.band_auxes(tg)[0]
    with pltpu.force_tpu_interpret_mode():
        jmx, jsm = jaf._stats_call(*_j(a1, a2), jaux.mask_row, w, ibs, 0.2,
                                   True)
        want = jaf._apply_call(*_j(a1, a2, v), jmx, jsm, jaux.slab_col,
                               jaux.mask_col, w, ibs, with_s, 0.2, True)
    mx, sm = (torch.from_numpy(np.array(t).reshape(a1.shape))
              for t in (jmx, jsm))
    got = taf.apply_call(*_t(a1, a2, v), mx, sm, taux.slab_col,
                         taux.mask_col, w=w, ibs=ibs, with_s=with_s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # masked entries give exactly zero, never NaN
    assert torch.isfinite(got).all()
    assert taf.apply_call.launches == 0


def _holes_graph(N=96, seed=11):
    """A w = 2 band at ibs 16 with no support in the whole window tile of
    row block 1 and column block 3 (mask_col[3, 0]), nor in the 8 x 8
    sub-tile at rows 64..72, columns 80..88 (mask_col[5, 1, :8, :8]): the
    CUDA apply kernel skips both."""
    S = _graph(N, 20, 1, seed)
    S[0, 16:32, 48:64] = 0
    S[0, 64:72, 80:88] = 0
    return S


def _block_diagonal_graph(N=64, ibs=16, seed=12):
    """Support inside the diagonal blocks only: w = 0."""
    rng = np.random.default_rng(seed)
    S = np.zeros((1, N, N), np.float32)
    ii = rng.integers(0, N, 4 * N)
    jj = ii // ibs * ibs + rng.integers(0, ibs, 4 * N)
    ok = jj < N
    S[0, ii[ok], jj[ok]] = rng.random(ok.sum())
    return S


@pytest.mark.parametrize("with_s", [True, False])
@pytest.mark.parametrize("case", ["holes", "w0"])
def test_apply_plain_reciprocal_form_matches_jax_kernel(case, with_s):
    """apply_plain in the kernel's form (one reciprocal of rowsum a row:
    exp(s - rowmax) * (1 / rowsum) * m) against the JAX _apply_call, which
    divides every score, at the unchanged tolerance: on a graph with an
    empty window tile and an empty sub-tile, and at w = 0."""
    ibs, Q, F = 16, 3, 4
    S = _holes_graph() if case == "holes" else _block_diagonal_graph()
    tg = tgso.as_gso(S, mode="band", block_size=ibs, device="cpu")
    jg = jgso.as_gso(S, mode="band", block_size=ibs)
    w = tg.band_w
    taux = taf.band_auxes(tg)[0]
    if case == "holes":
        assert w == 2
        assert not taux.mask_col[3, 0].any()
        assert not taux.mask_col[5, 1, :8, :8].any()
        assert taux.mask_col[5, 1].any()
    else:
        assert w == 0
    rng = np.random.default_rng(13)
    N, Np = S.shape[1], tg.s_band.shape[1] * ibs
    a1, a2 = (np.pad(rng.standard_normal((Q, N)).astype(np.float32),
                     ((0, 0), (0, Np - N))) for _ in range(2))
    v = np.pad(rng.standard_normal((Q, F, N)).astype(np.float32),
               ((0, 0), (0, 0), (0, Np - N)))
    jaux = jaf._auxes(jfilters._slab5(jg), w)[0]
    with pltpu.force_tpu_interpret_mode():
        jmx, jsm = jaf._stats_call(*_j(a1, a2), jaux.mask_row, w, ibs, 0.2,
                                   True)
        want = jaf._apply_call(*_j(a1, a2, v), jmx, jsm, jaux.slab_col,
                               jaux.mask_col, w, ibs, with_s, 0.2, True)
    mx, sm = (torch.from_numpy(np.array(t).reshape(a1.shape))
              for t in (jmx, jsm))
    got = taf.apply_plain(*_t(a1, a2, v), mx, sm, taux.slab_col,
                          taux.mask_col, w=w, ibs=ibs, with_s=with_s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("case", ["band", "holes"])
def test_support_lists_cover_the_support(case):
    """support_lists, the apply kernel's entry lists: every listed entry
    lies on the support of mask_col, every support entry is listed once,
    in row-major order within its chunk; each 4-row group's offsets bound
    its rows; chunks start 16-byte aligned with -1 padding; the result is
    deterministic, and band_auxes builds it once, shared by the edge
    features' BandAux."""
    ibs = 64
    S = _graph(256, 80, 1, 21)
    if case == "holes":
        S[0, 0:64, 128:192] = 0          # mask_col[2, 0]: a whole tile
        S[0, 96:128, 128:192] = 0        # and a 32-row chunk of k = 1
    S = np.concatenate([S, 0.5 * S])     # two edge features
    tg = tgso.as_gso(S, mode="band", block_size=ibs, device="cpu")
    auxes = taf.band_auxes(tg)
    mask = auxes[0].mask_col
    nb, W = mask.shape[:2]
    sup = taf.support_lists(mask)
    entries, offsets = sup.entries.long(), sup.offsets.long()
    n_chunks = nb * W * (ibs // taf.TILE_N) * (ibs // taf.APPLY_CHUNK)
    assert offsets.shape == (n_chunks, 9)
    listed = torch.zeros_like(mask)
    cid = 0
    for j in range(nb):
        for h in range(ibs // taf.TILE_N):
            for k in range(W):
                for pc in range(ibs // taf.APPLY_CHUNK):
                    o = offsets[cid]
                    assert o[0] % 8 == 0
                    got = entries[o[0]:o[8]]
                    assert torch.equal(got, got.sort().values)
                    p, c = got // taf.TILE_N, got % taf.TILE_N
                    for g in range(8):
                        rows = entries[o[g]:o[g + 1]] // taf.TILE_N
                        assert ((rows >= 4 * g) & (rows < 4 * g + 4)).all()
                    pad = -(-int(o[8] - o[0]) // 8) * 8
                    assert (entries[o[8]:o[0] + pad] == -1).all()
                    r0 = pc * taf.APPLY_CHUNK
                    listed[j, k, r0 + p, h * taf.TILE_N + c] += 1
                    cid += 1
    np.testing.assert_array_equal(listed.numpy(), (mask != 0).numpy())
    if case == "holes":
        assert not mask[2, 0].any() and not mask[2, 1, 32:64].any()
    again = taf.support_lists(mask)
    assert torch.equal(again.entries, sup.entries)
    assert torch.equal(again.offsets, sup.offsets)
    for aux in auxes:
        assert aux.sup_entries is auxes[0].sup_entries
        assert aux.sup_offs is auxes[0].sup_offs
    assert torch.equal(auxes[0].lists.entries, sup.entries)
    assert torch.equal(auxes[0].lists.offsets, sup.offsets)
    with pytest.raises(ValueError, match="multiple of 64"):
        taf.support_lists(torch.ones(2, 3, 32, 32))


def test_apply_lists_checked():
    """The apply wrappers' entry lists: missing lists, and lists of
    another mask's shape, are refused before any launch; the band
    structure's own lists are taken."""
    S = _graph(256, 80, 1, 21)
    aux = taf.band_auxes(tgso.as_gso(S, mode="band", block_size=64,
                                     device="cpu"))[0]
    with pytest.raises(ValueError, match="entry lists"):
        taf._lists_ptrs("apply_call", None, aux.mask_col)
    with pytest.raises(ValueError, match="do not fit"):
        taf._lists_ptrs("apply_call", aux.lists, aux.mask_col[1:])
    assert taf._lists_ptrs("apply_call", aux.lists, aux.mask_col) == (
        aux.sup_entries.data_ptr(), aux.sup_offs.data_ptr())


@pytest.mark.parametrize("with_s", [True, False])
def test_flash_apply_matches_jax(with_s):
    tg, jg, a1, a2, v = _kernel_operands(3, Q=1, F=5, N=90, half=40)
    w = tg.band_w
    with pltpu.force_tpu_interpret_mode():
        want = jaf.flash_apply(*_j(a1, a2, v), jaf._auxes(
            jfilters._slab5(jg), w)[0], w, 16, with_s, True, 0.2)
    got = taf.flash_apply(*_t(a1, a2, v), taf.band_auxes(tg)[0], w, 16,
                          with_s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _entry_args(kind, N, half, ibs, E, seed):
    K = 3 if kind == "evgf" else None
    S, tg, jg, x, a, W_p = _setup(N, half, ibs, E, K=K, seed=seed)
    rng = np.random.default_rng(seed + 7)
    h = rng.random((E, 3)).astype(np.float32)
    b = rng.standard_normal((3, 1)).astype(np.float32)
    return S, tg, jg, x, a, W_p, h, b


def _call_entry(mod, kind, slab, w, x, a, W_p, h, b, **kw):
    if kind == "gat":
        return mod.graph_attention_band_flash(x, a, W_p, slab, w, **kw)
    if kind == "gcat":
        return mod.gat_lsigf_band_flash(h, x, a, W_p, slab, w, b, **kw)
    return mod.gat_evgf_band_flash(x, a, W_p, slab, w, b, **kw)


@pytest.mark.parametrize("kind", ["gat", "gcat", "evgf"])
@pytest.mark.parametrize("N,half,ibs,E", CASES, ids=CASE_IDS)
def test_flash_entry_points_match_jax(kind, N, half, ibs, E):
    S, tg, jg, x, a, W_p, h, b = _entry_args(kind, N, half, ibs, E, seed=4)
    with pltpu.force_tpu_interpret_mode():
        want = _call_entry(jaf, kind, jfilters._slab5(jg), jg.band_w,
                           *_j(x, a, W_p, h, b), interpret=True)
    got = _call_entry(taf, kind, taf.slab5(tg), tg.band_w,
                      *_t(x, a, W_p, h, b), auxes=taf.band_auxes(tg))
    assert got.shape == want.shape == (x.shape[0], 2, 3, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _materialized(kind, slab, w, x, a, W_p, h, b, mod):
    if kind == "gat":
        return mod.graph_attention_band(x, a, W_p, slab, w)
    if kind == "gcat":
        return mod.gat_lsigf_band(h, x, a, W_p, slab, w, b)
    return mod.gat_evgf_band(x, a, W_p, slab, w, b)


@pytest.mark.parametrize("kind", ["gat", "gcat", "evgf"])
@pytest.mark.parametrize("N,half,ibs,E", CASES[:2], ids=CASE_IDS[:2])
def test_attention_band_matches_flash_and_jax(kind, N, half, ibs, E):
    """The port's materialized band path, the reference of the flash
    kernels, against the port's flash path and the JAX band path."""
    S, tg, jg, x, a, W_p, h, b = _entry_args(kind, N, half, ibs, E, seed=5)
    got = _materialized(kind, taf.slab5(tg), tg.band_w, *_t(x, a, W_p, h, b),
                        mod=tab)
    flash = _call_entry(taf, kind, taf.slab5(tg), tg.band_w,
                        *_t(x, a, W_p, h, b), auxes=taf.band_auxes(tg))
    want = _materialized(kind, jfilters._slab5(jg), jg.band_w,
                         *_j(x, a, W_p, h, b), mod=jab)
    np.testing.assert_allclose(got.numpy(), flash.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_band_attention_coefficients_match_jax():
    S, tg, jg, x, a, W_p = _setup(90, 40, 16, 2, seed=6)
    alpha, Wx = tab.band_attention_coefficients(
        *_t(x, a, W_p), taf.slab5(tg), tg.band_w)
    jalpha, jWx = jab.band_attention_coefficients(
        *_j(x, a, W_p), jfilters._slab5(jg), jg.band_w)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), **TOL)
    np.testing.assert_allclose(Wx.numpy(), np.asarray(jWx), **TOL)


@pytest.mark.parametrize("mode", ["dense", "band"])
@pytest.mark.parametrize("kind", ["gat", "gcat", "evgf"])
def test_filters_match_jax(kind, mode):
    """filters.graph_attention / gat_lsigf / gat_evgf on a dense and a
    band Gso (block size 32, w >= 1, ragged N), against JAX."""
    K = 3 if kind == "evgf" else None
    S, _, _, x, a, W_p = _setup(100, 30, 32, 2, K=K, seed=7)
    h = np.random.default_rng(8).random((2, 4)).astype(np.float32)
    b = np.random.default_rng(9).standard_normal((3, 1)).astype(np.float32)
    tg = tgso.as_gso(S, mode=mode, block_size=32, device="cpu")
    jg = jgso.as_gso(S, mode=mode, block_size=32)

    def run(mod, g, x, a, W_p, h, b):
        if kind == "gat":
            return mod.graph_attention(x, a, W_p, g)
        if kind == "gcat":
            return mod.gat_lsigf(h, x, a, W_p, g, b)
        return mod.gat_evgf(x, a, W_p, g, b)

    got = run(tfilters, tg, *_t(x, a, W_p, h, b))
    want = run(jfilters, jg, *_j(x, a, W_p, h, b))
    assert got.shape == (2, 2, 3, 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("gso_kind", ["gso", "raw"])
def test_attention_gso_matches_jax(gso_kind):
    S, _, _, x, a, W_p = _setup(50, 8, 16, 2, seed=10)
    tg = tgso.as_gso(S, device="cpu") if gso_kind == "gso" else S
    got = tfilters.attention_gso(*_t(x, a, W_p), tg)
    want = jfilters.attention_gso(*_j(x, a, W_p), jgso.as_gso(S))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # rows sum to one over the S+I support
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


def test_unported_gso_containers_raise():
    S, tg, _, x, a, W_p = _setup(48, 8, 16, 1, seed=11)
    xt, at, Wt = _t(x, a, W_p)

    class EdgeList:   # stands in for ops/attention_sparse.EdgeList
        n = 48

    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        tfilters.graph_attention(xt, at, Wt, EdgeList())


def test_kernel_wrappers_check_shapes():
    tg, _, a1, a2, v = _kernel_operands(12)
    aux = taf.band_auxes(tg)[0]
    w = tg.band_w
    a1t, a2t, vt = _t(a1, a2, v)
    with pytest.raises(ValueError, match="mask_row"):
        taf.stats_call(a1t, a2t, aux.mask_row[1:], w=w, ibs=16)
    with pytest.raises(ValueError, match="not a multiple"):
        taf.stats_call(a1t[:, 1:], a2t[:, 1:], aux.mask_row, w=w, ibs=16)
    mx, sm = taf.stats_call(a1t, a2t, aux.mask_row, w=w, ibs=16)
    with pytest.raises(ValueError, match="rowsum"):
        taf.apply_call(a1t, a2t, vt, mx, sm[:1], aux.slab_col, aux.mask_col,
                       w=w, ibs=16)
    taf.reset_launch_counts()
    assert all(fn.launches == 0 for fn in taf.KERNEL_WRAPPERS)
