"""PyTorch port, the bf16 attention kernels' tiles: the bf16 plain versions
of kernels 7b and 10b (the stats) and 9b and 12b (the flash backward),
global and ext -- what the wrappers run on the CPU and what chip_smoke.py
holds the CUDA kernels to -- against the JAX Pallas kernels on the same
bf16 values (interpret mode) at the edges of the CUDA kernels' tiles; and
the bf16 backward's shared-memory check.

The CUDA stats kernel (attn_stats_bf16_kernel) puts a warp's lanes over
the signal rows (a power of 2 of them on a row's list, at most 32 a
block); the backward (attn_bwd_mma_kernel) serves two signal rows a block
in 64-row tiles, its features in k16 steps up to 64. So the cases: Q in
{1, 3, 4, 5, 17, 33} for the stats (each side of the lanes' splits, two
signal-row groups at 33), Q in {1, 2, 3} for the backward (half a pair, a
pair, a pair and a half), F in {8, 48, 64} (NF = 1, 3, 4), ibs = 64 and
192, window tiles without support and rows without support, and for the
ext kernels the first, an interior and the last shard of a partition at
the kernels' 64-node granularity. Each signal row is computed on its own
on both sides, so the JAX kernel runs once a case at the largest Q and
each Q is held against its first Q rows.

Tolerances: the stats within 1e-5 relative (f32 from bf16 scores, as
tests/test_torch_bf16.py); dv within 2 bf16 ulps of the larger value,
taken at no less than 1e-3 of max|dv|; da2 and the folded da1 within 1e-3
of their largest magnitude (tests/test_torch_bf16_training.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graph_neural_networks_torch.ops import attention_flash as taf
from graph_neural_networks_torch.ops import gso as tgso
from graph_neural_networks_torch.parallel import attention as tsha
from graph_neural_networks_tpu.ops import attention_flash as jaf
from graph_neural_networks_tpu.ops import gso as jgso
from graph_neural_networks_tpu.parallel import attention as jsha
from tests.test_torch_bf16_training import (BF, DV_ULPS, F32_REL, _aux_bf16,
                                            _bf, _jaux_bf16, _jbf, _rel,
                                            _ulps)
from tests.test_torch_flash_bwd import _chunk_graph, _empty_subchunks
from tests.test_torch_sharded_training import _chunk_partition, _ext

SLOPE = 0.2
STATS_RTOL = 1e-5
STATS_QS = (1, 3, 4, 5, 17, 33)
BWD_QS = (1, 2, 3)
BWD_FS = (8, 48, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(kind):
    """(torch Gso, JAX Gso, ibs) of a band graph: 'ibs64', the chunk graph
    with 64 x 64 window tiles without support (N = 320, w = 2); 'ibs192',
    a ragged band at ibs = 192 (N = 500, w = 1)."""
    if kind == "ibs64":
        S, ibs = _chunk_graph("empty"), 64
    else:
        rng = np.random.default_rng(8)
        N, ibs = 500, 192
        S = np.zeros((1, N, N), np.float32)
        ii = rng.integers(0, N, 6 * N)
        jj = ii + rng.integers(-150, 151, len(ii))
        ok = (jj >= 0) & (jj < N)
        S[0, ii[ok], jj[ok]] = rng.random(ok.sum())
    return (tgso.as_gso(S, mode="band", block_size=ibs, device="cpu"),
            jgso.as_gso(S, mode="band", block_size=ibs), ibs)


def _no_support(mask_row, rows):
    """mask_row (nb, W, ibs, ibs) with the given rows' support removed."""
    m = mask_row.clone()
    ibs = m.shape[-1]
    for r in rows:
        m[r // ibs, :, r % ibs, :] = 0
    return m


@pytest.fixture(scope="module", params=["ibs64", "ibs192"])
def stats_case(request):
    """A graph's bf16 operands at the largest Q, its bf16 row mask with
    rows without support in the first, middle and last row blocks, and
    the JAX _stats_call on them."""
    tg, jg, ibs = _graph(request.param)
    w = tg.band_w
    mask = _aux_bf16(taf.band_auxes(tg)[0]).mask_row
    Np = mask.shape[0] * ibs
    rows = [0, ibs + 1, Np // 2, Np - 1]
    mask = _no_support(mask, rows)
    rng = np.random.default_rng(31)
    Q = max(STATS_QS)
    a1, a2 = (_bf(rng.standard_normal((Q, Np))) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        jmx, jsm = jaf._stats_call(_jbf(a1), _jbf(a2), _jbf(mask), w, ibs,
                                   SLOPE, True)
    return dict(w=w, ibs=ibs, mask=mask, rows=rows, a1=a1, a2=a2,
                want=[np.asarray(t).reshape(Q, Np) for t in (jmx, jsm)])


@pytest.mark.parametrize("Q", STATS_QS)
def test_stats_plain_bf16_matches_jax_at_the_lane_splits(stats_case, Q):
    """stats_call on bf16 operands (on the CPU: stats_plain) against the
    JAX kernel, for the first Q signal rows; the rows without support get
    rowmax -1e12 and rowsum W * ibs on both sides."""
    c = stats_case
    got = taf.stats_call(c["a1"][:Q], c["a2"][:Q], c["mask"], w=c["w"],
                         ibs=c["ibs"], slope=SLOPE)
    W = 2 * c["w"] + 1
    for t, want in zip(got, c["want"]):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), want[:Q], rtol=STATS_RTOL,
                                   atol=0)
    for mx, sm in (got, [t[:Q] for t in c["want"]]):
        assert (np.asarray(mx)[:, c["rows"]] == np.float32(-1e12)).all()
        assert (np.asarray(sm)[:, c["rows"]] == W * c["ibs"]).all()


@pytest.fixture(scope="module")
def ext_case():
    """The 'empty' partition at the kernels' 64-node granularity (w = 2,
    window tiles without support, halo blocks past the global ends), bf16
    global operands at Q = 5 and F = 48 with a cotangent, each shard's
    bf16 row mask, halo-extended slab and stats (stats_ext_plain)."""
    part, jpart = _chunk_partition("empty")
    mc, mr = tsha._row_col_masks(part)
    w, ibs, bs = part.w, part.inner_bs, part.block_size
    rng = np.random.default_rng(13)
    Q, F, Np = 5, 48, part.n_padded
    a1, a2 = (_bf(rng.standard_normal((Q, Np))) for _ in range(2))
    v, g = (_bf(rng.standard_normal((Q, F, Np))) for _ in range(2))
    shards = []
    for p in range(part.n_parts):
        own = slice(p * bs, (p + 1) * bs)
        a1e = torch.from_numpy(_ext(a1.float().numpy(), p, part)).to(BF)
        mrow = torch.from_numpy(mr[p]).to(BF)
        mx, sm = taf.stats_ext_plain(a1e, a2[:, own], mrow, w=w, ibs=ibs)
        shards.append(dict(
            a1e=a1e, a2=a2[:, own].contiguous(), v=v[:, :, own].contiguous(),
            mrow=mrow, mx=mx, sm=sm,
            g_ext=torch.from_numpy(_ext(g.float().numpy(), p, part)).to(BF),
            slab=torch.from_numpy(tsha._ext_slabs(part)[p, 0]).to(BF),
            jslab=jnp.asarray(jsha._row_slabs(jpart)[p, 0]).astype(
                jnp.bfloat16),
            jmrow=jnp.asarray(jsha._row_col_masks(jpart)[1][p]).astype(
                jnp.bfloat16)))
    return dict(part=part, shards=shards, w=w, ibs=ibs)


@pytest.mark.parametrize("p", [0, 1, 3], ids=["first", "interior", "last"])
def test_stats_ext_plain_bf16_matches_jax(ext_case, p):
    """stats_ext_call on bf16 operands (on the CPU: stats_ext_plain) of one
    shard against the JAX _stats_ext_call, at Q = 1 and 5."""
    s, w, ibs = ext_case["shards"][p], ext_case["w"], ext_case["ibs"]
    stats_j = jax.jit(jaf._stats_ext_call, static_argnums=(3, 4, 5, 6))
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(t).reshape(s["a2"].shape) for t in stats_j(
            _jbf(s["a1e"]), _jbf(s["a2"]), s["jmrow"], w, ibs, SLOPE, True)]
    for Q in (1, 5):
        got = taf.stats_ext_call(s["a1e"][:Q], s["a2"][:Q], s["mrow"], w=w,
                                 ibs=ibs, slope=SLOPE)
        for t, wt in zip(got, want):
            np.testing.assert_allclose(t.numpy(), wt[:Q], rtol=STATS_RTOL,
                                       atol=0)


@pytest.fixture(scope="module", params=["ibs64", "ibs192"])
def bwd_graph(request):
    """A graph's bf16 row-layout structure and the JAX one; at ibs = 64
    some of its 64 x 64 window tiles hold no support."""
    tg, jg, ibs = _graph(request.param)
    w = tg.band_w
    aux = _aux_bf16(taf.band_auxes(tg)[0])
    if ibs == 64:
        empty, total = _empty_subchunks(aux.mask_row.float().numpy(), w)
        assert 0 < empty < total
    return dict(w=w, ibs=ibs, aux=aux, jaux=_jaux_bf16(jg, w), cache={})


def _bwd_jax(c, F):
    """bf16 operands at Q = 3 and F features (f32 stats from stats_plain),
    and the JAX _bwd_call on them with S, computed once a (graph, F)."""
    if F not in c["cache"]:
        w, ibs, aux = c["w"], c["ibs"], c["aux"]
        Np = aux.mask_row.shape[0] * ibs
        Q = max(BWD_QS)
        rng = np.random.default_rng(40 + F)
        a1, a2 = (_bf(rng.standard_normal((Q, Np))) for _ in range(2))
        v, g = (_bf(rng.standard_normal((Q, F, Np))) for _ in range(2))
        mx, sm = taf.stats_plain(a1, a2, aux.mask_row, w=w, ibs=ibs)
        stats = (jnp.asarray(t.numpy().reshape(Q, -1, 1, ibs))
                 for t in (mx, sm))
        with pltpu.force_tpu_interpret_mode():
            want = jaf._bwd_call(_jbf(a1), _jbf(a2), _jbf(v), *stats,
                                 c["jaux"].slab_row, c["jaux"].mask_row,
                                 _jbf(g), w, ibs, True, SLOPE, True)
        c["cache"][F] = ((a1, a2, v, mx, sm, g), want)
    return c["cache"][F]


@pytest.mark.parametrize("Q", BWD_QS)
@pytest.mark.parametrize("F", BWD_FS)
def test_bwd_plain_bf16_matches_jax_at_the_pair_edges(bwd_graph, F, Q):
    """bwd_call on bf16 operands (on the CPU: bwd_plain) against the JAX
    kernel, for the first Q signal rows: da2 and da1p in f32, dv in bf16."""
    c = bwd_graph
    w, ibs, aux = c["w"], c["ibs"], c["aux"]
    (a1, a2, v, mx, sm, g), (jda2, jda1, jdv) = _bwd_jax(c, F)
    da2, da1p, dv = taf.bwd_call(a1[:Q], a2[:Q], v[:Q], mx[:Q], sm[:Q],
                                 aux.slab_col, aux.mask_row, g[:Q], w=w,
                                 ibs=ibs, slope=SLOPE)
    assert da2.dtype == da1p.dtype == torch.float32 and dv.dtype == BF
    assert _rel(da2, jda2[:Q]) <= F32_REL
    assert _rel(taf.fold_window_partials(da1p, w), jda1[:Q]) <= F32_REL
    assert _ulps(dv, jdv[:Q]) <= DV_ULPS


@pytest.mark.parametrize("p", [0, 1, 3], ids=["first", "interior", "last"])
def test_bwd_ext_plain_bf16_matches_jax(ext_case, p):
    """bwd_ext_call on bf16 operands (on the CPU: bwd_ext_plain) of one
    shard against the JAX _bwd_ext_call, at Q = 1 and 5 (F = 48): da2 and
    the da1 window partials in ext columns in f32, dv in bf16."""
    s, w, ibs = ext_case["shards"][p], ext_case["w"], ext_case["ibs"]
    bwd_j = jax.jit(jaf._bwd_ext_call, static_argnums=(8, 9, 10, 11, 12))
    want = bwd_j(_jbf(s["a1e"]), _jbf(s["a2"]), _jbf(s["v"]),
                 jnp.asarray(s["mx"].numpy()), jnp.asarray(s["sm"].numpy()),
                 s["jslab"], s["jmrow"], _jbf(s["g_ext"]), w, ibs, True,
                 SLOPE, True)
    for Q in (1, 5):
        da2, da1p, dv = taf.bwd_ext_call(
            s["a1e"][:Q], s["a2"][:Q], s["v"][:Q], s["mx"][:Q], s["sm"][:Q],
            s["slab"], s["mrow"], s["g_ext"][:Q], w=w, ibs=ibs, slope=SLOPE)
        assert dv.dtype == BF
        assert _rel(da2, want[0][:Q]) <= F32_REL
        assert _rel(taf.fold_ext_partials(da1p),
                    taf.fold_ext_partials(torch.from_numpy(
                        np.array(want[1][:Q])))) <= F32_REL
        assert _ulps(dv, want[2][:Q]) <= DV_ULPS


def test_bwd_bf16_smem_check_refuses_what_the_kernel_cannot_take():
    """The bf16 backward's check (before any launch): F above 64 and a
    layout above a block's shared memory are refused; the served shapes
    (gat_band_n16384: F = 32, w = 2, ibs = 128; GCAT's F = 64) and the
    tiles' edges are taken. The layout grows with F's k16 steps and the
    window."""
    check = taf._check_bwd_smem
    with pytest.raises(ValueError, match="F <= 64"):
        check("bwd_call", 2, 128, 65, BF)
    for w, ibs, F in ((2, 128, 32), (2, 128, 64), (2, 64, 8), (1, 192, 48),
                      (3, 256, 64)):
        check("bwd_call", w, ibs, F, BF)
        assert taf.bwd_bf16_smem_bytes(F, 2 * w + 1, ibs) <= \
            taf._BLOCK_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        check("bwd_ext_call", 12, 512, 64, BF)
    sizes = [taf.bwd_bf16_smem_bytes(F, 5, 128) for F in (16, 32, 48, 64)]
    assert sizes == sorted(set(sizes))
    assert taf.bwd_bf16_smem_bytes(32, 7, 128) > \
        taf.bwd_bf16_smem_bytes(32, 5, 128)
