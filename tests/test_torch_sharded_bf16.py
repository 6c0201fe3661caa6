"""PyTorch port, sharded models in bf16 (ROADMAP item 2.1), held against
the JAX package on the CPU: the bf16 plain versions of kernels 10-12
(``stats_ext_plain``, ``apply_ext_plain``, ``bwd_ext_plain`` on bf16
operands, what ``stats_ext_call``/``apply_ext_call``/``bwd_ext_call`` run
on CPU tensors) against the JAX Pallas kernels on bf16 operands
(interpret=True passed in); the sharded bf16 InferenceEngine (GAT over
(1, 2) and (2, 2) meshes on the flash schedule, SelectionGNN over the
ring, the all-gather and the BCSR shift) against the port's unsharded bf16
engine and JAX's unsharded and sharded bf16 engines; the kept divergence
(the port's sharded bf16 shift stays bf16, JAX's promotes to f32 on its
f32 slabs); sharded bf16 training against the port's unsharded bf16
Trainer and JAX's Trainer(mesh=..., precision="bf16"), and a sharded GRNN
under bf16; and the ``ShardedEllGso`` pytree (served as ``engine(x, S)``).

The port's meshes repeat the CPU device; the JAX side runs on the 8
virtual CPU devices of tests/conftest.py, jitted.

Tolerances, with the bf16 ulp of v taken as 2^(floor(log2|v|) - 7):
  * the plain versions against the JAX kernels: y and dv within 2 ulps of
    the larger of the two values, taken at no less than 1e-3 of the
    output's largest magnitude (one rounding of an f32 sum taken in
    another order); da2 and the da1 partials (f32) within 1e-3 of their
    largest magnitude; the stats (f32) within 1e-5 of theirs;
  * an engine: 1e-2 of the largest |y| against the port's unsharded bf16
    engine and against either JAX bf16 engine (bf16 rounds the
    activations and products of every layer, at other points in each;
    the JAX sharded path multiplies by f32 S);
  * a trainer: the first step's gradients within 2e-2 of each leaf's
    largest magnitude; 3 losses within rtol 0.05 and atol 0.02 (the JAX
    package's own bf16 bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_networks_torch import kernels
from graph_neural_networks_torch import parallel as tpar
from graph_neural_networks_torch import serving as tserving
from graph_neural_networks_torch import training as ttrain
from graph_neural_networks_torch.models import architectures as tarch
from graph_neural_networks_torch.ops import attention_flash as taf
from graph_neural_networks_torch.parallel import attention as tsha
from graph_neural_networks_torch.parallel import shift as tshift
from graph_neural_networks_torch.utils.params import load_flax_params
from graph_neural_networks_tpu import parallel as jpar
from graph_neural_networks_tpu import serving as jserving
from graph_neural_networks_tpu import training as jtrain
from graph_neural_networks_tpu.models import architectures as jarch
from graph_neural_networks_tpu.ops import attention_flash as jaf
from graph_neural_networks_tpu.parallel import attention as jsha
from tests.test_torch_serving import _db_pair, _db_request
from tests.test_torch_sharded_training import (_band, _band_graph, _ext,
                                               _meshes, _numpy_tree,
                                               _path_graph, _source_loc)

BF = torch.bfloat16
SLOPE = 0.2
ULPS = 2
ULP_FLOOR = 1e-3
F32_REL = 1e-3
STATS_REL = 1e-5
ENGINE_TOL = 1e-2
STEP_GRAD_REL = 2e-2
LOSS_TOL = dict(rtol=0.05, atol=0.02)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: one intra-op thread
    keeps the many small torch ops here from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _ulps(got, want) -> float:
    """Largest |got - want| in bf16 ulps of the larger magnitude, taken at
    no less than ULP_FLOOR of max|want|."""
    got, want = _f64(got), _f64(want)
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                       ULP_FLOOR * np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(scale, 1e-30))) - 7)
    return float((np.abs(got - want) / ulp).max())


def _rel(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _round(a) -> np.ndarray:
    """f32 numpy values rounded to bf16 (the operands both sides take)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _tb(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _jb(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


# ---------------------------------------------------------------------------
# The bf16 plain versions of kernels 10-12 against the JAX kernels
# ---------------------------------------------------------------------------

# partitions of a 200-node non-symmetric band over 4 shards of 4 inner
# blocks of 16 (56 padded nodes in the last): the band half-width picks w
PARTS = {"w1": (10, 1, False), "w2": (24, 2, False), "w3": (40, 3, False),
         "holes": (24, 2, True)}


def _part(kind):
    """(port partition, JAX partition, S) of PARTS[kind]; 'holes' has no
    support in a whole window tile and a sub-tile of shard 1."""
    half, w, holes = PARTS[kind]
    S = _band(200, half, 1, seed=20 + half)[0]
    if holes:
        S[64:80, 80:96] = 0
        S[96:104, 112:128] = 0
    part = tpar.partition_nodes(S, 4, order="none", inner_block=16)
    jpart = jpar.partition_nodes(S, 4, order="none", inner_block=16)
    assert (part.inner_bs, part.nbl, part.w) == (16, 4, w)
    return part, jpart, S


def _operands(part, Q, F, seed):
    """bf16-rounded a1, a2 (Q, Np), v and g (Q, F, Np), zero past N."""
    rng = np.random.default_rng(seed)
    N, Np = part.n_orig, part.n_padded

    def rand(*shape):
        t = np.zeros(shape + (Np,), np.float32)
        t[..., :N] = rng.standard_normal(shape + (N,))
        return _round(t)
    return rand(Q), rand(Q), rand(Q, F), rand(Q, F)


def _shard_case(kind, p, Q, F, seed=0):
    """Shard p's bf16 operands of kernels 10-12 (port and JAX layouts) and
    its f32 stats from stats_ext_plain."""
    part, jpart, _ = _part(kind)
    a1, a2, v, g = _operands(part, Q, F, seed)
    mc, mr = tsha._row_col_masks(part)
    w, ibs, bs = part.w, part.inner_bs, part.block_size
    own = slice(p * bs, (p + 1) * bs)
    stats = [taf.stats_ext_plain(_tb(_ext(a1, q, part)),
                                 _tb(a2[:, q * bs:(q + 1) * bs]), _tb(mr[q]),
                                 w=w, ibs=ibs) for q in range(4)]
    mx_ext, sm_ext = (_ext(np.stack([s[i].numpy() for s in stats])
                           .transpose(1, 0, 2).reshape(Q, -1), p, part)
                      for i in (0, 1))
    return dict(part=part, jpart=jpart, w=w, ibs=ibs, own=own,
                a1e=_ext(a1, p, part), a1=a1[:, own], a2=a2[:, own],
                a2e=_ext(a2, p, part), v=v[:, :, own], ve=_ext(v, p, part),
                ge=_ext(g, p, part), mc=mc[p], mr=mr[p],
                slab=part.slabs[p, 0], slab_ext=tsha._ext_slabs(part)[p, 0],
                slab_row=jsha._row_slabs(jpart)[p, 0],
                mx=stats[p][0], sm=stats[p][1], mx_ext=mx_ext, sm_ext=sm_ext)


_J_STATS = jax.jit(jaf._stats_ext_call, static_argnums=(3, 4, 5, 6))
_J_APPLY = jax.jit(jaf._apply_ext_call, static_argnums=(7, 8, 9, 10, 11))
_J_BWD = jax.jit(jaf._bwd_ext_call, static_argnums=(8, 9, 10, 11, 12))


@pytest.mark.parametrize("p", [0, 1, 3], ids=["first", "interior", "last"])
@pytest.mark.parametrize("kind", ["w1", "w2", "w3", "holes"])
def test_stats_ext_bf16_plain_matches_jax(kind, p):
    """stats_ext_plain on bf16 a1_ext, a2 and mask_row (f32 stats) against
    the JAX _stats_ext_call on the same bf16 operands."""
    c = _shard_case(kind, p, 3, 8)
    mx_j, sm_j = _J_STATS(_jb(c["a1e"]), _jb(c["a2"]), _jb(c["mr"]),
                          c["w"], c["ibs"], SLOPE, True)
    for got, want in ((c["mx"], mx_j), (c["sm"], sm_j)):
        assert got.dtype == torch.float32
        assert _rel(got, np.asarray(want).reshape(got.shape)) <= STATS_REL


@pytest.mark.parametrize("p", [0, 3], ids=["first", "last"])
def test_stats_ext_bf16_rows_without_support_match_jax(p):
    """Rows without support on the first and last shards (in their first
    and last w row blocks, windows into a halo past the global ends, and
    in the middle): rowmax -1e12 and rowsum W*ibs, as the JAX kernel."""
    c = _shard_case("w2", p, 2, 8)
    rows = [0, 3, 17, 32, 47, 63]
    mr = c["mr"].copy()
    for r in rows:
        mr[r // c["ibs"], :, r % c["ibs"], :] = 0
    mx, sm = taf.stats_ext_call(_tb(c["a1e"]), _tb(c["a2"]), _tb(mr),
                                w=c["w"], ibs=c["ibs"])
    mx_j, sm_j = (np.asarray(t).reshape(mx.shape) for t in _J_STATS(
        _jb(c["a1e"]), _jb(c["a2"]), _jb(mr), c["w"], c["ibs"], SLOPE, True))
    W = 2 * c["w"] + 1
    assert (mx[:, rows] == -1e12).all() and (mx_j[:, rows] == -1e12).all()
    assert (sm[:, rows] == W * c["ibs"]).all()
    assert (sm_j[:, rows] == W * c["ibs"]).all()
    assert _rel(mx, mx_j) <= STATS_REL and _rel(sm, sm_j) <= STATS_REL


@pytest.mark.parametrize("with_s", [True, False])
@pytest.mark.parametrize("kind,p,F", [
    ("w2", 0, 8), ("w2", 1, 24), ("w2", 3, 32), ("w1", 1, 64),
    ("w3", 0, 24), ("w3", 3, 8), ("holes", 1, 32)])
def test_apply_ext_bf16_plain_matches_jax(kind, p, F, with_s):
    """apply_ext_plain on bf16 operands (f32 stats; y bf16, rounded once)
    against the JAX _apply_ext_call on the same bf16 operands."""
    c = _shard_case(kind, p, 3, F)
    args = (c["a1"], c["a2e"], c["ve"], c["mx_ext"], c["sm_ext"], c["slab"],
            c["mc"])
    kernels.OP_CALLS.clear()
    got = taf.apply_ext_call(*(_tb(a) if i not in (3, 4) else
                               torch.from_numpy(np.asarray(a))
                               for i, a in enumerate(args)),
                             w=c["w"], ibs=c["ibs"], with_s=with_s)
    assert got.dtype == BF
    assert kernels.OP_CALLS == {("apply_ext_call", BF): 1}
    want = _J_APPLY(*(_jb(a) if i not in (3, 4) else jnp.asarray(a)
                      for i, a in enumerate(args)),
                    c["w"], c["ibs"], with_s, SLOPE, True)
    assert want.dtype == jnp.bfloat16
    assert _ulps(got, want) <= ULPS


@pytest.mark.parametrize("with_s", [True, False])
@pytest.mark.parametrize("kind,p,F", [
    ("w2", 0, 8), ("w2", 1, 24), ("w2", 3, 32), ("w1", 3, 64),
    ("w3", 1, 8), ("holes", 1, 24)])
def test_bwd_ext_bf16_plain_matches_jax(kind, p, F, with_s):
    """bwd_ext_plain on bf16 operands (f32 da2 and da1 partials, dv bf16
    rounded once) against the JAX _bwd_ext_call on the same bf16
    operands, its row-layout slab (_row_slabs) beside the port's
    halo-extended column slab."""
    c = _shard_case(kind, p, 2, F, seed=1)
    head = (c["a1e"], c["a2"], c["v"])
    kernels.OP_CALLS.clear()
    got = taf.bwd_ext_call(*map(_tb, head), c["mx"], c["sm"],
                           _tb(c["slab_ext"]), _tb(c["mr"]), _tb(c["ge"]),
                           w=c["w"], ibs=c["ibs"], with_s=with_s)
    assert kernels.OP_CALLS == {("bwd_ext_call", BF): 1}
    assert [t.dtype for t in got] == [torch.float32, torch.float32, BF]
    want = _J_BWD(*map(_jb, head), jnp.asarray(c["mx"].numpy()),
                  jnp.asarray(c["sm"].numpy()), _jb(c["slab_row"]),
                  _jb(c["mr"]), _jb(c["ge"]), c["w"], c["ibs"], with_s,
                  SLOPE, True)
    assert want[2].dtype == jnp.bfloat16
    assert _rel(got[0], want[0]) <= F32_REL
    assert _rel(got[1], want[1]) <= F32_REL
    assert _ulps(got[2], want[2]) <= ULPS


def test_ext_wrappers_take_bf16_on_the_cpu():
    """On the CPU the ext wrappers take bf16 (their plain versions), count
    each call in OP_CALLS by dtype, and round y and dv once: the result is
    the f32 computation on the same values rounded to bf16."""
    c = _shard_case("w2", 1, 2, 8)
    args = (c["a1"], c["a2e"], c["ve"], c["mx_ext"], c["sm_ext"], c["slab"],
            c["mc"])
    bf_args = [_tb(a) if i not in (3, 4) else torch.from_numpy(np.asarray(a))
               for i, a in enumerate(args)]
    f32_args = [t.float() for t in bf_args]
    kw = dict(w=c["w"], ibs=c["ibs"])
    y = taf.apply_ext_call(*bf_args, **kw)
    y32 = taf.apply_ext_call(*f32_args, **kw)
    assert torch.equal(y, y32.to(BF))
    taf.reset_launch_counts()
    kernels.OP_CALLS.clear()
    taf.stats_ext_call(_tb(c["a1e"]), _tb(c["a2"]), _tb(c["mr"]), **kw)
    taf.stats_ext_call(torch.from_numpy(c["a1e"]), torch.from_numpy(c["a2"]),
                       torch.from_numpy(c["mr"]), **kw)
    assert kernels.OP_CALLS == {("stats_ext_call", BF): 1,
                                ("stats_ext_call", torch.float32): 1}
    assert taf.stats_ext_call.launches == 0


# ---------------------------------------------------------------------------
# Sharded bf16 engines
# ---------------------------------------------------------------------------

N_ENG = 96


def _eng_graph():
    """A non-symmetric banded graph of N_ENG nodes (swapped orientations
    differ), eig-normalized."""
    S = _band(N_ENG, 10, 1, seed=13, count=3)[0].astype(np.float64)
    S[np.arange(N_ENG - 1), np.arange(1, N_ENG)] += 1.0
    return S / np.abs(np.linalg.eigvals(S)).max()


ENGINES = {
    # name: (mesh shape, data axis, family, port shift routing)
    "gat_1x2": ((1, 2), None, "gat", "ring"),
    "gat_2x2": ((2, 2), "data", "gat", "ring"),
    "selgnn_ring": ((1, 4), None, "selgnn", "ring"),
    "selgnn_allgather": ((1, 4), None, "selgnn", "allgather"),
    "selgnn_bcsr": ((1, 4), None, "selgnn", "bcsr"),
}
ENGINE_OPS = {"ring": ("band_matmul",), "allgather": ("band_matmul",),
              "bcsr": ("bcsr_matmul",)}


def _eng_models(name, monkeypatch):
    """(JAX model, its params, JAX mesh, port sharded model, port
    unsharded model): the port's on the JAX weights; the sharded ones
    routed as ENGINES[name] says (the port's shard-local steps on the
    kernels' paths: the flash schedule, the band kernel's local
    contraction)."""
    shape, data_axis, family, routing = ENGINES[name]
    tm, jm = _meshes(shape)
    S = _eng_graph()
    if family == "gat":
        args = ([2, 4, 4], [2, 2], "relu", [N_ENG, N_ENG], "NoPool", [1, 1],
                [3], True, S)
        jcls, tcls, kw = (jarch.GraphAttentionNetwork,
                          tarch.GraphAttentionNetwork,
                          dict(attentionMode="band"))
    else:
        args = ([1, 4, 4], [3, 2], True, "relu", [N_ENG, N_ENG], "NoPool",
                [1, 1], [3], S)
        jcls, tcls, kw = (jarch.SelectionGNN, tarch.SelectionGNN,
                          dict(gsoMode="bcsr" if routing == "bcsr"
                               else "band"))
    ja = jcls(*args)
    params = jax.jit(ja.init)(jax.random.PRNGKey(4))
    tu = tcls(*args, device="cpu", **kw)
    load_flax_params(tu, _numpy_tree(params))
    ts = tcls(*args, device="cpu")
    load_flax_params(ts, _numpy_tree(params))
    monkeypatch.setattr(tshift, "_uses_band_kernel", lambda mesh, part: True)
    n = shape[1]
    ts.shard(tm, n, data_axis=data_axis)
    ja.shard(jm, n, data_axis=data_axis)
    if routing == "allgather":
        ts.ctx = dict(ts.ctx, S=tpar.ShardedGso(tm, ts.S.partition,
                                                prefer_ring=False))
        ja.ctx["S"] = jpar.ShardedGso(jm, ja.ctx["S"].partition,
                                      prefer_ring=False)
    elif routing == "bcsr":
        ts.ctx = dict(ts.ctx, S=tpar.ShardedGso(
            tm, tpar.partition_nodes_bcsr(S, n, inner_block=16)))
        ja.ctx["S"] = jpar.ShardedGso(
            jm, jpar.partition_nodes_bcsr(S, n, inner_block=16))
        ja._ctx_cast = {}
    ts.S = ts.ctx["S"]
    if family == "gat":
        ts.S._band_attention = tsha.ShardedBandAttention(
            tm, ts.S.partition, data_axis=data_axis, local_flash=True)
    return ja, params, jm, ts, tu


@pytest.mark.parametrize("name", list(ENGINES))
def test_sharded_bf16_engine_matches(name, monkeypatch):
    """A sharded model's bf16 engine (its ShardedGso's bf16 twin, the bf16
    ext kernels' or shifts' plain versions) against the port's unsharded
    bf16 engine, JAX's unsharded bf16 engine and JAX's sharded bf16 engine
    (each within ENGINE_TOL of max|y|); every kernel op of the sharded
    forward ran in bf16; the caller's model and its ShardedGso stay f32,
    and the twin is made once."""
    ja, params, jm, ts, tu = _eng_models(name, monkeypatch)
    shape, data_axis, family, routing = ENGINES[name]
    x = np.random.default_rng(5).standard_normal(
        (4, 2 if family == "gat" else 1, N_ENG)).astype(np.float32)
    jeng = jserving.InferenceEngine(ja, params, (x,), dtype=jnp.bfloat16)
    with jm:
        j_sharded = np.asarray(jeng(x))
    S = _eng_graph()
    if family == "gat":
        jau = jarch.GraphAttentionNetwork(
            [2, 4, 4], [2, 2], "relu", [N_ENG, N_ENG], "NoPool", [1, 1], [3],
            True, S)
    else:
        jau = jarch.SelectionGNN([1, 4, 4], [3, 2], True, "relu",
                                 [N_ENG, N_ENG], "NoPool", [1, 1], [3], S)
    j_unsharded = np.asarray(jserving.InferenceEngine(
        jau, params, (x,), dtype=jnp.bfloat16)(x))
    u = tserving.InferenceEngine(tu, 4, device="cpu", dtype=BF)(x).numpy()
    eng = tserving.InferenceEngine(ts, 4, device="cpu", dtype=BF)
    kernels.OP_CALLS.clear()
    got = eng(x[:3])
    calls = dict(kernels.OP_CALLS)
    got_full = eng(x).numpy()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), got_full[:3])
    scale = np.abs(u).max()
    for want, what in ((u, "port unsharded"), (j_unsharded, "JAX unsharded"),
                       (j_sharded, "JAX sharded")):
        err = np.abs(got_full - want).max()
        print(f"{name}: |sharded bf16 port - {what} bf16| {err:.3e}, "
              f"max|y| {scale:.3e}")
        assert err <= ENGINE_TOL * np.abs(want).max(), what
    ops = (("stats_ext_call", "apply_ext_call") if family == "gat"
           else ENGINE_OPS[routing])
    assert set(calls) == {(op, BF) for op in ops}, calls
    # the caller's model and ShardedGso stay f32; the served twin is the
    # ShardedGso's memoized bf16 twin on the same mesh and partition
    assert all(p.dtype == torch.float32 for p in ts.parameters())
    assert ts.S.dtype == torch.float32
    twin = eng._served.ctx["S"]
    assert twin is ts.S.to(dtype=BF) and twin.dtype == BF
    assert twin.to(dtype=torch.float32) is ts.S
    assert twin.partition is ts.S.partition and twin.mesh is ts.S.mesh


def test_sharded_gso_twin_casts_floats_once_and_shares_tables():
    """ShardedGso.to(dtype=) of each routing: the shift's float tables in
    bf16, its integer tables (BCSR indices, segment offsets) the f32
    ShardedGso's own tensors; the attention operator's slabs and masks in
    bf16 (the own slab a view of the halo-extended one), its entry lists
    shared."""
    tm, _ = _meshes((1, 4))
    S = _eng_graph()
    ring = tpar.ShardedGso(tm, tpar.partition_nodes(S, 4, order="none"))
    bcsr = tpar.ShardedGso(tm, tpar.partition_nodes_bcsr(S, 4,
                                                         inner_block=16))
    for sg in (ring, bcsr):
        tw = sg.to(dtype=BF)
        assert sg.to(dtype=BF) is tw and sg.to("cpu") is sg
        for key, ts in sg._shift.tables.items():
            for t, t2 in zip(ts, tw._shift.tables[key]):
                if t.is_floating_point():
                    assert t2.dtype == BF and t.dtype == torch.float32
                    assert torch.equal(t2, t.to(BF))
                else:
                    assert t2 is t
    sattn = tsha.ShardedBandAttention(tm, ring.partition, local_flash=True)
    ring._band_attention = sattn
    twin = ring.to(dtype=BF).band_attention
    w, nbl = ring.partition.w, ring.partition.nbl
    for key, (own, mcol, mrow, ext, lists) in twin._shard_ops.items():
        f_own, f_mcol, f_mrow, f_ext, f_lists = sattn._shard_ops[key]
        assert own.dtype == mcol.dtype == mrow.dtype == ext.dtype == BF
        assert own.data_ptr() == ext[:, w:w + nbl].data_ptr()
        assert torch.equal(ext, f_ext.to(BF)) and lists is f_lists
    with pytest.raises(ValueError, match="lives on its mesh"):
        ring.to(torch.device("meta"))


def test_sharded_bf16_shift_stays_bf16_where_jax_promotes():
    """The kept divergence (ROADMAP queue 3): the JAX ShardedGso is a
    leafless pytree whose slabs stay f32, so its sharded shift of a bf16
    signal promotes to f32 on the CPU; the port's bf16 twin rounds S to
    bf16 and returns bf16, as both packages' unsharded bf16 engines do.
    The values agree within ENGINE_TOL of max|y|."""
    tm, jm = _meshes((1, 4))
    S = _eng_graph()
    sg_t = tpar.ShardedGso(tm, tpar.partition_nodes(S, 4, order="none"))
    sg_j = jpar.ShardedGso(jm, jpar.partition_nodes(S, 4, order="none"))
    x = _round(np.random.default_rng(7).standard_normal((3, 1, 2, N_ENG)))
    got = sg_t.to(dtype=BF).shift(_tb(x))
    with jm:
        want = jax.jit(sg_j.shift)(_jb(x))
    assert got.dtype == BF
    assert want.dtype == jnp.float32
    assert np.abs(_f64(got) - _f64(want)).max() <= (
        ENGINE_TOL * np.abs(_f64(want)).max())


# ---------------------------------------------------------------------------
# Sharded bf16 training
# ---------------------------------------------------------------------------

TRAINED = {
    # kind: (JAX class, port class, args before S, N)
    "selgnn": (jarch.SelectionGNN, tarch.SelectionGNN,
               ([1, 4], [3], True, "relu", [32], "NoPool", [1], [2]), 32),
    "gat": (jarch.GraphAttentionNetwork, tarch.GraphAttentionNetwork,
            ([1, 4], [2], "relu", [32], "NoPool", [1], [2], True), 32),
}
OPT = {"name": "ADAM", "lr": 5e-3}


def _trained_graph(kind, N):
    W = _path_graph(N)
    S = W / np.max(np.abs(np.linalg.eigvalsh(W)))
    if kind == "gat":   # a directed graph: swapped orientations differ
        S = S * (1 + np.triu(np.ones((N, N)), 1))
    return W, S


def _port_model(kind, S, params, path, shard=None, monkeypatch=None):
    """The port's model on the JAX weights: unsharded in band mode (the
    flash kernels, the band shift), or sharded 4 ways over `shard`'s
    'graph' axis (the flash schedule, the ring shift's kernel path)."""
    _, cls_t, args, _ = TRAINED[kind]
    mode = ({} if shard is not None else dict(attentionMode="band")
            if kind == "gat" else dict(gsoMode="band"))
    ta = cls_t(*args, S, device="cpu", **mode)
    load_flax_params(ta, _numpy_tree(params))
    if shard is not None:
        monkeypatch.setattr(tshift, "_uses_band_kernel",
                            lambda mesh, part: True)
        ta.shard(shard, 4, data_axis="data")
        if kind == "gat":
            ta.S._band_attention = tsha.ShardedBandAttention(
                shard, ta.S.partition, data_axis="data", local_flash=True)
    return ttrain.Model(ta, ttrain.losses.cross_entropy_loss, OPT,
                        ttrain.Trainer, ttrain.evaluate, name="t",
                        saveDir=str(path))


@pytest.mark.parametrize("kind", ["selgnn", "gat"])
def test_sharded_bf16_trainer_matches(kind, tmp_path, monkeypatch):
    """A model sharded over the 'graph' axis of a (2, 4) mesh and trained
    with Trainer(mesh=..., meshAxis='data', precision='bf16') (the ring
    shift on band_matmul's and the flash schedule on kernels 10-12's plain
    versions, all in bf16): its first-step gradients on the f32 masters
    against the port's unsharded bf16 Trainer's, and 3 steps' losses
    against the JAX sharded model trained by the JAX Trainer(mesh=...,
    precision='bf16') from the same weights; the masters stay f32."""
    cls_j, _, args, N = TRAINED[kind]
    W, S = _trained_graph(kind, N)
    data = _source_loc(N, W, seed=17)
    tm, jm = _meshes((2, 4))
    ja = cls_j(*args, S)
    ja.shard(jm, 4, data_axis="data")
    jmodel = jtrain.Model(ja, jtrain.losses.cross_entropy_loss, OPT,
                          jtrain.Trainer, jtrain.evaluate, name="j",
                          saveDir=str(tmp_path / "j"), seed=8)
    params = _numpy_tree(jmodel.params)
    kw = dict(nEpochs=1, batchSize=16, validationInterval=3,
              precision="bf16")
    with jm:
        want = jmodel.train(data, mesh=jm, meshAxis="data", **kw)

    idx = np.arange(16)
    grads = {}
    for sharded in (False, True):
        m = _port_model(kind, S, params, tmp_path / f"g{sharded}",
                        tm if sharded else None, monkeypatch)
        tr = ttrain.Trainer(m, data, 1, 16, precision="bf16",
                            **(dict(mesh=tm, meshAxis="data") if sharded
                               else {}))
        kernels.OP_CALLS.clear()
        tr.train_batch(idx)
        if sharded:
            ops = ({"stats_ext_call", "apply_ext_call", "bwd_ext_call"}
                   if kind == "gat" else {"band_matmul"})
            assert {(op, BF) for op in ops} == set(kernels.OP_CALLS), \
                kernels.OP_CALLS
        grads[sharded] = [p.grad.double().clone()
                          for p in m.archit.parameters()]
    for g, g0 in zip(grads[True], grads[False]):
        assert (g - g0).abs().max() <= STEP_GRAD_REL * max(
            g0.abs().max().item(), 1e-12)

    m = _port_model(kind, S, params, tmp_path / "t", tm, monkeypatch)
    got = m.train(data, mesh=tm, meshAxis="data", **kw)
    assert len(got["lossTrain"]) == 3
    np.testing.assert_allclose(got["lossTrain"], want["lossTrain"],
                               **LOSS_TOL)
    assert {p.dtype for p in m.archit.parameters()} == {torch.float32}
    assert m.archit.S.dtype == torch.float32


def test_sharded_grnn_bf16_runs_f32_on_rounded_params(tmp_path):
    """A sharded GraphRecurrentNN (compute_f32) under precision='bf16':
    the f32 sharded path on bf16-rounded parameters, as JAX's type
    promotion gives it; its first-step gradients against the unsharded
    GRNN's bf16 step's within STEP_GRAD_REL of each leaf's max, its
    output f32."""
    N, T = 32, 4
    W = _band_graph(N, seed=3)
    args = (1, 3, 4, [3, 2], True, "tanh", "relu", "identity", [3], W)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((6, T, 1, N)).astype(np.float32)
    y = rng.integers(0, 3, (6,))
    data = _seq_data(x, y)
    tm, _ = _meshes((1, 4))
    grads = {}
    for sharded in (False, True):
        ta = tarch.GraphRecurrentNN(
            *args, device="cpu", generator=torch.Generator().manual_seed(2))
        assert ta.compute_f32
        if sharded:
            ta.shard(tm, 4)
        m = ttrain.Model(ta, _seq_loss, OPT, ttrain.Trainer, ttrain.evaluate,
                         name="g", saveDir=str(tmp_path / str(sharded)))
        tr = ttrain.Trainer(m, data, 1, 6, precision="bf16", seed=0)
        out = tr._mixed(tr._forward, torch.from_numpy(x),
                        torch.Generator().manual_seed(1))
        assert out.dtype == torch.float32
        tr.generator = torch.Generator().manual_seed(5)
        tr.train_batch(np.arange(6))
        grads[sharded] = [p.grad.double().clone() for p in ta.parameters()]
    for g, g0 in zip(grads[True], grads[False]):
        assert (g - g0).abs().max() <= STEP_GRAD_REL * max(
            g0.abs().max().item(), 1e-12)


class _seq_data:
    """A minimal data object for Trainer: 6 training sequences."""
    nTrain = 6

    def __init__(self, x, y):
        self.x, self.y = x, y

    def getSamples(self, split, idx=None):
        idx = np.arange(len(self.x)) if idx is None else idx
        return self.x[idx], self.y[idx]

    def evaluate(self, yHat, y):
        return float(np.mean(np.argmax(yHat, 1) != y))


def _seq_loss(y_hat, y):
    """Cross-entropy on the last step's readout (B, T, C) -> (B, C)."""
    return ttrain.losses.cross_entropy_loss(y_hat[:, -1].reshape(
        y_hat.shape[0], -1), y)


# ---------------------------------------------------------------------------
# The ShardedEllGso pytree: engine(x, ShardedEllGso)
# ---------------------------------------------------------------------------

def test_engine_serves_a_sharded_ell_gso():
    """LocalGNN_DB served as engine(x, ShardedEllGso) over a (1, 4) mesh:
    in f32 equal to engine(x, EllGso) and to the JAX engine on the JAX
    ShardedEllGso; padded and cast leaf by leaf, still sharded (in bf16
    val cast, idx kept), the bf16 answer against JAX's bf16 engine."""
    jnet, params, tnet = _db_pair("local")
    x, jS, tS = _db_request(11, "ell")
    tm, jm = _meshes((1, 4))
    tsh = tpar.shard_ell(tS, tm)
    jsh = jpar.shard_ell(jS, jm)
    assert tsh.n == tS.n == 12
    eng = tserving.InferenceEngine(tnet, 4, device="cpu")
    for n in (4, 3, 1):
        rows = tuple(t[:n] for t in (tS.idx, tS.val))
        want = eng(x[:n], type(tS)(*rows))
        got = eng(x[:n], tpar.ShardedEllGso(*rows, tm))
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    with jm:
        j32 = np.asarray(jserving.InferenceEngine(jnet, params, (x, jsh))(
            x, jsh))
    np.testing.assert_allclose(eng(x, tsh).numpy(), j32, atol=1e-5,
                               rtol=1e-5)
    beng = tserving.InferenceEngine(tnet, 4, device="cpu", dtype=BF)
    n, (xp, Sp) = beng._padded((x[:3], tpar.ShardedEllGso(
        tsh.idx[:3], tsh.val[:3], tm, n_orig=tsh.n_orig)))
    assert n == 3 and type(Sp) is tpar.ShardedEllGso
    assert Sp.val.dtype == BF and Sp.idx.dtype == tsh.idx.dtype
    assert Sp.idx.shape[0] == 4 and Sp.mesh is tm and xp.dtype == BF
    # a bf16 training step casts a batch's ShardedEllGso the same way
    from graph_neural_networks_torch.training.trainer import _cast_floats
    xc, Sc = _cast_floats((torch.from_numpy(x), tsh), BF)
    assert xc.dtype == BF and type(Sc) is tpar.ShardedEllGso
    assert Sc.val.dtype == BF and Sc.idx is tsh.idx and Sc.mesh is tm
    assert Sc.n_orig == tsh.n_orig
    got = beng(x, tsh).numpy()
    with jm:
        want = np.asarray(jserving.InferenceEngine(
            jnet, params, (x, jsh), dtype=jnp.bfloat16)(x, jsh))
    assert np.abs(got - want).max() <= ENGINE_TOL * np.abs(want).max()
