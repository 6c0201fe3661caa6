"""Edge-list attention: SDDMM and segment softmax, O(E) memory.

The port of the JAX package's ``ops/attention_sparse.py``. The dense
attention path (``filters.attention_gso``) materializes the (B, P, E, N, N)
coefficients; this module computes the same coefficients on the S+I
support's edge list, and gives the edge-list form of every attention
functional (GAT aggregation, GCAT K-tap filtering, per-hop edge-variant
attention), so the attention architectures run in O(E) with
``attentionMode='edge'``. The same :class:`EdgeList` is the COO GSO of
``gsoMode='edge'`` (``gso.gshift``) and carries the recurrent family's
per-edge gates (``filters.gated_grnn(edge_gated=True)``).

Orientation (the reference's, graphML.py:713, 807): the score on edge (i
row, j col) is e_ij = LeakyReLU(a2.Wx_i + a1.Wx_j), the softmax normalizes
over each ROW i's edges, and the output at node m aggregates over rows:
y_m = sum_i s_im alpha_im Wx_i.

Plain torch, as the JAX module is plain XLA: the segment sums of
``jax.ops.segment_sum`` are ``index_add_``, its segment max
``scatter_reduce(reduce='amax')``. The max only shifts the exponent: its
gradient cancels, so it is taken without one. In bf16 (bf16 serving and
bf16 mixed precision) every tensor here is bf16 as in JAX, but a segment
sum accumulates in f32 and is rounded to bf16 once (JAX sums in bf16: an
``index_add_`` in bf16 would round at every add, by atomics in an order
of their own on the card). As the JAX module moves the
edge axis first for its segment ops, the gathers and segment reductions
here run node- or edge-major ((N, ...) and (nnz, ...) rows): a row is
contiguous, and the backward of ``index_select`` is an ``index_add_`` of
rows (advanced indexing on the last axis would expand its index to every
element of the gathered tensor in the backward and sort it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree

from graph_neural_networks_torch.utils.device import resolve_device

ZERO_TOL = 1e-9
# rows of the host support scan at a time: bounds the float64 temporaries
# of build_edge_list to SCAN_ROWS x N
SCAN_ROWS = 1024


@dataclasses.dataclass
class EdgeList:
    """COO support of S+I (self-loops added, reference graphML.py:692),
    sorted by row. row, col: (nnz,) int64; s_val: (E, nnz) f32 (bf16 in
    a bf16 copy, :meth:`to`) = S[e, row, col] (0 on the added self-loops
    unless S had them). A pytree node, as the JAX package's: its leaves
    row, col and s_val, n_nodes its context."""

    row: torch.Tensor
    col: torch.Tensor
    s_val: torch.Tensor
    n_nodes: int = 0

    @property
    def n(self) -> int:
        """The GSO surface of ``layers._gso_n``."""
        return self.n_nodes

    @property
    def n_edge_features(self) -> int:
        return self.s_val.shape[0]

    @property
    def nnz(self) -> int:
        return self.row.shape[0]

    def to(self, device=None, dtype=None) -> "EdgeList":
        """A copy on `device` with s_val in `dtype` (row and col kept
        int64); self when nothing changes."""
        dev = None if device is None else torch.device(device)
        moves = dev is not None and not (
            self.row.device.type == dev.type
            and dev.index in (None, self.row.device.index))
        casts = dtype is not None and self.s_val.dtype != dtype
        if not (moves or casts):
            return self
        row, col, s_val = (t.to(dev) if moves else t
                           for t in (self.row, self.col, self.s_val))
        return EdgeList(row, col, s_val.to(dtype) if casts else s_val,
                        self.n_nodes)


_pytree.register_pytree_node(
    EdgeList,
    lambda e: ([e.row, e.col, e.s_val], e.n_nodes),
    lambda leaves, n: EdgeList(*leaves, n),
    serialized_type_name="graph_neural_networks_torch.ops."
                         "attention_sparse.EdgeList",
    flatten_with_keys_fn=lambda e: (
        [(_pytree.GetAttrKey(k), getattr(e, k))
         for k in ("row", "col", "s_val")], e.n_nodes))


def _host_dense(S) -> np.ndarray:
    """(E, N, N) numpy view of a dense GSO: an ndarray, a tensor, or a
    ``gso.Gso`` (its dense S)."""
    S = getattr(S, "S", S)
    if isinstance(S, torch.Tensor):
        S = S.detach().cpu().numpy()
    S = np.asarray(S)
    return S[None] if S.ndim == 2 else S


def build_edge_list(S, device="cuda") -> EdgeList:
    """Host-side: the S+I support as a row-sorted COO edge list on
    `device` (the card unless told otherwise).

    The arrays equal the JAX ``build_edge_list``'s element for element
    (the row-major ``np.nonzero`` of ``(|S|.sum(0) + I) > 1e-9``), computed
    SCAN_ROWS rows at a time with the same arithmetic, so no N x N
    temporary is made beyond S itself.
    """
    S = _host_dense(S)
    E, N, _ = S.shape
    rows, cols = [], []
    for r0 in range(0, N, SCAN_ROWS):
        r1 = min(r0 + SCAN_ROWS, N)
        eye = np.zeros((r1 - r0, N))
        eye[np.arange(r1 - r0), np.arange(r0, r1)] = 1.0
        r, c = np.nonzero((np.abs(S[:, r0:r1]).sum(0) + eye) > ZERO_TOL)
        rows.append(r + r0)
        cols.append(c)
    row = np.concatenate(rows)
    col = np.concatenate(cols)
    s_val = np.asarray(S[:, row, col], np.float32)            # (E, nnz)
    dev = resolve_device(device)
    return EdgeList(torch.as_tensor(row, dtype=torch.long, device=dev),
                    torch.as_tensor(col, dtype=torch.long, device=dev),
                    torch.as_tensor(s_val, device=dev), N)


def _rows_first(t: torch.Tensor, lead: tuple, tail: tuple) -> torch.Tensor:
    """t (lead_t..., tail..., M) as (M, 1..., lead_t..., tail...): the last
    axis first, padded with unit axes so lead_t right-aligns with `lead`."""
    t = t.movedim(-1, 0)
    pad = len(lead) - (t.dim() - 1 - len(tail))
    return t.reshape((t.shape[0],) + (1,) * pad + t.shape[1:])


def _segment_sum(e: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment sum of e (nnz, ...) over seg (nnz,) -> (n, ...), in e's
    dtype; a bf16 (or f16) e accumulated in f32 and rounded once."""
    if e.dtype in (torch.bfloat16, torch.float16):
        return _segment_sum(e.float(), seg, n).to(e.dtype)
    return e.new_zeros((n,) + e.shape[1:]).index_add_(0, seg, e)


class _EdgeShift(torch.autograd.Function):
    """out[m] = sum over the edges k into m of cm[k] * vn[row[k]], node- and
    edge-major: vn (N, ..., D), cm (nnz, ..., 1) broadcasting against it.
    The backward keeps vn, cm and the indices and gathers again, so a
    shift holds no edge-sized tensor of its own (autograd through the
    gather, the product and ``index_add_`` would keep the gathered rows
    and the messages, nnz rows each, for every shift of a recurrence)."""

    @staticmethod
    def forward(ctx, vn, cm, row, col, n: int):
        out = _segment_sum(cm * vn.index_select(0, row), col, n)
        ctx.save_for_backward(vn, cm, row, col)
        return out

    @staticmethod
    def backward(ctx, g):
        vn, cm, row, col = ctx.saved_tensors
        g_msg = g.index_select(0, col)                 # nnz x ... x D
        grad_v = grad_c = None
        if ctx.needs_input_grad[0]:
            grad_v = _segment_sum(cm * g_msg, row,
                                  vn.shape[0]).sum_to_size(vn.shape)
        if ctx.needs_input_grad[1]:
            grad_c = (g_msg * vn.index_select(0, row)).sum_to_size(cm.shape)
        return grad_v, grad_c, None, None, None


def edge_shift(v: torch.Tensor, coeff: torch.Tensor,
               edges: EdgeList) -> torch.Tensor:
    """Edge-weighted graph shift: y[..., m] = sum_i v[..., i] c[..., (i,m)].

    v: (..., D, N) node values, coeff: (..., nnz) per-edge weights with
    leading dims that broadcast against v's; the message on edge k flows
    row[k] -> col[k]: a gather of node rows, the product, an
    ``index_add_`` of edge rows into the column nodes (:class:`_EdgeShift`).
    Returns (..., D, N) (a view of the node-major result).
    """
    lead = torch.broadcast_shapes(coeff.shape[:-1], v.shape[:-2])
    vn = _rows_first(v, lead, v.shape[-2:-1]).contiguous()  # N x ... x D
    cm = _rows_first(coeff, lead, ())[..., None]            # nnz x ... x 1
    out = _EdgeShift.apply(vn, cm, edges.row, edges.col, edges.n_nodes)
    return out.movedim(0, -1)


def _segment_max(e: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment max of e (nnz, ...) over seg (nnz,) -> (n, ...)."""
    idx = seg.reshape((-1,) + (1,) * (e.dim() - 1)).expand_as(e)
    return e.new_full((n,) + e.shape[1:], -torch.inf).scatter_reduce(
        0, idx, e, reduce="amax", include_self=False)


def attention_coefficients_edges(x: torch.Tensor, a: torch.Tensor,
                                 W: torch.Tensor, edges: EdgeList,
                                 negative_slope: float = 0.2):
    """Per-edge attention coefficients alpha (B, P, E, nnz), the sparse
    equivalent of ``filters.attention_gso`` (alpha on edge k equals the
    dense alpha[row[k], col[k]]), and Wx (B, P, E, F, N).
    x: (B,G,N), a: (P,E,2F), W: (P,E,F,G)."""
    F = W.shape[2]
    Wx = torch.einsum("pefg,bgn->bpefn", W, x)
    a1, a2 = a[..., :F], a[..., F:]
    # node-major (N, B, P, E) projections: a1 pairs with the column j, a2
    # with the row i
    a1Wx = torch.einsum("pef,bpefn->nbpe", a1, Wx).contiguous()
    a2Wx = torch.einsum("pef,bpefn->nbpe", a2, Wx).contiguous()
    # SDDMM: scores on the edges only, edge-major (nnz, B, P, E)
    e = torch.nn.functional.leaky_relu(
        a2Wx.index_select(0, edges.row) + a1Wx.index_select(0, edges.col),
        negative_slope=negative_slope)
    # segment softmax over each row's edges (every row has its self-loop)
    n = edges.n_nodes
    e_max = _segment_max(e.detach(), edges.row, n)
    e_exp = torch.exp(e - e_max.index_select(0, edges.row))
    denom = _segment_sum(e_exp, edges.row, n)
    alpha = e_exp / denom.index_select(0, edges.row)
    return alpha.movedim(0, -1), Wx                      # B x P x E x nnz


def graph_attention_edges(x, a, W, edges: EdgeList,
                          negative_slope: float = 0.2) -> torch.Tensor:
    """GAT layer output by edge-list aggregation, the sparse equivalent of
    ``filters.graph_attention``: y[..., m] = sum_i s_im alpha_im Wx_i.
    Returns (B, P, F, N)."""
    alpha, Wx = attention_coefficients_edges(x, a, W, edges, negative_slope)
    y = edge_shift(Wx, edges.s_val[None, None] * alpha, edges)
    return y.sum(dim=2)                  # over the edge features E


def gat_lsigf_edges(h, x, a, W, edges: EdgeList,
                    b: Optional[torch.Tensor] = None,
                    negative_slope: float = 0.2) -> torch.Tensor:
    """K-tap LSIGF over the learned attention coefficients (GCAT), the
    edge-list ``filters.gat_lsigf``: the shift operator is alpha itself
    (reference graphML.py:876-879), never materialized as N x N.
    h: (E,K), x: (B,G,N), a: (P,E,2F), W: (P,E,F,G) -> y: (B,P,F,N)."""
    E, K = h.shape
    P, _, F, G = W.shape
    B, _, N = x.shape
    alpha, _ = attention_coefficients_edges(x, a, W, edges, negative_slope)
    # the tap-layout quirk of the dense path (filters.gat_lsigf; reference
    # graphML.py:863-865), kept for parity
    W_taps = W.permute(0, 3, 1, 2).reshape(P, F, E, 1, G)
    hW = h[None, None, :, :, None] * W_taps               # P x F x E x K x G
    xe = x[:, None, None].expand(B, P, E, G, N)
    zs = [xe]
    for _ in range(1, K):
        xe = edge_shift(xe, alpha, edges)
        zs.append(xe)
    z = torch.stack(zs, dim=3)                            # B,P,E,K,G,N
    y = torch.einsum("bpekgn,pfekg->bpfn", z, hW)
    return y if b is None else y + b


def gat_evgf_edges(x, a, W, edges: EdgeList,
                   b: Optional[torch.Tensor] = None,
                   negative_slope: float = 0.2) -> torch.Tensor:
    """Edge-variant filter whose hop k is its own attention mechanism, the
    edge-list ``filters.gat_evgf`` (reference graphML.py:897-969).
    a: (P,K,E,2F), W: (P,K,E,F,G) -> y: (B,P,F,N)."""
    K = W.shape[1]
    sw = edges.s_val[None, None]
    alpha0, _ = attention_coefficients_edges(x, a[:, 0], W[:, 0], edges,
                                             negative_slope)
    W0x = torch.einsum("pefg,bgn->bpefn", W[:, 0], x)
    W0x = edge_shift(W0x, sw * alpha0, edges)
    y = W0x
    for k in range(1, K):
        alpha_k, _ = attention_coefficients_edges(x, a[:, k], W[:, k], edges,
                                                  negative_slope)
        W0x = edge_shift(W0x, sw * alpha_k, edges)
        y = y + W0x
    y = y.sum(dim=2)
    return y if b is None else y + b
