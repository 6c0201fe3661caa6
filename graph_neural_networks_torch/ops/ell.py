"""ELL (padded in-neighbor) layout for time-varying batched GSOs.

The port of the JAX package's ``ops/ell.py``: a fixed-width padded
in-neighbor table, the ELLPACK layout --

  * ``idx``: ``(*L, N, D)`` int32 -- ``idx[..., m, d]`` is the d-th
    in-neighbor ``n`` of output node ``m`` (entries beyond the true
    in-degree carry weight 0),
  * ``val``: ``(*L, E, N, D)`` -- ``val[..., e, m, d] = S[..., e, n, m]``
    with ``n = idx[..., m, d]``,

where ``*L`` are leading (batch/time) axes shared by both. The grid
environment's rollouts and the training-batch recompute return their
graph trajectories in it, and the delayed filters (``ops.filters.
lsigf_db``) shift over it: the graph shift ``y = x·S`` (output node m sums
its in-neighbors) is one row gather and one D-length contraction,
O(N·D) memory. The JAX package does the gather in XLA, not in a Pallas
kernel, so the port is plain torch; :class:`EllShiftRows` gives it a
backward that keeps only idx and val, never the gathered rows.
:func:`ell_topk` converts the all-pairs closed loop's dense per-step
graphs on the device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree

__all__ = ["EllGso", "ell_from_dense", "ell_topk", "ell_to_dense",
           "ell_shift", "ell_shift_rows", "EllShiftRows"]


class EllGso:
    """Padded in-neighbor (ELLPACK) time-varying GSO; see module docstring.

    idx: (*L, N, D) integer, val: (*L, E, N, D), numpy arrays or tensors.
    Leading axes *L are shared (e.g. (B, T) for the DB family, (B,) for
    one time step).
    """

    def __init__(self, idx, val):
        if not (tuple(idx.shape[:-2]) == tuple(val.shape[:-3])
                and tuple(idx.shape[-2:]) == tuple(val.shape[-2:])):
            raise ValueError(f"EllGso: idx {tuple(idx.shape)} does not fit "
                             f"val {tuple(val.shape)}")
        self.idx = idx
        self.val = val

    @property
    def n(self) -> int:
        return self.val.shape[-2]

    @property
    def d(self) -> int:
        return self.val.shape[-1]

    @property
    def n_edge_features(self) -> int:
        return self.val.shape[-3]

    def time_step(self, t: int) -> "EllGso":
        """The (B,)-led graph of step t of a (B, T)-led stack."""
        return EllGso(self.idx[:, t], self.val[:, t])

    def db_shift(self, x: torch.Tensor) -> torch.Tensor:
        """One graph shift of x: (*L, E, G, N) -> (*L, E, G, N)."""
        return ell_shift(x, self)

    def db_shift_rows(self, xr: torch.Tensor) -> torch.Tensor:
        """Node-major shift of xr: (*L, N, E, G) -> (*L, No, E, G)."""
        return ell_shift_rows(xr, self)

    def __repr__(self):
        return (f"EllGso(lead={tuple(self.idx.shape[:-2])}, N={self.n}, "
                f"D={self.d}, E={self.n_edge_features})")


# A pytree node (the JAX package registers it with jax.tree_util): padding,
# casting and torch.export see its two leaves, idx and val.
_pytree.register_pytree_node(
    EllGso,
    lambda e: ([e.idx, e.val], None),
    lambda leaves, _: EllGso(*leaves),
    serialized_type_name="graph_neural_networks_torch.ops.ell.EllGso",
    flatten_with_keys_fn=lambda e: ([(_pytree.GetAttrKey("idx"), e.idx),
                                     (_pytree.GetAttrKey("val"), e.val)],
                                    None))


def ell_from_dense(S, d_max=None) -> EllGso:
    """Host-side exact conversion of a dense GSO stack to ELL tensors.

    S: (*L, E, N, N) array. d_max=None uses the max in-degree over the
    whole stack (exact); a smaller d_max keeps the top-d_max entries of
    each column by max-over-E magnitude (a capped approximation). The
    same stable ordering as the JAX function, so the same idx.
    """
    S = np.asarray(S)
    mag = np.abs(S).max(axis=-3)                      # (*L, n, m)
    magt = np.swapaxes(mag, -1, -2)                   # (*L, m, n)
    if d_max is None:
        d_max = max(int((magt > 0).sum(axis=-1).max()), 1)
    idx = np.argsort(-magt, axis=-1, kind="stable")[..., :d_max]
    idx = np.ascontiguousarray(idx).astype(np.int32)  # (*L, N, D)
    St = np.swapaxes(S, -1, -2)                       # (*L, E, m, n)
    gather = np.broadcast_to(idx[..., None, :, :], St.shape[:-1] + (d_max,))
    val = np.take_along_axis(St, gather, axis=-1)     # (*L, E, N, D)
    return EllGso(torch.as_tensor(idx), torch.as_tensor(np.ascontiguousarray(
        val)))


def ell_topk(S: torch.Tensor, d_max: int) -> EllGso:
    """Dense-to-ELL conversion on the tensor's device: the d_max largest
    entries of each column by max-over-E magnitude, equal ones in index
    order (as lax.top_k, the JAX function's). Exact when d_max >= the max
    in-degree. S: (*L, E, N, N)."""
    magt = S.abs().amax(dim=-3).transpose(-1, -2)       # (*L, m, n)
    idx = torch.sort(magt, dim=-1, descending=True,
                     stable=True).indices[..., :d_max]  # (*L, N, D)
    St = S.transpose(-1, -2)                            # (*L, E, m, n)
    val = torch.gather(St, -1, idx[..., None, :, :].expand(
        St.shape[:-1] + (d_max,)))
    return EllGso(idx.to(torch.int32), val)


def ell_to_dense(ell: EllGso) -> np.ndarray:
    """Host-side scatter of an EllGso back to the dense (*L, E, N, N)
    stack (small N only: tests and references)."""
    idx = np.asarray(torch.as_tensor(ell.idx).cpu())
    val = np.asarray(torch.as_tensor(ell.val).cpu())
    lead = idx.shape[:-2]
    E, N, D = val.shape[-3:]
    S = np.zeros(lead + (E, N, N), val.dtype)
    Sf = S.reshape((-1, E, N, N))
    idxf = idx.reshape((-1, N, D))
    valf = val.reshape((-1, E, N, D))
    m = np.broadcast_to(np.arange(N)[:, None], (N, D))
    for i in range(Sf.shape[0]):
        for e in range(E):
            np.add.at(Sf[i, e], (idxf[i], m), valf[i, e])
    return S


class EllShiftRows(torch.autograd.Function):
    """The node-major ELL shift with a memory-lean backward.

    forward(xf (Bf, Nn, E*G), idxf (Bf, No, D), valf (Bf, E, No, D)) ->
    (Bf, No, E*G): y[b, m, e*G + g] = sum_d val[b, e, m, d] *
    x[b, idx[b, m, d], e*G + g]. It saves idx and val only: the gathered
    (No*D, E*G) rows of every call would otherwise stay alive until the
    backward (20 GB over 50 steps of a 262,144-agent batch). The backward
    adds grad_y x val into the source rows with one ``index_add_``. The
    table is data, not a parameter: val gets no gradient. val may be f32 or
    bf16; it is taken in x's dtype (a bf16 engine serves both in bf16).
    """

    @staticmethod
    def forward(ctx, xf, idxf, valf):
        Bf, Nn, EG = xf.shape
        E = valf.shape[1]
        G = EG // E
        No, D = idxf.shape[1:]
        rows = torch.gather(xf, 1, idxf.reshape(Bf, No * D, 1).long()
                            .expand(Bf, No * D, EG)).view(Bf, No, D, EG)
        vf = valf.to(xf.dtype)
        if E == 1:
            y = torch.einsum("bndc,bnd->bnc", rows, vf[:, 0])
        else:
            y = torch.einsum("bndeg,bend->bneg",
                             rows.view(Bf, No, D, E, G), vf).reshape(
                                 Bf, No, EG)
        ctx.save_for_backward(idxf, valf)
        ctx.shape = (Bf, Nn, E, G)
        return y

    @staticmethod
    def backward(ctx, gy):
        idxf, valf = ctx.saved_tensors
        Bf, Nn, E, G = ctx.shape
        No, D = idxf.shape[1:]
        contrib = (gy.reshape(Bf, No, 1, E, G)
                   * valf.to(gy.dtype).permute(0, 2, 3, 1)[..., None])
        rows = (idxf.long() + Nn * torch.arange(
            Bf, device=idxf.device).view(Bf, 1, 1)).reshape(-1)
        gx = gy.new_zeros(Bf * Nn, E * G)
        gx.index_add_(0, rows, contrib.reshape(Bf * No * D, E * G))
        return gx.view(Bf, Nn, E * G), None, None


def ell_shift_rows(xr: torch.Tensor, ell: EllGso) -> torch.Tensor:
    """One graph shift on the node-major layout: xr (*L, Nn, E, G) ->
    (*L, No, E, G), the semantics of ``ell_shift`` up to the transpose.

    All leading axes flatten into one batch axis and whole feature rows
    (E*G wide) are gathered along the node axis. The table may be
    rectangular: idx/val rows are the output nodes while xr's node axis
    holds the gather source. Differentiable in xr only.
    """
    idx, val = ell.idx, ell.val
    if val.requires_grad:
        raise ValueError("ell_shift_rows differentiates the signal only; "
                         "the table's val must not require grad")
    *L, Nn, E, G = xr.shape
    No, D = idx.shape[-2:]
    Bf = int(np.prod(L)) if L else 1
    y = EllShiftRows.apply(xr.reshape(Bf, Nn, E * G),
                           idx.reshape(Bf, No, D),
                           val.reshape(Bf, E, No, D))
    return y.reshape(tuple(L) + (No, E, G))


def ell_shift(x: torch.Tensor, ell: EllGso) -> torch.Tensor:
    """One graph shift y = x·S on the ELL layout.

    x: (*L, E, G, N) -> y: (*L, E, G, No), the semantics of
    ``einsum("...egn,...enm->...egm", x, S_dense)``: output node m
    aggregates its in-neighbors. The node axis moves to the rows and
    :func:`ell_shift_rows` shifts (the JAX package's 'rows' layout).
    """
    y = ell_shift_rows(torch.movedim(x, -1, -3), ell)
    return torch.movedim(y, -3, -1)
