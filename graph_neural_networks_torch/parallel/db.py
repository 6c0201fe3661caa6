"""Node-sharded time-varying (DB) shifts: the scale-out path of the
decentralized-controller family.

The port of the JAX package's ``parallel/db.py``. Time-varying
communication graphs (flocking) have no static locality, so the
decomposition is:

  * signals x (..., G, N) sharded over the node axis on the mesh's
    'graph' axis,
  * the ELL in-neighbor table (``ops.ell``) row-sharded: shard p owns the
    idx/val rows of its own output nodes (O(N·D / P) a shard, no dense
    N x N anywhere),
  * one all-gather of the O(N) signal a shift, then a shard-local ELL
    gather and contraction of the owned rows (``ell_shift_rows`` on a
    rectangular table: its ids are global).

Single-controller, as the rest of ``parallel``: the tables and the signals
are global tensors on the mesh's home device, shard p reads its rows of
the table, the all-gather is the whole signal on each distinct device of
the mesh (on one card, no copy), and the shards' outputs are
concatenated on the home device. Autograd gives the backward (the
scatter-add of ``EllShiftRows`` into the gathered signal, summed over the
shards), as JAX's autodiff of shard_map does. Pass a ShardedEllGso instead
of a (B,T,E,N,N) stack and the DB architectures run unchanged: every time
step of ``ops.filters.lsigf_db`` (``time_step``) stays sharded.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree

from graph_neural_networks_torch.ops import ell as ell_lib
from graph_neural_networks_torch.parallel.mesh import Mesh

__all__ = ["ShardedEllGso", "shard_ell"]


class ShardedEllGso(ell_lib.EllGso):
    """Row-sharded ELL time-varying GSO on a device mesh.

    idx: (*L, Np·P, D) integer, val: (*L, E, Np·P, D) tensors on the
    mesh's home device, the node axis padded to a multiple of the mesh
    axis size P (:func:`shard_ell`); shard p owns rows p·Np .. (p+1)·Np.
    ``n_orig`` is the true N, so that signals can be padded and unpadded at
    the boundary. A shift all-gathers the signal and contracts each
    shard's rows (module docstring).
    """

    def __init__(self, idx, val, mesh: Mesh, axis: str = "graph",
                 n_orig: int | None = None):
        super().__init__(idx, val)
        parts = mesh.shape[axis]
        if self.n % parts:
            raise ValueError(f"{self.n} nodes do not split into {parts} "
                             "shards; lay the table out with shard_ell")
        self.mesh = mesh
        self.axis = axis
        self.n_orig = self.n if n_orig is None else int(n_orig)

    def _shards(self):
        """(device, EllGso of the shard's rows) for every shard p."""
        devs = self.mesh.grid(self.axis)[0]
        bs = self.n // len(devs)
        return [(dev, ell_lib.EllGso(
            self.idx[..., p * bs:(p + 1) * bs, :].to(dev),
            self.val[..., p * bs:(p + 1) * bs, :].to(dev)))
            for p, dev in enumerate(devs)]

    def _sharded(self, x, shift, node_dim: int):
        gathered = {}                    # the all-gather, once a device
        ys = []
        for dev, blk in self._shards():
            if dev not in gathered:
                gathered[dev] = x.to(dev)
            ys.append(shift(gathered[dev], blk).to(x.device))
        return torch.cat(ys, dim=node_dim)

    def db_shift(self, x: torch.Tensor) -> torch.Tensor:
        """x: (*L, E, G, N_pad) -> same, each shard's output nodes from
        its own rows."""
        return self._sharded(x, ell_lib.ell_shift, -1)

    def db_shift_rows(self, xr: torch.Tensor) -> torch.Tensor:
        """Node-major variant: xr (*L, N_pad, E, G) -> same (the layout the
        DB filters hold their registers in)."""
        return self._sharded(xr, ell_lib.ell_shift_rows, -3)

    def time_step(self, t: int) -> "ShardedEllGso":
        """The (B,)-led graph of step t of a (B, T)-led stack, sharded
        alike (``ops.filters.lsigf_db`` shifts each step by it)."""
        return ShardedEllGso(self.idx[:, t], self.val[:, t], self.mesh,
                             self.axis, self.n_orig)

    # -- signal padding at the user boundary --------------------------------
    def pad_signal(self, x):
        """x (..., n_orig) -> (..., N_pad), zeros in the pad nodes."""
        x = torch.as_tensor(x)
        pad = self.n - self.n_orig
        return torch.nn.functional.pad(x, (0, pad)) if pad else x

    def unpad_signal(self, y):
        return y[..., :self.n_orig]

    def __repr__(self):
        return (f"ShardedEllGso(lead={tuple(self.idx.shape[:-2])}, "
                f"N={self.n_orig}(pad {self.n}), D={self.d}, "
                f"axis={self.axis!r})")


# A pytree node with leaves idx and val and the mesh, axis and n_orig as
# its context (the JAX package registers it so, parallel/db.py): padding a
# request, casting it to bf16 (InferenceEngine, Trainer._mixed) rebuild a
# ShardedEllGso on the same mesh, its idx kept.
_pytree.register_pytree_node(
    ShardedEllGso,
    lambda e: ([e.idx, e.val], (e.mesh, e.axis, e.n_orig)),
    lambda leaves, ctx: ShardedEllGso(*leaves, mesh=ctx[0], axis=ctx[1],
                                      n_orig=ctx[2]),
    serialized_type_name=(
        "graph_neural_networks_torch.parallel.db.ShardedEllGso"),
    flatten_with_keys_fn=lambda e: ([(_pytree.GetAttrKey("idx"), e.idx),
                                     (_pytree.GetAttrKey("val"), e.val)],
                                    (e.mesh, e.axis, e.n_orig)))


def shard_ell(ell: ell_lib.EllGso, mesh: Mesh,
              axis: str = "graph") -> ShardedEllGso:
    """Lay an EllGso (numpy arrays or tensors) out over the mesh: the node
    axis padded to a multiple of the mesh axis size (pad rows gather node 0
    with weight 0), the tables on the mesh's home device."""
    parts = mesh.shape[axis]
    idx = torch.as_tensor(ell.idx, device=mesh.home)
    val = torch.as_tensor(ell.val, device=mesh.home)
    N = idx.shape[-2]
    pad = (-N) % parts
    if pad:
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-2]
                                            + (pad, idx.shape[-1]))], -2)
        val = torch.cat([val, val.new_zeros(val.shape[:-2]
                                            + (pad, val.shape[-1]))], -2)
    return ShardedEllGso(idx, val, mesh, axis, n_orig=N)
