"""ShardedGso: a GSO whose shifts and attention run node-sharded over a
device mesh.

The port of the JAX package's ``parallel/sharded_gso.py``. It wraps a
partition and a mesh and exposes the duck-typed surface that
``ops.gso.gshift`` (a ``shift`` method), ``ops.filters`` (a
``band_attention`` operator) and the layers (``n``) read, so every filter
functional runs sharded.

Usage:
    part = partition_nodes(S, n_graph_shards)
    sgso = ShardedGso(mesh, part)
    y = filters.lsigf(h, sgso, x_padded)   # x padded via part.pad_signal

Routing: a ``BcsrPartition`` (a scattered graph) takes the BCSR shift; a
``GraphPartition`` takes the ring halo exchange when it is a ring and
``prefer_ring`` holds, else the all-gather shift (``uses_ring`` says
which).

``ShardedGso.to(dtype=torch.bfloat16)`` gives its bf16 twin on the same
mesh and partition (what bf16 serving and bf16 training shift with): the
shift's and the attention operator's per-shard float tensors cast once,
their integer tables and the support's entry lists shared. The JAX
``ShardedGso`` is a leafless pytree whose tables stay f32, so its bf16
path multiplies bf16 signals by f32 S; the port's twin keeps S in bf16, as
both packages' unsharded bf16 engines do (ROADMAP queue 3).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from graph_neural_networks_torch.parallel.mesh import Mesh, normalize_device
from graph_neural_networks_torch.parallel.partition import (
    BcsrPartition, GraphPartition)
from graph_neural_networks_torch.parallel.shift import (
    sharded_gshift_allgather, sharded_gshift_bcsr, sharded_gshift_ring)


class ShardedGso:
    """Node-sharded GSO over a ('data', 'graph') mesh.

    The signal convention matches gshift: x (..., E, G, N_padded), node
    axis last, already ordered/padded by ``partition.pad_signal``, on the
    mesh's home device. data_axis: also split the batch over this mesh
    axis where it divides it (hybrid data x graph parallelism).
    """

    def __init__(self, mesh: Mesh, partition, axis: str = "graph",
                 prefer_ring: bool = True, data_axis: str | None = None):
        if isinstance(partition, BcsrPartition):
            # scattered graph: per-shard BCSR column slices (the band slab
            # would degenerate dense at RCM bandwidth ~ N)
            self.uses_ring = False
            build = sharded_gshift_bcsr
        elif isinstance(partition, GraphPartition):
            self.uses_ring = prefer_ring and partition.is_ring
            build = (sharded_gshift_ring if self.uses_ring
                     else sharded_gshift_allgather)
        else:
            raise TypeError(f"a ShardedGso takes a GraphPartition or a "
                            f"BcsrPartition, got {type(partition).__name__}")
        self.mesh = mesh
        self.partition = partition
        self.axis = axis
        self.data_axis = data_axis
        self.dtype = torch.float32
        self._shift = build(mesh, partition, axis, data_axis)
        self._band_attention = None
        self._f32 = None      # a cast twin: the f32 ShardedGso it came from
        self._casts = {}      # dtype -> the twin (on the f32 one)

    # the Gso duck-type surface used by ops.gso.gshift and the layers
    @property
    def n(self) -> int:
        return self.partition.n_padded

    @property
    def n_edge_features(self) -> int:
        return self.partition.n_edge_features

    @property
    def S(self) -> torch.Tensor:
        """Dense (E, Np, Np) reconstruction on the home device: small-graph
        debug only (partition.S_perm refuses above its size guard)."""
        return torch.as_tensor(self.partition.S_perm, dtype=self.dtype,
                               device=self.mesh.home)

    def shift(self, x):
        """One sharded graph shift on (..., E, G, N_padded); any number
        of leading dims."""
        return self._shift(x)

    @property
    def band_attention(self):
        """Lazy sharded band-attention operator for the GAT family
        (parallel.attention.ShardedBandAttention); ops.filters routes
        graph_attention / gat_lsigf / gat_evgf here. Requires a ring
        partition."""
        if self._band_attention is None and self._f32 is not None:
            self._band_attention = self._f32.band_attention.cast(self.dtype)
        if self._band_attention is None:
            if not (isinstance(self.partition, GraphPartition)
                    and self.partition.is_ring):
                raise ValueError(
                    "sharded attention needs a ring GraphPartition (its "
                    "halo exchange); this ShardedGso holds a "
                    f"{type(self.partition).__name__}"
                    + ("" if isinstance(self.partition, BcsrPartition) else
                       f" with w={self.partition.w} > "
                       f"nbl={self.partition.nbl}"))
            from graph_neural_networks_torch.parallel.attention import (
                ShardedBandAttention)
            self._band_attention = ShardedBandAttention(
                self.mesh, self.partition, self.axis,
                data_axis=self.data_axis)
        return self._band_attention

    def to(self, device=None, dtype=None) -> "ShardedGso":
        """The ShardedGso in `dtype` (f32 or bf16) on its mesh: self when
        nothing changes; else its twin on the same mesh and partition, made
        once and memoized on the f32 one (its shift's and attention
        operator's float tables cast, integer tables and entry lists
        shared). A ShardedGso stays on its mesh, whose home device is the
        only `device` it takes."""
        if device is not None and normalize_device(device) != self.mesh.home:
            raise ValueError(f"a ShardedGso lives on its mesh (home "
                             f"{self.mesh.home}); cannot move it to {device}")
        if dtype is None or dtype == self.dtype:
            return self
        base = self._f32 or self
        if dtype == torch.float32:
            return base
        if dtype not in base._casts:
            twin = copy.copy(base)
            twin.dtype = dtype
            twin._shift = base._shift.cast(dtype)
            twin._band_attention = (None if base._band_attention is None
                                    else base._band_attention.cast(dtype))
            twin._f32, twin._casts = base, {}
            base._casts[dtype] = twin
        return base._casts[dtype]

    def pad_signal(self, x: np.ndarray) -> np.ndarray:
        return self.partition.pad_signal(x)

    def unpad_signal(self, x: np.ndarray) -> np.ndarray:
        return self.partition.unpad_signal(x)
