"""ShardedGso: a GSO whose shifts and attention run node-sharded over a
device mesh.

The port of the JAX package's ``parallel/sharded_gso.py``. It wraps a
GraphPartition and a mesh and exposes the duck-typed surface that
``ops.gso.gshift`` (a ``shift`` method), ``ops.filters`` (a
``band_attention`` operator) and the layers (``n``) read, so every filter
functional runs sharded with a halo exchange.

Usage:
    part = partition_nodes(S, n_graph_shards)
    sgso = ShardedGso(mesh, part)
    y = filters.lsigf(h, sgso, x_padded)   # x padded via part.pad_signal

Only the ring path is ported: a partition that is not a ring (the
all-gather shift) or a BCSR partition raises NotImplementedError (ROADMAP
queue 1 item 10.2).
"""

from __future__ import annotations

import numpy as np

from graph_neural_networks_torch.parallel.mesh import Mesh, normalize_device
from graph_neural_networks_torch.parallel.partition import GraphPartition
from graph_neural_networks_torch.parallel.shift import sharded_gshift_ring


class ShardedGso:
    """Node-sharded GSO over a ('data', 'graph') mesh.

    The signal convention matches gshift: x (..., E, G, N_padded), node
    axis last, already ordered/padded by ``partition.pad_signal``, on the
    mesh's home device. data_axis: also split the batch over this mesh
    axis where it divides it (hybrid data x graph parallelism).
    """

    def __init__(self, mesh: Mesh, partition, axis: str = "graph",
                 data_axis: str | None = None):
        if not isinstance(partition, GraphPartition):
            raise NotImplementedError(
                f"a ShardedGso over a {type(partition).__name__} (the BCSR "
                "partition) is not ported yet (ROADMAP queue 1 item 10.2)")
        if not partition.is_ring:
            raise NotImplementedError(
                f"the partition is not a ring (w={partition.w} > "
                f"nbl={partition.nbl}); the all-gather shift is not ported "
                "yet (ROADMAP queue 1 item 10.2)")
        self.mesh = mesh
        self.partition = partition
        self.axis = axis
        self.data_axis = data_axis
        self._shift = sharded_gshift_ring(mesh, partition, axis, data_axis)
        self._band_attention = None

    # the Gso duck-type surface used by ops.gso.gshift and the layers
    @property
    def n(self) -> int:
        return self.partition.n_padded

    @property
    def n_edge_features(self) -> int:
        return self.partition.n_edge_features

    def shift(self, x):
        """One sharded graph shift on (..., E, G, N_padded); any number
        of leading dims."""
        return self._shift(x)

    @property
    def band_attention(self):
        """Lazy sharded band-attention operator for the GAT family
        (parallel.attention.ShardedBandAttention); ops.filters routes
        graph_attention / gat_lsigf / gat_evgf here."""
        if self._band_attention is None:
            from graph_neural_networks_torch.parallel.attention import (
                ShardedBandAttention)
            self._band_attention = ShardedBandAttention(
                self.mesh, self.partition, self.axis,
                data_axis=self.data_axis)
        return self._band_attention

    def to(self, device) -> "ShardedGso":
        """self: a ShardedGso stays on its mesh, whose home device is the
        only one its global inputs and outputs may live on."""
        if normalize_device(device) != self.mesh.home:
            raise ValueError(f"a ShardedGso lives on its mesh (home "
                             f"{self.mesh.home}); cannot move it to {device}")
        return self

    def pad_signal(self, x: np.ndarray) -> np.ndarray:
        return self.partition.pad_signal(x)

    def unpad_signal(self, x: np.ndarray) -> np.ndarray:
        return self.partition.unpad_signal(x)
