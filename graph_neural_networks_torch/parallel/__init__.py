"""Node-sharded execution over a device mesh (single controller).

The port of the JAX package's ``parallel/`` for the ring path:

  * ``mesh``        -- the ('data', 'graph') mesh of torch devices (a
    device may repeat: several shards on one card) and the halo exchange,
  * ``partition``   -- the host-side node partitioner (contiguous blocks
    after a locality ordering) and its band slabs,
  * ``shift``       -- the ring halo-exchange graph shift,
  * ``attention``   -- the node-sharded band attention (flash kernels
    10-11 forward and 12 backward, or the windowed path),
  * ``sharded_gso`` -- ShardedGso, the GSO the filters and architectures
    take (``arch.shard(mesh, n_parts)``).

Not ported yet (ROADMAP queue 1 item 10): the all-gather and BCSR shifts,
the data-parallel train step, ``db``, ``swarm`` and ``multihost``.
"""

from graph_neural_networks_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh)
from graph_neural_networks_torch.parallel.partition import (  # noqa: F401
    GraphPartition, partition_nodes)
from graph_neural_networks_torch.parallel.shift import (  # noqa: F401
    sharded_gshift_ring)
from graph_neural_networks_torch.parallel.attention import (  # noqa: F401
    ShardedBandAttention, sharded_graph_attention, sharded_gat_lsigf,
    sharded_gat_evgf)
from graph_neural_networks_torch.parallel.sharded_gso import (  # noqa: F401
    ShardedGso)
