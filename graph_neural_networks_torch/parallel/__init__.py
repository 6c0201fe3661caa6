"""Node-sharded execution over a device mesh (single controller).

The port of the JAX package's ``parallel/`` (its single-controller part):

  * ``mesh``        -- the ('data', 'graph') mesh of torch devices (a
    device may repeat: several shards on one card) and the halo exchange,
  * ``partition``   -- the host-side node partitioners: contiguous blocks
    after a locality ordering with band slabs (``partition_nodes``), or
    per-shard BCSR column slices for scattered graphs
    (``partition_nodes_bcsr``),
  * ``shift``       -- the sharded graph shifts: the ring halo exchange,
    the all-gather shift and the BCSR shift,
  * ``attention``   -- the node-sharded band attention (flash kernels
    10-11 forward and 12 backward, or the windowed path),
  * ``sharded_gso`` -- ShardedGso, the GSO the filters and architectures
    take (``arch.shard(mesh, n_parts)``),
  * ``db``          -- ShardedEllGso, the row-sharded time-varying ELL GSO
    of the DB architectures (``shard_ell``),
  * ``swarm``       -- the node-sharded flocking environment and its
    closed-loop rollouts on the grid kernels.

Not ported yet (ROADMAP queue 1 item 10.2b): the multi-process half
(``multihost``, ``make_dp_train_step``).
"""

from graph_neural_networks_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh)
from graph_neural_networks_torch.parallel.partition import (  # noqa: F401
    GraphPartition, partition_nodes, BcsrPartition, partition_nodes_bcsr)
from graph_neural_networks_torch.parallel.shift import (  # noqa: F401
    sharded_gshift_allgather, sharded_gshift_ring, sharded_gshift_bcsr)
from graph_neural_networks_torch.parallel.attention import (  # noqa: F401
    ShardedBandAttention, sharded_graph_attention, sharded_gat_lsigf,
    sharded_gat_evgf)
from graph_neural_networks_torch.parallel.sharded_gso import (  # noqa: F401
    ShardedGso)
from graph_neural_networks_torch.parallel.db import (  # noqa: F401
    ShardedEllGso, shard_ell)
from graph_neural_networks_torch.parallel.swarm import (  # noqa: F401
    sharded_env_step, sharded_swarm_rollout, pad_swarm)
