"""The node-axis mesh of the scheduling round, on one card.

The JAX package scales one round over a `jax.sharding.Mesh`: the node axis
(and optionally the gang axis) split across chips, GSPMD inserting the
cross-device reductions.  The port runs the same mesh on one H100: kernel
K-K runs the round's placement loop as a thread-block cluster, one CTA a
node shard, their reductions meeting in distributed shared memory
(parallel/mesh.py).  The serving plane (serving.py) and the sharded slab
cache (mesh_slab.py) follow the JAX package's.
"""

from armada_tpu_torch.parallel.mesh import (
    AXIS_JOBS,
    AXIS_NODES,
    make_mesh,
    pad_problem,
    problem_shardings,
    shard_problem,
    sharded_schedule_round,
)
from armada_tpu_torch.parallel.serving import (
    mesh_axis_multiple,
    mesh_serving,
    reset_mesh_serving,
)

__all__ = [
    "AXIS_NODES",
    "AXIS_JOBS",
    "make_mesh",
    "pad_problem",
    "problem_shardings",
    "shard_problem",
    "sharded_schedule_round",
    "mesh_axis_multiple",
    "mesh_serving",
    "reset_mesh_serving",
]
