"""Distribution over a process group (port of ``faspsolver_tpu/parallel``):
row-split operators and vectors as DTensors over a 1-D device mesh,
neighbour halo exchange by P2P, sharded and halo-placed AMG hierarchies,
a record of what a run communicates, and ``dryrun_multichip``.
``teardown`` takes a process group down after releasing the CUDA graphs
that captured its collectives."""
from .dist_dia import dist_dia_operator, shard_hierarchy
from .halo import (CommMap, HaloDiaOperator, assert_neighbor_comm_only,
                   comm_pattern, cycle_comm_pattern, halo_dia_operator,
                   halo_from_bands, halo_shard_hierarchy)
from .pcsr import (dist_operator, make_mesh, release_mesh, replicate,
                   shard_block_rows, shard_rows, shard_vector, teardown)

__all__ = ["CommMap", "HaloDiaOperator", "assert_neighbor_comm_only",
           "comm_pattern", "cycle_comm_pattern",
           "dist_dia_operator", "dist_operator", "halo_dia_operator",
           "halo_from_bands", "halo_shard_hierarchy",
           "make_mesh", "replicate", "shard_block_rows",
           "shard_hierarchy", "shard_rows",
           "shard_vector",
           # the port's own: a multi-rank run's teardown (pcsr.py)
           "teardown"]
