"""Execution over a device mesh.

- ``mesh``        the mesh (an ordered tuple of devices on the row axis)
                  and the row-sharded catalog placement with its validity
                  mask (``shard_table_with_validity``); on a mesh
                  across processes a rank's rows (``place_rank_rows``)
                  and their gather (``gather_rows``)
- ``exchange``    the hash-partition all_to_all exchange and the broadcast
                  (all_gather) join primitives over per-shard lists
- ``partial_agg`` per-shard partial aggregates and their psum / all_gather
                  combines
- ``spmd``        the stage executor: whole query stages over the shards
                  (``try_execute_spmd``)
- ``distributed`` standalone collective functions over a mesh
- ``group``       a mesh across processes (``init_multihost`` with a
                  coordinator): its process group's collectives (NCCL on
                  cards, gloo on the CPU), ordered reductions and the
                  store rendezvous the stage walker agrees through
- ``gather``      the whole tables, gathered and cached, that the
                  single-device tiers read on a mesh across processes
"""
from .mesh import (ROW_AXIS, Mesh, default_mesh, gather_rows,
                   init_multihost, place_rank_rows, shard_table,
                   shard_table_with_validity)
from .spmd import spmd_enabled, try_execute_spmd

__all__ = [
    "ROW_AXIS", "Mesh", "default_mesh", "gather_rows", "init_multihost",
    "place_rank_rows", "shard_table", "shard_table_with_validity",
    "spmd_enabled", "try_execute_spmd",
]
