"""Distributed STKDE strategies and placement machinery on a mesh of shards.

  mesh         ``Mesh`` (named axes of ``torch.device``s), ``make_host_mesh``,
               ``shrink_mesh``
  collectives  ``psum``, ``pmax``, ``ppermute``, ``all_gather`` and
               ``all_to_all`` between shards, in a fixed order
  stkde_dist   the seven strategies, their ``prepare_*`` / ``build_*``, and
               ``execute_chunk`` for the chunked path
  partition    LPT / block placement of tile loads onto devices
  sharding     the language models' placement rules (parameter, batch and
               decode-state specs), ``shard_tree`` / ``gather_tree`` and the
               ``hint_mesh`` context
"""
from . import partition, sharding
from .mesh import Mesh, make_host_mesh, shrink_mesh
from .stkde_dist import (
    stkde_dr,
    stkde_dd,
    stkde_pd,
    stkde_dd_lpt,
    stkde_hybrid,
    STRATEGIES,
)

__all__ = [
    "partition",
    "sharding",
    "Mesh",
    "make_host_mesh",
    "shrink_mesh",
    "stkde_dr",
    "stkde_dd",
    "stkde_pd",
    "stkde_dd_lpt",
    "stkde_hybrid",
    "STRATEGIES",
]
