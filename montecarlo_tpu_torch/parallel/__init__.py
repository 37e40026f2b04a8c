"""Chain parallelism: a session's chains sharded over the ranks of a
torch.distributed process group (``mesh``), and worlds of ranks started
from one process (``launch``)."""

from .mesh import (
    CHAIN_AXIS, chain_mesh, chain_sharding, shard_chain_state,
    shard_simulation, cross_chain_mean, pmean_tree,
)

__all__ = ["CHAIN_AXIS", "chain_mesh", "chain_sharding", "shard_chain_state",
           "shard_simulation", "cross_chain_mean", "pmean_tree"]
