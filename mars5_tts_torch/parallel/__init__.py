from .mesh import make_mesh, replicated, shard_tree
from .sharding import codeclm_specs, nar_specs

__all__ = ["codeclm_specs", "make_mesh", "nar_specs", "replicated", "shard_tree"]
