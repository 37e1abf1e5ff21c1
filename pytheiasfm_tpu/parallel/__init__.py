"""Multi-device sharding over device meshes."""

from . import sharding  # noqa: F401
from .sharding import make_mesh, pad_to_multiple, replicated, shard_observations  # noqa: F401
