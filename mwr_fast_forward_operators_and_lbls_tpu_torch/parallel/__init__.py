"""Device meshes and the sharded entry points; profiling and roofline
accounting of the port's kernels; checkpoints.  `torch.distributed` is
imported only where a process group is used."""

from .mesh import make_mesh, single_device_mesh  # noqa: F401
from .sharding import forward_sharded, shard_profiles  # noqa: F401
from . import checkpoint, profiling  # noqa: F401
