"""Multi-process training (counterpart of the JAX package's `parallel/`):
`dist.py` starts the processes and holds every collective, `mesh.py` lays
the ranks on a (data, layer) grid, `data_parallel.py` makes a data rank's
X-step the global batch's, `launch.py` starts ranks from Python and
`dryrun.py` drives the whole multi-rank program at tiny shapes. The
layer-sharded Z/U step is `admm.admm_update(..., mesh=)`."""

from .dist import (init_distributed, is_main_process, partition_shard_paths,
                   shutdown)
from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "init_distributed", "is_main_process", "make_mesh",
           "partition_shard_paths", "shutdown"]
