"""Data parallelism over a process group (port of the JAX package's
``parallel/``)."""
from pvn3d_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, gather, local_rows, make_mesh, replicated, shard_batch,
)
from pvn3d_tpu_torch.parallel.multihost import (  # noqa: F401
    initialize_distributed,
)
