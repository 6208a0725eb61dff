"""Data parallelism over `torch.distributed` (port of `waveformer_tpu/parallel`).

One process per card: `mesh.py` (the `data` axis, `init_distributed`,
batch sharding, broadcast from rank 0) and `collectives.py` (the all-reduce
mean, the differentiable all-gather, the eval gather, `SyncBatchNorm`, the
eval case split).
"""

from waveformer_tpu_torch.parallel.collectives import (  # noqa: F401
    SyncBatchNorm,
    all_gather_with_grad,
    cross_replica_mean,
    gather_metrics,
    shard_cases_for_eval,
)
from waveformer_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshSpec,
    default_mesh_for_batch,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
