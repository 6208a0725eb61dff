"""The device mesh over `torch.distributed` (port of `waveformer_tpu/parallel`).

One process per rank: `mesh.py` (the three axes, `init_distributed`,
batch and depth sharding, broadcast from rank 0), `collectives.py` (the
all-reduce mean, the differentiable all-gather, the eval gather,
`SyncBatchNorm`, the eval case split, a model-parallel line's
`AxisShard`), `spatial.py` (the depth split's halos, gathers and
statistics), `tensor_sharding.py` (the Megatron slices) and
`model_parallel.py` (`shard_model`, which arms a model for both).
"""

from waveformer_tpu_torch.parallel.collectives import (  # noqa: F401
    AxisShard,
    SyncBatchNorm,
    Traffic,
    all_gather_with_grad,
    cross_replica_mean,
    gather_metrics,
    shard_cases_for_eval,
)
from waveformer_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshSpec,
    axis_lines,
    default_mesh_for_batch,
    depth_slab,
    init_distributed,
    make_mesh,
    mesh_coords,
    replicate,
    shard_batch,
)
from waveformer_tpu_torch.parallel.model_parallel import shard_model  # noqa: F401
from waveformer_tpu_torch.parallel.spatial import gather_depth  # noqa: F401
from waveformer_tpu_torch.parallel.tensor_sharding import (  # noqa: F401
    shard_params_tensor,
    tensor_param_specs,
)
