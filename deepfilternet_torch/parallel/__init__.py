from deepfilternet_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_parallel_mesh,
    shard_batch,
    shard_params,
)
