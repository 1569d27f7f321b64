from psnerf_torch.parallel.launch import launch
from psnerf_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_noise,
    shard_stage1_batch,
    shard_stage2_batch,
    shard_stage2_batch_2d,
)
