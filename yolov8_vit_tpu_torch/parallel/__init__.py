"""Process meshes, sharding rules and multi-process initialization
(PyTorch port of the JAX package's `parallel/`)."""
from yolov8_vit_tpu_torch.parallel.mesh import make_mesh, local_mesh, mesh_from_config  # noqa: F401
from yolov8_vit_tpu_torch.parallel.sharding import (  # noqa: F401
    shard_batch, replicate, vit_param_sharding, shard_params,
)
from yolov8_vit_tpu_torch.parallel.distributed import (  # noqa: F401
    init_multihost, global_mesh, is_primary,
)
