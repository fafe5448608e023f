"""Scale-out over ``torch.distributed`` (the counterpart of
``ssd_tpu/parallel``): the mesh and placements here, the step in
``ssd_tpu_torch.train_step``."""

from ssd_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, Mesh, create_mesh, data_index_and_size,
    fsdp_sharded, initialize_distributed, local_rows, model_sharded,
    shard_batch)
