"""Data, tensor and sequence parallelism: one process per card for
training on an (n, m) mesh (n data indices, a model axis of m), one
process over a list of devices for serving.  A step on a global batch
computes what one process computes on that whole batch; pad rows count
in neither the losses nor the BatchNorm statistics."""

from music_style_transfer_ldm_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize, process_info, shutdown,
)
from music_style_transfer_ldm_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, batch_sharding, make_mesh, replicated_sharding, sequence_sharding,
)
from music_style_transfer_ldm_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_validity_weights, gather_params, global_batch_from_local,
    pad_batch_to_multiple, param_partition_spec, shard_batch, shard_params,
)
