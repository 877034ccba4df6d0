"""Data parallelism and the set-axis shard over ``torch.distributed``
(counterpart of ``pcaudio/parallel``): the ``(data, set)`` mesh of ranks,
batch sharding, the set-sharded ST with its explicit collectives, and the
multi-process helpers."""
from pcaudio_torch.parallel.mesh import (
    DATA_AXIS,
    SET_AXIS,
    BatchSharding,
    Mesh,
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from pcaudio_torch.parallel.multihost import (
    global_batch_array,
    global_mesh,
    initialize_distributed,
    local_batch_slice,
)
from pcaudio_torch.parallel.set_sharded import set_sharded_st_forward

__all__ = [
    "DATA_AXIS", "SET_AXIS", "Mesh", "BatchSharding", "make_mesh",
    "batch_sharding", "replicated", "shard_batch", "initialize_distributed",
    "global_mesh", "local_batch_slice", "global_batch_array",
    "set_sharded_st_forward",
]
