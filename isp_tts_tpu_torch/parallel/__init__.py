"""Multi-card layer of the port: the rank mesh, its process groups, batch
and tensor-parallel sharding (counterpart of ``isp_tts_tpu/parallel``)."""

from .mesh import (
    batch_sharding,
    make_mesh,
    process_local_mesh_info,
    replicate,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "batch_sharding",
    "process_local_mesh_info",
]
