"""Parallelism of the port: the device mesh, the logical-axis rules, the
ZeRO layouts and tensor parallelism's collectives (port of
``k8s_tpu/parallel``)."""

from k8s_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES,
    MeshConfig,
    best_pow2_split,
    build_mesh,
    data_parallel_degree,
    mesh_shape,
)
from k8s_tpu_torch.parallel.sharding import (  # noqa: F401
    LogicalRules,
    sharded_embedding_lookup,
    zero1_partition_spec,
    zero3_selected,
)
