"""Multi-tier checkpointing of the port (port of ``k8s_tpu/ckpt``,
docs/CHECKPOINT.md).

Local tier (frequent, node-local, two-phase-committed snapshots in the
JAX package's on-disk format) + the persistent tier
(``torch.distributed.checkpoint``) behind one manager, with a restore
planner that picks the newest consistent step and sources a replaced
pod's shards from data-parallel peers before paying a persistent-store
restore.
"""

from k8s_tpu_torch.ckpt.local import (  # noqa: F401
    LocalTier,
    arm_partial_commit,
    compose_shard,
    covering_plan,
    index_key,
    local_shards_of,
    parse_index_key,
    shard_copy_jobs,
    union_covering_plan,
)
from k8s_tpu_torch.ckpt.pipeline import (  # noqa: F401
    InflightGate,
    crc32_array,
    stage_tree,
)
from k8s_tpu_torch.ckpt.peer import (  # noqa: F401
    FilesystemPeerTransport,
    PeerShardServer,
    RestPeerTransport,
)
from k8s_tpu_torch.ckpt.planner import (  # noqa: F401
    SOURCE_LOCAL,
    SOURCE_LOCAL_PEER,
    SOURCE_NONE,
    SOURCE_PERSISTENT,
    RestorePlan,
    RestorePlanner,
)
from k8s_tpu_torch.ckpt.manager import (  # noqa: F401
    CheckpointPolicy,
    GoodputStats,
    MultiTierCheckpointManager,
)
