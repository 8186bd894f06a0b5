"""Parallelism helpers of the port (single device for now)."""

from k8s_tpu_torch.parallel.sharding import sharded_embedding_lookup

__all__ = ["sharded_embedding_lookup"]
