"""Port of the embedding lookup of ``k8s_tpu/parallel/sharding.py``.

The JAX version gathers a mesh-sharded table at use with explicit
boundary shardings. The port serves on one device, so the lookup is a
plain embedding gather; tensor-parallel serving (and with it a sharded
table) is a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def sharded_embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                             dtype: Optional[torch.dtype] = None
                             ) -> torch.Tensor:
    """[V, E] table, [B, S] ids -> [B, S, E], cast to ``dtype``."""
    x = F.embedding(ids, table)
    return x if dtype is None else x.to(dtype)
