"""GPU accelerator topology model (the port's counterpart of
``k8s_tpu/spec/topology.py``, whose ``TpuTopology`` names TPU slices).

A GPU job asks for cards; the node shape decides how they group. An
accelerator name fixes the card model (the node-selector value the
NVIDIA GPU feature discovery labels nodes with), the cards one node
holds, and so the node count for a card count. One pod runs one card
(one process per card, as the port's training programs run), so a
job of ``n`` cards is ``n`` worker pods on ``nodes(n)`` nodes, and the
cards of one node are the NVLink domain the ``fsdp`` axis spans.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class GpuTopology:
    """Shape of one GPU node type.

    ``product``: the ``nvidia.com/gpu.product`` node label value.
    ``cards_per_node``: cards one node holds (8 on an HGX H100 node).
    ``memory_gib``: device memory of one card.
    """

    accelerator: str
    product: str
    cards_per_node: int
    memory_gib: int

    def nodes(self, cards: int) -> int:
        """Nodes a job of ``cards`` cards spans."""
        return max(1, -(-int(cards) // self.cards_per_node))


# accelerator name → node shape. "h100-80gb" is the 8-card HGX H100
# SXM node that clouds rent; "h100-80gb-x1" a node (or VM) with one of
# those cards, such as a single-card development machine.
KNOWN_ACCELERATORS: Dict[str, GpuTopology] = {
    "h100-80gb": GpuTopology("h100-80gb", "NVIDIA-H100-80GB-HBM3", 8, 80),
    "h100-80gb-x1": GpuTopology("h100-80gb-x1", "NVIDIA-H100-80GB-HBM3", 1,
                                80),
}


def lookup(accelerator: str) -> Optional[GpuTopology]:
    return KNOWN_ACCELERATORS.get(accelerator)


def parse(accelerator: str) -> GpuTopology:
    t = lookup(accelerator)
    if t is None:
        raise ValueError(
            f"unknown accelerator type {accelerator!r}; known: "
            f"{sorted(KNOWN_ACCELERATORS)}"
        )
    return t
