"""Device prefetch (port of ``k8s_tpu/data/prefetch.py``): a background
thread moves host batches to the device ahead of consumption, so the
host-to-device copy of batch n + 1 overlaps step n.

On the card the thread copies each numpy array into page-locked memory
and issues a ``non_blocking`` copy to the device on a side stream, then
records an event. The consumer's stream waits on that event before the
batch is handed over, and each device tensor is marked as used by the
consumer's stream (``record_stream``), so the caching allocator does not
hand its memory to the side stream again before the consumer's work on
it is done. On the CPU (only when the caller asks for it) the batch is
wrapped as tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from k8s_tpu_torch import resolve_device


def prefetch_to_device(
    it: Iterator[Dict[str, np.ndarray]],
    device="cuda",
    buffer_size: int = 2,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a host-batch iterator (dicts of numpy arrays, this rank's
    rows); yields dicts of tensors on ``device``, at most
    ``buffer_size`` of them in flight. An exception of the host iterator
    is raised in the consumer; abandoning the generator stops the thread
    within one timeout tick."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    side = torch.cuda.Stream(device=dev) if on_card else None
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    sentinel = object()

    def put(item) -> bool:
        """Bounded put that a departed consumer cannot wedge: with a plain
        blocking put into a full queue the producer would park forever
        once the consumer walked away (pinning the iterator and every
        device batch in the queue), so it polls ``stop`` between tries."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def to_device(batch):
        if not on_card:
            return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, None
        with torch.cuda.stream(side):
            out = {k: torch.from_numpy(np.asarray(v)).pin_memory().to(
                dev, non_blocking=True) for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def producer():
        try:
            for batch in it:
                if stop.is_set() or not put(to_device(batch)):
                    return
        except Exception as e:  # raised in the consumer
            put(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=producer, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, Exception):
                raise item
            batch, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(ready)
                for v in batch.values():
                    v.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        # free queued device batches promptly instead of at GC
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
