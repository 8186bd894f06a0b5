"""Continuous-batching serving of the port: the slot-based ragged
engine and its HTTP front-end."""

from k8s_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from k8s_tpu_torch.serving.server import ServingFrontend

__all__ = ["ContinuousBatchingEngine", "Request", "ServingFrontend"]
