"""Models of the port: the Llama decoder's serving path."""

from k8s_tpu_torch.models.convert import init_params, params_from_jax
from k8s_tpu_torch.models.llama import (
    KVCache,
    LlamaConfig,
    LlamaForCausalLM,
    generate,
)

__all__ = ["KVCache", "LlamaConfig", "LlamaForCausalLM", "generate",
           "init_params", "params_from_jax"]
