"""Models of the port: the Llama decoder, the ResNet and the MNIST CNN."""

from k8s_tpu_torch.models.convert import (
    init_params,
    mnist_params_from_jax,
    params_from_jax,
    resnet_params_from_jax,
)
from k8s_tpu_torch.models.llama import (
    KVCache,
    LlamaConfig,
    LlamaForCausalLM,
    generate,
)
from k8s_tpu_torch.models.mnist import MnistCNN
from k8s_tpu_torch.models.resnet import ResNet, ResNet50, ResNet101, ResNet152

__all__ = ["KVCache", "LlamaConfig", "LlamaForCausalLM", "MnistCNN", "ResNet",
           "ResNet50", "ResNet101", "ResNet152", "generate", "init_params",
           "mnist_params_from_jax", "params_from_jax", "resnet_params_from_jax"]
