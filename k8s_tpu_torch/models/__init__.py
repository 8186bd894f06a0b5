"""Models of the port: the Llama decoder, the ResNet, the MNIST CNN and
BERT."""

from k8s_tpu_torch.models.bert import BertConfig, BertForPretraining
from k8s_tpu_torch.models.convert import (
    bert_params_from_jax,
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

__all__ = ["BertConfig", "BertForPretraining", "KVCache", "LlamaConfig",
           "LlamaForCausalLM", "MnistCNN", "ResNet", "ResNet50", "ResNet101",
           "ResNet152", "bert_params_from_jax", "generate", "init_params",
           "mnist_params_from_jax", "params_from_jax", "resnet_params_from_jax"]
