"""The MNIST CNN (port of ``k8s_tpu/models/mnist.py``): two 3x3
convolutions with bias (SAME at stride 1, i.e. padding 1), each followed
by ReLU and a 2x2 VALID average pool, then Dense 256 with ReLU and Dense
``num_classes``, computed in ``dtype`` (bf16) from f32 parameters, the
logits returned in f32.

Input is NCHW ``[B, 1, 28, 28]``. The flatten before ``dense_0`` is in
flax's (h, w, c) order (the NHWC reshape of the JAX model), so its 3136
input rows line up with flax's ``Dense_0`` kernel rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from k8s_tpu_torch import resolve_device
from k8s_tpu_torch.models.resnet import lecun_normal_


class MnistCNN(nn.Module):
    """Parameters ``conv_0``/``conv_1`` (OIHW weight, bias) and
    ``dense_0``/``dense_1`` (``[out, in]`` weight, bias), random from
    ``seed`` with flax's inits (lecun-normal kernels, zero biases) — not
    flax's bits."""

    def __init__(self, num_classes: int = 10, dtype: torch.dtype = torch.bfloat16,
                 device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        # no default init: every draw comes from this model's generator
        f32 = dict(dtype=torch.float32, device=dev)
        self.conv_0 = nn.utils.skip_init(nn.Conv2d, 1, 32, 3, padding=1, **f32)
        self.conv_1 = nn.utils.skip_init(nn.Conv2d, 32, 64, 3, padding=1, **f32)
        self.dense_0 = nn.utils.skip_init(nn.Linear, 7 * 7 * 64, 256, **f32)
        self.dense_1 = nn.utils.skip_init(nn.Linear, 256, num_classes, **f32)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            for layer in (self.conv_0, self.conv_1, self.dense_0, self.dense_1):
                lecun_normal_(layer.weight, layer.weight[0].numel(), gen)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        for conv in (self.conv_0, self.conv_1):
            x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)
            x = F.avg_pool2d(F.relu(x), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c)
        x = F.relu(F.linear(x, self.dense_0.weight.to(dt), self.dense_0.bias.to(dt)))
        x = F.linear(x, self.dense_1.weight.to(dt), self.dense_1.bias.to(dt))
        return x.float()
