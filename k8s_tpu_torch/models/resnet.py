"""ResNet-v1.5 with synchronized BatchNorm (port of
``k8s_tpu/models/resnet.py``), the north-star workload.

The flax model's numerics, in PyTorch:

- **Layout.** Activations keep torch's NCHW logical shape in
  ``channels_last`` memory (cuDNN's NHWC tensor-core path); weights are
  OIHW f32 masters, also ``channels_last``, cast to ``dtype`` (bf16) for
  every convolution, as flax's ``dtype=bf16`` with f32 ``param_dtype``.
- **SAME padding.** Flax pads as XLA's SAME does: a total of
  ``(out - 1) * stride + k - in`` split low = total // 2, high = the
  rest, which at stride 2 and an even size is (0, 1), not torch's
  symmetric (1, 1). :class:`Conv` and the stem's max pool pad
  explicitly (``F.pad``, -inf for the pool) where the split is
  asymmetric and let the convolution pad where it is not.
- **BatchNorm** (:class:`BatchNorm`): flax's ``momentum=0.9``,
  ``epsilon=1e-5``: statistics reduced in f32 (``E[x^2] - E[x]^2``,
  clipped at 0), ``(x - mean) * rsqrt(var + eps) * scale + bias`` in
  f32 cast to ``norm_dtype`` at the end; running averages
  ``0.9 * ra + 0.1 * batch`` with the BIASED batch variance (torch's
  ``F.batch_norm`` updates the running variance with the unbiased one,
  so it cannot carry flax's state); eval mode (``model.eval()``, flax's
  ``train=False``) normalizes by the running averages.
- **Synchronized statistics.** Under jit with a sharded batch the JAX
  model's BN reductions are global. Here each process holds its rows of
  the batch, so :meth:`ResNet.use_sync_batch_norm` gives every BN a
  process group: the forward all-reduces the per-channel count, sum and
  sum of squares, the backward the two per-channel gradient sums
  (:class:`_SyncBatchNormFn`), and the running averages come out the
  same on every rank. On the card the passes over the activations are
  PyTorch's fused BatchNorm pieces (``batch_norm_stats``,
  ``batch_norm_elemt``, ``batch_norm_backward_reduce`` and
  ``batch_norm_backward_elemt``, SyncBatchNorm's own: one read of the
  bf16 input for the statistics, one for the output, two in the
  backward, f32 inside); the statistics, the running averages and the
  all-reduces around them are this module's, flax's formulas. On the
  CPU, where those pieces do not exist, the same math runs as plain
  f32 tensor ops.
- The global average pool of a bf16 tensor is a bf16 result, which the
  f32 head takes in f32.

The ``space_to_depth`` stem rewrites the 7x7/s2 convolution on 3
channels as a 4x4/s1 one on 12 channels after a 2x2 space-to-depth
rearrangement, with the explicit (2, 1) padding; its ``conv_init``
weight is ``[F, 12, 4, 4]``, so a checkpoint of one stem does not load
into the other.

Parameter names (:func:`~k8s_tpu_torch.models.convert.
resnet_params_from_jax` maps flax's to them): ``conv_init.weight``,
``bn_init.{scale,bias}`` (buffers ``bn_init.{mean,var}``),
``blocks.<i>.{conv_0,conv_1,conv_2,conv_proj}.weight``,
``blocks.<i>.{bn_0,bn_1,bn_2,norm_proj}.*``, ``head.{weight,bias}``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from k8s_tpu_torch import resolve_device

STEMS = ("conv7", "space_to_depth")
BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5
# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled to unit variance by this constant
_TRUNC_STD = 0.87962566103423978


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dimension: ``(low, high)``, the
    total ``(ceil(size / stride) - 1) * stride + k - size`` (at least 0)
    split low = total // 2, high = the rest."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's ``lecun_normal`` init of ``w`` in place (f32 draws)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), (s, s), use_bias=False,
    dtype=dtype)``: SAME padding by default, or explicit ``padding``
    ``((top, bottom), (left, right))``; an OIHW f32 weight, the product
    in ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.k, self.stride, self.padding, self.dtype = k, stride, padding, dtype
        self.weight = nn.Parameter(
            torch.empty(cout, cin, k, k, dtype=torch.float32, device=device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            lecun_normal_(self.weight, self.weight[0].numel(), gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = self.padding or (
            same_pads(x.shape[2], self.k, self.stride),
            same_pads(x.shape[3], self.k, self.stride))
        x = x.to(self.dtype)
        pad = (top, left)
        if top != bottom or left != right:
            x = F.pad(x, (left, right, top, bottom))
            pad = (0, 0)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                        padding=pad)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in place (nothing without a group or
    in a group of one)."""
    if group is not None:
        import torch.distributed as dist

        if dist.get_world_size(group) > 1:
            dist.all_reduce(t, group=group)
    return t


def _fused_bn(x: torch.Tensor) -> bool:
    """Whether ``x``'s BatchNorm runs PyTorch's fused CUDA pieces (on the
    card) rather than the plain f32 tensor ops (on the CPU)."""
    return x.is_cuda


def _same_format(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    fmt = (torch.channels_last if like.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    return t.contiguous(memory_format=fmt)


class _SyncBatchNormFn(torch.autograd.Function):
    """Training-mode BatchNorm over NCHW ``x`` with the statistics of the
    whole data-parallel batch: the forward all-reduces ``[sum, sum of
    squares, count]`` per channel over ``group`` (f32) and updates the
    running averages in place; the backward all-reduces ``[sum dy, sum
    dy * xhat]`` per channel. The gradients of ``scale`` and ``bias`` are
    this rank's sums (the data-parallel gradient sync averages them as
    any parameter's); ``dx`` uses the global sums over the global
    count."""

    @staticmethod
    def forward(ctx, x, scale, bias, ra_mean, ra_var, momentum: float,
                eps: float, out_dtype: torch.dtype, group):
        c = x.shape[1]
        n = torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device)
        fused = _fused_bn(x)
        if fused:
            # this rank's mean and 1/sqrt(biased var + eps), one pass
            x = _same_format(x, x)
            m, invstd = torch.batch_norm_stats(x, eps)
            stats = torch.cat([m * n, (invstd.pow(-2) - eps + m.square()) * n, n])
        else:
            x32 = x.float()
            stats = torch.cat([x32.sum((0, 2, 3)), x32.square().sum((0, 2, 3)), n])
        _all_reduce(stats, group)
        count = stats[2 * c]
        mean = stats[:c] / count
        var = (stats[c:2 * c] / count - mean.square()).clamp_min(0.0)
        with torch.no_grad():
            ra_mean.copy_(momentum * ra_mean + (1 - momentum) * mean)
            ra_var.copy_(momentum * ra_var + (1 - momentum) * var)
        inv = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.count, ctx.group, ctx.fused = count, group, fused
        if fused:
            return torch.batch_norm_elemt(x, scale, bias, mean, inv, eps).to(out_dtype)
        mul = inv * scale
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
        return y.to(out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, inv = ctx.saved_tensors
        c = x.shape[1]
        if ctx.fused:
            dy = _same_format(dy.to(x.dtype), x)
            sum_dy, sum_dy_xmu, dscale, dbias = torch.batch_norm_backward_reduce(
                dy, x, mean, inv, scale, True, True, True)
            sums = _all_reduce(torch.cat([sum_dy, sum_dy_xmu]), ctx.group)
            count = ctx.count.reshape(1).to(torch.int32)
            dx = torch.batch_norm_backward_elemt(
                dy, x, mean, inv, scale, sums[:c].contiguous(),
                sums[c:].contiguous(), count)
            return (dx, dscale, dbias, None, None, None, None, None, None)
        dy32 = dy.float()
        xhat = (x.float() - mean[:, None, None]) * inv[:, None, None]
        sum_dy = dy32.sum((0, 2, 3))
        sum_dy_xhat = (dy32 * xhat).sum((0, 2, 3))
        sums = _all_reduce(torch.cat([sum_dy, sum_dy_xhat]), ctx.group)
        mean_dy = sums[:c] / ctx.count
        mean_dy_xhat = sums[c:] / ctx.count
        dx = ((dy32 - mean_dy[:, None, None] - xhat * mean_dy_xhat[:, None, None])
              * (inv * scale)[:, None, None])
        return (dx.to(x.dtype), sum_dy_xhat, sum_dy, None, None, None, None,
                None, None)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype)`` over
    the channel axis of NCHW input: parameters ``scale`` (ones, or zeros
    with ``zero_scale``) and ``bias`` (zeros), f32 buffers ``mean``
    (zeros) and ``var`` (ones). ``group``: the process group whose
    batch the statistics cover (None: this process's rows only)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False, device=None):
        super().__init__()
        self.dtype, self.zero_scale = dtype, zero_scale
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.empty(features, **f32))
        self.bias = nn.Parameter(torch.empty(features, **f32))
        self.register_buffer("mean", torch.zeros(features, **f32))
        self.register_buffer("var", torch.ones(features, **f32))
        self.group = None
        self.reset_parameters()

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return _SyncBatchNormFn.apply(
                x, self.scale, self.bias, self.mean, self.var, BN_MOMENTUM,
                BN_EPSILON, self.dtype, self.group)
        mul = torch.rsqrt(self.var + BN_EPSILON) * self.scale
        y = ((x.float() - self.mean[:, None, None]) * mul[:, None, None]
             + self.bias[:, None, None])
        return y.to(self.dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (the block's stride) -> 1x1 x4, BN after each, the
    third BN's scale starting at 0; a projection (1x1 at the stride + BN)
    on the residual where its shape changes."""

    def __init__(self, cin: int, filters: int, stride: int,
                 dtype: torch.dtype, norm_dtype: torch.dtype, device=None):
        super().__init__()
        conv = partial(Conv, dtype=dtype, device=device)
        norm = partial(BatchNorm, dtype=norm_dtype, device=device)
        self.conv_0 = conv(cin, filters, 1)
        self.bn_0 = norm(filters)
        self.conv_1 = conv(filters, filters, 3, stride)
        self.bn_1 = norm(filters)
        self.conv_2 = conv(filters, filters * 4, 1)
        self.bn_2 = norm(filters * 4, zero_scale=True)
        self.project = cin != filters * 4 or stride != 1
        if self.project:
            self.conv_proj = conv(cin, filters * 4, 1, stride)
            self.norm_proj = norm(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn_0(self.conv_0(x)))
        y = F.relu(self.bn_1(self.conv_1(y)))
        y = self.bn_2(self.conv_2(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.project else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet-v1.5 over NCHW images (``channels_last`` preferred): the
    stem (``conv7``: 7x7/s2 with (3, 3) padding; ``space_to_depth``:
    2x2 space-to-depth then 4x4/s1 with (2, 1)), BN, ReLU, a 3x3/s2 SAME
    max pool, the bottleneck stages (stride 2 at the first block of every
    stage but the first), the global average pool and the f32 ``head``.
    Returns f32 logits ``[B, num_classes]``. Training mode
    (``model.train()``, the default) normalizes by the batch statistics
    and updates the running averages; ``model.eval()`` uses them.

    Weights are random from ``seed`` (flax's inits: lecun-normal kernels,
    BN scale 1 and bias 0, the third BN of each block scale 0, head bias
    0), drawn on ``device`` in parameter order — not flax's bits; load
    flax's through :func:`~k8s_tpu_torch.models.convert.
    resnet_params_from_jax` and ``load_state_dict``."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 norm_dtype: torch.dtype = torch.bfloat16, stem: str = "conv7",
                 device="cuda", seed: int = 0):
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"unknown stem {stem!r}; "
                             "expected 'conv7' or 'space_to_depth'")
        dev = resolve_device(device)
        self.stem, self.dtype = stem, dtype
        if stem == "space_to_depth":
            # output pixel i sees original rows [2i-4, 2i+3], which
            # contains the 7x7/s2 window [2i-3, 2i+3]
            self.conv_init = Conv(12, num_filters, 4, 1, ((2, 1), (2, 1)),
                                  dtype=dtype, device=dev)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, ((3, 3), (3, 3)),
                                  dtype=dtype, device=dev)
        self.bn_init = BatchNorm(num_filters, dtype=norm_dtype, device=dev)
        blocks = []
        cin = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                blocks.append(BottleneckBlock(
                    cin, filters, 2 if i > 0 and j == 0 else 1, dtype,
                    norm_dtype, device=dev))
                cin = filters * 4
        self.blocks = nn.ModuleList(blocks)
        # no default init: every draw comes from this model's generator
        self.head = nn.utils.skip_init(nn.Linear, cin, num_classes,
                                       dtype=torch.float32, device=dev)
        self.to(memory_format=torch.channels_last)
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int = 0) -> None:
        gen = torch.Generator(device=self.head.weight.device)
        gen.manual_seed(int(seed))
        for m in self.modules():
            if isinstance(m, (Conv, BatchNorm)):
                m.reset_parameters(gen)
        with torch.no_grad():
            lecun_normal_(self.head.weight, self.head.weight.shape[1], gen)
            self.head.bias.zero_()

    def use_sync_batch_norm(self, group) -> None:
        """Every BN's statistics over ``group``'s whole batch (the
        data-parallel group; None: this process's rows only)."""
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stem == "space_to_depth":
            b, c, h, w = x.shape
            if h % 2 or w % 2:
                raise ValueError(
                    f"space_to_depth stem requires even H and W, got {(h, w)}")
            x = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
            x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn_init(self.conv_init(x)))
        top, bottom = same_pads(x.shape[2], 3, 2)
        left, right = same_pads(x.shape[3], 3, 2)
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
        x = F.max_pool2d(x, 3, 2)
        for block in self.blocks:
            x = block(x)
        x = x.mean((2, 3))
        return F.linear(x.float(), self.head.weight, self.head.bias)


ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3))
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3))
ResNet152 = partial(ResNet, stage_sizes=(3, 8, 36, 3))
