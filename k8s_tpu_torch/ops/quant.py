"""Weight-only int8 for serving (port of the serving half of
``k8s_tpu/ops/quant.py``).

Projection weights are STORED int8 with one f32 scale per output column
(symmetric, ``amax / 127``); activations are quantized per row at each
call (over the contracted axis, ``amax`` clamped at 1e-8), the product
is int8 x int8 -> int32 and is dequantized by the outer product of the
two scale vectors. Decode reads every weight each step, so 1-byte
weights halve its dominant bandwidth term. The JAX package leaves the
product to XLA, so it is a library call here (``torch._int_mm``, on the
card cuBLASLt's int8 GEMM): no Pallas kernel stands behind it. All
rounding is half to even. The weights are quantized offline, where the
JAX package runs eagerly: ``amax / 127`` is an IEEE divide there. The
activations are quantized inside the served step, which the JAX package
runs under jit: XLA compiles ``amax / 127`` as a multiply by the f32
reciprocal (see ``ops/attention.py``), and so does the port. So the
int8 weights, activations and scales are bit-identical to the JAX
package's as it serves.

Weights keep the port's flattened ``[in, out]`` layout
(:mod:`k8s_tpu_torch.models.convert`): q/k/v ``[E, H*D]``, o_proj
``[H*D, E]``, the MLP and the lm_head as they are.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from k8s_tpu_torch.ops.attention import INV_127

_EPS = 1e-8
# torch._int_mm on the card takes more than 16 rows: smaller batches
# (decode at <= 16 slots) are padded with zero rows up to this
_INT_MM_MIN_ROWS = 32
# the weights quantize_params_for_serving rewrites, by the last part of
# their name (the JAX package's out_axes table, flattened)
_QUANTIZED_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                       "up_proj", "down_proj", "lm_head")


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 of a [..., K] activation over its last
    axis: ``(int8 [M, K], f32 scales [M, 1])`` with M the product of the
    leading axes."""
    xf = x.reshape(-1, x.shape[-1]).float()
    sx = xf.abs().amax(dim=1, keepdim=True).clamp_min(_EPS) * INV_127
    return torch.round(xf / sx).to(torch.int8), sx


def int8_serving_matmul(x: torch.Tensor, kernel_q: torch.Tensor,
                        scale: torch.Tensor, xq=None) -> torch.Tensor:
    """``x [..., K] @ kernel_q [K, N]`` against an int8-stored kernel with
    per-column ``scale [N]``: f32 ``[..., N]``. ``xq`` is
    :func:`quantize_rows` of ``x`` when the caller already has it (q, k
    and v, and gate and up, share their input: the per-row quantization
    is the same, so it runs once)."""
    qx, sx = quantize_rows(x) if xq is None else xq
    m = qx.shape[0]
    if m < _INT_MM_MIN_ROWS:
        qx = torch.cat([qx, qx.new_zeros(_INT_MM_MIN_ROWS - m, qx.shape[1])])
    acc = torch._int_mm(qx, kernel_q)[:m]
    out = acc.float() * sx * scale
    return out.reshape(*x.shape[:-1], kernel_q.shape[1])


class Int8ServingDense(nn.Module):
    """A projection with an int8-STORED kernel ``[n_in, n_out]`` and a
    per-column f32 ``scale`` (parameters ``kernel_q``/``scale``, the JAX
    module's names), producing ``out_dtype`` (the input's dtype when
    None). Weights come from :func:`quantize_params_for_serving`.

    ``kernel_q`` is held column-major (the transpose of a contiguous
    ``[n_out, n_in]``; ``LlamaForCausalLM.load_params`` keeps a
    parameter's layout): cuBLASLt's int8 GEMM behind ``torch._int_mm``
    took 0.127 ms for a row-major 4096 x 14336 operand at 32 rows and
    0.027 ms for a column-major one (H100 80GB HBM3, 700 W; a bf16 GEMM
    of that shape at 16 rows took 0.048 ms)."""

    def __init__(self, n_in: int, n_out: int, device,
                 out_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel_q = nn.Parameter(
            torch.zeros((n_out, n_in), dtype=torch.int8, device=device).t(),
            requires_grad=False)
        self.scale = nn.Parameter(
            torch.ones(n_out, dtype=torch.float32, device=device),
            requires_grad=False)
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor, xq=None) -> torch.Tensor:
        out = int8_serving_matmul(x, self.kernel_q, self.scale, xq)
        return out.to(self.out_dtype or x.dtype)


def quantize_kernel(w: torch.Tensor):
    """Symmetric per-output-column int8 of an ``[in, out]`` kernel:
    ``(int8 [in, out], f32 scale [out])``, computed in f32."""
    wf = w.float()
    scale = wf.abs().amax(dim=0).clamp_min(_EPS) / 127.0
    return torch.round(wf / scale).to(torch.int8), scale


def quantize_params_for_serving(
        params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Offline weight-only quantization of a port weight dict: every
    projection, MLP kernel and the lm_head (``_QUANTIZED_NAMES``)
    becomes ``<name>.kernel_q`` (int8) and ``<name>.scale`` (f32); the
    embedding and the norms pass through. Returns a NEW dict, the layout
    of ``LlamaConfig(quant="int8_serving")``."""
    out = {}
    for name, w in params.items():
        if name.rsplit(".", 1)[-1] in _QUANTIZED_NAMES:
            out[name + ".kernel_q"], out[name + ".scale"] = quantize_kernel(w)
        else:
            out[name] = w
    return out
