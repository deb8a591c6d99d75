"""``flash_attention`` (counterpart of ``paddle_tpu/ops/fused_ops.py:193``):
attention over ``[B, H, S, D]`` through the hand-written CUDA kernels on the
card and their plain versions on the CPU (``ops/cuda/flash_attention.py``).
``Lengths`` ([B] int) is the kernel-side key padding mask.

The op runs ``FlashAttentionFunction``, so its auto-VJP grad op re-runs the
forward kernel (K1) and then the backward kernels (K2 for dQ, K3 for dK
and dV), as JAX's auto-VJP re-runs ``_flash_fwd`` under ``jax.vjp``."""
from __future__ import annotations

import torch

from ..core.registry import In, Out, register_op
from .cuda.flash_attention import FlashAttentionFunction


@register_op(
    "flash_attention",
    inputs=[In("Q"), In("K"), In("V"),
            In("Lengths", dispensable=True, no_grad=True)],
    outputs=[Out("Out")],
    attrs={"causal": False, "scale": 0.0},
)
def _flash_attention(ins, attrs):
    # Q, K, V arrive as views from transpose2; the kernel reads
    # contiguous [B, H, S, D] memory
    q, k, v = (ins[s].contiguous() for s in ("Q", "K", "V"))
    if q.device.type == "meta":  # shape inference
        return {"Out": torch.empty_like(q)}
    scale = attrs.get("scale", 0.0) or float(q.shape[-1]) ** -0.5
    out = FlashAttentionFunction.apply(q, k, v, ins.get("Lengths"),
                                       bool(attrs.get("causal")), scale)
    return {"Out": out}
