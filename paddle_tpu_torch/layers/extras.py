"""``flash_attention`` (counterpart of ``paddle_tpu/layers/extras.py:960``):
fused attention over ``[B, H, S, D]``, the hand-written CUDA kernels on the
card. ``lengths`` ([B] int) masks padded keys inside the kernel."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["flash_attention"]


def flash_attention(q, k, v, causal=False, scale=0.0, lengths=None):
    helper = LayerHelper("flash_attention", input=q)
    out = helper.create_variable_for_type_inference(q.dtype)
    ins = {"Q": [q], "K": [k], "V": [v]}
    if lengths is not None:
        ins["Lengths"] = [lengths]
    helper.append_op("flash_attention", inputs=ins, outputs={"Out": [out]},
                     attrs={"causal": bool(causal), "scale": float(scale)})
    return out
