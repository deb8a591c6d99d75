"""``cos_sim`` (counterpart of ``paddle_tpu/ops/misc_ops.py:227``), with
the same slots: the cosine of each row pair over the last axis, the
product of the norms floored at 1e-12 (a zero row gives 0, not NaN), and
the two norms as ``XNorm`` / ``YNorm``. Its grad is the auto-VJP."""
from __future__ import annotations

import torch

from ..core.registry import In, Out, register_op


@register_op("cos_sim", inputs=[In("X"), In("Y")],
             outputs=[Out("Out"), Out("XNorm", no_grad=True),
                      Out("YNorm", no_grad=True)])
def _cos_sim(ins, attrs):
    x, y = ins["X"], ins["Y"]
    xn = torch.sqrt(torch.square(x).sum(dim=-1, keepdim=True))
    yn = torch.sqrt(torch.square(y).sum(dim=-1, keepdim=True))
    floor = torch.full((), 1e-12, dtype=x.dtype, device=x.device)
    sim = (x * y).sum(dim=-1, keepdim=True) / torch.maximum(xn * yn, floor)
    return {"Out": sim, "XNorm": xn, "YNorm": yn}
