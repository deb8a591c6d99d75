"""The loss-scaling ops of mixed-precision training (counterparts of
``paddle_tpu/ops/amp_ops.py``), with the same slots, attrs and arithmetic.

``check_finite_and_unscale`` (:24) multiplies every grad by ``1 / Scale``
(in float32, back in the grad's type) and, when any grad holds an inf or
a nan, zeroes them all, so the optimizer's update is a no-op: a
``torch.where``, never a host branch, so the op runs inside a captured
CUDA graph. ``update_loss_scaling`` (:55) counts clean and overflowing
steps and grows the scale after ``incr_every_n_steps`` clean ones (unless
it would overflow float32) or shrinks it, never below 1, after
``decr_every_n_nan_or_inf`` overflowing ones; it reads and writes one
persistable scale and two int32 counters.
"""
from __future__ import annotations

import torch

from ..core.registry import In, Out, register_op


@register_op(
    "check_finite_and_unscale",
    inputs=[In("X", duplicable=True, no_grad=True),
            In("Scale", no_grad=True)],
    outputs=[Out("Out", duplicable=True), Out("FoundInfinite")],
    attrs={},
)
def _check_finite_and_unscale(ins, attrs):
    xs = ins["X"] or []
    scale = ins["Scale"]
    inv = (1.0 / scale).to(torch.float32)
    found = torch.zeros((), dtype=torch.bool, device=scale.device)
    for x in xs:
        found = found | ~torch.isfinite(x).all()
    # where(), not a multiply by a 0/1 mask: inf * 0 is nan
    outs = []
    for x in xs:
        ux = (x.to(torch.float32) * inv).to(x.dtype)
        outs.append(torch.where(found, torch.zeros_like(ux), ux))
    return {"Out": outs, "FoundInfinite": found.reshape(1)}


@register_op(
    "update_loss_scaling",
    inputs=[In("FoundInfinite", no_grad=True),
            In("PrevLossScaling", no_grad=True),
            In("InGoodSteps", no_grad=True),
            In("InBadSteps", no_grad=True)],
    outputs=[Out("LossScaling"), Out("OutGoodSteps"), Out("OutBadSteps")],
    attrs={
        "incr_every_n_steps": 1000,
        "decr_every_n_nan_or_inf": 2,
        "incr_ratio": 2.0,
        "decr_ratio": 0.8,
    },
)
def _update_loss_scaling(ins, attrs):
    found = ins["FoundInfinite"].reshape(()).to(torch.bool)
    scale = ins["PrevLossScaling"]
    good = ins["InGoodSteps"]
    bad = ins["InBadSteps"]
    incr_n = attrs["incr_every_n_steps"]
    decr_n = attrs["decr_every_n_nan_or_inf"]
    # Python numbers: a float32 tensor times one rounds it to float32, as
    # jnp.float32(ratio) does, and no scalar is copied to the card
    incr_ratio = float(attrs["incr_ratio"])
    decr_ratio = float(attrs["decr_ratio"])

    bad_new = torch.where(found, bad + 1, torch.zeros_like(bad))
    good_new = torch.where(found, torch.zeros_like(good), good + 1)
    # shrink after decr_n consecutive overflowing steps, not below 1
    do_decr = bad_new >= decr_n
    scale_decr = torch.clamp_min(scale * decr_ratio, 1.0)
    # grow after incr_n consecutive clean steps, unless the grown scale
    # would leave float32's range (an inf scale zeroes every later grad)
    do_incr = good_new >= incr_n
    grown = scale * incr_ratio
    scale_incr = torch.where(torch.isfinite(grown), grown, scale)
    new_scale = torch.where(do_decr, scale_decr,
                            torch.where(do_incr, scale_incr, scale))
    good_out = torch.where(do_incr | do_decr, torch.zeros_like(good),
                           good_new)
    bad_out = torch.where(do_decr, torch.zeros_like(bad), bad_new)
    return {"LossScaling": new_scale, "OutGoodSteps": good_out,
            "OutBadSteps": bad_out}
