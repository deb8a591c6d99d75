"""Gradient clipping: ``append_gradient_clip_ops`` (counterpart of
``paddle_tpu/clip.py:112``) for programs that set no clip. The clip
classes (by value, by norm, by global norm) come with a later slice
(ROADMAP.md); a parameter that carries one raises here rather than train
unclipped."""
from __future__ import annotations


def append_gradient_clip_ops(params_grads):
    for p, _g in params_grads:
        if getattr(p, "gradient_clip_attr", None) is not None:
            raise NotImplementedError(
                "gradient clipping (%r on %s) is not yet ported "
                "(ROADMAP.md, queue 1)" % (p.gradient_clip_attr, p.name))
    return list(params_grads)
