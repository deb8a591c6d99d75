"""``conv2d``, ``depthwise_conv2d`` and ``pool2d`` (counterparts of
``paddle_tpu/ops/conv_ops.py`` ``:112``, ``:142`` and ``:318``), in NCHW and
NHWC, with the same slots and attrs.

``conv2d`` routes by ``FLAGS_use_pallas_conv`` (``_maybe_pallas_conv``, as
``:61``): a routed conv runs the hand-written implicit-GEMM kernel K5
(``ops/cuda/conv.py``; its plain version on the CPU), any other runs
``torch.nn.functional.conv2d``, as the JAX package runs
``lax.conv_general_dilated``. NHWC convs run on NCHW views of channels-last
memory: no copy, and cuDNN picks its channels-last algorithms. The filter
stays OIHW, the framework's storage layout.

``conv2d_grad`` is hand-written (``_conv2d_grad``): torch's conv gradients
(``convolution_backward``) for Input and Filter, the channel sum of the
output grad for Bias, without re-running the forward. So a routed conv
launches K5 once per step, in its forward. The JAX package's conv grad is
its auto-VJP, whose backward convs are XLA's (``pallas_conv``'s
``custom_vjp`` does the same for routed convs).

``pool2d``: max pooling pads with -inf, average pooling sums a zero-padded
window and divides by the count of real elements (``exclusive``) or by the
window size; ``ceil_mode`` adds extra high padding; ``global_pooling``
reduces every spatial position; ``adaptive`` splits evenly. Its grad is the
auto-VJP.
"""
from __future__ import annotations

import functools
import math
import warnings

import torch
import torch.nn.functional as F

from ..core.flags import flag
from ..core.registry import BOUND_OUTPUTS_ATTR, GRAD_SUFFIX, In, Out, \
    register_op
from .cuda import conv as k5


def _norm_pads(paddings, n=2):
    # [p] -> [(p,p)...]; [ph, pw] -> [(ph,ph),(pw,pw)]; [t,b,l,r] -> pairs
    p = list(paddings)
    if len(p) == n:
        return [(x, x) for x in p]
    if len(p) == 2 * n:
        return [(p[2 * i], p[2 * i + 1]) for i in range(n)]
    if len(p) == 1:
        return [(p[0], p[0])] * n
    raise ValueError("bad paddings %r" % (paddings,))


def _conv_pads(spatial, kernel, strides, paddings, dilations,
               padding_algorithm):
    """Per-dim (lo, hi) pads, with XLA's rule for SAME."""
    if padding_algorithm == "VALID":
        return [(0, 0)] * len(spatial)
    if padding_algorithm != "SAME":
        return _norm_pads(paddings, len(spatial))
    pads = []
    for size, k, s, d in zip(spatial, kernel, strides, dilations):
        total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _nchw(x, nhwc):
    return x.permute(0, 3, 1, 2) if nhwc else x


def _back(x, nhwc):
    return x.permute(0, 2, 3, 1) if nhwc else x


def _conv_nd(x, w, strides, paddings, dilations, groups, data_format="NCHW",
             padding_algorithm="EXPLICIT"):
    """2-D conv of NCHW or NHWC ``x`` with OIHW ``w``; asymmetric pads
    are applied to the input first."""
    nhwc = data_format == "NHWC"
    xc = _nchw(x, nhwc)
    pads = _conv_pads(xc.shape[2:], w.shape[2:], strides, paddings,
                      dilations, padding_algorithm)
    if any(lo != hi for lo, hi in pads):
        xc = F.pad(xc, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        pads = [(0, 0), (0, 0)]
    out = F.conv2d(xc, w, None, tuple(strides),
                   (pads[0][0], pads[1][0]), tuple(dilations), groups)
    return _back(out, nhwc)


def _maybe_pallas_conv(ins, attrs, data_format):
    """FLAGS_use_pallas_conv routing (off/auto/all), as the JAX package's
    ``_maybe_pallas_conv``: the K5 result, or None to take ``_conv_nd``.
    Only NHWC stride-1/2 square 1x1/3x3, groups 1, symmetric padding
    qualify; in 'auto' only the expansion 1x1 class. The device plays no
    part: a CPU tensor runs the kernel's plain version."""
    mode = flag("use_pallas_conv")
    if mode not in ("off", "auto", "all"):
        warnings.warn("FLAGS_use_pallas_conv=%r is not one of off/auto/all; "
                      "treating as 'off'" % (mode,))
        return None
    if mode == "off":
        return None
    x, w = ins["Input"], ins["Filter"]
    strides = attrs.get("strides", [1, 1])
    pads = _norm_pads(attrs.get("paddings", [0, 0]))
    if attrs.get("padding_algorithm", "EXPLICIT") not in ("EXPLICIT",):
        return None
    if strides[0] != strides[1]:
        return None
    if not all(a == b == pads[0][0] for (a, b) in pads):
        return None
    w_hwio_shape = (w.shape[2], w.shape[3], w.shape[1], w.shape[0])
    if not k5.route_pallas(mode, tuple(x.shape), w_hwio_shape, strides[0],
                           attrs.get("groups", 1),
                           attrs.get("dilations", [1, 1]), data_format):
        return None
    if x.device.type == "meta":  # shape inference
        out = k5.check_scope(x.shape, w_hwio_shape, strides[0], pads[0][0])
        return torch.empty(out, dtype=x.dtype, device="meta")
    # filter storage is OIHW; the kernel wants HWIO. The op's grad is
    # ``_conv2d_grad``, so the forward needs no autograd Function.
    return k5.conv2d_bn_act(x, w.permute(2, 3, 1, 0), stride=strides[0],
                            padding=pads[0][0])


_CONV_ATTRS = {
    "strides": [1, 1],
    "paddings": [0, 0],
    "dilations": [1, 1],
    "groups": 1,
    "use_cudnn": True,
    "use_mkldnn": False,
    "data_format": "NCHW",
    "padding_algorithm": "EXPLICIT",
    "exhaustive_search": False,
    "fuse_relu_before_depthwise_conv": False,
    "workspace_size_MB": 512,
}


def _data_format(attrs):
    fmt = attrs.get("data_format", "NCHW")
    return "NCHW" if fmt == "AnyLayout" else fmt


def _conv2d_grad(ins, attrs):
    """Input, Filter and Bias grads of ``conv2d`` from ``Output@GRAD``:
    ``convolution_backward`` on the (padded) NCHW view, the asymmetric
    padding cut back off dInput. ``ResidualData`` is not read by the
    forward, so its grad is zeros, as the auto-VJP gives."""
    bound = set(attrs.get(BOUND_OUTPUTS_ATTR) or ())

    def want(slot):
        return ins.get(slot) is not None and (
            not bound or slot + GRAD_SUFFIX in bound)

    x, w, g = ins["Input"], ins["Filter"], ins.get("Output" + GRAD_SUFFIX)
    out = {}
    if want("ResidualData"):
        out["ResidualData" + GRAD_SUFFIX] = torch.zeros_like(
            ins["ResidualData"])
    if g is None:  # no grad flows in: every input's grad is zero
        for slot in ("Input", "Filter", "Bias"):
            if want(slot):
                out[slot + GRAD_SUFFIX] = torch.zeros_like(ins[slot])
        return out
    nhwc = _data_format(attrs) == "NHWC"
    strides = attrs.get("strides", [1, 1])
    dilations = attrs.get("dilations", [1, 1])
    xc, gc = _nchw(x, nhwc), _nchw(g, nhwc)
    pads = _conv_pads(xc.shape[2:], w.shape[2:], strides,
                      attrs.get("paddings", [0, 0]), dilations,
                      attrs.get("padding_algorithm", "EXPLICIT"))
    asym = any(lo != hi for lo, hi in pads)
    H, W = xc.shape[2:]
    if asym:
        xc = F.pad(xc, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    dx, dw = k5.conv_backward(
        gc, xc, w, strides, (0, 0) if asym else (pads[0][0], pads[1][0]),
        dilations, attrs.get("groups", 1),
        need=(want("Input"), want("Filter")))
    if dx is not None:
        if asym:
            dx = dx[:, :, pads[0][0]:pads[0][0] + H,
                    pads[1][0]:pads[1][0] + W]
        out["Input" + GRAD_SUFFIX] = _back(dx, nhwc)
    if dw is not None:
        out["Filter" + GRAD_SUFFIX] = dw
    if want("Bias"):
        b = ins["Bias"]
        out["Bias" + GRAD_SUFFIX] = g.sum(
            dim=(0, 1, 2) if nhwc else (0, 2, 3)).reshape(b.shape).to(b.dtype)
    return out


@register_op(
    "conv2d",
    inputs=[In("Input"), In("Filter"), In("Bias", dispensable=True),
            In("ResidualData", dispensable=True)],
    outputs=[Out("Output")],
    attrs=dict(_CONV_ATTRS),
    grad_fn=_conv2d_grad,
)
def _conv2d(ins, attrs):
    data_format = _data_format(attrs)
    out = _maybe_pallas_conv(ins, attrs, data_format)
    if out is None:
        out = _conv_nd(
            ins["Input"],
            ins["Filter"],
            attrs.get("strides", [1, 1]),
            attrs.get("paddings", [0, 0]),
            attrs.get("dilations", [1, 1]),
            attrs.get("groups", 1),
            data_format,
            attrs.get("padding_algorithm", "EXPLICIT"),
        )
    if ins.get("Bias") is not None:
        bshape = ((1, -1, 1, 1) if data_format != "NHWC"
                  else (1, 1, 1, -1))
        out = out + ins["Bias"].reshape(bshape)
    return {"Output": out}


@register_op(
    "depthwise_conv2d",
    inputs=[In("Input"), In("Filter")],
    outputs=[Out("Output")],
    attrs=dict(_CONV_ATTRS),
)
def _depthwise_conv2d(ins, attrs):
    """One group an input channel, the channel axis read from the layout
    (``paddle_tpu/ops/conv_ops.py:142``, which runs ``lax`` outside any
    Pallas kernel); the ``groups`` attr is not read. Its grad is the
    auto-VJP."""
    x = ins["Input"]
    data_format = _data_format(attrs)
    return {"Output": _conv_nd(
        x, ins["Filter"],
        attrs.get("strides", [1, 1]),
        attrs.get("paddings", [0, 0]),
        attrs.get("dilations", [1, 1]),
        x.shape[-1] if data_format == "NHWC" else x.shape[1],
        data_format,
        attrs.get("padding_algorithm", "EXPLICIT"))}


_POOL_ATTRS = {
    "pooling_type": "max",
    "ksize": [1, 1],
    "strides": [1, 1],
    "paddings": [0, 0],
    "global_pooling": False,
    "exclusive": True,
    "adaptive": False,
    "ceil_mode": False,
    "use_cudnn": True,
    "use_mkldnn": False,
    "data_format": "NCHW",
    "padding_algorithm": "EXPLICIT",
}


def _ceil_extra_pads(spatial, ksize, strides, pads, ceil_mode):
    """Per-dim (lo, hi) pads; ceil_mode adds extra hi pad so the output
    size follows ceil((H + pl + ph - k)/s) + 1 (reference pooling.cc)."""
    out = []
    for size, k, s, (lo, hi) in zip(spatial, ksize, strides, pads):
        if ceil_mode:
            n_out = -(-(size + lo + hi - k) // s) + 1  # ceil div
            extra = (n_out - 1) * s + k - (size + lo + hi)
            hi += max(0, extra)
        out.append((lo, hi))
    return out


@functools.lru_cache(maxsize=64)
def _window_counts(spatial, ksize, strides, flat_pad, dtype, device):
    """Real (unpadded) elements under each pooling window."""
    ones = torch.ones((1, 1) + spatial, dtype=dtype, device=device)
    return F.avg_pool2d(F.pad(ones, flat_pad), ksize, strides,
                        divisor_override=1)


def _pool_impl(x, attrs):
    """Max/avg pooling over the two spatial dims of an NCHW (or, with
    data_format=NHWC, NHWC) tensor."""
    ptype = attrs.get("pooling_type", "max")
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    sp = (1, 2) if nhwc else (2, 3)
    ksize = list(attrs.get("ksize", [1, 1]))
    if attrs.get("global_pooling", False) or (
            attrs.get("adaptive", False) and ksize == [1, 1]):
        if ptype == "max":
            return x.amax(dim=sp, keepdim=True)
        return x.mean(dim=sp, keepdim=True)
    if attrs.get("adaptive", False):
        # adaptive pooling via even split (requires divisibility, the
        # common CNN case)
        new_shape = list(x.shape[:sp[0]])
        red = []
        for i, o in enumerate(ksize):
            new_shape += [o, x.shape[sp[0] + i] // o]
            red.append(sp[0] + 2 * i + 1)
        new_shape += list(x.shape[sp[0] + 2:])
        xs = x.reshape(new_shape)
        return (xs.amax(dim=tuple(red)) if ptype == "max"
                else xs.mean(dim=tuple(red)))
    strides = tuple(attrs.get("strides", [1, 1]))
    ksize = tuple(ksize)
    pads = _norm_pads(attrs.get("paddings", [0, 0]), 2)
    pads = _ceil_extra_pads(x.shape[sp[0]:sp[0] + 2], ksize, strides, pads,
                            attrs.get("ceil_mode", False))
    flat_pad = (pads[1][0], pads[1][1], pads[0][0], pads[0][1])
    xc = _nchw(x, nhwc)
    if ptype == "max":
        fill = (-math.inf if x.is_floating_point()
                else torch.iinfo(x.dtype).min)
        out = F.max_pool2d(F.pad(xc, flat_pad, value=fill), ksize, strides)
        return _back(out, nhwc)
    s = F.avg_pool2d(F.pad(xc, flat_pad), ksize, strides, divisor_override=1)
    if attrs.get("exclusive", True):
        if x.device.type == "meta":
            return _back(s, nhwc)
        s = s / _window_counts(tuple(xc.shape[2:]), ksize, strides,
                               flat_pad, x.dtype, x.device)
    else:
        s = s / float(math.prod(ksize))
    return _back(s, nhwc)


@register_op(
    "pool2d",
    inputs=[In("X")],
    outputs=[Out("Out")],
    attrs=dict(_POOL_ATTRS),
)
def _pool2d(ins, attrs):
    return {"Out": _pool_impl(ins["X"], attrs)}
