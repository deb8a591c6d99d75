"""Fused implicit-GEMM conv: the CUDA kernel, its plain version and routing.

Counterpart of ``paddle_tpu/ops/pallas/conv.py`` (K5, ``conv2d_bn_act``,
body ``_kernel``). The kernel is ``paddle_tpu_torch/csrc/conv2d_bn_act.cu``;
its source says what bounds it on the card and how its design answers that.

``conv2d_bn_act(x, w, scale, shift, stride=, padding=, relu=, residual=)``
computes ``relu?(conv(x, w) * scale + shift + residual?)`` for NHWC
``x [B, H, W, Cin]`` and HWIO ``w [KH, KW, Cin, Cout]``, accumulated in
float32 and returned in x's type: float32, or bfloat16 on the card. It
takes 1x1 and 3x3 filters, stride 1 or 2, symmetric padding, Cin % 128 ==
0, and any B, H, W and Cout; anything else raises ``ValueError``. On a CPU
tensor it runs ``conv2d_bn_act_reference``, which repeats ``_kernel``'s
arithmetic (a sum of KH * KW float32 matrix products of shifted, strided
slices of the padded input) and never calls ``F.conv2d``; on a CUDA tensor
it launches the kernel or raises.

``pallas_conv(x, w, stride, padding)`` is the differentiable conv, a
``torch.autograd.Function`` in place of the ``jax.custom_vjp`` at
``conv.py:175``: its forward runs ``conv2d_bn_act``, its backward torch's
conv gradients (``convolution_backward``), as the JAX package's backward
runs XLA's conv transposes. The ``conv2d`` op calls ``conv2d_bn_act``
itself, since its grad op (``ops/conv_ops.py`` ``_conv2d_grad``) calls
``conv_backward`` without the forward; ``pallas_conv`` is for a caller
that differentiates K5 with torch's autograd, and the tests hold it to
the ``custom_vjp``.

``route_pallas`` and ``pallas_conv_viable`` are copies of the JAX
package's routing. The conv op routes on ``FLAGS_use_pallas_conv`` and the
shape alone, on any device: on the CPU a routed conv runs the plain
version, so the CPU tests go through the route. The JAX package routes only
when its backend is the TPU (``ops/conv_ops.py:76``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import support

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CIN_ALIGN = 128
LAUNCHES = support.launch_counter("conv2d_bn_act")
# the launches of the bfloat16 form alone (also counted in LAUNCHES)
LAUNCHES_BF16 = support.launch_counter("conv2d_bn_act_bf16")
_kernel = None

# The kernel's tile configurations, ``Tile<0..2>`` in
# csrc/conv2d_bn_act.cu: (BM output pixels, BN output channels).
TILES = ((128, 128), (128, 64), (64, 128))
SMS = 132   # an H100 SXM's streaming multiprocessors


def choose_tile(M: int, N: int, dtype: torch.dtype = torch.float32) -> int:
    """Index into ``TILES`` for a GEMM of M output pixels by N channels in
    ``dtype``, from the kernel's timings at ResNet-50's 19 shapes
    (tools/torch_conv_tiles.py; the source's header note has the reasons):
    128x64 for N <= 64, so that half of each block is not zeros; in
    float32 64x128 when 128x128 blocks would not fill two waves of the
    card (one such block an SM), so that half-size blocks share out the
    last wave; else 128x128."""
    if N <= 64:
        return 1
    if dtype == torch.float32 and -(-M // 128) * -(-N // 128) < 2 * SMS:
        return 2
    return 0


def output_size(n: int, k: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - k) // stride + 1


def check_scope(x_shape: Sequence[int], w_shape: Sequence[int], stride: int,
                padding: int, residual_shape=None) -> tuple:
    """Raise ``ValueError`` unless the kernel takes these shapes; return
    the output shape ``(B, H_out, W_out, Cout)``."""
    if stride not in (1, 2):
        # as the JAX wrapper refuses: its stride-2 decimation is a
        # hard-coded factor-2 reshape
        raise ValueError("conv2d_bn_act supports stride 1 or 2, got %r"
                         % (stride,))
    if len(x_shape) != 4 or len(w_shape) != 4:
        raise ValueError("conv2d_bn_act takes x [B, H, W, Cin] and w "
                         "[KH, KW, Cin, Cout], got %s and %s"
                         % (tuple(x_shape), tuple(w_shape)))
    B, H, W, Cin = x_shape
    KH, KW, wcin, Cout = w_shape
    if KH != KW or KH not in (1, 3):
        raise ValueError("conv2d_bn_act takes 1x1 or 3x3 filters, got %dx%d"
                         % (KH, KW))
    if wcin != Cin or Cin % CIN_ALIGN or Cin == 0:
        raise ValueError("conv2d_bn_act needs Cin %% %d == 0 and the "
                         "filter's Cin equal to x's, got %d and %d"
                         % (CIN_ALIGN, Cin, wcin))
    if not isinstance(padding, int) or padding < 0:
        raise ValueError("conv2d_bn_act takes one symmetric padding >= 0, "
                         "got %r" % (padding,))
    H_out = output_size(H, KH, stride, padding)
    W_out = output_size(W, KW, stride, padding)
    if H_out <= 0 or W_out <= 0 or Cout <= 0:
        raise ValueError("conv2d_bn_act: empty output %dx%dx%d"
                         % (H_out, W_out, Cout))
    out = (B, H_out, W_out, Cout)
    if residual_shape is not None and tuple(residual_shape) != out:
        raise ValueError("conv2d_bn_act: residual %s, output %s"
                         % (tuple(residual_shape), out))
    return out


def _epilogue_params(scale, shift, cout, device):
    scale = (torch.ones(cout, dtype=torch.float32, device=device)
             if scale is None else scale.to(device=device,
                                            dtype=torch.float32))
    shift = (torch.zeros(cout, dtype=torch.float32, device=device)
             if shift is None else shift.to(device=device,
                                            dtype=torch.float32))
    if scale.numel() != cout or shift.numel() != cout:
        raise ValueError("conv2d_bn_act: scale and shift must hold Cout = %d "
                         "values, got %d and %d"
                         % (cout, scale.numel(), shift.numel()))
    return scale.reshape(cout).contiguous(), shift.reshape(cout).contiguous()


def conv2d_bn_act_reference(x: torch.Tensor, w: torch.Tensor,
                            scale: Optional[torch.Tensor] = None,
                            shift: Optional[torch.Tensor] = None, *,
                            stride: int = 1, padding: int = 0,
                            relu: bool = False,
                            residual: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain torch version of ``_kernel``: for each tap (r, c) in order,
    add the float32 product of the strided slice of the padded input it
    sees, ``[B*H_out*W_out, Cin]``, with ``w[r, c]``; then the epilogue."""
    B, H_out, W_out, Cout = check_scope(
        x.shape, w.shape, stride, padding,
        None if residual is None else residual.shape)
    KH, KW, Cin, _ = w.shape
    scale, shift = _epilogue_params(scale, shift, Cout, x.device)
    xf = x.to(torch.float32)
    wf = w.to(torch.float32)
    if padding:
        xf = F.pad(xf, (0, 0, padding, padding, padding, padding))
    acc = torch.zeros((B * H_out * W_out, Cout), dtype=torch.float32,
                      device=x.device)
    for r in range(KH):
        for c in range(KW):
            xs = xf[:, r:r + (H_out - 1) * stride + 1:stride,
                    c:c + (W_out - 1) * stride + 1:stride, :]
            acc = acc + torch.matmul(xs.reshape(-1, Cin), wf[r, c])
    y = acc * scale + shift
    if residual is not None:
        y = y + residual.reshape(-1, Cout).to(torch.float32)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.reshape(B, H_out, W_out, Cout).to(x.dtype)


def _load_kernel():
    global _kernel
    if _kernel is None:
        lib = support.load_library("conv2d_bn_act")
        fn = lib.paddle_conv2d_bn_act
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 13 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel = (lib, fn)
    return _kernel


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, and 16-byte aligned as the kernel's vector loads need (a
    view at an odd offset is copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, w, scale, shift, stride, padding, relu, residual, tile):
    out_shape = check_scope(x.shape, w.shape, stride, padding,
                            None if residual is None else residual.shape)
    B, H_out, W_out, Cout = out_shape
    if tile is None:
        tile = choose_tile(B * H_out * W_out, Cout, x.dtype)
    elif tile not in range(len(TILES)):
        raise ValueError("conv2d_bn_act: tile %r, the kernel has %d"
                         % (tile, len(TILES)))
    if x.dtype not in DTYPES:
        raise ValueError("conv2d_bn_act takes float32 or bfloat16, got %s"
                         % x.dtype)
    for name, t in (("w", w), ("residual", residual)):
        if t is None:
            continue
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError("conv2d_bn_act: %s is %s on %s, x is %s on %s"
                             % (name, t.dtype, t.device, x.dtype, x.device))
    B, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    scale, shift = _epilogue_params(scale, shift, Cout, x.device)
    x, w, scale, shift = (_aligned(t) for t in (x, w, scale, shift))
    if residual is not None:
        residual = _aligned(residual)
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib, fn = _load_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
                  scale.data_ptr(), shift.data_ptr(),
                  None if residual is None else residual.data_ptr(),
                  y.data_ptr(), B, H, W, Cin, KH, KW, Cout, stride, padding,
                  H_out, W_out, int(bool(relu)), tile, stream)
    support.check_launch(lib, "paddle_conv2d_bn_act", code)
    LAUNCHES.inc()
    if x.dtype == torch.bfloat16:
        LAUNCHES_BF16.inc()
    return y


def conv2d_bn_act(x: torch.Tensor, w: torch.Tensor,
                  scale: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None, *, stride: int = 1,
                  padding: int = 0, relu: bool = False,
                  residual: Optional[torch.Tensor] = None,
                  tile: Optional[int] = None) -> torch.Tensor:
    """Fused conv(+scale/shift)(+residual)(+relu), NHWC: the kernel on a
    CUDA tensor, the plain version on a CPU tensor. ``tile`` forces one of
    the kernel's ``TILES`` (None: ``choose_tile``); every one gives the
    same bits, since each output sums its products in the same order."""
    if x.device.type == "cpu":
        return conv2d_bn_act_reference(x, w, scale, shift, stride=stride,
                                       padding=padding, relu=relu,
                                       residual=residual)
    if x.device.type != "cuda":
        raise ValueError("conv2d_bn_act: tensor on %s" % x.device)
    return _launch(x, w, scale, shift, stride, padding, relu, residual,
                   tile)


def conv_backward(grad_out, x, w, stride, padding, dilation=(1, 1),
                  groups=1, need=(True, True)):
    """(dx, dw) of an NCHW conv with an OIHW filter: torch's conv
    gradients, no forward recomputed. ``padding`` is one (ph, pw) pair."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        grad_out.to(x.dtype), x, w, None, list(stride), list(padding),
        list(dilation), False, [0, 0], groups,
        [bool(need[0]), bool(need[1]), False])
    return dx, dw


class PallasConvFunction(torch.autograd.Function):
    """NHWC x, HWIO w: the forward runs ``conv2d_bn_act``, the backward
    ``conv_backward`` on NCHW / OIHW views of the same memory."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding)
        return conv2d_bn_act(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding = ctx.conv
        dx, dw = conv_backward(
            g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
            w.permute(3, 2, 0, 1), (stride, stride), (padding, padding),
            need=ctx.needs_input_grad[:2])
        return (None if dx is None else dx.permute(0, 2, 3, 1),
                None if dw is None else dw.permute(2, 3, 1, 0), None, None)


def pallas_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """Differentiable K5 conv, NHWC x [B, H, W, Cin], HWIO w."""
    return PallasConvFunction.apply(x, w, stride, padding)


def route_pallas(flag_value, x_shape, w_shape, stride, groups, dilations,
                 data_format) -> bool:
    """Routing decision for the conv op, as ``route_pallas`` (conv.py:200):
    'off' never; 'all' any viable shape; 'auto' only stride-1 1x1
    expansion convs (Cout >= 2 * Cin)."""
    if flag_value == "off" or not pallas_conv_viable(
            x_shape, w_shape, stride, groups, dilations, data_format):
        return False
    if flag_value == "all":
        return True
    KH, KW, Cin, Cout = w_shape
    return KH == 1 and stride == 1 and Cout >= 2 * Cin


def pallas_conv_viable(x_shape, w_shape, stride, groups, dilations,
                       data_format) -> bool:
    """True when the kernel covers this conv (NHWC, groups 1, no dilation,
    square 1x1 or 3x3 filter, Cin % 128 == 0, stride 1 or 2), as
    ``pallas_conv_viable`` (conv.py:216)."""
    if data_format != "NHWC" or groups != 1:
        return False
    if any(d != 1 for d in dilations):
        return False
    KH, KW, Cin, _ = w_shape
    if KH != KW or KH not in (1, 3):
        return False
    if Cin % CIN_ALIGN:
        return False          # the 3-channel stem stays on the library
    return stride in (1, 2)
