"""Fused optimizer update over flat buffers: the CUDA kernel and its plain
version.

Counterpart of ``paddle_tpu/ops/pallas/fused_optimizer.py`` (K4,
``_pallas_update``). The kernel is ``paddle_tpu_torch/csrc/fused_optimizer.cu``;
its source says what bounds it on the card and how its design answers that.

``fused_optimizer_update(op_type, attrs, param, grad, lr, state_a, state_b,
beta1_pow, beta2_pow)`` applies one sgd / momentum / adam / adamw step to
flat float32 buffers and returns ``(param_out, state_a_out, state_b_out)``
(None where the optimizer has no such state). ``lr`` and the beta powers
are one-element tensors on the buffers' device.

On a CPU tensor the wrapper runs ``fused_optimizer_update_reference``,
which returns new tensors. On a CUDA tensor it launches the kernel, which
updates ``param`` and the state buffers in place and returns them: the
JAX kernel returns new arrays, the port saves the second copy.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import support

FUSED_OPTIMIZERS = ("sgd", "momentum", "adam", "adamw")
N_STATES = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 2}
_KINDS = {name: i for i, name in enumerate(FUSED_OPTIMIZERS)}

LAUNCHES = support.launch_counter("fused_optimizer_update")
_kernel = None


def fused_optimizer_update_reference(op_type: str, attrs: Dict, p, g, lr,
                                     sa=None, sb=None, b1pow=None,
                                     b2pow=None):
    """``_update_math`` (fused_optimizer.py:47) in torch, term for term:
    the same operations in the same order, each rounded to float32.
    ``lr``, ``b1pow`` and ``b2pow`` are 0-d tensors."""
    if op_type == "sgd":
        return p - lr * g, None, None
    if op_type == "momentum":
        mu = attrs.get("mu", 0.9)
        v = mu * sa + g
        if attrs.get("use_nesterov", False):
            p_out = p - (g + mu * v) * lr
        else:
            p_out = p - lr * v
        return p_out, v, None
    if op_type in ("adam", "adamw"):
        b1 = attrs.get("beta1", 0.9)
        b2 = attrs.get("beta2", 0.999)
        eps = attrs.get("epsilon", 1e-8)
        m1 = b1 * sa + (1 - b1) * g
        m2 = b2 * sb + (1 - b2) * torch.square(g)
        lr_t = lr * torch.sqrt(1 - b2pow) / (1 - b1pow)
        p_out = p - lr_t * m1 / (torch.sqrt(m2) + eps)
        if op_type == "adamw":
            wd = attrs.get("weight_decay", 0.01)
            p_out = p_out - lr * wd * p
        return p_out, m1, m2
    raise ValueError("fused optimizer does not support %r" % op_type)


def _load_kernel():
    global _kernel
    if _kernel is None:
        lib = support.load_library("fused_optimizer")
        fn = lib.paddle_fused_optimizer_update
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int64] + [ctypes.c_float] * 7
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel = (lib, fn)
    return _kernel


def _launch(op_type, attrs, p, g, lr, sa, sb, b1pow, b2pow):
    n_state = N_STATES[op_type]
    flat = [("param", p), ("grad", g)]
    flat += [("state_a", sa)] if n_state >= 1 else []
    flat += [("state_b", sb)] if n_state >= 2 else []
    scalars = [("lr", lr)]
    if n_state == 2:
        if b1pow is None or b2pow is None:
            raise ValueError("%s needs beta pow accumulators" % op_type)
        scalars += [("beta1_pow", b1pow), ("beta2_pow", b2pow)]
    n = p.numel()
    for name, t in flat + scalars:
        if t is None:
            raise ValueError("fused_optimizer_update(%s): %s is missing"
                             % (op_type, name))
        if t.device != p.device:
            raise ValueError("fused_optimizer_update: %s is on %s, param on "
                             "%s" % (name, t.device, p.device))
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused_optimizer_update takes contiguous "
                             "float32 tensors; %s is %s (contiguous=%s)"
                             % (name, t.dtype, t.is_contiguous()))
    for name, t in flat:
        if t.numel() != n:
            raise ValueError("fused_optimizer_update: %s has %d elements, "
                             "param %d" % (name, t.numel(), n))
    for name, t in scalars:
        if t.numel() != 1:
            raise ValueError("fused_optimizer_update: %s must hold one "
                             "value, got %d" % (name, t.numel()))
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    # each constant rounds to float32 once, as the plain version's Python
    # scalars do when they meet a float32 tensor
    consts = (attrs.get("mu", 0.9), b1, 1 - b1, b2, 1 - b2,
              attrs.get("epsilon", 1e-8), attrs.get("weight_decay", 0.01))
    lib, fn = _load_kernel()
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        code = fn(_KINDS[op_type], p.data_ptr(), g.data_ptr(), ptr(sa),
                  ptr(sb), lr.data_ptr(), ptr(b1pow), ptr(b2pow), n,
                  *consts, int(bool(attrs.get("use_nesterov", False))),
                  stream)
    support.check_launch(lib, "paddle_fused_optimizer", code)
    LAUNCHES.inc()
    return p, (sa if n_state >= 1 else None), (sb if n_state >= 2 else None)


def fused_optimizer_update(op_type: str, attrs: Dict, param, grad, lr,
                           state_a: Optional[torch.Tensor] = None,
                           state_b: Optional[torch.Tensor] = None,
                           beta1_pow: Optional[torch.Tensor] = None,
                           beta2_pow: Optional[torch.Tensor] = None):
    """One fused optimizer step over flat buffers: the CUDA kernel (in
    place) for CUDA tensors, the plain version for CPU tensors."""
    if op_type not in FUSED_OPTIMIZERS:
        raise ValueError("fused optimizer does not support %r" % op_type)
    if param.device.type == "cpu":
        return fused_optimizer_update_reference(
            op_type, attrs, param, grad.to(param.dtype), lr.reshape(()),
            state_a, state_b,
            None if beta1_pow is None else beta1_pow.reshape(()),
            None if beta2_pow is None else beta2_pow.reshape(()))
    if param.device.type != "cuda":
        raise ValueError("fused_optimizer_update: tensors on %s"
                         % param.device)
    return _launch(op_type, attrs, param, grad, lr, state_a, state_b,
                   beta1_pow, beta2_pow)
