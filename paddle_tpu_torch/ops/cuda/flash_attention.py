"""Flash attention: the CUDA kernels and their plain versions.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``: the forward
(``_flash_forward``, body ``_flash_kernel``; K1) is
``paddle_tpu_torch/csrc/flash_attention.cu``, the backward
(``_flash_backward``: ``_flash_bwd_dq_kernel``, K2, and
``_flash_bwd_dkv_kernel``, K3) is ``paddle_tpu_torch/csrc/flash_attention_bwd.cu``.
Each source says what bounds it on the card and how its design answers that.

``flash_attention(q, k, v, causal, scale, lengths)`` takes q ``[B, H, S_q,
D]`` and k, v ``[B, H, S_kv, D]`` (S_kv = S_q under ``causal``, whose mask
is square, as in the JAX package) and returns ``(O, LSE)``: O in q's type,
LSE ``[B*H, S_q]`` float32. ``lengths`` ([B] int) hides keys at or past
``lengths[b]`` from row b; query rows past the length are computed like any
other (mask the consumer, as the JAX package does). A row that sees no key
gets O = 0.

``flash_attention_backward(q, k, v, out, lse, dout, causal, scale,
lengths)`` returns ``(dQ, dK, dV)``: ``delta = rowsum(dO * O)`` in plain
torch (the JAX package also leaves it outside Pallas), then K2 for dQ and
K3 for dK and dV. A row that sees no key gets dQ = 0; keys past the length
get dK = dV = 0.

All three kernels run their products on the tensor cores (float32 through
the 3xTF32 split, float32-accurate; bfloat16 directly) and load their
tiles with 16-byte asynchronous copies, so they take contiguous, 16-byte
aligned tensors of float32 or bfloat16, D 64 or 128, B*H up to 65535 and
S up to 65535 tiles of 64. K2 and K3 take S_q = S_kv only; on the card a
rectangular backward raises (its plain version takes any S_kv).

``FlashAttentionFunction`` is the ``torch.autograd.Function`` around them,
the counterpart of the ``jax.custom_vjp`` there: its forward runs K1 and
saves Q, K, V, O, LSE and the lengths, its backward runs K2 and K3.
``Lengths`` gets no gradient.

On CPU tensors each wrapper runs its plain version
(``flash_attention_reference``, ``flash_attention_backward_reference``);
on CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import support

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
ALIGN = 16              # K1-K3 copy their tiles 16 bytes at a time
MAX_S = 65535 * 64      # K1-K3 launch one block row per 64-row tile
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = support.launch_counter("flash_attention_forward")
DQ_LAUNCHES = support.launch_counter("flash_attention_backward_dq")
DKV_LAUNCHES = support.launch_counter("flash_attention_backward_dkv")
_kernel = None
_bwd_kernels = None


def _check_shapes(q, k, v, lengths, causal=False):
    """Raise unless q is [B, H, S_q, D] and k, v [B, H, S_kv, D] of one
    shape; causal attention takes S_q = S_kv only (its mask is the
    square one of positions q >= k, as in the JAX package)."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(
            "flash_attention takes q of [B, H, S_q, D] and k, v of one "
            "shape [B, H, S_kv, D], got %s, %s, %s"
            % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if causal and k.shape[2] != q.shape[2]:
        raise ValueError(
            "causal flash_attention takes S_q = S_kv (its mask is "
            "[S, S]), got S_q %d and S_kv %d" % (q.shape[2], k.shape[2]))
    if lengths is not None and tuple(lengths.shape) != (q.shape[0],):
        raise ValueError("lengths must be [B] = [%d], got %s"
                         % (q.shape[0], tuple(lengths.shape)))


def _visible(S, causal, lengths, device, S_kv=None):
    """[B or 1, 1, S, S_kv] bool: key visible to query (S_kv = S unless
    given)."""
    S_kv = S if S_kv is None else S_kv
    kpos = torch.arange(S_kv, device=device)
    vis = torch.ones((S, S_kv), dtype=torch.bool, device=device)
    if causal:
        vis = torch.arange(S, device=device)[:, None] >= kpos[None, :]
    vis = vis[None, None]
    if lengths is not None:
        lens = lengths.to(device=device, dtype=torch.int64)
        vis = vis & (kpos[None, None, None, :] < lens[:, None, None, None])
    return vis


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              scale: Optional[float] = None,
                              lengths: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel: the same masks, the same float32
    softmax with Q scaled first, the same O = 0 / LSE for rows that see no
    key. Any S_q, S_kv (equal under ``causal``), any D."""
    _check_shapes(q, k, v, lengths, causal)
    B, H, S, D = q.shape
    if scale is None:
        scale = float(D) ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    vis = _visible(S, causal, lengths, q.device, k.shape[2])
    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), torch.zeros_like(s))
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l_safe
    lse = (m + torch.log(l_safe)).reshape(B * H, S)
    return out.to(q.dtype), lse


def flash_attention_backward_reference(q, k, v, out, lse, dout,
                                       causal: bool = False,
                                       scale: Optional[float] = None,
                                       lengths: Optional[torch.Tensor] = None):
    """Plain torch version of K2 and K3: the same masks, probabilities
    recomputed from LSE in float32 with Q scaled first as in the forward,
    masked elements p = 0. Returns (dQ, dK, dV) in the input types."""
    _check_shapes(q, k, v, lengths, causal)
    B, H, S, D = q.shape
    if scale is None:
        scale = float(D) ** -0.5
    qs = q.float() * scale
    kf, vf, do = k.float(), v.float(), dout.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    vis = _visible(S, causal, lengths, q.device, k.shape[2])
    p = torch.where(vis, torch.exp(s - lse.reshape(B, H, S, 1)),
                    torch.zeros_like(s))
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, vf) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _load_kernel():
    global _kernel
    if _kernel is None:
        lib = support.load_library("flash_attention")
        fn = lib.paddle_flash_attention_forward
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel = (lib, fn)
    return _kernel


def _check_kernel_args(q, others):
    """Raise unless q and ``others`` (name -> tensor) are what the
    kernels take: one device, one type (float32 or bfloat16), D 64 or
    128, contiguous, B*H within the grid."""
    B, H, S, D = q.shape
    dev = q.device
    for name, t in others.items():
        if t.device != dev:
            raise ValueError("flash_attention: %s is on %s, q on %s"
                             % (name, t.device, dev))
    if q.dtype not in DTYPES or any(t.dtype != q.dtype
                                    for t in others.values()):
        raise ValueError("flash_attention kernel takes float32 or bfloat16 "
                         "q, k, v of one type, got %s, %s"
                         % (q.dtype, [t.dtype for t in others.values()]))
    if D not in HEAD_DIMS:
        raise ValueError("flash_attention kernel takes head dim D in %s, "
                         "got %d" % (HEAD_DIMS, D))
    if not (q.is_contiguous()
            and all(t.is_contiguous() for t in others.values())):
        raise ValueError("flash_attention kernel takes contiguous tensors")
    if B * H > 65535:
        raise ValueError("flash_attention kernel takes B*H <= 65535, got %d"
                         % (B * H))
    if S > MAX_S:
        raise ValueError("flash_attention kernels take S <= %d (65535 "
                         "tiles of 64), got %d" % (MAX_S, S))


def _lengths_ptr(lengths, dev):
    if lengths is None:
        return None, None
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    return lengths, lengths.data_ptr()


def _check_aligned(what, tensors):
    for name, t in tensors.items():
        if t.data_ptr() % ALIGN:
            raise ValueError("%s: %s must be %d-byte aligned, got address "
                             "%% %d = %d" % (what, name, ALIGN, ALIGN,
                                             t.data_ptr() % ALIGN))


def _launch(q, k, v, causal, scale, lengths):
    B, H, S, D = q.shape
    dev = q.device
    _check_kernel_args(q, {"k": k, "v": v})
    _check_aligned("flash_attention kernel", {"q": q, "k": k, "v": v})
    out = torch.empty_like(q)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=dev)
    if q.numel() == 0:
        return out, lse
    lengths, lens_ptr = _lengths_ptr(lengths, dev)
    lib, fn = _load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens_ptr,
                  out.data_ptr(), lse.data_ptr(), B, H, S, k.shape[2], D,
                  int(q.dtype == torch.bfloat16), int(bool(causal)),
                  float(scale), stream)
    support.check_launch(lib, "paddle_flash_attention", code)
    LAUNCHES.inc()
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    lengths: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) of attention of ``[B, H, S_q, D]`` queries over ``[B, H,
    S_kv, D]`` keys and values: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    _check_shapes(q, k, v, lengths, causal)
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, lengths)
    if q.device.type != "cuda":
        raise ValueError("flash_attention: tensors on %s" % q.device)
    return _launch(q, k, v, causal, scale, lengths)


def _load_bwd_kernels():
    global _bwd_kernels
    if _bwd_kernels is None:
        lib = support.load_library("flash_attention_bwd")
        dq_fn = lib.paddle_flash_attention_backward_dq
        dq_fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                          + [ctypes.c_float, ctypes.c_void_p])
        dq_fn.restype = ctypes.c_int
        dkv_fn = lib.paddle_flash_attention_backward_dkv
        dkv_fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_void_p])
        dkv_fn.restype = ctypes.c_int
        _bwd_kernels = (lib, dq_fn, dkv_fn)
    return _bwd_kernels



def _check_backward_args(q, k, v, out, lse, dout):
    B, H, S, _ = q.shape
    if k.shape[2] != S:
        raise ValueError("flash_attention backward kernels (K2, K3) take "
                         "S_q = S_kv, got S_q %d and S_kv %d: their "
                         "rectangular form is not written yet"
                         % (S, k.shape[2]))
    _check_kernel_args(q, {"k": k, "v": v, "out": out, "dout": dout})
    _check_aligned("flash_attention backward kernels",
                   {"q": q, "k": k, "v": v, "dout": dout})
    if lse.shape != (B * H, S) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("flash_attention backward takes LSE as contiguous "
                         "[B*H, S] = [%d, %d] float32 on %s, got %s %s on %s"
                         % (B * H, S, q.device, tuple(lse.shape), lse.dtype,
                            lse.device))


def _bwd_args(q, k, v, dout, lse, delta, causal, scale, lengths):
    """(pointers, trailing scalars, lengths kept alive) of a K2/K3 call."""
    B, H, S, D = q.shape
    lengths, lens_ptr = _lengths_ptr(lengths, q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), lens_ptr)
    tail = (B, H, S, D, int(q.dtype == torch.bfloat16), int(bool(causal)),
            float(scale))
    return ptrs, tail, lengths


def launch_backward_dq(q, k, v, dout, lse, delta, causal, scale, lengths):
    """K2 on checked CUDA tensors: dQ. ``delta`` is rowsum(dO * O) as
    [B*H, S] float32."""
    lib, dq_fn, _ = _load_bwd_kernels()
    dq = torch.empty_like(q)
    ptrs, tail, _lengths = _bwd_args(q, k, v, dout, lse, delta, causal,
                                     scale, lengths)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = dq_fn(*ptrs, dq.data_ptr(), *tail, stream)
    support.check_launch(lib, "paddle_flash_attention_bwd", code)
    DQ_LAUNCHES.inc()
    return dq


def launch_backward_dkv(q, k, v, dout, lse, delta, causal, scale, lengths):
    """K3 on checked CUDA tensors: (dK, dV)."""
    lib, _, dkv_fn = _load_bwd_kernels()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs, tail, _lengths = _bwd_args(q, k, v, dout, lse, delta, causal,
                                     scale, lengths)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = dkv_fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *tail, stream)
    support.check_launch(lib, "paddle_flash_attention_bwd", code)
    DKV_LAUNCHES.inc()
    return dk, dv


def backward_delta(out, dout):
    """delta = rowsum(dO * O) as [B*H, S] float32: the O(S D) pass the JAX
    package also leaves outside its kernels."""
    B, H, S, _ = out.shape
    return (dout.float() * out.float()).sum(dim=-1).reshape(B * H, S)


def _launch_backward(q, k, v, out, lse, dout, causal, scale, lengths):
    _check_backward_args(q, k, v, out, lse, dout)
    if q.numel() == 0:
        return tuple(torch.empty_like(t) for t in (q, k, v))
    delta = backward_delta(out, dout)
    dq = launch_backward_dq(q, k, v, dout, lse, delta, causal, scale,
                            lengths)
    dk, dv = launch_backward_dkv(q, k, v, dout, lse, delta, causal, scale,
                                 lengths)
    return dq, dk, dv


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = False,
                             scale: Optional[float] = None,
                             lengths: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, ...]:
    """(dQ, dK, dV) of attention over ``[B, H, S, D]`` given the forward's
    O and LSE and the output gradient dO: K2 and K3 for CUDA tensors, the
    plain version for CPU tensors."""
    _check_shapes(q, k, v, lengths, causal)
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                  causal, scale, lengths)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_backward: tensors on %s"
                         % q.device)
    return _launch_backward(q, k, v, out, lse, dout.contiguous(), causal,
                            scale, lengths)


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention: K1 forward, K2/K3 backward.

    ``FlashAttentionFunction.apply(q, k, v, lengths, causal, scale)``
    returns O; ``lengths`` may be None and gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, scale):
        out, lse = flash_attention(q, k, v, causal, scale, lengths)
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout,
                                              ctx.causal, ctx.scale, lengths)
        return dq, dk, dv, None, None, None
