"""Paged decode attention: the CUDA kernel (K6) and its plain version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``: the kernel
(``_paged_pallas``, body ``_paged_kernel``) is
``paddle_tpu_torch/csrc/paged_attention.cu``; the source says what bounds it
on the card and how its design answers that.

One query token per row attends over that row's sequence, whose keys and
values are read straight out of the serving tier's paged KV-cache arena
through the row's block table. Shapes: q ``[B, H, D]`` float32; arenas
``[num_blocks, block_tokens, H, D]``; ``block_tables`` ``[B, max_blocks]``
int (-1 padded), or ``[1, max_blocks]`` when every row reads one sequence
(the rows of a prefill chunk); ``seq_lens`` ``[B]`` int. Returns ``[B, H,
D]`` float32; a zero-length row (a padded batch slot) gives zeros.

Storage, as ``k_scales``/``v_scales`` say: None for float32 arenas,
``"bf16"`` for bfloat16 arenas (``torch.bfloat16``, whose bits are the
reference's uint16 patterns), or ``[num_blocks, H]`` float32 per-(block,
head) scales for int8 codes. On a CUDA tensor every storage reaches the
kernel, which stages tiles as stored and widens them as it reads them;
the Pallas path took float32 only. The kernel copies a token row in
pieces of ``copy_width(D, element_size)`` bytes, so each arena's base
must be aligned to that width (a fresh tensor always is).

On CPU tensors ``paged_decode_attention`` runs the plain version
(``paged_attention_reference``); on CUDA tensors it launches the kernel or
raises. The plain version reduces each row on its own, as the reference
does, so its result for a row does not depend on the other rows either.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import support

__all__ = ["paged_decode_attention", "paged_attention_reference"]

MAX_HEAD_DIM = 256
LAUNCHES = support.launch_counter("paged_decode_attention")
_STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_kernel = None


def _widen(arr: torch.Tensor, scales, block_ids: torch.Tensor
           ) -> torch.Tensor:
    """Dequantize one gathered ``[T, H, D]`` slab to float32."""
    if scales is None or isinstance(scales, str):
        return arr.float()   # float32 as is; bfloat16 widens exactly
    s = scales[block_ids]                             # [T, H]
    return arr.float() * s[:, :, None]


def _check_storage(k_arena, v_arena, k_scales, v_scales):
    if k_arena.dtype != v_arena.dtype or k_arena.dtype not in _STORAGE:
        raise ValueError("paged attention takes float32, bfloat16 or int8 "
                         "arenas of one type, got %s and %s"
                         % (k_arena.dtype, v_arena.dtype))
    for s in (k_scales, v_scales):
        if k_arena.dtype == torch.float32:
            ok = s is None
        elif k_arena.dtype == torch.bfloat16:
            ok = isinstance(s, str) and s == "bf16"
        else:
            ok = isinstance(s, torch.Tensor)
        if not ok:
            raise ValueError("a %s arena takes scales None (float32), "
                             "'bf16' (bfloat16) or [num_blocks, H] float32 "
                             "(int8), got %r" % (k_arena.dtype, s))


def paged_attention_reference(q, k_arena, v_arena, block_tables, seq_lens,
                              *, block_tokens: int,
                              scale: Optional[float] = None,
                              k_scales=None, v_scales=None) -> torch.Tensor:
    """Plain torch version: gather each row's blocks, softmax attention in
    float32, one row at a time; zero-length rows give zeros."""
    B, H, D = q.shape
    _check_storage(k_arena, v_arena, k_scales, v_scales)
    if scale is None:
        scale = 1.0 / float(D) ** 0.5
    q = q.float()
    out = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    tables = torch.as_tensor(block_tables).to(torch.int64).cpu()
    lens = torch.as_tensor(seq_lens).to(torch.int64).cpu().tolist()
    for b in range(B):
        n = int(lens[b])
        if n <= 0:
            continue
        nblk = -(-n // block_tokens)
        ids = tables[b if tables.shape[0] > 1 else 0, :nblk].to(q.device)
        # token t lives at (ids[t // bt], t % bt)
        tok_blocks = ids.repeat_interleave(block_tokens)[:n]
        k = _widen(k_arena[ids].reshape(-1, H, D)[:n], k_scales, tok_blocks)
        v = _widen(v_arena[ids].reshape(-1, H, D)[:n], v_scales, tok_blocks)
        s = torch.einsum("hd,thd->ht", q[b], k) * scale      # [H, T]
        s = s - s.amax(dim=1, keepdim=True)
        p = torch.exp(s)
        p = p / p.sum(dim=1, keepdim=True)
        out[b] = torch.einsum("ht,thd->hd", p, v)
    return out


def copy_width(D: int, element_size: int) -> int:
    """Bytes one copy of the kernel moves: the widest of 16, 8, 4, 2 and 1
    that divides a token row of D elements. Each arena's base must be
    aligned to it."""
    width = 16
    while (D * element_size) % width:
        width //= 2
    return width


def _load_kernel():
    global _kernel
    if _kernel is None:
        lib = support.load_library("paged_attention")
        fn = lib.paddle_paged_attention
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel = (lib, fn)
    return _kernel


def _launch(q, k_arena, v_arena, block_tables, seq_lens, block_tokens,
            scale, k_scales, v_scales):
    B, H, D = q.shape
    dev = q.device
    if q.dtype != torch.float32:
        raise ValueError("paged attention kernel takes a float32 q, got %s"
                         % q.dtype)
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError("paged attention kernel takes head dim D in 1..%d, "
                         "got %d" % (MAX_HEAD_DIM, D))
    if k_arena.dim() != 4 or k_arena.shape != v_arena.shape or \
            tuple(k_arena.shape[1:]) != (block_tokens, H, D):
        raise ValueError("arenas must be [num_blocks, %d, %d, %d], got %s "
                         "and %s" % (block_tokens, H, D,
                                     tuple(k_arena.shape),
                                     tuple(v_arena.shape)))
    scales = (k_scales, v_scales) if k_arena.dtype == torch.int8 else ()
    for name, t in (("k_arena", k_arena), ("v_arena", v_arena)) + tuple(
            zip(("k_scales", "v_scales"), scales)):
        if t.device != dev:
            raise ValueError("paged attention: %s is on %s, q on %s"
                             % (name, t.device, dev))
        if not t.is_contiguous():
            raise ValueError("paged attention kernel takes contiguous "
                             "tensors (%s is not)" % name)
    width = copy_width(D, k_arena.element_size())
    for name, t in (("k_arena", k_arena), ("v_arena", v_arena)):
        if t.data_ptr() % width:
            raise ValueError(
                "paged attention kernel takes %s aligned to %d bytes (the "
                "copy width of a %d-byte token row), got address %% %d = %d"
                % (name, width, D * k_arena.element_size(), width,
                   t.data_ptr() % width))
    for s in scales:
        if s.dtype != torch.float32 or \
                tuple(s.shape) != (k_arena.shape[0], H):
            raise ValueError("int8 scales must be [%d, %d] float32, got %s "
                             "%s" % (k_arena.shape[0], H, tuple(s.shape),
                                     s.dtype))
    tables = torch.as_tensor(block_tables).to(device=dev, dtype=torch.int32)
    lens = torch.as_tensor(seq_lens).to(device=dev, dtype=torch.int32)
    if tables.dim() != 2 or tables.shape[0] not in (1, B) or \
            tuple(lens.shape) != (B,):
        raise ValueError("block_tables must be [%d or 1, max_blocks] and "
                         "seq_lens [%d], got %s and %s"
                         % (B, B, tuple(tables.shape), tuple(lens.shape)))
    q = q.contiguous()
    tables, lens = tables.contiguous(), lens.contiguous()
    out = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib, fn = _load_kernel()
    ks = k_scales.data_ptr() if scales else None
    vs = v_scales.data_ptr() if scales else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), ks,
                  vs, tables.data_ptr(), lens.data_ptr(), out.data_ptr(), B,
                  H, D, block_tokens, tables.shape[1],
                  _STORAGE[k_arena.dtype],
                  int(tables.shape[0] == 1 and B > 1), float(scale), stream)
    support.check_launch(lib, "paddle_paged_attention", code)
    LAUNCHES.inc()
    return out


def paged_decode_attention(q, k_arena, v_arena, block_tables, seq_lens, *,
                           block_tokens: int, scale: Optional[float] = None,
                           k_scales=None, v_scales=None,
                           backend: Optional[str] = None) -> torch.Tensor:
    """Decode-step attention over a paged KV cache: the CUDA kernel for
    CUDA tensors (every storage type), the plain version for CPU tensors.

    ``backend`` is kept for the reference's signature: ``None`` (or
    ``"dense"`` on the CPU) only; the port has no Pallas path, and a CUDA
    tensor never takes the plain version."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    _check_storage(k_arena, v_arena, k_scales, v_scales)
    if q.device.type == "cpu":
        if backend not in (None, "dense"):
            raise ValueError("paged attention backend %r: the port runs the "
                             "plain version on the CPU" % (backend,))
        return paged_attention_reference(
            q, k_arena, v_arena, block_tables, seq_lens,
            block_tokens=block_tokens, scale=scale, k_scales=k_scales,
            v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError("paged_decode_attention: tensors on %s" % q.device)
    if backend is not None:
        raise ValueError("paged attention backend %r: on the card the "
                         "kernel runs, always" % (backend,))
    return _launch(q, k_arena, v_arena, block_tables, seq_lens,
                   int(block_tokens), scale, k_scales, v_scales)
