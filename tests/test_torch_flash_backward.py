"""The port's flash-attention backward (K2/K3) plain version against the JAX
Pallas kernels, and the autograd Function around the kernels.

The JAX side runs as its own tests run it on the CPU: ``_flash_forward``
and ``_flash_backward`` in interpret mode with 16 x 16 blocks. The port's
``flash_attention_backward_reference`` takes the same Q, K, V, dO and the
JAX forward's O and LSE, so the comparison is of the backward alone.
Inputs are unit-scale normals made from a numpy seed.

Tolerances: float32 within 1e-5 absolute (the same float32 recomputation
of P from LSE, products summed in another order over at most 64 terms).
The autograd Function is held to ``torch.autograd`` through the plain
forward within 1e-5 as well (the same float32 math, differentiated by
hand on one side and by autograd on the other).

The card's K2/K3 run float32 products through the 3xTF32 split. An
emulation here (TF32 rounding to nearest on the mantissa bits, then
lo*hi + hi*lo + hi*hi) run through the plain backward's five products
stays within the card tests' float32 limit, 2e-5 of each grad's largest
magnitude, against the plain backward, also with peaked softmaxes (Q times
8), whether lo is rounded to nearest or cut toward zero (the kernels leave
it for the tensor cores to cut); one TF32 pass (hi*hi) goes over it by
far.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.flash_attention import (_flash_backward,
                                                   _flash_forward)
from paddle_tpu_torch.ops.cuda import flash_attention as port_fa

B, H = 3, 2
BLOCK = 16
TOL = 1e-5


def _lengths(kind, S):
    return {"none": None,
            "with_zero": [0, S // 2 + 3, S],
            "partial": [1, S // 3 + 1, S - 5],
            "full": [S, S, S]}[kind]


def _inputs(S, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, S, D).astype("float32") for _ in range(4)]


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("S", [32, 64])
@pytest.mark.parametrize("kind", ["none", "with_zero", "partial", "full"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_pallas_kernels(causal, kind, S, D):
    q, k, v, do = _inputs(S, D, seed=S + D)
    lengths = _lengths(kind, S)
    scale = float(D) ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    out, lse = _flash_forward(jq, jk, jv, causal, scale, BLOCK, BLOCK,
                              interpret=True, lengths=jl)
    want = _flash_backward(jq, jk, jv, out, lse, jdo, causal, scale, BLOCK,
                           BLOCK, True, lengths=jl)

    tl = None if lengths is None else torch.tensor(lengths,
                                                   dtype=torch.int32)
    got = port_fa.flash_attention_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(np.array(out)),
        torch.from_numpy(np.array(lse)).reshape(B * H, S),
        torch.from_numpy(do), causal, scale, tl)
    for name, g, w in zip(("dQ", "dK", "dV"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL,
                                   err_msg=name)
    if lengths is not None and 0 in lengths:
        b = lengths.index(0)
        assert all((g[b] == 0).all() for g in got)
    if lengths is not None:
        for b, n in enumerate(lengths):  # keys past the length: no grad
            assert (got[1][b, :, n:] == 0).all()
            assert (got[2][b, :, n:] == 0).all()


@pytest.mark.parametrize("lengths", [None, [0, 5, 19]])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_autograd_through_the_plain_forward(
        causal, lengths):
    rng = np.random.RandomState(11)
    S, D = 19, 16
    q, k, v, do = (torch.from_numpy(rng.randn(B, H, S, D).astype("float32"))
                   for _ in range(4))
    tl = None if lengths is None else torch.tensor(lengths,
                                                   dtype=torch.int32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = port_fa.FlashAttentionFunction.apply(*leaves, tl, causal, None)
    got = torch.autograd.grad(out, leaves, do)

    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_out, _ = port_fa.flash_attention_reference(*ref_leaves, causal,
                                                   None, tl)
    want = torch.autograd.grad(ref_out, ref_leaves, do)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=TOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL)


def test_cpu_backward_launches_nothing():
    before = (port_fa.DQ_LAUNCHES.value, port_fa.DKV_LAUNCHES.value)
    q = torch.randn(1, 2, 8, 64, requires_grad=True)
    out = port_fa.FlashAttentionFunction.apply(q, q.detach(), q.detach(),
                                               None, True, None)
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert (port_fa.DQ_LAUNCHES.value, port_fa.DKV_LAUNCHES.value) == before


def test_backward_wrapper_refuses_other_devices():
    x = torch.empty((1, 2, 8, 64), device="meta")
    lse = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="meta"):
        port_fa.flash_attention_backward(x, x, x, x, lse, x)


F32_LIMIT = 2e-5   # the card tests' float32 limit for K2/K3


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away
    from zero: what ``cvt.rna.tf32.f32`` gives."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_toward_zero(x):
    """float32 cut to TF32 toward zero: what the tensor cores read of an
    operand whose 13 low bits are not clear."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_product(eq, a, b, passes, lo_cut=_tf32):
    """einsum of TF32 operands: one pass (hi*hi) or the 3xTF32 split
    (lo*hi + hi*lo + hi*hi, hi = tf32(x), lo = lo_cut(x - hi))."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ah, bh)
    if passes == 3:
        al, bl = lo_cut(a - ah), lo_cut(b - bh)
        out = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + out
    return out


def _emulated_backward(q, k, v, out, lse, do, causal, scale, passes,
                       lo_cut=_tf32):
    """The plain backward with every product emulated as the card's
    kernels run it (scale applied after Q K^T and to dQ, dK at the end)."""
    B, H, S, _ = q.shape

    def mm(eq, a, b):
        return _tf32_product(eq, a, b, passes, lo_cut)

    s = mm("bhqd,bhkd->bhqk", q, k) * scale
    vis = port_fa._visible(S, causal, None, q.device)
    p = torch.where(vis, torch.exp(s - lse.reshape(B, H, S, 1)),
                    torch.zeros_like(s))
    delta = (do * out).sum(dim=-1, keepdim=True)
    ds = p * (mm("bhqd,bhkd->bhqk", do, v) - delta)
    dv = mm("bhqk,bhqd->bhkd", p, do)
    dq = mm("bhqk,bhkd->bhqd", ds, k) * scale
    dk = mm("bhqk,bhqd->bhkd", ds, q) * scale
    return dq, dk, dv


@pytest.mark.parametrize("lo_cut", ["nearest", "toward_zero"])
@pytest.mark.parametrize("peak", [1.0, 8.0])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_split_keeps_the_float32_limit_and_one_pass_does_not(
        causal, S, D, peak, lo_cut):
    """lo rounded to nearest, or left for the tensor cores to cut toward
    zero as the kernels leave it: either way within the limit."""
    cut = {"nearest": _tf32, "toward_zero": _tf32_toward_zero}[lo_cut]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(S, D, seed=S + D))
    q = q * peak
    scale = float(D) ** -0.5
    out, lse = port_fa.flash_attention_reference(q, k, v, causal, scale)
    want = port_fa.flash_attention_backward_reference(q, k, v, out, lse, do,
                                                      causal, scale)

    def worst(passes):
        got = _emulated_backward(q, k, v, out, lse, do, causal, scale,
                                 passes, cut)
        return max(float((g - w).abs().max())
                   / max(float(w.abs().max()), 1.0)
                   for g, w in zip(got, want))

    assert worst(3) <= F32_LIMIT
    assert worst(1) > 10 * F32_LIMIT


def test_tf32_rounding_is_to_nearest_on_the_mantissa():
    one = 1.0 + 2.0 ** -10     # representable in TF32
    x = torch.tensor([1.0 + 2.0 ** -11,            # tie: away from zero
                      1.0 + 2.0 ** -11 - 2.0 ** -20,  # below the tie
                      -(1.0 + 2.0 ** -11), one], dtype=torch.float32)
    want = torch.tensor([one, 1.0, -one, one], dtype=torch.float32)
    assert torch.equal(_tf32(x), want)


def test_backward_kernel_limits_raise_naming_the_limit():
    x = torch.zeros(2 * 4 * 64 + 1)[1:].view(1, 2, 4, 64)  # 4 bytes off
    lse = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        port_fa._check_backward_args(x, x, x, x, lse, x)
    S = port_fa.MAX_S + 1
    y = torch.empty((1, 1, S, 64), device="meta")
    with pytest.raises(ValueError, match="S <= %d" % port_fa.MAX_S):
        port_fa._check_backward_args(y, y, y, y,
                                     torch.empty((1, S), device="meta"), y)
