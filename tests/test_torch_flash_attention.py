"""The port's flash-attention plain version against the JAX Pallas kernel.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel in
interpret mode (``force_pallas=True``, block 16) for O, and
``_flash_forward(..., interpret=True)`` for the LSE (which takes the dense
path when S is not a multiple of the block, as S = 24 is). Inputs are made
from a numpy seed and handed to both.

Tolerances: float32 within 1e-5 (the same float32 softmax, summed in
another order). bfloat16 inputs, with O rounded to bfloat16 on both sides,
are compared in float32 within 2e-2 (two bfloat16 rounding steps near 1).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas.flash_attention import (_flash_forward,
                                                   flash_attention as jax_fa)
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.ops.cuda import flash_attention as port_fa
from paddle_tpu_torch.ops.cuda import support

B, H, D = 3, 2, 16
BLOCK = 16


def _lengths(kind, S):
    return {"none": None,
            "with_zero": [0, S // 2, S],
            "partial": [1, S // 3 + 1, S - 1],
            "full": [S, S, S]}[kind]


def _inputs(S, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, S, D).astype("float32") for _ in range(3)]


def _jax_out_lse(q, k, v, causal, lengths, dtype=jnp.float32):
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    scale = float(D) ** -0.5
    out = jax_fa(jq, jk, jv, causal=causal, block_q=BLOCK, block_k=BLOCK,
                 force_pallas=True, lengths=jl)
    _, lse = _flash_forward(jq, jk, jv, causal, scale, BLOCK, BLOCK,
                            interpret=True, lengths=jl)
    return (np.asarray(out.astype(jnp.float32)),
            np.asarray(lse).reshape(B * H, -1))


def _port_out_lse(q, k, v, causal, lengths, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    tl = None if lengths is None else torch.tensor(lengths,
                                                   dtype=torch.int32)
    out, lse = port_fa.flash_attention_reference(tq, tk, tv, causal, None,
                                                 tl)
    return out.float().numpy(), lse.numpy()


def _seen_rows(lengths, S):
    """[B*H, S] mask of rows whose batch has at least one key."""
    lens = np.full(B, S) if lengths is None else np.asarray(lengths)
    return np.repeat(lens > 0, H)[:, None].repeat(S, axis=1)


@pytest.mark.parametrize("S", [16, 32, 24])
@pytest.mark.parametrize("kind", ["none", "with_zero", "partial", "full"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_pallas_kernel_f32(causal, kind, S):
    q, k, v = _inputs(S, seed=S)
    lengths = _lengths(kind, S)
    j_out, j_lse = _jax_out_lse(q, k, v, causal, lengths)
    p_out, p_lse = _port_out_lse(q, k, v, causal, lengths)
    np.testing.assert_allclose(p_out, j_out, rtol=1e-5, atol=1e-5)
    seen = _seen_rows(lengths, S)
    np.testing.assert_allclose(p_lse[seen], j_lse[seen], rtol=1e-5,
                               atol=1e-5)
    assert np.isfinite(p_out).all()
    if lengths is not None and 0 in lengths:
        assert (p_out[lengths.index(0)] == 0).all()


@pytest.mark.parametrize("kind", ["with_zero", "partial"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_pallas_kernel_bf16(causal, kind):
    S = 32
    q, k, v = _inputs(S, seed=7)
    lengths = _lengths(kind, S)
    j_out, _ = _jax_out_lse(q, k, v, causal, lengths, jnp.bfloat16)
    p_out, _ = _port_out_lse(q, k, v, causal, lengths, torch.bfloat16)
    np.testing.assert_allclose(p_out, j_out, rtol=2e-2, atol=2e-2)


def test_cpu_wrapper_never_touches_the_loader(monkeypatch):
    def _no_loader(name):
        raise AssertionError("the CPU path loaded %r" % name)

    monkeypatch.setattr(support, "load_library", _no_loader)
    monkeypatch.setattr(support, "build", _no_loader)
    before = port_fa.LAUNCHES.value
    q, k, v = (torch.from_numpy(a) for a in _inputs(32, seed=3))
    lens = torch.tensor([0, 5, 32], dtype=torch.int32)
    out, lse = port_fa.flash_attention(q, k, v, True, None, lens)
    ref_out, ref_lse = port_fa.flash_attention_reference(q, k, v, True,
                                                         None, lens)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert port_fa.LAUNCHES.value == before == 0


def test_wrapper_refuses_other_devices_and_shapes():
    q = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="meta"):
        port_fa.flash_attention(q, q, q)
    x = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="one shape"):
        port_fa.flash_attention(x, x[:, :, :4], x)
    with pytest.raises(ValueError, match="lengths"):
        port_fa.flash_attention(x, x, x, lengths=torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="S_q = S_kv"):
        port_fa.flash_attention(x, torch.zeros((1, 2, 16, 64)),
                                torch.zeros((1, 2, 16, 64)), causal=True)
    with pytest.raises(ValueError, match="one shape"):
        port_fa.flash_attention(x, torch.zeros((1, 2, 16, 32)),
                                torch.zeros((1, 2, 16, 32)))


# rectangular (cross) attention: S_q 8 queries over S_kv 16 keys, D 64.
# The JAX op computes it by its dense path; O and the grads agree within
# float32 rounding of sums of 16 products (observed ~1e-7), 1e-5 allowed.
RECT = dict(B=1, H=2, S_q=8, S_kv=16, D=64)
RECT_TOL = 1e-5


@pytest.mark.parametrize("lengths", [None, [11]])
def test_rectangular_op_and_grads_match_the_jax_op(lengths):
    b, h, sq, skv, d = (RECT[k] for k in ("B", "H", "S_q", "S_kv", "D"))
    rng = np.random.RandomState(5)
    q = rng.randn(b, h, sq, d).astype("float32")
    k, v = (rng.randn(b, h, skv, d).astype("float32") for _ in range(2))
    dout = rng.randn(b, h, sq, d).astype("float32")

    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    j_out, vjp = jax.vjp(lambda q_, k_, v_: jax_fa(q_, k_, v_, lengths=jl),
                         *(jnp.asarray(a) for a in (q, k, v)))
    j_grads = vjp(jnp.asarray(dout))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    ins = dict(zip("QKV", leaves))
    ins["Lengths"] = (None if lengths is None
                      else torch.tensor(lengths, dtype=torch.int32))
    op = OpInfoMap.instance().get("flash_attention")
    out = op.fn(ins, {"causal": False, "scale": 0.0})["Out"]
    assert tuple(out.shape) == (b, h, sq, d)
    p_grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout))

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=0, atol=RECT_TOL)
    for name, pg, jg in zip("qkv", p_grads, j_grads):
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=0,
                                   atol=RECT_TOL, err_msg=name)
    if lengths is not None:   # keys past the length get no gradient
        assert (p_grads[1][:, :, lengths[0]:] == 0).all()
        assert (p_grads[2][:, :, lengths[0]:] == 0).all()
    _, lse = port_fa.flash_attention_reference(*leaves, lengths=ins[
        "Lengths"])
    assert tuple(lse.shape) == (b * h, sq)


# The card's K1 runs float32 products through the 3xTF32 split. An
# emulation here (TF32 rounding to nearest on the mantissa bits, then
# lo*hi + hi*lo + hi*hi, lo left for the tensor cores to cut toward zero)
# run through the plain forward's two products stays within the card's
# float32 limit on O against the plain version (``KERNEL_TOL``, 2e-5), also
# with peaked softmaxes (Q times 8); one TF32 pass (hi*hi) goes over it.
# LSE stays within ``LSE_TOL`` (2e-5 absolute) on unit-scale inputs, those
# of the card's checks; with Q times 8 at D 128 the scores reach tens and
# the split's 2^-21 relative error reads 2.1e-5 on LSE, so that case's
# LSE is not held to the absolute limit.
F32_LIMIT = 2e-5


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` gives."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_toward_zero(x):
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_product(eq, a, b, passes):
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ah, bh)
    if passes == 3:
        al, bl = _tf32_toward_zero(a - ah), _tf32_toward_zero(b - bh)
        out = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + out
    return out


def _emulated_forward(q, k, v, causal, scale, lengths, passes):
    """The plain forward with both products as the card's K1 runs them
    (scale applied after Q K^T)."""
    B, H, S, _ = q.shape
    s = _tf32_product("bhqd,bhkd->bhqk", q, k, passes) * scale
    vis = port_fa._visible(S, causal, lengths, q.device, k.shape[2])
    s = torch.where(vis, s, torch.full_like(s, port_fa.NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), torch.zeros_like(s))
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = _tf32_product("bhqk,bhkd->bhqd", p, v, passes) / l_safe
    return out, (m + torch.log(l_safe)).reshape(B * H, S)


@pytest.mark.parametrize("peak", [1.0, 8.0])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_forward_keeps_the_float32_limit_and_one_pass_does_not(
        causal, D, peak):
    rng = np.random.RandomState(D + int(peak))
    q, k, v = (torch.from_numpy(rng.randn(2, 2, 64, D).astype("float32"))
               for _ in range(3))
    q = q * peak
    lengths = torch.tensor([64, 41], dtype=torch.int32)
    scale = float(D) ** -0.5
    want, want_lse = port_fa.flash_attention_reference(q, k, v, causal,
                                                       scale, lengths)

    def errors(passes):
        got, lse = _emulated_forward(q, k, v, causal, scale, lengths, passes)
        return (float((got - want).abs().max()),
                float((lse - want_lse).abs().max()))

    err_o, err_lse = errors(3)
    assert err_o <= F32_LIMIT
    if peak == 1.0:
        assert err_lse <= F32_LIMIT
    assert errors(1)[0] > F32_LIMIT
