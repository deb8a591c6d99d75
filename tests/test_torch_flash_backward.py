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
