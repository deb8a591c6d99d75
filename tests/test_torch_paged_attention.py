"""The port's paged-attention plain version against the JAX package.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel in
interpret mode (``backend="pallas_interpret"``) on float32 arenas, and its
dense path (``backend="dense"``) on bfloat16 and int8 arenas, which the
Pallas path refuses. Arenas, tables, lengths and queries are made from a
numpy seed and handed to both: bfloat16 arenas as the reference's uint16
patterns (and the same bits as ``torch.bfloat16``), int8 arenas as codes
with per-(block, head) scales.

Cases: lengths 0, 1, BT-1, BT, BT+1 and ragged ones; tables padded with -1
and blocks scattered over the arena; the prefill form, where the rows share
one table (``[1, max_blocks]`` in the port, the same row repeated for the
JAX package) and row t has length start + t + 1.

Tolerance 2e-5, as ``tests/test_serving_decode.py`` holds the Pallas kernel
to its dense path: the same float32 softmax, summed in another order.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as jax_paged)
from paddle_tpu.serving.decode.kvcache import _to_bf16_bits
from paddle_tpu_torch.ops.cuda import paged_attention as k6

TOL = 2e-5
BT, H, NB = 4, 2, 24
CASES = {
    # lengths 0, 1, BT-1, BT, BT+1 and a longer one, one row each
    "edges": [0, 1, BT - 1, BT, BT + 1, 3 * BT + 2],
    "ragged": [7, 2, 13, 0, 9],
}


def _arena(rng, storage, D):
    """(JAX arena, port arena, JAX scales, port scales) of one side."""
    vals = rng.randn(NB, BT, H, D).astype(np.float32)
    if storage == "f32":
        return vals, torch.from_numpy(vals.copy()), None, None
    if storage == "bf16":
        bits = _to_bf16_bits(vals)
        port = torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
        return bits, port, "bf16", "bf16"
    codes = rng.randint(-127, 128, size=(NB, BT, H, D)).astype(np.int8)
    scales = (rng.rand(NB, H).astype(np.float32) + 0.5) / 127.0
    return (codes, torch.from_numpy(codes.copy()), scales,
            torch.from_numpy(scales.copy()))


def _tables(rng, lens):
    """-1 padded tables over blocks scattered across the arena."""
    width = max(1, max(-(-n // BT) for n in lens))
    perm = rng.permutation(NB)
    table = np.full((len(lens), width), -1, np.int32)
    used = 0
    for b, n in enumerate(lens):
        nblk = -(-n // BT)
        table[b, :nblk] = perm[used:used + nblk]
        used += nblk
    return table


def _inputs(storage, D, case, seed):
    rng = np.random.RandomState(seed)
    ka, kp, ksj, ksp = _arena(rng, storage, D)
    va, vp, vsj, vsp = _arena(rng, storage, D)
    if case == "prefill":
        start, T = 5, 11
        lens = [start + t + 1 for t in range(T)]
        table = _tables(rng, [start + T])
        jtable, ptable = np.repeat(table, T, axis=0), table
    else:
        lens = CASES[case]
        jtable = ptable = _tables(rng, lens)
    q = rng.randn(len(lens), H, D).astype(np.float32)
    jax_args = (q, ka, va, jtable, np.asarray(lens, np.int32))
    port_args = (torch.from_numpy(q), kp, vp, torch.from_numpy(ptable),
                 torch.tensor(lens, dtype=torch.int32))
    return jax_args, dict(k_scales=ksj, v_scales=vsj), port_args, dict(
        k_scales=ksp, v_scales=vsp), lens


@pytest.mark.parametrize("case", ["edges", "ragged", "prefill"])
@pytest.mark.parametrize("D", [8, 64])
def test_f32_plain_version_matches_the_pallas_kernel(D, case):
    jargs, _, pargs, pkw, lens = _inputs("f32", D, case, seed=D)
    want = jax_paged(*jargs, block_tokens=BT, backend="pallas_interpret")
    got = k6.paged_decode_attention(*pargs, block_tokens=BT, **pkw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    for b, n in enumerate(lens):
        if n == 0:
            assert (got[b] == 0).all()


@pytest.mark.parametrize("case", ["edges", "ragged", "prefill"])
@pytest.mark.parametrize("D", [8, 64])
@pytest.mark.parametrize("storage", ["bf16", "int8"])
def test_quantized_plain_version_matches_the_dense_path(storage, D, case):
    jargs, jkw, pargs, pkw, _ = _inputs(storage, D, case, seed=3 * D + 1)
    want = jax_paged(*jargs, block_tokens=BT, backend="dense", **jkw)
    got = k6.paged_decode_attention(*pargs, block_tokens=BT, **pkw)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_a_row_does_not_depend_on_the_others():
    """Each row alone gives the bits it gives inside the batch (the
    decode engine's invariance rests on it)."""
    _, _, (q, ka, va, table, lens), kw, _ = _inputs("f32", 8, "ragged", 5)
    batch = k6.paged_decode_attention(q, ka, va, table, lens,
                                      block_tokens=BT)
    for b in range(q.shape[0]):
        alone = k6.paged_decode_attention(q[b:b + 1], ka, va,
                                          table[b:b + 1], lens[b:b + 1],
                                          block_tokens=BT)
        assert torch.equal(alone[0], batch[b])


def test_scale_argument_matches_the_reference():
    jargs, _, pargs, _, _ = _inputs("f32", 8, "ragged", seed=9)
    want = jax_paged(*jargs, block_tokens=BT, scale=0.25, backend="dense")
    got = k6.paged_decode_attention(*pargs, block_tokens=BT, scale=0.25)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_refuses_what_it_does_not_take():
    _, _, (q, ka, va, table, lens), _, _ = _inputs("f32", 8, "ragged", 1)
    with pytest.raises(ValueError, match="backend"):
        k6.paged_decode_attention(q, ka, va, table, lens, block_tokens=BT,
                                  backend="pallas")
    with pytest.raises(ValueError, match="scales"):
        k6.paged_decode_attention(q, ka, va, table, lens, block_tokens=BT,
                                  k_scales="bf16", v_scales="bf16")
    with pytest.raises(ValueError, match="scales"):
        k6.paged_decode_attention(q, ka.to(torch.bfloat16),
                                  va.to(torch.bfloat16), table, lens,
                                  block_tokens=BT)
    with pytest.raises(ValueError, match="arenas"):
        k6.paged_decode_attention(q, ka.half(), va.half(), table, lens,
                                  block_tokens=BT)


# The card's K6 runs its products on the tensor cores: a float32 operand
# through the 3xTF32 split (lo*hi + hi*lo + hi*hi, hi = tf32(x) rounded to
# nearest, lo = x - hi cut toward zero), a bf16 or int8 operand (exact in
# TF32) times both halves of the other; int8 scales multiply after the
# product. An emulation of that arithmetic through the plain version's two
# products stays within K6's limit, 2e-5 of the output's largest
# magnitude, on every storage; one TF32 pass (hi*hi) does not.
def _tf32(x):
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


def _emulated_kernel(q, k_arena, v_arena, tables, lens, scales, bt, passes):
    """Each row as K6 computes it: stored values widened exactly (codes
    for int8), S = q K^T, the key scale per column, P times the value
    scale per column before P V."""
    B, H, D = q.shape
    scale = float(D) ** -0.5
    out = torch.zeros(B, H, D)
    for b, n in enumerate(lens):
        if n == 0:
            continue
        ids = tables[b if tables.shape[0] > 1 else 0, :-(-n // bt)].long()
        tok_blocks = ids.repeat_interleave(bt)[:n]
        k = k_arena[ids].reshape(-1, H, D)[:n].float()
        v = v_arena[ids].reshape(-1, H, D)[:n].float()
        s = _tf32_product("hd,thd->ht", q[b], k, passes)
        if scales is not None:
            s = s * scales[0][tok_blocks].T
        s = s * scale
        p = torch.exp(s - s.amax(dim=1, keepdim=True))
        l = p.sum(dim=1, keepdim=True)
        if scales is not None:
            p = p * scales[1][tok_blocks].T
        out[b] = _tf32_product("ht,thd->hd", p, v, passes) / l
    return out


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_tensor_core_arithmetic_keeps_k6_limit_and_one_pass_does_not(
        storage):
    D = 64
    _, _, port_args, port_kw, lens = _inputs(storage, D, "ragged", seed=17)
    q, ka, va, table, _ = port_args
    want = k6.paged_attention_reference(*port_args, block_tokens=BT,
                                        **port_kw)
    scales = (None if storage != "int8"
              else (port_kw["k_scales"], port_kw["v_scales"]))

    def rel(passes):
        got = _emulated_kernel(q, ka, va, table, lens, scales, BT, passes)
        return float((got - want).abs().max()) / float(want.abs().max())

    assert rel(3) <= TOL
    assert rel(1) > TOL


@pytest.mark.parametrize("D,esize,width", [
    (64, 4, 16), (64, 2, 16), (64, 1, 16), (30, 4, 8), (31, 4, 4),
    (31, 2, 2), (8, 1, 8), (31, 1, 1)])
def test_copy_width_is_the_widest_that_divides_a_token_row(D, esize, width):
    assert k6.copy_width(D, esize) == width
