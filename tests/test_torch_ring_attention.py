"""Ring attention and Ulysses sequence parallelism, the port against the
JAX package on the CPU.

Every case of ``tests/test_ring_attention.py``: the port's
``sequence_parallel_attention`` (the sequence split over 8 replicas of an
``sp`` axis) against the dense oracle and against the JAX function on its
mesh of 8 virtual devices, causal and not, with key lengths (a
zero-length example outputs zeros), bf16, grads, a dp x sp layout and the
masked program path. The port's function takes the shards of every
replica of one ring as lists (``ring_attention``), as the engine's walk
holds them.

Tolerances: float32 within 2e-5 (the JAX tests' own), bf16 within 5e-2 of
the float32 oracle, grads within 1e-4; against the JAX function the same.
Losses of the program path within 1e-4 relative and the projection within
``rtol 1e-4, atol 1e-6``, as the JAX test holds its mesh to its dense run.
"""
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.parallel.ring_attention  # noqa: F401
from paddle_tpu.parallel.mesh_utils import make_mesh as jax_mesh
from paddle_tpu_torch.parallel.mesh_utils import make_mesh
import paddle_tpu_torch as fluid
from paddle_tpu_torch.parallel.ring_attention import (
    reference_attention, ring_attention, ring_blocks,
    sequence_parallel_attention, ulysses_attention)

J = sys.modules["paddle_tpu.parallel.ring_attention"]

B, H, S, D = 2, 8, 32, 16  # S over 8 replicas: 4 a replica
TOL = 2e-5


def _inputs(seed=0, shape=(B, H, S, D)):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype("float32") for _ in range(3))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh([8], ["sp"], [fluid.CPUPlace()] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh([8], ["sp"])


def t(a):
    return torch.tensor(a)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_matches_dense_and_the_jax_function(mesh, jmesh, mode, causal):
    q, k, v = _inputs(0 if mode == "ring" else 1)
    ref = reference_attention(t(q), t(k), t(v), causal=causal).numpy()
    out = sequence_parallel_attention(t(q), t(k), t(v), mesh, "sp",
                                      mode=mode, causal=causal).numpy()
    jout = np.asarray(J.sequence_parallel_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmesh, "sp",
        mode=mode, causal=causal))
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, jout, rtol=TOL, atol=TOL)


def test_ring_bf16(mesh):
    q, k, v = _inputs(2)
    qb, kb, vb = (t(x).to(torch.bfloat16) for x in (q, k, v))
    out = sequence_parallel_attention(qb, kb, vb, mesh, "sp", causal=True)
    assert out.dtype == torch.bfloat16
    ref = reference_attention(t(q), t(k), t(v), causal=True)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               rtol=5e-2, atol=5e-2)


def test_ring_grads_match_dense_and_the_jax_function(mesh, jmesh):
    import jax

    q, k, v = _inputs(3)
    qs, ks, vs = (t(x).requires_grad_(True) for x in (q, k, v))
    out = sequence_parallel_attention(qs, ks, vs, mesh, "sp", causal=True)
    g = torch.autograd.grad((out ** 2).sum(), (qs, ks, vs))
    qr, kr, vr = (t(x).requires_grad_(True) for x in (q, k, v))
    ref = reference_attention(qr, kr, vr, causal=True)
    g_ref = torch.autograd.grad((ref ** 2).sum(), (qr, kr, vr))

    def jloss(q, k, v):
        o = J.sequence_parallel_attention(q, k, v, jmesh, "sp", causal=True)
        return (o ** 2).sum()

    g_jax = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b, c in zip(g, g_ref, g_jax):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-4,
                                   atol=1e-4)


def test_dp_sp_layout_matches_dense():
    """Batch halves over dp, the sequence over sp=4: each dp half is its
    own ring."""
    q, k, v = _inputs(4)
    out = torch.cat([sequence_parallel_attention(
        qh, kh, vh, 4, causal=True) for qh, kh, vh in zip(
            t(q).chunk(2), t(k).chunk(2), t(v).chunk(2))])
    ref = reference_attention(t(q), t(k), t(v), causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_masked_matches_dense_and_the_jax_function(mesh, jmesh, causal,
                                                   mode):
    q, k, v = _inputs(7, (2, 8, 32, 8))
    lens = np.array([32, 13], "int32")
    out = sequence_parallel_attention(t(q), t(k), t(v), mesh, "sp",
                                      mode=mode, causal=causal,
                                      lengths=t(lens)).numpy()
    ref = reference_attention(t(q), t(k), t(v), causal=causal,
                              lengths=t(lens)).numpy()
    jout = np.asarray(J.sequence_parallel_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmesh, "sp",
        mode=mode, causal=causal, lengths=jnp.asarray(lens)))
    row_ok = np.zeros((2, 1, 32, 1), "float32")
    row_ok[0, :, :32] = 1.0
    row_ok[1, :, :13] = 1.0
    np.testing.assert_allclose(out * row_ok, ref * row_ok, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(out, jout, rtol=TOL, atol=TOL)


def test_zero_length_examples_output_zeros(mesh):
    q, _, _ = _inputs(9, (2, H, S, D))
    lens = t(np.array([S, 0], "int32"))
    ref = reference_attention(t(q), t(q), t(q), lengths=lens)
    assert torch.all(ref[1] == 0)
    for mode in ("ring", "ulysses"):
        out = sequence_parallel_attention(t(q), t(q), t(q), mesh, "sp",
                                          mode=mode, lengths=lens)
        assert torch.all(out[1] == 0), mode
        np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(),
                                   rtol=TOL, atol=TOL)


def test_causal_ring_skips_the_masked_future():
    """Replica i of a causal ring attends i + 1 blocks, its own first:
    replica 0's share of the work is half of replica 1's on sp=2."""
    assert [len(ring_blocks(8, i, True)) for i in range(8)] == list(
        range(1, 9))
    assert ring_blocks(8, 3, True) == [3, 2, 1, 0]
    assert ring_blocks(4, 1, False) == [1, 0, 3, 2]


def test_ulysses_needs_heads_divisible_by_the_axis():
    q = torch.zeros(1, 6, 4, 8)
    with pytest.raises(ValueError, match="heads"):
        ulysses_attention([q] * 4, [q] * 4, [q] * 4)


def test_lists_of_shards_are_the_engine_form():
    q, k, v = _inputs(11, (1, 2, 16, 8))
    outs = ring_attention(list(t(q).chunk(4, 2)), list(t(k).chunk(4, 2)),
                          list(t(v).chunk(4, 2)), causal=True)
    assert len(outs) == 4 and outs[0].shape == (1, 2, 4, 8)
    ref = reference_attention(t(q), t(k), t(v), causal=True)
    np.testing.assert_allclose(torch.cat(outs, 2).numpy(), ref.numpy(),
                               rtol=TOL, atol=TOL)


def test_masked_flash_routes_ring_on_the_program_path():
    """flash_attention with key lengths transpiles to the masked ring over
    dp(2) x sp(4): the loss and the projection match the JAX mesh."""
    import test_torch_hybrid_parallel as HP

    sp, dp = 4, 2
    Bp, Hp, Sp, Dp = 2 * dp, 4, 8 * sp, 8

    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.data(name="x", shape=[Bp, Hp, Sp, Dp], dtype="float32")
            tgt = pkg.data(name="tgt", shape=[Bp, Hp, Sp, Dp],
                           dtype="float32")
            lens = pkg.data(name="lens", shape=[Bp], dtype="int32")
            w = pkg.layers.create_parameter([Dp, Dp], "float32",
                                            name="w_q2")
            qv = pkg.layers.matmul(x, w)
            o = pkg.layers.flash_attention(qv, x, x, causal=True,
                                           lengths=lens)
            loss = pkg.layers.reduce_mean(pkg.layers.square(
                pkg.layers.elementwise_sub(o, tgt)))
            HP.minimize(pkg, pkg.optimizer.SGDOptimizer(0.05), HP.strategy(
                pkg, sequence_parallel=True, sp_degree=sp,
                feed_shard_specs={"x": ("dp", None, "sp"),
                                  "tgt": ("dp", None, "sp")}), loss)
        return main, startup, loss

    rng = np.random.RandomState(5)
    feeds = [{"x": rng.randn(Bp, Hp, Sp, Dp).astype("float32"),
              "tgt": rng.randn(Bp, Hp, Sp, Dp).astype("float32"),
              "lens": rng.randint(Sp // 2, Sp + 1, (Bp,)).astype("int32")}]
    jl, pl, js, ps, pmain, _ = HP.run_both(build, feeds, [dp, sp],
                                           ["dp", "sp"])
    assert any(op.type == "c_ring_attention"
               for op in pmain.global_block().ops)
    assert pmain._feed_shard_specs["lens"] == ("dp",)
    HP.assert_matches(jl, pl, js, ps, loss_rtol=1e-4)


def test_the_ring_rotation_and_the_axis_subgroups():
    """``ReplicaGroup.ppermute`` is the rotation r -> r + 1 (replica r
    gets its left neighbour's tensor, a copy), ``axis_index`` a replica's
    place; ``AxisGroups`` holds one group a subgroup of a named axis of a
    multi-axis mesh."""
    from paddle_tpu_torch.ops.collective_ops import AxisGroups, ReplicaGroup

    g = ReplicaGroup(["cpu"] * 4)
    xs = [torch.full((2,), float(r)) for r in range(4)]
    got = g.ppermute(xs)
    assert [float(x[0]) for x in got] == [3.0, 0.0, 1.0, 2.0]
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(got, xs))
    assert [g.axis_index(r) for r in range(4)] == [0, 1, 2, 3]
    mesh = make_mesh([2, 2], ["dp", "sp"], [fluid.CPUPlace()] * 4)
    axis = AxisGroups(mesh.axis_groups(["sp"]), mesh.devices)
    assert [r for r, _ in axis.parts()] == [[0, 1], [2, 3]]
    assert mesh.axis_groups(["dp"]) == [[0, 2], [1, 3]]
    assert mesh.coords(3) == {"dp": 1, "sp": 1}
