"""Expert-parallel MoE, the port against the JAX package on the CPU.

The cases of ``tests/test_moe_ep.py``: the port's
``expert_parallel_moe`` over 4 replicas of an ``ep`` subgroup (a
``ReplicaGroup``) against the dense oracle ``moe_reference`` (the tokens
in 4 chunks, so both drop the same tokens) and against the JAX function
under ``shard_map`` on 4 virtual devices; a tiny capacity that drops
tokens; and the expert weights' grads through both all-to-alls. The
``moe`` op's dense form (``num_groups`` chunks) is the oracle too.

Tolerances: outputs within ``rtol 1e-4, atol 1e-5`` and grads within
1e-4, the JAX tests' own.
"""
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import paddle_tpu.parallel.moe  # noqa: F401
from paddle_tpu.parallel.mesh_utils import make_mesh, shard_map_compat
from paddle_tpu_torch.ops.collective_ops import ReplicaGroup
from paddle_tpu_torch.parallel.moe import (_top1_dispatch,
                                           expert_parallel_moe,
                                           moe_reference)

J = sys.modules["paddle_tpu.parallel.moe"]

N = 4
T_LOCAL, D, H, E_LOCAL = 8, 6, 10, 2
T, E = T_LOCAL * N, E_LOCAL * N


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(T, D).astype("float32"),
            rng.randn(D, E).astype("float32"),
            (rng.randn(E, D, H) * 0.3).astype("float32"),
            (rng.randn(E, H, D) * 0.3).astype("float32"))


def port(x, gw, wi, wo, cf):
    x, gw, wi, wo = (torch.as_tensor(a) for a in (x, gw, wi, wo))
    outs = expert_parallel_moe(list(x.chunk(N)), [gw] * N,
                               list(wi.chunk(N)), list(wo.chunk(N)),
                               ReplicaGroup(["cpu"] * N), cf)
    return torch.cat(outs)


def jax_moe(x, gw, wi, wo, cf):
    mesh = make_mesh([N], ["ep"])
    f = shard_map_compat(
        lambda a, b, c, d: J.expert_parallel_moe(a, b, c, d, "ep", cf, N),
        mesh, in_specs=(P("ep"), P(), P("ep"), P("ep")), out_specs=P("ep"))
    return np.asarray(jax.jit(f)(x, gw, wi, wo))


def check(cf, seed):
    x, gw, wi, wo = _inputs(seed)
    got = port(x, gw, wi, wo, cf).numpy()
    ref = moe_reference(*(torch.as_tensor(a) for a in (x, gw, wi, wo)),
                        cf, N).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, jax_moe(x, gw, wi, wo, cf), rtol=1e-4,
                               atol=1e-5)
    return got


def test_matches_oracle_and_the_jax_function():
    check(2.0, 0)


def test_capacity_drop_semantics():
    got = check(0.25, 1)
    assert (np.abs(got).sum(axis=1) == 0).any()


def test_dispatch_drops_in_token_order():
    """Tokens past an expert's capacity are dropped in token order, as the
    JAX dispatch drops them."""
    x, gw, _, _ = _inputs(1)
    cap = 1
    disp, _, _ = _top1_dispatch(torch.as_tensor(x[:T_LOCAL]),
                                torch.as_tensor(gw), E, cap)
    jdisp, _, _ = J._top1_dispatch(jnp.asarray(x[:T_LOCAL]),
                                   jnp.asarray(gw), E, cap)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
    assert float(disp.sum()) <= E * cap


def test_expert_grads_flow():
    x, gw, wi, wo = _inputs(2)
    wi_t, wo_t = (torch.tensor(a, requires_grad=True) for a in (wi, wo))
    g = torch.autograd.grad((port(x, gw, wi_t, wo_t, 2.0) ** 2).sum(),
                            (wi_t, wo_t))
    wi_r, wo_r = (torch.tensor(a, requires_grad=True) for a in (wi, wo))
    ref = moe_reference(torch.as_tensor(x), torch.as_tensor(gw), wi_r,
                        wo_r, 2.0, N)
    g_ref = torch.autograd.grad((ref ** 2).sum(), (wi_r, wo_r))
    mesh = make_mesh([N], ["ep"])
    f = shard_map_compat(
        lambda a, b, c, d: J.expert_parallel_moe(a, b, c, d, "ep", 2.0, N),
        mesh, in_specs=(P("ep"), P(), P("ep"), P("ep")), out_specs=P("ep"))
    g_jax = jax.grad(lambda a, b: (f(x, gw, a, b) ** 2).sum(),
                     argnums=(0, 1))(wi, wo)
    for a, b, c in zip(g, g_ref, g_jax):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-4,
                                   atol=1e-4)
        assert a.abs().sum() > 0


def test_the_moe_op_dense_form_is_the_oracle():
    """The ``moe`` op with no live ``ep`` axis runs ``num_groups`` chunks:
    the same tokens drop as on the mesh."""
    from paddle_tpu_torch.core.registry import OpInfoMap

    x, gw, wi, wo = _inputs(3)
    ins = {"X": torch.as_tensor(x), "GateW": torch.as_tensor(gw),
           "WIn": torch.as_tensor(wi), "WOut": torch.as_tensor(wo)}
    out = OpInfoMap.instance().get("moe").fn(
        ins, {"shard_axis": "ep", "num_groups": N,
              "capacity_factor": 0.5})["Out"]
    np.testing.assert_allclose(out.numpy(), port(x, gw, wi, wo,
                                                 0.5).numpy(),
                               rtol=1e-4, atol=1e-5)
