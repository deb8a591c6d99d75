"""The port's fused optimizer update (K4) plain version against the JAX
Pallas kernel, and the port's ``fused_optimizer`` op against its
per-parameter ops.

The JAX side runs as its own tests run it on the CPU:
``fused_optimizer_update(..., force_pallas=True)``, the Pallas kernel in
interpret mode, over flat buffers padded to ``LANE_PAD``. Inputs are made
from a numpy seed and handed to both.

Tolerances: the plain version within 4 float32 ULP of the Pallas kernel
(the same operations in the same order, but XLA may contract a product
and a sum into one FMA where eager torch rounds twice; tools/sc_smoke.py
states the same 4-ULP contraction bound). A contraction differs by up to
an ULP of the product it absorbs, which can be far more ULP of a result
that cancels (p - lr g near 0), so the ULP is that of the element's
largest operand or result. The port's ``fused_optimizer``
op, flat and chain, equals the port's per-parameter ops bit for bit: the
same operations on every element.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu.ops.pallas.fused_optimizer import (LANE_PAD,
                                                   fused_optimizer_update)
from paddle_tpu_torch.core.fusion import LANE_PAD as PORT_LANE_PAD
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.ops.cuda import fused_optimizer as port_fo

MAX_ULP = 4
CASES = [("sgd", False), ("momentum", False), ("momentum", True),
         ("adam", False), ("adamw", False)]


def _attrs(nesterov):
    return {"mu": 0.9, "use_nesterov": nesterov, "beta1": 0.9,
            "beta2": 0.999, "epsilon": 1e-8, "weight_decay": 0.01}


def _ulps(got, want, operands):
    """Largest |got - want| in float32 ULPs of each element's largest
    operand or result."""
    scale = np.abs(np.asarray(want, np.float32))
    for x in operands:
        scale = np.maximum(scale, np.abs(x))
    return float((np.abs(np.asarray(got, np.float64) - want)
                  / np.spacing(scale.astype(np.float32))).max())


def _flat_inputs(n, seed):
    rng = np.random.RandomState(seed)
    p, g, sa = (rng.randn(n).astype("float32") for _ in range(3))
    sb = np.abs(rng.randn(n)).astype("float32")
    return p, g, sa, sb


@pytest.mark.parametrize("op_type,nesterov", CASES)
def test_plain_version_matches_pallas_kernel(op_type, nesterov):
    n = 3 * LANE_PAD
    p, g, sa, sb = _flat_inputs(n, seed=len(op_type))
    lr = np.float32(0.05)
    b1p, b2p = np.float32(0.81), np.float32(0.998)
    n_state = port_fo.N_STATES[op_type]
    attrs = _attrs(nesterov)
    want = fused_optimizer_update(
        op_type, attrs, jnp.asarray(p), jnp.asarray(g), jnp.asarray(lr),
        jnp.asarray(sa) if n_state >= 1 else None,
        jnp.asarray(sb) if n_state >= 2 else None,
        jnp.asarray([b1p]), jnp.asarray([b2p]), force_pallas=True)
    t = torch.from_numpy
    got = port_fo.fused_optimizer_update(
        op_type, attrs, t(p), t(g), t(np.array([lr])),
        t(sa) if n_state >= 1 else None, t(sb) if n_state >= 2 else None,
        t(np.array([b1p])), t(np.array([b2p])))
    assert port_fo.LAUNCHES.value == 0
    for i, (a, b) in enumerate(zip(got, want)):
        if i > n_state:
            assert a is None and b is None
            continue
        operands = [p, g, sa, sb][:2 + n_state]
        assert _ulps(a.numpy(), np.asarray(b), operands) <= MAX_ULP, \
            (op_type, i)
    assert LANE_PAD == PORT_LANE_PAD


def _per_param(op_type, attrs, ps, gs, sas, sbs, lr, b1p, b2p):
    fn = OpInfoMap.instance().get(op_type).fn
    outs = []
    for i, (p, g) in enumerate(zip(ps, gs)):
        ins = {"Param": p, "Grad": g, "LearningRate": lr}
        if op_type == "momentum":
            ins["Velocity"] = sas[i]
        if op_type in ("adam", "adamw"):
            ins.update(Moment1=sas[i], Moment2=sbs[i], Beta1Pow=b1p,
                       Beta2Pow=b2p)
        outs.append(fn(ins, attrs))
    return outs


@pytest.mark.parametrize("layout", ["flat", "chain"])
@pytest.mark.parametrize("op_type,nesterov", CASES)
def test_fused_op_equals_per_param_ops(op_type, nesterov, layout):
    sizes = [(7,), (3, 43), (1024,), (33, 1)]
    rng = np.random.RandomState(5)
    mk = (lambda s: torch.from_numpy(rng.randn(*s).astype("float32")))
    ps, gs, sas = ([mk(s) for s in sizes] for _ in range(3))
    sbs = [mk(s).abs() for s in sizes]
    lr = torch.tensor([0.01])
    b1p, b2p = torch.tensor([0.9]), torch.tensor([0.999])
    attrs = dict(_attrs(nesterov), op_type=op_type, layout=layout)
    n_state = port_fo.N_STATES[op_type]
    total = sum(int(np.prod(s)) for s in sizes)
    padded = -(-total // PORT_LANE_PAD) * PORT_LANE_PAD
    attrs["padded_size"] = padded

    def flat(xs):
        f = torch.cat([x.reshape(-1) for x in xs])
        return torch.cat([f, f.new_zeros(padded - total)])

    ins = {"Param": ps, "Grad": gs, "LearningRate": lr}
    if n_state >= 1:
        ins["StateA"] = [flat(sas)] if layout == "flat" else sas
    if n_state >= 2:
        ins["StateB"] = [flat(sbs)] if layout == "flat" else sbs
        ins["Beta1Pow"] = [b1p] * len(ps)
        ins["Beta2Pow"] = [b2p] * len(ps)
    got = OpInfoMap.instance().get("fused_optimizer").fn(ins, attrs)
    want = _per_param(op_type, _attrs(nesterov), ps, gs, sas, sbs, lr, b1p,
                      b2p)

    state_slots = {"momentum": ["VelocityOut"],
                   "adam": ["Moment1Out", "Moment2Out"],
                   "adamw": ["Moment1Out", "Moment2Out"]}.get(op_type, [])
    off = 0
    for i, w in enumerate(want):
        assert torch.equal(got["ParamOut"][i], w["ParamOut"])
        k = w["ParamOut"].numel()
        for j, slot in enumerate(state_slots):
            fused = got["StateAOut" if j == 0 else "StateBOut"]
            if layout == "flat":
                assert torch.equal(fused[0][off:off + k],
                                   w[slot].reshape(-1))
            else:
                assert torch.equal(fused[i], w[slot])
        if n_state == 2:
            assert torch.equal(got["Beta1PowOut"][i], w["Beta1PowOut"])
            assert torch.equal(got["Beta2PowOut"][i], w["Beta2PowOut"])
        off += k
    if layout == "flat" and n_state >= 1:
        assert (got["StateAOut"][0][total:] == 0).all()


def _mlp_step(knob_value, monkeypatch, optimizer):
    """One step of a small fc + mean model; returns the program's op types
    and its parameters afterwards."""
    if knob_value is None:
        monkeypatch.delenv("PADDLE_TPU_FUSED_OPTIMIZER", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", knob_value)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[8, 16], dtype="float32")
        h = fluid.layers.fc(x, 33, act="gelu")
        h = fluid.layers.fc(h, 17)
        loss = fluid.layers.mean(h)
        optimizer().minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(7).rand(8, 16).astype("float32")}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    params = {p.name: scope.find_var(p.name).get_tensor().numpy()
              for p in main.all_parameters()}
    return [op.type for op in main.global_block().ops], params


@pytest.mark.parametrize("layout", ["flat", "chain"])
@pytest.mark.parametrize("optimizer", [
    lambda: fluid.optimizer.SGD(0.1),
    lambda: fluid.optimizer.Momentum(0.1, 0.9, use_nesterov=True),
    lambda: fluid.optimizer.Adam(1e-3),
    lambda: fluid.optimizer.AdamW(1e-3)], ids=["sgd", "nesterov", "adam",
                                                "adamw"])
def test_program_rewrite_is_bitwise(monkeypatch, optimizer, layout):
    base_ops, base = _mlp_step(None, monkeypatch, optimizer)
    fused_ops, fused = _mlp_step(layout, monkeypatch, optimizer)
    assert fused_ops.count("fused_optimizer") == 1
    assert len(fused_ops) == len(base_ops) - 3  # four updates became one
    for name, want in base.items():
        np.testing.assert_array_equal(fused[name], want, err_msg=name)


def _momentum_program():
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[8, 16], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(fluid.layers.fc(x, 9), 4))
        fluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
    feed = {"x": np.random.RandomState(2).rand(8, 16).astype("float32")}
    return main, startup, loss, feed


def test_restart_resyncs_the_flat_state(monkeypatch):
    """Re-running the startup program re-initializes the retired
    per-param velocities; the next run rebuilds the flat state from them,
    so one step after the restart the velocity is that step's grad
    (mu * 0 + g), exactly as a fresh start's first step."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "flat")
    main, startup, loss, feed = _momentum_program()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    (flat,) = main._sharded_flat_layout
    trained = scope.find_var(flat).get_tensor().numpy().copy()
    exe.run(startup, scope=scope)  # restart
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    after = scope.find_var(flat).get_tensor().numpy()
    assert not np.array_equal(trained, after)

    fresh_main, fresh_startup, fresh_loss, _ = _momentum_program()
    fresh = fluid.Scope()
    exe.run(fresh_startup, scope=fresh)
    exe.run(fresh_main, feed=feed, fetch_list=[fresh_loss], scope=fresh)
    np.testing.assert_array_equal(
        after, fresh.find_var(flat).get_tensor().numpy())


def test_single_member_groups_stay_per_param(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "flat")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[8, 16], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(x, 4, bias_attr=False))
        fluid.optimizer.Adam(1e-3).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": np.ones((8, 16), "float32")},
            fetch_list=[loss], scope=scope)
    ops = [op.type for op in main.global_block().ops]
    assert "fused_optimizer" not in ops and ops.count("adam") == 1
