"""Deep gradient compression through the port against the JAX package.

- The ``dgc``, ``dgc_momentum`` and ``dgc_clip_by_norm`` ops against the
  JAX op functions of the same names on the same seeded numpy inputs:
  the rampup walk of the sparsity list (every step from before the rampup
  to past its end), Nesterov, a negative rampup step, a tie at the
  threshold (every entry of one magnitude: all of them selected), and
  one tensor of more than 2^24 elements (``torch.quantile`` refuses
  those; the port's threshold is a sort). ``dgc``'s selection must be the
  same entries and its outputs the same bits: the same float32 formula
  term for term, and the same two order statistics weighted alike. The
  ``dgc_momentum`` / ``dgc_clip_by_norm`` cases are the twins of
  ``tests/test_fluid_modules.py``'s, held to the JAX op within 1e-6 of
  the output's scale.
- ``DGCMomentumOptimizer`` builds the JAX package's program (op types,
  slots and attrs) and trains an MLP (the twin of
  ``tests/test_optimizer_extras.py::TestDGCMomentum``) from the JAX
  startup: on one device, and over 4 replicas against the JAX mesh of 4
  of the 8 virtual devices, under ``tests/test_torch_data_parallel.py``'s
  limits (losses within 1e-5 relative, state within rtol 1e-4 / atol
  1e-6). Each replica keeps its own u and v; the allreduce lands on the
  encoded grad, as in the JAX package. The port binds ``dgc``'s
  ``GradOut`` to the grad var (the JAX package binds it beside
  ``EncodeGrad``, which its own IR verifier refuses).
- The port's ``DGCMomentumOptimizer`` appends its ``sgd`` ops after every
  ``dgc`` op (the JAX package interleaves them a parameter, and its fused
  pass spares such a group), so that the fused optimizer pass folds them
  into one K4 sgd group under ``PADDLE_TPU_FUSED_OPTIMIZER``; that trains
  the same bits as the per-parameter ops, and the JAX package's.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core.registry import OpInfoMap as JaxOps
from paddle_tpu.parallel.mesh_utils import make_mesh as jax_mesh
import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.parallel.mesh_utils import make_mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_lr_schedule as LS  # noqa: E402

UPDATE_RTOL = 1e-6
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
SPARSITY = [0.75, 0.9375, 0.984375, 0.996, 0.999]


def run_both(op_type, ins, attrs):
    """The op's function in each package on the same numpy inputs."""
    j = JaxOps.instance().get(op_type).fn(
        {k: jnp.asarray(v) for k, v in ins.items()}, dict(attrs))
    p = OpInfoMap.instance().get(op_type).fn(
        {k: torch.from_numpy(np.array(v)) for k, v in ins.items()},
        dict(attrs))
    return ({k: np.asarray(v) for k, v in j.items() if v is not None},
            {k: v.numpy() for k, v in p.items() if v is not None})


def dgc_inputs(seed, shape):
    rng = np.random.RandomState(seed)
    return {"U": rng.randn(*shape).astype("float32") * 0.1,
            "V": rng.randn(*shape).astype("float32") * 0.1,
            "Grad": rng.randn(*shape).astype("float32")}


def assert_same_dgc(j, p):
    assert set(j) == set(p)
    np.testing.assert_array_equal(p["EncodeGrad"] != 0,
                                  j["EncodeGrad"] != 0)
    for k in j:
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)


@pytest.mark.parametrize("nesterov", [False, True])
def test_dgc_walks_the_sparsity_list_over_the_rampup(nesterov):
    """Steps 0 (before the rampup: everything selected) to 7 (past its
    end: the last sparsity held), rampup from step 1 over 4 steps."""
    attrs = {"m": 0.9, "use_nesterov": nesterov, "sparsity": SPARSITY,
             "rampup_begin_step": 1.0, "rampup_step": 4.0}
    kept = []
    for step in range(8):
        ins = dgc_inputs(100 + step, (64, 33))
        ins["CurrentStep"] = np.array([step], "float32")
        j, p = run_both("dgc", ins, attrs)
        assert_same_dgc(j, p)
        kept.append(int((p["EncodeGrad"] != 0).sum()))
    n = 64 * 33
    assert kept[0] == n  # before the rampup
    # the sparsity walks down the list: fewer kept each step, then held
    assert kept[1] > kept[2] > kept[3] > kept[4] >= kept[5] == kept[6]


def test_dgc_negative_rampup_compresses_from_the_start():
    """A negative rampup step: every step is past it (the dgc op has no
    disabled form; ``dgc_momentum`` and ``dgc_clip_by_norm`` do)."""
    attrs = {"m": 0.9, "sparsity": [0.75], "rampup_begin_step": -1.0,
             "rampup_step": 1.0}
    ins = dgc_inputs(7, (40, 25))
    ins["CurrentStep"] = np.array([0], "float32")
    j, p = run_both("dgc", ins, attrs)
    assert_same_dgc(j, p)
    assert (p["EncodeGrad"] != 0).sum() == 250  # a quarter of 1000


def test_dgc_selects_every_entry_tied_at_the_threshold():
    """|v| all equal: the quantile is that value, and ``>=`` keeps every
    entry; a few larger ones on top: those and the tied ones at the
    threshold decide the count alike in both packages."""
    attrs = {"m": 0.0, "sparsity": [0.5], "rampup_begin_step": 0.0,
             "rampup_step": 1.0}
    g = np.where(np.arange(1000) % 2, 0.25, -0.25).astype("float32")
    ins = {"U": np.zeros(1000, "float32"), "V": np.zeros(1000, "float32"),
           "Grad": g, "CurrentStep": np.array([3], "float32")}
    j, p = run_both("dgc", ins, attrs)
    assert_same_dgc(j, p)
    assert (p["EncodeGrad"] != 0).sum() == 1000
    g2 = g.copy()
    g2[:300] = 0.5
    g2[300:700] = 0.25
    g2[700:] = 0.125
    ins["Grad"] = g2
    j, p = run_both("dgc", ins, attrs)
    assert_same_dgc(j, p)
    # the median lies among the 0.25s: they and the 0.5s are kept
    assert (p["EncodeGrad"] != 0).sum() == 700


def test_dgc_takes_a_tensor_over_two_to_the_24():
    """2^24 + 4099 elements (more than ``torch.quantile`` takes): the
    threshold interpolates between two order statistics at a position
    that float32 rounds, as ``jnp.quantile`` does."""
    n = (1 << 24) + 4099
    rng = np.random.RandomState(24)
    ins = {"U": np.zeros(n, "float32"),
           "V": np.zeros(n, "float32"),
           "Grad": rng.randn(n).astype("float32"),
           "CurrentStep": np.array([5], "float32")}
    attrs = {"m": 0.9, "sparsity": [0.999], "rampup_begin_step": 0.0,
             "rampup_step": 1.0}
    j, p = run_both("dgc", ins, attrs)
    sel = p["EncodeGrad"] != 0
    np.testing.assert_array_equal(sel, j["EncodeGrad"] != 0)
    np.testing.assert_array_equal(p["EncodeGrad"], j["EncodeGrad"])
    assert abs(int(sel.sum()) - n // 1000) <= 1


@pytest.mark.parametrize("step,nesterov", [(0.0, False), (10.0, False),
                                           (0.0, True), (10.0, True)])
def test_dgc_momentum_switches_at_rampup(step, nesterov):
    p = np.array([1.0, 1.0, -0.5], "float32")
    ins = {"Param": p, "Grad": np.array([0.2, 0.4, -0.3], "float32"),
           "Velocity": np.array([0.1, 0.1, 0.2], "float32"),
           "LearningRate": np.array([0.5], "float32"),
           "current_step": np.array([step], "float32"),
           "nranks": np.array([2.0], "float32")}
    for rampup in (5.0, -1.0):
        j, q = run_both("dgc_momentum", ins,
                        {"mu": 0.9, "use_nesterov": nesterov,
                         "rampup_begin_step": rampup})
        assert set(j) == set(q)
        for k in j:
            np.testing.assert_allclose(
                q[k], j[k], rtol=0,
                atol=UPDATE_RTOL * max(np.abs(j[k]).max(), 1e-3),
                err_msg=k)


@pytest.mark.parametrize("step", [0.0, 10.0])
def test_dgc_clip_by_norm_gated(step):
    x = np.array([3.0, 4.0], "float32")
    for rampup in (5.0, -1.0):
        j, p = run_both("dgc_clip_by_norm",
                        {"X": x, "current_step": np.array([step],
                                                          "float32")},
                        {"max_norm": 1.0, "rampup_begin_step": rampup})
        np.testing.assert_allclose(p["Out"], j["Out"], rtol=UPDATE_RTOL)


def dgc_mlp(pkg, batch, sparsity=(0.75,), rampup_begin=0,
            learning_rate=0.05):
    """``TestDGCMomentum``'s regression net, widened by a hidden layer."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[batch, 8], dtype="float32")
        y = pkg.data(name="y", shape=[batch, 1], dtype="float32")
        h = pkg.layers.fc(x, 16, act="relu")
        pred = pkg.layers.fc(h, 1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.DGCMomentumOptimizer(
            learning_rate=learning_rate, momentum=0.9,
            rampup_begin_step=rampup_begin, rampup_step=4,
            sparsity=list(sparsity)).minimize(loss)
    return main, startup, loss


def dgc_feeds(steps, batch, seed=5):
    rng = np.random.RandomState(seed)
    W = rng.randn(8, 1).astype("float32")
    out = []
    for _ in range(steps):
        xb = rng.randn(batch, 8).astype("float32")
        out.append({"x": xb, "y": xb @ W})
    return out


def test_dgc_optimizer_builds_the_jax_program():
    jmain, _, _ = dgc_mlp(jfluid, 16)
    pmain, _, _ = dgc_mlp(fluid, 16)
    jops, pops = jmain.global_block().ops, pmain.global_block().ops
    # the same ops, the port's sgd ops after every dgc op (JAX interleaves
    # dgc, sgd a parameter)
    order = lambda o: (o.type == "sgd", o.input_arg_names)  # noqa: E731
    first = min(i for i, o in enumerate(jops) if o.type == "dgc")
    assert [o.type for o in pops[:first]] == [o.type for o in jops[:first]]
    jops = jops[:first] + sorted(jops[first:], key=order)
    pops = pops[:first] + sorted(pops[first:], key=order)
    assert [o.type for o in pops] == [o.type for o in jops]
    for jo, po in zip(jops, pops):
        if jo.type in ("dgc", "sgd", "increment"):
            assert po.inputs == jo.inputs
            # GradOut on the grad var, not beside EncodeGrad
            want = dict(jo.outputs)
            if jo.type == "dgc":
                want["GradOut"] = jo.input("Grad")
            assert po.outputs == want
            for k, v in jo.attrs.items():
                if not k.startswith("_"):
                    assert po.attrs.get(k) == v, (jo.type, k)
    assert "DGCMomentumOptimizer" in fluid.optimizer.__all__
    assert sorted(fluid.optimizer.__all__) == sorted(
        jfluid.optimizer.__all__)


def assert_state_close(jstate, pstate):
    for name, want in jstate.items():
        if want.dtype.kind == "f":
            np.testing.assert_allclose(pstate[name], want, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=name)


# the one-device run's rate: at 0.05 with momentum 0.9 this net's loss
# rises at some starts of the JAX startup's RNG (3 of seeds 0-23 end
# above their first loss; over 24 steps it diverges at every start); at
# 0.02 the mean of the last three losses falls below that of the first
# three at all 24 (``starts()``, this file's script mode)
DGC_RATE = 0.02


def test_dgc_trains_as_the_jax_package_on_one_device():
    """12 steps over the rampup (begin 1, 4 steps over SPARSITY) from a
    seeded JAX startup. Each step's batch is new, so single losses swing
    with the batch: the loss falls when the mean of the last three is
    below the mean of the first three."""
    feeds = dgc_feeds(12, 16)
    (jl, js), (pl, ps), _ = LS.train_both(
        lambda pkg: (lambda m, s, l: (m, s, [l]))(
            *dgc_mlp(pkg, 16, SPARSITY, 1, learning_rate=DGC_RATE)),
        feeds, jax_seed=3)
    for j, p in zip(jl, pl):
        np.testing.assert_allclose(p[0], j[0], rtol=LOSS_RTOL)
    assert_state_close(js, ps)
    losses = [float(np.mean(p[0])) for p in pl]
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_dgc_over_four_replicas_matches_the_jax_mesh(monkeypatch):
    """4 replicas, batch 32, against the JAX mesh of 4 devices: losses,
    parameters and replica 0's u and v. The JAX side runs unverified: its
    ``dgc`` binds ``GradOut`` and ``EncodeGrad`` to one var, which its IR
    verifier refuses after the allreduce pass; the port's program
    verifies clean."""
    feeds = dgc_feeds(6, 32, seed=9)
    jmain, jstart, jloss = dgc_mlp(jfluid, 32, SPARSITY, 1)
    pmain, _, ploss = dgc_mlp(fluid, 32, SPARSITY, 1)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe._core.rng.seed = 9
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        pscope = fluid.Scope()
        LS.carry(jmain, jscope, pmain, pscope)
        cp = jfluid.CompiledProgram(jmain).with_data_parallel(
            loss_name=jloss.name, places=jax_mesh([4], ["dp"]))
        monkeypatch.setenv("PADDLE_TPU_VERIFY_IR", "0")
        jl = [np.asarray(jexe.run(cp, feed=f, fetch_list=[jloss])[0])
              for f in feeds]
        monkeypatch.setenv("PADDLE_TPU_VERIFY_IR", "1")
    pexe = fluid.Executor(fluid.CPUPlace())
    cp = fluid.CompiledProgram(pmain).with_data_parallel(
        loss_name=ploss.name,
        places=make_mesh([4], ["dp"], [fluid.CPUPlace()] * 4))
    pl = [np.asarray(pexe.run(cp, feed=f, fetch_list=[ploss],
                              scope=pscope)[0]) for f in feeds]
    for j, p in zip(jl, pl):
        np.testing.assert_allclose(p, j, rtol=LOSS_RTOL)
    assert_state_close(LS.persistables(jmain, jscope),
                       LS.persistables(pmain, pscope))
    # a reduction of each encoded grad lies between its dgc and its sgd
    ops = pmain.global_block().ops
    for i, op in enumerate(ops):
        if op.type != "sgd":
            continue
        enc = op.input("Grad")[0]
        d = max(k for k in range(i) if ops[k].type == "dgc"
                and ops[k].output("EncodeGrad") == [enc])
        assert any(o.type.startswith("c_") and enc in o.input_arg_names
                   for o in ops[d + 1:i]), enc


def test_fused_optimizer_folds_the_dgc_sgd_ops(monkeypatch):
    """``PADDLE_TPU_FUSED_OPTIMIZER=flat``: the port's DGC sgd ops become
    one ``fused_optimizer`` sgd group (K4's plain version on the CPU; the
    JAX pass spares its interleaved ops), and the training is the
    per-parameter ops' bit for bit and the JAX package's. Unverified, as the JAX pass's contract refuses its own ``dgc``
    binding (see the test above)."""
    monkeypatch.setenv("PADDLE_TPU_VERIFY_IR", "0")
    feeds = dgc_feeds(6, 16, seed=3)
    runs = {}
    for knob in ("0", "flat"):
        monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", knob)
        (jl, js), (pl, ps), (jmain, pmain) = LS.train_both(
            lambda pkg: (lambda m, s, l: (m, s, [l]))(
                *dgc_mlp(pkg, 16, SPARSITY, 1)), feeds, jax_seed=7)
        runs[knob] = (pl, ps)
        groups = [o for o in pmain.global_block().ops
                  if o.type == "fused_optimizer"]
        # the JAX pass spares its interleaved dgc / sgd ops
        assert not [o for o in jmain.global_block().ops
                    if o.type == "fused_optimizer"]
        assert len(groups) == (knob == "flat")
        if groups:
            assert groups[0].attrs["op_type"] == "sgd"
            assert len(groups[0].input("Param")) == 4
        for j, p in zip(jl, pl):
            np.testing.assert_allclose(p[0], j[0], rtol=LOSS_RTOL)
        assert_state_close(js, ps)
    for a, b in zip(runs["0"][0], runs["flat"][0]):
        np.testing.assert_array_equal(a[0], b[0])
    for k, v in runs["0"][1].items():
        np.testing.assert_array_equal(runs["flat"][1][k], v, err_msg=k)


def starts(rates=(0.05, DGC_RATE), seeds=range(24), steps=12):
    """The one-device run's claim at each start of the JAX executor's RNG:
    (rate, seed, mean of the first three losses, of the last three, the
    first and the last loss), the port's, as the test trains it
    (``steps=24`` shows the divergence at 0.05)."""
    feeds = dgc_feeds(steps, 16)
    out = []
    for rate in rates:
        for seed in seeds:
            _, (pl, _), _ = LS.train_both(
                lambda pkg: (lambda m, s, l: (m, s, [l]))(
                    *dgc_mlp(pkg, 16, SPARSITY, 1, learning_rate=rate)),
                feeds, jax_seed=seed)
            losses = [float(np.mean(p[0])) for p in pl]
            out.append((rate, seed, float(np.mean(losses[:3])),
                        float(np.mean(losses[-3:])), losses[0], losses[-1]))
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_dgc.py
    for rate, seed, first, last, l0, l1 in starts():
        print("rate %g seed %2d: first three %.3f, last three %.3f (%s); "
              "first %.3f, last %.3f (%s)"
              % (rate, seed, first, last, "falls" if last < first
                 else "RISES", l0, l1, "falls" if l1 < l0 else "rises"))
