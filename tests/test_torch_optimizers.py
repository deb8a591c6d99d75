"""The training recipe's ops and optimizers, the port against the JAX
package, on the CPU from the same seeded numpy inputs.

- Every op type this slice adds, against the JAX op function of the same
  name (both registries): the unary math (``exp``, ``log``, ``sqrt``,
  ``abs``, ``square``, ``ceil``, ``floor``, ``cos``, ``pow``, ``sign``),
  ``clip``, ``clip_by_norm``, ``squared_l2_norm``, ``increment`` and
  ``where``, forward and grad, within 1e-5 of the output's scale
  (``test_torch_transformer_ops.py``'s limit: the same math, summed in
  another order); the ten update ops (``lars_momentum``, ``adamax``,
  ``adagrad``, ``decayed_adagrad``, ``adadelta``, ``rmsprop``, ``ftrl``,
  ``lamb``, ``dpsgd``, with their attr variants) within 1e-6 of each
  output's scale (the larger of its largest magnitude and 1e-3): the same
  formula term for term, and ``lamb``'s and ``lars_momentum``'s norms
  summed in another order. ``dpsgd`` draws no noise in the JAX package, so
  it is held to the JAX op like the others.
- Each of the nine optimizer classes (and RMSProp centered, Ftrl at
  another ``lr_power``) builds the JAX package's program and trains three
  steps of ``test_torch_clip_regularizer.py``'s MLP through both packages'
  Executors: losses and every parameter and accumulator within 1e-5 of
  their scale, as there.
- A per-parameter learning rate (``ParamAttr(learning_rate=...)``) emits
  the JAX package's ``scale`` op and trains alike; the fused-optimizer
  pass (K4's grouping) makes the same groups in both packages, and the
  flat layout trains as the per-parameter ops do (plain K4 on the CPU).
- The dygraph ``minimize`` of ``LambOptimizer`` and ``AdagradOptimizer``
  against the JAX dygraph step, three steps of the narrow dygraph_mlp,
  eager and lazy, under ``test_torch_dygraph.py``'s limits; any other
  optimizer raises, as in the JAX package.
"""
import os
import sys
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.core import fusion as jfusion
from paddle_tpu.core.registry import OpInfoMap as JaxOps
from paddle_tpu_torch.core import fusion
from paddle_tpu_torch.core.registry import OpInfoMap

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_clip_regularizer as CR  # noqa: E402
import test_torch_dygraph as DY  # noqa: E402
import test_torch_lr_schedule as LS  # noqa: E402
import test_torch_transformer_ops as TO  # noqa: E402

UPDATE_RTOL = 1e-6
FLOOR = 1e-3
TRAIN_RTOL = 1e-5


def _rng(*key):
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def _f(rng, *shape):
    return rng.randn(*shape).astype("float32")


# -- the math ops: forward and grad --------------------------------------------

def _math_cases():
    rng = _rng("math")
    x = _f(rng, 3, 4, 5)
    pos = np.abs(x) + 0.5
    with_zero = x.copy()
    with_zero[0, 0, :2] = 0.0
    cases = {n: (n, {"X": x}, {}) for n in (
        "exp", "square", "ceil", "floor", "cos", "sign")}
    cases.update({
        "log": ("log", {"X": pos}, {}),
        "sqrt": ("sqrt", {"X": pos}, {}),
        "abs_with_zeros": ("abs", {"X": with_zero}, {}),
        "pow_2": ("pow", {"X": x}, {"factor": 2.0}),
        "pow_-0.5": ("pow", {"X": pos}, {"factor": -0.5}),
        "clip": ("clip", {"X": x}, {"min": -0.3, "max": 0.7}),
        "clip_by_norm_clips": ("clip_by_norm", {"X": x}, {"max_norm": 1.0}),
        "clip_by_norm_passes": ("clip_by_norm", {"X": x * 0.01},
                                {"max_norm": 10.0}),
        "squared_l2_norm": ("squared_l2_norm", {"X": x}, {}),
        "increment_float": ("increment", {"X": x[0, 0, :1]}, {"step": 2.5}),
        "where": ("where", {"Condition": _f(rng, 3, 4, 5) > 0, "X": x,
                            "Y": _f(rng, 3, 4, 5)}, {}),
    })
    return cases


MATH = _math_cases()


def test_the_recipe_ops_are_registered_with_the_jax_grad_kinds():
    ours = set(OpInfoMap.instance().all_op_types())
    theirs = set(JaxOps.instance().all_op_types())
    new = {"clip", "clip_by_norm", "squared_l2_norm", "increment", "where",
           "truncated_gaussian_random", "sqrt", "sign", "pow", "cos",
           "floor", "ceil", "exp", "log", "abs", "square", "lamb",
           "lars_momentum", "adagrad", "decayed_adagrad", "adadelta",
           "adamax", "rmsprop", "ftrl", "dpsgd"}
    assert new <= ours and new <= theirs
    for t in new:
        assert ((t + "_grad") in ours) == ((t + "_grad") in theirs), t
        p, j = OpInfoMap.instance().get(t), JaxOps.instance().get(t)
        assert [s.name for s in p.inputs] == [s.name for s in j.inputs], t
        assert [s.name for s in p.outputs] == [s.name for s in j.outputs], t
        assert p.attrs == j.attrs, t
        assert p.needs_rng == j.needs_rng, t


@pytest.mark.parametrize("case", sorted(MATH))
def test_math_op_matches_the_jax_op(case):
    op_type, ins, attrs = MATH[case]
    TO._check(op_type, ins, attrs, seed=zlib.crc32(case.encode()))


def test_increment_of_an_int64_counter():
    j, p = TO._run("increment", {"X": np.array([4], np.int64)},
                   {"step": 1.0})
    assert p["Out"].dtype == np.int64 and p["Out"].tolist() == [5]
    assert j["Out"].tolist() == [5]


# -- the update ops -----------------------------------------------------------

def _update_cases():
    rng = _rng("update")
    shape = (7, 5)
    p, g = _f(rng, *shape), _f(rng, *shape)
    sq = lambda: np.abs(_f(rng, *shape)) * 0.1  # noqa: E731  (>= 0)
    lr = np.array([0.05], np.float32)
    pows = {"Beta1Pow": np.array([0.9 ** 3], np.float32),
            "Beta2Pow": np.array([0.999 ** 3], np.float32)}
    adam_like = {"Param": p, "Grad": g, "LearningRate": lr,
                 "Moment1": _f(rng, *shape) * 0.1, "Moment2": sq(), **pows}
    rms = {"Param": p, "Grad": g, "LearningRate": lr, "Moment": sq(),
           "MeanSquare": sq() + 0.5, "MeanGrad": _f(rng, *shape) * 0.1}
    ftrl = {"Param": p, "Grad": g, "LearningRate": lr,
            "SquaredAccumulator": sq() + 0.1,
            "LinearAccumulator": _f(rng, *shape)}
    return {
        "lars_momentum": ("lars_momentum", {"Param": p, "Grad": g,
                                            "Velocity": _f(rng, *shape),
                                            "LearningRate": lr}, {}),
        "lars_momentum_eps": ("lars_momentum", {
            "Param": p, "Grad": g, "Velocity": _f(rng, *shape),
            "LearningRate": lr}, {"mu": 0.8, "lars_coeff": 0.01,
                                  "lars_weight_decay": 0.001,
                                  "epsilon": 1e-3}),
        "lars_momentum_zero_param": ("lars_momentum", {
            "Param": np.zeros(shape, np.float32), "Grad": g,
            "Velocity": _f(rng, *shape), "LearningRate": lr}, {}),
        "adamax": ("adamax", {"Param": p, "Grad": g, "LearningRate": lr,
                              "Moment": _f(rng, *shape), "InfNorm": sq(),
                              "Beta1Pow": pows["Beta1Pow"]}, {}),
        "adagrad": ("adagrad", {"Param": p, "Grad": g, "Moment": sq(),
                                "LearningRate": lr}, {"epsilon": 1e-5}),
        "decayed_adagrad": ("decayed_adagrad", {
            "Param": p, "Grad": g, "Moment": sq(), "LearningRate": lr},
            {"decay": 0.9}),
        "adadelta": ("adadelta", {"Param": p, "Grad": g,
                                  "AvgSquaredGrad": sq(),
                                  "AvgSquaredUpdate": sq()}, {"rho": 0.9}),
        "rmsprop": ("rmsprop", rms, {"momentum": 0.9}),
        "rmsprop_centered": ("rmsprop", rms, {"centered": True,
                                              "momentum": 0.5}),
        "ftrl": ("ftrl", ftrl, {"l1": 0.1, "l2": 0.2}),
        "ftrl_lr_power": ("ftrl", ftrl, {"l1": 0.1, "l2": 0.2,
                                         "lr_power": -0.25}),
        "lamb": ("lamb", adam_like, {"weight_decay": 0.01}),
        "lamb_no_decay": ("lamb", adam_like, {"weight_decay": 0.0,
                                              "epsilon": 1e-8}),
        "dpsgd_clips": ("dpsgd", {"Param": p, "Grad": g, "LearningRate": lr},
                        {"clip": 1.0}),
        "dpsgd_passes": ("dpsgd", {"Param": p, "Grad": g,
                                   "LearningRate": lr}, {"clip": 100.0}),
    }


UPDATES = _update_cases()


@pytest.mark.parametrize("case", sorted(UPDATES))
def test_update_op_matches_the_jax_op(case):
    op_type, ins, attrs = UPDATES[case]
    j, p = TO._run(op_type, ins, attrs)
    assert sorted(p) == sorted(j)
    for slot, want in j.items():
        got = p[slot]
        assert got.shape == want.shape and got.dtype == want.dtype, slot
        scale = max(float(np.abs(want).max()), FLOOR)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=UPDATE_RTOL * scale, err_msg=slot)
    # the update moved the parameter
    out = "ParamOut"
    assert not np.array_equal(p[out], ins["Param"])


# -- the optimizer classes ----------------------------------------------------

CLASSES = {
    "LarsMomentum": lambda O: O.LarsMomentumOptimizer(0.5, 0.9),
    "Adagrad": lambda O: O.Adagrad(0.1, initial_accumulator_value=0.1),
    "Adamax": lambda O: O.Adamax(0.05),
    "Dpsgd": lambda O: O.DpsgdOptimizer(0.1, clip=1.0),
    "DecayedAdagrad": lambda O: O.DecayedAdagradOptimizer(0.1),
    "Adadelta": lambda O: O.Adadelta(0.1, rho=0.9),
    "RMSProp": lambda O: O.RMSProp(0.01, momentum=0.5),
    "RMSProp_centered": lambda O: O.RMSPropOptimizer(0.01, centered=True),
    "Ftrl": lambda O: O.Ftrl(0.1, l1=0.01, l2=0.01),
    "Ftrl_lr_power": lambda O: O.FtrlOptimizer(0.1, l1=0.01,
                                               lr_power=-0.25),
    "Lamb": lambda O: O.LambOptimizer(0.05, lamb_weight_decay=0.01),
}


def _build_class(name):
    return CR.build_mlp(lambda pkg: CLASSES[name](pkg.optimizer))


def _check_state(pstate, jstate, rtol=TRAIN_RTOL):
    assert sorted(pstate) == sorted(jstate)
    for n, want in jstate.items():
        got = pstate[n]
        if np.issubdtype(want.dtype, np.floating):
            scale = max(float(np.abs(want).max(initial=0.0)), FLOOR)
            np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                                       err_msg=n)
        else:
            assert got.astype(np.int64).tolist() == \
                want.astype(np.int64).tolist(), n


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_optimizer_class_builds_the_jax_program(name):
    jmain, jstartup, _ = _build_class(name)(jfluid)
    pmain, pstartup, _ = _build_class(name)(fluid)
    assert LS.op_seq(pmain) == LS.op_seq(jmain)
    assert LS.op_seq(pstartup) == LS.op_seq(jstartup)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_optimizer_class_trains_as_the_jax_package(name):
    (j, jstate), (p, pstate), _ = LS.train_both(_build_class(name),
                                                CR.feeds(), jax_seed=13)
    losses = [float(s[0].reshape(-1)[0]) for s in p]
    np.testing.assert_allclose(
        losses, [float(s[0].reshape(-1)[0]) for s in j], rtol=TRAIN_RTOL)
    assert np.isfinite(losses).all()
    _check_state(pstate, jstate)


def test_the_aliases_are_the_jax_packages():
    O = fluid.optimizer
    for alias, cls in (("Adagrad", "AdagradOptimizer"),
                       ("Adamax", "AdamaxOptimizer"),
                       ("Adadelta", "AdadeltaOptimizer"),
                       ("RMSProp", "RMSPropOptimizer"),
                       ("Ftrl", "FtrlOptimizer"), ("SGD", "SGDOptimizer"),
                       ("Momentum", "MomentumOptimizer"),
                       ("Adam", "AdamOptimizer")):
        assert getattr(O, alias) is getattr(O, cls)
        assert hasattr(jfluid.optimizer, alias)
    lamb = O.LambOptimizer(0.1, exclude_from_weight_decay_fn=len)
    assert lamb._exclude_fn is len and lamb._extra_attrs() == {
        "weight_decay": 0.01}


# -- per-parameter learning rates ---------------------------------------------

def _param_lr_build(opt="momentum"):
    make = {"momentum": lambda pkg: pkg.optimizer.Momentum(0.1, 0.9),
            "adam": lambda pkg: pkg.optimizer.Adam(0.01)}[opt]
    return CR.build_mlp(make, w1_attr=lambda pkg: pkg.ParamAttr(
        learning_rate=2.0))


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_a_per_parameter_rate_is_the_jax_packages(opt):
    jmain, _, _ = _param_lr_build(opt)(jfluid)
    pmain, _, _ = _param_lr_build(opt)(fluid)
    assert LS.op_seq(pmain) == LS.op_seq(jmain)
    scales = [op for op in pmain.global_block().ops if op.type == "scale"
              and op.attrs.get("scale") == 2.0]
    assert len(scales) == 1
    lrs = {op.input("LearningRate")[0] for op in pmain.global_block().ops
           if op.type in ("momentum", "adam")}
    assert len(lrs) == 2 and scales[0].output("Out")[0] in lrs
    (j, jstate), (p, pstate), _ = LS.train_both(_param_lr_build(opt),
                                                CR.feeds(), jax_seed=17)
    np.testing.assert_allclose([float(s[0].reshape(-1)[0]) for s in p],
                               [float(s[0].reshape(-1)[0]) for s in j],
                               rtol=TRAIN_RTOL)
    _check_state(pstate, jstate)


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_per_parameter_rates_make_the_jax_passes_groups(opt):
    """The fused pass groups by rate var: one group of the three params at
    the global rate, the one at twice it stays a per-parameter op, in
    both packages."""
    jmain, _, _ = _param_lr_build(opt)(jfluid)
    pmain, _, _ = _param_lr_build(opt)(fluid)
    nj = jfusion.apply_fused_optimizer(jmain, jfluid.Scope(), layout="chain")
    np_ = fusion.apply_fused_optimizer(pmain, fluid.Scope(),
                                       torch.device("cpu"), layout="chain")
    assert np_ == nj == 1
    assert [op.type for op in pmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    fused = [op for op in pmain.global_block().ops
             if op.type == "fused_optimizer"]
    assert len(fused[0].input("Param")) == 3


def test_per_parameter_rates_train_alike_in_the_flat_layout(monkeypatch):
    """The flat layout (K4's plain version on the CPU) trains as the JAX
    package's per-parameter ops."""
    (j, jstate), _, _ = LS.train_both(_param_lr_build("adam"), CR.feeds(),
                                      jax_seed=19)
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "flat")
    (_, _), (p, pstate), (_, pmain) = LS.train_both(_param_lr_build("adam"),
                                                    CR.feeds(), jax_seed=19)
    assert [op.type for op in pmain.global_block().ops].count(
        "fused_optimizer") == 1
    np.testing.assert_allclose([float(s[0].reshape(-1)[0]) for s in p],
                               [float(s[0].reshape(-1)[0]) for s in j],
                               rtol=TRAIN_RTOL)
    for n, want in jstate.items():
        if n in pstate and not n.endswith(("moment1_0", "moment2_0")):
            scale = max(float(np.abs(want).max()), FLOOR)
            np.testing.assert_allclose(pstate[n], want, rtol=0,
                                       atol=TRAIN_RTOL * scale, err_msg=n)


# -- dygraph ------------------------------------------------------------------

DYGRAPH = {"lamb": lambda O, ps: O.LambOptimizer(1e-3, parameter_list=ps),
           "adagrad": lambda O, ps: O.AdagradOptimizer(
               0.01, initial_accumulator_value=0.1, parameter_list=ps)}


def _dy_train(pkg, name, lazy=False):
    with DY.guard(pkg, lazy):
        params, step = DY.mlp_script(pkg, **DY.MLP)
        DY._set_weights(params, 1)
        opt = DYGRAPH[name](pkg.optimizer, params)
        seen = DY._record_grads(opt, params)
        losses = [float(DY._np(step(opt)).reshape(-1)[0])
                  for _ in range(DY.STEPS)]
        state = {k: DY._np(v) for k, v in opt._dygraph_state.items()}
        return losses, [DY._np(p) for p in params], DY._ordered_state(
            opt, params, state), seen


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
@pytest.mark.parametrize("name", sorted(DYGRAPH))
def test_dygraph_update_matches_the_jax_step(name, lazy):
    got = _dy_train(fluid, name, lazy)
    want = _dy_train(jfluid, name)
    # LAMB, as Adam, moves an element whose grad is rounding noise by a
    # sign-like step: test_torch_dygraph.py leaves those out; Adagrad's
    # step is smooth in the grad (its accumulator starts at 0.1), so every
    # element is held, as for SGD
    DY.check_training(got, want, "sgd" if name == "adagrad" else name)
    assert all(np.isfinite(got[0])) and got[0][-1] < got[0][0]


def test_dygraph_minimize_raises_for_the_others_as_the_jax_package():
    for pkg in (fluid, jfluid):
        with DY.guard(pkg):
            lin = pkg.dygraph.Linear(3, 2)
            loss = pkg.layers.mean(lin(pkg.dygraph.to_variable(
                np.ones((2, 3), "float32"))))
            loss.backward()
            with pytest.raises(NotImplementedError, match="later wave"):
                pkg.optimizer.RMSPropOptimizer(
                    0.1, parameter_list=lin.parameters()).minimize(loss)
