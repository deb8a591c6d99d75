"""Gradient clipping (``clip.py``) and weight decay (``regularizer.py``),
the port against the JAX package.

A two-layer MLP (6 -> 16 relu -> 1, the mean squared error) is built by
one script under both packages, with each clip class given as
``grad_clip=``, through ``set_gradient_clip``, each regularizer on the
optimizer and on a parameter, a clip and a regularizer together (the
update reads the clipped grad plus the decay: clip, then regularize, then
update), and BERT's recipe in small (AdamW, a global-norm clip and a
warm-up over a linear decay). Each program must be the JAX package's,
op for op (types, slots, var names, attrs), and three training steps
through both packages' Executors on the CPU, from the JAX startup's
persistables, must agree: the losses and every parameter and accumulator
afterwards within 1e-5 of their scale (the larger of their largest
magnitude and 1e-3; float32 sums in another order, a few ulps a step).

``ParamAttr(gradient_clip=...)`` is stored and never applied, in both
packages: its program is the unclipped one.
"""
import os
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_lr_schedule as LS  # noqa: E402

BATCH, IN, HIDDEN = 8, 6, 16
STEPS = 3
RTOL = 1e-5
FLOOR = 1e-3


def build_mlp(make_opt, w1_attr=None, before_minimize=None):
    """``build(pkg)`` of the MLP under ``make_opt(pkg)``'s optimizer;
    ``w1_attr(pkg)`` is the first layer's weight attr and
    ``before_minimize(pkg, main)`` runs before ``minimize``."""

    def build(pkg):
        L = pkg.layers
        main, startup = pkg.Program(), pkg.Program()
        startup.random_seed = 1
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data(name="x", shape=[BATCH, IN], dtype="float32")
            y = pkg.data(name="y", shape=[BATCH, 1], dtype="float32")
            h = L.fc(x, HIDDEN, act="relu",
                     param_attr=w1_attr(pkg) if w1_attr else None)
            pred = L.fc(h, 1)
            loss = L.mean(L.square(pred - y))
            if before_minimize is not None:
                before_minimize(pkg, main)
            opt = make_opt(pkg)
            opt.minimize(loss)
        return main, startup, [loss]

    return build


def feeds(n=STEPS, seed=3):
    rng = np.random.RandomState(seed)
    w = rng.randn(IN, 1).astype("float32")
    out = []
    for _ in range(n):
        x = rng.randn(BATCH, IN).astype("float32") * 3
        out.append({"x": x, "y": x @ w})
    return out


def _sgd(**kw):
    return lambda pkg: pkg.optimizer.SGD(
        0.5, **{k: f(pkg) for k, f in kw.items()})


def _momentum(**kw):
    return lambda pkg: pkg.optimizer.Momentum(
        0.1, 0.9, **{k: f(pkg) for k, f in kw.items()})


def _set_clip(which, params=None):
    def before(pkg, main):
        clip = {"value": lambda: pkg.clip.GradientClipByValue(0.05),
                "norm": lambda: pkg.clip.GradientClipByNorm(0.1),
                "global": lambda: pkg.clip.GradientClipByGlobalNorm(0.5)}
        plist = None
        if params is not None:
            plist = [p.name for p in main.all_parameters()][:params]
        pkg.clip.set_gradient_clip(clip[which](), param_list=plist,
                                   program=main)

    return before


def _bert_recipe(pkg):
    L = pkg.layers
    lr = L.linear_lr_warmup(
        L.polynomial_decay(0.05, decay_steps=3, end_learning_rate=0.0,
                           power=1.0),
        warmup_steps=2, start_lr=0.0, end_lr=0.05)
    return pkg.optimizer.AdamW(
        lr, weight_decay=0.01,
        grad_clip=pkg.clip.GradientClipByGlobalNorm(1.0))


CASES = {
    "grad_clip_by_value": (_sgd(grad_clip=lambda p: p.clip.GradientClipByValue(
        0.05, -0.02)), None, None),
    "grad_clip_by_norm": (_sgd(grad_clip=lambda p: p.clip.GradientClipByNorm(
        0.1)), None, None),
    "grad_clip_by_global_norm": (_sgd(
        grad_clip=lambda p: p.clip.GradientClipByGlobalNorm(0.5)), None,
        None),
    "set_gradient_clip_by_value": (lambda pkg: pkg.optimizer.SGD(0.5), None,
                                   _set_clip("value")),
    "set_gradient_clip_by_norm": (lambda pkg: pkg.optimizer.SGD(0.5), None,
                                  _set_clip("norm")),
    "set_gradient_clip_global_on_two": (lambda pkg: pkg.optimizer.SGD(0.5),
                                        None, _set_clip("global", 2)),
    "l1_decay": (_momentum(regularization=lambda p: p.regularizer.L1Decay(
        0.01)), None, None),
    "l2_decay": (_momentum(regularization=lambda p: p.regularizer.L2Decay(
        0.01)), None, None),
    "param_l2_over_optimizer_l1": (
        _momentum(regularization=lambda p: p.regularizer.L1DecayRegularizer(
            0.01)),
        lambda p: p.ParamAttr(regularizer=p.regularizer.L2DecayRegularizer(
            0.1)), None),
    "global_clip_then_l2": (
        lambda pkg: pkg.optimizer.Adam(
            0.01, regularization=pkg.regularizer.L2Decay(0.05),
            grad_clip=pkg.clip.GradientClipByGlobalNorm(0.3)), None, None),
    "bert_recipe": (_bert_recipe, None, None),
}


def _scale(a):
    return max(float(np.abs(a).max(initial=0.0)), FLOOR)


@pytest.mark.parametrize("case", sorted(CASES))
def test_program_is_the_jax_packages(case):
    make_opt, w1_attr, before = CASES[case]
    build = build_mlp(make_opt, w1_attr, before)
    jmain, jstartup, _ = build(jfluid)
    pmain, pstartup, _ = build(fluid)
    assert LS.op_seq(pmain) == LS.op_seq(jmain)
    assert LS.op_seq(pstartup) == LS.op_seq(jstartup)


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_the_jax_package(case):
    make_opt, w1_attr, before = CASES[case]
    (j, jstate), (p, pstate), (jmain, _) = LS.train_both(
        build_mlp(make_opt, w1_attr, before), feeds(), jax_seed=41)
    for js, ps in zip(j, p):
        np.testing.assert_allclose(ps[0], js[0], rtol=RTOL, atol=0)
    assert sorted(pstate) == sorted(jstate)
    for n, want in jstate.items():
        got = pstate[n]
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=RTOL * _scale(want), err_msg=n)
        else:
            assert got.astype(np.int64).tolist() == \
                want.astype(np.int64).tolist(), n
    # the clip changed the update: the parameters differ from plain SGD's
    if case.startswith(("grad_clip", "set_gradient_clip")):
        (_, plain), _, _ = LS.train_both(
            build_mlp(lambda pkg: pkg.optimizer.SGD(0.5)), feeds(),
            jax_seed=41)
        assert any(not np.allclose(plain[n], jstate[n]) for n in plain)


def test_clip_then_regularize_then_update_order():
    """The update of each parameter reads sum(clipped grad, decay)."""
    make_opt, _, _ = CASES["global_clip_then_l2"]
    main, _, _ = build_mlp(make_opt)(fluid)
    ops = main.global_block().ops
    types = [op.type for op in ops]
    first_clip = types.index("squared_l2_norm")
    last_mul = max(i for i, t in enumerate(types) if t == "elementwise_mul"
                   and i > first_clip)
    first_decay = types.index("scale", first_clip)
    first_update = types.index("adam")
    assert first_clip < last_mul < first_decay < first_update
    for op in ops:
        if op.type == "adam":
            grad = op.input("Grad")[0]
            writer = [o for o in ops if grad in o.output_arg_names]
            assert writer[0].type == "sum"


def test_param_attr_gradient_clip_is_stored_and_not_applied():
    def attr(pkg):
        return pkg.ParamAttr(gradient_clip=pkg.clip.GradientClipByValue(1e-3))

    plain = build_mlp(lambda pkg: pkg.optimizer.SGD(0.5))
    stored = build_mlp(lambda pkg: pkg.optimizer.SGD(0.5), w1_attr=attr)
    for pkg in (jfluid, fluid):
        assert LS.op_seq(stored(pkg)[0]) == LS.op_seq(plain(pkg)[0])
    assert attr(fluid).gradient_clip.max == 1e-3
    err = fluid.clip.ErrorClipByValue(2.0)
    assert (err.min, err.max) == (-2.0, 2.0)
