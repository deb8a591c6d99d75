"""ResNet training end to end, the port against the JAX package.

bench.py's ResNet script (``_build_resnet50``: images, int64 labels, the
ResNet, mean cross entropy of its softmax, ``MomentumOptimizer``) is built
by this file's ``build`` under both packages, and the port's
``models.resnet.build_resnet_train`` builds the same program:

(a) ResNet-50 NHWC at bench.py's batch 128: the same 534 ops, slots and
    var names, and 44 of its 53 convs routed to K5 under
    ``FLAGS_use_pallas_conv=all``;
(b) three Momentum steps (lr 1e-3) of ResNet-50 NHWC at 64², batch 4,
    class_dim 10, with every conv the flag routes running K5's plain
    version, and of ResNet-18 NCHW (nothing routed), with
    ``PADDLE_TPU_FUSED_OPTIMIZER`` unset and ``flat``. The JAX startup
    runs and the JAX package trains three steps; the port runs each step
    from the JAX package's state before that step, carried over with
    ``io.scope_from_numpy``.

What is compared, and why so. Each step's loss within 1e-4 relative, and
the batch-norm running means and variances after it within 1e-4 of their
scale: forward quantities, float32 sums in another order. The step-1
``@GRAD`` fetches, each step's parameter updates and velocities within
0.04 relative L2 per tensor: these networks at this size are not well
conditioned, so no two float32 implementations agree more closely. A
rounding difference of 1e-6 flips a few ReLU or max-pool decisions, each
flip changes one element's grad by its full size, and batch norm over a
batch of 4 spreads that into every grad. In float64, a relative
perturbation of 1e-7 of ResNet-50's weights moves its grads by about 1%
relative L2. Between the packages the largest reading over every tensor
and both layouts is 0.0154 for ResNet-50 and 0.0095 for ResNet-18, so the
limit is 2.6 times the largest. A wrong backward scores above it
(``test_a_planted_grad_fault_exceeds_the_limit``): every filter grad 5%
too large scores 0.050, each 3x3 filter grad transposed 1.30. Running
this file as a script prints these readings. Each op's grad is held to
1e-5 in ``test_torch_resnet_ops.py``.
"""
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as fluid
from paddle_tpu_torch.models.resnet import build_resnet_train, random_batch

BATCH, CLASSES, LR, STEPS = 4, 10, 1e-3, 3
LOSS_RTOL = 1e-4
STAT_RTOL = 1e-4
GRAD_RELL2 = 0.04
KNOB = "PADDLE_TPU_FUSED_OPTIMIZER"
CONFIGS = {"resnet50_nhwc": dict(depth=50, data_format="NHWC",
                                 image_size=64),
           "resnet18_nchw": dict(depth=18, data_format="NCHW",
                                 image_size=64)}


def build(pkg, cfg, batch=BATCH, classes=CLASSES, use_bf16=False):
    """bench.py's ResNet script (``_build_resnet50``) under ``pkg``;
    ``use_bf16`` wraps the optimizer in ``mp.decorate``."""
    size, fmt = cfg["image_size"], cfg["data_format"]
    img_shape = ([batch, 3, size, size] if fmt == "NCHW"
                 else [batch, size, size, 3])
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.data(name="img", shape=img_shape, dtype="float32")
        label = pkg.data(name="label", shape=[batch, 1], dtype="int64")
        pred = pkg.models.resnet(img, classes, cfg["depth"],
                                 data_format=fmt)
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        opt = pkg.optimizer.MomentumOptimizer(learning_rate=LR, momentum=0.9)
        if use_bf16:
            opt = pkg.contrib.mixed_precision.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def test_build_resnet_train_is_the_bench_script():
    cfg = CONFIGS["resnet50_nhwc"]
    want = build(fluid, cfg)
    got = build_resnet_train(BATCH, cfg["image_size"], CLASSES, 50, "NHWC",
                             learning_rate=LR, seed=1)

    def seq(p):
        return [(op.type, op.inputs, op.outputs, op.attrs)
                for op in p.global_block().ops]

    for w, g in zip(want[:2], got[:2]):
        assert seq(g) == seq(w) and g.random_seed == w.random_seed
    assert got[2].name == want[2].name


def persistables(main, scope):
    out = {}
    for v in main.global_block().vars.values():
        var = scope.find_var(v.name) if v.persistable else None
        if var is not None and var.is_initialized():
            out[v.name] = np.array(var.get_tensor(), dtype=np.float32)
    return out


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture
def knob():
    old = os.environ.pop(KNOB, None)

    def set_(value):
        os.environ.pop(KNOB, None)
        if value is not None:
            os.environ[KNOB] = value

    yield set_
    os.environ.pop(KNOB, None)
    if old is not None:
        os.environ[KNOB] = old


@pytest.fixture
def route_all():
    old = fluid.get_flags("FLAGS_use_pallas_conv")
    fluid.set_flags({"FLAGS_use_pallas_conv": "all"})
    yield
    fluid.set_flags(old)


_JAX_RUNS = {}


def _jax_run(name):
    """The JAX package's startup and three steps (its fused optimizer
    off), computed once per config: the state before each step, each
    step's loss, the step-1 grads and the state after each step."""
    if name in _JAX_RUNS:
        return _JAX_RUNS[name]
    cfg = CONFIGS[name]
    old = os.environ.pop(KNOB, None)
    try:
        main, startup, loss = build(jfluid, cfg)
        grad_names = [p.name + "@GRAD" for p in main.all_parameters()
                      if p.trainable]
        rng = np.random.RandomState(0)
        feeds = [random_batch(rng, BATCH, cfg["image_size"], CLASSES,
                              cfg["data_format"]) for _ in range(STEPS)]
        exe = jfluid.Executor(jfluid.CPUPlace())
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe.run(startup)
            states, losses, grads = [persistables(main, scope)], [], None
            for i, feed in enumerate(feeds):
                res = exe.run(main, feed=feed, fetch_list=[loss] + (
                    grad_names if i == 0 else []))
                losses.append(float(np.asarray(res[0]).reshape(-1)[0]))
                if i == 0:
                    grads = [np.asarray(r) for r in res[1:]]
                states.append(persistables(main, scope))
    finally:
        if old is not None:
            os.environ[KNOB] = old
    _JAX_RUNS[name] = (feeds, grad_names, states, losses, grads)
    return _JAX_RUNS[name]


def _unflatten(program, state):
    """Per-parameter velocities out of the flat fused-optimizer state."""
    out = {}
    layout = getattr(program, "_sharded_flat_layout", None) or {}
    block = program.global_block()
    for flat_name, (names, total, _, _, _) in layout.items():
        flat, off = state[flat_name], 0
        for n in names:
            shape = block.var(n).shape
            size = int(np.prod(shape))
            out[n] = flat[off:off + size].reshape(shape)
            off += size
        assert off == total
    return out


def test_minimize_emits_the_jax_resnet50_program(route_all):
    cfg = dict(depth=50, data_format="NHWC", image_size=224)
    jmain, jstartup, _ = build(jfluid, cfg, batch=128, classes=1000)
    pmain, pstartup, _ = build(fluid, cfg, batch=128, classes=1000)

    def seq(p):
        return [(op.type, op.inputs, op.outputs, op.attrs)
                for op in p.global_block().ops]

    assert seq(pmain) == seq(jmain) and seq(pstartup) == seq(jstartup)
    types = [op.type for op in pmain.global_block().ops]
    assert len(types) == 534
    assert types.count("conv2d") == types.count("conv2d_grad") == 53
    assert types.count("momentum") == 161
    for name, v in jmain.global_block().vars.items():
        assert pmain.global_block().vars[name].shape == v.shape, name


@pytest.mark.parametrize("layout", [None, "flat"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_three_momentum_steps_match_the_jax_package(knob, route_all,
                                                    monkeypatch, name, layout):
    from paddle_tpu_torch.ops.cuda import conv as k5

    feeds, grad_names, jstates, jlosses, jgrads = _jax_run(name)
    knob(layout)
    main, _, loss = build(fluid, CONFIGS[name])
    stats = {v.name for v in main.all_parameters() if not v.trainable}
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    calls = []
    plain = k5.conv2d_bn_act_reference
    monkeypatch.setattr(k5, "conv2d_bn_act_reference",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    for i, feed in enumerate(feeds):
        fluid.io.scope_from_numpy(scope, jstates[i], fluid.CPUPlace())
        res = exe.run(main, feed=feed, scope=scope,
                      fetch_list=[loss] + (grad_names if i == 0 else []))
        got = float(np.asarray(res[0]).reshape(-1)[0])
        assert abs(got - jlosses[i]) <= LOSS_RTOL * abs(jlosses[i]), (
            i, got, jlosses[i])
        if i == 0:
            for gname, g, want in zip(grad_names, res[1:], jgrads):
                assert g.shape == want.shape, gname
                assert rel_l2(g, want) <= GRAD_RELL2, gname
        _compare_state(main, stats, persistables(main, scope), jstates[i],
                       jstates[i + 1], layout)
    routed = 44 if name == "resnet50_nhwc" else 0
    assert len(calls) == routed * STEPS
    ops = [op.type for op in main.global_block().ops]
    if layout == "flat":
        assert ops.count("fused_optimizer") == 1 and "momentum" not in ops
    else:
        assert "fused_optimizer" not in ops


FAULTS = {"filter_grad_x1.05": lambda dw: dw * 1.05,
          "filter_grad_transposed": lambda dw: dw.transpose(2, 3)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_grad_fault_exceeds_the_limit(knob, route_all, monkeypatch,
                                                fault):
    """GRAD_RELL2 against what a wrong backward scores: every conv's
    filter grad 5% too large, or each 3x3 filter grad transposed."""
    knob(None)
    worst = _planted_fault_score(monkeypatch, fault)
    assert worst > GRAD_RELL2, worst


def _planted_fault_score(monkeypatch, fault):
    """The largest step-1 grad rel-L2 of ResNet-50 NHWC against the JAX
    package with ``fault`` applied to every conv's filter grad."""
    from paddle_tpu_torch.ops.cuda import conv as k5

    feeds, grad_names, jstates, _, jgrads = _jax_run("resnet50_nhwc")
    plain = k5.conv_backward

    def faulty(*a, **kw):
        dx, dw = plain(*a, **kw)
        return dx, None if dw is None else FAULTS[fault](dw)

    monkeypatch.setattr(k5, "conv_backward", faulty)
    main, _, loss = build(fluid, CONFIGS["resnet50_nhwc"])
    scope = fluid.Scope()
    fluid.io.scope_from_numpy(scope, jstates[0], fluid.CPUPlace())
    res = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feeds[0], scope=scope, fetch_list=grad_names)
    return max(rel_l2(g, w) for g, w in zip(res, jgrads))


def _compare_state(main, stats, got, before, want, layout):
    """``stats``: the batch-norm running means and variances."""
    got = dict(got)
    if layout == "flat":
        got.update(_unflatten(main, got))
    for name, w in want.items():
        assert name in got, name
        g = got[name]
        if name in stats:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=STAT_RTOL * max(np.abs(w).max(), 1e-3),
                err_msg=name)
        elif name.endswith("_velocity_0"):
            assert rel_l2(g, w) <= GRAD_RELL2, name
        elif not np.array_equal(w, before[name]):
            assert rel_l2(g - before[name], w - before[name]) \
                <= GRAD_RELL2, name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_port_startup_trains_resnet_on_its_own(knob, route_all):
    """The port's own startup (gaussian_random conv weights) and 3 steps
    on one batch: every loss is finite and the BN running stats move."""
    knob(None)
    cfg = dict(depth=18, data_format="NHWC", image_size=32)
    main, startup, loss = build(fluid, cfg)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    before = persistables(main, scope)
    feed = random_batch(np.random.RandomState(4), BATCH, 32, CLASSES, "NHWC")
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for _ in range(3)]
    assert np.isfinite(losses).all()
    after = persistables(main, scope)
    assert not np.array_equal(after["batch_norm.w_2"],
                              before["batch_norm.w_2"])
    names = set(scope.local_var_names())
    assert not any(n.startswith("conv2d.tmp") for n in names)


if __name__ == "__main__":
    # The readings behind GRAD_RELL2: for each config and layout, the
    # largest relative L2 the three-step test computes against the JAX
    # package, and what each planted fault scores. Run from the repo root:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_resnet_training.py
    readings = []
    _plain_rel_l2 = rel_l2

    def rel_l2(got, want):  # noqa: F811  (records every comparison)
        readings.append(_plain_rel_l2(got, want))
        return readings[-1]

    GRAD_RELL2 = float("inf")
    os.environ.pop(KNOB, None)
    fluid.set_flags({"FLAGS_use_pallas_conv": "all"})
    with pytest.MonkeyPatch.context() as mp:
        for name in sorted(CONFIGS):
            for layout in (None, "flat"):
                os.environ.pop(KNOB, None)
                if layout:
                    os.environ[KNOB] = layout
                del readings[:]
                test_three_momentum_steps_match_the_jax_package(
                    lambda v: None, None, mp, name, layout)
                print("%s layout %s: %d tensors, largest rel-L2 %.4g"
                      % (name, layout, len(readings), max(readings)))
                mp.undo()
        os.environ.pop(KNOB, None)
        for fault in sorted(FAULTS):
            print("planted fault %s: largest step-1 grad rel-L2 %.4g"
                  % (fault, _planted_fault_score(mp, fault)))
            mp.undo()
